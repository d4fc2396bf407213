"""Every bitrot algorithm of the JAX registry in the port (minio_tpu_torch,
plain PyTorch and the host hash library on the CPU) against the JAX
package, on the same seeded inputs.

- the host library (csrc/host_hash.cc) and its pure-Python plain versions
  against minio_tpu.native's sip256 / highwayhash256, the xxhash package
  (seed 0x6D747075) and hashlib, at lengths 0-4097 and random bytes;
- the registry: seven algorithms, the JAX digests, xxh64's 8-byte frame;
- for each of the seven, both ways on 12 drives at EC 8+4 (64 KiB blocks
  to keep the CPU run short): the JAX package writes, the port reads,
  reads degraded, deep-verifies and heals, byte-equal to the JAX heal of
  the same damage; the port writes, the JAX package reads, and the shard
  files equal the JAX package's own PUT of the same bytes; a flipped byte
  is read around and rewritten by a deep heal;
- a multipart upload with sip256 on sets; the port's server over drives
  the JAX server formatted and wrote with its CPU default, sip256;
- a host library that does not build raises, and nothing falls back.

The JAX side runs as its own per-request oracle: both batch planes off
(MTPU_METAPLANE=0, MTPU_BATCHED_DATAPLANE=0). Tolerance: exact bytes."""

import ast
import glob
import hashlib
import io
import os
import pathlib
import shutil

import numpy as np
import pytest
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.native import lib as jlib
from minio_tpu.ops import bitrot as jbitrot
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.native import lib, plain
from minio_tpu_torch.ops import bitrot
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import errors as se
from tests.torch_native import jax_native_library

# Before anything of this module asks for it: load the JAX package's C++
# library from a whole build, as its loader can lose a build race between
# test workers for good (tests/torch_native.py).
jax_native_library()

ROOT = pathlib.Path(__file__).resolve().parents[1]
ALGOS = ["mxsum256", "mxhash256", "sip256", "highwayhash256", "sha256", "xxh64",
         "blake2b256"]
BS = 64 << 10
SIZE = 3 * BS + 1234          # three full blocks and a short one
BUCKET = "bitrot"
N = 12
SEED = 0x6D74_7075


@pytest.fixture(autouse=True)
def planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


# --- the host library and the plain versions ------------------------------

HOST_CASES = {
    "sip256": (lambda d: lib.sip256(bitrot.BITROT_KEY, d),
               lambda d: plain.sip256_py(bitrot.BITROT_KEY, d),
               lambda d: jlib.sip256(bitrot.BITROT_KEY, d)),
    "highwayhash256": (lambda d: lib.highwayhash256(bitrot.HH_BITROT_KEY, d),
                       lambda d: plain.highwayhash256_py(bitrot.HH_BITROT_KEY, d),
                       lambda d: jlib.highwayhash256(bitrot.HH_BITROT_KEY, d)),
    "xxh64": (lambda d: lib.xxh64(d, SEED),
              lambda d: plain.xxh64_py(d, SEED),
              lambda d: xxhash.xxh64(d, seed=SEED).intdigest()),
}


def test_jax_native_library_is_built_here():
    """The comparisons below are against the JAX package's C++ library,
    not its Python fallbacks."""
    assert jax_native_library()
    assert jlib.available()


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_library_equals_jax_at_every_length(name):
    ours, _plain, theirs = HOST_CASES[name]
    data = _payload(4097, 11)
    for n in range(0, 4098):
        assert ours(data[:n]) == theirs(data[:n]), n


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_plain_versions_equal_the_library(name):
    ours, py, theirs = HOST_CASES[name]
    data = _payload(4097, 12)
    for n in [*range(0, 130), 255, 256, 257, 511, 1023, 1024, 1025, 4095, 4096, 4097]:
        assert py(data[:n]) == ours(data[:n]) == theirs(data[:n]), n


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=5000), st.integers(0, 7))
def test_random_bytes_and_offsets(data, off):
    """Random contents at random offsets of a buffer (memoryview slices, as
    the writer threads pass them), against all three references."""
    mv = memoryview(bytes(8) + data)[8 - off:]
    raw = bytes(mv)
    for ours, py, theirs in HOST_CASES.values():
        assert ours(mv) == theirs(raw)
        if len(raw) <= 600:
            assert py(raw) == theirs(raw)
    assert bitrot.get_algorithm("xxh64").digest(mv) == \
        xxhash.xxh64(raw, seed=SEED).digest()


def test_registry_serves_the_seven_jax_algorithms():
    data = _payload(10_000, 13)
    for name in ALGOS:
        ours, theirs = bitrot.get_algorithm(name), jbitrot.get_algorithm(name)
        assert ours.digest_len == theirs.digest_len == (8 if name == "xxh64" else 32)
        for n in (0, 1, 4096, 10_000):
            assert ours.digest(data[:n]) == theirs.digest(data[:n]), (name, n)
        assert bitrot.bitrot_shard_file_size(70_000, 8192, name) == \
            jbitrot.bitrot_shard_file_size(70_000, 8192, name)
    assert bitrot.HH_BITROT_KEY == jbitrot.HH_BITROT_KEY
    assert bitrot.bitrot_shard_file_size(70_000, 8192, "xxh64") == 70_000 + 9 * 8
    with pytest.raises(se.CorruptedFormat):
        bitrot.get_algorithm("crc32")


def test_port_imports_no_xxhash_and_the_hygiene_scan_covers_the_new_modules():
    """The card's machine has no xxhash package; the AST scan of
    tests/test_torch_hygiene.py walks every module of the port, the new
    native/ package and ops/mxhash.py among them."""
    files = sorted((ROOT / "minio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    rel = {str(f.relative_to(ROOT)) for f in files}
    assert {"minio_tpu_torch/native/lib.py", "minio_tpu_torch/native/plain.py",
            "minio_tpu_torch/ops/mxhash.py"} <= rel
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f}:{node.lineno}" for n in names
                    if n.split(".")[0] in ("xxhash", "jax", "minio_tpu")]
    assert not bad, bad


@pytest.mark.parametrize("cxx", ["/nonexistent/g++", "false"])
def test_a_host_library_that_does_not_build_raises(monkeypatch, tmp_path, cxx):
    """No compiler, or one that refuses the source: every host algorithm
    raises, at construction of a set that writes with it and on a read;
    nothing falls back to the pure-Python versions."""
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CXX", cxx)
    for name in ("sip256", "highwayhash256", "xxh64"):
        with pytest.raises(lib.HostLibraryError):
            bitrot.get_algorithm(name)
    with pytest.raises(lib.HostLibraryError):
        bitrot._Sip256.digest(b"abc")
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    with pytest.raises(lib.HostLibraryError):
        TorchObjects([TorchDrive(p) for p in paths], device="cpu",
                     bitrot_algorithm="sip256")
    with pytest.raises(lib.HostLibraryError):
        bitrot.BitrotReader(io.BytesIO(b""), 0, 64, "xxh64")
    assert bitrot.get_algorithm("sha256").digest(b"") == hashlib.sha256(b"").digest()


# --- objects, both ways -----------------------------------------------------


def _paths(root, n=N):
    return [str(root / f"d{i:02d}") for i in range(n)]


def _jax(paths, algo):
    return JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                      bitrot_algorithm=algo)


def _torch(paths, algo=None):
    return TorchObjects([TorchDrive(p) for p in paths], parity=4, block_size=BS,
                        device="cpu", bitrot_algorithm=algo)


def _get(layer, key):
    _info, it = layer.get_object(BUCKET, key)
    return b"".join(bytes(c) for c in it)


def _part_file(path, key, part=1):
    hits = glob.glob(os.path.join(path, BUCKET, key, "*", f"part.{part}"))
    return hits[0] if hits else None


def _part_files(paths, key):
    return {i: open(_part_file(p, key), "rb").read() for i, p in enumerate(paths)
            if _part_file(p, key)}


def _tree(paths):
    """{(drive, relative path): bytes} of every file but the tmp area's."""
    out = {}
    for i, p in enumerate(paths):
        for root, dirs, files in os.walk(p):
            rel = os.path.relpath(root, p)
            if rel.split(os.sep)[:2] == [".mtpu.sys", "tmp"]:
                dirs[:] = []
                continue
            for f in files:
                full = os.path.join(root, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, p))] = fh.read()
    return out


def _copy(paths, root):
    dst = _paths(root, len(paths))
    for a, b in zip(paths, dst):
        shutil.copytree(a, b)
    return dst


def _drop(paths, key, drives):
    for i in drives:
        shutil.rmtree(os.path.dirname(_part_file(paths[i], key)))


@pytest.mark.parametrize("algo", ALGOS)
def test_jax_writes_port_reads_degraded_heals_like_jax(tmp_path, algo):
    paths = _paths(tmp_path / "w")
    jl = _jax(paths, algo)
    jl.make_bucket(BUCKET)
    data = _payload(SIZE, 1)
    info = jl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    tl = _torch(paths)
    fi = tl.latest_fileinfo(BUCKET, "obj")
    assert [c.algorithm for c in fi.erasure.checksums] == [algo]
    assert _get(tl, "obj") == data
    assert tl.get_object_info(BUCKET, "obj").etag == info.etag
    # Deep verify of every shard file, and framed sizes the JAX package wrote.
    dl = 8 if algo == "xxh64" else 32
    shard_data = fi.erasure.shard_file_size(SIZE)
    for p in paths:
        with open(_part_file(p, "obj"), "rb") as f:
            assert os.fstat(f.fileno()).st_size == \
                shard_data + -(-shard_data // fi.erasure.shard_size()) * dl
            bitrot.verify_shard_file(f, shard_data, fi.erasure.shard_size(), algo,
                                     tl.device)
        TorchDrive(p).check_parts(BUCKET, "obj", fi)

    # The same damage to two copies, each healed by one package.
    lost = [0, 3, 6, 9]
    healed = {}
    for pkg in ("jax", "torch"):
        cp = _copy(paths, tmp_path / f"heal-{pkg}")
        _drop(cp, "obj", lost)
        layer = _jax(cp, algo) if pkg == "jax" else _torch(cp)
        if pkg == "torch":
            assert _get(layer, "obj") == data          # degraded GET
        res = layer.heal_object(BUCKET, "obj", scan_deep=True)
        assert res.healed_count == len(lost)
        healed[pkg] = cp
    assert _tree(healed["torch"]) == _tree(healed["jax"])
    assert _part_files(healed["torch"], "obj") == _part_files(paths, "obj")


@pytest.mark.parametrize("algo", ALGOS)
def test_port_writes_jax_reads_and_files_equal_jax_put(tmp_path, algo):
    data = _payload(SIZE, 2)
    ours, theirs = _paths(tmp_path / "port"), _paths(tmp_path / "jax")
    tl = _torch(ours, algo)
    tl.make_bucket(BUCKET)
    info = tl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    jw = _jax(theirs, algo)
    jw.make_bucket(BUCKET)
    jw.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    assert _part_files(ours, "obj") == _part_files(theirs, "obj")
    assert len(_part_files(ours, "obj")) == N
    jl = _jax(ours, "mxsum256")
    assert _get(jl, "obj") == data
    assert jl.get_object_info(BUCKET, "obj").etag == info.etag
    assert [c.algorithm for c in jl._read_quorum_fileinfo(BUCKET, "obj", "")
            .erasure.checksums] == [algo]


@pytest.mark.parametrize("algo", ALGOS)
def test_flipped_byte_is_read_around_and_deep_healed(tmp_path, algo):
    paths = _paths(tmp_path)
    tl = _torch(paths, algo)
    tl.make_bucket(BUCKET)
    data = _payload(SIZE, 3)
    tl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    f = _part_file(paths[4], "obj")
    original = open(f, "rb").read()
    raw = bytearray(original)
    raw[len(raw) // 2] ^= 0x5A
    open(f, "wb").write(raw)
    assert _get(tl, "obj") == data
    assert _get(_jax(paths, algo), "obj") == data
    res = tl.heal_object(BUCKET, "obj", scan_deep=True)
    assert res.healed_count == 1
    assert open(_part_file(paths[4], "obj"), "rb").read() == original


@pytest.mark.parametrize("algo", ["sip256", "mxhash256"])
def test_with_the_port_plane_on(tmp_path, monkeypatch, algo):
    """The port's batched data plane on: a host algorithm's PUT and heal
    ride its lanes without digests (the writer threads hash), mxhash256's
    take the codec (K1 then K3); the shard files equal the JAX package's
    PUT of the same bytes, and the heal rebuilds them."""
    from minio_tpu_torch import dataplane

    data = _payload(SIZE, 4)
    theirs = _paths(tmp_path / "jax")
    jw = _jax(theirs, algo)
    jw.make_bucket(BUCKET)
    jw.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "1")
    try:
        ours = _paths(tmp_path / "port")
        tl = _torch(ours, algo)
        tl.make_bucket(BUCKET)
        tl.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
        lanes = dataplane.get_plane("cpu").stats()["op_launches"].get("encode", 0)
        assert (lanes > 0) == (algo == "sip256")
        assert _part_files(ours, "obj") == _part_files(theirs, "obj")
        _drop(ours, "obj", [1, 5])
        assert _get(tl, "obj") == data
        assert tl.heal_object(BUCKET, "obj", scan_deep=True).healed_count == 2
        assert _part_files(ours, "obj") == _part_files(theirs, "obj")
    finally:
        dataplane.reset_global()


def test_sip256_multipart_on_sets(tmp_path):
    """A multipart upload with sip256 on 2 sets of 6 drives: begun by the
    port, one part put by each package, completed by the port; both read
    it, the journal names sip256 for every part, and the shard files equal
    the JAX package's own upload of the same parts."""
    from minio_tpu.erasure.multipart import MIN_PART_SIZE

    parts = [_payload(MIN_PART_SIZE, 20), _payload(100_000, 21)]
    whole = b"".join(parts)

    def upload(sets, part_sets, cp):
        sets.make_bucket(BUCKET)
        uid = sets.new_multipart_upload(BUCKET, "mp")
        etags = [ps.put_object_part(BUCKET, "mp", uid, i + 1, io.BytesIO(p),
                                    len(p)).etag
                 for i, (p, ps) in enumerate(zip(parts, part_sets))]
        return sets.complete_multipart_upload(
            BUCKET, "mp", uid, [cp(i + 1, e) for i, e in enumerate(etags)])

    ours, theirs = _paths(tmp_path / "port"), _paths(tmp_path / "jax")
    ts = TorchSets([TorchDrive(p) for p in ours], 6, parity=2, block_size=BS,
                   device="cpu", bitrot_algorithm="sip256")
    js_ours = JaxSets([JaxDrive(p) for p in ours], set_drive_count=6, parity=2,
                      block_size=BS, bitrot_algorithm="sip256")
    info = upload(ts, [js_ours, ts], TorchPart)
    js = JaxSets([JaxDrive(p) for p in theirs], set_drive_count=6, parity=2,
                 block_size=BS, bitrot_algorithm="sip256")
    jinfo = upload(js, [js, js], JaxPart)
    assert info.etag == jinfo.etag
    for layer in (ts, js_ours):
        _i, it = layer.get_object(BUCKET, "mp")
        assert b"".join(bytes(c) for c in it) == whole
    es = ts.get_hashed_set("mp")
    fi = es.latest_fileinfo(BUCKET, "mp")
    assert [c.algorithm for c in fi.erasure.checksums] == ["sip256", "sip256"]

    def files(paths):
        """(drive within its set, part file) -> bytes: each deployment
        routes the key to a set by its own deployment id."""
        return {(i % 6, os.path.basename(f)): open(f, "rb").read()
                for i, p in enumerate(paths)
                for f in glob.glob(os.path.join(p, BUCKET, "mp", "*", "part.*"))}

    assert files(ours) == files(theirs) and len(files(ours)) == 12
    ts.close()
    js_ours.close()
    js.close()


def test_port_server_serves_drives_the_jax_server_wrote(tmp_path):
    """The JAX build_server, which takes no algorithm, writes with its CPU
    default: sip256, since its native library builds here. The port's
    server over the same drives answers GETs over HTTP byte-equal."""
    from minio_tpu.s3.server import build_server as jax_build_server
    from minio_tpu_torch.s3.server import build_server
    from tests.s3client import SigV4Client

    paths = _paths(tmp_path)
    objects = {"big": _payload(SIZE, 5), "tiny": _payload(100, 6)}
    jsrv = jax_build_server(paths, "bitrotadmin", "bitrotsecret123")
    try:
        jsrv.obj.make_bucket(BUCKET)
        for key, data in objects.items():
            jsrv.obj.put_object(BUCKET, key, io.BytesIO(data), len(data))
        es = jsrv.obj.pools[0].sets[0]
        assert es.bitrot_algorithm == "sip256"
        assert [c.algorithm for c in es._read_quorum_fileinfo(BUCKET, "big", "")
                .erasure.checksums] == ["sip256"]
    finally:
        jsrv.obj.close()
    srv = build_server(paths, "bitrotadmin", "bitrotsecret123", device="cpu").start()
    try:
        cl = SigV4Client(srv.url, "bitrotadmin", "bitrotsecret123")
        for key, data in objects.items():
            r = cl.get(f"/{BUCKET}/{key}")
            assert r.status_code == 200 and r.content == data
            assert r.headers["ETag"] == f'"{hashlib.md5(data).hexdigest()}"'
    finally:
        srv.close()
