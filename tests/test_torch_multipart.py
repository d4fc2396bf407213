"""Multipart uploads of the port (minio_tpu_torch, plain PyTorch on the CPU)
against the JAX package's on one 16-drive set at EC 12+4 with 1 MiB blocks
(87,382-byte shard chunks) and 5 MiB parts.

Every test runs twice, with both packages' group-commit metadata plane at
its default (on) and with MTPU_METAPLANE=0 (tests/torch_planes.py); the
batched data plane is off, and the JAX side writes
bitrot_algorithm="mxsum256", the checksum the port writes. Both packages
run on the same drive directories, so a session begun by one is
continued, completed and read by the other. Tolerance: exact bytes."""

import glob
import hashlib
import io
import json
import os
import shutil
import types

import numpy as np
import pytest

from minio_tpu.erasure import multipart as jax_mp
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.utils import errors as jax_se
from minio_tpu_torch.erasure import multipart as torch_mp
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import errors as torch_se
from tests.torch_planes import planes  # noqa: F401 - the fixture

N, PARITY = 16, 4
BUCKET = "mpu"
MIB = 1 << 20
PART_SIZES = [5 * MIB, 5 * MIB, 123457]


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _layers(planes, root):
    paths = [str(root / f"d{i}") for i in range(N)]
    jl, tl = planes.layers(
        paths,
        lambda: JaxObjects([JaxDrive(p) for p in paths], parity=PARITY,
                           bitrot_algorithm="mxsum256"),
        lambda: TorchObjects([TorchDrive(p) for p in paths], parity=PARITY,
                             device="cpu"))
    return paths, jl, tl


def _pick(name, jl, tl):
    return jl if name == "jax" else tl


def _cp(layer, number, etag):
    return (JaxPart if layer.pkg == "jax" else TorchPart)(number, etag)


def _upload(layer, key, parts, part_layers=None):
    """Begin an upload on `layer`, put `parts` through `part_layers` (each
    part by the layer at its index; default `layer`); -> (upload id, etags)."""
    uid = layer.new_multipart_upload(BUCKET, key)
    etags = []
    for i, data in enumerate(parts):
        pl = part_layers[i % len(part_layers)] if part_layers else layer
        etags.append(pl.put_object_part(BUCKET, key, uid, i + 1, io.BytesIO(data),
                                        len(data)).etag)
    return uid, etags


def _get(layer, key, offset=0, length=-1):
    _info, it = layer.get_object(BUCKET, key, offset, length)
    return b"".join(bytes(c) for c in it)


def _part_files(paths, key):
    """(drive, part file name) -> bytes of every shard file of the object."""
    out = {}
    for i, p in enumerate(paths):
        for f in glob.glob(os.path.join(p, BUCKET, key, "*", "part.*")):
            out[(i, os.path.basename(f))] = open(f, "rb").read()
    return out


def _drop_shards(paths, key, drives):
    for i in drives:
        for d in glob.glob(os.path.join(paths[i], BUCKET, key, "*", "")):
            shutil.rmtree(d)


def _parts(seed=0):
    return [_payload(n, seed + i) for i, n in enumerate(PART_SIZES)]


@pytest.mark.parametrize("begin,complete", [("jax", "torch"), ("torch", "jax"),
                                            ("torch", "torch")])
def test_roundtrip_across_packages(tmp_path, planes, begin, complete):
    """Begun by one package, parts put by both in turn, completed by either:
    both read the object whole, by range and by info."""
    paths, jl, tl = _layers(planes, tmp_path)
    tl.make_bucket(BUCKET)
    parts = _parts()
    b, c = _pick(begin, jl, tl), _pick(complete, jl, tl)
    uid, etags = _upload(b, "obj", parts, part_layers=[jl, tl])
    info = c.complete_multipart_upload(
        BUCKET, "obj", uid, [_cp(c, i + 1, e) for i, e in enumerate(etags)])
    want_etag = torch_mp.multipart_etag([hashlib.md5(p).hexdigest() for p in parts])
    assert info.etag == want_etag and want_etag.endswith("-3")
    data = b"".join(parts)
    for reader in (jl, tl):
        assert _get(reader, "obj") == data
        got = reader.get_object_info(BUCKET, "obj")
        assert (got.etag, got.size) == (want_etag, len(data))
    planes.settle()
    assert not any(glob.glob(os.path.join(p, ".mtpu.sys", "multipart", "*", uid))
                   for p in paths)


def test_part_files_and_session_bytes_equal(tmp_path, planes, monkeypatch):
    """The same upload (same id and clock) on two drive sets, one per
    package: upload.json, part.N.json and every shard file are the same
    bytes, before and after Complete."""
    clock = types.SimpleNamespace(time=lambda: 1700000000.25)
    ids = types.SimpleNamespace(uuid4=lambda: types.SimpleNamespace(
        hex="0123456789abcdef0123456789abcdef"))
    for mod in (jax_mp, torch_mp):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "uuid", ids)
    jpaths, jl, _ = _layers(planes, tmp_path / "a")
    tpaths, _, tl = _layers(planes, tmp_path / "b")
    parts = _parts(3)
    trees = []
    for layer, paths in ((jl, jpaths), (tl, tpaths)):
        layer.make_bucket(BUCKET)
        uid, _ = _upload(layer, "obj", parts)
        planes.settle()
        session = {}
        for i, p in enumerate(paths):
            for f in glob.glob(os.path.join(p, ".mtpu.sys", "multipart", "*", uid, "*")):
                session[(i, os.path.relpath(f, p))] = open(f, "rb").read()
        trees.append(session)
    assert trees[0] == trees[1]
    assert len(trees[0]) == N * (1 + 2 * len(parts))
    meta = json.loads(trees[1][(0, next(k for _i, k in trees[1] if k.endswith("upload.json")))])
    assert list(meta) == ["bucket", "object", "upload_id", "initiated", "user_defined",
                          "distribution", "parity", "block_size", "bitrot"]
    for layer in (jl, tl):
        layer.complete_multipart_upload(
            BUCKET, "obj", "0123456789abcdef0123456789abcdef",
            [_cp(layer, i + 1, hashlib.md5(p).hexdigest()) for i, p in enumerate(parts)])
    planes.settle()
    jf, tf = _part_files(jpaths, "obj"), _part_files(tpaths, "obj")
    assert len(jf) == N * len(parts) and jf == tf


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_range_across_part_boundaries(tmp_path, planes, writer):
    paths, jl, tl = _layers(planes, tmp_path)
    w = _pick(writer, jl, tl)
    w.make_bucket(BUCKET)
    parts = _parts(5)
    uid, etags = _upload(w, "obj", parts)
    w.complete_multipart_upload(BUCKET, "obj", uid,
                                [_cp(w, i + 1, e) for i, e in enumerate(etags)])
    data = b"".join(parts)
    b1, b2 = PART_SIZES[0], PART_SIZES[0] + PART_SIZES[1]
    for off, ln in ((b1 - 1, 2), (b1 - 1000, 3 * MIB), (b2 - 17, 100), (0, len(data)),
                    (b1 - 5, PART_SIZES[1] + 10), (len(data) - 1, 1)):
        for reader in (jl, tl):
            assert _get(reader, "obj", off, ln) == data[off:off + ln], (off, ln)


def test_part_overwrite_keeps_the_last_upload(tmp_path, planes):
    paths, jl, tl = _layers(planes, tmp_path)
    tl.make_bucket(BUCKET)
    first, second, tail = _payload(5 * MIB, 10), _payload(5 * MIB, 11), _payload(999, 12)
    uid, _ = _upload(tl, "obj", [first, tail])
    e1 = tl.put_object_part(BUCKET, "obj", uid, 1, io.BytesIO(second), len(second)).etag
    assert [p.etag for p in tl.list_parts(BUCKET, "obj", uid)] == \
        [p.etag for p in jl.list_parts(BUCKET, "obj", uid)] == \
        [hashlib.md5(second).hexdigest(), hashlib.md5(tail).hexdigest()]
    with pytest.raises(Exception) as ei:      # the replaced part's etag is gone
        tl.complete_multipart_upload(BUCKET, "obj", uid, [
            TorchPart(1, hashlib.md5(first).hexdigest()),
            TorchPart(2, hashlib.md5(tail).hexdigest())])
    assert type(ei.value).__name__ == "InvalidPart"
    jl.complete_multipart_upload(BUCKET, "obj", uid, [
        JaxPart(1, e1), JaxPart(2, hashlib.md5(tail).hexdigest())])
    assert _get(tl, "obj") == second + tail
    planes.settle()
    assert not any(glob.glob(os.path.join(p, ".mtpu.sys", "multipart", "*", uid, "tmp-*"))
                   for p in paths)


def _validation_cases(small, big, tail):
    """name -> (parts to upload, parts to name in Complete: (number, data))."""
    return {
        "empty list": ([big, tail], []),
        "out of order": ([big, tail], [(2, tail), (1, big)]),
        "duplicate": ([big, tail], [(1, big), (1, big)]),
        "wrong etag": ([big, tail], [(1, tail), (2, tail)]),
        "not uploaded": ([big, tail], [(1, big), (3, tail)]),
        "too small": ([small, tail], [(1, small), (2, tail)]),
    }


@pytest.mark.parametrize("case", list(_validation_cases(b"", b"", b"")))
def test_complete_validation_errors_match(tmp_path, planes, case):
    small, big, tail = _payload(MIB, 20), _payload(5 * MIB, 21), _payload(100, 22)
    uploads, named = _validation_cases(small, big, tail)[case]
    errs = []
    for name in ("jax", "torch"):
        paths, jl, tl = _layers(planes, tmp_path / name)
        layer = _pick(name, jl, tl)
        layer.make_bucket(BUCKET)
        uid, _ = _upload(layer, "obj", uploads)
        with pytest.raises(Exception) as ei:
            layer.complete_multipart_upload(BUCKET, "obj", uid, [
                _cp(layer, n, hashlib.md5(d).hexdigest()) for n, d in named])
        errs.append(type(ei.value).__name__)
        if case != "too small":
            # A refused Complete leaves the session whole: it completes after.
            layer.complete_multipart_upload(BUCKET, "obj", uid, [
                _cp(layer, i + 1, hashlib.md5(d).hexdigest())
                for i, d in enumerate(uploads)])
    assert errs[0] == errs[1]
    assert errs[1] == ("PartTooSmall" if case == "too small" else "InvalidPart")


def test_abort_removes_the_session(tmp_path, planes):
    paths, jl, tl = _layers(planes, tmp_path)
    tl.make_bucket(BUCKET)
    uid, _ = _upload(jl, "obj", [_payload(5 * MIB, 30)])
    tl.abort_multipart_upload(BUCKET, "obj", uid)
    planes.settle()
    assert not glob.glob(os.path.join(paths[0], ".mtpu.sys", "multipart", "*", uid))
    for layer in (jl, tl):
        with pytest.raises(Exception) as ei:
            layer.put_object_part(BUCKET, "obj", uid, 1, io.BytesIO(b"x"), 1)
        assert type(ei.value).__name__ == "InvalidUploadID"


@pytest.mark.parametrize("call", ["put_part", "list_parts", "complete", "abort",
                                  "wrong_key"])
def test_unknown_upload_matches(tmp_path, planes, call):
    paths, jl, tl = _layers(planes, tmp_path)
    tl.make_bucket(BUCKET)
    uid = tl.new_multipart_upload(BUCKET, "obj")
    names = []
    for layer in (jl, tl):
        fn = {
            "put_part": lambda: layer.put_object_part(BUCKET, "obj", "nope", 1,
                                                      io.BytesIO(b"x"), 1),
            "list_parts": lambda: layer.list_parts(BUCKET, "obj", "nope"),
            "complete": lambda: layer.complete_multipart_upload(
                BUCKET, "obj", "nope", [_cp(layer, 1, "00" * 16)]),
            "abort": lambda: layer.abort_multipart_upload(BUCKET, "obj", "nope"),
            "wrong_key": lambda: layer.list_parts(BUCKET, "other", uid),
        }[call]
        with pytest.raises(Exception) as ei:
            fn()
        names.append(type(ei.value).__name__)
    assert names == ["InvalidUploadID", "InvalidUploadID"]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_read_after_losing_m_drives(tmp_path, planes, writer):
    paths, jl, tl = _layers(planes, tmp_path)
    w = _pick(writer, jl, tl)
    w.make_bucket(BUCKET)
    parts = _parts(40)
    uid, etags = _upload(w, "obj", parts)
    w.complete_multipart_upload(BUCKET, "obj", uid,
                                [_cp(w, i + 1, e) for i, e in enumerate(etags)])
    planes.settle()
    _drop_shards(paths, "obj", [0, 5, 9, 15])
    data = b"".join(parts)
    for reader in (jl, tl):
        assert _get(reader, "obj") == data
        assert _get(reader, "obj", PART_SIZES[0] - 3, 7) == \
            data[PART_SIZES[0] - 3:PART_SIZES[0] + 4]


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_heal_rebuilds_every_part_as_the_jax_heal_does(tmp_path, planes, writer):
    """One multipart object on two copies of the same drives, the same 4
    drives' shards lost in both: the JAX heal of one copy and the port's
    heal of the other rebuild every part file, byte-equal to each other and
    to the originals; then a deep scan finds a flipped byte."""
    a, jla, tla = _layers(planes, tmp_path / "a")
    w = _pick(writer, jla, tla)
    w.make_bucket(BUCKET)
    parts = _parts(50)
    uid, etags = _upload(w, "obj", parts)
    w.complete_multipart_upload(BUCKET, "obj", uid,
                                [_cp(w, i + 1, e) for i, e in enumerate(etags)])
    planes.release()   # every journal on disk, no WAL left to copy
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    b, jlb, tlb = _layers(planes, tmp_path / "b")
    original = _part_files(a, "obj")
    lost = [1, 2, 8, 11]
    _drop_shards(a, "obj", lost)
    _drop_shards(b, "obj", lost)
    rj = jla.heal_object(BUCKET, "obj")
    rt = tlb.heal_object(BUCKET, "obj")
    assert rj.healed_count == rt.healed_count == 4
    assert [s.state for s in rt.before] == [s.state for s in rj.before]
    planes.settle()
    assert _part_files(a, "obj") == _part_files(b, "obj") == original
    f = glob.glob(os.path.join(b[6], BUCKET, "obj", "*", "part.2"))[0]
    raw = bytearray(open(f, "rb").read())
    raw[32 + 70000] ^= 0x40
    open(f, "wb").write(bytes(raw))
    assert tlb.heal_object(BUCKET, "obj", scan_deep=True).healed_count == 1
    planes.settle()
    assert _part_files(b, "obj") == original
    assert _get(jlb, "obj") == b"".join(parts)


def test_list_parts_and_uploads_equal(tmp_path, planes):
    paths, jl, tl = _layers(planes, tmp_path)
    tl.make_bucket(BUCKET)
    ups = {}
    for i, (layer, key) in enumerate(((jl, "docs/a"), (tl, "docs/b"), (tl, "img/c"),
                                      (jl, "docs/a"))):
        parts = [_payload(5 * MIB, 60 + i), _payload(1000 + i, 70 + i)]
        ups[(key, i)] = _upload(layer, key, parts, part_layers=[tl, jl])[0]

    def view(layer, prefix):
        return [(u.object, u.upload_id, u.initiated, u.user_defined)
                for u in layer.list_multipart_uploads(BUCKET, prefix)]

    for prefix in ("", "docs/", "img", "zzz"):
        assert view(tl, prefix) == view(jl, prefix)
    assert len(view(tl, "")) == 4 and len(view(tl, "docs/")) == 3
    for (key, _i), uid in ups.items():
        for marker, mx in ((0, 1000), (1, 1000), (0, 1)):
            want = [(p.part_number, p.etag, p.size, p.last_modified)
                    for p in jl.list_parts(BUCKET, key, uid, marker, mx)]
            got = [(p.part_number, p.etag, p.size, p.last_modified)
                   for p in tl.list_parts(BUCKET, key, uid, marker, mx)]
            assert got == want and got


@pytest.mark.parametrize("name", ["jax", "torch"])
def test_below_quorum_complete_rolls_back(tmp_path, planes, name):
    """Complete over an existing object with 5 of 16 drives failing the
    commit (write quorum 12): both packages refuse it, keep the old object
    readable (reclaim capsules undone), keep the parts in the session, and
    complete on a retry once the drives are back."""
    paths, jl, tl = _layers(planes, tmp_path)
    layer = _pick(name, jl, tl)
    layer.make_bucket(BUCKET)
    old = _payload(300 << 10, 80)
    layer.put_object(BUCKET, "obj", io.BytesIO(old), len(old))
    parts = [_payload(5 * MIB, 81), _payload(4000, 82)]
    uid, etags = _upload(layer, "obj", parts)
    done = [_cp(layer, i + 1, e) for i, e in enumerate(etags)]
    broken = layer.drives[3:8]

    faulty = (jax_se if name == "jax" else torch_se).FaultyDisk

    def fail(*_a, **_kw):
        raise faulty("injected")

    commits = ("rename_data", "write_metadata", "write_metadata_single",
               "journal_commit_async")
    for d in broken:
        for m in commits:
            setattr(d, m, fail)
    with pytest.raises(Exception) as ei:
        layer.complete_multipart_upload(BUCKET, "obj", uid, done)
    assert type(ei.value).__name__ == "InsufficientWriteQuorum"
    for reader in (jl, tl):
        assert _get(reader, "obj") == old
    assert [p.etag for p in tl.list_parts(BUCKET, "obj", uid)] == etags
    planes.settle()
    assert not any(glob.glob(os.path.join(p, ".mtpu.sys", "tmp", "*")) for p in paths)
    for d in broken:
        for m in commits:
            delattr(d, m)
    layer.complete_multipart_upload(BUCKET, "obj", uid, done)
    for reader in (jl, tl):
        assert _get(reader, "obj") == b"".join(parts)
