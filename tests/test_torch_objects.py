"""Two-way interop of the port's object layer (minio_tpu_torch, plain
PyTorch on the CPU) with the JAX package's on 12 tmp drives at EC 8+4.

The JAX side runs as its own per-request oracle: both batch planes off
(MTPU_METAPLANE=0, MTPU_BATCHED_DATAPLANE=0, so every journal is on disk
when the PUT returns) and bitrot_algorithm="mxsum256", the device checksum
the port writes. block_size is cut to 64 KiB to keep the CPU run short;
the shapes are the EC 8+4 set's. Tolerance: exact bytes."""

import glob
import io
import os
import shutil

import numpy as np
import pytest

from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive

BS = 64 << 10
SIZES = {"small.bin": 1 << 10, "mid.bin": 300 << 10, "big.bin": (1 << 20) + 12345}
BUCKET = "interop"


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture
def planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


def _layers(root):
    paths = [str(root / f"d{i}") for i in range(12)]
    jax_layer = JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                           bitrot_algorithm="mxsum256")
    torch_layer = TorchObjects([TorchDrive(p) for p in paths], parity=4,
                               block_size=BS, device="cpu")
    return paths, jax_layer, torch_layer


def _get(layer, key, offset=0, length=-1):
    _info, it = layer.get_object(BUCKET, key, offset, length)
    return b"".join(bytes(c) for c in it)


def _part_files(paths, key):
    """drive index -> bytes of the object's part.1 on that drive."""
    out = {}
    for i, p in enumerate(paths):
        hits = glob.glob(os.path.join(p, BUCKET, key, "*", "part.1"))
        if hits:
            out[i] = open(hits[0], "rb").read()
    return out


def _drop_shards(paths, key, drives):
    for i in drives:
        for d in glob.glob(os.path.join(paths[i], BUCKET, key, "*", "")):
            shutil.rmtree(d)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_written_by_one_read_by_the_other(tmp_path, planes_off, writer):
    paths, jl, tl = _layers(tmp_path)
    w, r = (jl, tl) if writer == "jax" else (tl, jl)
    w.make_bucket(BUCKET)
    for seed, (key, size) in enumerate(SIZES.items()):
        data = _payload(size, seed)
        info = w.put_object(BUCKET, key, io.BytesIO(data), size)
        assert _get(r, key) == data
        assert r.get_object_info(BUCKET, key).etag == info.etag
        assert _get(r, key, size // 3, size // 2) == data[size // 3:size // 3 + size // 2]


def test_part_files_byte_equal(tmp_path, planes_off):
    jpaths, jl, _ = _layers(tmp_path / "a")
    tpaths, _, tl = _layers(tmp_path / "b")
    jl.make_bucket(BUCKET)
    tl.make_bucket(BUCKET)
    for seed, (key, size) in enumerate(SIZES.items()):
        data = _payload(size, seed)
        jl.put_object(BUCKET, key, io.BytesIO(data), size)
        tl.put_object(BUCKET, key, io.BytesIO(data), size)
        jf, tf = _part_files(jpaths, key), _part_files(tpaths, key)
        if size <= 16 << 10:
            assert jf == tf == {}          # inline: no shard files
        else:
            assert len(jf) == 12 and jf == tf


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_degraded_and_bitrot_reads_in_both(tmp_path, planes_off, writer):
    paths, jl, tl = _layers(tmp_path)
    w = jl if writer == "jax" else tl
    w.make_bucket(BUCKET)
    data = _payload(SIZES["big.bin"], 9)
    w.put_object(BUCKET, "lossy", io.BytesIO(data), len(data))
    _drop_shards(paths, "lossy", [0, 3, 5, 7])
    for reader in (jl, tl):
        assert _get(reader, "lossy") == data
    # One flipped byte in one shard chunk: the digest catches it and the
    # read goes around that shard.
    w.put_object(BUCKET, "rotten", io.BytesIO(data), len(data))
    f = glob.glob(os.path.join(paths[4], BUCKET, "rotten", "*", "part.1"))[0]
    raw = bytearray(open(f, "rb").read())
    raw[32 + 100] ^= 0x5A
    open(f, "wb").write(bytes(raw))
    for reader in (jl, tl):
        assert _get(reader, "rotten") == data


@pytest.mark.parametrize("writer,healer", [("jax", "torch"), ("torch", "jax"),
                                           ("torch", "torch")])
def test_heal_rebuilds_original_files(tmp_path, planes_off, writer, healer):
    paths, jl, tl = _layers(tmp_path)
    w, h = (jl if writer == "jax" else tl), (jl if healer == "jax" else tl)
    w.make_bucket(BUCKET)
    key, data = "mid.bin", _payload(SIZES["mid.bin"], 5)
    w.put_object(BUCKET, key, io.BytesIO(data), len(data))
    before = _part_files(paths, key)
    lost = [1, 2, 8, 11]
    _drop_shards(paths, key, lost)
    res = h.heal_object(BUCKET, key)
    assert sum(1 for b, a in zip(res.before, res.after)
               if b.state != "ok" and a.state == "ok") == 4
    assert _part_files(paths, key) == before
    # With 4 OTHER drives gone, only the healed shards make quorum.
    _drop_shards(paths, key, [0, 4, 6, 9])
    for reader in (jl, tl):
        assert _get(reader, key) == data


def test_deep_heal_rewrites_a_flipped_byte(tmp_path, planes_off):
    paths, _, tl = _layers(tmp_path)
    tl.make_bucket(BUCKET)
    key, data = "mid.bin", _payload(SIZES["mid.bin"], 6)
    tl.put_object(BUCKET, key, io.BytesIO(data), len(data))
    before = _part_files(paths, key)
    f = glob.glob(os.path.join(paths[3], BUCKET, key, "*", "part.1"))[0]
    raw = bytearray(before[3])
    raw[40] ^= 1
    open(f, "wb").write(bytes(raw))
    assert tl.heal_object(BUCKET, key).healed_count == 0   # size check only
    assert tl.heal_object(BUCKET, key, scan_deep=True).healed_count == 1
    assert _part_files(paths, key) == before


def test_inline_heal_and_delete(tmp_path, planes_off):
    paths, jl, tl = _layers(tmp_path)
    tl.make_bucket(BUCKET)
    data = _payload(1000, 1)
    tl.put_object(BUCKET, "tiny", io.BytesIO(data), len(data))
    for i in (0, 5):
        os.remove(os.path.join(paths[i], BUCKET, "tiny", "meta.mp"))
    assert tl.heal_object(BUCKET, "tiny").healed_count == 2
    assert all(os.path.exists(os.path.join(p, BUCKET, "tiny", "meta.mp"))
               for p in paths)
    tl.delete_object(BUCKET, "tiny")
    for layer in (jl, tl):
        with pytest.raises(Exception) as ei:
            layer.get_object_info(BUCKET, "tiny")
        assert type(ei.value).__name__ == "ObjectNotFound"


def test_port_reads_and_heals_blake2b_objects(tmp_path, planes_off):
    """Objects the JAX package wrote with the host blake2b256 checksum are
    read (verified host-side per chunk) and healed by the port."""
    paths = [str(tmp_path / f"d{i}") for i in range(12)]
    jl = JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                    bitrot_algorithm="blake2b256")
    tl = TorchObjects([TorchDrive(p) for p in paths], parity=4, block_size=BS,
                      device="cpu")
    jl.make_bucket(BUCKET)
    data = _payload(SIZES["mid.bin"], 8)
    jl.put_object(BUCKET, "b2", io.BytesIO(data), len(data))
    assert _get(tl, "b2") == data
    before = _part_files(paths, "b2")
    f = glob.glob(os.path.join(paths[2], BUCKET, "b2", "*", "part.1"))[0]
    raw = bytearray(before[2])
    raw[40] ^= 1
    open(f, "wb").write(bytes(raw))
    assert _get(tl, "b2") == data              # digest catches, read goes around
    _drop_shards(paths, "b2", [5, 6])
    assert tl.heal_object(BUCKET, "b2", scan_deep=True).healed_count == 3
    assert _part_files(paths, "b2") == before
    assert _get(jl, "b2") == data
