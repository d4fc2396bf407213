"""The port's journal codec against the JAX package's: its own msgpack
subset must write the bytes `msgpack.packb` writes, its CRC-32C must equal
the native one, and a journal built by either package must serialize to
the same bytes and parse in the other. Inputs are made from a fixed seed;
tolerance: exact bytes."""

import msgpack
import numpy as np
import pytest

from minio_tpu.native.lib import crc32c as jax_crc32c
from minio_tpu.storage import fileinfo as jfi
from minio_tpu.storage.xlmeta import XLMeta as JaxMeta
from minio_tpu_torch.storage import fileinfo as tfi
from minio_tpu_torch.storage.xlmeta import XLMeta as TorchMeta
from minio_tpu_torch.utils import msgpack as tmp
from minio_tpu_torch.utils.crc32c import crc32c


def _doc(rng, depth=0):
    kind = rng.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        shift = int(rng.integers(0, 63))
        return int(rng.integers(-2**63, 2**63 - 1, dtype=np.int64)) >> shift
    if kind == 1:
        return float(rng.normal() * 10.0 ** int(rng.integers(-5, 15)))
    if kind == 2:
        n = int(rng.integers(0, 300))
        return "".join(chr(c) for c in rng.integers(32, 0x2FF, n))
    if kind == 3:
        return rng.bytes(int(rng.choice([0, 5, 255, 256, 70000])))
    if kind == 4:
        return [None, True, False][int(rng.integers(0, 3))]
    if kind == 5:
        edges = [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                 2**64 - 1, -32, -33, -128, -129, -32768, -32769, -2**31,
                 -2**31 - 1, -2**63]
        return edges[int(rng.integers(len(edges)))]
    if kind in (6, 7):
        n = int(rng.choice([0, 3, 15, 16, 40]))
        return [_doc(rng, depth + 1) for _ in range(n)]
    n = int(rng.choice([0, 2, 15, 16, 20]))
    return {f"k{i}": _doc(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(8))
def test_msgpack_subset_matches_msgpack(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        doc = _doc(rng)
        raw = msgpack.packb(doc)
        assert tmp.packb(doc) == raw
        assert tmp.unpackb(raw) == msgpack.unpackb(raw, strict_map_key=False)


def test_msgpack_rejects_malformed():
    raw = msgpack.packb({"a": [1, 2, 3]})
    for bad in (raw[:-1], raw + b"\x00", b"\xc1", b"\xd9\x05ab"):
        with pytest.raises(ValueError):
            tmp.unpackb(bad)


def test_crc32c_matches_native():
    rng = np.random.default_rng(2)
    for n in (0, 1, 7, 64, 1000, 20000):
        data = rng.bytes(n)
        assert crc32c(data) == jax_crc32c(data)
        assert crc32c(data, offset=n // 3) == jax_crc32c(data, offset=n // 3)


def _versions(mod):
    """The same journal history as FileInfos of package `mod`."""
    out = []
    for i, (vid, deleted, inline) in enumerate(
            [("", False, b""), ("v1", False, b"tiny"), ("v2", True, b""),
             ("", False, b"x" * 300), ("v3", False, b"")]):
        fi = mod.FileInfo(volume="bkt", name="a/b", version_id=vid,
                          deleted=deleted, mod_time=1.7e9 + i * 0.5,
                          data_dir="" if inline or deleted else f"dd-{i}",
                          size=len(inline) or 1000 + i,
                          metadata={"etag": f"{i:032x}", "content-type": "x/y"},
                          inline_data=inline)
        if not deleted:
            fi.parts = [mod.PartInfo(1, fi.size, fi.size, fi.mod_time)]
            fi.erasure = mod.ErasureInfo(
                data_blocks=8, parity_blocks=4, block_size=1 << 20, index=i,
                distribution=list(range(1, 13)),
                checksums=[mod.ChecksumInfo(1, "mxsum256")])
        out.append(fi)
    return out


def test_journals_serialize_identically_and_cross_parse():
    jm, tm = JaxMeta(), TorchMeta()
    for jv, tv in zip(_versions(jfi), _versions(tfi)):
        jm.add_version(jv)
        tm.add_version(tv)
        jraw, traw = jm.serialize(), tm.serialize()
        assert jraw == traw
        assert JaxMeta.parse(traw).serialize() == traw
        assert TorchMeta.parse(jraw).serialize() == jraw
    for vid in ("", "v1", "v3", "null"):
        a = JaxMeta.parse(tm.serialize()).to_fileinfo("bkt", "a/b", vid)
        b = TorchMeta.parse(jm.serialize()).to_fileinfo("bkt", "a/b", vid)
        assert (a.version_id, a.data_dir, a.size, a.mod_time, a.inline_data,
                a.metadata, a.erasure.distribution, a.is_latest) == \
            (b.version_id, b.data_dir, b.size, b.mod_time, b.inline_data,
             b.metadata, b.erasure.distribution, b.is_latest)
    removed_j = jm.delete_version("v1", "bkt", "a/b")
    removed_t = tm.delete_version("v1", "bkt", "a/b")
    assert removed_j.inline_data == removed_t.inline_data == b"tiny"
    assert jm.serialize() == tm.serialize()


def test_corrupt_journal_is_typed():
    from minio_tpu_torch.utils import errors as se

    tm = TorchMeta()
    tm.add_version(_versions(tfi)[0])
    raw = bytearray(tm.serialize())
    raw[-1] ^= 1
    with pytest.raises(se.CorruptedFormat):
        TorchMeta.parse(bytes(raw))
