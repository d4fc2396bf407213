"""meta.mp — the per-object versioned metadata journal.

Same on-disk format as minio_tpu/storage/xlmeta.py, so either package
reads the other's drives:

    magic "MTP2" | CRC32C(rest) LE32 | env_len LE32 | env | bodies

`env` is one msgpack map of packed columns (mod times f64[n], types u8[n],
body lengths u32[n], version-id and data-dir byte lengths u16[n], the ids
and data dirs as joined utf-8 buffers); each version body is an
individually packed msgpack document, concatenated after the envelope.
Versions are kept newest-first by mod_time.

The JAX package keeps the journal columnar and decodes lazily for speed;
this port materializes the (few) versions on parse, which writes the same
bytes for the same journal.
"""

from __future__ import annotations

import struct

from minio_tpu_torch.storage.fileinfo import (ChecksumInfo, ErasureInfo,
                                              FileInfo, PartInfo)
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils import msgpack
from minio_tpu_torch.utils.crc32c import crc32c

MAGIC = b"MTP2"
FORMAT_VERSION = 2

VTYPE_OBJECT = 1
VTYPE_DELETE_MARKER = 2

NULL_VERSION_REQ = "null"     # S3's request literal for the null version


def _fi_to_doc(fi: FileInfo) -> dict:
    doc = {
        "t": VTYPE_DELETE_MARKER if fi.deleted else VTYPE_OBJECT,
        "vid": fi.version_id,
        "mt": fi.mod_time,
    }
    if fi.deleted:
        return doc
    doc.update({
        "dd": fi.data_dir,
        "sz": fi.size,
        "meta": fi.metadata,
        "parts": [{"number": p.number, "size": p.size,
                   "actual_size": p.actual_size,
                   "mod_time": p.mod_time, "etag": p.etag}
                  for p in fi.parts],
        "ec": {
            "algo": fi.erasure.algorithm,
            "k": fi.erasure.data_blocks,
            "m": fi.erasure.parity_blocks,
            "bs": fi.erasure.block_size,
            "idx": fi.erasure.index,
            "dist": fi.erasure.distribution,
            "cks": [{"p": c.part_number, "a": c.algorithm, "h": c.hash}
                    for c in fi.erasure.checksums],
        },
    })
    if fi.inline_data:
        doc["inl"] = fi.inline_data
    return doc


def _doc_to_fi(doc: dict, volume: str, name: str) -> FileInfo:
    fi = FileInfo(volume=volume, name=name,
                  version_id=doc.get("vid", ""), mod_time=doc.get("mt", 0.0))
    if doc["t"] == VTYPE_DELETE_MARKER:
        fi.deleted = True
        return fi
    fi.data_dir = doc.get("dd", "")
    fi.size = doc.get("sz", 0)
    fi.metadata = dict(doc.get("meta", {}))
    fi.parts = [PartInfo(**p) for p in doc.get("parts", [])]
    ec = doc.get("ec", {})
    fi.erasure = ErasureInfo(
        algorithm=ec.get("algo", ""),
        data_blocks=ec.get("k", 0),
        parity_blocks=ec.get("m", 0),
        block_size=ec.get("bs", 0),
        index=ec.get("idx", 0),
        distribution=list(ec.get("dist", [])),
        checksums=[ChecksumInfo(c["p"], c["a"], c["h"])
                   for c in ec.get("cks", [])],
    )
    fi.inline_data = doc.get("inl", b"")
    return fi


class Version:
    """One journal entry: sort/lookup fields plus its packed body."""

    __slots__ = ("mt", "vid", "vtype", "dd", "blob")

    def __init__(self, mt: float, vid: str, vtype: int, dd: str, blob: bytes):
        self.mt = mt
        self.vid = vid
        self.vtype = vtype
        self.dd = dd
        self.blob = blob

    @property
    def doc(self) -> dict:
        try:
            return msgpack.unpackb(self.blob)
        except ValueError as e:
            raise se.CorruptedFormat(f"version body unpack: {e}") from e


def _split(buf: bytes, lens) -> list[str]:
    out, pos = [], 0
    for ln in lens:
        out.append(buf[pos:pos + ln].decode("utf-8"))
        pos += ln
    return out


class XLMeta:
    """In-memory journal; versions newest-first by mod_time."""

    def __init__(self, versions: list[Version] | None = None):
        self.versions: list[Version] = versions if versions is not None else []

    def serialize(self) -> bytes:
        vs = self.versions
        n = len(vs)
        vids = [v.vid.encode("utf-8") for v in vs]
        dds = [v.dd.encode("utf-8") for v in vs]
        env = msgpack.packb({
            "v": FORMAT_VERSION,
            "n": n,
            "mt": struct.pack(f"<{n}d", *(v.mt for v in vs)),
            "t": bytes(v.vtype for v in vs),
            "bl": struct.pack(f"<{n}I", *(len(v.blob) for v in vs)),
            "vl": struct.pack(f"<{n}H", *map(len, vids)),
            "dl": struct.pack(f"<{n}H", *map(len, dds)),
            "vid": b"".join(vids),
            "dd": b"".join(dds),
        })
        payload = b"".join([len(env).to_bytes(4, "little"), env]
                           + [v.blob for v in vs])
        return b"".join((MAGIC, crc32c(payload).to_bytes(4, "little"), payload))

    @classmethod
    def parse(cls, raw: bytes) -> "XLMeta":
        if len(raw) < 12 or raw[:4] != MAGIC:
            raise se.CorruptedFormat("bad meta magic or truncated header")
        if crc32c(raw, offset=8) != int.from_bytes(raw[4:8], "little"):
            raise se.CorruptedFormat("meta crc mismatch")
        env_len = int.from_bytes(raw[8:12], "little")
        if 12 + env_len > len(raw):
            raise se.CorruptedFormat("bad envelope length")
        try:
            env = msgpack.unpackb(raw[12:12 + env_len])
        except ValueError as e:
            raise se.CorruptedFormat(f"meta unpack: {e}") from e
        if not isinstance(env, dict) or env.get("v") != FORMAT_VERSION:
            raise se.CorruptedFormat("unknown meta version")
        try:
            n = env["n"]
            mts = struct.unpack(f"<{n}d", env["mt"])
            vts = env["t"]
            bls = struct.unpack(f"<{n}I", env["bl"])
            vids = _split(env["vid"], struct.unpack(f"<{n}H", env["vl"]))
            dds = _split(env["dd"], struct.unpack(f"<{n}H", env["dl"]))
            if len(vts) != n or sum(bls) != len(raw) - 12 - env_len:
                raise se.CorruptedFormat("bad column lengths")
        except (KeyError, TypeError, struct.error, UnicodeDecodeError) as e:
            raise se.CorruptedFormat(f"bad version columns: {e}") from e
        versions, pos = [], 12 + env_len
        for i in range(n):
            versions.append(Version(mts[i], vids[i], vts[i], dds[i],
                                    raw[pos:pos + bls[i]]))
            pos += bls[i]
        return cls(versions)

    def add_version(self, fi: FileInfo) -> None:
        """Insert fi's version; an entry with the same version id (the null
        version included) is replaced. Stable newest-first order: equal
        mod_times keep existing-before-new."""
        doc = _fi_to_doc(fi)
        ver = Version(fi.mod_time, fi.version_id, doc["t"],
                      fi.data_dir if not fi.deleted else "", msgpack.packb(doc))
        self.versions = [v for v in self.versions if v.vid != fi.version_id]
        self.versions.append(ver)
        self.versions.sort(key=lambda v: v.mt, reverse=True)

    def delete_version(self, version_id: str, volume: str, name: str) -> FileInfo:
        """Remove a version; returns its FileInfo (caller removes its data dir)."""
        if version_id == NULL_VERSION_REQ:
            version_id = ""
        for i, v in enumerate(self.versions):
            if v.vid == version_id:
                del self.versions[i]
                return _doc_to_fi(v.doc, volume, name)
        raise se.FileVersionNotFound(f"{name} vid={version_id!r}")

    def _fileinfo(self, i: int, volume: str, name: str) -> FileInfo:
        fi = _doc_to_fi(self.versions[i].doc, volume, name)
        fi.is_latest = i == 0
        fi.num_versions = len(self.versions)
        return fi

    def to_fileinfo(self, volume: str, name: str,
                    version_id: str | None = None) -> FileInfo:
        """Resolve a version (None/'' => latest; "null" => the null version)."""
        if not self.versions:
            raise se.FileNotFound(name)
        if version_id in (None, ""):
            return self._fileinfo(0, volume, name)
        return self.exact_version(volume, name, version_id)

    def exact_version(self, volume: str, name: str, version_id: str) -> FileInfo:
        """Exact-id lookup: '' (or "null") matches ONLY the null version."""
        if version_id == NULL_VERSION_REQ:
            version_id = ""
        for i, v in enumerate(self.versions):
            if v.vid == version_id:
                return self._fileinfo(i, volume, name)
        raise se.FileVersionNotFound(f"{name} vid={version_id!r}")
