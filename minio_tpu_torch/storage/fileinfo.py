"""FileInfo / ErasureInfo: the per-version object metadata model.

The currency of the whole stack — every StorageAPI metadata call trades in
FileInfo (reference: FileInfo struct cmd/storage-datatypes.go:39, ErasureInfo
cmd/erasure-metadata.go:44). Serialized into the per-object journal by
storage/xlmeta.py.
"""

from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field


@dataclass
class ChecksumInfo:
    """Bitrot checksum of one part on one drive (cmd/erasure-metadata.go:60).

    For streaming algorithms the hash lives interleaved in the shard file and
    `hash` stays empty; whole-file algorithms store the digest here."""

    part_number: int
    algorithm: str
    hash: bytes = b""


@dataclass
class ErasureInfo:
    """Erasure geometry + per-drive placement for one object version
    (cmd/erasure-metadata.go:44-58)."""

    algorithm: str = "rs-vandermonde"
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0                      # 1-based shard index this drive holds
    distribution: list[int] = field(default_factory=list)
    checksums: list[ChecksumInfo] = field(default_factory=list)

    def shard_size(self) -> int:
        """Ceil(block_size / k): shard chunk per erasure block."""
        from minio_tpu_torch.utils import shardmath
        return shardmath.shard_size(self.block_size, self.data_blocks)

    def shard_file_size(self, total_length: int) -> int:
        """Final size of one shard file for an object of total_length bytes
        (cmd/erasure-coding.go:120-133)."""
        from minio_tpu_torch.utils import shardmath
        return shardmath.shard_file_size(total_length, self.block_size, self.data_blocks)

    def shard_file_offset(self, start_offset: int, length: int, total_length: int) -> int:
        """Offset within a shard file up to which data must be read to serve
        [start_offset, start_offset+length) of the object
        (cmd/erasure-coding.go:134-143)."""
        from minio_tpu_torch.utils import shardmath
        return shardmath.shard_file_offset(
            start_offset, length, total_length, self.block_size, self.data_blocks
        )


@dataclass
class PartInfo:
    number: int
    size: int                      # stored (possibly compressed/encrypted) size
    actual_size: int               # original user-visible size
    mod_time: float = 0.0
    etag: str = ""


@dataclass
class FileInfo:
    """One object version as seen by one drive (cmd/storage-datatypes.go:39)."""

    volume: str = ""
    name: str = ""
    version_id: str = ""           # "" == null version
    is_latest: bool = True
    deleted: bool = False          # delete marker
    data_dir: str = ""             # uuid dir holding part files
    mod_time: float = 0.0
    size: int = 0
    metadata: dict[str, str] = field(default_factory=dict)
    parts: list[PartInfo] = field(default_factory=list)
    erasure: ErasureInfo = field(default_factory=ErasureInfo)
    inline_data: bytes = b""       # small objects inlined into the journal
    fresh: bool = False            # first version of the object
    # population-only fields (not persisted):
    num_versions: int = 0
    successor_mod_time: float = 0.0

    @staticmethod
    def new(volume: str, name: str, version_id: str = "") -> "FileInfo":
        return FileInfo(volume=volume, name=name, version_id=version_id,
                        data_dir=str(uuid.uuid4()), mod_time=time.time())

    def clone(self) -> "FileInfo":
        """Independent copy safe for per-drive mutation (erasure.index,
        checksum hashes). Hand-rolled __new__/__dict__ copy: this runs
        once per drive per op on the hot request path, where both
        copy.deepcopy (~200us) and dataclasses.replace (~10us per nested
        object) measurably cap ops/s. inline_data/str fields are immutable
        and shared deliberately."""
        e = self.erasure
        ne = ErasureInfo.__new__(ErasureInfo)
        ne.__dict__.update(e.__dict__)
        ne.distribution = list(e.distribution)
        ne.checksums = [ChecksumInfo(c.part_number, c.algorithm, c.hash)
                        for c in e.checksums]
        out = FileInfo.__new__(FileInfo)
        out.__dict__.update(self.__dict__)
        out.metadata = dict(self.metadata)
        out.parts = [PartInfo(p.number, p.size, p.actual_size, p.mod_time,
                              p.etag) for p in self.parts]
        out.erasure = ne
        return out

    def to_object_part_offset(self, offset: int) -> tuple[int, int]:
        """(part index, offset inside part) for a global object offset
        (cmd/erasure-metadata.go:156-180)."""
        if offset == 0:
            return 0, 0
        remaining = offset
        for i, part in enumerate(self.parts):
            if remaining < part.size:
                return i, remaining
            remaining -= part.size
        from minio_tpu_torch.utils import errors as se
        raise se.InvalidRange(self.volume, self.name, f"offset {offset} beyond object size")
