"""StorageAPI — the drive interface the erasure layer calls.

The subset of minio_tpu/storage/api.py this slice uses. LocalDrive
(storage/local.py) implements it; the interface lets tests put a wrapping
drive in front of a real one.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import BinaryIO, Iterable

from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.utils import errors as se


@dataclass
class VolInfo:
    name: str
    created: float


class StorageAPI(abc.ABC):
    def is_online(self) -> bool:
        return True

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    # --- identity ---

    @abc.abstractmethod
    def read_format(self) -> dict: ...

    @abc.abstractmethod
    def write_format(self, fmt: dict) -> None: ...

    # --- volumes ---

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    # --- files ---

    @abc.abstractmethod
    def delete(self, volume: str, path: str, recursive: bool = False) -> None: ...

    @abc.abstractmethod
    def create_file(self, volume: str, path: str, chunks: Iterable[bytes]) -> int:
        """Stream chunks into a new file (fsynced before return)."""

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str) -> BinaryIO: ...

    # --- versioned metadata ---

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        """Commit staged part files + the journal entry (the per-drive
        atomic commit point)."""

    def check_parts(self, volume: str, path: str, fi: FileInfo) -> None:
        """Shallow part-presence check: every part file exists with exactly
        the bitrot-framed size (reference CheckParts, cmd/xl-storage.go).
        Raises FileNotFound / FileCorrupt."""
        from minio_tpu_torch.ops import bitrot

        algo = next((c.algorithm for c in fi.erasure.checksums),
                    bitrot.WRITE_ALGORITHM)
        shard_size = fi.erasure.shard_size()
        for part in fi.parts:
            expected = bitrot.bitrot_shard_file_size(
                fi.erasure.shard_file_size(part.size), shard_size, algo)
            rel = f"{path}/{fi.data_dir}/part.{part.number}"
            with self.read_file_stream(volume, rel) as f:
                f.seek(0, 2)
                if f.tell() != expected:
                    raise se.FileCorrupt(
                        f"{volume}/{rel}: size {f.tell()} != expected {expected}")
