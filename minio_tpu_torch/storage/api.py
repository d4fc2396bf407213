"""StorageAPI — the drive interface the erasure layer calls.

The subset of minio_tpu/storage/api.py the port uses. LocalDrive
(storage/local.py) implements it; the interface lets tests put a wrapping
drive in front of a real one.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import BinaryIO, Iterable, Iterator

from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.utils import errors as se


@dataclass
class VolInfo:
    name: str
    created: float


@dataclass
class DiskInfo:
    """Identity and space of one drive (reference DiskInfo,
    cmd/storage-interface.go:36-41): pool placement weighs `free`, the
    admin info and the scrape read the rest."""

    free: int = 0
    total: int = 0
    used: int = 0
    used_inodes: int = 0
    endpoint: str = ""
    mount_path: str = ""
    id: str = ""
    healing: bool = False


@dataclass
class WalkEntry:
    """One entry from walk_dir: an object's name and its raw journal."""

    name: str
    meta: bytes = b""


# Lexicographic upper bound for any legal object-name suffix (names cap at
# 1024 chars): appended to a prefix it names the largest key that prefix
# range can contain. walk_dir's subtree prune compares against it, and
# delimiter listings resume past a whole CommonPrefix group by passing
# marker + MARKER_GROUP_PAD as start_after.
MARKER_GROUP_PAD = "\U0010ffff" * 1025


def group_start_after(marker: str, delimiter: str) -> str:
    """start_after for a listing continuation: when the marker is a
    CommonPrefix (a delimiter listing rolled a group up), resume past the
    whole group so the walk prunes its subtree instead of parsing and
    discarding every journal inside it."""
    if delimiter and marker.endswith(delimiter):
        return marker + MARKER_GROUP_PAD
    return marker


class StorageAPI(abc.ABC):
    def is_online(self) -> bool:
        return True

    @abc.abstractmethod
    def endpoint(self) -> str: ...

    @abc.abstractmethod
    def disk_info(self, *, with_id: bool = True) -> DiskInfo:
        """Space and identity; `with_id=False` leaves `id` empty and skips
        reading it (pool placement needs only `free`)."""

    # --- identity ---

    @abc.abstractmethod
    def read_format(self) -> dict: ...

    @abc.abstractmethod
    def write_format(self, fmt: dict) -> None: ...

    @abc.abstractmethod
    def get_disk_id(self) -> str:
        """The drive's UUID; InconsistentDisk if it is not the one the
        drive was bound to."""

    @abc.abstractmethod
    def set_disk_id(self, disk_id: str) -> None:
        """Bind the drive to the slot UUID it was placed under."""

    # --- volumes ---

    @abc.abstractmethod
    def make_vol(self, volume: str) -> None: ...

    @abc.abstractmethod
    def list_vols(self) -> list[VolInfo]: ...

    @abc.abstractmethod
    def stat_vol(self, volume: str) -> VolInfo: ...

    @abc.abstractmethod
    def delete_vol(self, volume: str) -> None:
        """Remove an empty volume (VolumeNotEmpty otherwise)."""

    # --- files ---

    @abc.abstractmethod
    def delete(self, volume: str, path: str, recursive: bool = False) -> None: ...

    @abc.abstractmethod
    def write_all(self, volume: str, path: str, data: bytes) -> None:
        """Write a small file whole (fsynced, then renamed into place)."""

    @abc.abstractmethod
    def read_all(self, volume: str, path: str) -> bytes: ...

    @abc.abstractmethod
    def stat_file(self, volume: str, path: str) -> tuple[int, int, int]:
        """(inode, mtime in ns, size) of a file."""

    @abc.abstractmethod
    def list_dir(self, volume: str, dir_path: str) -> list[str]:
        """Sorted entry names; directories carry a trailing '/'."""

    @abc.abstractmethod
    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None: ...

    @abc.abstractmethod
    def create_file(self, volume: str, path: str, chunks: Iterable[bytes]) -> int:
        """Stream chunks into a new file (fsynced before return)."""

    @abc.abstractmethod
    def read_file_stream(self, volume: str, path: str) -> BinaryIO: ...

    # --- versioned metadata ---

    @abc.abstractmethod
    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def write_metadata_single(self, volume: str, path: str, fi: FileInfo,
                              raw: bytes, defer_reclaim: bool = False
                              ) -> str | None:
        """Commit an inline version from its caller-serialized one-version
        journal `raw`; with defer_reclaim, as rename_data's."""

    @abc.abstractmethod
    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo: ...

    @abc.abstractmethod
    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None: ...

    @abc.abstractmethod
    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str,
                    defer_reclaim: bool = False) -> str | None:
        """Commit staged part files + the journal entry (the per-drive
        atomic commit point). With defer_reclaim, what the commit displaces
        is kept aside and a token returned for commit_rename / undo_rename."""

    @abc.abstractmethod
    def commit_rename(self, token: str) -> None:
        """Quorum reached: drop what rename_data displaced."""

    @abc.abstractmethod
    def undo_rename(self, volume: str, path: str, fi: FileInfo,
                    token: str | None) -> None:
        """Quorum failed: remove the committed version and restore what
        rename_data displaced."""

    @abc.abstractmethod
    def walk_dir(self, volume: str, prefix: str = "",
                 start_after: str = "") -> Iterator[WalkEntry]:
        """Stream the journals under prefix in lexicographic order of the
        full object name, skipping names <= start_after WITHOUT reading
        their journals (whole subtrees below the marker are pruned, so a
        mid-bucket resume is O(page); reference WalkDir forward-to,
        cmd/metacache-walk.go)."""

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
