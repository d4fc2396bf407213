"""LocalDrive — POSIX implementation of StorageAPI.

Same layout and commit protocol as minio_tpu/storage/local.py, so a drive
written by either package is served by the other:

    <root>/.mtpu.sys/format.json      drive identity (format v1)
    <root>/.mtpu.sys/tmp/<uuid>/      staging area for in-flight writes
    <root>/.mtpu.sys/tmp/reclaim-<uuid>/  what a deferred commit displaced
    <root>/.mtpu.sys/multipart/<key-hash>/<upload-id>/  upload sessions
    <root>/<volume>/<object-key>/meta.mp          version journal
    <root>/<volume>/<object-key>/<data-dir>/part.N  bitrot-framed shards

Shards stream into the tmp area; rename_data moves the data dir into the
object dir and rewrites the journal (the per-drive atomic commit point).
fsync points match the JAX package: every shard file before close, every
journal before its rename, the object directory after the commit rename,
the format file and its directory, every write_all file, the target
directory of rename_file.

rename_data(defer_reclaim=True) and the inline store
write_metadata_single(defer_reclaim=True) park what a commit displaces
(the replaced version's journal entry and data dir) in a reclaim capsule
and return its token: commit_rename drops the capsule once the commit
made quorum, undo_rename puts it back when it did not.

walk_dir streams a volume's journals in lexicographic order of the full
object name, the order the listing's k-way merge relies on.

read_version keeps parsed journals in a read cache validated by each
file's (inode, mtime, size), as the JAX package's does: a quorum read of
a multipart object's journal (hundreds of parts, decoded by the port's
pure-Python msgpack) otherwise costs milliseconds per drive and request.

The group-commit metadata plane (metaplane/, on unless MTPU_METAPLANE=0)
arms a per-drive WAL at mount, after replaying any WAL a previous process
left (a replay runs whatever the gate says). Armed, every journal store
and removal rides the WAL and is acknowledged by its shared fsync; the
meta.mp files materialize later, so every journal read consults the
pending overlay before the read cache and the disk, and walk_dir,
list_dir and a volume delete flush the WAL first. write_all_async is the
blob lane of system files (multipart part journals, config documents).

Left for later slices (ROADMAP.md): O_DIRECT shard writes.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import threading
import time
import uuid
from collections import OrderedDict
from typing import BinaryIO, Iterable, Iterator

from minio_tpu_torch import metaplane, obs
from minio_tpu_torch.storage.api import (MARKER_GROUP_PAD, DiskInfo,
                                         StorageAPI, VolInfo, WalkEntry)
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.xlmeta import XLMeta
from minio_tpu_torch.utils import errors as se

SYS_VOL = ".mtpu.sys"
META_FILE = "meta.mp"
FORMAT_FILE = "format.json"


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync at a commit point."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _has_subdirs(entry: os.DirEntry) -> bool:
    """False when the directory holds no subdirectory: its link count is
    2 ('.' and its name in the parent; each subdirectory's '..' adds one
    on POSIX filesystems). A filesystem that does not count them reports
    1, and the walk scans the directory. One stat instead of a scan: the
    walk asks this of every object directory."""
    try:
        return entry.stat(follow_symlinks=False).st_nlink != 2
    except OSError:
        return True


def _read_small_file(path: str) -> bytes | None:
    """A small file's bytes through raw descriptors (open, read to EOF,
    close: the fewest system calls), or None when it cannot be read."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return None
    try:
        chunks = []
        while chunk := os.read(fd, 1 << 16):
            chunks.append(chunk)
        return b"".join(chunks)
    except OSError:
        return None
    finally:
        os.close(fd)


class LocalDrive(StorageAPI):
    # The journal read cache (minio_tpu/storage/local.py
    # _cached_meta_entry): a hit needs the file's (inode, mtime, size) to
    # be the cached one, and every write replaces meta.mp by a rename, so
    # a new journal has a new inode. A journal modified within
    # _RACY_STAT_NS of its read is not cached: a coarse mtime tick could
    # otherwise give two journals one signature (git's racy-stat guard).
    _RACY_STAT_NS = 20_000_000
    _META_CACHE_CAP = 4096

    def __init__(self, root: str, endpoint: str = ""):
        """endpoint: the drive's name in a cluster (its URL endpoint); the
        root path by default."""
        self.root = os.path.abspath(root)
        self._endpoint = endpoint or self.root
        # (volume, path) -> (signature, XLMeta, {version id: FileInfo})
        self._meta_cache: OrderedDict = OrderedDict()
        self._meta_mu = threading.Lock()
        # The slot UUID this drive was placed under (set_disk_id); a drive
        # swapped under the path answers get_disk_id with InconsistentDisk.
        self._expected_id = ""
        # Volume existence with a short positive TTL (the WAL committer's
        # per-record check).
        self._vol_ok: dict[str, float] = {}
        # Volumes this process created empty -> the keys it may have
        # journaled there: a key outside the set provably has no journal,
        # so the committer skips its existence check. None: tracking lost.
        self._fresh_vols: dict[str, set | None] = {}
        self._fresh_vol_cap = 1 << 17
        # minio_tpu_drive_latency_seconds{drive,op} over obs.DRIVE_OPS, and
        # `storage` records while someone traces.
        self._observe_op = obs.drive_op_observer(self.root)
        try:
            os.makedirs(os.path.join(self.root, SYS_VOL, "tmp"), exist_ok=True)
        except OSError as e:
            raise se.DiskAccessDenied(str(e)) from e
        # (applied, failed, seconds) of the WAL replay at this mount, if any.
        self.last_replay: tuple[int, int, float] | None = None
        self._wal = None
        if metaplane.enabled():
            from minio_tpu_torch.metaplane.groupcommit import DriveWAL

            self._wal = DriveWAL(self)   # replays a leftover WAL first
        else:
            from minio_tpu_torch.metaplane import wal as walfmt

            wal_dir = os.path.join(self.root, SYS_VOL, "wal")
            if walfmt.segment_paths(wal_dir):
                from minio_tpu_torch.metaplane import groupcommit

                groupcommit.replay_all(self, wal_dir)

    def sys_volume(self) -> str:
        return SYS_VOL

    def endpoint(self) -> str:
        return self._endpoint

    def disk_info(self, *, with_id: bool = True) -> DiskInfo:
        st = os.statvfs(self.root)
        disk_id = ""
        if with_id:
            try:
                disk_id = self.get_disk_id()
            except se.StorageError:
                pass
        return DiskInfo(free=st.f_bavail * st.f_frsize,
                        total=st.f_blocks * st.f_frsize,
                        used=(st.f_blocks - st.f_bfree) * st.f_frsize,
                        used_inodes=st.f_files - st.f_ffree,
                        endpoint=self._endpoint, mount_path=self.root, id=disk_id)

    # ---------- identity ----------

    def _format_path(self) -> str:
        return os.path.join(self.root, SYS_VOL, FORMAT_FILE)

    def read_format(self) -> dict:
        if not os.path.isdir(self.root):
            raise se.FaultyDisk(f"drive root missing (unmounted?): {self.root}")
        try:
            with open(self._format_path(), "rb") as f:
                return json.load(f)
        except FileNotFoundError:
            raise se.UnformattedDisk(self.root) from None
        except (OSError, ValueError) as e:
            raise se.CorruptedFormat(str(e)) from e

    def write_format(self, fmt: dict) -> None:
        if not os.path.isdir(self.root):
            raise se.FaultyDisk(f"drive root missing (unmounted?): {self.root}")
        os.makedirs(os.path.join(self.root, SYS_VOL, "tmp"), exist_ok=True)
        tmp = self._format_path() + f".tmp.{uuid.uuid4().hex}"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(fmt, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._format_path())
        _fsync_dir(os.path.dirname(self._format_path()))

    def get_disk_id(self) -> str:
        """The drive's UUID from its format.json, checked against the one
        it was placed under (minio_tpu/storage/local.py get_disk_id)."""
        fmt = self.read_format()
        this = fmt.get("erasure", {}).get("this", "") or fmt.get("this", "")
        if self._expected_id and this != self._expected_id:
            raise se.InconsistentDisk(
                f"drive {self.root}: id {this!r} != expected {self._expected_id!r}")
        return this

    def set_disk_id(self, disk_id: str) -> None:
        self._expected_id = disk_id

    # ---------- path mapping ----------

    def _vol_dir(self, volume: str) -> str:
        if not volume or volume.startswith("/") or ".." in volume.split("/"):
            raise se.VolumeNotFound(volume)
        return os.path.join(self.root, volume)

    def _file_path(self, volume: str, path: str) -> str:
        parts = [p for p in path.split("/") if p not in ("", ".")]
        if any(p == ".." for p in parts):
            raise se.FileAccessDenied(path)
        return os.path.join(self._vol_dir(volume), *parts)

    # ---------- volumes ----------

    def make_vol(self, volume: str) -> None:
        d = self._vol_dir(volume)
        self._vol_ok.pop(volume, None)
        try:
            # mkdir, not makedirs: a missing root means an unmounted drive.
            os.mkdir(d)
            self._fresh_vols[volume] = set()
        except FileExistsError:
            raise se.VolumeExists(volume) from None
        except FileNotFoundError:
            raise se.FaultyDisk(
                f"drive root missing (unmounted?): {self.root}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def list_vols(self) -> list[VolInfo]:
        out = []
        try:
            with os.scandir(self.root) as it:
                for entry in it:
                    if entry.is_dir() and entry.name != SYS_VOL:
                        out.append(VolInfo(entry.name, entry.stat().st_ctime))
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        return sorted(out, key=lambda v: v.name)

    def stat_vol(self, volume: str) -> VolInfo:
        try:
            st = os.stat(self._vol_dir(volume))
        except FileNotFoundError:
            raise se.VolumeNotFound(volume) from None
        return VolInfo(volume, st.st_ctime)

    def _note_journal_key(self, volume: str, path: str) -> None:
        """A journal may now exist at (volume, path); past the cap the
        volume's tracking is dropped, never wrong."""
        s = self._fresh_vols.get(volume)
        if s is None:
            return
        if len(s) >= self._fresh_vol_cap:
            self._fresh_vols[volume] = None
            return
        s.add(path)

    def journal_known_absent(self, volume: str, path: str) -> bool:
        """True only when this process created the volume empty and never
        journaled the key (the WAL committer then skips its stat)."""
        if not metaplane.single_owner():
            return False
        s = self._fresh_vols.get(volume)
        return s is not None and path not in s

    def _stat_vol_cached(self, volume: str) -> None:
        """stat_vol with a 2 s positive TTL: the committer's per-record
        volume check. make_vol and delete_vol invalidate it."""
        now = time.monotonic()
        exp = self._vol_ok.get(volume)
        if exp is not None and exp > now:
            return
        self.stat_vol(volume)
        self._vol_ok[volume] = now + 2.0

    def delete_vol(self, volume: str, force: bool = False) -> None:
        """Remove an empty volume; with `force`, the volume and all in it
        (the storage plane's delete_vol route, as in the JAX package)."""
        d = self._vol_dir(volume)
        self._vol_ok.pop(volume, None)
        self._fresh_vols.pop(volume, None)
        if self._wal is not None:
            if force:
                self._wal.forget_subtree(volume, "")
            else:
                # rmdir decides emptiness from the filesystem: acked
                # journals still in the overlay must be on disk first.
                self._wal.flush()
        try:
            if force:
                shutil.rmtree(d)
            else:
                os.rmdir(d)
        except FileNotFoundError:
            raise se.VolumeNotFound(volume) from None
        except OSError as e:
            if e.errno == errno.ENOTEMPTY:
                raise se.VolumeNotEmpty(volume) from None
            raise se.FaultyDisk(str(e)) from e

    # ---------- files ----------

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        fp = self._file_path(volume, path)
        wal_blob_pending = False
        if self._wal is not None:
            # What vanishes out of band must not come back at replay.
            if recursive:
                self._wal.forget_subtree(volume, path)
            elif os.path.basename(fp) == META_FILE:
                self._wal.forget_key(volume, os.path.dirname(path))
            elif self._wal.has_blob_state(volume, path):
                wal_blob_pending = self._wal.forget_blob(volume, path)
        try:
            if recursive:
                shutil.rmtree(fp)
            elif os.path.isdir(fp):
                os.rmdir(fp)
            else:
                os.remove(fp)
        except FileNotFoundError:
            if wal_blob_pending:
                return   # the file only ever lived in the overlay
            raise se.FileNotFound(f"{volume}/{path}") from None
        except OSError as e:
            if e.errno == errno.ENOTEMPTY:
                raise se.VolumeNotEmpty(path) from None
            raise se.FaultyDisk(str(e)) from e
        self._prune_empty_parents(os.path.dirname(fp), volume)

    def _prune_empty_parents(self, d: str, volume: str) -> None:
        vol_dir = self._vol_dir(volume)
        while d.startswith(vol_dir) and d != vol_dir:
            try:
                os.rmdir(d)
            except OSError:
                return
            d = os.path.dirname(d)

    def write_all(self, volume: str, path: str, data: bytes) -> None:
        self.stat_vol(volume)
        fp = self._file_path(volume, path)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        tmp = fp + f".tmp.{uuid.uuid4().hex}"
        try:
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, fp)
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def write_all_async(self, volume: str, path: str, data: bytes):
        """write_all through the WAL's blob lane: the future resolves after
        the shared fsync covering the record, and the file materializes
        later. None when the WAL is not armed (callers use write_all)."""
        if self._wal is None:
            return None
        self.stat_vol(volume)
        self._file_path(volume, path)   # validate before journaling
        t0 = time.perf_counter()
        fut = self._wal.submit_blob(volume, path, data)

        def done(f, t0=t0):
            self._observe_op("write_all_async", t0, volume, path, f.exception())

        fut.add_done_callback(obs.ctx_wrap(done))
        return fut

    def _store_blob_disk(self, volume: str, path: str, raw) -> None:
        """Materialize a WAL blob record: tmp + rename, no fsync (the WAL
        holds durability until its checkpoint)."""
        fp = self._file_path(volume, path)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        tmp = fp + f".tmp.{uuid.uuid4().hex}"
        try:
            with open(tmp, "wb") as f:
                f.write(raw)
            os.replace(tmp, fp)
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def _remove_blob_disk(self, volume: str, path: str) -> None:
        fp = self._file_path(volume, path)
        try:
            os.remove(fp)
        except FileNotFoundError:
            pass
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        self._prune_empty_parents(os.path.dirname(fp), volume)

    def _disk_blob_mt(self, volume: str, path: str) -> float | None:
        """mtime of the blob file on disk, None when absent: the replay
        tiebreak of blob records."""
        try:
            return os.stat(self._file_path(volume, path)).st_mtime
        except (FileNotFoundError, NotADirectoryError):
            return None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def stat_file(self, volume: str, path: str) -> tuple[int, int, int]:
        """The file's (inode, mtime in ns, size). For an acked write of it
        still in the WAL overlay, without waiting for the committer to
        write the file: (minus the WAL's generation, unique in the
        process, the write's sequence number in it, its size), a
        signature no file on disk has."""
        if self._wal is not None:
            pe = self._wal.pending_blob(volume, path)
            if pe is not None:
                if pe.removed:
                    raise se.FileNotFound(f"{volume}/{path}")
                return -self._wal.generation, pe.lsn, len(pe.raw)
        try:
            st = os.stat(self._file_path(volume, path))
        except (FileNotFoundError, NotADirectoryError):
            raise se.FileNotFound(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        return st.st_ino, st.st_mtime_ns, st.st_size

    def read_all(self, volume: str, path: str) -> bytes:
        if self._wal is not None:
            pe = self._wal.pending_blob(volume, path)
            if pe is not None:   # acked, not yet on disk: the overlay is the file
                if pe.removed:
                    raise se.FileNotFound(f"{volume}/{path}")
                return pe.raw
        fp = self._file_path(volume, path)
        try:
            with open(fp, "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise se.FileNotFound(f"{volume}/{path}") from None
        except IsADirectoryError:
            raise se.IsNotRegular(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def list_dir(self, volume: str, dir_path: str) -> list[str]:
        if self._wal is not None:
            self._wal.flush()   # the directory must show every acked commit
        try:
            with os.scandir(self._file_path(volume, dir_path)) as it:
                return sorted(e.name + "/" if e.is_dir() else e.name for e in it)
        except FileNotFoundError:
            raise se.FileNotFound(f"{volume}/{dir_path}") from None
        except NotADirectoryError:
            raise se.IsNotRegular(f"{volume}/{dir_path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def rename_file(self, src_volume: str, src_path: str,
                    dst_volume: str, dst_path: str) -> None:
        src = self._file_path(src_volume, src_path)
        dst = self._file_path(dst_volume, dst_path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        try:
            os.replace(src, dst)
        except FileNotFoundError:
            raise se.FileNotFound(f"{src_volume}/{src_path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        _fsync_dir(os.path.dirname(dst))

    def create_file(self, volume: str, path: str, chunks: Iterable[bytes]) -> int:
        with obs.timed_op(self._observe_op, "create_file", volume, path):
            return self._create_file(volume, path, chunks)

    def _create_file(self, volume: str, path: str, chunks: Iterable[bytes]) -> int:
        fp = self._file_path(volume, path)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        written = 0
        try:
            with open(fp, "wb") as f:
                for chunk in chunks:
                    f.write(chunk)
                    written += len(chunk)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        return written

    def append_file(self, volume: str, path: str, data: bytes) -> None:
        """Append and fsync (the storage plane's append_file route)."""
        fp = self._file_path(volume, path)
        os.makedirs(os.path.dirname(fp), exist_ok=True)
        try:
            with open(fp, "ab") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def read_file_stream(self, volume: str, path: str) -> BinaryIO:
        fp = self._file_path(volume, path)
        try:
            return open(fp, "rb")
        except FileNotFoundError:
            raise se.FileNotFound(f"{volume}/{path}") from None
        except IsADirectoryError:
            raise se.IsNotRegular(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    # ---------- versioned metadata ----------

    def _meta_path(self, volume: str, path: str) -> str:
        return os.path.join(self._file_path(volume, path), META_FILE)

    def _load_meta(self, volume: str, path: str) -> XLMeta:
        """A fresh parse of the key's journal (callers mutate it): the
        WAL overlay's when the key has a pending entry, else the disk's."""
        if self._wal is not None:
            pe = self._wal.pending_entry(volume, path)
            if pe is not None:
                if pe.removed:
                    raise se.FileNotFound(f"{volume}/{path}")
                return XLMeta.parse(pe.raw)
        return self._read_meta(volume, path)[0]

    def _read_meta(self, volume: str, path: str) -> tuple[XLMeta, tuple]:
        """The on-disk journal and the (inode, mtime, size) of its file."""
        try:
            with open(self._meta_path(volume, path), "rb") as f:
                st = os.fstat(f.fileno())
                raw = f.read()
        except (FileNotFoundError, NotADirectoryError):
            raise se.FileNotFound(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        return XLMeta.parse(raw), (st.st_ino, st.st_mtime_ns, st.st_size)

    def _disk_meta_mt(self, volume: str, path: str) -> float | None:
        """mod time of the newest version of the journal on disk, None
        when absent: the replay tiebreak (never the overlay's)."""
        try:
            return self._read_meta(volume, path)[0].latest_mt
        except se.FileNotFound:
            return None

    def _store_meta(self, volume: str, path: str, meta: XLMeta) -> None:
        raw = meta.serialize()
        if self._wal is not None:
            # Acked by the shared WAL fsync; meta.mp materializes later.
            self._wal_wait(self._wal.submit_commit(volume, path, raw, meta))
            return
        self._store_meta_disk(volume, path, raw)

    def _store_meta_disk(self, volume: str, path: str, raw,
                         fsync: bool = True) -> None:
        """Write journal bytes to meta.mp: tmp, fsync unless the WAL holds
        durability, rename."""
        mp = self._meta_path(volume, path)
        self._note_journal_key(volume, path)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        tmp = mp + f".tmp.{uuid.uuid4().hex}"
        try:
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, raw)
                if fsync:
                    os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, mp)
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        with self._meta_mu:
            self._meta_cache.pop((volume, path), None)

    def _remove_meta_disk(self, volume: str, path: str) -> None:
        """Remove a journal and prune the empty directories above it."""
        mp = self._meta_path(volume, path)
        try:
            os.remove(mp)
        except (FileNotFoundError, NotADirectoryError):
            pass
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        with self._meta_mu:
            self._meta_cache.pop((volume, path), None)
        obj_dir = os.path.dirname(mp)
        try:
            os.rmdir(obj_dir)
        except OSError:
            return  # data dirs remain, or already gone
        self._prune_empty_parents(os.path.dirname(obj_dir), volume)

    @staticmethod
    def _wal_wait(fut):
        """Wait for a group-commit future (a single's reclaim token); a
        commit that does not come back becomes FaultyDisk."""
        from concurrent.futures import TimeoutError as FutureTimeout

        try:
            return fut.result(timeout=60.0)
        except FutureTimeout:
            raise se.FaultyDisk("wal group commit stalled") from None

    def write_metadata(self, volume: str, path: str, fi: FileInfo) -> None:
        self.stat_vol(volume)
        try:
            meta = self._load_meta(volume, path)
        except se.FileNotFound:
            meta = XLMeta()
        # Replacing a version: reclaim its old data dir (exact-id lookup, so
        # a null-version write never reclaims a versioned entry's data).
        try:
            old = meta.exact_version(volume, path, fi.version_id)
            if old.data_dir and old.data_dir != fi.data_dir and not old.deleted:
                shutil.rmtree(os.path.join(self._file_path(volume, path),
                                           old.data_dir), ignore_errors=True)
        except se.StorageError:
            pass
        meta.add_version(fi)
        self._store_meta(volume, path, meta)

    def write_metadata_single(self, volume: str, path: str, fi: FileInfo,
                              raw: bytes, defer_reclaim: bool = False
                              ) -> str | None:
        with obs.timed_op(self._observe_op, "write_metadata_single", volume, path):
            return self._write_metadata_single(volume, path, fi, raw, defer_reclaim)

    def _write_metadata_single(self, volume: str, path: str, fi: FileInfo,
                               raw: bytes, defer_reclaim: bool = False
                               ) -> str | None:
        """Store an inline version whose one-version journal the caller
        serialized once for the whole set (`raw`); see _single_prework."""
        if self._wal is not None:
            return self._wal_wait(self._wal.submit_single(
                volume, path, fi, raw, XLMeta.parse(raw), defer_reclaim))
        self.stat_vol(volume)
        token, merged = self._single_prework(volume, path, fi, defer_reclaim)
        if merged is not None:
            self._store_meta_disk(volume, path, merged.serialize())
        else:
            self._store_meta_disk(volume, path, raw)
        return token

    def journal_commit_async(self, volume: str, path: str, fi: FileInfo, raw,
                             meta: XLMeta | None = None,
                             defer_reclaim: bool = False):
        """write_metadata_single in two phases: enqueue the record (the
        prework runs in the committer) and return a future that resolves
        to the reclaim token after the shared WAL fsync, so a set submits
        to every drive and then waits once. None when the WAL is not
        armed (callers take the synchronous fan-out)."""
        if self._wal is None:
            return None
        t0 = time.perf_counter()
        fut = self._wal.submit_single(volume, path, fi, raw,
                                      meta if meta is not None else XLMeta.parse(raw),
                                      defer_reclaim)

        def done(f, t0=t0):
            self._observe_op("journal_commit_async", t0, volume, path, f.exception())

        fut.add_done_callback(obs.ctx_wrap(done))
        return fut

    def _reclaim_dir(self, d: str, defer_fs: bool) -> None:
        """Remove a displaced data dir; in the committer (defer_fs) park it
        with one rename and remove it at the next idle drain, so a large
        tree never holds up a group commit."""
        if defer_fs and self._wal is not None:
            trash = os.path.join(self.root, SYS_VOL, "tmp", f"trash-{uuid.uuid4().hex}")
            try:
                os.replace(d, trash)
            except OSError:
                pass
            else:
                self._wal.note_trash(trash)
                return
        shutil.rmtree(d, ignore_errors=True)

    def _single_prework(self, volume: str, path: str, fi: FileInfo,
                        defer_reclaim: bool, assume_new: bool = False,
                        defer_fs: bool = False) -> tuple:
        """The non-commit half of a single-journal store: park (with
        defer_reclaim, returning its token) or reclaim what the write
        displaces, and detect a journal holding other versions, for which
        fi is merged in. Returns (token, merged journal or None, when
        the caller's one-version journal may be stored as it is). Runs in
        the WAL committer when the plane is armed."""
        if assume_new:
            return None, None
        try:
            meta = self._load_meta(volume, path)
        except se.FileNotFound:
            return None, None
        token: str | None = None
        try:
            old = meta.exact_version(volume, path, fi.version_id)
        except se.StorageError:
            old = None
        if old is not None and not old.deleted:
            displaces = bool(old.data_dir and old.data_dir != fi.data_dir)
            if defer_reclaim:
                token = self._stash_displaced(volume, path, old, move_data=displaces)
            elif displaces:
                self._reclaim_dir(os.path.join(self._file_path(volume, path),
                                               old.data_dir), defer_fs)
        if old is None or len(meta.versions) != 1:
            meta.add_version(fi)
            return token, meta
        return token, None

    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        # Inline timing (not obs.timed_op): a cached journal read is a few
        # microseconds, and a generator context manager costs about one.
        t0 = time.perf_counter()
        err: BaseException | None = None
        try:
            return self._read_version(volume, path, version_id)
        except BaseException as e:
            err = e
            raise
        finally:
            self._observe_op("read_version", t0, volume, path, err)

    def _read_version(self, volume: str, path: str,
                      version_id: str = "") -> FileInfo:
        """The version's FileInfo (a copy: callers mutate it): from the WAL
        overlay while the key has a pending entry, else from the journal
        read cache while the file is unchanged."""
        key = (volume, path)
        hit = None
        if self._wal is not None:
            pe = self._wal.pending_entry(volume, path)
            if pe is not None:
                if pe.removed:
                    raise se.FileNotFound(f"{volume}/{path}")
                if pe.meta is None:
                    pe.meta = XLMeta.parse(pe.raw)
                hit = (None, pe.meta, pe.memo)
        if hit is None:
            try:
                st = os.stat(self._meta_path(volume, path))
            except (FileNotFoundError, NotADirectoryError):
                raise se.FileNotFound(f"{volume}/{path}") from None
            except OSError as e:
                raise se.FaultyDisk(str(e)) from e
            with self._meta_mu:
                hit = self._meta_cache.get(key)
                if hit is not None and hit[0] == (st.st_ino, st.st_mtime_ns,
                                                  st.st_size):
                    self._meta_cache.move_to_end(key)
                else:
                    hit = None
        if hit is None:
            meta, sig = self._read_meta(volume, path)
            hit = (sig, meta, {})
            if time.time_ns() - sig[1] > self._RACY_STAT_NS:
                with self._meta_mu:
                    self._meta_cache[key] = hit
                    while len(self._meta_cache) > self._META_CACHE_CAP:
                        self._meta_cache.popitem(last=False)
        fi = hit[2].get(version_id)
        if fi is None:
            fi = hit[2][version_id] = hit[1].to_fileinfo(volume, path, version_id)
        return fi.clone()

    def read_xl(self, volume: str, path: str) -> bytes:
        """The key's raw journal: the WAL overlay's while it has a pending
        entry, else meta.mp (the storage plane's read_xl route)."""
        if self._wal is not None:
            pe = self._wal.pending_entry(volume, path)
            if pe is not None:
                if pe.removed:
                    raise se.FileNotFound(f"{volume}/{path}")
                return pe.raw
        try:
            with open(self._meta_path(volume, path), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError):
            raise se.FileNotFound(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def delete_version(self, volume: str, path: str, fi: FileInfo) -> None:
        try:
            meta = self._load_meta(volume, path)
        except se.FileNotFound:
            if fi.deleted:  # a delete marker on a missing object is legal
                meta = XLMeta()
                meta.add_version(fi)
                self._store_meta(volume, path, meta)
                return
            raise
        if fi.deleted:
            meta.add_version(fi)
            self._store_meta(volume, path, meta)
            return
        removed = meta.delete_version(fi.version_id, volume, path)
        if removed.data_dir:
            shutil.rmtree(os.path.join(self._file_path(volume, path),
                                       removed.data_dir), ignore_errors=True)
        if meta.versions:
            self._store_meta(volume, path, meta)
        elif self._wal is not None:
            # WAL-ordered, or replay would bring back an earlier commit.
            self._wal_wait(self._wal.submit_remove(volume, path))
        else:
            self._remove_meta_disk(volume, path)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str,
                    defer_reclaim: bool = False) -> str | None:
        with obs.timed_op(self._observe_op, "rename_data", dst_volume, dst_path):
            return self._rename_data(src_volume, src_path, fi, dst_volume,
                                     dst_path, defer_reclaim)

    def _rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                     dst_volume: str, dst_path: str,
                     defer_reclaim: bool = False) -> str | None:
        src_dir = self._file_path(src_volume, src_path)
        obj_dir = self._file_path(dst_volume, dst_path)
        os.makedirs(obj_dir, exist_ok=True)
        token: str | None = None
        if fi.data_dir:
            dst_data = os.path.join(obj_dir, fi.data_dir)
            # Heal overwrites an existing data dir of the same name: move the
            # old one aside and drop it only once the new one is in place.
            aside = None
            if os.path.isdir(dst_data):
                aside = dst_data + f".old.{uuid.uuid4().hex}"
                os.replace(dst_data, aside)
            try:
                os.replace(src_dir, dst_data)
            except FileNotFoundError:
                if aside:
                    os.replace(aside, dst_data)
                raise se.FileNotFound(f"{src_volume}/{src_path}") from None
            except OSError as e:
                if aside:
                    os.replace(aside, dst_data)
                raise se.FaultyDisk(str(e)) from e
            if aside:
                shutil.rmtree(aside, ignore_errors=True)
        try:
            meta = self._load_meta(dst_volume, dst_path)
        except (se.FileNotFound, se.CorruptedFormat):
            # No journal, or an unreadable one whose history is already
            # lost: rebuild from the incoming version (heal re-adds the rest).
            meta = XLMeta()
        try:
            old = meta.exact_version(dst_volume, dst_path, fi.version_id)
        except se.StorageError:
            old = None
        if old is not None:
            displaces_data = bool(old.data_dir and old.data_dir != fi.data_dir
                                  and not old.deleted)
            if defer_reclaim:
                token = self._stash_displaced(dst_volume, dst_path, old,
                                              move_data=displaces_data)
            elif displaces_data:
                shutil.rmtree(os.path.join(obj_dir, old.data_dir),
                              ignore_errors=True)
        meta.add_version(fi)
        self._store_meta(dst_volume, dst_path, meta)
        _fsync_dir(obj_dir)
        return token

    def _capsule(self, token: str | None) -> str | None:
        if not token or "/" in token or ".." in token:
            return None
        return os.path.join(self.root, SYS_VOL, "tmp", token)

    def _stash_displaced(self, volume: str, path: str, old: FileInfo,
                         move_data: bool) -> str:
        """Park a displaced version in a reclaim capsule (its journal entry
        in old.mp, its data dir in olddata when move_data) and return the
        token. A failed stash rolls the data move back and raises
        FaultyDisk, which the caller's quorum counts as a drive error."""
        token = f"reclaim-{uuid.uuid4().hex}"
        cap = self._capsule(token)
        old_data = (os.path.join(self._file_path(volume, path), old.data_dir)
                    if old.data_dir else "")
        moved = False
        try:
            os.makedirs(cap, exist_ok=True)
            oldj = XLMeta()
            oldj.add_version(old)
            with open(os.path.join(cap, "old.mp"), "wb") as f:
                f.write(oldj.serialize())
            if move_data and os.path.isdir(old_data):
                os.replace(old_data, os.path.join(cap, "olddata"))
                moved = True
        except OSError as e:
            if moved:
                try:
                    os.replace(os.path.join(cap, "olddata"), old_data)
                except OSError:
                    pass
            shutil.rmtree(cap, ignore_errors=True)
            raise se.FaultyDisk(f"reclaim stash: {e}") from e
        return token

    def commit_rename(self, token: str) -> None:
        cap = self._capsule(token)
        if cap is not None:
            shutil.rmtree(cap, ignore_errors=True)

    def undo_rename(self, volume: str, path: str, fi: FileInfo,
                    token: str | None) -> None:
        try:
            self.delete_version(volume, path, fi)
        except se.StorageError:
            pass
        cap = self._capsule(token)
        if cap is None or not os.path.isdir(cap):
            return
        oldmp = os.path.join(cap, "old.mp")
        if os.path.exists(oldmp):
            try:
                with open(oldmp, "rb") as f:
                    old = XLMeta.parse(f.read()).to_fileinfo(volume, path)
                olddata = os.path.join(cap, "olddata")
                if os.path.isdir(olddata) and old.data_dir:
                    obj_dir = self._file_path(volume, path)
                    os.makedirs(obj_dir, exist_ok=True)
                    os.replace(olddata, os.path.join(obj_dir, old.data_dir))
                try:
                    meta = self._load_meta(volume, path)
                except se.StorageError:
                    meta = XLMeta()
                meta.add_version(old)
                self._store_meta(volume, path, meta)
            except (se.StorageError, OSError):
                pass    # best effort: heal converges the rest
        shutil.rmtree(cap, ignore_errors=True)

    # ---------- listing ----------

    def walk_dir(self, volume: str, prefix: str = "",
                 start_after: str = "") -> Iterator[WalkEntry]:
        """Sorted journal walk. Entries come out in lexicographic order of
        the full object name. A per-directory sort alone is not that order
        ('a.txt' < 'a/b' because '.' < '/', yet a naive walk emits all of
        a/ first), so each directory entry sorts under two keys: `name`
        for the journal it may hold and `name + "/"` for its subtree (the
        reference's dir-entries-carry-a-trailing-slash convention,
        cmd/metacache-walk.go). Keys nested under an object key ('a' and
        'a/b') both list."""
        if self._wal is not None:
            self._wal.flush()   # the walk reads meta.mp off the filesystem
        base = self._vol_dir(volume)
        if not os.path.isdir(base):
            raise se.VolumeNotFound(volume)

        def walk(rel: str, d: str) -> Iterator[WalkEntry]:
            try:
                with os.scandir(d) as it:
                    dirs = {e.name: e for e in it if e.is_dir()}
            except OSError:
                return
            # Directory names hold no "/", so a key ending in "/" is a
            # subtree and one without is the journal the directory may hold.
            keys = list(dirs) + [dn + "/" for dn in dirs]
            keys.sort()
            for key in keys:
                if key[-1] == "/":
                    dn = key[:-1]
                    name = rel + dn
                    if prefix and not (name.startswith(prefix)
                                       or prefix.startswith(name + "/")):
                        continue
                    # Marker prune: name + "/" + MARKER_GROUP_PAD bounds
                    # every key the subtree can hold (names are capped at
                    # 1024 chars); at or below start_after, none follows
                    # the marker, so the subtree is skipped unread.
                    if start_after and name + "/" + MARKER_GROUP_PAD <= start_after:
                        continue
                    if not _has_subdirs(dirs[dn]):
                        continue   # nothing below it can hold a journal
                    yield from walk(name + "/", os.path.join(d, dn))
                    continue
                name = rel + key
                if prefix and not name.startswith(prefix):
                    continue
                if start_after and name <= start_after:
                    continue
                raw = _read_small_file(os.path.join(d, key, META_FILE))
                if raw is not None:   # else a plain directory level
                    yield WalkEntry(name=name, meta=raw)

        yield from walk("", base)

    # ---------- metadata plane hooks ----------

    def meta_sig(self, volume: str, path: str):
        """The signature of this drive's journal of a key for the set-level
        FileInfo cache: the WAL's ("w", lsn) while armed, else the file's
        (inode, mtime, size). None: absent or unknown (re-elect)."""
        if self._wal is not None:
            sig = self._wal.key_sig(volume, path)
            if sig is not None:
                return sig
        try:
            st = os.stat(self._meta_path(volume, path))
        except OSError:
            return None
        return (st.st_ino, st.st_mtime_ns, st.st_size)

    def flush_wal(self) -> None:
        """Every acknowledged journal and blob on disk (for tools and tests
        that copy or damage the drive's files directly)."""
        if self._wal is not None:
            self._wal.flush()

    def close_wal(self) -> None:
        """Drain, checkpoint and stop the group-commit thread (tests, and
        servers that close; a process's drives otherwise die with it)."""
        if self._wal is not None:
            self._wal.close()
