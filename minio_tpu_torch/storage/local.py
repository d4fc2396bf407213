"""LocalDrive — POSIX implementation of StorageAPI.

Same layout and commit protocol as minio_tpu/storage/local.py, so a drive
written by either package is served by the other:

    <root>/.mtpu.sys/format.json      drive identity (format v1)
    <root>/.mtpu.sys/tmp/<uuid>/      staging area for in-flight writes
    <root>/<volume>/<object-key>/meta.mp          version journal
    <root>/<volume>/<object-key>/<data-dir>/part.N  bitrot-framed shards

Shards stream into the tmp area; rename_data moves the data dir into the
object dir and rewrites the journal (the per-drive atomic commit point).
fsync points match the JAX package: every shard file before close, every
journal before its rename, the object directory after the commit rename,
the format file and its directory.

Left for later slices (ROADMAP.md): the group-commit WAL, the journal
read cache, reclaim capsules (undo of a displaced version), O_DIRECT
writes, listing walks.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import uuid
from typing import BinaryIO, Iterable

from minio_tpu_torch.storage.api import StorageAPI, VolInfo
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


class LocalDrive(StorageAPI):
    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        try:
            os.makedirs(os.path.join(self.root, SYS_VOL, "tmp"), exist_ok=True)
        except OSError as e:
            raise se.DiskAccessDenied(str(e)) from e

    def endpoint(self) -> str:
        return self.root

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
        try:
            # mkdir, not makedirs: a missing root means an unmounted drive.
            os.mkdir(d)
        except FileExistsError:
            raise se.VolumeExists(volume) from None
        except FileNotFoundError:
            raise se.FaultyDisk(
                f"drive root missing (unmounted?): {self.root}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def stat_vol(self, volume: str) -> VolInfo:
        try:
            st = os.stat(self._vol_dir(volume))
        except FileNotFoundError:
            raise se.VolumeNotFound(volume) from None
        return VolInfo(volume, st.st_ctime)

    # ---------- files ----------

    def delete(self, volume: str, path: str, recursive: bool = False) -> None:
        fp = self._file_path(volume, path)
        try:
            if recursive:
                shutil.rmtree(fp)
            elif os.path.isdir(fp):
                os.rmdir(fp)
            else:
                os.remove(fp)
        except FileNotFoundError:
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

    def create_file(self, volume: str, path: str, chunks: Iterable[bytes]) -> int:
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
        try:
            with open(self._meta_path(volume, path), "rb") as f:
                return XLMeta.parse(f.read())
        except (FileNotFoundError, NotADirectoryError):
            raise se.FileNotFound(f"{volume}/{path}") from None
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def _store_meta(self, volume: str, path: str, meta: XLMeta) -> None:
        mp = self._meta_path(volume, path)
        os.makedirs(os.path.dirname(mp), exist_ok=True)
        tmp = mp + f".tmp.{uuid.uuid4().hex}"
        try:
            fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            try:
                os.write(fd, meta.serialize())
                os.fsync(fd)
            finally:
                os.close(fd)
            os.replace(tmp, mp)
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e

    def _remove_meta(self, volume: str, path: str) -> None:
        mp = self._meta_path(volume, path)
        try:
            os.remove(mp)
        except FileNotFoundError:
            return
        except OSError as e:
            raise se.FaultyDisk(str(e)) from e
        obj_dir = os.path.dirname(mp)
        try:
            os.rmdir(obj_dir)
        except OSError:
            return  # data dirs remain, or already gone
        self._prune_empty_parents(os.path.dirname(obj_dir), volume)

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

    def read_version(self, volume: str, path: str,
                     version_id: str = "") -> FileInfo:
        return self._load_meta(volume, path).to_fileinfo(volume, path, version_id)

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
        else:
            self._remove_meta(volume, path)

    def rename_data(self, src_volume: str, src_path: str, fi: FileInfo,
                    dst_volume: str, dst_path: str) -> None:
        src_dir = self._file_path(src_volume, src_path)
        obj_dir = self._file_path(dst_volume, dst_path)
        os.makedirs(obj_dir, exist_ok=True)
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
            if old.data_dir and old.data_dir != fi.data_dir and not old.deleted:
                shutil.rmtree(os.path.join(obj_dir, old.data_dir),
                              ignore_errors=True)
        except se.StorageError:
            pass
        meta.add_version(fi)
        self._store_meta(dst_volume, dst_path, meta)
        _fsync_dir(obj_dir)
