"""Disk-identity check (counterpart of minio_tpu/storage/idcheck.py;
reference cmd/xl-storage-disk-id-check.go:64).

Every guarded call asks "is this still the drive placed in this slot": a
swapped, remounted or replugged disk answers DiskNotFound, so the quorum
layers count it offline and the auto-healer reclaims it, instead of
serving another drive's shards. The probe reads format.json, so it runs
at most once per CHECK_INTERVAL, and a failed probe is remembered for as
long, failing calls with no I/O. The identity calls themselves (get and
set the id, read and write the format) are the probe's surface and pass
through unguarded.
"""

from __future__ import annotations

import time

from minio_tpu_torch.utils import errors as se

CHECK_INTERVAL = 5.0

_GUARDED = {
    "make_vol", "stat_vol", "list_vols", "delete_vol",
    "list_dir", "walk_dir", "read_all", "write_all", "write_all_async",
    "delete", "stat_file", "create_file", "read_file_stream", "rename_file",
    "write_metadata", "write_metadata_single", "journal_commit_async",
    "read_version", "delete_version",
    "rename_data", "commit_rename", "undo_rename", "check_parts",
}


class DiskIDChecker:
    """StorageAPI wrapper binding a drive to its format UUID."""

    def __init__(self, inner, expected_id: str, interval: float = CHECK_INTERVAL):
        self._inner = inner
        self._expected = expected_id
        self._interval = interval
        self._last_ok = 0.0
        self._last_fail = 0.0
        self._fail_msg = ""

    @property
    def inner(self):
        return self._inner

    def get_disk_id(self) -> str:
        return self._inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self._expected = disk_id
        self._inner.set_disk_id(disk_id)
        self._last_fail = 0.0   # identity changed: probe again at once

    def disk_info(self, **kw):
        return self._inner.disk_info(**kw)

    def endpoint(self) -> str:
        return self._inner.endpoint()

    def read_format(self):
        return self._inner.read_format()

    def write_format(self, doc) -> None:
        self._inner.write_format(doc)
        self._last_ok = 0.0
        self._last_fail = 0.0

    def _fail(self, now: float, msg: str) -> se.DiskNotFound:
        self._last_fail = now
        self._fail_msg = msg
        return se.DiskNotFound(msg)

    def _check(self) -> None:
        if not self._expected:
            return
        now = time.monotonic()
        if now - self._last_ok < self._interval:
            return
        if self._last_fail and now - self._last_fail < self._interval:
            raise se.DiskNotFound(self._fail_msg)
        try:
            this = self._inner.get_disk_id()
        except se.StorageError as e:
            raise self._fail(
                now, f"{self._inner.endpoint()}: identity probe failed: {e}") from e
        if this != self._expected:
            raise self._fail(
                now, f"{self._inner.endpoint()}: drive id {this!r} != expected "
                     f"{self._expected!r} (swapped drive?)")
        self._last_ok = now
        self._last_fail = 0.0

    def __getattr__(self, name: str):
        fn = getattr(self._inner, name)
        if name not in _GUARDED or not callable(fn):
            return fn

        def guarded(*a, **kw):
            self._check()
            return fn(*a, **kw)

        return guarded


def wrap_with_id_check(drives: list, fmt) -> list:
    """Wrap a slot-ordered drive list with its format's UUIDs."""
    flat = [u for s in fmt.sets for u in s]
    return [DiskIDChecker(d, flat[i]) if i < len(flat) and flat[i] else d
            for i, d in enumerate(drives)]
