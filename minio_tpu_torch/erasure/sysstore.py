"""Mirrored system documents across a drive set (counterpart of
minio_tpu/erasure/sysstore.py).

Small documents (multipart session and part journals, metacache blocks)
are not striped: each is written whole to every drive, and reads elect
the content by majority, so they survive the drive losses the data path
survives. SysConfigStore keeps them under `.mtpu.sys/config/`, the JAX
package's layout, so either package reads what the other wrote. With the
metadata plane armed, the writes ride each drive's WAL blob lane: one
shared fsync per drive and batch acknowledges them.
"""

from __future__ import annotations

import hashlib

import time
from concurrent.futures import TimeoutError as FutureTimeout

from minio_tpu_torch.erasure.metadata import (parallel_map, reduce_write_quorum,
                                              run_bounded)
from minio_tpu_torch.storage import healthcheck
from minio_tpu_torch.storage.local import SYS_VOL, LocalDrive
from minio_tpu_torch.utils import errors as se

CONFIG_PREFIX = "config"


def submits_may_block(drives) -> bool:
    """Whether a WAL submit to these drives could block: true when some
    drive, under its health and disk-ID wrappers, is not a LocalDrive (a
    wrapper that may stall any call, as the resilience tests install).
    The JAX package asks the same of its chaos layer."""
    return any(type(healthcheck.unwrap(d)) is not LocalDrive for d in drives)


def mirror_write_all(drives, vol: str, rel: str, data: bytes,
                     deadline: float | None = None) -> list:
    """Write `data` to `vol/rel` on every drive through the WAL's blob
    lane where the drive has one armed (submit to every drive, then wait
    for the shared fsyncs under the deadline), else by write_all with its
    own fsync. Returns per-drive outcomes (None | Exception) for the
    caller's quorum reducer."""
    if deadline is None:
        deadline = healthcheck.fleet_deadlines(drives)[0]
    n = len(drives)
    futs: list = [None] * n
    sync_idx: list[int] = []

    def submit_all():
        for i, d in enumerate(drives):
            fn = getattr(d, "write_all_async", None)
            if fn is None:
                sync_idx.append(i)
                continue
            try:
                f = fn(vol, rel, data)
            except Exception as e:  # noqa: BLE001 - per-drive outcome
                futs[i] = e
                continue
            if f is None:
                sync_idx.append(i)   # not armed: synchronous write
            else:
                futs[i] = f

    if submits_may_block(drives):
        # A wedged submit loop degrades every drive to the bounded
        # synchronous fan-out (a repeated store writes the same bytes).
        if not run_bounded(submit_all, deadline):
            futs = [None] * n
            sync_idx = list(range(n))
    else:
        submit_all()
    outcomes: list = [None] * n
    if sync_idx:
        sync_out = parallel_map([lambda d=drives[i]: d.write_all(vol, rel, data)
                                 for i in sync_idx], deadline=deadline)
        for i, out in zip(sync_idx, sync_out):
            outcomes[i] = out
    end = time.monotonic() + deadline
    for i, f in enumerate(futs):
        if f is None:
            continue
        if isinstance(f, Exception):
            outcomes[i] = f
            continue
        try:
            f.result(timeout=max(0.0, end - time.monotonic()))
        except FutureTimeout:
            outcomes[i] = se.OperationTimedOut(
                msg="wal blob commit exceeded deadline")
        except Exception as e:  # noqa: BLE001 - per-drive outcome
            outcomes[i] = e
    return outcomes


class SysConfigStore:
    """Mirrored key -> bytes store over one drive set (the host class
    provides `drives` and `_write_quorum_meta()`)."""

    def read_sys_config(self, path: str) -> bytes:
        """The majority's content, with read-repair: drives whose copy is
        missing or differs get the elected content rewritten, but only
        when it holds a true write-quorum majority (a plurality among a
        minority of visible drives may be the old generation)."""
        rel = f"{CONFIG_PREFIX}/{path}"
        results = parallel_map([lambda d=d: d.read_all(SYS_VOL, rel)
                                for d in self.drives],
                               deadline=self._meta_deadline())
        tally: dict[bytes, tuple[int, bytes]] = {}
        for r in results:
            if isinstance(r, (bytes, bytearray)):
                h = hashlib.sha256(r).digest()
                n, _ = tally.get(h, (0, b""))
                tally[h] = (n + 1, bytes(r))
        if not tally:
            if all(isinstance(r, se.FileNotFound) for r in results):
                raise se.FileNotFound(path)
            raise se.InsufficientReadQuorum("", path, "no readable config copy")
        count, data = max(tally.values(), key=lambda v: v[0])
        if count >= self._write_quorum_meta():
            lag = [d for d, r in zip(self.drives, results)
                   if not (isinstance(r, (bytes, bytearray)) and bytes(r) == data)]
            if lag:
                # Best effort: a drive that fails the repair stays
                # divergent and is retried on the next read.
                parallel_map([lambda d=d: d.write_all(SYS_VOL, rel, data)
                              for d in lag],
                             deadline=self._meta_deadline())
        return data

    def write_sys_config(self, path: str, data: bytes) -> None:
        results = mirror_write_all(self.drives, SYS_VOL,
                                   f"{CONFIG_PREFIX}/{path}", data)
        reduce_write_quorum(results, self._write_quorum_meta(), SYS_VOL, path)

    def delete_sys_config(self, path: str) -> None:
        rel = f"{CONFIG_PREFIX}/{path}"
        results = parallel_map([lambda d=d: d.delete(SYS_VOL, rel)
                                for d in self.drives],
                               deadline=self._meta_deadline())
        results = [None if isinstance(r, se.FileNotFound) else r for r in results]
        reduce_write_quorum(results, self._write_quorum_meta(), SYS_VOL, path)

    def sys_config_signature(self, path: str) -> tuple:
        """Each drive's (inode, mtime, size) of the document, None where it
        has none or cannot say: every write replaces the file by a rename,
        so an equal signature means no copy was rewritten in between."""
        rel = f"{CONFIG_PREFIX}/{path}"
        results = parallel_map([lambda d=d: d.stat_file(SYS_VOL, rel)
                                for d in self.drives],
                               deadline=self._meta_deadline())
        return tuple(None if isinstance(r, Exception) else r for r in results)

    def list_sys_config(self, prefix: str = "") -> list[str]:
        """Sorted keys under prefix, the union across drives (a key exists
        if any drive has it; stale deletes resolve on read)."""
        rel = f"{CONFIG_PREFIX}/{prefix}".rstrip("/")
        names: set[str] = set()
        for r in parallel_map([lambda d=d: _walk_names(d, rel) for d in self.drives],
                              deadline=self._meta_deadline()):
            if isinstance(r, set):
                names |= r
        strip = len(CONFIG_PREFIX) + 1
        return sorted(n[strip:] for n in names)


def _walk_names(drive, rel: str) -> set:
    out = set()
    try:
        stack = [rel]
        while stack:
            d = stack.pop()
            for name in drive.list_dir(SYS_VOL, d):
                full = f"{d}/{name}" if d else name
                if name.endswith("/"):
                    stack.append(full.rstrip("/"))
                else:
                    out.add(full)
    except (se.FileNotFound, se.VolumeNotFound):
        pass
    return out
