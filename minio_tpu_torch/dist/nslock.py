"""Namespace locks: per-(bucket, object) RW locking for the object layer
(counterpart of minio_tpu/dist/nslock.py).

Role-equivalent of cmd/namespace-lock.go:48-263 — the object engine asks for
a lock on (bucket, object...) around mutating commits; standalone mode uses
an in-process RW mutex table, distributed mode a dsync DRWMutex over the
set's lockers. The context-manager shape replaces the reference's
GetLock/Unlock pairs. The port's GET takes no read lock (its commits are
per-drive renames read by quorum), so the JAX map's single-resource
`rlock` fast path is not carried.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator

from minio_tpu_torch.dist.dsync import DRWMutex
from minio_tpu_torch.utils import errors as se


class _RWLock:
    """Writer-preferring in-process RW mutex (pkg/lsync role)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self, timeout: float) -> bool:
        with self._cond:
            ok = self._cond.wait_for(
                lambda: not self._writer and self._writers_waiting == 0,
                timeout)
            if ok:
                self._readers += 1
            return ok

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self, timeout: float) -> bool:
        with self._cond:
            self._writers_waiting += 1
            try:
                ok = self._cond.wait_for(
                    lambda: not self._writer and self._readers == 0, timeout)
                if ok:
                    self._writer = True
                return ok
            finally:
                self._writers_waiting -= 1

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()


class LockLease:
    """What `lock()` yields: a handle whose `held` goes False if the
    distributed lock loses its refresh quorum mid-critical-section (a
    partition isolating this node from the locker majority). Commit
    paths consult it at the point of no return and roll back instead of
    completing an unprotected write. Local locks can't be lost: `held`
    is constant True."""

    __slots__ = ("_mx",)

    def __init__(self, mx=None):
        self._mx = mx

    @property
    def held(self) -> bool:
        return True if self._mx is None else self._mx.held


_LOCAL_LEASE = LockLease()


class NamespaceLockMap:
    """Lock table keyed by "bucket/object" pathnames.

    distributed=False -> in-process table (nsLockMap local mode);
    distributed=True  -> each lock() builds a DRWMutex over `lockers`
    (the set's lockers, cmd/erasure-sets.go NewNSLock)."""

    def __init__(self, distributed: bool = False, lockers: list | None = None,
                 owner: str = "", refresh_interval: float | None = None):
        self.distributed = distributed
        self.lockers = lockers or []
        self.owner = owner
        # None -> dsync default (MTPU_DSYNC_REFRESH_INTERVAL); tests pin
        # it low so partition-during-commit aborts are provable fast.
        self.refresh_interval = refresh_interval
        # resource -> [lock, refcount]; the refcount is mutated only under
        # _mu (the reference nsLockMap keeps `ref` under lockMapMutex,
        # cmd/namespace-lock.go:141) so an entry can never be GC'd between
        # another thread's _get and its acquire — deleting in that window
        # would hand two writers two different 'same' locks.
        self._table: dict[str, list] = {}
        self._mu = threading.Lock()

    def _get(self, resource: str) -> _RWLock:
        with self._mu:
            entry = self._table.get(resource)
            if entry is None:
                entry = self._table[resource] = [_RWLock(), 0]
            entry[1] += 1
            return entry[0]

    def _unref(self, resource: str) -> None:
        with self._mu:
            entry = self._table.get(resource)
            if entry is None:
                return
            entry[1] -= 1
            if entry[1] <= 0:
                del self._table[resource]

    @contextlib.contextmanager
    def lock(self, bucket: str, *objects: str, timeout: float = 30.0,
             readonly: bool = False) -> Iterator[LockLease]:
        resources = sorted(f"{bucket}/{o}" if o else bucket
                           for o in (objects or ("",)))
        if self.distributed:
            mx = DRWMutex(resources, self.lockers, owner=self.owner,
                          refresh_interval=self.refresh_interval)
            got = mx.get_rlock(timeout) if readonly else mx.get_lock(timeout)
            if not got:
                mx.unlock()   # release the broadcast pool's workers
                raise se.OperationTimedOut(
                    bucket, ",".join(objects),
                    f"lock timeout on {resources}")
            try:
                yield LockLease(mx)
            finally:
                mx.unlock()
            return

        # Local mode: acquire in sorted order (deadlock-free), all-or-release.
        acquired: list[_RWLock] = []
        referenced: list[str] = []
        try:
            for res in resources:
                lk = self._get(res)
                referenced.append(res)
                ok = (lk.acquire_read(timeout) if readonly
                      else lk.acquire_write(timeout))
                if not ok:
                    raise se.OperationTimedOut(
                        bucket, ",".join(objects), f"lock timeout on {res}")
                acquired.append(lk)
            yield _LOCAL_LEASE
        finally:
            for lk in reversed(acquired):
                if readonly:
                    lk.release_read()
                else:
                    lk.release_write()
            for res in referenced:
                self._unref(res)
