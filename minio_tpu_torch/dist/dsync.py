"""dsync — quorum-based distributed read/write locks (counterpart of
minio_tpu/dist/dsync.py, on the same lock-plane wire).

Role-equivalent of pkg/dsync: a lock is acquired by sending simultaneous
lock calls to ALL n lockers and succeeds iff a quorum grants it
(drwmutex.go:165-187 — write quorum n/2+1, read quorum n/2, tolerance-
adjusted); failed acquisitions release every granted locker (releaseAll:498)
and retry with jitter until the timeout; held locks are refreshed
continuously and dropped if the refresh quorum is lost (refresh:245).

Lockers are symmetric: every node runs a LocalLocker served over the lock
RPC plane; a DRWMutex talks to all of a set's lockers (local one in-process,
peers via RemoteLocker).
"""

from __future__ import annotations

import os
import random
import threading
import time
import uuid
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Protocol

from minio_tpu_torch import obs
from minio_tpu_torch.dist.rpc import RestClient, pack, unpack

# Unrefreshed locks are presumed owned by a dead process and reaped
# (the reference's lock maintenance loop, cmd/lock-rest-server.go:330).
LOCK_STALE_AFTER = 60.0
REFRESH_INTERVAL = float(os.environ.get("MTPU_DSYNC_REFRESH_INTERVAL",
                                        "10.0"))
RETRY_MIN = 0.01
RETRY_MAX = 0.25

# A held lock dropping its refresh quorum is the partition signal the
# degraded-write path keys on (commits check `held` and roll back) —
# count it so an operator can see silent lock losses.
_REFRESH_LOST = obs.counter(
    "minio_tpu_dsync_refresh_lost_total",
    "Held dsync locks dropped after losing their refresh quorum")


@dataclass
class LockArgs:
    uid: str
    resources: list[str]
    owner: str
    readonly: bool = False

    def to_doc(self) -> dict:
        return {"uid": self.uid, "res": self.resources,
                "owner": self.owner, "ro": self.readonly}

    @classmethod
    def from_doc(cls, doc: dict) -> "LockArgs":
        return cls(uid=doc["uid"], resources=list(doc["res"]),
                   owner=doc.get("owner", ""), readonly=bool(doc.get("ro")))


class NetLocker(Protocol):
    """The RPC surface a locker must serve (pkg/dsync/rpc-client-interface.go:42)."""

    def lock(self, args: LockArgs) -> bool: ...
    def unlock(self, args: LockArgs) -> bool: ...
    def rlock(self, args: LockArgs) -> bool: ...
    def runlock(self, args: LockArgs) -> bool: ...
    def refresh(self, args: LockArgs) -> bool: ...
    def force_unlock(self, args: LockArgs) -> bool: ...
    def is_online(self) -> bool: ...


@dataclass
class _Grant:
    uid: str
    owner: str
    readonly: bool
    granted_at: float
    refreshed_at: float


class LocalLocker:
    """In-process lock table: resource -> grants (cmd/local-locker.go:55).

    A write grant excludes everything; read grants coexist. Stale grants
    (no refresh within LOCK_STALE_AFTER) are reaped lazily on conflict —
    this is what lets the cluster survive a lock-holder dying mid-flight.
    """

    def __init__(self):
        self._table: dict[str, list[_Grant]] = {}
        self._mu = threading.Lock()

    def _reap(self, resource: str, now: float) -> list[_Grant]:
        grants = [g for g in self._table.get(resource, ())
                  if now - g.refreshed_at < LOCK_STALE_AFTER]
        if grants:
            self._table[resource] = grants
        else:
            self._table.pop(resource, None)
        return grants

    def _acquire(self, args: LockArgs, readonly: bool) -> bool:
        now = time.time()
        with self._mu:
            # All-or-nothing across the resource list.
            for res in args.resources:
                grants = self._reap(res, now)
                if readonly:
                    if any(not g.readonly for g in grants):
                        return False
                elif grants:
                    return False
            for res in args.resources:
                self._table.setdefault(res, []).append(
                    _Grant(args.uid, args.owner, readonly, now, now))
            return True

    def _release(self, args: LockArgs, readonly: bool) -> bool:
        ok = False
        with self._mu:
            for res in args.resources:
                grants = self._table.get(res, [])
                keep = [g for g in grants
                        if not (g.uid == args.uid and g.readonly == readonly)]
                if len(keep) != len(grants):
                    ok = True
                if keep:
                    self._table[res] = keep
                else:
                    self._table.pop(res, None)
        return ok

    # -- NetLocker --

    def lock(self, args: LockArgs) -> bool:
        return self._acquire(args, readonly=False)

    def rlock(self, args: LockArgs) -> bool:
        return self._acquire(args, readonly=True)

    def unlock(self, args: LockArgs) -> bool:
        return self._release(args, readonly=False)

    def runlock(self, args: LockArgs) -> bool:
        return self._release(args, readonly=True)

    def refresh(self, args: LockArgs) -> bool:
        now = time.time()
        found = False
        with self._mu:
            for res in args.resources:
                for g in self._table.get(res, ()):
                    if g.uid == args.uid:
                        g.refreshed_at = now
                        found = True
        return found

    def force_unlock(self, args: LockArgs) -> bool:
        with self._mu:
            for res in args.resources:
                self._table.pop(res, None)
        return True

    def is_online(self) -> bool:
        return True

    # -- introspection (admin top-locks) --

    def dump(self) -> dict[str, list[dict]]:
        with self._mu:
            return {res: [{"uid": g.uid, "owner": g.owner, "ro": g.readonly,
                           "since": g.granted_at} for g in grants]
                    for res, grants in self._table.items()}


# --- lock RPC plane ----------------------------------------------------------

PLANE = "lock"


def lock_routes(locker: LocalLocker) -> dict:
    """Handlers serving this node's LocalLocker (cmd/lock-rest-server.go)."""

    def wrap(method):
        def h(params: dict, body) -> bytes:
            args = LockArgs.from_doc(unpack(body.read(-1)))
            return pack({"ok": bool(getattr(locker, method)(args))})
        return h

    return {m: wrap(m) for m in
            ["lock", "unlock", "rlock", "runlock", "refresh", "force_unlock"]}


class RemoteLocker:
    """NetLocker over the node fabric (cmd/lock-rest-client.go). Network
    failure = refusal (False) — dsync quorum absorbs locker loss."""

    def __init__(self, client: RestClient):
        self._client = client

    def _call(self, method: str, args: LockArgs) -> bool:
        try:
            doc = self._client.call_msgpack(
                f"/rpc/{PLANE}/v1/{method}", body=pack(args.to_doc()))
            return bool(doc and doc.get("ok"))
        except Exception:
            return False

    def lock(self, args: LockArgs) -> bool:
        return self._call("lock", args)

    def unlock(self, args: LockArgs) -> bool:
        return self._call("unlock", args)

    def rlock(self, args: LockArgs) -> bool:
        return self._call("rlock", args)

    def runlock(self, args: LockArgs) -> bool:
        return self._call("runlock", args)

    def refresh(self, args: LockArgs) -> bool:
        return self._call("refresh", args)

    def force_unlock(self, args: LockArgs) -> bool:
        return self._call("force_unlock", args)

    def is_online(self) -> bool:
        return self._client.is_online()


# --- the distributed mutex ---------------------------------------------------

class DRWMutex:
    """Quorum read/write lock over n lockers (pkg/dsync/drwmutex.go:56)."""

    def __init__(self, resources: list[str], lockers: list,
                 owner: str = "", refresh_interval: float | None = None,
                 on_lost=None):
        """on_lost: called (once) from the refresh thread if the lock
        loses its refresh quorum while held — the abort signal degraded
        writes key on."""
        self.resources = resources
        self.lockers = lockers
        self.owner = owner or str(uuid.uuid4())
        self.refresh_interval = (REFRESH_INTERVAL if refresh_interval is None
                                 else refresh_interval)
        self.on_lost = on_lost
        self._uid = ""
        self._readonly = False
        self._held = False
        self._released = False
        self._stop_refresh = threading.Event()
        self._refresh_thread: threading.Thread | None = None
        self._pool = ThreadPoolExecutor(
            max_workers=max(4, len(lockers)),
            thread_name_prefix="dsync")

    # write quorum n/2+1; read quorum n/2 (drwmutex.go:165-187)
    def _quorum(self, readonly: bool) -> int:
        n = len(self.lockers)
        q = n // 2 if readonly else n // 2 + 1
        return max(q, 1)

    def _broadcast(self, method: str, args: LockArgs) -> int:
        futs = []
        for lk in self.lockers:
            try:
                futs.append(self._pool.submit(
                    obs.ctx_wrap(getattr(lk, method)), args))
            except RuntimeError:
                # unlock() shut the pool down while the refresh thread
                # was entering a broadcast — count the locker as
                # unreachable instead of crashing the daemon thread.
                pass
        granted = 0
        for f in futs:
            try:
                if f.result(timeout=30):
                    granted += 1
            except Exception:
                pass
        return granted

    def _try_acquire(self, readonly: bool) -> bool:
        uid = str(uuid.uuid4())
        args = LockArgs(uid=uid, resources=self.resources,
                        owner=self.owner, readonly=readonly)
        method = "rlock" if readonly else "lock"
        granted = self._broadcast(method, args)
        if granted >= self._quorum(readonly):
            self._uid = uid
            self._readonly = readonly
            self._held = True
            self._start_refresh()
            return True
        # Release whatever we got (releaseAll, drwmutex.go:498).
        self._broadcast("runlock" if readonly else "unlock", args)
        return False

    def _acquire_blocking(self, readonly: bool, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        while True:
            if self._try_acquire(readonly):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(random.uniform(RETRY_MIN, RETRY_MAX))

    def get_lock(self, timeout: float = 30.0) -> bool:
        return self._acquire_blocking(readonly=False, timeout=timeout)

    def get_rlock(self, timeout: float = 30.0) -> bool:
        return self._acquire_blocking(readonly=True, timeout=timeout)

    def unlock(self) -> None:
        # Keyed on _released, NOT _held: a refresh-quorum loss flips
        # _held to abort commits, but the minority lockers that still
        # hold the grant must be released (best effort — partitioned
        # ones fail fast) and the executor shut down, or every lease
        # abort would leak worker threads and block new writers for
        # LOCK_STALE_AFTER.
        if self._released:
            return
        self._released = True
        self._held = False
        self._stop_refresh.set()
        if self._uid:
            args = LockArgs(uid=self._uid, resources=self.resources,
                            owner=self.owner, readonly=self._readonly)
            self._broadcast("runlock" if self._readonly else "unlock", args)
        self._pool.shutdown(wait=False)

    # -- keepalive (drwmutex.go:214,245) --

    def _start_refresh(self) -> None:
        self._stop_refresh = threading.Event()

        def loop():
            args = LockArgs(uid=self._uid, resources=self.resources,
                            owner=self.owner, readonly=self._readonly)
            while not self._stop_refresh.wait(self.refresh_interval):
                refreshed = self._broadcast("refresh", args)
                if self._stop_refresh.is_set():
                    # unlock() raced this tick — a released lock cannot
                    # lose its quorum (no spurious on_lost/metric).
                    return
                if refreshed < self._quorum(self._readonly):
                    # Lost the quorum — the lock is no longer safe to
                    # hold. Commits in flight observe `held` flipping and
                    # roll back instead of completing unprotected.
                    self._held = False
                    _REFRESH_LOST.labels().inc()
                    if self.on_lost is not None:
                        try:
                            self.on_lost()
                        except Exception:  # noqa: BLE001 - observer only
                            pass
                    return

        self._refresh_thread = threading.Thread(
            target=loop, daemon=True, name="dsync-refresh")
        self._refresh_thread.start()

    @property
    def held(self) -> bool:
        return self._held
