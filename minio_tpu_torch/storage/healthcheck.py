"""Drive health check: deadline-bounded calls and a per-drive
ONLINE -> FAULTY -> OFFLINE state machine (counterpart of
minio_tpu/storage/healthcheck.py; reference diskHealthTracker,
cmd/xl-storage-disk-id-check.go).

A hung drive (a stalled mount, a dying disk) must not wedge the data
path. Every guarded call registers an in-flight record with a deadline
of its class ("meta": journal and volume calls, "data": shard streams,
"walk": the gap between listing entries), each an adaptive
DynamicTimeout; one process-wide watchdog thread charges every record
past its deadline against its drive and walks the state machine:

    ONLINE  --a timeout or drive error-->         FAULTY
    FAULTY  --OFFLINE_AFTER in a row-->           OFFLINE
    FAULTY  --a healthy call-->                   ONLINE
    OFFLINE --the background probe succeeds-->    ONLINE (+ heal tracker)

An OFFLINE drive fails every guarded call at once with DiskNotFound and
no I/O. The caller stuck inside a hung call is freed by the fan-out
(parallel_map's deadline, the hedged shard reads): calls run inline here,
so the wrapper adds two clock reads and a dict slot to each.

A shard write's deadline is suspended while the drive waits for the
producer's next chunk (a slow client never indicts the drive) and re-armed
at each chunk; a walk's is re-armed per entry.
"""

from __future__ import annotations

import threading
import time
import uuid as _uuid
import weakref

from minio_tpu_torch import obs
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.dyntimeout import DynamicTimeout

SYS_VOL = ".mtpu.sys"

ONLINE = "online"
FAULTY = "faulty"
OFFLINE = "offline"
_STATE_CODE = {ONLINE: 0, FAULTY: 1, OFFLINE: 2}

# (timeout, minimum) seeds of the adaptive deadlines, by class: the JAX
# package's seeds, with higher floors (JAX: 1, 2, 2 s). A calm set
# shrinks each deadline to its floor within seconds; under 64 clients the
# port's metadata calls, on Python threads that wait for the interpreter
# lock, came within 9% of 1 s, and a stall past it strikes every drive
# with calls in flight at once (on the H100 host, chip_smoke.py phases 8
# and 9 answered 500 and 503 at the JAX floors; PERF.md 6.13).
DEFAULT_DEADLINES = {
    "meta": (8.0, 4.0),
    "data": (30.0, 8.0),
    "walk": (30.0, 8.0),
}

OFFLINE_AFTER = 3      # consecutive failures before FAULTY -> OFFLINE
PROBE_INTERVAL = 1.0   # sentinel probe cadence while OFFLINE
WATCHDOG_TICK = 0.05

# Guarded call -> deadline class. The identity calls (get and set the
# id, read and write the format) stay unguarded: they are the probe's and
# heal's surface.
OP_CLASS = {
    "disk_info": "meta",
    "make_vol": "meta", "stat_vol": "meta", "list_vols": "meta",
    "delete_vol": "meta", "list_dir": "meta",
    "read_all": "meta", "write_all": "meta", "write_all_async": "meta",
    "delete": "meta", "stat_file": "meta", "rename_file": "meta",
    "write_metadata": "meta", "write_metadata_single": "meta",
    "journal_commit_async": "meta",
    "read_version": "meta", "delete_version": "meta",
    "rename_data": "meta", "commit_rename": "meta", "undo_rename": "meta",
    "create_file": "data", "read_file_stream": "data", "check_parts": "data",
    "walk_dir": "walk",
}

# Errors that indict the drive; per-object state (FileNotFound, bitrot,
# VolumeExists) is healthy contact. An admission shed is policy, not
# sickness: contact, but no latency sample.
_SYS_ERRORS = (se.DiskNotFound, se.FaultyDisk, se.OperationTimedOut)
_BACKPRESSURE = (se.AdmissionShed,)

_STATE = obs.gauge(
    "minio_tpu_drive_state",
    "Drive health state (0=online, 1=faulty, 2=offline)", ("drive",))
_TIMEOUTS = obs.counter(
    "minio_tpu_drive_timeouts_total",
    "Guarded drive ops that exceeded their op-class deadline", ("drive",))


class _Op:
    """One in-flight guarded call. The watchdog reads deadline_at alone;
    +inf suspends it (one attribute write arms or disarms)."""

    __slots__ = ("cls", "start", "deadline_at", "armed_base", "timed_out")

    def __init__(self, cls: str, now: float, timeout: float):
        self.cls = cls
        self.start = now
        self.armed_base = now
        self.deadline_at = now + timeout
        self.timed_out = False


class _Watchdog:
    """One process-wide scanner of every HealthChecker's in-flight calls."""

    def __init__(self):
        self._mu = threading.Lock()
        self._drives: weakref.WeakSet[HealthChecker] = weakref.WeakSet()
        self._thread: threading.Thread | None = None

    def register(self, hc: "HealthChecker") -> None:
        with self._mu:
            self._drives.add(hc)
            if self._thread is None:
                self._thread = threading.Thread(target=self._loop, daemon=True,
                                                name="drive-watchdog")
                self._thread.start()

    def _loop(self) -> None:
        while True:
            time.sleep(WATCHDOG_TICK)
            with self._mu:
                drives = list(self._drives)
            now = time.monotonic()
            for hc in drives:
                try:
                    hc._watch(now)
                except Exception:  # noqa: BLE001 - keep the watchdog alive
                    pass


_WATCHDOG = _Watchdog()


def _run_with_deadline(fn, timeout: float) -> bool:
    """fn() in a throwaway daemon thread: True only if it returned truthy
    within the deadline (a hung probe leaks its thread; probes are rare)."""
    result = [False]
    done = threading.Event()

    def run():
        try:
            result[0] = bool(fn())
        except Exception:  # noqa: BLE001 - a failed probe is just False
            result[0] = False
        finally:
            done.set()

    threading.Thread(target=run, daemon=True, name="drive-health-probe").start()
    return result[0] if done.wait(timeout) else False


class HealthChecker:
    """StorageAPI wrapper (over DiskIDChecker) that deadline-bounds every
    guarded call and fails an OFFLINE drive fast."""

    def __init__(self, inner, deadlines: dict | None = None,
                 probe_interval: float = PROBE_INTERVAL,
                 offline_after: int = OFFLINE_AFTER, on_restore=None):
        """deadlines: {"meta" | "data" | "walk": (timeout, minimum)}
        overrides. on_restore(hc) runs after the probe brings the drive
        back (the auto-heal hook)."""
        self._inner = inner
        self._deadlines = {cls: DynamicTimeout(*((deadlines or {}).get(cls, dflt)))
                           for cls, dflt in DEFAULT_DEADLINES.items()}
        self._probe_interval = probe_interval
        self._offline_after = max(1, offline_after)
        self._on_restore = on_restore
        self.state = ONLINE
        self.consecutive = 0      # consecutive timeouts and drive errors
        self.timeouts = 0         # deadline hits, lifetime
        self._mu = threading.Lock()
        self._inflight: dict[int, _Op] = {}
        self._tok = 0
        self._probing = False
        self._drive = inner.endpoint()
        self._g_state = _STATE.labels(drive=self._drive)
        self._g_state.set(0)
        self._c_timeouts = _TIMEOUTS.labels(drive=self._drive)
        _WATCHDOG.register(self)

    @property
    def inner(self):
        return self._inner

    def health_state(self) -> str:
        return self.state

    def is_online(self) -> bool:
        return self.state != OFFLINE and self._inner.is_online()

    def op_deadlines(self) -> tuple[float, float, float]:
        """The current adaptive (meta, data, walk) deadlines."""
        return (self._deadlines["meta"].timeout(), self._deadlines["data"].timeout(),
                self._deadlines["walk"].timeout())

    # -- identity calls (unguarded) --

    def get_disk_id(self) -> str:
        return self._inner.get_disk_id()

    def set_disk_id(self, disk_id: str) -> None:
        self._inner.set_disk_id(disk_id)

    def endpoint(self) -> str:
        return self._inner.endpoint()

    def read_format(self):
        return self._inner.read_format()

    def write_format(self, doc) -> None:
        self._inner.write_format(doc)
        # A rewritten identity is a heal's act: trust it at once.
        self._restore(via_probe=False)

    def disk_info(self, **kw):
        tok, op = self._begin("meta")
        err = None
        try:
            return self._inner.disk_info(**kw)
        except Exception as e:
            err = e
            raise
        finally:
            self._end(tok, op, err)

    # -- bookkeeping --

    def _begin(self, cls: str) -> tuple[int, _Op]:
        if self.state == OFFLINE:
            raise se.DiskNotFound(f"{self._drive}: drive offline (health)")
        op = _Op(cls, time.monotonic(), self._deadlines[cls].timeout())
        with self._mu:
            self._tok += 1
            tok = self._tok
            self._inflight[tok] = op
        return tok, op

    def _end(self, tok: int, op: _Op, err: BaseException | None) -> None:
        with self._mu:
            self._inflight.pop(tok, None)
        now = time.monotonic()
        if op.timed_out:
            return  # charged by the watchdog; a late return clears nothing
        if err is not None and isinstance(err, _BACKPRESSURE):
            self._note_ok()
        elif err is None or not isinstance(err, (*_SYS_ERRORS, OSError)):
            self._deadlines[op.cls].log_success(now - op.armed_base)
            self._note_ok()
        else:
            self._note_failure()

    def _watch(self, now: float) -> None:
        """Watchdog tick: charge every call past its deadline and re-arm
        it, so a call hung for good keeps striking until OFFLINE."""
        fired = 0
        with self._mu:
            for op in self._inflight.values():
                if now < op.deadline_at:
                    continue
                op.timed_out = True
                dt = self._deadlines[op.cls]
                dt.log_failure()
                op.deadline_at = now + dt.timeout()
                fired += 1
        for _ in range(fired):
            self.timeouts += 1
            self._c_timeouts.inc()
            self._note_failure()

    def _note_ok(self) -> None:
        with self._mu:
            self.consecutive = 0
            if self.state == FAULTY:
                self._set_state(ONLINE)

    def _note_failure(self) -> None:
        start_probe = False
        with self._mu:
            self.consecutive += 1
            if self.state == ONLINE:
                self._set_state(FAULTY)
            if self.state == FAULTY and self.consecutive >= self._offline_after:
                self._set_state(OFFLINE)
            if self.state == OFFLINE and not self._probing:
                self._probing = True
                start_probe = True
        if start_probe:
            threading.Thread(target=self._probe_loop, daemon=True,
                             name=f"drive-health-{self._drive}").start()

    def _set_state(self, state: str) -> None:
        """A transition (the caller holds self._mu): gauge and a `drive`
        trace record."""
        prev, self.state = self.state, state
        self._g_state.set(_STATE_CODE[state])
        if prev != state and obs.has_subscribers():
            obs.publish({"type": "drive", "time": time.time(), "drive": self._drive,
                         "state": state, "prev": prev, "timeouts": self.timeouts})

    # -- the offline probe --

    def _probe_once(self, path: str) -> bool:
        """Write, read back and delete a sentinel under the system tmp
        area through the inner stack (the disk-ID check included, so a
        swapped drive stays offline until it is reformatted)."""
        payload = b"mtpu-health-probe"
        self._inner.write_all(SYS_VOL, path, payload)
        if self._inner.read_all(SYS_VOL, path) != payload:
            return False
        self._inner.delete(SYS_VOL, path)
        return True

    def _probe_loop(self) -> None:
        path = f"tmp/health-{_uuid.uuid4().hex}"
        while True:
            time.sleep(self._probe_interval)
            budget = self._deadlines["data"].timeout()
            if _run_with_deadline(lambda: self._probe_once(path), budget):
                self._restore(via_probe=True)
                return

    def _restore(self, via_probe: bool) -> None:
        with self._mu:
            if via_probe:
                self._probing = False
            if self.state == ONLINE:
                return
            self.consecutive = 0
            self._set_state(ONLINE)
        cb = self._on_restore
        if cb is not None:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - a notification must not kill the probe
                pass

    # -- the guard --

    def _guard_stream_sink(self, fn, volume: str, path: str, chunks):
        """create_file: the deadline is suspended while the drive waits
        for the producer's next chunk and re-armed at each chunk."""
        tok, op = self._begin("data")
        dt = self._deadlines["data"]
        err = None

        def paced():
            it = iter(chunks)
            while True:
                op.deadline_at = float("inf")
                try:
                    chunk = next(it)
                except StopIteration:
                    now = time.monotonic()
                    op.armed_base = now
                    op.deadline_at = now + dt.timeout()   # the final fsync
                    return
                now = time.monotonic()
                op.armed_base = now
                op.deadline_at = now + dt.timeout()
                yield chunk

        try:
            return fn(volume, path, paced())
        except Exception as e:
            err = e
            raise
        finally:
            self._end(tok, op, err)

    def _guard_walk(self, fn, args, kwargs):
        """walk_dir: one record for the call and every entry, re-armed at
        each next() and suspended while the consumer holds an entry."""
        tok, op = self._begin("walk")
        dt = self._deadlines["walk"]
        try:
            it = fn(*args, **kwargs)
        except Exception as e:
            self._end(tok, op, e)
            raise
        op.deadline_at = float("inf")

        def gen():
            err = None
            try:
                while True:
                    now = time.monotonic()
                    op.armed_base = now
                    op.deadline_at = now + dt.timeout()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    op.deadline_at = float("inf")
                    yield item
            except Exception as e:
                err = e
                raise
            finally:
                self._end(tok, op, err)

        return gen()

    def __getattr__(self, name: str):
        fn = getattr(self._inner, name)
        cls = OP_CLASS.get(name)
        if cls is None or not callable(fn):
            return fn
        if name == "walk_dir":
            return lambda *a, **kw: self._guard_walk(fn, a, kw)
        if name == "create_file":
            return lambda volume, path, chunks: self._guard_stream_sink(
                fn, volume, path, chunks)
        if name in ("journal_commit_async", "write_all_async"):
            # Two-phase commits: the guard spans until the WAL fsync
            # resolves the future, so a hung fsync walks the drive
            # FAULTY -> OFFLINE like a hung synchronous store.
            def guarded_async(*a, **kw):
                tok, op = self._begin(cls)
                try:
                    fut = fn(*a, **kw)
                except Exception as e:
                    self._end(tok, op, e)
                    raise
                if fut is None:
                    self._end(tok, op, None)
                    return None
                fut.add_done_callback(lambda f: self._end(tok, op, f.exception()))
                return fut

            return guarded_async

        def guarded(*a, **kw):
            tok, op = self._begin(cls)
            err = None
            try:
                return fn(*a, **kw)
            except Exception as e:
                err = e
                raise
            finally:
                self._end(tok, op, err)

        return guarded


def wrap_with_healthcheck(drives: list, fmt=None, **kw) -> list:
    """A HealthChecker over each (disk-ID-checked) drive. With a format,
    the restore hook leaves a healing tracker naming the slot, so the
    AutoHealer rebuilds what the drive missed while OFFLINE."""
    flat = [u for s in fmt.sets for u in s] if fmt is not None else []
    out = []
    for i, d in enumerate(drives):
        uid = flat[i] if i < len(flat) else ""
        cb = None
        if uid:
            def cb(hc, _uid=uid):
                from minio_tpu_torch.erasure.autoheal import mark_drive_healing

                try:
                    mark_drive_healing(hc, _uid)
                except se.StorageError:
                    pass  # the next restore or boot retries
        out.append(HealthChecker(d, on_restore=cb, **kw))
    return out


def unwrap(drive):
    """Peel the health and disk-ID wrappers, and only those."""
    from minio_tpu_torch.storage.idcheck import DiskIDChecker

    while True:
        if isinstance(drive, HealthChecker):
            drive = drive._inner
        elif isinstance(drive, DiskIDChecker):
            drive = drive.inner
        else:
            return drive


def fleet_deadlines(drives) -> tuple[float, float, float]:
    """(meta, data, walk) deadlines of a fan-out over `drives`: the largest
    of the wrapped drives' adaptive deadlines, or the class seeds when no
    drive is wrapped."""
    meta: list[float] = []
    data: list[float] = []
    walk: list[float] = []
    for d in drives:
        if isinstance(d, HealthChecker):
            m, dd, w = d.op_deadlines()
            meta.append(m)
            data.append(dd)
            walk.append(w)
    return (max(meta) if meta else DEFAULT_DEADLINES["meta"][0],
            max(data) if data else DEFAULT_DEADLINES["data"][0],
            max(walk) if walk else DEFAULT_DEADLINES["walk"][0])
