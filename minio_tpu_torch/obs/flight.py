"""Always-on bounded flight recorder: per-request stage timelines
(counterpart of minio_tpu/obs/flight.py, same stage names).

Aggregate histograms say *that* a PUT took 4 ms; they cannot say where
the 4 ms went once the request crossed into the batch planes (dataplane
lanes, group-commit WAL, shm ring, hot tier). The flight recorder keeps
the critical-path decomposition per request:

- a `Timeline` rides the request's contextvars (the same channel the
  trace id uses, crossing thread hops via `obs.ctx_wrap`) and records
  two kinds of entries:

  * sequential **marks** — `mark("encode")` closes the segment from the
    previous mark (or request entry) to now. Sequential segments tile
    the request wall clock end to end, so their sum reconstructs the
    e2e latency;
  * detail **stamps** — `stamp("dp_queue_wait", dt, plane="dataplane")`
    attaches a plane-measured duration that overlaps a sequential
    segment (queue wait inside `encode`, fsync wait inside `commit`).
    Stamps attribute, marks account.

- completed timelines land in a per-process bounded ring (last N
  requests) plus a slowest-N-per-API board, both queryable through
  `GET /minio/admin/v3/perf/timeline?traceid=|api=|worst=|tenant=` —
  federated across front-door workers (shm spool, frontdoor/shm.py
  FlightSpool);
- every stage feeds the `minio_tpu_stage_seconds{api,stage,plane}`
  histogram family.

Zero-overhead contract (mirrors the trace bus): disarmed
(`MTPU_FLIGHT=0`), `begin()` never binds a Timeline, so every
`mark()`/`stamp()`/`current()` on the hot path is one contextvar read
returning None. `Timeline.allocated` counts constructions so tests can
assert the disarmed path allocates nothing.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from collections import deque

from minio_tpu_torch.obs.histogram import histogram
from minio_tpu_torch.obs.span import current_node as _current_node

ARM_ENV = "MTPU_FLIGHT"
RING_ENV = "MTPU_FLIGHT_RING"
WORST_ENV = "MTPU_FLIGHT_WORST"

_ARMED = os.environ.get(ARM_ENV, "1") not in ("0", "false", "off")
_RING_N = max(1, int(os.environ.get(RING_ENV, "256") or 256))
_WORST_N = max(1, int(os.environ.get(WORST_ENV, "8") or 8))

_STAGE = histogram(
    "minio_tpu_stage_seconds",
    "Per-request stage latency decomposition across the planes",
    ("api", "stage", "plane"))

_tl: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_flight", default=None)

_mu = threading.Lock()
_ring: deque = deque(maxlen=_RING_N)        # completed snapshots, FIFO
_worst: dict[str, list] = {}                # api -> [(e2e_ns, snap)] desc
_sink = None                                # worker shm spool writer
_sibling_reader = None                      # reads other workers' spools
_worker = -1                                # front-door worker id, -1 solo


class Timeline:
    """One request's stage record. Thread-safe: plane threads stamp
    concurrently with the request thread marking (the batcher's finish
    thread materializes while the handler drains the response)."""

    allocated = 0  # class-level construction count (zero-overhead guard)

    __slots__ = ("trace_id", "api", "tenant", "_t0", "_cursor", "_stages",
                 "_done", "_lock")

    def __init__(self, trace_id: str, api: str = ""):
        Timeline.allocated += 1
        self.trace_id = trace_id
        self.api = api
        self.tenant = ""
        now = time.perf_counter()
        self._t0 = now
        self._cursor = now
        # (stage, plane, dur_s, sequential)
        self._stages: list[tuple[str, str, float, bool]] = []
        self._done = False
        self._lock = threading.Lock()

    def mark(self, stage: str, plane: str = "s3") -> None:
        """Close the sequential segment [previous mark, now)."""
        now = time.perf_counter()
        with self._lock:
            if self._done:
                return
            self._stages.append((stage, plane, now - self._cursor, True))
            self._cursor = now

    def stamp(self, stage: str, dur: float, plane: str) -> None:
        """Attach a plane-measured overlapping duration (seconds)."""
        with self._lock:
            if self._done:
                return
            self._stages.append((stage, plane, dur, False))

    def finalize(self, status: int, final_stage: str | None) -> dict:
        now = time.perf_counter()
        with self._lock:
            self._done = True
            if final_stage is not None:
                self._stages.append(
                    (final_stage, "s3", now - self._cursor, True))
            stages = list(self._stages)
        api = self.api or "unknown"
        for stage, plane, dur, _seq in stages:
            _STAGE.labels(api=api, stage=stage, plane=plane).observe(dur)
        return {
            "trace_id": self.trace_id,
            "api": api,
            "tenant": self.tenant,
            "node": _current_node(),
            "worker": _worker,
            "time": time.time(),
            "status": status,
            "e2e_ns": int((now - self._t0) * 1e9),
            "stages": [{"stage": s, "plane": p,
                        "dur_ns": int(d * 1e9), "seq": q}
                       for s, p, d, q in stages],
        }


# --- request lifecycle -------------------------------------------------------


def begin(trace_id: str, api: str = "") -> Timeline | None:
    """Bind a fresh Timeline to the current context. Returns None (and
    binds nothing — zero allocation) when disarmed."""
    if not _ARMED:
        return None
    tl = Timeline(trace_id, api)
    _tl.set(tl)
    return tl


def current() -> Timeline | None:
    return _tl.get()


def set_api(api: str) -> None:
    tl = _tl.get()
    if tl is not None:
        tl.api = api


def set_tenant(tenant: str) -> None:
    tl = _tl.get()
    if tl is not None:
        tl.tenant = tenant


def mark(stage: str, plane: str = "s3") -> None:
    tl = _tl.get()
    if tl is not None:
        tl.mark(stage, plane)


def stamp(stage: str, dur: float, plane: str) -> None:
    tl = _tl.get()
    if tl is not None:
        tl.stamp(stage, dur, plane)


def end(status: int = 200, final_stage: str | None = "resp_drain") -> None:
    """Finalize the context timeline: close the trailing sequential
    segment, feed the stage histograms, record into the ring + worst
    board, and hand the snapshot to the worker spool sink if wired."""
    tl = _tl.get()
    if tl is None:
        return
    _tl.set(None)
    finish(tl, status=status, final_stage=final_stage)


def detached(trace_id: str, api: str) -> Timeline | None:
    """A Timeline NOT bound to the context — for server-side work whose
    originating request lives in another process (ring lane serves)."""
    if not _ARMED:
        return None
    return Timeline(trace_id, api)


def finish(tl: Timeline, status: int = 200,
           final_stage: str | None = None) -> dict:
    snap = tl.finalize(status, final_stage)
    with _mu:
        _ring.append(snap)
        board = _worst.setdefault(snap["api"], [])
        board.append((snap["e2e_ns"], snap))
        board.sort(key=lambda t: -t[0])
        del board[_WORST_N:]
    sink = _sink
    if sink is not None:
        try:
            sink(snap)
        # the spool is a best-effort cross-worker
        # mirror; the local ring above already holds the snapshot, and a
        # recorder failure must never fail the request being recorded.
        except Exception:  # noqa: BLE001
            pass
    return snap


# --- wiring (worker fan-in) --------------------------------------------------


def armed() -> bool:
    return _ARMED


def set_armed(on: bool) -> None:
    """Test/bench hook — the production gate is MTPU_FLIGHT at boot."""
    global _ARMED
    _ARMED = bool(on)


def set_worker(worker: int) -> None:
    global _worker
    _worker = worker


def attach_sink(fn) -> None:
    """Every finished snapshot is also handed to `fn(snap)` — the
    front-door worker wires its shm FlightSpool writer here so the
    admin endpoint can read all workers' recorders from any worker."""
    global _sink
    _sink = fn


def set_sibling_reader(fn) -> None:
    """`fn() -> list[snap]` reading the OTHER workers' spools."""
    global _sibling_reader
    _sibling_reader = fn


def reset() -> None:
    """Drop recorded state (tests)."""
    global _sink, _sibling_reader
    with _mu:
        _ring.clear()
        _worst.clear()
    _sink = None
    _sibling_reader = None


# --- query -------------------------------------------------------------------


def _matches(snap: dict, traceid: str, api: str, tenant: str = "") -> bool:
    if traceid and snap.get("trace_id") != traceid:
        return False
    if api and snap.get("api") != api:
        return False
    if tenant and snap.get("tenant") != tenant:
        return False
    return True


def query(snaps, traceid: str = "", api: str = "",
          worst: int = 0, tenant: str = "") -> list[dict]:
    """Filter + order an iterable of snapshots: trace-id/api/tenant
    exact match; `worst` keeps the N slowest, else newest first."""
    out = [s for s in snaps if _matches(s, traceid, api, tenant)]
    if worst > 0:
        out.sort(key=lambda s: -s.get("e2e_ns", 0))
        return out[:worst]
    out.reverse()
    return out


def snapshot(traceid: str = "", api: str = "",
             worst: int = 0, tenant: str = "") -> list[dict]:
    """This process's recorder contents, filtered."""
    with _mu:
        if worst > 0:
            boards = ([_worst.get(api, [])] if api
                      else list(_worst.values()))
            snaps = [s for board in boards for _, s in board]
        else:
            snaps = list(_ring)
    return query(snaps, traceid, api, worst, tenant)


def collect(traceid: str = "", api: str = "",
            worst: int = 0, tenant: str = "") -> list[dict]:
    """Local recorder + sibling front-door workers' spools, filtered.
    Peer federation happens a layer up (admin/handlers.py), the same
    split /metrics/cluster uses."""
    snaps = snapshot(traceid, api, worst, tenant)
    reader = _sibling_reader
    if reader is not None:
        try:
            snaps = query(snaps + reader(), traceid, api, worst, tenant)
        # a sibling worker mid-respawn (its spool
        # gone or half-built) degrades the answer to local-only; the
        # query must still serve what this worker has.
        except Exception:  # noqa: BLE001
            pass
    return snaps
