"""Declarative SLO objectives evaluated as multi-window burn rates
(counterpart of minio_tpu/obs/slo.py: the same objectives, math, state
document and gauges).

An SLO here is "fraction of requests that must be good" — good meaning
under a latency threshold (per-API p99-style objectives, measured from
the histogram buckets themselves) or not a 5xx (error-ratio objectives).
The *burn rate* is how fast the error budget is spent:
`(bad fraction over the window) / (1 - target)`. Burn 1.0 exactly
exhausts the budget over the SLO period; the fast-burn page threshold
14.4 (Google SRE workbook) means "at this rate a 30-day budget is gone
in 2 days".

Evaluation runs over two windows of the on-node ring (obs/tsdb.py): a
fast one (`MTPU_SLO_FAST_WINDOW_S`, 5 min) and a slow one
(`MTPU_SLO_SLOW_WINDOW_S`, 1 h). Both trim to the history on record, so
a freshly booted node breaches on a sustained burn within one fast
window. Breach = fast AND slow at or over `MTPU_SLO_BURN_THRESHOLD`.

Results surface three ways:
- gauges `minio_tpu_slo_burn_rate{slo,window}` and
  `minio_tpu_slo_breach{slo}` in the normal exposition;
- `GET /minio/admin/v3/slo` — this worker's state merged with its
  front-door siblings' (shm StateSpool, frontdoor/shm.py) and federated
  across a cluster's peers (admin/metrics.py collect_cluster_slo);
- the chaos invariants read the same ring windows
  (`chaos.invariants.window_from_ring`).
"""

from __future__ import annotations

import os
import threading
import time

from minio_tpu_torch.obs import tsdb as _tsdb
from minio_tpu_torch.obs.histogram import gauge as _gauge

# Objective schema: `kind` latency | error_ratio. A latency objective
# names a histogram `family`, a `threshold_s` good/bad cut and an
# optional `match` label filter or `by` grouping label (a grouped
# objective reports the WORST group's burn: one series per objective);
# an error_ratio objective names its `total` and `bad` counter families.
# `target` is the good fraction promised; the error budget is 1 - target.
SLO_OBJECTIVES = {
    "put_latency_p99": {
        "kind": "latency",
        "family": "minio_tpu_s3_requests_latency_seconds",
        "match": {"api": "PutObject"},
        "threshold_s": 1.0,
        "target": 0.99,
    },
    "get_latency_p99": {
        "kind": "latency",
        "family": "minio_tpu_s3_requests_latency_seconds",
        "match": {"api": "GetObject"},
        "threshold_s": 0.5,
        "target": 0.99,
    },
    "s3_error_ratio": {
        "kind": "error_ratio",
        "total": "minio_tpu_s3_requests_total",
        "bad": "minio_tpu_s3_requests_5xx_errors_total",
        "target": 0.999,
    },
    "tenant_latency_p99": {
        "kind": "latency",
        "family": "minio_tpu_tenant_request_seconds",
        "by": "tenant",
        "threshold_s": 1.0,
        "target": 0.99,
    },
}

WINDOWS = ("fast", "slow")

_BURN = _gauge(
    "minio_tpu_slo_burn_rate",
    "Error-budget burn rate per SLO objective and evaluation window",
    ("slo", "window"))
_BREACH = _gauge(
    "minio_tpu_slo_breach",
    "1 when an SLO's fast AND slow burn rates are over threshold",
    ("slo",))


class SLOEngine:
    """Burn-rate evaluator over one TSDB ring. The env knobs resolve at
    construction (tests pin small windows before building a server)."""

    def __init__(self, db: "_tsdb.TSDB | None" = None):
        env = os.environ.get
        self.db = db if db is not None else _tsdb.get()
        self.fast_s = float(env("MTPU_SLO_FAST_WINDOW_S", "300"))
        self.slow_s = float(env("MTPU_SLO_SLOW_WINDOW_S", "3600"))
        self.threshold = float(env("MTPU_SLO_BURN_THRESHOLD", "14.4"))
        self._mu = threading.Lock()
        self._state: dict = {"time": 0.0, "slos": {}}

    # -- burn math ------------------------------------------------------

    @staticmethod
    def _latency_burn(obj: dict, window: dict) -> tuple[float, dict]:
        """Worst-group burn from cumulative bucket deltas: good = the
        count at the smallest bound >= threshold_s (observations between
        the threshold and that bound count good)."""
        fam = obj["family"] + "_bucket"
        match = obj.get("match") or {}
        by = obj.get("by")
        groups: dict[str, dict[float, float]] = {}
        for (name, labels), v in window.items():
            if name != fam:
                continue
            ld = dict(labels)
            if any(ld.get(k) != mv for k, mv in match.items()):
                continue
            le = ld.get("le", "")
            bound = float("inf") if le == "+Inf" else float(le)
            g = groups.setdefault(ld.get(by, "") if by else "", {})
            g[bound] = g.get(bound, 0.0) + v
        budget = max(1e-9, 1.0 - float(obj["target"]))
        thr = float(obj["threshold_s"])
        worst, per = 0.0, {}
        for gk, buckets in sorted(groups.items()):
            bounds = sorted(buckets)
            total = buckets[bounds[-1]]
            if total <= 0:
                continue
            good = 0.0
            for b in bounds:
                if b >= thr:
                    good = buckets[b]
                    break
            bad = max(0.0, total - good)
            burn = (bad / total) / budget
            per[gk or "_"] = {"burn": round(burn, 4),
                              "total": round(total, 1),
                              "bad": round(bad, 1)}
            worst = max(worst, burn)
        return worst, per

    @staticmethod
    def _error_burn(obj: dict, window: dict) -> tuple[float, dict]:
        total = sum(v for (n, _l), v in window.items() if n == obj["total"])
        bad = sum(v for (n, _l), v in window.items() if n == obj["bad"])
        budget = max(1e-9, 1.0 - float(obj["target"]))
        frac = (bad / total) if total > 0 else 0.0
        return (frac / budget,
                {"_": {"burn": round(frac / budget, 4),
                       "total": round(total, 1), "bad": round(bad, 1)}})

    def _burn(self, obj: dict, window: dict) -> tuple[float, dict]:
        if obj["kind"] == "latency":
            return self._latency_burn(obj, window)
        return self._error_burn(obj, window)

    # -- evaluation -----------------------------------------------------

    def evaluate(self) -> dict:
        """One pass over both windows for every objective: sets the burn
        and breach gauges, stores the state the /slo route serves, and
        hands it to the worker's spool sink where one is wired."""
        deltas = {"fast": self.db.delta_window(self.fast_s),
                  "slow": self.db.delta_window(self.slow_s)}
        slos: dict[str, dict] = {}
        for name, obj in SLO_OBJECTIVES.items():
            burns: dict[str, float] = {}
            windows: dict[str, dict] = {}
            for w in WINDOWS:
                span, window = deltas[w]
                burn, per = self._burn(obj, window)
                burns[w] = burn
                _BURN.set(burn, slo=name, window=w)
                windows[w] = {"burn": round(burn, 4),
                              "window_s": round(span, 1),
                              "groups": per}
            breach = (burns["fast"] >= self.threshold
                      and burns["slow"] >= self.threshold)
            _BREACH.set(1.0 if breach else 0.0, slo=name)
            slos[name] = {"breach": breach, "windows": windows,
                          "target": obj["target"], "kind": obj["kind"]}
        state = {"time": time.time(), "worker": _worker,
                 "threshold": self.threshold,
                 "fast_s": self.fast_s, "slow_s": self.slow_s,
                 "slos": slos}
        with self._mu:
            self._state = state
        sink = _sink
        if sink is not None:
            try:
                sink(state)
            # The spool mirror is best effort: this worker's state above
            # is already queryable locally.
            except Exception:  # noqa: BLE001
                pass
        return state

    def state(self) -> dict:
        with self._mu:
            return self._state


# --- process wiring ----------------------------------------------------------

_engine: SLOEngine | None = None
_mu = threading.Lock()
_sink = None             # the worker's shm StateSpool writer
_sibling_reader = None   # reads the other workers' StateSpools
_worker = -1             # front-door worker id, -1 alone


def ensure_started(store=None,
                   persist_key: str = "slo/history.json.gz"
                   ) -> SLOEngine | None:
    """Get or make the engine, hook it to the TSDB sampler and start
    sampling; None when disarmed (MTPU_SLO=0). `store`
    (read_sys_config / write_sys_config) attaches the ring's persistence
    and may be passed on a later call."""
    if not _tsdb.armed():
        return None
    global _engine
    with _mu:
        if _engine is None:
            db = _tsdb.get()
            _engine = SLOEngine(db)
            db.add_listener(_engine.evaluate)
            db.start()
        if store is not None:
            _engine.db.attach_store(store, persist_key)
        return _engine


def engine() -> SLOEngine | None:
    return _engine


def set_worker(worker: int) -> None:
    global _worker
    _worker = worker


def attach_sink(fn) -> None:
    """Every evaluation's state is also handed to `fn(state)`: the
    front-door worker wires its shm StateSpool writer here."""
    global _sink
    _sink = fn


def set_sibling_reader(fn) -> None:
    """`fn() -> list[state]` reading the OTHER workers' spools."""
    global _sibling_reader
    _sibling_reader = fn


def reset() -> None:
    """Tear down the engine and the ring (tests), so the next
    ensure_started builds them anew from the current env."""
    global _engine, _sink, _sibling_reader
    with _mu:
        _engine = None
    _sink = None
    _sibling_reader = None
    _tsdb.reset()


# --- query (worker fan-in and merge) -----------------------------------------


def merge_states(states: list[dict]) -> dict:
    """Fold per-worker states into one node answer: per objective the
    worst burn of each window, and a breach if any worker breaches (each
    worker sees only its own traffic, so the node burns as fast as its
    hottest worker)."""
    merged: dict = {"time": 0.0, "workers": [], "slos": {}}
    for st in states:
        if not isinstance(st, dict):
            continue
        merged["time"] = max(merged["time"], st.get("time", 0.0))
        merged["workers"].append(st.get("worker", -1))
        for k in ("threshold", "fast_s", "slow_s"):
            if k in st:
                merged.setdefault(k, st[k])
        for name, s in (st.get("slos") or {}).items():
            cur = merged["slos"].setdefault(
                name, {"breach": False, "windows": {},
                       "target": s.get("target"), "kind": s.get("kind")})
            cur["breach"] = cur["breach"] or bool(s.get("breach"))
            for w, wd in (s.get("windows") or {}).items():
                cw = cur["windows"].setdefault(
                    w, {"burn": 0.0, "window_s": 0.0, "groups": {}})
                if wd.get("burn", 0.0) >= cw["burn"]:
                    cw.update({"burn": wd.get("burn", 0.0),
                               "window_s": wd.get("window_s", 0.0),
                               "groups": wd.get("groups", {})})
    return merged


def collect_local() -> dict:
    """This process's SLO state merged with its front-door siblings'.
    The peer federation is a layer up (admin/metrics.py)."""
    states: list[dict] = []
    eng = _engine
    if eng is not None:
        states.append(eng.state())
    reader = _sibling_reader
    if reader is not None:
        try:
            states.extend(reader() or [])
        # A sibling mid-respawn degrades the answer to this worker's.
        except Exception:  # noqa: BLE001
            pass
    return merge_states(states)
