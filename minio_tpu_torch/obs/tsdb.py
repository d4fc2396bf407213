"""Bounded on-node metric history: the SLO plane's time-series ring
(counterpart of minio_tpu/obs/tsdb.py, same snapshot and persisted
shapes).

Prometheus answers "what is the counter NOW"; burn-rate alerting needs
"what was it five minutes ago". This module keeps that history on the
node itself: a sampler thread snapshots the *cumulative* values of a
selected set of metric families every `MTPU_SLO_SAMPLE_S` seconds into
a bounded raw ring, subsamples one entry per minute into a coarse
retention tier, and periodically persists the coarse tier through the
sys-config store (`write_sys_config`, erasure/sysstore.py) so history
survives a restart. The persisted document is the JAX package's, so
either package restores what the other wrote.

Every snapshot is the `chaos.invariants.parse_exposition` dict
`{(sample_name, sorted-label-pairs): value}`, so `delta`,
`histogram_quantile` and `counter_sum` consume a ring window exactly as
they consume two live scrapes (`chaos.invariants.window_from_ring`).

Families rendered from the obs registry (obs/histogram.py) are sampled
directly; values that only exist exporter-side (the per-API request and
error counters derived from HTTPStats) reach the ring through
`add_source` callbacks the server registers at boot.

Nothing on any request path touches this module: the sampler pulls on
its own cadence, and disarmed (`MTPU_SLO=0`) no thread starts at all.
"""

from __future__ import annotations

import gzip
import json
import os
import threading
import time
from collections import deque

from minio_tpu_torch.obs.histogram import registry as _obs_registry

ARM_ENV = "MTPU_SLO"

# Families the ring samples by default: per-API and per-tenant latency
# histograms, per-tenant status counters, stage decomposition and the
# admission shed counter — the inputs of the objectives in obs/slo.py.
# MTPU_SLO_FAMILIES overrides (comma-separated).
DEFAULT_FAMILIES = (
    "minio_tpu_s3_requests_latency_seconds",
    "minio_tpu_s3_ttfb_seconds",
    "minio_tpu_s3_requests_total",
    "minio_tpu_s3_requests_errors_total",
    "minio_tpu_s3_requests_5xx_errors_total",
    "minio_tpu_tenant_request_seconds",
    "minio_tpu_tenant_requests_total",
    "minio_tpu_stage_seconds",
    "minio_tpu_admission_shed_total",
)


def armed() -> bool:
    return os.environ.get(ARM_ENV, "1") not in ("0", "false", "off")


class _Sink:
    """PromText-shaped sink collecting samples into the invariants dict
    shape instead of text lines."""

    wants_exemplars = False

    def __init__(self):
        self.out: dict[tuple, float] = {}

    def family(self, name: str, help_: str, typ: str = "gauge") -> None:
        pass

    def sample(self, name: str, value, labels: dict | None = None) -> None:
        key = (name, tuple(sorted(
            (k, str(v)) for k, v in (labels or {}).items())))
        try:
            self.out[key] = float(value)
        except (TypeError, ValueError):
            return


class TSDB:
    """The bounded two-tier ring and its sampler. Every knob resolves its
    env var at construction, so tests can pin them."""

    def __init__(self, families: tuple[str, ...] | None = None,
                 sample_s: float | None = None,
                 raw_window_s: float | None = None,
                 coarse_window_s: float | None = None,
                 persist_s: float | None = None):
        env = os.environ.get
        if families is None:
            raw = env("MTPU_SLO_FAMILIES", "")
            families = (tuple(f for f in raw.split(",") if f)
                        if raw else DEFAULT_FAMILIES)
        self.families = tuple(families)
        self.sample_s = (sample_s if sample_s is not None
                         else float(env("MTPU_SLO_SAMPLE_S", "5")))
        raw_w = (raw_window_s if raw_window_s is not None
                 else float(env("MTPU_SLO_RAW_WINDOW_S", "3900")))
        coarse_w = (coarse_window_s if coarse_window_s is not None
                    else float(env("MTPU_SLO_COARSE_WINDOW_S", "86400")))
        self.persist_s = (persist_s if persist_s is not None
                          else float(env("MTPU_SLO_PERSIST_S", "60")))
        # The coarse tier subsamples to about one entry a minute whatever
        # the raw cadence, so retention is bounded by wall clock.
        self._coarse_every = max(1, int(round(60.0 / self.sample_s)))
        self._raw: deque = deque(maxlen=max(8, int(raw_w / self.sample_s)))
        self._coarse: deque = deque(maxlen=max(8, int(coarse_w / 60.0)))
        self._mu = threading.Lock()
        # key -> fn() -> iter[(name, labels, value)]
        self._sources: dict[object, object] = {}
        self._listeners: list = []    # fn() after each sample (SLO eval)
        self._tick = 0
        self._store = None
        self._persist_key = ""
        self._last_persist = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- feeding --------------------------------------------------------

    def add_source(self, fn, key: object = None) -> None:
        """`fn() -> iterable[(name, labels_dict, value)]` sampled each
        tick. A repeated `key` REPLACES the earlier source, so a rebuilt
        server never leaves its predecessor's stats shadowing the live
        ones."""
        self._sources[key if key is not None else object()] = fn

    def add_listener(self, fn) -> None:
        """`fn()` runs after every appended sample (the SLO engine's
        evaluation). Exceptions are swallowed: a broken evaluator must
        not stop the history."""
        self._listeners.append(fn)

    def _collect(self) -> dict[tuple, float]:
        p = _Sink()
        want = set(self.families)
        for vec in _obs_registry():
            if getattr(vec, "name", "") in want:
                vec.render_into(p)
        for src in list(self._sources.values()):
            try:
                for name, labels, value in src():
                    if name in want:
                        p.sample(name, value, labels)
            # A faulted source loses its own families from this tick only.
            except Exception:  # noqa: BLE001
                continue
        return p.out

    def sample_now(self) -> None:
        """Take one snapshot (the sampler's body; tests call it)."""
        snap = self._collect()          # no ring lock held while rendering
        ts = time.time()
        with self._mu:
            self._raw.append((ts, snap))
            self._tick += 1
            if self._tick % self._coarse_every == 0:
                self._coarse.append((ts, snap))
        for fn in list(self._listeners):
            try:
                fn()
            except Exception:  # noqa: BLE001 - see add_listener
                continue
        if (self._store is not None
                and ts - self._last_persist >= self.persist_s):
            self._last_persist = ts
            self.persist()

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="mtpu-slo-sampler")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.sample_s):
            try:
                self.sample_now()
            # The sampler survives any transient render or persist
            # failure; the next tick retries.
            except Exception:  # noqa: BLE001
                continue

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
        self._thread = None

    # -- querying -------------------------------------------------------

    def _entries(self) -> list[tuple[float, dict]]:
        with self._mu:
            ent = list(self._coarse) + list(self._raw)
        ent.sort(key=lambda e: e[0])
        # Coarse and raw overlap on recent history: drop duplicates by
        # timestamp.
        out: list[tuple[float, dict]] = []
        for ts, snap in ent:
            if out and out[-1][0] == ts:
                continue
            out.append((ts, snap))
        return out

    def delta_window(self, seconds: float) -> tuple[float, dict]:
        """(actual_span_s, {key: delta}) between the newest snapshot and
        the one at or before `now - seconds` (trimmed to the oldest on
        record). Negative deltas — a counter reset across a restart with
        restored history — clamp to 0: burn rates need one fresh window
        after a restart, never a phantom negative burn."""
        ent = self._entries()
        if len(ent) < 2:
            return 0.0, {}
        newest_ts, newest = ent[-1]
        cutoff = newest_ts - seconds
        base_ts, base = ent[0]
        for ts, snap in ent:
            if ts > cutoff:
                break
            base_ts, base = ts, snap
        if newest_ts <= base_ts:
            return 0.0, {}
        return (newest_ts - base_ts,
                {k: max(0.0, v - base.get(k, 0.0))
                 for k, v in newest.items()})

    def history(self, seconds: float = 0.0, prefix: str = "") -> list[dict]:
        """The ring for the admin slo/history route, newest last:
        {"t": ts, "samples": [[name, [[k, v]..], value]..]}."""
        ent = self._entries()
        if seconds > 0 and ent:
            cutoff = ent[-1][0] - seconds
            ent = [e for e in ent if e[0] >= cutoff]
        return [{"t": round(ts, 3),
                 "samples": [[n, [list(kv) for kv in lbl], v]
                             for (n, lbl), v in sorted(snap.items())
                             if not prefix or n.startswith(prefix)]}
                for ts, snap in ent]

    # -- persistence ----------------------------------------------------

    def attach_store(self, store, key: str) -> None:
        """Persist the coarse tier through a sys-config store and restore
        whatever a predecessor left there. Best effort both ways."""
        self._store = store
        self._persist_key = key
        try:
            raw = store.read_sys_config(key)
            doc = json.loads(gzip.decompress(bytes(raw)).decode())
            with self._mu:
                for ts, flat in doc.get("coarse", []):
                    snap = {(n, tuple(tuple(kv) for kv in lbl)): float(v)
                            for n, lbl, v in flat}
                    self._coarse.append((float(ts), snap))
        # No (or a corrupt) prior history is a cold start.
        except Exception:  # noqa: BLE001
            return

    def detach_store(self, store) -> None:
        """Stop persisting through `store` if it is the attached one (its
        server is closing; the history in memory stays)."""
        if self._store is store:
            self._store = None

    def persist(self) -> None:
        store, key = self._store, self._persist_key
        if store is None:
            return
        cap = int(os.environ.get("MTPU_SLO_PERSIST_SAMPLES", "120"))
        with self._mu:
            coarse = list(self._coarse)[-cap:]
        doc = {"v": 1, "time": time.time(),
               "coarse": [[ts, [[n, [list(kv) for kv in lbl], v]
                                for (n, lbl), v in snap.items()]]
                          for ts, snap in coarse]}
        blob = gzip.compress(
            json.dumps(doc, separators=(",", ":")).encode(), 5)
        try:
            store.write_sys_config(key, blob)
        # Best effort: a store mid-teardown or below write quorum must not
        # kill the sampler.
        except Exception:  # noqa: BLE001
            return


# --- process singleton -------------------------------------------------------

_tsdb: TSDB | None = None
_mu = threading.Lock()


def get() -> TSDB:
    """The process TSDB (made on first use, its sampler NOT started:
    that is obs/slo.py ensure_started's job)."""
    global _tsdb
    with _mu:
        if _tsdb is None:
            _tsdb = TSDB()
        return _tsdb


def reset() -> None:
    """Tear down the process TSDB (tests): stop the sampler and drop the
    history, so the next get() builds anew from the current env."""
    global _tsdb
    with _mu:
        t, _tsdb = _tsdb, None
    if t is not None:
        t.stop()
