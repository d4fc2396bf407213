"""Fixed-bucket histograms + counters/gauges with a process registry
(counterpart of minio_tpu/obs/histogram.py, kept byte-equal in what it
renders).

The exposition contract mirrors client_golang's (what cmd/metrics-v2.go
renders): log-spaced `le` upper bounds, cumulative bucket counts ending
at `+Inf`, plus `_sum` and `_count` series. `observe()` is lock-cheap —
one bisect over a 16-entry tuple and a short critical section — so the
per-drive read path can afford it on every call.

Rendering is duck-typed against admin.metrics.PromText (family/sample)
so this module stays import-light and the admin exporter depends on us,
never the reverse.

OpenMetrics exemplars: every `EXEMPLAR_EVERY`-th observation of a
histogram that runs under a request trace context captures its trace id
against the bucket it landed in, and the exporter renders it as an
OpenMetrics exemplar annotation under content negotiation. The other
observations pay one counter increment.
"""

from __future__ import annotations

import bisect
import threading
import time

# The closed set of label keys an exemplar annotation may carry (the JAX
# package's set).
EXEMPLAR_LABELS = ("trace_id",)

# Sample one observation in this many (the JAX package's default).
EXEMPLAR_EVERY = 8
_trace_id_fn = None  # lazily bound to obs.span.trace_id on first capture


# Log-spaced seconds: 100us .. 10s, the spread between a cached journal
# stat and a cold distributed PUT (reference metrics-v2 latency buckets).
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
                   0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


class Histogram:
    """One labelset's distribution: counts per `le` bound + sum."""

    __slots__ = ("buckets", "_counts", "_sum", "_mu", "_ex_n",
                 "_exemplars")

    def __init__(self, buckets=LATENCY_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self._sum = 0.0
        self._mu = threading.Lock()
        self._ex_n = 0
        # bucket index -> (trace_id, value, unix_ts). Written without
        # the lock: a single dict-slot store is atomic under the GIL,
        # and a reader racing an overwrite sees either exemplar — both
        # valid. Sampling keeps the tax to one counter increment
        # on most observes.
        self._exemplars: dict[int, tuple] = {}

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        with self._mu:
            self._counts[i] += 1
            self._sum += value
        self._ex_n += 1
        if self._ex_n % EXEMPLAR_EVERY == 0:
            _capture_exemplar(self, i, value)

    def exemplar(self, bucket_index: int) -> tuple | None:
        """(trace_id, value, ts) captured for one bucket, or None."""
        return self._exemplars.get(bucket_index)

    def snapshot(self) -> tuple[list[int], float]:
        """(per-bucket counts incl. +Inf, sum) — a consistent pair."""
        with self._mu:
            return list(self._counts), self._sum


def _capture_exemplar(h: Histogram, i: int, value: float) -> None:
    """Off the fast path (every Nth observe): bind the trace-id
    accessor lazily (histogram stays import-light) and store the
    latest exemplar for the bucket the observation landed in."""
    global _trace_id_fn
    if _trace_id_fn is None:
        from minio_tpu_torch.obs.span import trace_id

        _trace_id_fn = trace_id
    tid = _trace_id_fn()
    if not tid:
        return
    h._exemplars[i] = (tid, value, time.time())


class HistogramVec:
    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...],
                 buckets=LATENCY_BUCKETS):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        self._children: dict[tuple, Histogram] = {}
        self._mu = threading.Lock()

    def labels(self, **kv) -> Histogram:
        key = tuple(str(kv[n]) for n in self.labelnames)
        h = self._children.get(key)
        if h is None:
            with self._mu:
                h = self._children.setdefault(key, Histogram(self.buckets))
        return h

    def render_into(self, p) -> None:
        p.family(self.name, self.help, "histogram")
        # Snapshot the child map under the vec lock: a concurrent
        # labels() insert during a scrape must never tear the family
        # (RuntimeError mid-iteration, or a half-rendered labelset).
        with self._mu:
            children = sorted(self._children.items())
        want_ex = getattr(p, "wants_exemplars", False)
        for key, h in children:
            counts, total = h.snapshot()
            base = dict(zip(self.labelnames, key))
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                self._bucket(p, cum, {**base, "le": _fmt(bound)},
                             h.exemplar(i) if want_ex else None)
            cum += counts[-1]
            self._bucket(p, cum, {**base, "le": "+Inf"},
                         h.exemplar(len(self.buckets)) if want_ex
                         else None)
            p.sample(f"{self.name}_sum", round(total, 6), base or None)
            p.sample(f"{self.name}_count", cum, base or None)

    def _bucket(self, p, cum, labels, ex) -> None:
        # Exemplars travel by keyword only when present, so plain
        # PromText-shaped sinks without the parameter keep working.
        if ex is not None:
            p.sample(f"{self.name}_bucket", cum, labels, exemplar=ex)
        else:
            p.sample(f"{self.name}_bucket", cum, labels)


class CounterVec:
    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, "_Counter"] = {}
        self._mu = threading.Lock()

    def labels(self, **kv) -> "_Counter":
        key = tuple(str(kv[n]) for n in self.labelnames)
        c = self._children.get(key)
        if c is None:
            with self._mu:
                c = self._children.setdefault(key, _Counter())
        return c

    def render_into(self, p) -> None:
        p.family(self.name, self.help, "counter")
        with self._mu:
            children = sorted(self._children.items())
        for key, c in children:
            p.sample(self.name, c.value,
                     dict(zip(self.labelnames, key)) or None)


class _Counter:
    __slots__ = ("value", "_mu")

    def __init__(self):
        self.value = 0
        self._mu = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self.value += n


class GaugeVec:
    def __init__(self, name: str, help_: str, labelnames: tuple[str, ...] = ()):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: dict[tuple, list] = {}
        self._mu = threading.Lock()

    def labels(self, **kv) -> "_Gauge":
        key = tuple(str(kv[n]) for n in self.labelnames)
        g = self._children.get(key)
        if g is None:
            with self._mu:
                g = self._children.setdefault(key, _Gauge())
        return g

    def set(self, value: float, **kv) -> None:
        self.labels(**kv).set(value)

    def render_into(self, p) -> None:
        p.family(self.name, self.help, "gauge")
        with self._mu:
            children = sorted(self._children.items())
        for key, g in children:
            p.sample(self.name, round(g.value, 6),
                     dict(zip(self.labelnames, key)) or None)


class _Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


def _fmt(bound: float) -> str:
    s = repr(bound)
    return s[:-2] if s.endswith(".0") else s


# --- process registry --------------------------------------------------------

_REGISTRY: dict[str, object] = {}
_REG_MU = threading.Lock()


def _register(name: str, factory):
    with _REG_MU:
        v = _REGISTRY.get(name)
        if v is None:
            v = factory()
            _REGISTRY[name] = v
        return v


def histogram(name: str, help_: str, labelnames: tuple[str, ...] = (),
              buckets=LATENCY_BUCKETS) -> HistogramVec:
    """Get-or-create: modules on both ends of a family (LocalDrive and
    RemoteDrive both feed drive latency) share one vec by name."""
    return _register(name, lambda: HistogramVec(name, help_, labelnames,
                                                buckets))


def counter(name: str, help_: str,
            labelnames: tuple[str, ...] = ()) -> CounterVec:
    return _register(name, lambda: CounterVec(name, help_, labelnames))


def gauge(name: str, help_: str,
          labelnames: tuple[str, ...] = ()) -> GaugeVec:
    return _register(name, lambda: GaugeVec(name, help_, labelnames))


def registry() -> list:
    with _REG_MU:
        return [v for _n, v in sorted(_REGISTRY.items())]


def render_into(p) -> None:
    """Render every registered family into a PromText-shaped sink."""
    for vec in registry():
        vec.render_into(p)
