"""Contextvar span recorder over the process trace bus (counterpart of
minio_tpu/obs/span.py).

A span is a timed section that publishes ONE typed trace record at exit
(`mc admin trace --call` shape): {type, name, durationNs, time, ...attrs},
with the enclosing span's name attached as `parent` when both live on the
same thread of control.

Zero-overhead contract: `span()` returns the shared `_NOOP` singleton —
no Span object, no contextvar write, no clock read — unless the bus has
a subscriber at entry. `Span.allocated` counts constructions so tests can
assert the hot path stays allocation-free without a subscriber.

Trace context: a second contextvar pair carries the request's trace id
(the S3 request id) and the emitting node's identity. Every record that
reaches the bus is enriched with `trace_id` + `node` at publish time,
under the subscriber gate. Context variables do not cross
threading.Thread or pool submissions: every hand-off on a request's
behalf goes through `ctx_wrap`, so a drive's records carry the request's
trace id.
"""

from __future__ import annotations

import contextvars
import socket
import time
from contextlib import contextmanager

from minio_tpu_torch.admin.pubsub import PubSub

_BUS = PubSub()
_current: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_span", default=None)

# The closed set of trace record types that may ride the bus, carried as
# the JAX package has it. Consumers key on it (admin trace stream
# `?type=` filtering).
RECORD_TYPES = frozenset({
    "internal",   # obs.span default: engine-internal timed sections
    "http",       # S3 front door request records
    "storage",    # per-drive op records (local + remote)
    "drive",      # drive health state transitions
    "rpc",        # peer fabric round trips
    "kernel",     # device-plane kernel launches
    "batch",      # plane batch boundaries (dataplane launch / WAL group
                  # fsync) linking member trace_ids
    "ring",       # shm ring lane serves (cross-process front-door hop)
    "hottier",    # HBM hot-tier serve/admit/evict events
    "replication",  # cross-cluster replication task lifecycle
                    # (queued / completed / failed / skipped)
})

# --- trace context -----------------------------------------------------------

_trace_id: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_trace_id", default=None)
_node_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_node", default=None)
# The node identity records carry unless the context names one.
_NODE_DEFAULT = socket.gethostname()


def set_default_node(name: str) -> None:
    """Process-wide fallback node identity (a front-door worker names
    itself `<addr>#w<id>`)."""
    global _NODE_DEFAULT
    if name:
        _NODE_DEFAULT = name


def set_trace_context(trace_id: str | None = None, node: str | None = None):
    """Bind trace id and/or node identity to the current context. Returns
    an opaque token for reset_trace_context (pass through unchanged)."""
    t1 = _trace_id.set(trace_id) if trace_id is not None else None
    t2 = _node_ctx.set(node) if node is not None else None
    return (t1, t2)


def reset_trace_context(tokens) -> None:
    t1, t2 = tokens
    if t1 is not None:
        _trace_id.reset(t1)
    if t2 is not None:
        _node_ctx.reset(t2)


def trace_id() -> str | None:
    return _trace_id.get()


def current_node() -> str:
    return _node_ctx.get() or _NODE_DEFAULT


def ctx_wrap(fn):
    """Capture the CURRENT context (trace id, node, span parent) and
    return a callable running fn inside a private copy — the bridge for
    pool/thread submissions, which do not inherit contextvars. Each call
    to ctx_wrap snapshots its own copy, so wrapped closures may run
    concurrently."""
    ctx = contextvars.copy_context()
    return lambda *a, **kw: ctx.run(fn, *a, **kw)


def _enrich(rec: dict) -> None:
    """Stamp trace_id + node onto an outbound record. Only called under
    the subscriber gate."""
    tid = _trace_id.get()
    if tid is not None and "trace_id" not in rec:
        rec["trace_id"] = tid
    if "node" not in rec:
        rec["node"] = _node_ctx.get() or _NODE_DEFAULT


def trace_bus() -> PubSub:
    """The process trace bus (reference globalTrace pubsub)."""
    return _BUS


def has_subscribers() -> bool:
    return _BUS.has_subscribers


def publish(record: dict) -> None:
    """Publish a pre-built trace record, enriched with the current trace
    context (`trace_id`, `node`). Callers on hot paths must gate on
    has_subscribers() BEFORE building the record."""
    _enrich(record)
    _BUS.publish(record)


class Span:
    allocated = 0  # class-level construction count (zero-overhead guard)

    __slots__ = ("name", "typ", "attrs", "_t0", "_token")

    def __init__(self, name: str, typ: str, attrs: dict):
        Span.allocated += 1
        self.name = name
        self.typ = typ
        self.attrs = attrs
        self._t0 = 0.0
        self._token = None

    def set(self, **kv) -> None:
        """Attach attrs discovered mid-span (e.g. byte counts)."""
        self.attrs.update(kv)

    def __enter__(self) -> "Span":
        self._token = _current.set(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur = time.perf_counter() - self._t0
        parent = None
        if self._token is not None:
            parent = self._token.old_value
            if parent is contextvars.Token.MISSING:
                parent = None
            _current.reset(self._token)
        if _BUS.has_subscribers:
            rec = {"type": self.typ, "name": self.name,
                   "time": time.time(), "durationNs": int(dur * 1e9)}
            if isinstance(parent, Span):
                rec["parent"] = parent.name
            if exc is not None:
                rec["error"] = f"{type(exc).__name__}: {exc}"
            rec.update(self.attrs)
            _enrich(rec)
            _BUS.publish(rec)
        return False


class _NoopSpan:
    __slots__ = ()

    def set(self, **kv) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, typ: str = "internal", **attrs):
    """Timed trace section; `with obs.span("quorum-read", bucket=b): ...`.
    Returns the no-op singleton when nobody is watching."""
    if not _BUS.has_subscribers:
        return _NOOP
    return Span(name, typ, attrs)


@contextmanager
def timed_op(observe, op: str, volume: str, path: str):
    """Shared timing wrapper for per-op storage instrumentation:
    `observe(op, t0, volume, path, err)` fires on both success and
    failure. Not for microsecond-hot paths (generator contextmanagers
    cost ~1us per entry) — those keep an inline try/finally."""
    t0 = time.perf_counter()
    try:
        yield
    except BaseException as e:
        observe(op, t0, volume, path, e)
        raise
    else:
        observe(op, t0, volume, path)
