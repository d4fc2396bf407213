"""Unified observability: metric registry + request spans + trace bus
(counterpart of minio_tpu/obs/__init__.py).

Every plane of the port (the HTTP front door, the drives, the erasure
engine, the kernels and the batch planes) records through the same two
primitives:

- `histogram()/counter()/gauge()` — process-global, named metric
  families rendered into the Prometheus exposition by admin/metrics.py.
  Always on (a scrape must see the full history), cheap enough for the
  hot path (one bisect + a short lock per observe).
- `span()` and `publish()` — typed trace records on the process trace
  bus. Zero overhead when nothing subscribes: `span()` returns a shared
  no-op context manager without allocating, and publishers gate on
  `has_subscribers()`.

The bus is process-global: every S3Server and drive in the process
shares it, so `mc admin trace` sees the node's whole request path. The
SLO plane rides on the registry: `tsdb` (the on-node metric ring),
`slo` (burn-rate objectives over it) and `calibration` (the per-host
profile and the build-info gauge).
"""

import time as _time

from minio_tpu_torch.obs.histogram import (  # noqa: F401
    LATENCY_BUCKETS,
    CounterVec,
    GaugeVec,
    Histogram,
    HistogramVec,
    counter,
    gauge,
    histogram,
    registry,
    render_into,
)
from minio_tpu_torch.obs import calibration  # noqa: F401
from minio_tpu_torch.obs import flight  # noqa: F401
from minio_tpu_torch.obs import slo  # noqa: F401
from minio_tpu_torch.obs import tsdb  # noqa: F401
from minio_tpu_torch.obs.span import (  # noqa: F401
    Span,
    ctx_wrap,
    current_node,
    has_subscribers,
    publish,
    reset_trace_context,
    set_default_node,
    set_trace_context,
    span,
    timed_op,
    trace_bus,
    trace_id,
)

# The StorageAPI ops carrying the object hot path — the per-drive latency
# family tracks exactly these (reference minio_node_drive_latency_us).
DRIVE_OPS = ("read_version", "create_file", "write_metadata_single",
             "rename_data", "journal_commit_async", "write_all_async")


def drive_op_observer(drive: str):
    """observe(op, t0, volume, path, err=None) closure for one drive:
    feeds minio_tpu_drive_latency_seconds{drive,op} and, when watched,
    typed `storage` trace records."""
    lat = histogram("minio_tpu_drive_latency_seconds",
                    "Storage op latency by drive and op", ("drive", "op"))
    children = {op: lat.labels(drive=drive, op=op) for op in DRIVE_OPS}

    def observe(op: str, t0: float, volume: str, path: str,
                err: BaseException | None = None) -> None:
        dt = _time.perf_counter() - t0
        children[op].observe(dt)
        if has_subscribers():
            rec = {"type": "storage", "time": _time.time(),
                   "drive": drive, "op": op,
                   "vol": volume, "path": path,
                   "durationNs": int(dt * 1e9)}
            if err is not None:
                rec["error"] = f"{type(err).__name__}: {err}"
            publish(rec)

    return observe
