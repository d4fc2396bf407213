"""Device-plane kernel observability: per-kernel latency + batch shape
(counterpart of minio_tpu/obs/kernel.py, the same families and labels).

Families (rendered by admin/metrics.py through the shared registry):

- `minio_tpu_kernel_seconds{kernel,backend}` — time of one launch:
  host wall time by default, the device time of its hand-written
  kernels under MTPU_KERNEL_SYNC=1.
- `minio_tpu_kernel_batch_blocks{kernel,backend}` — batch rows staged
  into the most recent launch.
- `minio_tpu_kernel_batch_bytes{kernel,backend}` — bytes staged into
  the most recent launch.
- `minio_tpu_kernel_launches_total{kernel,backend}` — launch count.

`kernel` is the JAX package's entry-point label (encode, encode_digests,
reconstruct, reconstruct_digests, reconstruct_weights, verify_digests,
dp_<op>, bitrot_<algo>, bitrot_verify_<algo>); ops/fused.py documents
which of K1, K2 and K3 each label launches. `backend` is what JAX
reports for the same device: "gpu" on the card, "cpu" for the plain
versions, "host" for the host bitrot hashes.

Batched-dataplane families: `minio_tpu_dataplane_launches_total{op}` /
`_requests_total{op}` (amortization ratio), `_batch_fill{op}`
(occupancy histogram), `_queue_wait_seconds{op}` (submit→launch wait),
`_backpressure_total{op}` (bounded-queue rejections → 503 SlowDown).

Timing semantics: a launch returns before the card has done its work,
so by default the histogram records the host-side launch wall time: two
clock reads and one observe, no sync and no device-to-host copy. With
MTPU_KERNEL_SYNC=1 (or set_sync(True)) `start` opens a record on the
calling thread, each hand-written kernel's wrapper that launches on that
thread until `stop` brackets its launch with timing events on its stream
(`device_begin`/`device_end`), and observe waits for the last event and
records the sum of those kernels' device times: not the uploads queued
before them, nor the other ops of a composition. Each begin event
follows a short hold of the stream (HOLD_CYCLES), so the card is still
busy when the host launches the kernel and the events do not time its
wait for the host. A failed launch or sync raises; it is
never recorded as fast.

Typed `kernel` trace records ride the bus under the same zero-overhead
subscriber gate as every other plane.
"""

from __future__ import annotations

import os
import threading
import time

from minio_tpu_torch.obs.histogram import counter as _counter
from minio_tpu_torch.obs.histogram import gauge as _gauge
from minio_tpu_torch.obs.histogram import histogram as _histogram
from minio_tpu_torch.obs.span import has_subscribers as _has_subscribers
from minio_tpu_torch.obs.span import publish as _publish

_KERNEL_SECONDS = _histogram(
    "minio_tpu_kernel_seconds",
    "Kernel launch wall time by kernel and backend (host-observed; "
    "MTPU_KERNEL_SYNC=1 for the launch's kernels' device time)",
    ("kernel", "backend"))
_KERNEL_LAUNCHES = _counter(
    "minio_tpu_kernel_launches_total",
    "Kernel launches by kernel and backend", ("kernel", "backend"))
_KERNEL_BLOCKS = _gauge(
    "minio_tpu_kernel_batch_blocks",
    "Batch rows staged into the most recent kernel launch",
    ("kernel", "backend"))
_KERNEL_BYTES = _gauge(
    "minio_tpu_kernel_batch_bytes",
    "Bytes staged into the most recent kernel launch",
    ("kernel", "backend"))

_DP_QUEUE_WAIT = _histogram(
    "minio_tpu_dataplane_queue_wait_seconds",
    "Submit-to-launch wait of one coalesced codec request", ("op",))
_DP_FILL = _histogram(
    "minio_tpu_dataplane_batch_fill",
    "Filled fraction of each coalesced lane launch (occupancy)", ("op",))
_DP_LAUNCHES = _counter(
    "minio_tpu_dataplane_launches_total",
    "Coalesced lane launches by op", ("op",))
_DP_REQUESTS = _counter(
    "minio_tpu_dataplane_requests_total",
    "Codec requests carried by coalesced launches", ("op",))
_DP_REJECTED = _counter(
    "minio_tpu_dataplane_backpressure_total",
    "Requests rejected at the bounded submission queue (503 SlowDown)",
    ("op",))

_SYNC = os.environ.get("MTPU_KERNEL_SYNC", "") in ("1", "true", "on")


def set_sync(on: bool) -> None:
    """Wait for each launch's work before stamping (profiling sessions)."""
    global _SYNC
    _SYNC = bool(on)


def backend(device) -> str:
    """The `backend` label of a launch on `device`: JAX's platform name
    for it ("gpu" for a CUDA device, else the device type)."""
    kind = getattr(device, "type", str(device))
    return "gpu" if kind == "cuda" else kind


class _Launch:
    """A record opened by start under MTPU_KERNEL_SYNC on a CUDA device:
    the host clock, and the (begin, end) events of each hand-written
    kernel launched on the thread while it is open."""

    __slots__ = ("t0", "spans")

    def __init__(self, t0: float):
        self.t0 = t0
        self.spans: list[tuple] = []


_open = threading.local()   # .launch: the thread's open _Launch, or None


def start(device):
    """The start of a launch on `device`, for stop and observe: the host
    clock; under MTPU_KERNEL_SYNC on a CUDA device, a record that the
    thread's hand-written kernel launches time themselves into."""
    t0 = time.perf_counter()
    if not _SYNC or getattr(device, "type", None) != "cuda":
        return t0
    launch = _Launch(t0)
    _open.launch = launch
    return launch


def stop(launch):
    """Close the thread's record (kernels launched after it are not
    timed into it); returns `launch` for observe."""
    if isinstance(launch, _Launch) and getattr(_open, "launch", None) is launch:
        _open.launch = None
    return launch


# GPU clock cycles (~0.5 ms on an H100) a sync record holds the stream
# before a kernel's begin event: the host then launches the kernel while the
# card is still busy, so the events time the kernel and not the card's
# wait for the host (the interpreter lock can keep it tens of us or more).
HOLD_CYCLES = 1_000_000


def _hold(stream) -> None:
    import torch

    with torch.cuda.stream(stream):
        torch.cuda._sleep(HOLD_CYCLES)


def device_begin(stream):
    """Called by a hand-written kernel's wrapper right before its launch
    on `stream`: a timing event recorded there, after a hold, while a
    record is open on this thread, else None (the default path: one
    attribute read)."""
    if getattr(_open, "launch", None) is None:
        return None
    import torch

    _hold(stream)
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(stream)
    return ev


def device_end(begin, stream) -> None:
    """Called right after the launch that `begin` (device_begin's answer)
    preceded: its end event, kept in the thread's open record."""
    if begin is None:
        return
    import torch

    end = torch.cuda.Event(enable_timing=True)
    end.record(stream)
    _open.launch.spans.append((begin, end))


def dataplane_launch(op: str, filled: int, capacity: int,
                     waits: list[float]) -> None:
    """Record one coalesced launch: occupancy + per-request queue wait
    (submit to launch). Called by the dispatcher thread only."""
    _DP_LAUNCHES.labels(op=op).inc()
    _DP_REQUESTS.labels(op=op).inc(len(waits))
    if capacity:
        _DP_FILL.labels(op=op).observe(filled / capacity)
    wait_hist = _DP_QUEUE_WAIT.labels(op=op)
    for w in waits:
        wait_hist.observe(w)


def dataplane_rejected(op: str) -> None:
    """One submission bounced off the bounded queue (backpressure)."""
    _DP_REJECTED.labels(op=op).inc()


def observe(kernel: str, backend: str, t0, *,
            blocks: int = 0, nbytes: int = 0) -> None:
    """Record one launch: t0 from start() (or time.perf_counter()) taken
    right before it. A record that start opened under MTPU_KERNEL_SYNC is
    closed here if the caller did not stop it, waited for, and recorded
    as its kernels' device time. Exceptions from a failed sync
    propagate."""
    if isinstance(t0, _Launch):
        stop(t0)
        for _begin, end in t0.spans:
            end.synchronize()
        dt = sum(b.elapsed_time(e) for b, e in t0.spans) / 1e3
    else:
        dt = time.perf_counter() - t0
    _KERNEL_SECONDS.labels(kernel=kernel, backend=backend).observe(dt)
    _KERNEL_LAUNCHES.labels(kernel=kernel, backend=backend).inc()
    if blocks:
        _KERNEL_BLOCKS.set(blocks, kernel=kernel, backend=backend)
    if nbytes:
        _KERNEL_BYTES.set(nbytes, kernel=kernel, backend=backend)
    if _has_subscribers():
        rec = {"type": "kernel", "time": time.time(),
               "kernel": kernel, "backend": backend,
               "durationNs": int(dt * 1e9)}
        if blocks:
            rec["blocks"] = blocks
        if nbytes:
            rec["bytes"] = nbytes
        _publish(rec)
