"""Profiling plane: host cProfile + the card's profiler (counterpart of
minio_tpu/admin/profiling.py).

Role-equivalent of cmd/utils.go:276 startProfiler and
DownloadProfilingData (cmd/notification.go:301): an admin starts
profiling, lets the workload run, then downloads one archive holding the
node's profiles.

Kinds:
- `cpu`: cProfile over the process, as in the JAX package (cpu.txt,
  cpu.pstats);
- `device`: torch.profiler with CPU and CUDA activities; its chrome trace
  (the CUDA kernels' device times among the host events) is zipped as
  device_trace.zip. Without a CUDA device it raises at start: it writes
  no marker file and never profiles nothing quietly. Where the trace
  holds fewer events of one of the port's kernels than it launched
  during the capture (ops/kernels.py counts; the profiler lost the
  card's events), collecting raises IncompleteDeviceTrace instead of
  handing back a trace that leaves them out. It costs time while on, so
  it runs only between start and download.

The JAX package's `tpu` kind has no meaning on this card; the admin route
answers it InvalidArgument, naming `device`.
"""

from __future__ import annotations

import cProfile
import io
import json
import os
import pstats
import shutil
import tempfile
import threading
import zipfile

KINDS = ("cpu", "device")


class IncompleteDeviceTrace(RuntimeError):
    """The device capture lacks kernels that ran while it was on."""


def _missed(before: dict[str, int], after: dict[str, int],
            events: list[dict]) -> list[str]:
    """Each of the port's kernels whose launches between two counts of
    ops/kernels.py (a count reset in between restarts from 0) outnumber
    its events in a chrome trace, as "name: captured of launched"."""
    from minio_tpu_torch.ops import kernels

    names = [ev.get("name", "") for ev in events if ev.get("cat") == "kernel"]
    out = []
    for k, n in after.items():
        launched = n - before.get(k, 0) if n >= before.get(k, 0) else n
        if not launched:
            continue
        captured = min(sum(dn in name for name in names)
                       for dn in kernels.DEVICE_NAMES[k])
        if captured < launched:
            out.append(f"{k}: {captured} of {launched}")
    return out


class Profiler:
    """One node's profiling session (at most one active at a time)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cpu: cProfile.Profile | None = None
        self._device = None            # a started torch.profiler.profile
        self._launches0: dict[str, int] = {}

    @property
    def running(self) -> bool:
        return self._cpu is not None or self._device is not None

    def start(self, kinds: tuple[str, ...] = ("cpu",)) -> None:
        unknown = [k for k in kinds if k not in KINDS]
        if unknown:
            raise ValueError(f"profiler type {unknown[0]!r} is not served; "
                             f"types: {', '.join(KINDS)}")
        with self._mu:
            if self.running:
                raise RuntimeError("profiler already running")
            if "device" in kinds:
                import torch
                from torch.profiler import ProfilerActivity, profile

                if not torch.cuda.is_available():
                    raise RuntimeError("device profiling needs a CUDA device; "
                                       "none is available")
                from minio_tpu_torch.ops import kernels

                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.start()
                # Counted after the start: a counted launch was made
                # before its count moved.
                self._launches0 = kernels.launches()
                self._device = prof
            if "cpu" in kinds:
                self._cpu = cProfile.Profile()
                self._cpu.enable()

    def stop_collect(self) -> dict[str, bytes]:
        """Stop everything and return {filename: payload}."""
        out: dict[str, bytes] = {}
        with self._mu:
            if self._cpu is not None:
                self._cpu.disable()
                stats = pstats.Stats(self._cpu)
                txt = io.StringIO()
                stats.stream = txt
                stats.sort_stats("cumulative").print_stats(100)
                out["cpu.txt"] = txt.getvalue().encode()
                with tempfile.NamedTemporaryFile(suffix=".pstats",
                                                 delete=False) as f:
                    tmp = f.name
                stats.dump_stats(tmp)
                with open(tmp, "rb") as f:
                    out["cpu.pstats"] = f.read()
                os.unlink(tmp)
                self._cpu = None
            if self._device is not None:
                import torch

                from minio_tpu_torch.ops import kernels

                prof, self._device = self._device, None
                launches = kernels.launches()
                # Work still queued on the card would end after the
                # capture does: wait for it, so its kernels are in the trace.
                torch.cuda.synchronize()
                prof.stop()
                d = tempfile.mkdtemp(prefix="mtpu-torchprof-")
                try:
                    path = os.path.join(d, "trace.json")
                    prof.export_chrome_trace(path)
                    with open(path, "rb") as f:
                        events = json.load(f).get("traceEvents", [])
                    missed = _missed(self._launches0, launches, events)
                    if missed:
                        raise IncompleteDeviceTrace(
                            f"the device capture holds fewer kernel events than "
                            f"launches ({', '.join(missed)}): the profiler lost "
                            "the card's events")
                    buf = io.BytesIO()
                    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                        z.write(path, "trace.json")
                    out["device_trace.zip"] = buf.getvalue()
                finally:
                    shutil.rmtree(d, ignore_errors=True)
        return out


def zip_profiles(per_node: dict[str, dict[str, bytes]]) -> bytes:
    """Bundle every node's profile files into one archive
    (DownloadProfilingData's zip, cmd/notification.go:301)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for node, files in per_node.items():
            for name, payload in files.items():
                z.writestr(f"{node}/{name}", payload)
    return buf.getvalue()
