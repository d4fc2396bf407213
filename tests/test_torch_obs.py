"""The port's observability package (minio_tpu_torch/obs) against the JAX
package's (minio_tpu/obs), on the CPU.

Tolerance: exact. The same seeded values fed to a family of each package
render byte-equal; span, kernel, storage and batch records carry the
same keys; flight timelines under a pinned clock are equal. The
registries are process-global in both packages, so every test makes its
own families or compares deltas."""

import importlib
import time
import types
import uuid

import numpy as np
import pytest
import torch

from minio_tpu import obs as jobs
from minio_tpu.admin import metrics as jmetrics
from minio_tpu.obs import flight as jflight
from minio_tpu.obs import kernel as jkernel
from minio_tpu_torch import obs as tobs
from minio_tpu_torch.admin import metrics as tmetrics
from minio_tpu_torch.obs import flight as tflight
from minio_tpu_torch.obs import kernel as tkernel

PKGS = ((jobs, jmetrics), (tobs, tmetrics))
# obs.span is the span() function in both packages: the modules by name.
jspan = importlib.import_module("minio_tpu.obs.span")
tspan = importlib.import_module("minio_tpu_torch.obs.span")


def _values(seed, n=200):
    rng = np.random.default_rng(seed)
    return [float(v) for v in 10 ** rng.uniform(-5, 1.5, n)]


def _render(vec, metrics_mod, openmetrics=False):
    p = metrics_mod.PromText(openmetrics)
    vec.render_into(p)
    return p.render()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_renders_byte_equal(seed):
    name = f"mtpu_test_hist_{uuid.uuid4().hex[:8]}"
    outs = []
    for o, m in PKGS:
        h = o.histogram(name, "a test histogram", ("api", "drive"))
        for i, v in enumerate(_values(seed)):
            h.labels(api=("GetObject", "PutObject")[i % 2], drive=f"/d{i % 3}").observe(v)
        outs.append(_render(h, m))
    assert outs[0] == outs[1]
    assert b'le="0.00025"' in outs[1] and b'le="+Inf"' in outs[1]


def test_latency_buckets_are_the_jax_packages():
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS


@pytest.mark.parametrize("seed", [3, 4])
def test_counter_and_gauge_render_byte_equal(seed):
    rng = np.random.default_rng(seed)
    incs = rng.integers(1, 1000, 50).tolist()
    sets = rng.uniform(-100, 100, 50).tolist()
    c_name, g_name = (f"mtpu_test_{k}_{uuid.uuid4().hex[:8]}" for k in ("c", "g"))
    outs = []
    for o, m in PKGS:
        c = o.counter(c_name, "a test counter", ("kernel", "backend"))
        g = o.gauge(g_name, "a test gauge", ("le",))
        for i, n in enumerate(incs):
            c.labels(kernel=f"k{i % 4}", backend="gpu").inc(n)
        for i, v in enumerate(sets):
            g.labels(le=str(i % 5)).set(v)
        outs.append(_render(c, m) + _render(g, m))
    assert outs[0] == outs[1]


def test_openmetrics_exemplar_render_equal(monkeypatch):
    """An exemplar captured under a trace context renders the same
    annotation in both packages (the capture time pinned)."""
    name = f"mtpu_test_ex_{uuid.uuid4().hex[:8]}"
    outs = []
    sample_all = {"minio_tpu.obs.histogram": {"_EX_ARMED": True, "_EX_EVERY": 1},
                  "minio_tpu_torch.obs.histogram": {"EXEMPLAR_EVERY": 1}}
    for (o, m), hist_mod, span_mod in ((PKGS[0], "minio_tpu.obs.histogram", jspan),
                                       (PKGS[1], "minio_tpu_torch.obs.histogram", tspan)):
        mod = importlib.import_module(hist_mod)
        for attr, value in sample_all[hist_mod].items():
            monkeypatch.setattr(mod, attr, value)
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            time=lambda: 1700000000.125))
        h = o.histogram(name, "exemplars", ("api",))
        tok = span_mod.set_trace_context("TRACE1")
        try:
            h.labels(api="GetObject").observe(0.003)
        finally:
            span_mod.reset_trace_context(tok)
        outs.append(_render(h, m, openmetrics=True))
    assert outs[0] == outs[1]
    assert b'# {trace_id="TRACE1"} 0.003 1700000000.125' in outs[1]


def _records(o, fn):
    with o.trace_bus().subscribe() as sub:
        fn()
        out = []
        while (r := sub.get(timeout=0.05)) is not None:
            out.append(r)
    return out


def test_span_records_have_equal_keys():
    def run(o):
        tok = o.set_trace_context("REQ1")
        try:
            with o.span("encode", bucket="b", object="k") as sp:
                with o.span("commit", bucket="b", object="k"):
                    pass
                sp.set(bytes=5)
        finally:
            o.reset_trace_context(tok)

    jr, tr = (_records(o, lambda o=o: run(o)) for o, _m in PKGS)
    assert [sorted(r) for r in jr] == [sorted(r) for r in tr]
    assert [(r["name"], r.get("parent"), r["trace_id"]) for r in tr] == \
        [("commit", "encode", "REQ1"), ("encode", None, "REQ1")]


def test_kernel_storage_and_drive_records_have_equal_keys(tmp_path):
    def run(o, k):
        t0 = time.perf_counter()
        k.observe("encode_digests", "gpu", t0, blocks=4, nbytes=4096)
        obs_fn = o.drive_op_observer(str(tmp_path / "drive"))
        obs_fn("read_version", time.perf_counter(), "b", "k")
        obs_fn("create_file", time.perf_counter(), "b", "k", OSError("x"))

    jr = _records(jobs, lambda: run(jobs, jkernel))
    tr = _records(tobs, lambda: run(tobs, tkernel))
    assert [r["type"] for r in tr] == ["kernel", "storage", "storage"]
    assert [sorted(r) for r in jr] == [sorted(r) for r in tr]


def test_no_subscriber_allocates_no_span():
    before = tspan.Span.allocated
    with tobs.span("encode", bucket="b"):
        pass
    assert tspan.Span.allocated == before
    assert tobs.span("x") is tspan._NOOP


class _Clock:
    def __init__(self):
        self.t = 100.0

    def perf_counter(self):
        self.t += 0.00125
        return self.t

    def time(self):
        return 1700000000.0


def test_flight_timelines_equal_under_a_fixed_clock(monkeypatch):
    snaps = []
    for fl, sp in ((jflight, jspan), (tflight, tspan)):
        monkeypatch.setattr(fl, "time", _Clock())
        monkeypatch.setattr(fl, "_ARMED", True)
        # The front-door worker id, which other tests may have set.
        monkeypatch.setattr(fl, "_worker", -1)
        # The node is the context's: other tests in this process may have
        # changed either package's default.
        tok = sp.set_trace_context(node="node-1")
        try:
            tl = fl.begin("TL1", "PutObject")
            assert tl is not None
            fl.mark("auth")
            fl.mark("rx_drain")
            fl.stamp("dp_queue_wait", 0.0005, "dataplane")
            fl.mark("encode", "dataplane")
            fl.mark("commit", "metaplane")
            fl.end(status=200)
        finally:
            sp.reset_trace_context(tok)
        snaps.append(fl.snapshot(traceid="TL1")[0])
    # No tenant was bound: both snapshots carry the empty one.
    assert snaps[0]["tenant"] == ""
    assert snaps[0] == snaps[1]
    assert [s["stage"] for s in snaps[1]["stages"]] == [
        "auth", "rx_drain", "dp_queue_wait", "encode", "commit", "resp_drain"]


def test_flight_disarmed_allocates_nothing(monkeypatch):
    monkeypatch.setattr(tflight, "_ARMED", False)
    before = tflight.Timeline.allocated
    assert tflight.begin("X") is None
    tflight.mark("auth")
    assert tflight.Timeline.allocated == before


def _launches(label, backend="cpu"):
    return tkernel._KERNEL_LAUNCHES.labels(kernel=label, backend=backend).value


@pytest.mark.parametrize("sync", [False, True])
def test_fused_entry_points_observe_on_the_cpu(monkeypatch, sync):
    """MTPU_KERNEL_SYNC on the CPU still records each launch."""
    from minio_tpu_torch.ops import fused

    monkeypatch.setattr(tkernel, "_SYNC", sync)
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, (2, 4, 512), dtype=np.uint8))
    lens = torch.full((2,), 512, dtype=torch.int32)
    before = {k: _launches(k) for k in ("encode_digests", "verify_digests")}
    fused.encode_with_digests(data, 4, 2, lens)
    fused.verify_digests(data.reshape(8, 512), lens.repeat(4))
    assert _launches("encode_digests") == before["encode_digests"] + 1
    assert _launches("verify_digests") == before["verify_digests"] + 1
    g = tkernel._KERNEL_BLOCKS.labels(kernel="encode_digests", backend="cpu")
    assert g.value == 2


class _FakeEvent:
    """A CUDA timing event without a card: the streams it was recorded
    on, and an elapsed time in milliseconds."""

    def __init__(self, enable_timing=False, fail=False):
        assert enable_timing
        self.recorded, self.fail = [], fail

    def record(self, stream):
        self.recorded.append(stream)

    def synchronize(self):
        if self.fail:
            raise RuntimeError("CUDA error: an illegal memory access was encountered")

    def elapsed_time(self, other):
        return 2.5


def _fake_cuda(monkeypatch, fail=False):
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda enable_timing=False: _FakeEvent(enable_timing, fail))
    held = []
    monkeypatch.setattr(tkernel, "_hold", held.append)
    return held


def _kernel_launch(stream="s"):
    """What a hand-written kernel's wrapper does around its launch."""
    begin = tkernel.device_begin(stream)
    tkernel.device_end(begin, stream)
    return begin


def test_failed_sync_raises_and_records_nothing(monkeypatch):
    monkeypatch.setattr(tkernel, "_SYNC", True)
    _fake_cuda(monkeypatch, fail=True)
    before = _launches("encode", "gpu")
    launch = tkernel.start(torch.device("cuda"))
    _kernel_launch()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tkernel.observe("encode", "gpu", launch)
    assert _launches("encode", "gpu") == before


def test_sync_records_the_device_time_of_the_kernels_launched(monkeypatch):
    """Under MTPU_KERNEL_SYNC the record is the sum of the device times
    of the hand-written kernels launched on the thread between start and
    stop, each between events on its own stream, not the host's wait;
    kernels launched after stop or on another thread are not in it."""
    import threading

    monkeypatch.setattr(tkernel, "_SYNC", True)
    held = _fake_cuda(monkeypatch)
    h = tkernel._KERNEL_SECONDS.labels(kernel="dp_verify", backend="gpu")
    counts, total = h.snapshot()
    launch = tkernel.start(torch.device("cuda"))
    first = _kernel_launch("plane")
    other = []
    t = threading.Thread(target=lambda: other.append(_kernel_launch()))
    t.start()
    t.join()
    _kernel_launch("plane")
    time.sleep(0.01)
    tkernel.stop(launch)
    assert _kernel_launch() is None and other == [None]
    tkernel.observe("dp_verify", "gpu", launch)
    assert first.recorded == ["plane"] and len(launch.spans) == 2
    # Each begin event follows a hold of its stream.
    assert held == ["plane", "plane"]
    assert h.snapshot()[1] - total == pytest.approx(0.005, abs=1e-12)
    assert sum(h.snapshot()[0]) == sum(counts) + 1


def test_default_path_never_waits(monkeypatch):
    def forbidden(*_a, **_kw):
        raise AssertionError("a CUDA event without MTPU_KERNEL_SYNC")

    monkeypatch.setattr(tkernel, "_SYNC", False)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(tkernel, "_hold", forbidden)
    launch = tkernel.start(torch.device("cuda"))
    assert isinstance(launch, float)
    assert _kernel_launch() is None
    tkernel.observe("encode", "gpu", tkernel.stop(launch))


def test_dataplane_families_match(tmp_path):
    """The plane's families and the dp_<op> launch label, fed by the
    port's BatchPlane on the CPU, render with the JAX family names."""
    from minio_tpu_torch.dataplane.batcher import BatchPlane

    plane = BatchPlane(device="cpu", max_wait_s=0.0005)
    try:
        before = tkernel._DP_LAUNCHES.labels(op="verify").value
        rng = np.random.default_rng(1)
        chunks = [rng.bytes(int(n)) for n in rng.integers(1, 4000, 5)]
        got = plane.digest_chunks(chunks, 4096)
    finally:
        plane.close()
    from minio_tpu_torch.ops import fused

    assert got == fused.digest_chunks_host(chunks, 4096, device="cpu")
    assert tkernel._DP_LAUNCHES.labels(op="verify").value > before
    names = lambda o: {v.name for v in o.registry() if "dataplane" in v.name}  # noqa: E731
    assert names(jobs) == names(tobs)


def test_record_types_are_the_jax_set():
    assert tspan.RECORD_TYPES == jspan.RECORD_TYPES
