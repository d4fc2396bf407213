"""The port's QoS plane (minio_tpu_torch/qos/) held against the JAX
package's (minio_tpu/qos/).

- scheduler: the same operation scripts (puts with their outcome, gets
  with the item served, clock ticks, token takes and refunds, ring-gate
  acquires and releases) through both packages' FairQueue, TokenBucket
  and RingGate under one pinned clock: the transcripts must be equal.
  The scenarios are those of tests/test_qos.py, one parametrised case
  each;
- identity and knobs: tenant binding, the 12-byte slot tag, metric-label
  folding, weight parsing, plane_queue armed and disarmed;
- wiring: a dataplane and a metaplane tenant quota shed under the
  tenant's label, WAL batch records list their tenants, the in-flight
  view and the flight recorder's tenant filter, each package against the
  other. No test reads the wall clock: every scheduler clock is pinned.
"""

from __future__ import annotations

import queue

import pytest

from minio_tpu import qos as jqos
from minio_tpu.qos import scheduler as jsched
from minio_tpu_torch import qos as tqos
from minio_tpu_torch.qos import scheduler as tsched

PKGS = {"jax": (jqos, jsched), "torch": (tqos, tsched)}


class _Clock:
    """A monotonic clock that moves only when a script ticks it."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for _q, sched in PKGS.values():
        monkeypatch.setattr(sched, "time", c)
    return c


# ---------------------------------------------------------------------------
# Scheduler scripts
# ---------------------------------------------------------------------------

def _fair_run(sched, clock, kwargs, script):
    q = sched.FairQueue(**kwargs)
    out = []
    for op in script:
        if op[0] == "put":
            try:
                q.put_nowait(op[1])
                out.append("ok")
            except sched.QuotaFull:
                out.append("quota")
            except queue.Full:
                out.append("full")
        elif op[0] == "get":
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                out.append("empty")
        elif op[0] == "tick":
            clock.t += op[1]
        elif op[0] == "backlog":
            out.append(q.backlog_by_tenant())
        elif op[0] == "size":
            out.append((q.qsize(), q.empty()))
    return out


def _tenant(it):
    return it[0]


def _cost(it):
    return it[1]


def _flush(it):
    return it[0] == "flush"


def _tomb(it):
    return it[1] == "TOMB"


def _puts(key, n, start=0):
    return [("put", (key, i)) for i in range(start, start + n)]


def _gets(n):
    return [("get",)] * n


FAIR_CASES = {
    "fifo_within_one_tenant": (
        dict(cap=16, tenant_of=_tenant),
        _puts("a", 5) + _gets(6) + [("size",)]),
    "drr_serves_by_weight": (
        dict(cap=64, weights={"a": 2.0, "b": 1.0}, quantum=2, tenant_of=_tenant),
        [op for i in range(16) for op in (("put", ("a", i)), ("put", ("b", i)))]
        + _gets(32)),
    "single_tenant_work_conserving": (
        dict(cap=8, tenant_of=_tenant), _puts("a", 9)),
    "newcomer_admitted_past_saturated_tenant": (
        dict(cap=8, tenant_of=_tenant),
        _puts("a", 8) + [("put", ("b", 0)), ("put", ("a", 99)), ("backlog",)]),
    "share_tracks_weights": (
        dict(cap=12, weights={"a": 2.0, "b": 1.0}, tenant_of=_tenant),
        [("put", ("a", 0)), ("put", ("b", 0))] + _puts("a", 8, 1)
        + _puts("b", 4, 1) + [("backlog",)]),
    "starvation_bound": (
        dict(cap=64, weights={"heavy": 8.0, "light": 1.0}, quantum=1,
             tenant_of=_tenant),
        _puts("heavy", 40) + [("put", ("light", 0))] + _gets(12)),
    "ops_quota_and_refill": (
        dict(cap=16, tenant_of=_tenant, rate_ops=1000.0, burst_s=1 / 1000.0),
        [("put", ("a", 0)), ("put", ("a", 1)), ("put", ("b", 0)),
         ("tick", 0.0005), ("put", ("a", 2)), ("tick", 0.0005),
         ("put", ("a", 3)), ("put", ("a", 4))] + _gets(4)),
    "bytes_quota": (
        dict(cap=16, tenant_of=_tenant, cost_of=_cost, rate_bytes=1000.0,
             burst_s=1.0),
        [("put", ("a", 800)), ("put", ("a", 800)), ("put", ("b", 800)),
         ("tick", 0.5), ("put", ("a", 600)), ("put", ("a", 200))]),
    "control_never_quota_checked": (
        dict(cap=2, tenant_of=_tenant, is_control=_flush, rate_ops=0.001,
             burst_s=2_000.0),
        [("put", ("a", 0)), ("put", ("a", 1)), ("put", ("flush", "CTL")),
         ("get",), ("put", ("a", 2))] + _gets(3)),
    "control_barrier_orders_after_predecessors": (
        dict(cap=32, weights={"a": 4.0, "b": 1.0}, tenant_of=_tenant,
             is_control=_flush),
        [op for i in range(4) for op in (("put", ("a", i)), ("put", ("b", i)))]
        + [("put", ("flush", "CTL")), ("put", ("a", 99))] + _gets(11)),
    "barrier_is_full_ordering_fence": (
        dict(cap=64, weights={"a": 8.0, "b": 1.0}, tenant_of=_tenant,
             is_barrier=_tomb),
        _puts("b", 8) + [("put", ("a", "TOMB"))] + _puts("a", 4) + _gets(13)),
    "capacity_reject_does_not_burn_quota": (
        dict(cap=2, tenant_of=_tenant, rate_ops=0.001, burst_s=3_000.0),
        [("put", ("a", 0)), ("put", ("a", 1))] + [("put", ("a", 2))] * 5
        + [("get",), ("put", ("a", 2)), ("get",), ("put", ("a", 3))]),
    "byte_quota_reject_refunds_op_token": (
        dict(cap=16, tenant_of=_tenant, cost_of=_cost, rate_ops=0.001,
             burst_s=2_000.0, rate_bytes=0.001),
        [("put", ("a", 500))] * 3 + [("put", ("a", 1))] * 3),
    "unattributed_items_ride_system_lane": (
        dict(cap=8), [("put", ("x",)), ("backlog",), ("get",)]),
    "weight_prefix_and_wildcard": (
        dict(cap=24, weights={"ak": 3.0, "*": 0.5}, quantum=1, tenant_of=_tenant),
        _puts("ak/b1", 10) + _puts("zz/b2", 10) + _gets(20)),
    "many_tenants_round_robin": (
        dict(cap=40, quantum=1, tenant_of=_tenant),
        [("put", (f"t{i % 5}", i)) for i in range(30)] + _gets(30)),
}


@pytest.mark.parametrize("case", sorted(FAIR_CASES))
def test_fairqueue_script_matches_jax(case, clock):
    kwargs, script = FAIR_CASES[case]
    got = {}
    for name, (_q, sched) in PKGS.items():
        clock.t = 1000.0
        got[name] = _fair_run(sched, clock, kwargs, script)
    assert got["torch"] == got["jax"]
    # The scripts exercise what they are named for: a refusal or a
    # served item in every case.
    assert any(r in ("full", "quota") for r in got["torch"]) or any(
        isinstance(r, tuple) for r in got["torch"])


BUCKET_CASES = {
    "rate_zero_is_unlimited": ((0, 0), [("take", 1.0)] * 50),
    "burst_then_refill": ((1000.0, 2.0), [("take", 1.0)] * 3
                          + [("tick", 0.001), ("take", 1.0), ("take", 1.0)]),
    "untake_refunds_to_burst": ((10.0, 3.0), [("take", 2.0), ("untake", 5.0),
                                              ("take", 3.0), ("take", 0.5),
                                              ("tick", 0.05), ("take", 0.5)]),
    "fractional_takes": ((4.0, 1.0), [("take", 0.25)] * 5
                         + [("tick", 0.125), ("take", 0.5), ("take", 0.1)]),
}


@pytest.mark.parametrize("case", sorted(BUCKET_CASES))
def test_token_bucket_script_matches_jax(case, clock):
    (rate, burst), script = BUCKET_CASES[case]
    got = {}
    for name, (_q, sched) in PKGS.items():
        clock.t = 1000.0
        b = sched.TokenBucket(rate, burst)
        out = []
        for op, arg in script:
            if op == "take":
                out.append(b.take(arg))
            elif op == "untake":
                b.untake(arg)
            else:
                clock.t += arg
            out.append(round(b._level, 9))
        got[name] = out
    assert got["torch"] == got["jax"]


GATE_CASES = {
    "share_cap_and_release": (
        dict(slots=4),
        [("acquire", "a")] * 5 + [("release", "a")] + [("acquire", "a")]
        + [("release", "a")] * 4 + [("acquire", "a")] * 2
        + [("acquire", "b")] * 2 + [("acquire", "a")]),
    "rate_bucket": (
        dict(slots=64, rate_ops=1000.0, burst_s=2 / 1000.0),
        [("acquire", "a")] * 3 + [("release", "a")] * 2
        + [("tick", 0.001), ("acquire", "a"), ("acquire", "a")]),
    "weighted_shares": (
        dict(slots=8, weights={"a": 3.0, "b": 1.0}),
        [("acquire", "b")] + [("acquire", "a")] * 8 + [("acquire", "b")] * 3),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_ringgate_script_matches_jax(case, clock):
    kwargs, script = GATE_CASES[case]
    got = {}
    for name, (_q, sched) in PKGS.items():
        clock.t = 1000.0
        g = sched.RingGate(**kwargs)
        out = []
        for op, arg in script:
            if op == "acquire":
                out.append(g.acquire(arg))
            elif op == "release":
                g.release(arg)
            else:
                clock.t += arg
        got[name] = out
    assert got["torch"] == got["jax"]


def test_quotafull_is_queue_full():
    assert issubclass(tsched.QuotaFull, queue.Full)
    assert tqos.QuotaFull is tsched.QuotaFull


# ---------------------------------------------------------------------------
# Identity and knobs
# ---------------------------------------------------------------------------

def _identity_view(q):
    out = []
    for ak, bkt in (("alice", "photos"), ("alice", ""), ("ak", "b"),
                    ("averylongaccesskey", "bucket"), ("", "x")):
        tok = q.bind(ak, bkt)
        try:
            tag = q.tenant_tag()
            out.append((q.current_key(), tag, len(tag) <= q.TAG_LEN,
                        q.key_from_tag(tag), q.key_from_tag(tag + b"\x00" * 4)))
        finally:
            q.reset(tok)
    out.append((q.current_key(), q.tenant_tag(), q.key_from_tag(b"")))
    for key in ("ak/bkt", "solo", q.UNATTRIBUTED, ""):
        tok = q.bind_key(key)
        try:
            t = q.current()
            out.append(None if t is None else (t.access_key, t.bucket, t.key))
        finally:
            q.reset(tok)
    return out


def test_tenant_identity_and_tags_match_jax():
    assert _identity_view(tqos) == _identity_view(jqos)
    assert (tqos.UNATTRIBUTED, tqos.METRIC_OVERFLOW, tqos.TAG_LEN) == \
        (jqos.UNATTRIBUTED, jqos.METRIC_OVERFLOW, jqos.TAG_LEN)


def test_tenant_crosses_ctx_wrap_hops():
    import threading

    from minio_tpu_torch import obs

    seen = []
    tok = tqos.bind("hop", "bkt")
    try:
        fn = obs.ctx_wrap(lambda: seen.append(tqos.current_key()))
    finally:
        tqos.reset(tok)
    t = threading.Thread(target=fn)
    t.start()
    t.join()
    assert seen == ["hop/bkt"] and tqos.current_key() == tqos.UNATTRIBUTED


def test_metric_key_folding_matches_jax(monkeypatch):
    got = {}
    for name, (q, _s) in PKGS.items():
        monkeypatch.setattr(q, "_metric_tenants", set())
        monkeypatch.setattr(q, "_METRIC_TENANTS_CAP", 3)
        out = [q.metric_key(f"scan/b{i}") for i in range(5)]
        out += [q.metric_key("scan/b1"), q.metric_key(q.UNATTRIBUTED)]
        tok = q.bind("late", "bkt")
        try:
            out.append(q.metric_key())
        finally:
            q.reset(tok)
        got[name] = out
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == tqos.METRIC_OVERFLOW


@pytest.mark.parametrize("spec", ["a=2,b/photos=0.5,junk,c=notanum,=3,d=-1,*=1.5",
                                  "", " ak = 3 , x=y=2,,", "k=1e3,k=2"])
def test_parse_weights_matches_jax(spec):
    assert tqos.parse_weights(spec) == jqos.parse_weights(spec)


def test_plane_queue_disarmed_and_armed_match_jax(monkeypatch):
    monkeypatch.delenv("MTPU_QOS", raising=False)
    for q, _s in PKGS.values():
        pq = q.plane_queue("dataplane", 7)
        assert type(pq) is queue.Queue and pq.maxsize == 7
        assert q.ring_gate(8) is None and not q.armed()
    for k, v in {"MTPU_QOS": "1", "MTPU_QOS_WEIGHTS": "ak=2,*=0.5",
                 "MTPU_QOS_QUANTUM": "9", "MTPU_QOS_MIN_SHARE": "2",
                 "MTPU_QOS_RATE_OPS": "50", "MTPU_QOS_RATE_BYTES": "bad",
                 "MTPU_QOS_BURST_S": "3", "MTPU_QOS_HOTGET_OPS": "7"}.items():
        monkeypatch.setenv(k, v)
    views = {}
    for name, (q, sched) in PKGS.items():
        pq = q.plane_queue("metaplane", 7)
        gate = q.ring_gate(8)
        assert isinstance(pq, sched.FairQueue) and isinstance(gate, sched.RingGate)
        views[name] = (pq.cap, pq.quantum, pq.min_share, pq._weights,
                       pq._rate_ops, pq._rate_bytes, pq._burst_s,
                       pq._unattributed, gate.slots, gate._rate, gate._burst_s,
                       gate._weights)
    assert views["torch"] == views["jax"]


# ---------------------------------------------------------------------------
# Wiring
# ---------------------------------------------------------------------------

def _shed_value(admission, plane, cause, tenant):
    return admission._SHED.labels(plane=plane, cause=cause, tenant=tenant).value


@pytest.fixture
def armed_quota(monkeypatch, clock):
    """Armed, a 1-op burst per tenant and a pinned clock: the second
    submission of a tenant finds its bucket empty."""
    monkeypatch.setenv("MTPU_QOS", "1")
    monkeypatch.setenv("MTPU_QOS_RATE_OPS", "1000")
    monkeypatch.setenv("MTPU_QOS_BURST_S", "0.001")
    return clock


def _plane_quota_view(pkg):
    import os

    if pkg == "jax":
        from minio_tpu.dataplane.batcher import BatchPlane
        from minio_tpu.utils import admission, errors as se
        plane = BatchPlane(queue_cap=8, max_wait_s=0.01)
    else:
        from minio_tpu_torch.dataplane.batcher import BatchPlane
        from minio_tpu_torch.utils import admission, errors as se
        plane = BatchPlane(device="cpu", queue_cap=8, max_wait_s=0.01)
    q = PKGS[pkg][0]
    out = []
    tok = q.bind("stormy", "b")
    try:
        before = _shed_value(admission, "dataplane", "tenant_quota", "stormy/b")
        first = plane.begin_encode(4, 2, 1 << 12, [os.urandom(64)])
        try:
            plane.begin_encode(4, 2, 1 << 12, [os.urandom(64)])
            out.append("admitted")
        except se.OperationTimedOut as e:
            out.append((type(e).__name__, isinstance(e, se.AdmissionShed)))
        out.append(_shed_value(admission, "dataplane", "tenant_quota",
                               "stormy/b") - before)
        chunks, _digs = first.wait()
        out.append((len(chunks), len(chunks[0])))
    finally:
        q.reset(tok)
        # Another tenant's bucket is its own.
        tok = q.bind("calm", "b")
        try:
            plane.begin_encode(4, 2, 1 << 12, [os.urandom(64)]).wait()
            out.append("calm admitted")
        finally:
            q.reset(tok)
        plane.close()
    return out


def test_dataplane_tenant_quota_sheds_like_jax(armed_quota):
    jax_view = _plane_quota_view("jax")
    assert _plane_quota_view("torch") == jax_view
    assert jax_view[1] == 1


def _wal_view(pkg, root):
    if pkg == "jax":
        from minio_tpu import obs
        from minio_tpu.storage.local import LocalDrive
        from minio_tpu.utils import admission, errors as se
    else:
        from minio_tpu_torch import obs
        from minio_tpu_torch.storage.local import LocalDrive
        from minio_tpu_torch.utils import admission, errors as se
    q = PKGS[pkg][0]
    d = LocalDrive(str(root))
    out = []
    try:
        d.make_vol("bkt")
        tok = q.bind("stormy", "b")
        try:
            with obs.trace_bus().subscribe() as sub:
                before = _shed_value(admission, "metaplane", "tenant_quota",
                                     "stormy/b")
                fut = d.write_all_async(".mtpu.sys", "config/a.mp", b"x" * 64)
                try:
                    d.write_all_async(".mtpu.sys", "config/b.mp", b"x" * 64)
                    out.append("admitted")
                except se.OperationTimedOut as e:
                    out.append(isinstance(e, se.AdmissionShed))
                out.append(_shed_value(admission, "metaplane", "tenant_quota",
                                       "stormy/b") - before)
                fut.result(timeout=30)
                # The batch record is published before the futures resolve.
                tenants = set()
                while (rec := sub.get(timeout=0)) is not None:
                    if rec.get("type") == "batch" and rec.get("plane") == "metaplane":
                        tenants.update(rec["tenants"])
                out.append(sorted(tenants))
                # flush is control traffic: never quota-metered.
                d._wal.flush(timeout=30)
                out.append("flushed")
        finally:
            q.reset(tok)
    finally:
        d.close_wal()
    return out


def test_metaplane_quota_and_commit_tenants_like_jax(armed_quota, monkeypatch,
                                                     tmp_path):
    monkeypatch.setenv("MTPU_METAPLANE", "1")
    jax_view = _wal_view("jax", tmp_path / "j")
    assert _wal_view("torch", tmp_path / "t") == jax_view
    assert jax_view == [True, 1, ["stormy/b"], "flushed"]


def test_stats_inflight_tenant_matches_jax():
    from minio_tpu.admin.stats import HTTPStats as JStats
    from minio_tpu_torch.admin.stats import HTTPStats as TStats

    views = []
    for cls in (JStats, TStats):
        st = cls()
        st.begin("rid-1", "PUT", "127.0.0.1:1", tenant_get=lambda: "alice/photos")
        st.begin("rid-2", "GET", "127.0.0.1:2")
        st.begin("rid-3", "GET", "127.0.0.1:3", tenant_get=lambda: 1 / 0)
        views.append({r["trace_id"]: r["tenant"] for r in st.inflight()})
    assert views[1] == views[0] == {"rid-1": "alice/photos", "rid-2": "-",
                                    "rid-3": "-"}


def test_flight_tenant_filter_matches_jax(monkeypatch):
    from minio_tpu.obs import flight as jflight
    from minio_tpu_torch.obs import flight as tflight

    views = []
    for fl in (jflight, tflight):
        monkeypatch.setattr(fl, "_ARMED", True)
        fl.reset()
        try:
            for tenant, tid in (("a/b", "t1"), ("c/d", "t2")):
                tl = fl.Timeline(tid, "PutObject")
                tl.tenant = tenant
                fl.finish(tl, 200)
            tl = fl.begin("t3", "GetObject")
            fl.set_tenant("e/f")
            fl.end(200)
            views.append(([s["trace_id"] for s in fl.collect(tenant="a/b")],
                          len(fl.collect()), fl.collect(tenant="nobody"),
                          [s["trace_id"] for s in fl.snapshot(tenant="e/f")],
                          tl.tenant))
        finally:
            fl.reset()
    assert views[1] == views[0] == (["t1"], 3, [], ["t3"], "e/f")


def _server_tenant_view(pkg, paths):
    """One bucket PUT and GET by the root and one anonymous refused GET;
    -> the tenants of the scrape's per-tenant request counts and of the
    flight recorder's timelines, by tenant filter."""
    import json

    from tests import torch_iam as ti

    srv = ti.server(pkg, paths)
    try:
        cl = ti.root(srv.url)
        assert cl.request("PUT", "/qbkt").status_code == 200
        assert cl.request("PUT", "/qbkt/k", data=b"q" * 1000).status_code == 200
        assert cl.request("GET", "/qbkt/k").content == b"q" * 1000
        assert ti.anon(srv.url, "GET", "/qbkt/k").status_code == 403
        from tests.test_observability import parse_exposition

        scrape = cl.request("GET", "/minio/v2/metrics/node").text
        _families, samples = parse_exposition(scrape)
        reqs = {(lbl["tenant"], lbl["code"]): v for n, lbl, v in samples
                if n == "minio_tpu_tenant_requests_total"}
        mine = {k: v for k, v in reqs.items() if k[0].endswith("/qbkt")}
        tl = json.loads(ti.admin(cl, "GET", "perf/timeline",
                                 {"tenant": f"{ti.S3_ACCESS}/qbkt"}).content)
        apis = sorted(t["api"] for t in tl["timelines"])
        tenants = {t["tenant"] for t in tl["timelines"]}
        return mine, apis, tenants
    finally:
        srv.close()


def test_server_binds_the_tenant_after_auth_like_jax(monkeypatch, tmp_path):
    from tests import torch_iam as ti

    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    views = {pkg: _server_tenant_view(pkg, [str(tmp_path / f"{pkg}{i}")
                                            for i in range(4)])
             for pkg in ("jax", "torch")}
    assert views["torch"] == views["jax"]
    mine, apis, tenants = views["torch"]
    assert mine == {(f"{ti.S3_ACCESS}/qbkt", "2xx"): 3.0,
                    ("anonymous/qbkt", "4xx"): 1.0}
    assert tenants == {f"{ti.S3_ACCESS}/qbkt"} and "PutObject" in apis
