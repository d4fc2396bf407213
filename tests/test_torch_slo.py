"""The port's SLO plane (minio_tpu_torch/obs/{tsdb,slo,calibration}.py, the
admin `slo` routes, the front door's SLO mailbox), case for case the JAX
package's tests/test_slo.py, and held against the JAX package:

- burn-rate math, the ring's windows, reset clamp and persistence, on the
  same inputs in both packages; `SLOEngine.evaluate()` equal on the same
  sampled ring (clocks pinned), `merge_states` equal, a ring persisted by
  one package restored by the other;
- a drive-delay storm through the chaos wrapper (NaughtyDisk) breaches
  the PUT objective on a port server, the breach gauge and the admin
  `slo` answer agree, and the storm's exemplar resolves through
  perf/timeline; the breach clears over a healthy window;
- the federated answer: bounded by dead and hung peers; a cluster node's
  answer carries every peer (a port node and a JAX node); a front-door
  pool's answer merges every worker's StateSpool;
- a StateSpool written by one package is read by the other, and so is a
  calibration.json (the fingerprints pinned equal); the admin `slo`,
  `slo/history` and `faults` answers have the JAX server's shape.

The SLO windows read wall time: the tests drive `TSDB.sample_now()` with
the sampler's cadence parked at an hour, and pin clocks or windows; none
sleeps through a window. The calibration probe is pinned wherever a test
asserts "not stale" (an fsync on a loaded host can straddle a band edge).
The port runs on the CPU. Tolerance: exact."""

import gzip as gzip_mod
import json
import os
import re
import time
import types

import pytest

from minio_tpu_torch import chaos
from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client
from tests.torch_dist import free_port

# The module server's env: chaos-wrappable drives, small burn windows and
# a sampler cadence long enough that every snapshot below is an explicit
# sample_now().
_ENV = {
    "MTPU_CHAOS_DRIVE_WRAP": "1",
    "MTPU_SLO_SAMPLE_S": "3600",
    "MTPU_SLO_FAST_WINDOW_S": "60",
    "MTPU_SLO_SLOW_WINDOW_S": "120",
}

_LAT = "minio_tpu_s3_requests_latency_seconds_bucket"


def _k(name, **labels):
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's fault planes have their own registry, which the
    conftest's hygiene fixture never sees."""
    yield
    if chaos.anything_armed():
        chaos.clear_all()


def _pkg(name):
    import importlib

    root = "minio_tpu" if name == "jax" else "minio_tpu_torch"
    return types.SimpleNamespace(
        slo=importlib.import_module(f"{root}.obs.slo"),
        tsdb=importlib.import_module(f"{root}.obs.tsdb"),
        calibration=importlib.import_module(f"{root}.obs.calibration"),
        shm=importlib.import_module(f"{root}.frontdoor.shm"),
        invariants=importlib.import_module(f"{root}.chaos.invariants"),
        metrics=importlib.import_module(f"{root}.admin.metrics"))


PKGS = {"jax": _pkg("jax"), "torch": _pkg("torch")}
T = PKGS["torch"]


@pytest.fixture(scope="module")
def slo_server(tmp_path_factory):
    from minio_tpu_torch.chaos import naughty
    from minio_tpu_torch.s3.server import build_server

    old = {k: os.environ.get(k) for k in _ENV}
    os.environ.update(_ENV)
    # The engine and ring are process singletons: rebuild them under this
    # module's env.
    T.slo.reset()
    root = tmp_path_factory.mktemp("tslo")
    srv = build_server([str(root / f"d{i}") for i in range(4)], S3_ACCESS,
                       S3_SECRET, device="cpu").start()
    naughties = [nd for nd in naughty._registered()
                 if str(root) in str(nd.inner.endpoint())]
    assert len(naughties) == 4, "the chaos drive wrap did not engage"
    yield srv.url, srv, naughties
    naughty.clear_all()
    srv.close()
    T.slo.reset()
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def client(slo_server):
    return SigV4Client(slo_server[0], S3_ACCESS, S3_SECRET)


# ---------------------------------------------------------------------------
# burn-rate math, in both packages
# ---------------------------------------------------------------------------

def test_latency_burn_good_bad_split():
    """good = the cumulative count at the smallest bound >= threshold_s;
    the put objective (1.0 s, 0.99) burns (bad / total) / 0.01."""
    win = {_k(_LAT, api="PutObject", le="0.5"): 90.0,
           _k(_LAT, api="PutObject", le="1"): 95.0,
           _k(_LAT, api="PutObject", le="+Inf"): 100.0,
           _k(_LAT, api="GetObject", le="+Inf"): 50.0}   # must not leak in
    out = {}
    for name, p in PKGS.items():
        out[name] = p.slo.SLOEngine._latency_burn(
            p.slo.SLO_OBJECTIVES["put_latency_p99"], win)
    burn, per = out["torch"]
    assert burn == pytest.approx(5.0)
    assert per["_"]["total"] == 100.0 and per["_"]["bad"] == 5.0
    assert out["torch"] == out["jax"]


def test_latency_burn_grouped_worst_tenant_wins():
    fam = "minio_tpu_tenant_request_seconds_bucket"
    win = {_k(fam, tenant="calm", le="1"): 100.0,
           _k(fam, tenant="calm", le="+Inf"): 100.0,
           _k(fam, tenant="noisy", le="1"): 50.0,
           _k(fam, tenant="noisy", le="+Inf"): 100.0}
    out = {name: p.slo.SLOEngine._latency_burn(
        p.slo.SLO_OBJECTIVES["tenant_latency_p99"], win)
        for name, p in PKGS.items()}
    burn, per = out["torch"]
    assert burn == pytest.approx(50.0)
    assert per["noisy"]["burn"] == pytest.approx(50.0)
    assert per["calm"]["burn"] == 0.0
    assert out["torch"] == out["jax"]


def test_error_ratio_burn():
    win = {_k("minio_tpu_s3_requests_total", api="PutObject"): 600.0,
           _k("minio_tpu_s3_requests_total", api="GetObject"): 400.0,
           _k("minio_tpu_s3_requests_5xx_errors_total", api="PutObject"): 2.0}
    out = {name: p.slo.SLOEngine._error_burn(
        p.slo.SLO_OBJECTIVES["s3_error_ratio"], win)
        for name, p in PKGS.items()}
    assert out["torch"][0] == pytest.approx(2.0)     # 0.2% bad / 0.1% budget
    assert out["torch"] == out["jax"]


def test_objectives_are_the_jax_literal():
    assert T.slo.SLO_OBJECTIVES == PKGS["jax"].slo.SLO_OBJECTIVES
    assert T.slo.WINDOWS == PKGS["jax"].slo.WINDOWS
    assert T.tsdb.DEFAULT_FAMILIES == PKGS["jax"].tsdb.DEFAULT_FAMILIES


def _state(worker, burn, breach, slo="put_latency_p99", w="fast"):
    return {"time": 1.0 + worker, "worker": worker, "threshold": 14.4,
            "fast_s": 60, "slow_s": 120,
            "slos": {slo: {"breach": breach, "target": 0.99, "kind": "latency",
                           "windows": {w: {"burn": burn, "window_s": 60,
                                           "groups": {"_": {"burn": burn}}}}}}}


def test_merge_states_worst_burn_and_breach_any():
    states = [_state(0, 2.0, False), _state(1, 30.0, True),
              _state(2, 7.0, False, slo="s3_error_ratio", w="slow"),
              "not a state", _state(3, 30.0, False)]
    merged = {name: p.slo.merge_states(states) for name, p in PKGS.items()}
    m = merged["torch"]
    assert m["workers"] == [0, 1, 2, 3]
    s = m["slos"]["put_latency_p99"]
    assert s["breach"] is True
    assert s["windows"]["fast"]["burn"] == pytest.approx(30.0)
    assert m["slos"]["s3_error_ratio"]["windows"]["slow"]["burn"] == 7.0
    assert merged["torch"] == merged["jax"]


# ---------------------------------------------------------------------------
# the ring: windows, the reset clamp, persistence, across packages
# ---------------------------------------------------------------------------

class _FakeStore:
    def __init__(self):
        self.blobs: dict[str, bytes] = {}

    def read_sys_config(self, key: str) -> bytes:
        return self.blobs[key]

    def write_sys_config(self, key: str, blob: bytes) -> None:
        self.blobs[key] = bytes(blob)


def _counter_source(state):
    def src():
        return [("test_slo_ring_total", {"api": "x"}, state["v"])]
    return src


def test_ring_delta_window_and_reset_clamp():
    db = T.tsdb.TSDB(families=("test_slo_ring_total",), sample_s=3600,
                     persist_s=10**9)
    state = {"v": 100.0}
    db.add_source(_counter_source(state), key="t")
    db.sample_now()
    state["v"] = 140.0
    db.sample_now()
    span, win = db.delta_window(60)
    assert span > 0
    assert win[_k("test_slo_ring_total", api="x")] == pytest.approx(40.0)
    # A counter reset (a restart) clamps to 0, never negative.
    state["v"] = 3.0
    db.sample_now()
    _span, win = db.delta_window(60)
    assert win[_k("test_slo_ring_total", api="x")] == 0.0
    assert T.invariants.window_from_ring(db, 60) == win


def test_window_from_history_equals_the_rings(monkeypatch):
    """The window another process reads from a ring's `slo/history`
    answer (timestamps rounded to the millisecond there) is the ring's."""
    clock = [2_000_000.0]
    _pin_clock(monkeypatch, clock)
    db = T.tsdb.TSDB(families=("test_slo_ring_total",), sample_s=3600,
                     persist_s=10**9)
    state = {"v": 0.0}
    db.add_source(_counter_source(state), key="t")
    for v in (5.0, 9.0, 30.0, 31.0, 2.0, 40.0):
        state["v"] = v
        clock[0] += 20.0
        db.sample_now()
    for seconds in (10, 30, 60, 3600):
        assert T.invariants.window_from_history(db.history(), seconds) == \
            T.invariants.window_from_ring(db, seconds), seconds
    # Base: the newest sample at or before 30 s ago (31.0), so 40 - 31.
    assert T.invariants.window_from_ring(db, 30) == {
        _k("test_slo_ring_total", api="x"): 9.0}


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch"),
                                           ("torch", "torch")])
def test_ring_persist_restore_roundtrip(writer, reader):
    """A ring persisted by one package is restored by the other (or by
    itself): the successor's first fresh sample yields a delta at once."""
    store = _FakeStore()
    w, r = PKGS[writer].tsdb, PKGS[reader].tsdb
    db = w.TSDB(families=("test_slo_ring_total",), sample_s=3600, persist_s=10**9)
    db.attach_store(store, "slo/history.json.gz")   # cold start: no blob
    state = {"v": 7.0}
    db.add_source(_counter_source(state), key="t")
    db.sample_now()
    state["v"] = 9.0
    db.sample_now()
    db.persist()
    doc = json.loads(gzip_mod.decompress(store.blobs["slo/history.json.gz"]).decode())
    assert doc["v"] == 1 and len(doc["coarse"]) == 2

    db2 = r.TSDB(families=("test_slo_ring_total",), sample_s=3600, persist_s=10**9)
    db2.attach_store(store, "slo/history.json.gz")
    hist = db2.history()
    assert len(hist) == 2
    assert hist[-1]["samples"] == [["test_slo_ring_total", [["api", "x"]], 9.0]]
    assert hist == db.history()
    state["v"] = 15.0
    db2.add_source(_counter_source(state), key="t")
    db2.sample_now()
    _span, win = db2.delta_window(3600)
    assert win[_k("test_slo_ring_total", api="x")] == pytest.approx(8.0)


def _pin_clock(monkeypatch, clock):
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("__")})
    fake.time = lambda: clock[0]
    for p in PKGS.values():
        monkeypatch.setattr(p.tsdb, "time", fake)
        monkeypatch.setattr(p.slo, "time", fake)


def test_engine_evaluate_equal_on_the_same_ring(monkeypatch):
    """The same sampled ring (the same counters at the same pinned
    instants) evaluates to the same state, burns and breaches in both
    packages, and the burn and breach gauges carry it."""
    import numpy as np

    clock = [1_000_000.0]
    _pin_clock(monkeypatch, clock)
    for p in PKGS.values():
        monkeypatch.setattr(p.tsdb, "_obs_registry", lambda: [])
    rng = np.random.default_rng(18)
    bounds = ("0.5", "1", "2.5", "+Inf")
    series = []                    # per tick: [(name, labels, value)]
    cum = {}
    for _tick in range(12):
        for api, thr_heavy in (("PutObject", 0.3), ("GetObject", 0.05)):
            n = int(rng.integers(20, 60))
            lat = rng.exponential(thr_heavy * 3, n)
            for b in bounds:
                key = (api, b)
                cut = float("inf") if b == "+Inf" else float(b)
                cum[key] = cum.get(key, 0) + int((lat <= cut).sum())
            cum[(api, "total")] = cum.get((api, "total"), 0) + n
            cum[(api, "5xx")] = cum.get((api, "5xx"), 0) + int(rng.integers(0, 2))
        for tenant in ("calm", "noisy"):
            n = 40
            bad = 1 if tenant == "calm" else 12
            for b in bounds:
                key = (tenant, b)
                cum[key] = cum.get(key, 0) + (n - bad if b in ("0.5", "1") else n)
        rows = []
        for api in ("PutObject", "GetObject"):
            for b in bounds:
                rows.append((_LAT, {"api": api, "le": b}, cum[(api, b)]))
            rows.append(("minio_tpu_s3_requests_total", {"api": api},
                         cum[(api, "total")]))
            rows.append(("minio_tpu_s3_requests_5xx_errors_total", {"api": api},
                         cum[(api, "5xx")]))
        for tenant in ("calm", "noisy"):
            for b in bounds:
                rows.append(("minio_tpu_tenant_request_seconds_bucket",
                             {"tenant": tenant, "le": b}, cum[(tenant, b)]))
        series.append(rows)

    states = {}
    for name, p in PKGS.items():
        clock[0] = 1_000_000.0
        families = tuple({r[0].removesuffix("_bucket") for r in series[0]}
                         | {r[0] for r in series[0]})
        db = p.tsdb.TSDB(families=families, sample_s=3600, persist_s=10**9)
        tick = {"i": 0}
        db.add_source(lambda s=series, t=tick: s[t["i"]], key="t")
        monkeypatch.setenv("MTPU_SLO_FAST_WINDOW_S", "300")
        monkeypatch.setenv("MTPU_SLO_SLOW_WINDOW_S", "3600")
        eng = p.slo.SLOEngine(db)
        db.add_listener(eng.evaluate)
        for i in range(len(series)):
            tick["i"] = i
            clock[0] += 60.0
            db.sample_now()
        states[name] = eng.state()
    assert states["torch"] == states["jax"]
    st = states["torch"]
    assert st["slos"]["tenant_latency_p99"]["breach"] is True
    assert st["slos"]["tenant_latency_p99"]["windows"]["fast"]["groups"]["noisy"]["burn"] \
        == pytest.approx(30.0)
    assert st["slos"]["put_latency_p99"]["windows"]["slow"]["window_s"] == 660.0
    text = _node_scrape_text()
    for name, s in st["slos"].items():
        want = "1.0" if s["breach"] else "0.0"
        assert f'minio_tpu_slo_breach{{slo="{name}"}} {want}' in text


def _node_scrape_text() -> str:
    from minio_tpu_torch import obs
    from minio_tpu_torch.admin.metrics import PromText

    p = PromText(False)
    obs.render_into(p)
    return p.render().decode()


# ---------------------------------------------------------------------------
# the port server: history, the chaos storm, the breach and its recovery
# ---------------------------------------------------------------------------

def test_history_endpoint_prefix_filter(slo_server, client):
    assert client.put("/histbkt").status_code == 200
    assert client.put("/histbkt/a", data=b"h" * 512).status_code == 200
    T.tsdb.get().sample_now()
    r = client.get("/minio/admin/v3/slo/history",
                   query={"prefix": "minio_tpu_s3_requests_total"})
    assert r.status_code == 200, r.text
    doc = r.json()
    assert doc["history"], "ring empty after sample_now"
    names = {s[0] for ent in doc["history"] for s in ent["samples"]}
    assert names == {"minio_tpu_s3_requests_total"}, names


_EXEMPLAR_RE = re.compile(
    r'^minio_tpu_s3_requests_latency_seconds_bucket\{[^}]*api="PutObject"'
    r'[^}]*\} \S+ # \{trace_id="([0-9A-Za-z]+)"\}', re.M)


def test_chaos_drive_storm_breaches_put_slo_and_exemplar_resolves(
        slo_server, client, monkeypatch):
    import importlib

    # The module, not the obs package's histogram() of the same name.
    histogram = importlib.import_module("minio_tpu_torch.obs.histogram")
    _base, _srv, naughties = slo_server
    eng = T.slo.engine()
    assert eng is not None, "the SLO engine was not started by build_server"
    assert eng.fast_s == 60.0 and eng.slow_s == 120.0
    assert client.put("/slobkt").status_code == 200
    # Every observation captures its exemplar for this storm.
    monkeypatch.setattr(histogram, "EXEMPLAR_EVERY", 1)
    T.tsdb.get().sample_now()                 # the window's base
    try:
        for nd in naughties:
            nd.per_method_delay.update({"create_file": 1.3, "write_all": 1.3})
        t0 = time.monotonic()
        storm_ids = set()
        for i in range(4):
            r = client.put(f"/slobkt/slow-{i}", data=b"s" * (1 << 20))
            assert r.status_code == 200, r.text
            storm_ids.add(r.headers["x-amz-request-id"])
        assert time.monotonic() - t0 > 1.0, "the drive delays did not slow the PUTs"
    finally:
        for nd in naughties:
            nd.clear_faults()
    T.tsdb.get().sample_now()                 # evaluates inside
    state = eng.state()
    put = state["slos"]["put_latency_p99"]
    assert put["windows"]["fast"]["burn"] >= eng.threshold, put
    assert put["breach"] is True, put
    assert state["slos"]["s3_error_ratio"]["breach"] is False

    r = client.get("/minio/v2/metrics/node")
    assert r.status_code == 200
    assert 'minio_tpu_slo_breach{slo="put_latency_p99"} 1.0' in r.text
    r = client.get("/minio/admin/v3/slo")
    assert r.status_code == 200, r.text
    doc = r.json()
    assert not doc["errors"]
    (_node, st), = doc["nodes"].items()
    assert st["slos"]["put_latency_p99"]["breach"] is True

    r = client.get("/minio/v2/metrics/node",
                   headers={"Accept": "application/openmetrics-text"})
    assert r.status_code == 200
    assert r.headers["Content-Type"].startswith("application/openmetrics-text")
    # The registry is the process's: a bucket the storm did not reach keeps
    # an exemplar of an earlier test's PUT. The storm's last PUT is the
    # newest observation of its bucket, so its trace id is there.
    tids = [t for t in _EXEMPLAR_RE.findall(r.text) if t in storm_ids]
    assert tids, "no exemplar of the storm's PUTs in the OpenMetrics exposition"
    tid = tids[0]
    r = client.get("/minio/admin/v3/perf/timeline",
                   query={"traceid": tid, "all": "false"})
    assert r.status_code == 200, r.text
    snaps = r.json()["timelines"]
    assert snaps and snaps[0]["trace_id"] == tid
    assert snaps[0]["api"] == "PutObject"


def test_breach_clears_after_recovery(slo_server, client):
    """The fast burn decays once healthy traffic refills the window: the
    next evaluation over an all-good delta drops the breach gauge."""
    eng = T.slo.engine()
    db = T.tsdb.get()
    for i in range(3):
        assert client.put(f"/slobkt/ok-{i}", data=b"k" * 4096).status_code == 200
    time.sleep(0.05)
    db.sample_now()
    old_fast, old_slow = eng.fast_s, eng.slow_s
    eng.fast_s = eng.slow_s = 0.01
    try:
        state = eng.evaluate()
    finally:
        eng.fast_s, eng.slow_s = old_fast, old_slow
    assert state["slos"]["put_latency_p99"]["breach"] is False
    r = client.get("/minio/v2/metrics/node")
    assert 'minio_tpu_slo_breach{slo="put_latency_p99"} 0.0' in r.text


# ---------------------------------------------------------------------------
# federation
# ---------------------------------------------------------------------------

class _DeadPeer:
    name = "peer-dead"

    def slo(self):
        raise ConnectionError("connection refused")


class _HungPeer:
    name = "peer-hung"

    def slo(self):
        time.sleep(3.0)
        return {}


class _FakeNotification:
    def __init__(self, peers):
        self.peers = peers


def test_slo_fanout_bounded_by_dead_and_hung_peers(slo_server):
    errs = T.metrics._PEER_SCRAPE_ERRORS
    dead0 = errs.labels(peer="peer-dead").value
    hung0 = errs.labels(peer="peer-hung").value
    t0 = time.monotonic()
    out = T.metrics.collect_cluster_slo(
        _FakeNotification([_DeadPeer(), _HungPeer()]), "local", deadline=0.5)
    wall = time.monotonic() - t0
    assert wall < 2.5, f"the hung peer stalled the fan-out for {wall:.1f}s"
    assert sorted(out["errors"]) == ["peer-dead", "peer-hung"]
    assert "local" in out["nodes"] and "peer-dead" not in out["nodes"]
    assert errs.labels(peer="peer-dead").value == dead0 + 1
    assert errs.labels(peer="peer-hung").value == hung0 + 1


def test_cluster_slo_answer_carries_every_peer(tmp_path, monkeypatch):
    """A port node and a JAX node serving one set: each node's federated
    `slo` answer holds both nodes, the peer's pulled over the peer plane
    of the other package."""
    from tests import torch_dist as td
    from tests.test_torch_cluster import _boot

    for m in (td.jax_rpc, td.torch_rpc):
        monkeypatch.setattr(m, "HEALTH_INTERVAL", 0.05)
        monkeypatch.setattr(m, "HEALTH_BACKOFF_CAP", 0.2)
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    nodes = _boot(tmp_path, [("torch", 5), ("jax", 3)], parity=3)
    try:
        # One evaluation in each node (each package's process engine).
        for p in PKGS.values():
            p.tsdb.get().sample_now()
        names = sorted(n.node.node_name for n in nodes)
        deadline = time.monotonic() + 60
        for n in nodes:
            while True:
                r = SigV4Client(n.url, S3_ACCESS, S3_SECRET).get("/minio/admin/v3/slo")
                assert r.status_code == 200, r.text
                doc = r.json()
                if sorted(doc["nodes"]) == names or time.monotonic() > deadline:
                    break
                time.sleep(0.2)
            assert sorted(doc["nodes"]) == names, doc
            assert not doc["errors"]
            for st in doc["nodes"].values():
                assert set(st["slos"]) == set(T.slo.SLO_OBJECTIVES)
    finally:
        for n in reversed(nodes):
            n.close()


def test_front_door_pool_merges_every_workers_mailbox(tmp_path):
    """Two port workers behind one supervisor: each evaluates on its own
    ring, writes its StateSpool, and either worker's `slo` answer holds
    both workers."""
    from minio_tpu_torch.frontdoor.supervisor import Supervisor

    port = free_port()
    url = f"http://127.0.0.1:{port}"
    sup = Supervisor([str(tmp_path / f"p{i}") for i in range(4)],
                     f"127.0.0.1:{port}", 2, device="cpu", log_dir=str(tmp_path),
                     env={"MTPU_ROOT_USER": S3_ACCESS, "MTPU_ROOT_PASSWORD": S3_SECRET,
                          "MTPU_SLO_SAMPLE_S": "0.2", "JAX_PLATFORMS": "cpu",
                          "MTPU_FRONTDOOR_DRAIN_S": "10"})
    sup.start()
    try:
        sup.wait_workers(90)
        deadline = time.monotonic() + 60
        seen = {}
        while time.monotonic() < deadline and len(seen) < 2:
            cl = SigV4Client(url, S3_ACCESS, S3_SECRET)
            try:
                r = cl.request("GET", "/minio/admin/v3/slo")
            finally:
                cl.session.close()
            assert r.status_code == 200, r.text
            doc = r.json()
            local = doc["nodes"]["local"]
            if sorted(local["workers"]) == [0, 1]:
                seen[r.headers["X-Mtpu-Worker"]] = local
            else:
                time.sleep(0.2)
        assert len(seen) == 2, f"not every worker merged both mailboxes: {seen}"
        for local in seen.values():
            assert set(local["slos"]) == set(T.slo.SLO_OBJECTIVES)
    finally:
        sup.drain(timeout=30)


# ---------------------------------------------------------------------------
# the state mailbox and the calibration profile across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_state_spool_read_across_packages(writer, reader):
    name = f"tslo{os.getpid()}{writer[0]}"
    w = PKGS[writer].shm.StateSpool.create(name)
    try:
        assert w.nslots == 1 and w.cap == PKGS[reader].shm.DEFAULT_STATE_BYTES
        assert PKGS[writer].shm.STATE_MAGIC == PKGS[reader].shm.STATE_MAGIC
        r = PKGS[reader].shm.StateSpool.attach(name)
        try:
            assert r.read_all() == []
            for i in range(3):
                st = _state(i, 1.5 * i, i == 2)
                w.put(st)
                assert r.read_all() == [st]
            with pytest.raises(ValueError):
                PKGS[reader].shm.FlightSpool.attach(name)
        finally:
            r.close()
    finally:
        w.close()
        w.unlink()


def _pin_host(monkeypatch, platform="gpu", devices=1, medium="ssd"):
    for p in PKGS.values():
        monkeypatch.setattr(p.calibration, "_accel", lambda: (platform, devices))
        monkeypatch.setattr(p.calibration, "_probe_fsync", lambda root: (medium, 500.0))


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_calibration_profile_read_across_packages(tmp_path, monkeypatch, writer, reader):
    _pin_host(monkeypatch)
    d0 = tmp_path / "drive0"
    d0.mkdir()
    first = PKGS[writer].calibration.boot(str(d0))
    assert first["stored"] is None and first["stale"] == []
    path = d0 / ".mtpu.sys" / "calibration.json"
    written = json.loads(path.read_text())
    assert set(written) == {"v", "time", "mtpu_version", "fingerprint", "gates"}
    again = PKGS[reader].calibration.boot(str(d0))
    assert again["stored"] == written and again["stale"] == []
    assert again["profile"]["gates"] == written["gates"]
    assert again["profile"]["fingerprint"] == written["fingerprint"]
    assert json.loads(path.read_text()) == written      # left in place
    # Another host class under the reader: stale on exactly those keys.
    _pin_host(monkeypatch, platform="tpu", devices=4, medium="disk")
    stale = PKGS[reader].calibration.boot(str(d0))
    assert set(stale["stale"]) == {"platform", "devices", "fsync_medium"}


def test_calibration_profile_boot_and_staleness(tmp_path, monkeypatch):
    monkeypatch.setattr(T.calibration, "_probe_fsync", lambda root: ("ssd", 500.0))
    d0 = tmp_path / "drive0"
    d0.mkdir()
    assert T.calibration.boot(str(d0))["stale"] == []
    prof_path = d0 / ".mtpu.sys" / "calibration.json"
    assert prof_path.exists()
    assert T.calibration.boot(str(d0))["stale"] == []
    doc = json.loads(prof_path.read_text())
    doc["fingerprint"]["cores"] += 64
    doc["fingerprint"]["fsync_medium"] = "carrier-pigeon"
    prof_path.write_text(json.dumps(doc))
    assert set(T.calibration.boot(str(d0))["stale"]) == {"cores", "fsync_medium"}
    assert 'minio_tpu_calibration_stale 1.0' in _node_scrape_text()
    # Park the process gauge back at 0 with a matching profile.
    d1 = tmp_path / "drive1"
    d1.mkdir()
    T.calibration.boot(str(d1))
    assert T.calibration.boot(str(d1))["stale"] == []
    assert 'minio_tpu_calibration_stale 0.0' in _node_scrape_text()


def test_fingerprint_and_gates():
    fp = T.calibration.fingerprint()
    assert {"cores", "page_size", "platform", "devices"} <= set(fp)
    # No card here: the CPU with no CUDA device.
    assert (fp["platform"], fp["devices"]) == ("cpu", 0)
    prof = T.calibration.profile()
    assert set(prof) >= {"fingerprint", "gates", "time"}
    assert T.calibration.gates() == PKGS["jax"].calibration.gates()
    assert T.calibration.COMPARE_KEYS == PKGS["jax"].calibration.COMPARE_KEYS


def test_calibration_and_build_info_on_scrape(slo_server, client):
    r = client.get("/minio/v2/metrics/node")
    m = re.search(r'minio_tpu_build_info\{([^}]*)\} 1\.0', r.text)
    assert m, "the build info gauge is missing"
    assert 'platform="cpu"' in m.group(1) and 'version="0.1.0"' in m.group(1)
    assert re.search(r"^minio_tpu_calibration_stale [01]\.0$", r.text, re.M)


# ---------------------------------------------------------------------------
# gzip, and the admin answers' shape against the JAX server's
# ---------------------------------------------------------------------------

def test_slo_routes_gzip_when_negotiated(slo_server, client):
    for path in ("/minio/admin/v3/slo", "/minio/admin/v3/slo/history"):
        r = client.get(path, headers={"Accept-Encoding": "gzip"})
        assert r.status_code == 200
        assert r.headers.get("Content-Encoding") == "gzip"
        assert r.json()
    r = client.request("GET", "/minio/admin/v3/slo",
                       headers={"Accept-Encoding": "identity"})
    assert r.headers.get("Content-Encoding") is None
    assert client.get("/minio/admin/v3/slo/nope").status_code == 405


def _paths(doc, prefix=""):
    """{path/to/leaf:type} of a document (a list by its first item)."""
    shape = _shape(doc)
    out = set()

    def walk(node, at):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{at}/{k}")
        elif isinstance(node, list):
            out.add(f"{at}[]") if not node else walk(node[0], f"{at}[]")
        else:
            out.add(f"{at}:{node}")

    walk(shape, prefix)
    return out


def _shape(doc, data_keys=False):
    """The document's structure: the types of its leaves, a list by its
    first item, and the keys of a `groups` or `nodes` map (data: tenant
    and node names) folded into one "*"."""
    if isinstance(doc, dict):
        if data_keys:
            return {"*": _shape(next(iter(doc.values())))} if doc else {}
        return {k: _shape(v, k in ("groups", "nodes")) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_shape(doc[0])] if doc else []
    if isinstance(doc, bool):
        return "bool"
    if isinstance(doc, (int, float)):
        return "number"
    return type(doc).__name__


def test_admin_slo_and_faults_answers_shaped_as_jax(slo_server, client, tmp_path,
                                                    monkeypatch):
    from tests.torch_atrest import JaxServer

    jsrv = JaxServer([str(tmp_path / f"j{i}") for i in range(4)])
    try:
        jc = SigV4Client(jsrv.url, S3_ACCESS, S3_SECRET)
        answers = {}
        for name, cl in (("jax", jc), ("torch", client)):
            # The same traffic on both, so each objective has its groups.
            PKGS[name].tsdb.get().sample_now()
            assert cl.put("/shapebkt").status_code in (200, 409)
            assert cl.put("/shapebkt/k", data=b"s" * 1000).status_code == 200
            assert cl.get("/shapebkt/k").status_code == 200
            PKGS[name].tsdb.get().sample_now()
            monkeypatch.delenv("MTPU_FAULT_INJECTION", raising=False)
            refused = cl.get("/minio/admin/v3/faults")
            monkeypatch.setenv("MTPU_FAULT_INJECTION", "1")
            got = {"slo": cl.get("/minio/admin/v3/slo").json(),
                   "history": cl.get("/minio/admin/v3/slo/history",
                                     query={"seconds": "3600"}).json(),
                   "faults": cl.get("/minio/admin/v3/faults").json(),
                   "refused": (refused.status_code, "NotImplemented" in refused.text)}
            bad = cl.post("/minio/admin/v3/faults", data=b"[1]")
            got["bad"] = (bad.status_code, "InvalidArgument" in bad.text)
            rule = cl.post("/minio/admin/v3/faults", data=json.dumps(
                {"op": "partition", "name": "p", "groups": [["a:1"], ["b:2"]],
                 "seed": 7}).encode())
            got["rule"] = rule.json()
            got["clear_all"] = cl.post("/minio/admin/v3/faults",
                                       data=b'{"op": "clear_all"}').json()
            answers[name] = got
        for key in ("refused", "bad", "rule"):
            assert answers["torch"][key] == answers["jax"][key], key
        # What clear_all found armed depends on each process registry's
        # history; the network plane it uninstalled is this test's.
        assert set(answers["torch"]["clear_all"]) == set(answers["jax"]["clear_all"])
        assert answers["torch"]["clear_all"]["net_plane"] == 1
        assert answers["jax"]["clear_all"]["net_plane"] == 1
        assert answers["torch"]["refused"] == (501, True)
        assert answers["torch"]["bad"] == (400, True)
        for key in ("slo", "faults"):
            tp, jp = _paths(answers["torch"][key]), _paths(answers["jax"][key])
            assert tp == jp, (key, sorted(tp ^ jp))
        th, jh = answers["torch"]["history"], answers["jax"]["history"]
        assert set(th) == set(jh) == {"node", "history"}
        assert _shape(th["history"][-1]) == _shape(jh["history"][-1])
    finally:
        jsrv.close()
