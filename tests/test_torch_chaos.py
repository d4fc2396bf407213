"""The port's composed chaos plane (minio_tpu_torch/chaos/), case for case
the JAX package's tests/test_chaos.py, and held against the JAX package:

1. one seed reproduces the storm: `subseed` and the generated
   `ChaosProgram` previews equal the JAX package's, bit for bit; the
   scheduler applies the preview in order and records a missing actuator;
   the network plane takes its seed from the master;
2. the ledger's fold, the invariant checker's verdicts and the exposition
   helpers (`parse_exposition`, `histogram_quantile`, `counter_sum`, on a
   port server's scrape) equal the JAX package's on the same input; a
   worker of the mixed workload draws the same op stream as the JAX one;
3. `clear_all` releases hangs, the network plane and open breakers;
4. a bounded composed storm on three port node processes
   (tests/torch_chaos_cluster.py, `--device cpu`): drive hangs and errors
   through the admin `faults` route, an asymmetric partition through the
   fault plane, one node SIGKILLed and restarted, under a mixed workload
   on the stdlib client; then all four invariants, the SLO one on a
   window of node 0's own metric ring.

Every failure message carries MTPU_CHAOS_SEED. Tolerance: exact."""

import json
import random
import threading
import time

import pytest

from minio_tpu import chaos as jax_chaos
from minio_tpu.chaos import invariants as jax_invariants
from minio_tpu.chaos import ledger as jax_ledger
from minio_tpu.chaos import schedule as jax_schedule
from minio_tpu.chaos import workload as jax_workload
from minio_tpu_torch import chaos
from minio_tpu_torch.chaos import invariants, schedule
from minio_tpu_torch.chaos import ledger as ledger_mod
from minio_tpu_torch.chaos import naughty as naughty_mod
from minio_tpu_torch.chaos.workload import MixedWorkload
from minio_tpu_torch.dist import faultplane
from minio_tpu_torch.dist import rpc as rpc_mod

SEED = chaos.master_seed(default=20260803)


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's NaughtyDisks, network plane and breakers have their own
    registry, which the conftest's hygiene fixture never sees: release
    whatever a test left armed, so a HANG leaks no parked thread into the
    next test of this worker."""
    yield
    if chaos.anything_armed():
        chaos.clear_all()


# ---------------------------------------------------------------------------
# 1. seed discipline and the schedule
# ---------------------------------------------------------------------------

def test_subseed_stable_and_equal_to_jax():
    assert chaos.subseed(42, "net") == chaos.subseed(42, "net")
    assert chaos.subseed(42, "net") != chaos.subseed(42, "drive")
    assert chaos.subseed(42, "net") != chaos.subseed(43, "net")
    assert chaos.subseed(0, "net") == 3066711364380105199
    rng = random.Random(18)
    for _ in range(64):
        m = rng.getrandbits(63)
        plane = rng.choice(["net", "drive-schedule", "worker-3", "proc"])
        assert chaos.subseed(m, plane) == jax_chaos.subseed(m, plane)


def test_master_seed_reads_the_env(monkeypatch):
    monkeypatch.setenv(chaos.MASTER_SEED_ENV, "77")
    assert chaos.master_seed() == jax_chaos.master_seed() == 77
    monkeypatch.setenv(chaos.MASTER_SEED_ENV, "not-a-number")
    assert chaos.master_seed(5) == jax_chaos.master_seed(5) == 5


_GEN = dict(nodes=["a:1", "b:2", "c:3"], drives=["d0", "d1", "d2"],
            kill_nodes=["c:3"])


@pytest.mark.parametrize("seed", [SEED, 0, 1, 1 << 40])
@pytest.mark.parametrize("extra", [{}, {"worker_kill_targets": ["w0", "w1"]},
                                   {"flap_period": 5.0, "hang_hold": 2.0,
                                    "hang_methods": ("read_all",)}])
def test_program_preview_equal_to_jax(seed, extra):
    kw = {**_GEN, **extra}
    ours = schedule.ChaosProgram.generate(seed, 60.0, **kw)
    theirs = jax_schedule.ChaosProgram.generate(seed, 60.0, **kw)
    assert ours.schedule() == theirs.schedule()
    assert ours.describe() == theirs.describe()
    assert [repr(e) for e in ours.sorted_events()] == \
        [repr(e) for e in theirs.sorted_events()]


def test_program_generation_deterministic():
    a = schedule.ChaosProgram.generate(SEED, 60.0, **_GEN)
    b = schedule.ChaosProgram.generate(SEED, 60.0, **_GEN)
    assert a.schedule() == b.schedule()
    assert a.schedule(5) == b.schedule(5) == a.schedule()[:5]
    assert a.schedule() == a.schedule()
    assert a.schedule() != schedule.ChaosProgram.generate(SEED + 1, 60.0, **_GEN).schedule()
    kinds = [k for _t, k, *_rest in a.schedule()]
    assert kinds.count(schedule.DRIVE_HANG) == kinds.count(schedule.DRIVE_CLEAR)
    assert kinds.count(schedule.NET_PARTITION) == kinds.count(schedule.NET_HEAL)
    assert kinds.count(schedule.KILL) == kinds.count(schedule.RESTART) == 1
    assert a.duration() <= 60.0
    with pytest.raises(ValueError):
        schedule.ChaosEvent(0.0, "meteor", "x")


def test_scheduler_applies_in_order_and_records_errors():
    prog = schedule.ChaosProgram(SEED)
    prog.add(0.02, schedule.DRIVE_HANG, "d0", method="read_version")
    prog.add(0.05, schedule.NET_HEAL, "x", name="p")
    prog.add(0.08, schedule.KILL, "node-without-actuator")
    applied = []
    sched = schedule.ChaosScheduler(prog, {
        schedule.DRIVE_HANG: lambda ev: applied.append(ev.kind),
        schedule.NET_HEAL: lambda ev: applied.append(ev.kind),
    })
    sched.start()
    assert sched.join(5.0)
    assert applied == [schedule.DRIVE_HANG, schedule.NET_HEAL]
    assert sched.applied() == prog.schedule(2)
    assert len(sched.errors()) == 1 and "kill" in str(sched.errors()[0])


def test_faultplane_derives_seed_from_chaos_master(monkeypatch):
    monkeypatch.setenv(chaos.MASTER_SEED_ENV, "5")
    p = faultplane.install()
    try:
        assert p.seed == chaos.subseed(5, "net")
    finally:
        faultplane.uninstall()
    p = faultplane.install(seed=123)
    try:
        assert p.seed == 123
    finally:
        faultplane.uninstall()


# ---------------------------------------------------------------------------
# 2. the ledger, the checker and the exposition helpers against the JAX ones
# ---------------------------------------------------------------------------

def _fold(ledger_pkg, ops):
    L = ledger_pkg.WriteLedger()
    for op, key, sha, ack in ops:
        e = L.intent(op, key, sha, len(sha))
        if ack:
            L.ack(e, f"etag-{e.seq}")
    return {k: (st.must_exist, st.candidates,
                None if st.settled is None else (st.settled.seq, st.settled.op,
                                                 st.settled.etag))
            for k, st in sorted(L.expected().items())}, L.describe()


def test_ledger_expected_state_fold():
    L = ledger_mod.WriteLedger()
    e = L.intent("put", "a", "A1", 2)
    L.ack(e, "etag-a")
    e = L.intent("put", "b", "B1", 2)
    L.ack(e)
    L.intent("put", "b", "B2", 2)
    e = L.intent("put", "c", "C1", 2)
    L.ack(e)
    e = L.intent("delete", "c")
    L.ack(e)
    L.intent("put", "d", "D1", 2)
    exp = L.expected()
    assert exp["a"].must_exist and exp["a"].candidates == ["A1"]
    assert not exp["b"].must_exist
    assert exp["b"].candidates == ["B1", "B2"]
    assert exp["c"].candidates == [None]
    assert exp["d"].candidates == [None, "D1"]
    assert L.acked_count() == 4


@pytest.mark.parametrize("seed", [3, 18, 2026])
def test_ledger_fold_equal_to_jax(seed, tmp_path):
    rng = random.Random(seed)
    ops = [(rng.choice(["put", "put", "delete", "multipart"]),
            f"k{rng.randrange(12)}", f"{rng.getrandbits(64):016x}",
            rng.random() < 0.7) for _ in range(300)]
    assert _fold(ledger_mod, ops) == _fold(jax_ledger, ops)
    # The JSONL audit trail: the same rows but their clocks.
    rows = {}
    for name, pkg in (("torch", ledger_mod), ("jax", jax_ledger)):
        path = tmp_path / f"{name}.jsonl"
        L = pkg.WriteLedger(path=str(path))
        for op, key, sha, ack in ops[:40]:
            e = L.intent(op, key, sha, 3)
            if ack:
                L.ack(e, "t")
        L.close()
        rows[name] = [{k: v for k, v in json.loads(line).items() if k != "t"}
                      for line in path.read_text().splitlines()]
    assert rows["torch"] == rows["jax"] and rows["torch"]


def _checker_served():
    bodies = {"lost": b"xx", "torn": b"yyyy", "ok": b"zz"}
    served = {"lost": (404, b""), "torn": (200, b"yyXX"), "ok": (200, b"zz"),
              "ghost": (200, b"boo")}
    return bodies, served


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_invariant_checker_catches_loss_torn_and_ghost(pkg):
    inv, led = ((invariants, ledger_mod) if pkg == "torch"
                else (jax_invariants, jax_ledger))
    bodies, served = _checker_served()
    L = led.WriteLedger()
    for k, v in bodies.items():
        L.ack(L.intent("put", k, led.digest(v), len(v)))
    L.ack(L.intent("delete", "ghost"))
    rep = inv.check_acknowledged_writes(lambda k: served[k], L, seed=777,
                                        retry_5xx_s=0.0)
    assert not rep.ok() and len(rep.failures) == 3
    assert "MTPU_CHAOS_SEED=777" in rep.summary()
    with pytest.raises(AssertionError, match="MTPU_CHAOS_SEED=777"):
        rep.assert_ok()
    served.update({"lost": (200, b"xx"), "torn": (200, b"yyyy"), "ghost": (404, b"")})
    inv.check_acknowledged_writes(lambda k: served[k], L, seed=777).assert_ok()


def test_checker_reports_equal_to_jax():
    """The same ledger served the same answers gives the same report in
    both packages: acknowledged, cross-node and heal convergence."""
    reports = {}
    for name, inv, led in (("torch", invariants, ledger_mod),
                           ("jax", jax_invariants, jax_ledger)):
        r = random.Random(9)
        L = led.WriteLedger()
        store = {}
        for _ in range(80):
            key = f"k{r.randrange(10)}"
            if r.random() < 0.2:
                e = L.intent("delete", key)
                if r.random() < 0.8:
                    L.ack(e)
                    store.pop(key, None)
            else:
                body = r.randbytes(r.randrange(1, 64))
                e = L.intent("put", key, led.digest(body), len(body))
                if r.random() < 0.8:
                    L.ack(e)
                    store[key] = body
        store["k3"] = b"torn"
        store.pop("k5", None)

        def get(key, store=store):
            return (200, store[key]) if key in store else (404, b"")

        heal_items = [{"bucket": "b", "object": "o1", "after": [{"state": "ok"}]},
                      {"bucket": "b", "object": "o2", "after": [{"state": "missing"}]},
                      {"bucket": "b", "object": "o3", "purged": True},
                      {"bucket": "b", "object": "o4", "error": "locked"}]
        reports[name] = [
            (rep.ok(), rep.checked, rep.failures) for rep in (
                inv.check_acknowledged_writes(get, L, seed=5, retry_5xx_s=0.0),
                inv.check_cross_node_agreement([get, get], L, seed=5, retry_5xx_s=0.0),
                inv.check_heal_convergence(
                    lambda: {"drivesOnline": 12, "drivesOffline": 0},
                    lambda: heal_items, 12, seed=5, heal_attempts=1))]
    assert reports["torch"] == reports["jax"]


def test_slo_quantile_and_delta():
    fam = "minio_tpu_s3_requests_latency_seconds"
    before = "\n".join([
        f'{fam}_bucket{{api="PutObject",le="0.1"}} 0',
        f'{fam}_bucket{{api="PutObject",le="1"}} 0',
        f'{fam}_bucket{{api="PutObject",le="+Inf"}} 0',
        'minio_tpu_s3_requests_total{api="PutObject"} 0',
        'minio_tpu_s3_requests_5xx_errors_total{api="PutObject"} 0'])
    after = "\n".join([
        f'{fam}_bucket{{api="PutObject",le="0.1"}} 98',
        f'{fam}_bucket{{api="PutObject",le="1"}} 100',
        f'{fam}_bucket{{api="PutObject",le="+Inf"}} 100',
        'minio_tpu_s3_requests_total{api="PutObject"} 100',
        'minio_tpu_s3_requests_5xx_errors_total{api="PutObject"} 3'])
    win = invariants.delta(invariants.parse_exposition(after),
                           invariants.parse_exposition(before))
    p99 = invariants.histogram_quantile(win, fam, 0.99, {"api": "PutObject"})
    assert 0.1 < p99 <= 1.0
    invariants.check_slos(win, seed=SEED, p99_bound=1.0, error_rate_bound=0.05,
                          apis=("PutObject",)).assert_ok()
    rep = invariants.check_slos(win, seed=SEED, p99_bound=0.05,
                                error_rate_bound=0.01, apis=("PutObject",))
    assert len(rep.failures) == 2
    assert [str(f) for f in rep.failures] == jax_invariants.check_slos(
        win, seed=SEED, p99_bound=0.05, error_rate_bound=0.01,
        apis=("PutObject",)).failures
    inf_win = invariants.parse_exposition(f'{fam}_bucket{{api="PutObject",le="+Inf"}} 7')
    assert invariants.histogram_quantile(inf_win, fam, 0.99) == float("inf")


def test_exposition_helpers_equal_on_a_port_scrape(tmp_path):
    """A port server's scrape, plain and OpenMetrics, parses, folds and
    sums the same in both packages."""
    from minio_tpu_torch.chaos.workload import S3Client
    from minio_tpu_torch.s3.server import build_server

    srv = build_server([str(tmp_path / f"d{i}") for i in range(4)], "scrapeadmin",
                       "scrapesecret1", device="cpu").start()
    try:
        c = S3Client(srv.url, "scrapeadmin", "scrapesecret1")
        assert c.put("/scrapebkt").status_code == 200
        for i in range(6):
            assert c.put(f"/scrapebkt/k{i}", data=b"p" * (1000 * i + 1)).status_code == 200
            assert c.get(f"/scrapebkt/k{i}").status_code == 200
        assert c.get("/scrapebkt/missing").status_code == 404
        before = c.get("/minio/v2/metrics/cluster").content.decode()
        for i in range(4):
            c.get(f"/scrapebkt/k{i}")
        texts = [c.get("/minio/v2/metrics/cluster").content.decode(),
                 c.get("/minio/v2/metrics/cluster",
                       headers={"Accept": "application/openmetrics-text"}).content.decode()]
    finally:
        srv.close()
    fam = "minio_tpu_s3_requests_latency_seconds"
    for text in texts:
        ours, theirs = invariants.parse_exposition(text), jax_invariants.parse_exposition(text)
        assert ours == theirs and ours
        wins = (invariants.delta(ours, invariants.parse_exposition(before)),
                jax_invariants.delta(theirs, jax_invariants.parse_exposition(before)))
        assert wins[0] == wins[1]
        for win in (ours, wins[0]):
            for q in (0.5, 0.9, 0.99):
                for f in (None, {"api": "GetObject"}, {"api": "PutObject"}):
                    assert invariants.histogram_quantile(win, fam, q, f) == \
                        jax_invariants.histogram_quantile(win, fam, q, f)
            for name in ("minio_tpu_s3_requests_total",
                         "minio_tpu_s3_requests_4xx_errors_total",
                         "minio_tpu_drive_latency_seconds_count"):
                assert invariants.counter_sum(win, name) == \
                    jax_invariants.counter_sum(win, name)
        assert invariants.counter_sum(wins[0], "minio_tpu_s3_requests_total",
                                      {"api": "GetObject"}) >= 4


class _FakeS3:
    """An in-memory S3 with the workload's client surface, answering in
    order, so two packages' workers see the same answers."""

    def __init__(self):
        self.objects: dict[str, bytes] = {}
        self.uploads: dict[str, dict] = {}
        self.calls: list[tuple] = []

    def _r(self, code, content=b"", etag=""):
        import types

        return types.SimpleNamespace(status_code=code, content=content,
                                     headers={"ETag": etag})

    def put(self, path, data=b"", query=None, timeout=None):
        self.calls.append(("PUT", path, len(data), tuple(sorted((query or {}).items()))))
        if query and "uploadId" in query:
            self.uploads[query["uploadId"]][int(query["partNumber"])] = data
            return self._r(200, etag=f"p{query['partNumber']}")
        self.objects[path] = bytes(data)
        return self._r(200, etag="e")

    def get(self, path, query=None, timeout=None):
        self.calls.append(("GET", path, tuple(sorted((query or {}).items()))))
        if query:
            return self._r(200, b"<ListBucketResult/>")
        if path in self.objects:
            return self._r(200, self.objects[path])
        return self._r(404)

    def delete(self, path, timeout=None):
        self.calls.append(("DELETE", path))
        self.objects.pop(path, None)
        return self._r(204)

    def post(self, path, data=b"", query=None, timeout=None):
        self.calls.append(("POST", path, len(data), tuple(sorted((query or {}).items()))))
        if query and "uploads" in query:
            uid = f"u{len(self.uploads)}"
            self.uploads[uid] = {}
            return self._r(200, f"<UploadId>{uid}</UploadId>".encode())
        parts = self.uploads.pop(query["uploadId"])
        self.objects[path] = b"".join(parts[n] for n in sorted(parts))
        return self._r(200, b"<CompleteMultipartUploadResult/>")


@pytest.mark.parametrize("wid", [0, 3])
def test_workload_op_stream_equal_to_jax(wid):
    """One worker of each package's fleet, from one seed, against the
    same in-memory server: the same requests, ledger rows and stats."""
    out = {}
    for name, mod, led in (("torch", MixedWorkload, ledger_mod),
                           ("jax", jax_workload.MixedWorkload, jax_ledger)):
        fake = _FakeS3()
        L = led.WriteLedger()
        wl = mod(lambda f=fake: f, L, "bkt", seed=SEED, workers=1,
                 mp_size=64 << 10)
        n = {"calls": 0}

        def stop_after(orig, wl=wl, n=n):
            def call(*a, **kw):
                n["calls"] += 1
                if n["calls"] >= 150:
                    wl._stop.set()
                return orig(*a, **kw)
            return call

        for verb in ("put", "get", "delete", "post"):
            setattr(fake, verb, stop_after(getattr(fake, verb)))
        wl._worker(wid)
        out[name] = (fake.calls,
                     [(e.seq, e.op, e.key, e.sha256, e.size, e.acked) for e in L.entries()],
                     wl.stats.ops, wl.stats.errors, wl.stats.violations, wl.stats.codes)
    assert out["torch"] == out["jax"]
    assert not out["torch"][4] and len(out["torch"][1]) > 20


# ---------------------------------------------------------------------------
# 3. teardown: clear_all releases every plane
# ---------------------------------------------------------------------------

def test_clear_all_releases_hangs_planes_and_breakers():
    from minio_tpu_torch.replication import client as repl_client

    nd = naughty_mod.NaughtyDisk(object())
    nd.per_method_delay["read_version"] = naughty_mod.HANG
    woke = threading.Event()

    def parked():
        nd._maybe_delay("read_version")
        woke.set()

    t = threading.Thread(target=parked)
    t.start()
    c = rpc_mod.RestClient("127.0.0.1", 1, "secret", timeout=0.5)
    tb = repl_client.breaker_for("chaos-test-target:1", "127.0.0.1", 1, False, "")
    try:
        assert not woke.wait(0.1)
        faultplane.install(seed=1).partition("leak", ["a:1"], ["b:2"])
        c.mark_offline()
        tb.mark_offline()
        assert c.breaker_state() == rpc_mod.BREAKER_OPEN
        assert chaos.anything_armed()
        cleared = chaos.clear_all()
        assert cleared["drive_faults"] >= 1
        assert cleared["net_plane"] == 1
        assert cleared["breakers_reset"] >= 2
        assert woke.wait(2.0), "clear_all did not release the HANG"
        assert faultplane.get() is None
        assert c.breaker_state() == rpc_mod.BREAKER_CLOSED
        assert tb.state() == rpc_mod.BREAKER_CLOSED
        assert not chaos.anything_armed()
        # A fault armed after the sweep blocks on a fresh event.
        nd.per_method_delay["read_version"] = naughty_mod.HANG
        t2 = threading.Thread(target=lambda: nd._maybe_delay("read_version"),
                              daemon=True)
        t2.start()
        t2.join(0.1)
        assert t2.is_alive(), "a HANG armed after the sweep must block again"
        nd.release.set()
        t2.join(2.0)
    finally:
        c.close()
        tb._probe_stop.set()
        nd.clear_faults()
        t.join(5.0)


# ---------------------------------------------------------------------------
# 4. the bounded composed storm on port node processes
# ---------------------------------------------------------------------------

def _storm_program(cl) -> schedule.ChaosProgram:
    """All three planes overlap: node 0's d1 hangs its reads and writes,
    node 0's d2 refuses its commits, node 0 cannot reach node 2, and node
    2 is SIGKILLed while all of that holds. The hang is released before
    the drive deadline, so a hung request waits at most its 2.5 s."""
    n0d1, n0d2 = str(cl.work / "n0" / "d1"), str(cl.work / "n0" / "d2")
    p = schedule.ChaosProgram(SEED)
    p.add(0.5, schedule.DRIVE_HANG, n0d1, method="read_version")
    p.add(0.6, schedule.DRIVE_HANG, n0d1, method="create_file")
    p.add(1.0, schedule.DRIVE_DELAY, n0d2, method="rename_data", error="faulty")
    p.add(1.5, schedule.NET_ISOLATE, cl.node_name(2), name="asym",
          src=cl.node_name(0), dst=cl.node_name(2))
    p.add(2.5, schedule.KILL, "2")
    p.add(3.0, schedule.DRIVE_CLEAR, n0d1)
    p.add(5.5, schedule.RESTART, "2")
    p.add(6.5, schedule.DRIVE_CLEAR, n0d2)
    p.add(8.0, schedule.NET_HEAL, cl.node_name(2), name="asym")
    return p


def _actuators(cl) -> dict:
    def drive_fault(ev):
        doc = {"op": "drive", "endpoint": ev.target, "method": ev.params["method"]}
        if "error" in ev.params:
            doc["error"] = ev.params["error"]
        else:
            doc["delay"] = ev.params.get("delay", "hang")
        cl.fault(0, doc)

    return {
        schedule.DRIVE_HANG: drive_fault,
        schedule.DRIVE_DELAY: drive_fault,
        schedule.DRIVE_CLEAR: lambda ev: cl.fault(0, {"op": "drive_clear",
                                                      "endpoint": ev.target}),
        schedule.NET_ISOLATE: lambda ev: cl.fault(0, {
            "op": "isolate", "name": ev.params["name"],
            "src": ev.params["src"], "dst": ev.params["dst"]}),
        schedule.NET_HEAL: lambda ev: cl.fault(0, {"op": "heal",
                                                   "name": ev.params["name"]}),
        schedule.KILL: lambda ev: cl.kill9(int(ev.target)),
        schedule.RESTART: lambda ev: cl.start(int(ev.target)),
    }


@pytest.mark.chaos
def test_bounded_composed_storm(tmp_path):
    """One seed drives drive, network and process faults under a live
    mixed workload on three port node processes; afterwards nothing
    acknowledged is lost, nothing reads torn, every node serves the same
    bytes, the set heals to full redundancy, and node 0's SLO window
    holds the storm's traffic within its bounds."""
    from tests.torch_chaos_cluster import DRIVES_PER_NODE, N_NODES, Cluster

    # The sampler ticks fast enough for the ring to span the storm.
    cl = Cluster(tmp_path, extra_env={"MTPU_SLO_SAMPLE_S": "0.5"})
    try:
        for i in range(N_NODES):
            cl.start(i)
        for i in range(N_NODES):
            cl.wait_healthy(i)
        bucket = "chaosbkt"
        assert cl.client(0).put(f"/{bucket}").status_code == 200

        prog = _storm_program(cl)
        assert prog.schedule() == _storm_program(cl).schedule()
        lgr = ledger_mod.WriteLedger(path=str(tmp_path / "ledger.jsonl"))
        fleet = MixedWorkload(
            # The workload rides the two front doors that stay up.
            lambda _n=iter(range(10 ** 9)): cl.client(next(_n) % 2),
            lgr, bucket, seed=SEED, workers=4, mp_size=5 << 20, op_timeout=20.0)
        sched = schedule.ChaosScheduler(prog, _actuators(cl))
        t0 = time.monotonic()
        sched.start()
        try:
            fleet.run_for(10.0)
        finally:
            sched.stop()
            assert sched.join(60.0)
        storm_s = time.monotonic() - t0
        assert sched.errors() == [], (
            f"actuation errors {sched.errors()} — reproduce with "
            f"MTPU_CHAOS_SEED={SEED}")
        assert sched.applied() == prog.schedule()
        assert lgr.acked_count() >= 10, (
            f"storm too quiet: {lgr.describe()} after {storm_s:.0f}s "
            f"(ops {fleet.stats.describe()})")

        # Converge: every node serving, residual faults swept, drives back.
        for i in range(N_NODES):
            if cl.procs.get(i) is None:
                cl.start(i)
            cl.wait_healthy(i)
        for i in range(N_NODES):
            cl.fault(i, {"op": "clear_all"})
        cl.wait_drives_online(timeout=60)
        assert not fleet.stats.violations, (
            f"in-storm read violations {fleet.stats.violations[:5]} — "
            f"reproduce with MTPU_CHAOS_SEED={SEED}")

        def get_via(i):
            def get_fn(key):
                r = cl.client(i).get(f"/{bucket}/{key}")
                return r.status_code, (r.content if r.status_code == 200 else b"")
            return get_fn

        invariants.check_acknowledged_writes(get_via(0), lgr, seed=SEED).assert_ok()
        invariants.check_cross_node_agreement(
            [get_via(i) for i in range(N_NODES)], lgr, seed=SEED).assert_ok()
        invariants.check_heal_convergence(
            lambda: cl.admin_info(0),
            lambda: [i for i in cl.deep_heal(0, bucket) if i.get("object")],
            want_drives=N_NODES * DRIVES_PER_NODE, seed=SEED,
            timeout=60).assert_ok()

        # The SLO invariant on node 0's own ring, over the storm, at the
        # JAX soak's bounds (tests/test_chaos.py): PUT and GET p99 within
        # 12 s, 5xx within half of the requests (a write below quorum
        # answers 503, as it must).
        c0 = cl.client(0)
        window_s = time.monotonic() - t0 + 5
        r = c0.get("/minio/admin/v3/slo/history", query={"seconds": str(window_s + 5)})
        assert r.status_code == 200, r.content[:300]
        window = invariants.window_from_history(json.loads(r.content)["history"], window_s)
        assert invariants.counter_sum(window, "minio_tpu_s3_requests_total") > 0
        invariants.check_slos(window, seed=SEED, p99_bound=12.0,
                              error_rate_bound=0.5).assert_ok()
        # The federated answer carries every node of the cluster.
        doc = json.loads(c0.get("/minio/admin/v3/slo").content)
        assert not doc["errors"]
        assert sorted(doc["nodes"]) == sorted(cl.node_name(i) for i in range(N_NODES))
        for state in doc["nodes"].values():
            assert set(state["slos"]) == {"put_latency_p99", "get_latency_p99",
                                          "s3_error_ratio", "tenant_latency_p99"}
        lgr.close()
    finally:
        cl.stop_all()
