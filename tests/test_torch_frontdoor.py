"""The port's multi-process front door (minio_tpu_torch/frontdoor/) held
against the JAX package's (minio_tpu/frontdoor/), on the CPU:

- the shm ring: a slot each package publishes is byte-equal, and so are
  the chunk framing and a flight-spool entry;
- lanes across packages: a JAX LaneClient against the port's
  LaneServer(device="cpu") and the port's LaneClient against the JAX
  LaneServer give digests, encodes, reconstructs and hot GETs byte-equal
  to the client's own single-process plane and tier, and to the other
  package's client; the oversize fallback and the recovery of an
  abandoned slot;
- WAL segments: a segment one package's worker leaves (`journal.w1.wal`)
  is folded by the other package's mount, never while its owner lives;
- a 2-worker port pool (router shard, --device cpu, shared lanes, QoS on)
  over 4 tmp drives, booted once for the module: accepts spread over both
  workers, 12 concurrent PUT/GETs byte-equal (bytes and ETags) to a
  single-process JAX server, a segment per worker on every drive, one
  SIGKILL with no acknowledged write lost and the worker respawned, and
  a SIGTERM drain after which every worker exited 0 and a single-process
  port server reads every key; and a pool under the reuseport shard
  policy, every worker on its own SO_REUSEPORT listener. Each pool test
  runs under its own alarm.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import signal
import threading
import time

import numpy as np
import pytest

from minio_tpu import dataplane as jdp
from minio_tpu import hottier as jhot
from minio_tpu.frontdoor import laneserver as jlane
from minio_tpu.frontdoor import shm as jshm
from minio_tpu_torch import dataplane as tdp
from minio_tpu_torch import hottier as thot
from minio_tpu_torch.frontdoor import laneserver as tlane
from minio_tpu_torch.frontdoor import shm as tshm
from tests.conftest import S3_ACCESS, S3_SECRET, free_port
from tests.s3client import SigV4Client

LANE = {"jax": jlane, "torch": tlane}
SHM = {"jax": jshm, "torch": tshm}
K, M = 8, 4


def _payload(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


@contextlib.contextmanager
def _deadline(seconds: float):
    """Fail the test (TimeoutError) if its body runs past `seconds`."""
    def expire(_sig, _frm):
        raise TimeoutError(f"test body passed its {seconds} s limit")

    prev = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, prev)


# ---------------------------------------------------------------------------
# The ring's bytes
# ---------------------------------------------------------------------------

def test_published_slot_is_byte_equal():
    chunks = [_payload(n, n) for n in (0, 1, 777, 4096)]
    images = {}
    for name, mod in SHM.items():
        ring = mod.Ring.create(nslots=3, slot_cap=16 << 10)
        try:
            req_len = mod.pack_chunks(ring.req_view(1), chunks)
            ring.publish(1, mod.OP_ENCODE, mod.FLAG_DIGESTS, 8, 4, 0x1234_5678_9ABC,
                         len(chunks), req_len, b"TRACE-ID-0123456", b"ak/bucket-xyz")
            ring.resp_view(1)[:5] = b"hello"
            assert ring.respond(1, 0x1234_5678_9ABC, 5, ok=True)
            images[name] = bytes(ring.buf[:ring._off(3)])
            assert mod.unpack_chunks(ring.req_view(1), len(chunks), req_len) == chunks
            assert ring.head(1)[0] == mod.DONE
        finally:
            ring.close()
            ring.unlink()
    assert images["torch"] == images["jax"]
    for attr in ("MAGIC", "FREE", "SUBMITTED", "DONE", "ERROR", "ABANDONED",
                 "OP_DIGEST", "OP_ENCODE", "OP_RECONSTRUCT", "OP_HOTGET",
                 "RING_OPS", "RING_FALLBACK_REASONS", "DEFAULT_SLOT_BYTES",
                 "DEFAULT_SLOTS_PER_WORKER", "FLIGHT_MAGIC"):
        assert getattr(tshm, attr) == getattr(jshm, attr), attr
    assert tlane._OP_NAMES == jlane._OP_NAMES


def test_flight_spool_entries_are_byte_equal_and_cross_read():
    snaps = [{"trace_id": f"T{i}", "api": "PutObject", "tenant": "a/b",
              "e2e_ns": i} for i in range(5)]
    images = {}
    for name, mod in SHM.items():
        spool = mod.FlightSpool.create(f"mtpu_t_fls_{name}_{os.getpid()}",
                                       nslots=4, cap=256)
        try:
            for s in snaps:
                spool.put(s)
            images[name] = bytes(spool.buf[:spool._off(4)])
            other = SHM["jax" if name == "torch" else "torch"]
            reader = other.FlightSpool.attach(spool.name)
            try:
                assert sorted(s["trace_id"] for s in reader.read_all()) == \
                    ["T1", "T2", "T3", "T4"]
            finally:
                reader.close()
        finally:
            spool.close()
            spool.unlink()
    assert images["torch"] == images["jax"]


# ---------------------------------------------------------------------------
# Lanes across packages
# ---------------------------------------------------------------------------

def _plane(pkg):
    return tdp.get_plane("cpu") if pkg == "torch" else jdp.get_plane()


def _tier(pkg):
    return thot.get_tier("cpu") if pkg == "torch" else jhot.get_tier()


def _served(pkg, op):
    return LANE[pkg]._RING_SERVED.labels(worker="0", op=op).value


def _fallbacks(pkg, reason):
    return LANE[pkg]._RING_FALLBACKS.labels(worker="1", reason=reason).value


@pytest.fixture
def planes(monkeypatch):
    monkeypatch.setenv("MTPU_HOTTIER", "1")
    monkeypatch.setenv("MTPU_HOTTIER_ADMIT_COOLDOWN_S", "0")
    for mod in (tdp, jdp, thot, jhot):
        mod.reset_global()
    yield
    for mod in (tdp, jdp, thot, jhot):
        mod.reset_global()


@contextlib.contextmanager
def _lanes(client_pkg, server_pkg, slot_cap=1 << 20, server=True):
    """A ring, a LaneServer of `server_pkg` (worker 0) over that package's
    own plane, and a LaneClient of `client_pkg` (worker 1 of 2)."""
    ring = SHM[server_pkg].Ring.create(nslots=8, slot_cap=slot_cap)
    srv = srv_ring = None
    if server:
        kw = {"device": "cpu"} if server_pkg == "torch" else {}
        srv_ring = SHM[server_pkg].Ring.attach(ring.name)
        srv = LANE[server_pkg].LaneServer(srv_ring, plane=_plane(server_pkg), **kw)
    kw = {"device": "cpu"} if client_pkg == "torch" else {}
    cl = LANE[client_pkg].LaneClient(SHM[client_pkg].Ring.attach(ring.name), 1, 2, **kw)
    try:
        yield ring, cl
    finally:
        if srv is not None:
            srv.stop()
            srv_ring.close()
        cl.close()
        ring.close()
        ring.unlink()


def _blocks(seed):
    sizes = (64 << 10, 40_001, 8 * 1000 + 3, 1)
    return [_payload(n, seed + i) for i, n in enumerate(sizes)]


def _encode(cl, pkg, blocks, digests):
    pend = cl.begin_encode(K, M, 64 << 10, blocks, with_digests=digests)
    rows, digs = pend.wait()
    return ([[bytes(c) for c in row] for row in rows],
            None if digs is None else [[bytes(d) for d in row] for row in digs])


def _reconstruct(cl, pkg, rows, lens, targets, digests):
    if pkg == "jax":
        pend = cl.begin_reconstruct(K, M, 64 << 10, rows, lens, targets,
                                    with_digests=digests)
    else:
        pend = cl.begin_reconstruct(K, M, rows, lens, targets, with_digests=digests)
    out, digs = pend.wait()
    return ([[bytes(c) for c in row] for row in out],
            None if digs is None else [[bytes(d) for d in row] for row in digs])


def _seed_hot(pkg, body):
    """Make (hb, hot) resident in `pkg`'s tier through its admit reader."""
    class Info:
        etag, size, mod_time, version_id = "e-hot", len(body), 42.5, ""

    mod = thot if pkg == "torch" else jhot
    tier = _tier(pkg)
    mod.set_reader(lambda b, o: (Info(), iter([body[:5000], body[5000:]])))
    try:
        for _ in range(2):
            tier.note_miss("hb", "hot", len(body))
        assert tier.drain(30) and tier.resident("hb", "hot"), tier.stats()
    finally:
        mod.set_reader(None)
    return ("", "e-hot", len(body), 42.5)


def _lane_answers(client_pkg, server_pkg, use_ring=True):
    """Digests, encodes (with and without digests), a heal-shaped
    reconstruct and hot GETs through the client; -> the answers."""
    blocks = _blocks(11)
    chunks = [b[:n] for b, n in zip(blocks, (65536, 1, 0, 513))]
    hot_body = _payload(300 << 10, 5)
    ident = _seed_hot(server_pkg, hot_body)
    with _lanes(client_pkg, server_pkg) as (_ring, cl):
        target = cl if use_ring else cl.local()
        out = {"digest": [bytes(d) for d in target.digest_chunks(chunks, 65536)]}
        out["encode"] = _encode(target, client_pkg, blocks, False)
        out["encode_digests"] = _encode(target, client_pkg, blocks, True)
        full = out["encode_digests"][0]
        lens = [len(b) for b in blocks]
        rows = [[c if i not in (0, 5, 9) else None for i, c in enumerate(row)]
                for row in full]
        out["reconstruct"] = _reconstruct(target, client_pkg, rows, lens, (0, 5, 9),
                                          True)
        assert [[row[i] for i in (0, 5, 9)] for row in full] == out["reconstruct"][0]
        if use_ring:
            got = cl.hot_get("hb", "hot", ident, 1000, 70_000)
            out["hot"] = bytes(got)
            out["hot_stale"] = cl.hot_get("hb", "hot", ident[:1] + ("e-old",)
                                          + ident[2:], 0, 10)
        else:
            out["hot"] = hot_body[1000:71_000]
            out["hot_stale"] = None
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [("jax", "torch"), ("torch", "jax")])
def test_lane_client_against_the_other_package_server(planes, client_pkg, server_pkg):
    before = {op: _served(server_pkg, op)
              for op in ("digest", "encode", "reconstruct", "hotget")}
    via_ring = _lane_answers(client_pkg, server_pkg)
    served = {op: _served(server_pkg, op) - v for op, v in before.items()}
    assert served == {"digest": 1, "encode": 2, "reconstruct": 1, "hotget": 1}
    # The same work on the client's own single-process plane.
    local = _lane_answers(client_pkg, server_pkg, use_ring=False)
    assert via_ring == local
    assert via_ring["hot_stale"] is None


def test_lane_answers_equal_across_packages(planes):
    answers = {c: _lane_answers(c, "torch" if c == "jax" else "jax")
               for c in ("jax", "torch")}
    assert answers["torch"] == answers["jax"]


def test_oversize_falls_back_to_the_local_plane(planes):
    chunks = [_payload(60_000, i) for i in range(4)]
    with _lanes("torch", "torch", slot_cap=64 << 10) as (_ring, cl):
        before = _fallbacks("torch", "oversize")
        got = cl.digest_chunks(chunks, 65536)
        assert _fallbacks("torch", "oversize") == before + 1
        assert [bytes(d) for d in got] == [bytes(d) for d in
                                           cl.local().digest_chunks(chunks, 65536)]


def test_abandoned_slot_recovers(planes, monkeypatch):
    monkeypatch.setenv("MTPU_FRONTDOOR_RING_TIMEOUT_S", "0.2")
    chunks = [_payload(1000, 1)]
    want = [bytes(d) for d in tdp.get_plane("cpu").digest_chunks(chunks, 1000)]
    with _lanes("torch", "torch", server=False) as (ring, cl):
        before = _fallbacks("torch", "timeout")
        assert [bytes(d) for d in cl.digest_chunks(chunks, 1000)] == want
        assert _fallbacks("torch", "timeout") == before + 1
        slot = cl._lo
        assert ring.state(slot) == tshm.ABANDONED
        # A client that abandoned a slot stays off the ring a while.
        before = _fallbacks("torch", "no_slot")
        assert [bytes(d) for d in cl.digest_chunks(chunks, 1000)] == want
        assert _fallbacks("torch", "no_slot") == before + 1
        # A lane server's boot frees what a dead predecessor left.
        srv = tlane.LaneServer(tshm.Ring.attach(ring.name), plane=_plane("torch"),
                               device="cpu")
        try:
            assert ring.state(slot) == tshm.FREE
            cl._degraded_until = 0.0
            served = _served("torch", "digest")
            assert [bytes(d) for d in cl.digest_chunks(chunks, 1000)] == want
            assert _served("torch", "digest") == served + 1
        finally:
            srv.stop()


# ---------------------------------------------------------------------------
# WAL segments across packages
# ---------------------------------------------------------------------------

def _drive(pkg, root):
    if pkg == "torch":
        from minio_tpu_torch.storage.local import LocalDrive
    else:
        from minio_tpu.storage.local import LocalDrive
    return LocalDrive(str(root))


@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_worker_segment_folds_across_packages(writer, reader, tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "1")
    root = tmp_path / "d0"
    # Worker 1 of a pool of 2 writes its segment, then dies uncleanly.
    monkeypatch.setenv("MTPU_FRONTDOOR_WORKERS", "2")
    monkeypatch.setenv("MTPU_FRONTDOOR_WORKER", "1")
    monkeypatch.setenv("MTPU_WAL_SEGMENT", "w1")
    d = _drive(writer, root)
    d.make_vol("bkt")
    data = {f"config/k{i}.mp": _payload(100 + i, i) for i in range(3)}
    for path, raw in data.items():
        d.write_all_async(".mtpu.sys", path, raw).result(timeout=30)
    seg = root / ".mtpu.sys" / "wal" / "journal.w1.wal"
    assert seg.stat().st_size > 8
    # Worker 0 of the other package mounts while worker 1 still lives: its
    # segment is left alone (the flock marks it live).
    monkeypatch.setenv("MTPU_FRONTDOOR_WORKER", "0")
    monkeypatch.setenv("MTPU_WAL_SEGMENT", "w0")
    live = _drive(reader, root)
    assert seg.stat().st_size > 8
    live.close_wal()
    d._wal.abandon()
    # Worker 1 is gone: the next mount folds its segment.
    again = _drive(reader, root)
    try:
        for path, raw in data.items():
            assert again.read_all(".mtpu.sys", path) == raw
        assert seg.stat().st_size <= 8
        assert (root / ".mtpu.sys" / "wal" / "journal.w0.wal").exists()
    finally:
        again.close_wal()


# ---------------------------------------------------------------------------
# A 2-worker port pool
# ---------------------------------------------------------------------------

class _Pool:
    def __init__(self, root):
        from minio_tpu_torch.frontdoor.supervisor import Supervisor

        self.drives = [str(root / f"p{i}") for i in range(4)]
        self.port = free_port()
        self.url = f"http://127.0.0.1:{self.port}"
        self.sup = Supervisor(
            self.drives, f"127.0.0.1:{self.port}", 2, shared_lanes=True,
            device="cpu", log_dir=str(root),
            env={"MTPU_ROOT_USER": S3_ACCESS, "MTPU_ROOT_PASSWORD": S3_SECRET,
                 "MTPU_QOS": "1", "MTPU_QOS_WEIGHTS": f"{S3_ACCESS}/fda=3,*=1",
                 "MTPU_FRONTDOOR_DRAIN_S": "20", "JAX_PLATFORMS": "cpu"})
        self.acked: dict[str, bytes] = {}
        self.root = root

    def client(self) -> SigV4Client:
        return SigV4Client(self.url, S3_ACCESS, S3_SECRET)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("fdpool")
    p = _Pool(root)
    with _deadline(120):
        p.sup.start()
        p.sup.wait_workers(90)
    yield p
    if p.sup.alive():
        p.sup.drain(timeout=30)


def _fresh_get(url, path):
    """GET on a connection of its own (the router rotates connections)."""
    cl = SigV4Client(url, S3_ACCESS, S3_SECRET)
    try:
        r = cl.request("GET", path)
        return r.status_code, r.headers.get("X-Mtpu-Worker"), r.content, \
            r.headers.get("ETag")
    finally:
        cl.session.close()


def _worker_scrapes(url) -> dict:
    """Each worker's node scrape, over new connections until every worker
    answered one."""
    from tests.test_observability import parse_exposition

    out = {}
    for _ in range(8):
        cl = SigV4Client(url, S3_ACCESS, S3_SECRET)
        try:
            r = cl.request("GET", "/minio/v2/metrics/node")
            out[r.headers["X-Mtpu-Worker"]] = parse_exposition(r.text)[1]
        finally:
            cl.session.close()
        if len(out) == 2:
            break
    return out


def test_pool_serves_on_both_workers_like_a_single_jax_server(pool, tmp_path):
    from tests.torch_atrest import JaxServer

    objs = {f"o{i:02d}": _payload(int(s), 100 + i) for i, s in
            enumerate(np.linspace(1 << 10, 120 << 10, 12))}
    jax_srv = JaxServer([str(tmp_path / f"j{i}") for i in range(4)])
    try:
        with _deadline(120):
            workers = set()
            for url, bucket in ((pool.url, "fda"), (pool.url, "fdb"), (jax_srv.url, "fda")):
                assert SigV4Client(url, S3_ACCESS, S3_SECRET).request(
                    "PUT", f"/{bucket}").status_code == 200
            results: dict = {}

            def put_get(url, bucket, key, body):
                cl = SigV4Client(url, S3_ACCESS, S3_SECRET)
                try:
                    r = cl.request("PUT", f"/{bucket}/{key}", data=body)
                    assert r.status_code == 200, r.text
                    g = cl.request("GET", f"/{bucket}/{key}")
                    results[(url, bucket, key)] = (g.content, g.headers.get("ETag"),
                                                   r.headers.get("ETag"))
                    for resp in (r, g):
                        if url == pool.url:
                            workers.add(resp.headers.get("X-Mtpu-Worker"))
                finally:
                    cl.session.close()

            jobs = [(pool.url, "fda" if i % 2 else "fdb", k, v)
                    for i, (k, v) in enumerate(objs.items())]
            jobs += [(jax_srv.url, "fda", k, v) for k, v in objs.items()]
            threads = [threading.Thread(target=put_get, args=j) for j in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            assert len(results) == 24
            for i, (k, v) in enumerate(objs.items()):
                mine = results[(pool.url, "fda" if i % 2 else "fdb", k)]
                oracle = results[(jax_srv.url, "fda", k)]
                assert mine == oracle and mine[0] == v
                assert mine[1] == f'"{hashlib.md5(v).hexdigest()}"'
                pool.acked[f"/{'fda' if i % 2 else 'fdb'}/{k}"] = v
            # Accepts spread: new connections alternate over the workers.
            seen = {_fresh_get(pool.url, "/fda/o01")[1] for _ in range(4)}
            assert workers | seen == {"0", "1"}
            # Worker 1's lane work rode the ring into worker 0's plane.
            scrapes = _worker_scrapes(pool.url)
            submits = sum(v for n, lbl, v in scrapes["1"]
                          if n == "minio_tpu_frontdoor_ring_submits_total")
            served = sum(v for n, lbl, v in scrapes["0"]
                         if n == "minio_tpu_frontdoor_ring_served_total")
            assert submits > 0 and served > 0, (submits, served)
    finally:
        jax_srv.close()


def test_pool_keeps_a_wal_segment_per_worker(pool):
    for d in pool.drives:
        names = set(os.listdir(os.path.join(d, ".mtpu.sys", "wal")))
        assert {"journal.w0.wal", "journal.w1.wal"} <= names, names


def test_pool_sigkill_loses_no_acknowledged_write(pool):
    from minio_tpu_torch.frontdoor import supervisor

    respawns = supervisor._RESPAWNS.labels(worker="1").value
    old_pid = pool.sup.pid(1)
    bodies = {f"/fdb/k{i:02d}": _payload(2000 + 977 * i, 300 + i) for i in range(16)}
    acked, lock = {}, threading.Lock()

    def put(key, body):
        cl = SigV4Client(pool.url, S3_ACCESS, S3_SECRET)
        try:
            for _ in range(3):   # a PUT cut by the kill is retried, as clients do
                try:
                    r = cl.request("PUT", key, data=body)
                except OSError:
                    continue
                if r.status_code == 200:
                    with lock:
                        acked[key] = body
                    return
        finally:
            cl.session.close()

    with _deadline(150):
        threads = [threading.Thread(target=put, args=kv) for kv in bodies.items()]
        for i, t in enumerate(threads):
            t.start()
            if i == 6:
                pool.sup.kill_worker(1)
        for t in threads:
            t.join()
        # Back to 2: the respawn runs and has joined the router (the dead
        # worker left the rotation when the supervisor saw it die).
        while (pool.sup.pid(1) in (None, old_pid) or len(pool.sup.alive()) < 2
               or len(pool.sup.router.workers_connected()) < 2):
            time.sleep(0.1)
        assert supervisor._RESPAWNS.labels(worker="1").value == respawns + 1
        assert len(acked) >= 8
        pool.acked.update(acked)
        for key, body in acked.items():
            status, _w, data, _e = _fresh_get(pool.url, key)
            assert status == 200 and data == body, key


def test_pool_drains_and_a_single_server_reads_every_key(pool):
    from minio_tpu_torch.s3.server import build_server

    with _deadline(120):
        pool.sup.drain(timeout=30)
        assert [p.returncode for p in pool.sup.procs.values()] == [0, 0]
        srv = build_server(pool.drives, S3_ACCESS, S3_SECRET, device="cpu",
                           enable_mrf=False).start()
        try:
            cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
            assert pool.acked
            for key, body in pool.acked.items():
                r = cl.request("GET", key)
                assert r.status_code == 200 and r.content == body, key
                assert r.headers.get("X-Mtpu-Worker") is None
        finally:
            srv.close()
            for d in srv.obj.all_drives():
                from minio_tpu_torch.storage import healthcheck

                healthcheck.unwrap(d).close_wal()


def test_reuseport_pool_listens_in_every_worker(tmp_path, monkeypatch):
    """Under MTPU_FRONTDOOR_SHARD=reuseport every worker serves the
    address from its own SO_REUSEPORT listener (S3Server.serve_socket)."""
    from minio_tpu_torch.frontdoor import listener
    from minio_tpu_torch.frontdoor.supervisor import Supervisor

    if not listener.supports_reuseport():
        pytest.skip("this kernel refuses SO_REUSEPORT")
    monkeypatch.setenv("MTPU_FRONTDOOR_SHARD", "reuseport")
    port = free_port()
    sup = Supervisor([str(tmp_path / f"r{i}") for i in range(4)], f"127.0.0.1:{port}",
                     2, shared_lanes=False, device="cpu", log_dir=str(tmp_path),
                     env={"MTPU_ROOT_USER": S3_ACCESS, "MTPU_ROOT_PASSWORD": S3_SECRET})
    try:
        with _deadline(120):
            sup.start()
            assert sup.router is None
            log1 = tmp_path / "worker1.log"
            while not (log1.exists() and "serving" in log1.read_text()):
                time.sleep(0.1)
            url = f"http://127.0.0.1:{port}"
            cl = SigV4Client(url, S3_ACCESS, S3_SECRET)
            assert cl.request("PUT", "/rpbkt").status_code == 200
            body = _payload(40_000, 7)
            assert cl.request("PUT", "/rpbkt/k", data=body).status_code == 200
            cl.session.close()
            for _ in range(4):
                status, worker, data, _etag = _fresh_get(url, "/rpbkt/k")
                assert status == 200 and data == body and worker in ("0", "1")
    finally:
        sup.drain(timeout=30)
    assert [p.returncode for p in sup.procs.values()] == [0, 0]
