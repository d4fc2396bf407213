"""dsync and the namespace lock of the port (minio_tpu_torch/dist/dsync.py,
dist/nslock.py) against the JAX package's, the JAX tests/test_dsync.py
cases over a mixed fabric: five lock servers alternating between the two
packages (JAX, port, JAX, port, JAX), each reached through a RemoteLocker
of the package under test. A port DRWMutex gets write quorum (3 of 5)
over the mix, coexists with readers as the JAX one does, tolerates a
minority of lockers down and fails on a majority; port and JAX mutexes
contending for one resource leave exactly one holder at every moment.
Every wait has a deadline."""

import threading
import time

import pytest

from tests import torch_dist as td
from tests.torch_dist import fast_clients  # noqa: F401 - the fixture

SERVER_PKGS = ("jax", "torch", "jax", "torch", "jax")


@pytest.fixture()
def mixed(fast_clients):
    """The five servers and, per package, a RemoteLocker on each."""
    servers = [td.node_server(pkg, {})[0] for pkg in SERVER_PKGS]
    clients = {pkg: [td.client(pkg, s.port, timeout=2.0) for s in servers]
               for pkg in ("jax", "torch")}
    lockers = {pkg: [td.PKG[pkg].dsync.RemoteLocker(c) for c in cs]
               for pkg, cs in clients.items()}
    yield servers, clients, lockers
    for cs in clients.values():
        for c in cs:
            c.close()
    for s in servers:
        try:
            s.close()
        except Exception:  # noqa: BLE001 - closed by the test already
            pass


def _down(servers, clients, idx):
    for i in idx:
        servers[i].close()
        for cs in clients.values():
            cs[i].close()
            cs[i].mark_offline()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_local_locker_semantics_equal(pkg, monkeypatch):
    m = td.PKG[pkg].dsync
    lk, A = m.LocalLocker(), m.LockArgs
    w, r1, r2 = A("u1", ["res"], "me"), A("u2", ["res"], "me", True), A("u3", ["res"], "me", True)
    got = [lk.lock(w), lk.rlock(r1), lk.unlock(w), lk.rlock(r1), lk.rlock(r2),
           lk.lock(w), lk.runlock(r1), lk.runlock(r2), lk.lock(w),
           lk.lock(A("u4", ["res", "b"], "me")), lk.lock(A("u5", ["b"], "me"))]
    assert got == [True, False, True, True, True, False, True, True, True, False, True]
    assert sorted(lk.dump()) == ["b", "res"]
    monkeypatch.setattr(m, "LOCK_STALE_AFTER", 0.05)
    time.sleep(0.1)
    assert lk.lock(A("live", ["res"], "me"))   # the dead holder is reaped


def test_port_mutex_quorum_over_mixed_lockers(mixed):
    _servers, _clients, lockers = mixed
    M = td.torch_dsync.DRWMutex
    mx = M(["bucket/obj"], lockers["torch"])
    assert mx.get_lock(timeout=2.0)
    # Competitors of either package fail while it is held.
    assert not M(["bucket/obj"], lockers["torch"]).get_lock(timeout=0.4)
    jmx = td.jax_dsync.DRWMutex(["bucket/obj"], lockers["jax"])
    assert not jmx.get_lock(timeout=0.4)
    jmx.unlock()
    mx.unlock()
    mx2 = M(["bucket/obj"], lockers["torch"])
    assert mx2.get_lock(timeout=2.0)
    mx2.unlock()


def test_readers_coexist_writer_excluded(mixed):
    _servers, _clients, lockers = mixed
    M = td.torch_dsync.DRWMutex
    r1 = M(["res"], lockers["torch"])
    r2 = td.jax_dsync.DRWMutex(["res"], lockers["jax"])
    w = M(["res"], lockers["torch"])
    assert r1.get_rlock(timeout=2.0) and r2.get_rlock(timeout=2.0)
    assert not w.get_lock(timeout=0.4)
    r1.unlock()
    r2.unlock()
    assert w.get_lock(timeout=2.0)
    w.unlock()


def test_tolerates_minority_down_fails_on_majority(mixed):
    servers, clients, lockers = mixed
    M = td.torch_dsync.DRWMutex
    _down(servers, clients, [1, 2])       # one server of each package
    mx = M(["res"], lockers["torch"])
    assert mx.get_lock(timeout=3.0)
    mx.unlock()
    _down(servers, clients, [3])
    mx = M(["res"], lockers["torch"])
    assert not mx.get_lock(timeout=0.6)
    mx.unlock()


def test_refresh_keeps_lock_alive_and_loss_is_seen(mixed):
    servers, clients, lockers = mixed
    lost = []
    mx = td.torch_dsync.DRWMutex(["res"], lockers["torch"], refresh_interval=0.05,
                                 on_lost=lambda: lost.append(1))
    assert mx.get_lock(timeout=2.0)
    time.sleep(0.3)
    assert mx.held and not lost
    _down(servers, clients, [0, 1, 2])    # refresh quorum gone
    deadline = time.monotonic() + 5
    while mx.held and time.monotonic() < deadline:
        time.sleep(0.02)
    assert not mx.held and lost == [1]
    mx.unlock()


def test_competing_writers_one_winner(mixed):
    """Port and JAX mutexes contending for one resource: one holder at
    every moment, and every contender gets its turn."""
    _servers, _clients, lockers = mixed
    holders, overlap = [], []
    active = threading.Semaphore(1)

    def contender(i):
        pkg = ("torch", "jax")[i % 2]
        mx = td.PKG[pkg].dsync.DRWMutex(["hot"], lockers[pkg])
        if not mx.get_lock(timeout=20.0):
            mx.unlock()
            return
        if not active.acquire(blocking=False):
            overlap.append(i)
        else:
            holders.append(i)
            time.sleep(0.02)
            active.release()
        mx.unlock()

    threads = [threading.Thread(target=contender, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not overlap
    assert sorted(holders) == list(range(6))


def test_namespace_lock_distributed_and_local(mixed):
    _servers, _clients, lockers = mixed
    NS = td.torch_nslock.NamespaceLockMap
    ns = NS(distributed=True, lockers=lockers["torch"], owner="n1:9000")
    with ns.lock("bkt", "obj") as lease:
        assert lease.held
        ns2 = td.jax_nslock.NamespaceLockMap(distributed=True, lockers=lockers["jax"])
        with pytest.raises(Exception) as ei:
            with ns2.lock("bkt", "obj", timeout=0.3):
                pass
        assert type(ei.value).__name__ == "OperationTimedOut"
    with ns.lock("bkt", "obj", timeout=2.0):
        pass
    local = NS()
    with local.lock("bkt", "obj"):
        with pytest.raises(td.torch_nslock.se.OperationTimedOut):
            with local.lock("bkt", "obj", timeout=0.1):
                pass
    with local.lock("bkt", "obj", readonly=True), \
            local.lock("bkt", "obj", readonly=True, timeout=0.5):
        pass
    assert not local._table
