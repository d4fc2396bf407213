"""Drive resilience in the port (minio_tpu_torch/storage/healthcheck.py,
idcheck.py, erasure/metadata.py deadlines, hedged shard reads), the
applicable cases of the JAX package's tests/test_drive_hang.py on 12
drives at EC 8+4 with 64 KiB blocks.

One hung drive must not wedge the data path: PUT, GET and listing finish
at quorum within a bounded time, the drive walks ONLINE -> FAULTY ->
OFFLINE, and the background probe brings it back and hands it to the
auto-healer. The hang is a wrapper around the drive (`_Stall`) whose
chosen calls block on an event; the deadlines are tight DynamicTimeouts,
so no test waits out a real multi-second deadline."""

import hashlib
import io
import threading
import time

import numpy as np
import pytest

from minio_tpu_torch import obs
from minio_tpu_torch.erasure.metadata import hash_order, parallel_map
from minio_tpu_torch.erasure.objects import ErasureObjects
from minio_tpu_torch.storage import healthcheck as hcmod
from minio_tpu_torch.storage.healthcheck import HealthChecker
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors as se

D = 1.0          # test deadline of every class (seconds)
BOUND = 4.5      # completion bound with one hung drive
TIGHT = {"meta": (D, 0.1), "data": (D, 0.1), "walk": (D, 0.1)}
BS = 64 << 10


class _Stall:
    """A drive whose calls named in `hang` block until `release` is set,
    and whose shard streams sleep `chunk_delay` in every read."""

    def __init__(self, inner):
        self.inner = inner
        self.hang: set[str] = set()
        self.chunk_delay = 0.0
        self.release = threading.Event()
        self.calls = 0

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        if not callable(fn) or name.startswith("_"):
            return fn

        def wrapped(*a, **kw):
            self.calls += 1
            if name in self.hang:
                self.release.wait()
            out = fn(*a, **kw)
            if name == "read_file_stream" and self.chunk_delay:
                return _SlowStream(out, self.chunk_delay)
            return out

        return wrapped


class _SlowStream:
    def __init__(self, f, delay):
        self.f, self.delay = f, delay

    def read(self, *a):
        time.sleep(self.delay)
        return self.f.read(*a)

    def __getattr__(self, name):
        return getattr(self.f, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.f.close()


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _build_set(tmp_path, probe_interval=60.0, offline_after=2, on_restore=None,
               health=True):
    """12 drives, EC 8+4: LocalDrive <- _Stall <- HealthChecker."""
    stalls = [_Stall(LocalDrive(str(tmp_path / f"d{i}"))) for i in range(12)]
    if health:
        drives = [HealthChecker(st, deadlines=TIGHT, probe_interval=probe_interval,
                                offline_after=offline_after, on_restore=on_restore)
                  for st in stalls]
    else:
        drives = list(stalls)
    es = ErasureObjects(drives, parity=4, block_size=BS, device="cpu")
    es.make_bucket("bkt")
    return es, stalls, drives


def _teardown(es, stalls):
    for st in stalls:
        st.hang.clear()
        st.chunk_delay = 0.0
        st.release.set()
    es.close()
    for st in stalls:
        st.inner.close_wal()


def _wait_for(cond, timeout=8.0, what="condition"):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _drive_of_shard(es, obj, shard_index=1):
    """Physical drive index holding 1-based shard `shard_index` of obj."""
    return hash_order(f"bkt/{obj}", es.n).index(shard_index)


def _get(es, key):
    _info, it = es.get_object("bkt", key)
    return b"".join(bytes(c) for c in it)


# ---------------------------------------------------------------------------
# parallel_map deadlines
# ---------------------------------------------------------------------------

def test_parallel_map_deadline_converts_stragglers():
    release = threading.Event()

    def hung():
        release.wait()
        return "late"

    def boom():
        raise se.FaultyDisk("dead")

    try:
        t0 = time.monotonic()
        results = parallel_map([lambda: "ok", hung, boom], deadline=0.3)
        assert time.monotonic() - t0 < 1.5
        assert results[0] == "ok"
        assert isinstance(results[1], se.OperationTimedOut)
        assert isinstance(results[2], se.FaultyDisk)
        # A straggler finishing later never overwrites its slot.
        release.set()
        time.sleep(0.2)
        assert isinstance(results[1], se.OperationTimedOut)
    finally:
        release.set()


def test_parallel_map_deadline_accounts_leaked_worker():
    from minio_tpu_torch.erasure.metadata import _HUNG_WORKERS, _shared_pool

    before = _HUNG_WORKERS.labels().value
    cap_before = _shared_pool()._max_workers
    release = threading.Event()
    try:
        results = parallel_map([release.wait, lambda: 1], deadline=0.2)
        assert isinstance(results[0], se.OperationTimedOut)
        assert results[1] == 1
        assert _HUNG_WORKERS.labels().value > before
        assert _shared_pool()._max_workers > cap_before
    finally:
        release.set()
    _wait_for(lambda: _shared_pool()._max_workers == cap_before,
              what="the lent worker given back")


def test_parallel_map_deadline_counts_from_the_closure_start():
    """A closure that queued behind a saturated pool past the fan-out's
    deadline, then ran for less than the deadline, is no timeout: the
    queue is the pool's, not the drive's. Its wait in the queue is bounded
    (twice the deadline), and so is its run after it starts."""
    from minio_tpu_torch.erasure.metadata import _shared_pool

    deadline = 1.0
    pool = _shared_pool()
    hold = threading.Event()
    busy = threading.Semaphore(0)

    def blocker():
        busy.release()
        hold.wait()

    blockers = [pool.submit(blocker) for _ in range(pool._max_workers)]
    try:
        for _ in blockers:
            assert busy.acquire(timeout=10), "the pool never filled"
        t0 = time.monotonic()

        def drive_call():
            # Runs 0.8 deadlines from a start 1.5 deadlines in: it ends
            # past the old whole-fan-out limit (2 deadlines from t0), well
            # inside one deadline from its own start.
            time.sleep(max(0.0, t0 + 2.3 * deadline - time.monotonic()))
            return "ok"

        box = {}
        caller = threading.Thread(
            target=lambda: box.setdefault("r", parallel_map([drive_call] * 2,
                                                            deadline=deadline)))
        caller.start()
        time.sleep(1.5 * deadline)
        hold.set()
        caller.join(timeout=10)
        assert box["r"] == ["ok", "ok"]
    finally:
        hold.set()
        for f in blockers:
            f.result(timeout=10)


# ---------------------------------------------------------------------------
# the disk-ID check
# ---------------------------------------------------------------------------

def test_idcheck_caches_failed_probe():
    from minio_tpu_torch.storage.idcheck import DiskIDChecker

    class DeadDrive:
        probes = 0

        def endpoint(self):
            return "dead:1"

        def get_disk_id(self):
            DeadDrive.probes += 1
            raise se.FaultyDisk("unplugged")

        def make_vol(self, v):
            return None

    w = DiskIDChecker(DeadDrive(), "uuid-A", interval=0.3)
    with pytest.raises(se.DiskNotFound):
        w.make_vol("v")
    assert DeadDrive.probes == 1
    with pytest.raises(se.DiskNotFound):
        w.make_vol("v")    # the cached failure answers, no I/O
    assert DeadDrive.probes == 1
    time.sleep(0.35)
    with pytest.raises(se.DiskNotFound):
        w.make_vol("v")
    assert DeadDrive.probes == 2


def test_a_swapped_drive_answers_disk_not_found(tmp_path):
    """Through ErasureSets every drive is bound to its slot's UUID: a drive
    whose format.json names another slot answers DiskNotFound, and the
    set still serves at quorum."""
    import json
    import os

    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.storage import idcheck

    paths = [str(tmp_path / f"d{i}") for i in range(12)]
    s = ErasureSets([LocalDrive(p) for p in paths], parity=4, block_size=BS,
                    device="cpu")
    try:
        s.make_bucket("bkt")
        data = _payload(200 << 10, 1)
        s.put_object("bkt", "k", io.BytesIO(data), len(data))
        victim = s.drives[3]
        assert isinstance(victim.inner, idcheck.DiskIDChecker)
        fp = os.path.join(paths[3], ".mtpu.sys", "format.json")
        doc = json.load(open(fp))
        doc["erasure"]["this"] = "00000000-0000-0000-0000-00000000dead"
        json.dump(doc, open(fp, "w"))
        victim.inner._last_ok = 0.0
        with pytest.raises(se.DiskNotFound):
            victim.stat_vol("bkt")
        _info, it = s.get_object("bkt", "k")
        assert b"".join(bytes(c) for c in it) == data
    finally:
        s.close()
        for d in s.drives:
            d.close_wal()


# ---------------------------------------------------------------------------
# one hung drive: every path bounded and at quorum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["put-stream", "put-inline", "get-meta",
                                  "get-data", "list"])
def test_hang_matrix(tmp_path, case):
    es, stalls, drives = _build_set(tmp_path)
    payload = _payload(BS * 3, 1)
    for i in range(3):
        es.put_object("bkt", f"seed{i}", io.BytesIO(payload), len(payload))
    try:
        if case == "put-stream":
            victim = _drive_of_shard(es, "hung-put")
            stalls[victim].hang.add("create_file")
            t0 = time.monotonic()
            es.put_object("bkt", "hung-put", io.BytesIO(payload), len(payload))
            assert time.monotonic() - t0 < BOUND
            assert _get(es, "hung-put") == payload
        elif case == "put-inline":
            victim = 0
            stalls[victim].hang.update(("write_metadata_single",
                                        "journal_commit_async"))
            t0 = time.monotonic()
            es.put_object("bkt", "small", io.BytesIO(b"tiny"), 4)
            assert time.monotonic() - t0 < BOUND
            assert _get(es, "small") == b"tiny"
        elif case == "get-meta":
            victim = 0
            stalls[victim].hang.add("read_version")
            es._setcache = None   # the election itself must meet the hang
            t0 = time.monotonic()
            info = es.get_object_info("bkt", "seed0")
            assert time.monotonic() - t0 < BOUND
            assert info.size == len(payload)
        elif case == "get-data":
            victim = _drive_of_shard(es, "seed1")
            stalls[victim].hang.add("read_file_stream")
            t0 = time.monotonic()
            assert _get(es, "seed1") == payload
            assert time.monotonic() - t0 < BOUND
        else:
            victim = 0
            stalls[victim].hang.add("walk_dir")
            t0 = time.monotonic()
            names = [o.name for o in es.list_objects("bkt").objects]
            assert time.monotonic() - t0 < BOUND
            assert set(names) >= {"seed0", "seed1", "seed2"}
        _wait_for(lambda: drives[victim].state != hcmod.ONLINE,
                  what=f"{case}: the victim leaving ONLINE")
        assert drives[victim].timeouts >= 1
    finally:
        _teardown(es, stalls)


# ---------------------------------------------------------------------------
# ONLINE -> FAULTY -> OFFLINE -> probe -> ONLINE -> auto-heal
# ---------------------------------------------------------------------------

def test_state_machine_roundtrip(tmp_path):
    from minio_tpu_torch.erasure.autoheal import (AutoHealer, HealingTracker,
                                                  mark_drive_healing)

    restored = []

    def on_restore(hc):
        restored.append(hc)
        mark_drive_healing(hc, "uuid-roundtrip")

    es, stalls, drives = _build_set(tmp_path, probe_interval=0.05,
                                    on_restore=on_restore)
    payload = _payload(40000, 2)
    es.put_object("bkt", "pre", io.BytesIO(payload), len(payload))
    victim = 0
    st, hc = stalls[victim], drives[victim]
    es._setcache = None
    try:
        # Hang the calls health depends on: reads, and the probe's own.
        st.hang.update(("read_version", "write_all", "read_all"))
        for _ in range(6):
            es.get_object_info("bkt", "pre")
            if hc.state == hcmod.OFFLINE:
                break
            time.sleep(0.3)
        _wait_for(lambda: hc.state == hcmod.OFFLINE, what="OFFLINE")
        # OFFLINE: DiskNotFound at once, no call reaches the drive.
        calls = st.calls
        t0 = time.monotonic()
        with pytest.raises(se.DiskNotFound):
            hc.read_all("bkt", "nope")
        assert time.monotonic() - t0 < 0.25
        assert st.calls == calls
        # A write the drive misses while OFFLINE (quorum 8 of 12 holds).
        missed = _payload(300 << 10, 3)
        es.put_object("bkt", "missed", io.BytesIO(missed), len(missed))
        # Released: the probe restores the drive and leaves a tracker.
        st.hang.clear()
        st.release.set()
        _wait_for(lambda: hc.state == hcmod.ONLINE, what="probe restore")
        _wait_for(lambda: HealingTracker.load(hc) is not None,
                  what="healing tracker from on_restore")
        assert restored and restored[0] is hc
        healer = AutoHealer(es, interval=3600)
        assert healer.run_once() == 1
        assert HealingTracker.load(hc) is None
        assert st.inner.read_version("bkt", "missed").size == len(missed)
        assert _get(es, "missed") == missed
    finally:
        _teardown(es, stalls)


# ---------------------------------------------------------------------------
# hedged shard reads: first k wins
# ---------------------------------------------------------------------------

def test_hedged_read_first_k_wins(tmp_path):
    es, stalls, _ = _build_set(tmp_path, health=False)
    es.hedge_delay = 0.05
    payload = _payload(200 << 10, 4)    # one batch of 4 blocks
    es.put_object("bkt", "hedge", io.BytesIO(payload), len(payload))
    hedged = obs.counter("minio_tpu_hedged_reads_total", "").labels()
    won = obs.counter("minio_tpu_hedged_reads_won_total", "").labels()
    h0, w0 = hedged.value, won.value
    # Data shard 1 is always in the first, data-first selection: its
    # drive's slowness must be covered by a parity spare.
    victim = _drive_of_shard(es, "hedge")
    stalls[victim].chunk_delay = 2.5
    try:
        t0 = time.monotonic()
        assert _get(es, "hedge") == payload
        assert time.monotonic() - t0 < 2.0, "the hedge must beat the slow shard"
        assert hedged.value > h0
        assert won.value > w0
    finally:
        _teardown(es, stalls)


def test_read_ahead_stream_is_byte_equal_and_closes_early(tmp_path):
    """A GET of several batches runs its read-ahead producer: the bytes are
    the object's, ranged or whole, and a consumer that stops early ends
    the producer thread."""
    es, stalls, _ = _build_set(tmp_path, health=False)
    try:
        body = _payload((3 << 20) + 5555, 5)   # 49 blocks: several batches
        es.put_object("bkt", "long", io.BytesIO(body), len(body))
        assert hashlib.sha256(_get(es, "long")).digest() == hashlib.sha256(body).digest()
        _info, it = es.get_object("bkt", "long", 1 << 20, (1 << 20) + 777)
        assert b"".join(bytes(c) for c in it) == body[1 << 20:(2 << 20) + 777]
        _info, it = es.get_object("bkt", "long")
        next(it)
        it.close()
        _wait_for(lambda: not any(t.name == "shard-readahead" and t.is_alive()
                                  for t in threading.enumerate()),
                  what="the read-ahead producer to stop")
    finally:
        _teardown(es, stalls)


# ---------------------------------------------------------------------------
# the drive families in the scrape
# ---------------------------------------------------------------------------

class _Sink:
    def __init__(self):
        self.families = []
        self.samples = []

    def family(self, name, help_, typ):
        self.families.append(name)

    def sample(self, name, value, labels=None):
        self.samples.append((name, value, labels))


def test_drive_metrics_render(tmp_path):
    st = _Stall(LocalDrive(str(tmp_path / "d")))
    st.hang.add("stat_vol")
    hc = HealthChecker(st, deadlines=TIGHT, probe_interval=60)
    try:
        threading.Thread(target=lambda: _swallow(hc.stat_vol, "v"), daemon=True).start()
        _wait_for(lambda: hc.timeouts >= 1, what="a watchdog timeout")
    finally:
        st.release.set()
        st.inner.close_wal()
    sink = _Sink()
    obs.render_into(sink)
    for fam in ("minio_tpu_drive_state", "minio_tpu_drive_timeouts_total",
                "minio_tpu_hedged_reads_total", "minio_tpu_hedged_reads_won_total",
                "minio_tpu_hung_workers_total"):
        assert fam in sink.families, f"{fam} missing from the exposition"
    mine = [v for n, v, lbl in sink.samples
            if n == "minio_tpu_drive_timeouts_total" and lbl == {"drive": st.endpoint()}]
    assert mine and mine[0] >= 1
    assert any(n == "minio_tpu_drive_state" and lbl == {"drive": st.endpoint()}
               for n, _v, lbl in sink.samples)


def _swallow(fn, *a):
    try:
        fn(*a)
    except Exception:  # noqa: BLE001 - the timeout is what is measured
        pass
