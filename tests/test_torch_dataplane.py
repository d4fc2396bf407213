"""The port's batched data plane (minio_tpu_torch/dataplane, plain PyTorch on
the CPU) against the JAX package's (minio_tpu/dataplane, on the CPU), case
by case after tests/test_dataplane.py:

  1. byte equality: lane encode (parity + digests), verify digests, mixed-
     pattern decode and the digest-fused heal lane equal the JAX plane's
     and the port's per-object codec on the same seeded inputs;
  2. ring mechanics: more batches than slots back to back, and row tails
     zeroed in a reused slot (lane padding stays invisible);
  3. batching policy: the lone-request wait bound, a full lane launching
     at once, backpressure as 503 SlowDown through the port's S3 error
     map, close() draining without orphan futures, default-on and opt-out;
  4. serving integration with both planes ON: PUT/GET/degraded GET/heal/
     deep verify through the port's plane write part files byte-equal to
     the JAX package's with its plane on.

Tolerance: exact bytes. The cases of (2) live in tests/torch_lane_cases.py,
which tests/test_torch_kernels.py also runs on the card."""

import glob
import io
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from minio_tpu import dataplane as jax_dataplane
from minio_tpu.dataplane.batcher import BatchPlane as JaxPlane
from minio_tpu.dataplane import ring as jax_ring
from minio_tpu_torch import dataplane
from minio_tpu_torch.dataplane import ring
from minio_tpu_torch.dataplane.batcher import BatchPlane
from minio_tpu_torch.erasure.codec import ErasureCodec
from minio_tpu_torch.ops import fused
from minio_tpu_torch.s3 import errors as s3err
from minio_tpu_torch.utils import admission
from minio_tpu_torch.utils import errors as se
import torch_lane_cases as lane_cases

CPU = torch.device("cpu")


def _blob(rng, size: int) -> bytes:
    return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


def _rows(chunks):
    return [[None if c is None else bytes(c) for c in r] for r in chunks]


@pytest.fixture(scope="module")
def planes():
    tp = BatchPlane(device="cpu", max_wait_s=0.002)
    jp = JaxPlane(max_wait_s=0.002)
    yield tp, jp
    tp.close()
    jp.close()


# ---------------------------------------------------------------------------
# 1. byte equality with the JAX plane and the per-object codec
# ---------------------------------------------------------------------------

def test_encode_16_concurrent_writers_equal_jax_and_codec(planes):
    """16 writers, mixed sizes and geometries: parity and digests of the
    port's lanes equal the JAX plane's and the port's codec's, and the
    concurrent writers shared launches."""
    tp, jp = planes
    geoms = [(4, 2, 1 << 16), (8, 4, 1 << 18), (2, 1, 1 << 14)]
    sizes = [17, 1033, 10 << 10, 60 << 10, 1 << 16, (1 << 18) - 5]
    failures: list[str] = []
    before = tp.stats()

    def writer(wid: int) -> None:
        rng = np.random.default_rng(wid)
        for i in range(4):
            k, m, bs = geoms[(wid + i) % len(geoms)]
            blocks = [_blob(rng, min(sizes[(wid + i + j) % len(sizes)], bs))
                      for j in range(1 + (wid + i) % 3)]
            want_c, want_d = ErasureCodec(k, m, bs, device="cpu").begin_encode(
                blocks).wait()
            got_c, got_d = tp.begin_encode(k, m, bs, blocks,
                                           with_digests=True).wait()
            jax_c, jax_d = jp.begin_encode(k, m, bs, blocks,
                                           with_digests=True).wait()
            if not (_rows(want_c) == _rows(got_c) == _rows(jax_c)):
                failures.append(f"w{wid} chunks {k}+{m}")
            if not (want_d == got_d == jax_d):
                failures.append(f"w{wid} digests {k}+{m}")

    threads = [threading.Thread(target=writer, args=(w,)) for w in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not any(t.is_alive() for t in threads)
    assert not failures, failures[:5]
    after = tp.stats()
    assert after["launches"] - before["launches"] \
        < after["requests"] - before["requests"], "writers never coalesced"


def test_digest_chunks_equal_jax_plane(planes):
    tp, jp = planes
    rng = np.random.default_rng(1)
    chunks = [_blob(rng, n) for n in (1, 100, 4096, 8192, 5000, 0)] * 25
    got = tp.digest_chunks(chunks, 8192)
    assert got == jp.digest_chunks(chunks, 8192)
    assert got == fused.digest_chunks_host(chunks, 8192, "cpu")


def test_decode_blocks_mixed_patterns_equal_jax(planes):
    """Rows with different failure patterns share one launch and equal
    both the JAX plane and the port's codec."""
    tp, jp = planes
    rng = np.random.default_rng(2)
    k, m, bs = 4, 2, 1 << 15
    codec = ErasureCodec(k, m, bs, device="cpu")
    blocks = [_blob(rng, n) for n in (bs, bs // 2, 777, bs, bs - 1)]
    chunks, _ = codec.begin_encode(blocks).wait()
    rows, lens = [], []
    for bi, row in enumerate(_rows(chunks)):
        row[bi % (k + m)] = None                    # pattern varies by row
        row[(bi + 2) % (k + m)] = None
        rows.append(row)
        lens.append(len(blocks[bi]))
    want = _rows(codec.decode_blocks([list(r) for r in rows], lens))
    n0 = tp.stats()["op_launches"]["reconstruct"]
    assert _rows(tp.decode_blocks(k, m, rows, lens)) == want
    assert tp.stats()["op_launches"]["reconstruct"] == n0 + 1
    assert _rows(jp.decode_blocks(k, m, bs, rows, lens)) == want
    assert [b"".join(r) for r in want] == [b + bytes(-len(b) % k)
                                           for b in blocks]
    # No missing shard: no launch, the rows come back as they are.
    before = tp.stats()["launches"]
    full = _rows(chunks)
    assert tp.decode_blocks(k, m, full, lens) == [r[:k] for r in full]
    assert tp.stats()["launches"] == before


def test_decode_blocks_quorum_error(planes):
    tp, _ = planes
    k, m, bs = 4, 2, 1 << 12
    chunks, _ = ErasureCodec(k, m, bs, device="cpu").begin_encode(
        [_blob(np.random.default_rng(3), 100)]).wait()
    row = _rows(chunks)[0]
    for i in range(m + 1):
        row[i] = None
    with pytest.raises(se.InsufficientReadQuorum):
        tp.decode_blocks(k, m, [row], [100])


@pytest.mark.parametrize("targets", [(1,), (0, 5), (2, 3, 9)])
def test_begin_reconstruct_with_digests_equal_jax(planes, targets):
    """The heal lane: rebuilt chunks and their digests from one call equal
    the JAX plane's and the port codec's begin_reconstruct."""
    tp, jp = planes
    rng = np.random.default_rng(4 + len(targets))
    k, m, bs = 8, 4, 1 << 16
    codec = ErasureCodec(k, m, bs, device="cpu")
    blocks = [_blob(rng, n) for n in (bs, 5000, 40000)]
    chunks, _ = codec.begin_encode(blocks).wait()
    rows = _rows(chunks)
    for r in rows:
        for t in targets:
            r[t] = None
    lens = [len(b) for b in blocks]
    want = codec.begin_reconstruct(rows, lens, targets, with_digests=True).wait()
    got = tp.begin_reconstruct(k, m, rows, lens, targets,
                               with_digests=True).wait()
    jax = jp.begin_reconstruct(k, m, bs, rows, lens, targets,
                               with_digests=True).wait()
    assert got == want == jax
    full = _rows(chunks)
    assert got[0] == [[full[b][t] for t in targets] for b in range(3)]


# ---------------------------------------------------------------------------
# 2. ring mechanics (also on the card)
# ---------------------------------------------------------------------------

def test_ring_depth_overrun_back_to_back():
    lane_cases.ring_overrun("cpu")


def test_reused_slot_tails_are_zeroed():
    lane_cases.dirty_slot_tails("cpu")


# ---------------------------------------------------------------------------
# 3. batching policy
# ---------------------------------------------------------------------------

def test_lone_request_honors_max_wait_bound():
    """A lone request launches at the max-wait deadline, not when the
    32-row lane fills."""
    rng = np.random.default_rng(7)
    p = BatchPlane(device="cpu", max_wait_s=0.05, lane_blocks=32)
    try:
        k, m, bs = 4, 2, 1 << 14
        p.begin_encode(k, m, bs, [_blob(rng, 64)], with_digests=True).wait()
        t0 = time.perf_counter()
        p.begin_encode(k, m, bs, [_blob(rng, 64)], with_digests=True).wait()
        assert 0.02 <= time.perf_counter() - t0 < 2.0
    finally:
        p.close()


def test_full_lane_launches_without_waiting():
    rng = np.random.default_rng(8)
    p = BatchPlane(device="cpu", max_wait_s=30.0, lane_blocks=4)
    try:
        k, m, bs = 4, 2, 1 << 14
        p.begin_encode(k, m, bs, [_blob(rng, 64)] * 4, with_digests=True).wait()
        t0 = time.perf_counter()
        pends = [p.begin_encode(k, m, bs, [_blob(rng, 64)], with_digests=True)
                 for _ in range(4)]
        for pend in pends:
            pend.wait()
        assert time.perf_counter() - t0 < 10.0
    finally:
        p.close()


def test_backpressure_is_slowdown_not_deadlock():
    """A full bounded queue rejects the submit with the error the port's
    S3 map answers as 503 SlowDown; the queued work still completes."""
    rng = np.random.default_rng(9)
    p = BatchPlane(device="cpu", queue_cap=2, max_wait_s=0.01)
    try:
        k, m, bs = 4, 2, 1 << 12
        p.begin_encode(k, m, bs, [_blob(rng, 64)]).wait()
        # The future resolves on the completion thread, possibly before the
        # dispatcher is back in its queue wait: wait for it there, or the
        # gate cleared below parks it before it takes the request.
        deadline = time.monotonic() + 10
        while not p._q.not_empty._waiters:
            assert time.monotonic() < deadline, "dispatcher never waited on its queue"
            time.sleep(0.005)
        # Park the dispatcher at its gate: clear it and feed one request,
        # whose consumption walks the loop back to the cleared gate.
        p._gate.clear()
        sacrificial = p.begin_encode(k, m, bs, [_blob(rng, 64)])
        deadline = time.monotonic() + 10
        while not p._q.empty():
            assert time.monotonic() < deadline, "dispatcher never parked"
            time.sleep(0.005)
        okay = [p.begin_encode(k, m, bs, [_blob(rng, 64)]) for _ in range(2)]
        sheds = admission.stats().get(("dataplane", "lane_full"), 0)
        with pytest.raises(se.AdmissionShed, match="saturated") as ei:
            p.begin_encode(k, m, bs, [_blob(rng, 64)])
        assert p.stats()["rejected"] == 1
        assert admission.stats()[("dataplane", "lane_full")] == sheds + 1
        err = s3err.from_exception(ei.value)
        assert (err.api.code, err.api.http_status) == ("SlowDown", 503)
        p._gate.set()
        for pend in (sacrificial, *okay):
            pend.wait()
    finally:
        p.close()


def test_close_drains_in_flight_without_orphan_futures():
    rng = np.random.default_rng(10)
    p = BatchPlane(device="cpu", max_wait_s=5.0, lane_blocks=64)
    k, m, bs = 4, 2, 1 << 12
    pends = [p.begin_encode(k, m, bs, [_blob(rng, 64)], with_digests=True)
             for _ in range(5)]
    p.close()
    for pend in pends:
        chunks, digs = pend.wait()
        assert len(chunks) == 1 and len(digs) == 1
    with pytest.raises(se.OperationTimedOut, match="closed"):
        p.begin_encode(k, m, bs, [_blob(rng, 64)])
    assert not p._dispatch_t.is_alive() and not p._complete_t.is_alive()


def test_plane_enabled_by_default(monkeypatch):
    monkeypatch.delenv("MTPU_BATCHED_DATAPLANE", raising=False)
    assert dataplane.enabled() and jax_dataplane.enabled()
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    assert not dataplane.enabled()
    assert dataplane.maybe_plane(CPU) is None


def test_one_lane_function_per_lane(planes):
    tp, _ = planes
    rng = np.random.default_rng(11)
    before = ring.trace_count()
    for _ in range(4):
        tp.begin_encode(5, 3, 1 << 13, [_blob(rng, 900)],
                        with_digests=True).wait()
    assert ring.trace_count() - before <= 1


def test_bucket_helpers_equal_jax():
    for s in (1, 511, 512, 513, 2560, 65536, 65537):
        assert ring.width_bucket(s) == jax_ring.width_bucket(s)
    for b, cap in ((1, 32), (6, 32), (40, 32), (100, 128)):
        assert ring.rows_bucket(b, cap) == jax_ring.rows_bucket(b, cap)


# ---------------------------------------------------------------------------
# 4. serving integration, both planes ON
# ---------------------------------------------------------------------------

BUCKET = "planes"
SIZES = [17 << 10, 100 << 10, 300 << 10, (1 << 20) + 13]


@pytest.fixture
def planes_on(monkeypatch):
    """The batched data plane at its default (ON) in both packages; the
    JAX metadata plane off, so its journals are on disk when a PUT
    returns (the port has no metadata plane)."""
    monkeypatch.delenv("MTPU_BATCHED_DATAPLANE", raising=False)
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    dataplane.reset_global()
    jax_dataplane.reset_global()
    yield
    dataplane.reset_global()
    jax_dataplane.reset_global()


def _layers(root):
    from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
    from minio_tpu.storage.local import LocalDrive as JaxDrive
    from minio_tpu_torch.erasure.objects import ErasureObjects
    from minio_tpu_torch.storage.local import LocalDrive

    paths = [str(root / f"d{i}") for i in range(12)]
    jl = JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=64 << 10,
                    bitrot_algorithm="mxsum256")
    tl = ErasureObjects([LocalDrive(p) for p in paths], parity=4,
                        block_size=64 << 10, device="cpu")
    return paths, jl, tl


def _part_files(paths, key):
    out = {}
    for i, p in enumerate(paths):
        hits = glob.glob(os.path.join(p, BUCKET, key, "*", "part.1"))
        if hits:
            out[i] = open(hits[0], "rb").read()
    return out


def _get(layer, key):
    _info, it = layer.get_object(BUCKET, key)
    return b"".join(bytes(c) for c in it)


def test_put_get_degraded_heal_deep_verify_through_plane(tmp_path, planes_on):
    jpaths, jl, _ = _layers(tmp_path / "jax")
    tpaths, _, tl = _layers(tmp_path / "torch")
    jl.make_bucket(BUCKET)
    tl.make_bucket(BUCKET)
    rng = np.random.default_rng(12)
    payloads = {f"o{i}": _blob(rng, n) for i, n in enumerate(SIZES)}
    for key, data in payloads.items():
        ji = jl.put_object(BUCKET, key, io.BytesIO(data), len(data))
        ti = tl.put_object(BUCKET, key, io.BytesIO(data), len(data))
        assert ji.etag == ti.etag
        jf, tf = _part_files(jpaths, key), _part_files(tpaths, key)
        assert len(tf) == 12 and jf == tf, key
    plane = dataplane.get_plane(CPU)
    jplane = jax_dataplane.get_plane()
    st = plane.stats()
    assert st["launches"] > 0, "PUTs never touched the port's plane"
    assert jplane.stats()["launches"] > 0, "the JAX side ran without its plane"
    for key, data in payloads.items():
        assert _get(tl, key) == data
    assert plane.stats()["requests"] > st["requests"], "GET verify bypassed"

    # Degraded GET through the reconstruct lanes: two data shards lost.
    n0 = plane.stats()["op_launches"]["reconstruct"]
    for key in ("o0", "o1"):
        for i in (0, 1):
            shutil.rmtree(os.path.dirname(glob.glob(os.path.join(
                tpaths[i], BUCKET, key, "*", "part.1"))[0]))
    for key in ("o0", "o1"):
        assert _get(tl, key) == payloads[key]
        assert _get(jl, key) == payloads[key]   # the JAX reader agrees
    assert plane.stats()["op_launches"]["reconstruct"] > n0

    # Heal through the digest-fused reconstruct lane rewrites the JAX
    # package's files byte for byte.
    before = _part_files(jpaths, "o1")
    lost = [i for i in range(12) if i not in _part_files(tpaths, "o1")]
    n0 = plane.stats()["op_launches"]["reconstruct"]
    res = tl.heal_object(BUCKET, "o1")
    assert res.healed_count == len(lost) == 2
    assert _part_files(tpaths, "o1") == before
    assert plane.stats()["op_launches"]["reconstruct"] > n0

    # Deep verify on the plane catches one flipped byte, and heals it.
    f = glob.glob(os.path.join(tpaths[5], BUCKET, "o2", "*", "part.1"))[0]
    raw = bytearray(open(f, "rb").read())
    raw[32 + 77] ^= 0x40
    open(f, "wb").write(bytes(raw))
    n0 = plane.stats()["requests"]
    assert tl.heal_object(BUCKET, "o2", scan_deep=True).healed_count == 1
    assert plane.stats()["requests"] > n0
    assert _part_files(tpaths, "o2") == _part_files(jpaths, "o2")


def test_jax_written_with_plane_read_by_port(tmp_path, planes_on):
    """Objects the JAX package wrote with its plane on read back byte-equal
    through the port's plane, intact and with two shards lost."""
    paths, jl, tl = _layers(tmp_path)
    jl.make_bucket(BUCKET)
    rng = np.random.default_rng(13)
    for i, n in enumerate(SIZES):
        data = _blob(rng, n)
        jl.put_object(BUCKET, f"j{i}", io.BytesIO(data), n)
        assert _get(tl, f"j{i}") == data
        for d in (3, 7):
            for hit in glob.glob(os.path.join(paths[d], BUCKET, f"j{i}", "*", "")):
                shutil.rmtree(hit)
        assert _get(tl, f"j{i}") == data


def test_plane_off_is_the_per_object_path(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    # _layers mounts the drives in both packages at once: their WALs off.
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    dataplane.reset_global()
    try:
        _paths, _jl, tl = _layers(tmp_path)
        tl.make_bucket(BUCKET)
        data = _blob(np.random.default_rng(14), 100 << 10)
        tl.put_object(BUCKET, "off", io.BytesIO(data), len(data))
        assert _get(tl, "off") == data
        assert not dataplane._global_planes, "the plane was built while off"
    finally:
        dataplane.reset_global()
