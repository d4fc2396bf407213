"""The port's group-commit metadata plane (minio_tpu_torch/metaplane/)
held against the JAX package's (minio_tpu/metaplane/) on the CPU.

12 drives at EC 8+4 with 64 KiB blocks, numpy-seeded data, exact bytes.
The crash cases use each package's own crash simulation (`abandon()`:
the committer stops dead and the segment is released with nothing
materialized), then compare what the other package serves from the
drives with what the writer's own package serves from a copy of them. A
drive's WAL is owned by one package at a time: a test closes or abandons
one package's WALs before the other mounts the drives."""

import io
import os
import shutil
import struct
import threading
import time

import numpy as np
import pytest

from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.metaplane import wal as jax_wal
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.storage.xlmeta import XLMeta as JaxXLMeta
from minio_tpu.utils.dyntimeout import DynamicTimeout as JaxDynamicTimeout
from minio_tpu_torch import obs
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.metaplane import wal as torch_wal
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.storage.xlmeta import XLMeta as TorchXLMeta
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.dyntimeout import DynamicTimeout as TorchDynamicTimeout

BS = 64 << 10
BUCKET = "meta"


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _paths(root):
    return [str(root / f"d{i}") for i in range(12)]


def _layer(pkg, paths):
    if pkg == "jax":
        return JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                          bitrot_algorithm="mxsum256")
    return TorchObjects([TorchDrive(p) for p in paths], parity=4, block_size=BS,
                        device="cpu")


def _close(layer):
    for d in layer.drives:
        d.close_wal()
    layer.close()


def _get(layer, key):
    _info, it = layer.get_object(BUCKET, key)
    return b"".join(bytes(c) for c in it)


def _served(layer, key):
    """What a layer answers for a key: (bytes, etag, version id), or the
    error's class name."""
    try:
        info = layer.get_object_info(BUCKET, key)
        return _get(layer, key), info.etag, info.version_id
    except Exception as e:  # noqa: BLE001 - the answer is compared
        return type(e).__name__


def _counter(name):
    for v in obs.registry():
        if v.name == name:
            return sum(c.value for c in v._children.values())
    raise AssertionError(f"family {name} not registered")


@pytest.fixture
def armed(monkeypatch):
    """Both packages at their defaults (metadata plane on); the batched
    data plane off so each PUT is one object's codec launches."""
    monkeypatch.delenv("MTPU_METAPLANE", raising=False)
    monkeypatch.delenv("MTPU_WAL_LAZY_MATERIALIZE", raising=False)
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


# ---------------------------------------------------------------------------
# R1: a crash's acknowledged writes, replayed at mount, both ways
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lazy", [False, True], ids=["default", "lazy"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_crash_replay_serves_what_the_writer_serves(tmp_path, armed, monkeypatch,
                                                    writer, reader, lazy):
    """The writer takes a burst of inline and streamed PUTs, overwrites
    and deletes, then crashes (abandon on every drive). The reader's
    package mounts the drives; the writer's own package reopens a copy of
    them. Both replay the WAL and must serve the same bytes, ETags,
    versions and absent keys: exactly what was acknowledged."""
    if lazy:
        monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    paths = _paths(tmp_path / "drives")
    w = _layer(writer, paths)
    w.make_bucket(BUCKET)
    acked = {}
    for seed, (key, size) in enumerate((("small", 1000), ("mid", 300 << 10),
                                        ("big", (1 << 20) + 12345),
                                        ("keep", 4000))):
        data = _payload(size, seed)
        w.put_object(BUCKET, key, io.BytesIO(data), size)
        acked[key] = data
    # The committer's idle tick materializes the first burst (not in
    # lazy mode); what follows lives in the WAL alone at the crash.
    time.sleep(0.8)
    acked["small"] = _payload(2000, 10)
    w.put_object(BUCKET, "small", io.BytesIO(acked["small"]), 2000)
    w.delete_object(BUCKET, "mid")
    acked["mid"] = None
    acked["big"] = _payload(700 << 10, 11)
    w.put_object(BUCKET, "big", io.BytesIO(acked["big"]), len(acked["big"]))
    acked["late"] = _payload(777, 12)
    w.put_object(BUCKET, "late", io.BytesIO(acked["late"]), 777)
    acked["late-big"] = _payload(200 << 10, 13)
    w.put_object(BUCKET, "late-big", io.BytesIO(acked["late-big"]), 200 << 10)
    for d in w.drives:
        d._wal.abandon()
    w.close()
    monkeypatch.delenv("MTPU_WAL_LAZY_MATERIALIZE", raising=False)
    shutil.copytree(tmp_path / "drives", tmp_path / "copy")
    r = _layer(reader, paths)
    again = _layer(writer, _paths(tmp_path / "copy"))
    try:
        for key, data in acked.items():
            got, want = _served(r, key), _served(again, key)
            assert got == want, key
            if data is None:
                assert got == "ObjectNotFound", key
            else:
                assert got[0] == data, key
    finally:
        _close(r)
        _close(again)


# ---------------------------------------------------------------------------
# R2: v1 journals
# ---------------------------------------------------------------------------

def test_mtp1_journal_parses_as_in_jax():
    """The MTP1 document of tests/test_storage.py parses in the port as in
    the JAX package, and both write it back in the same current layout."""
    from minio_tpu_torch.utils import msgpack

    v1_doc = {"v": 1, "versions": [
        {"t": 1, "vid": "aaaa", "mt": 2.0, "dd": "dd1", "sz": 7,
         "meta": {"etag": "x"}, "parts": [],
         "ec": {"algo": "", "k": 2, "m": 1, "bs": 65536, "idx": 1,
                "dist": [1, 2, 3], "cks": []}},
        {"t": 2, "vid": "bbbb", "mt": 1.0},
    ]}
    raw = b"MTP1" + msgpack.packb(v1_doc)
    meta, ref = TorchXLMeta.parse(raw), JaxXLMeta.parse(raw)
    assert meta.version_count == 2 and meta.latest_mt == 2.0
    fi = meta.to_fileinfo("v", "obj")
    assert fi.size == 7 and fi.is_latest and fi.erasure.data_blocks == 2
    assert meta.to_fileinfo("v", "obj", "bbbb").deleted
    assert meta.serialize() == ref.serialize()
    assert TorchXLMeta.parse(meta.serialize()).to_fileinfo("v", "obj").size == 7
    with pytest.raises(se.CorruptedFormat):
        TorchXLMeta.parse(b"MTP1" + msgpack.packb({"v": 7}))


# ---------------------------------------------------------------------------
# WAL format
# ---------------------------------------------------------------------------

RECORDS = [
    (1, 1.5, "vol", "a/b/c", b"journal-bytes"),
    (2, 2.5, "vol", "gone", b""),
    (3, 2.75, "vol", "a", b""),
    (4, 3.0, ".mtpu.sys", "multipart/x/part.1.json", b'{"size": 5}'),
    (5, 3.25, ".mtpu.sys", "config/doc", b""),
    (1, 3.5, "v2", "uni/é漢", bytes(range(256)) * 16),
]


def test_wal_frames_are_byte_equal_to_jax():
    for rec in RECORDS:
        mine = b"".join(bytes(b) for b in torch_wal.frame_record(*rec))
        ref = b"".join(bytes(b) for b in jax_wal.frame_record(*rec))
        assert mine == ref
    raw = memoryview(bytearray(b"z" * 300))[10:200]   # a view is framed uncopied
    assert b"".join(bytes(b) for b in torch_wal.frame_record(1, 9.0, "v", "k", raw)) \
        == b"".join(bytes(b) for b in jax_wal.frame_record(1, 9.0, "v", "k", raw))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_files_scan_and_fold_in_both(tmp_path, writer):
    wmod, rmod = (jax_wal, torch_wal) if writer == "jax" else (torch_wal, jax_wal)
    segs = []
    for name, recs in (("journal.wal", RECORDS[:3]), ("journal.w1.wal", RECORDS[2:])):
        p = str(tmp_path / name)
        wmod.reset(p)
        fd = os.open(p, os.O_WRONLY | os.O_APPEND)
        wmod.append_records(fd, [wmod.frame_record(*r) for r in recs])
        os.close(fd)
        segs.append(p)
    assert [tuple(r[:4]) + (bytes(r.raw),) for r in rmod.scan(segs[0])] == RECORDS[:3]
    assert rmod.segment_paths(str(tmp_path)) == sorted(segs)

    def flat(fold):
        return {k: (r.rtype, r.mt, bytes(r.raw)) for k, r in fold.items()}

    assert flat(torch_wal.fold(segs[0])) == flat(jax_wal.fold(segs[0]))
    assert flat(torch_wal.fold_merged(segs)) == flat(jax_wal.fold_merged(segs))


def test_torn_tail_replays_to_the_last_durable_record(tmp_path, monkeypatch):
    """A crash between append and fsync tears the WAL's tail: replay
    stops at the last whole record, in the port as the JAX scan does."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    d = TorchDrive(str(tmp_path / "d0"))
    d.make_vol("bkt")
    for i in range(3):
        fi = FileInfo.new("bkt", f"k{i}")
        fi.inline_data = bytes([i]) * 8
        fi.size = 8
        d.write_metadata("bkt", f"k{i}", fi)
    assert d.read_version("bkt", "k2").size == 8
    assert not os.path.exists(tmp_path / "d0" / "bkt" / "k0" / "meta.mp")
    d._wal.abandon()
    wal_file = tmp_path / "d0" / SYS_VOL / "wal" / "journal.wal"
    whole = wal_file.read_bytes()
    wal_file.write_bytes(whole[:-3])
    assert [r.path for r in jax_wal.scan(str(wal_file))] == ["k0", "k1"]
    assert [r.path for r in torch_wal.scan(str(wal_file))] == ["k0", "k1"]
    bad = bytearray(whole)
    bad[len(torch_wal.MAGIC) + struct.calcsize("<II") + 3] ^= 0xFF
    (tmp_path / "bad.wal").write_bytes(bytes(bad))
    assert list(torch_wal.scan(str(tmp_path / "bad.wal"))) == []
    monkeypatch.setenv("MTPU_METAPLANE", "0")   # replay runs unarmed too
    d2 = TorchDrive(str(tmp_path / "d0"))
    assert d2.last_replay[:2] == (2, 0)
    assert d2.read_version("bkt", "k1").inline_data == bytes([1]) * 8
    with pytest.raises(se.FileNotFound):
        d2.read_version("bkt", "k2")
    assert wal_file.read_bytes() == torch_wal.MAGIC


def test_checkpoint_truncates_the_wal(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_WAL_MAX_BYTES", "4096")
    d = TorchDrive(str(tmp_path / "d0"))
    d.make_vol("bkt")
    wal_file = tmp_path / "d0" / SYS_VOL / "wal" / "journal.wal"
    for i in range(40):
        fi = FileInfo.new("bkt", f"k{i}")
        fi.inline_data = _payload(300, i)
        fi.size = 300
        d.write_metadata("bkt", f"k{i}", fi)
    d._wal.flush()
    assert os.path.getsize(wal_file) < 4096 + 1024
    assert all(os.path.exists(tmp_path / "d0" / "bkt" / f"k{i}" / "meta.mp")
               for i in range(40))
    d.close_wal()
    assert wal_file.read_bytes() == torch_wal.MAGIC
    d2 = TorchDrive(str(tmp_path / "d0"))
    assert d2.last_replay[:2] == (0, 0)   # nothing left to replay
    assert d2.read_version("bkt", "k39").inline_data == _payload(300, 39)
    d2.close_wal()


# ---------------------------------------------------------------------------
# the plane under the object layer
# ---------------------------------------------------------------------------

def test_a_walk_sees_every_acknowledged_key(tmp_path, armed, monkeypatch):
    """With materialization held off, a listing flushes the WAL first and
    lists every acknowledged key; the journals are then on disk."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    paths = _paths(tmp_path)
    t = _layer("torch", paths)
    try:
        t.make_bucket(BUCKET)
        keys = [f"k{i:02d}" for i in range(10)]
        for i, k in enumerate(keys):
            t.put_object(BUCKET, k, io.BytesIO(_payload(500 + i, i)), 500 + i)
        assert not os.path.exists(os.path.join(paths[0], BUCKET, "k00", "meta.mp"))
        assert [o.name for o in t.list_objects(BUCKET).objects] == keys
        assert all(os.path.exists(os.path.join(p, BUCKET, k, "meta.mp"))
                   for p in paths for k in keys)
    finally:
        _close(t)


def test_part_journals_ride_the_blob_lane(tmp_path, armed, monkeypatch):
    """A part journal is acknowledged by the WAL fsync and served from the
    overlay before it is on disk; Complete reads it and the object GETs
    byte-equal; a crash before materialization replays it."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    paths = _paths(tmp_path)
    t = _layer("torch", paths)
    t.make_bucket(BUCKET)
    commits0 = _counter("minio_tpu_metaplane_commits_total")
    fsyncs0 = _counter("minio_tpu_metaplane_fsyncs_total")
    uid = t.new_multipart_upload(BUCKET, "mp")
    body = _payload(5 << 20, 3)
    part = t.put_object_part(BUCKET, "mp", uid, 1, io.BytesIO(body), len(body))
    mp = t._mp_dir(BUCKET, "mp", uid)
    rel = f"{mp}/part.1.json"
    base = t.drives[0]
    assert base._wal.pending_blob(SYS_VOL, rel) is not None
    assert not os.path.exists(os.path.join(paths[0], SYS_VOL, rel))
    assert b'"etag"' in base.read_all(SYS_VOL, rel)
    # One record per drive for upload.json and for part.1.json, each
    # drive's pair in at most two fsyncs.
    assert _counter("minio_tpu_metaplane_commits_total") - commits0 >= 24
    assert _counter("minio_tpu_metaplane_fsyncs_total") - fsyncs0 <= 24
    for d in t.drives:
        d._wal.abandon()
    t.close()
    monkeypatch.delenv("MTPU_WAL_LAZY_MATERIALIZE")
    t2 = _layer("torch", paths)
    try:
        assert os.path.exists(os.path.join(paths[0], SYS_VOL, rel))
        from minio_tpu_torch.erasure.types import CompletePart
        t2.complete_multipart_upload(BUCKET, "mp", uid, [CompletePart(1, part.etag)])
        assert _get(t2, "mp") == body
    finally:
        _close(t2)


def test_set_cache_hits_and_invalidates_on_overwrite_and_delete(tmp_path, armed):
    paths = _paths(tmp_path)
    t = _layer("torch", paths)
    try:
        t.make_bucket(BUCKET)
        old, new = _payload(3000, 1), _payload(300 << 10, 2)
        t.put_object(BUCKET, "k", io.BytesIO(old), len(old))
        hits0 = _counter("minio_tpu_metaplane_cache_hits_total")
        assert _get(t, "k") == old
        assert _get(t, "k") == old
        assert _counter("minio_tpu_metaplane_cache_hits_total") - hits0 >= 2
        t.put_object(BUCKET, "k", io.BytesIO(new), len(new))
        assert _get(t, "k") == new
        inv0 = _counter("minio_tpu_metaplane_cache_invalidations_total")
        t.delete_object(BUCKET, "k")
        assert _counter("minio_tpu_metaplane_cache_invalidations_total") > inv0
        with pytest.raises(se.ObjectNotFound):
            t.get_object_info(BUCKET, "k")
        # A journal rewritten behind the set's back (here: by the JAX
        # package, after a handoff) moves the drives' signatures, so the
        # cached election is not served.
        t.put_object(BUCKET, "j", io.BytesIO(old), len(old))
        assert _get(t, "j") == old
        for d in t.drives:
            d.close_wal()
        j = _layer("jax", paths)
        j.put_object(BUCKET, "j", io.BytesIO(new), len(new))
        for d in j.drives:
            d.close_wal()
        t2 = _layer("torch", paths)
        assert _get(t2, "j") == new
        _close(t2)
    finally:
        t.close()


def test_full_wal_queue_sheds_slowdown(tmp_path, monkeypatch):
    """A full submission queue sheds the commit as AdmissionShed (503
    SlowDown), counted in minio_tpu_admission_shed_total. Each batch's
    fsync is held 0.2 s, as the JAX package's MTPU_WAL_TEST_HOLD_FSYNC_S
    holds it (the port has no such hook): with a fast fsync the 8 writers
    may not overlap and nothing is shed."""
    import types

    from minio_tpu_torch.metaplane import groupcommit

    monkeypatch.setenv("MTPU_WAL_QUEUE", "2")
    monkeypatch.setenv("MTPU_WAL_MAX_BATCH", "1")

    def held_fsync(fd):
        time.sleep(0.2)
        os.fsync(fd)

    held_os = types.SimpleNamespace(**{k: getattr(os, k) for k in dir(os)
                                       if not k.startswith("__")})
    held_os.fsync = held_fsync
    monkeypatch.setattr(groupcommit, "os", held_os)
    d = TorchDrive(str(tmp_path / "d0"))
    d.make_vol("bkt")
    errors = []

    def store(i):
        fi = FileInfo.new("bkt", f"k{i}")
        try:
            d.write_metadata("bkt", f"k{i}", fi)
        except se.AdmissionShed as e:
            errors.append(e)

    threads = [threading.Thread(target=store, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    d.close_wal()
    assert errors
    from minio_tpu_torch.utils import admission
    assert admission.stats().get(("metaplane", "wal_full"), 0) >= len(errors)


# ---------------------------------------------------------------------------
# adaptive deadlines
# ---------------------------------------------------------------------------

def test_dynamic_timeout_follows_the_jax_sequence():
    """The same log of durations and timeouts gives the same sequence of
    deadlines in both packages."""
    rng = np.random.default_rng(7)
    mine, ref = TorchDynamicTimeout(2.0, 0.1), JaxDynamicTimeout(2.0, 0.1)
    seq_m, seq_r = [], []
    for step in range(3000):
        phase = (step // 500) % 3
        fail = rng.random() < (0.4 if phase == 1 else 0.02)
        dur = float(rng.exponential(0.05 if phase != 2 else 0.5))
        for dt, seq in ((mine, seq_m), (ref, seq_r)):
            if fail:
                dt.log_failure()
            else:
                dt.log_success(dur)
            seq.append(dt.timeout())
    assert seq_m == seq_r
    assert len(set(seq_m)) > 5


def test_an_ack_never_waits_behind_the_idle_drain(tmp_path, monkeypatch):
    """The committer's idle drain writes pending journals one by one and
    stops as soon as a submission waits, so a commit acknowledged during
    a long drain waits for one file, not the backlog."""
    d = TorchDrive(str(tmp_path / "d0"))
    d.make_vol("bkt")
    for i in range(60):
        fi = FileInfo.new("bkt", f"k{i}")
        d.write_metadata("bkt", f"k{i}", fi)
    real = d._store_meta_disk
    started = threading.Event()

    def slow_store(*a, **kw):
        started.set()
        time.sleep(0.05)
        return real(*a, **kw)

    monkeypatch.setattr(d, "_store_meta_disk", slow_store)
    assert started.wait(5)           # the idle tick's drain is under way
    t0 = time.perf_counter()
    d.write_all_async(SYS_VOL, "x/part.1.json", b"{}").result(timeout=10)
    assert time.perf_counter() - t0 < 1.0    # the backlog alone takes 3 s
    monkeypatch.setattr(d, "_store_meta_disk", real)
    d._wal.flush()
    assert all(os.path.exists(tmp_path / "d0" / "bkt" / f"k{i}" / "meta.mp")
               for i in range(60))
    d.close_wal()


def test_a_pending_blob_has_a_signature_before_it_is_on_disk(tmp_path, monkeypatch):
    """stat_file of a blob acknowledged but not yet written answers a
    signature from the WAL (no file on disk has it), and the file's own
    once it is written; a pending removal answers FileNotFound."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    d = TorchDrive(str(tmp_path / "d0"))
    d.write_all_async(SYS_VOL, "config/doc", b"one").result()
    pending = d.stat_file(SYS_VOL, "config/doc")
    assert pending[0] < 0 and pending[2] == 3
    d.write_all_async(SYS_VOL, "config/doc", b"three").result()
    again = d.stat_file(SYS_VOL, "config/doc")
    assert again != pending and again[2] == 5
    d.flush_wal()
    on_disk = d.stat_file(SYS_VOL, "config/doc")
    assert on_disk[0] > 0 and on_disk[2] == 5
    d.delete(SYS_VOL, "config/doc")
    with pytest.raises(se.FileNotFound):
        d.stat_file(SYS_VOL, "config/doc")
    d.close_wal()


def test_a_remount_never_repeats_a_pending_signature(tmp_path, monkeypatch):
    """A drive mounted again in the same process numbers its writes from
    the start, so a pending blob's signature carries its WAL's
    generation: the same write after a remount never reads as unchanged."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    sigs = []
    for body in (b"one", b"two"):
        d = TorchDrive(str(tmp_path / "d0"))
        d.write_all_async(SYS_VOL, "config/doc", body).result()
        sigs.append(d.stat_file(SYS_VOL, "config/doc"))
        d.close_wal()
        del d
    assert sigs[0][0] < 0 and sigs[1][0] < 0
    assert sigs[0][1:] == sigs[1][1:]     # same sequence number and size
    assert sigs[0] != sigs[1]


# ---------------------------------------------------------------------------
# multipart, versioning, listing and heal with both planes at the default
# ---------------------------------------------------------------------------

def _opts(pkg, **kw):
    if pkg == "jax":
        from minio_tpu.erasure.types import ObjectOptions
    else:
        from minio_tpu_torch.erasure.types import ObjectOptions
    return ObjectOptions(**kw)


def _part(pkg):
    if pkg == "jax":
        from minio_tpu.erasure.types import CompletePart
    else:
        from minio_tpu_torch.erasure.types import CompletePart
    return CompletePart


def _handoff(layer):
    """Close a layer's WALs (drain, materialize, checkpoint): the other
    package may mount the drives."""
    for d in layer.drives:
        d.close_wal()
    layer.close()


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_multipart_begun_in_one_crash_completed_in_the_other(tmp_path, armed,
                                                              monkeypatch,
                                                              writer, reader):
    """A session and its parts written at the default, the part journals
    on the WAL blob lane and left unmaterialized by a crash: the other
    package replays them at mount, completes the upload, and both
    packages GET the object byte-equal with the same ETag."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    paths = _paths(tmp_path)
    w = _layer(writer, paths)
    w.make_bucket(BUCKET)
    uid = w.new_multipart_upload(BUCKET, "mp")
    parts = [_payload(5 << 20, 20), _payload(300 << 10, 21)]
    etags = [w.put_object_part(BUCKET, "mp", uid, i + 1, io.BytesIO(b), len(b)).etag
             for i, b in enumerate(parts)]
    for d in w.drives:
        d._wal.abandon()
    w.close()
    monkeypatch.delenv("MTPU_WAL_LAZY_MATERIALIZE")
    r = _layer(reader, paths)
    info = r.complete_multipart_upload(
        BUCKET, "mp", uid, [_part(reader)(i + 1, e) for i, e in enumerate(etags)])
    assert _get(r, "mp") == b"".join(parts)
    _handoff(r)
    again = _layer(writer, paths)
    try:
        assert _get(again, "mp") == b"".join(parts)
        assert again.get_object_info(BUCKET, "mp").etag == info.etag
    finally:
        _close(again)


def test_versions_written_by_the_port_list_and_read_in_jax(tmp_path, armed):
    """Versioned PUTs, a delete marker and its removal through the port's
    WAL; after the hand-over the JAX package lists the same versions and
    reads each by id byte-equal."""
    paths = _paths(tmp_path)
    t = _layer("torch", paths)
    t.make_bucket(BUCKET)
    bodies = {}
    for i, size in enumerate((3000, 200 << 10, 1000)):
        body = _payload(size, 30 + i)
        vid = t.put_object(BUCKET, "k", io.BytesIO(body), size,
                           _opts("torch", versioned=True)).version_id
        bodies[vid] = body
    marker = t.delete_object(BUCKET, "k", _opts("torch", versioned=True))
    mine = [(v.version_id, v.delete_marker, v.is_latest)
            for v in t.list_object_versions(BUCKET).objects]
    _handoff(t)
    j = _layer("jax", paths)
    try:
        theirs = [(v.version_id, v.delete_marker, v.is_latest)
                  for v in j.list_object_versions(BUCKET).objects]
        assert theirs == mine and mine[0] == (marker.version_id, True, True)
        for vid, body in bodies.items():
            _info, it = j.get_object(BUCKET, "k", opts=_opts("jax", version_id=vid))
            assert b"".join(bytes(c) for c in it) == body
    finally:
        _close(j)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_listing_after_a_crash_lists_what_was_acknowledged(tmp_path, armed,
                                                             monkeypatch, writer):
    """Keys PUT and deleted with materialization held off, then a crash:
    the other package's listing after its mount replayed the WAL names
    exactly the writer's own reopened listing."""
    monkeypatch.setenv("MTPU_WAL_LAZY_MATERIALIZE", "1")
    paths = _paths(tmp_path / "drives")
    w = _layer(writer, paths)
    w.make_bucket(BUCKET)
    for i in range(24):
        w.put_object(BUCKET, f"p{i % 3}/k{i:02d}", io.BytesIO(_payload(700 + i, i)),
                     700 + i)
    for i in range(0, 24, 5):
        w.delete_object(BUCKET, f"p{i % 3}/k{i:02d}")
    for d in w.drives:
        d._wal.abandon()
    w.close()
    monkeypatch.delenv("MTPU_WAL_LAZY_MATERIALIZE")
    shutil.copytree(tmp_path / "drives", tmp_path / "copy")
    other = "torch" if writer == "jax" else "jax"
    r = _layer(other, paths)
    again = _layer(writer, _paths(tmp_path / "copy"))
    try:
        for prefix, delim in (("", ""), ("p1/", ""), ("", "/")):
            got = r.list_objects(BUCKET, prefix, "", delim, 1000)
            want = again.list_objects(BUCKET, prefix, "", delim, 1000)
            assert [o.name for o in got.objects] == [o.name for o in want.objects]
            assert got.prefixes == want.prefixes
        assert len(r.list_objects(BUCKET).objects) == 24 - 5
    finally:
        _close(r)
        _close(again)


def test_port_heal_at_the_default_matches_the_jax_heal(tmp_path, armed):
    """The same damage healed by each package at its default (the WAL on):
    the rebuilt shard files and journals are byte-equal."""
    import glob

    src = tmp_path / "src"
    t = _layer("torch", _paths(src))
    t.make_bucket(BUCKET)
    data = _payload(300 << 10, 40)
    t.put_object(BUCKET, "h", io.BytesIO(data), len(data))
    t.put_object(BUCKET, "tiny", io.BytesIO(data[:900]), 900)
    _handoff(t)
    for name in ("a", "b"):
        shutil.copytree(src, tmp_path / name)
        for i in (1, 4, 7):
            for obj in ("h", "tiny"):
                shutil.rmtree(tmp_path / name / f"d{i}" / BUCKET / obj)
    healed = {}
    for pkg, name in (("jax", "a"), ("torch", "b")):
        layer = _layer(pkg, _paths(tmp_path / name))
        for obj in ("h", "tiny"):
            layer.heal_object(BUCKET, obj)
        _handoff(layer)
        healed[pkg] = {os.path.relpath(f, tmp_path / name): open(f, "rb").read()
                       for f in glob.glob(str(tmp_path / name / "d*" / BUCKET / "**"),
                                          recursive=True) if os.path.isfile(f)}
    assert healed["torch"] == healed["jax"]
    assert len([f for f in healed["torch"] if f.endswith("meta.mp")]) == 24
