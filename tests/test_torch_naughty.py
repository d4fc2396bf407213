"""Per-call fault-injection matrices on the port (minio_tpu_torch/chaos/
naughty.py over minio_tpu_torch/erasure/), case for case the JAX
package's tests/test_naughty_matrix.py: "the i-th call of method M on
drive D fails" swept through heal, complete-multipart and paged listing,
and double faults beyond parity. Each case asserts the two invariants a
quorum system owes its callers:

  1. the operation succeeds (the fault absorbed) or raises a CLEAN typed
     error (StorageError / ObjectError), never an unhandled exception;
  2. no torn state: reads return exactly the right bytes, listings the
     right names, and a fault-free retry converges.

Then the drive plane's admin surface: the same `apply_admin` documents
give the same `describe()` rows in both packages, and
`MTPU_CHAOS_DRIVE_WRAP=1` puts a NaughtyDisk between the port's disk-ID
check and its health checker. The port runs on the CPU (plain versions
of the kernels). Tolerance: exact bytes."""

import io
import os
import shutil

import pytest

from minio_tpu_torch import chaos
from minio_tpu_torch.chaos import naughty
from minio_tpu_torch.chaos.naughty import HANG, NaughtyDisk
from minio_tpu_torch.erasure.objects import ErasureObjects
from minio_tpu_torch.erasure.types import CompletePart
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors as se

CLEAN = (se.StorageError, se.ObjectError)

METHODS = ("write_metadata", "rename_data", "read_file_stream",
           "read_version")
INDICES = (1, 2, 3, 5)


@pytest.fixture(autouse=True)
def _port_chaos_hygiene():
    """The port's NaughtyDisks and breakers live in the port's registry,
    which the conftest's hygiene fixture (the JAX package's) never
    sees: release whatever a failed case left armed."""
    yield
    if chaos.anything_armed():
        chaos.clear_all()


def _drives(tmp_path, tag, n=4):
    return [LocalDrive(str(tmp_path / f"{tag}-d{i}")) for i in range(n)]


def _open(drives):
    return ErasureObjects(drives, parity=1, device="cpu")


def _close(es):
    """Stop the set and close each bare drive's WAL, so the next set over
    the same roots replays whatever this one left."""
    es.close()
    for d in es.drives:
        base = d.inner if isinstance(d, NaughtyDisk) else d
        base.close_wal()


def _set(tmp_path, tag):
    es = _open(_drives(tmp_path, tag))
    es.make_bucket("bkt")
    return es


def _err(method, idx):
    return {(method, idx): se.FaultyDisk(f"naughty {method}#{idx}")}


def _read(es, key):
    _i, st = es.get_object("bkt", key)
    return b"".join(st)


# ---------------------------------------------------------------------------
# heal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("idx", INDICES)
def test_heal_error_matrix(tmp_path, method, idx):
    data = os.urandom(300_000)
    es = _set(tmp_path, f"h{method}{idx}")
    es.put_object("bkt", "obj", io.BytesIO(data), len(data))
    # Wreck drive 3's copy (the heal target); drive 1 misbehaves mid-heal.
    shutil.rmtree(os.path.join(es.drives[3].root, "bkt", "obj"))
    _close(es)

    drives2 = _drives(tmp_path, f"h{method}{idx}")
    drives2[1] = NaughtyDisk(drives2[1], per_method_call=_err(method, idx))
    es2 = _open(drives2)
    try:
        es2.heal_object("bkt", "obj")
    except CLEAN:
        pass                       # a clean typed failure is acceptable
    assert _read(es2, "obj") == data
    _close(es2)
    # A fault-free retry converges: the wrecked copy is back on disk.
    es3 = _open(_drives(tmp_path, f"h{method}{idx}"))
    es3.heal_object("bkt", "obj")
    assert os.path.isdir(os.path.join(es3.drives[3].root, "bkt", "obj"))
    assert _read(es3, "obj") == data
    _close(es3)


# ---------------------------------------------------------------------------
# complete-multipart
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("idx", INDICES)
def test_complete_multipart_error_matrix(tmp_path, method, idx):
    part1 = os.urandom(5 << 20)            # S3's minimum for a non-last part
    part2 = os.urandom(120_000)
    es = _set(tmp_path, f"m{method}{idx}")
    uid = es.new_multipart_upload("bkt", "mp")
    r1 = es.put_object_part("bkt", "mp", uid, 1, io.BytesIO(part1), len(part1))
    r2 = es.put_object_part("bkt", "mp", uid, 2, io.BytesIO(part2), len(part2))
    _close(es)
    parts = [CompletePart(1, r1.etag), CompletePart(2, r2.etag)]

    drives2 = _drives(tmp_path, f"m{method}{idx}")
    drives2[1] = NaughtyDisk(drives2[1], per_method_call=_err(method, idx))
    es2 = _open(drives2)
    completed = False
    try:
        es2.complete_multipart_upload("bkt", "mp", uid, parts)
        completed = True
    except CLEAN:
        pass
    _close(es2)
    es3 = _open(_drives(tmp_path, f"m{method}{idx}"))
    if not completed:
        # A clean failure leaves NO partial object, and a fault-free retry
        # of the same complete succeeds.
        with pytest.raises(CLEAN):
            _read(es3, "mp")
        es3.complete_multipart_upload("bkt", "mp", uid, parts)
    assert _read(es3, "mp") == part1 + part2
    _close(es3)


# ---------------------------------------------------------------------------
# paged listing
# ---------------------------------------------------------------------------

def _list_all(es, page=7):
    got, marker, pages = [], "", 0
    while True:
        res = es.list_objects("bkt", marker=marker, max_keys=page)
        got.extend(o.name for o in res.objects)
        pages += 1
        assert pages < 30
        if not res.is_truncated:
            return got
        marker = res.next_marker


@pytest.mark.parametrize("method", ("walk_dir", "read_version", "read_all"))
@pytest.mark.parametrize("idx", INDICES)
def test_paged_listing_error_matrix(tmp_path, method, idx):
    names = [f"o{i:03d}" for i in range(40)]
    es = _set(tmp_path, f"l{method}{idx}")
    for n in names:
        es.put_object("bkt", n, io.BytesIO(b"x" * 2048), 2048)
    _close(es)

    drives2 = _drives(tmp_path, f"l{method}{idx}")
    drives2[1] = NaughtyDisk(drives2[1], per_method_call=_err(method, idx))
    es2 = _open(drives2)
    try:
        # Absorbed, the listing is COMPLETE: a shortened page is torn.
        assert _list_all(es2) == names
    except CLEAN:
        pass
    _close(es2)
    es3 = _open(_drives(tmp_path, f"l{method}{idx}"))
    assert _list_all(es3) == names
    _close(es3)


# ---------------------------------------------------------------------------
# double faults: beyond parity, a clean quorum error and no torn state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ("create_file", "rename_data"))
def test_double_fault_put_is_atomic(tmp_path, method):
    data = os.urandom(200_000)
    drives = _drives(tmp_path, f"df{method}")
    # Two drives fail every call of the method: with parity 1 the write
    # quorum (3) is out of reach.
    for slot in (1, 2):
        drives[slot] = NaughtyDisk(drives[slot],
                                   per_method={method: se.FaultyDisk("df")})
    es = _open(drives)
    es.make_bucket("bkt")
    with pytest.raises(CLEAN):
        es.put_object("bkt", "atomic", io.BytesIO(data), len(data))
    _close(es)
    es2 = _open(_drives(tmp_path, f"df{method}"))
    with pytest.raises(CLEAN):
        _read(es2, "atomic")
    assert all(o.name != "atomic" for o in es2.list_objects("bkt").objects)
    _close(es2)


@pytest.mark.parametrize("inline", (False, True))
def test_double_fault_overwrite_preserves_old_generation(tmp_path, inline):
    """A below-quorum overwrite, streamed or inline (a small body over a
    large object, the journal-only commit), leaves the previous
    generation whole: its bytes and one listing entry."""
    old = os.urandom(180_000)
    tag = f"ow{int(inline)}"
    es = _set(tmp_path, tag)
    es.put_object("bkt", "keep", io.BytesIO(old), len(old))
    _close(es)

    drives2 = _drives(tmp_path, tag)
    # The commit writes the journal through rename_data (streamed) or
    # write_metadata_single / its WAL twin (inline), and write_metadata on
    # the way back: refusing all three on two drives puts any commit path
    # below quorum.
    for slot in (1, 2):
        drives2[slot] = NaughtyDisk(drives2[slot], per_method={
            m: se.FaultyDisk(tag) for m in
            ("rename_data", "write_metadata_single", "write_metadata")})
    es2 = _open(drives2)
    body = b"tiny" if inline else os.urandom(180_000)
    with pytest.raises(CLEAN):
        es2.put_object("bkt", "keep", io.BytesIO(body), len(body))
    _close(es2)

    es3 = _open(_drives(tmp_path, tag))
    assert _read(es3, "keep") == old, "a failed overwrite destroyed the old bytes"
    assert [o.name for o in es3.list_objects("bkt").objects] == ["keep"]
    es3.heal_object("bkt", "keep")
    assert _read(es3, "keep") == old
    _close(es3)


# ---------------------------------------------------------------------------
# the drive plane's admin surface, against the JAX package's
# ---------------------------------------------------------------------------

class _Named:
    def __init__(self, ep):
        self.ep = ep

    def endpoint(self):
        return self.ep


ADMIN_DOCS = (
    {"op": "drive", "endpoint": "adm-n0/d1", "method": "create_file", "delay": "hang"},
    {"op": "drive", "endpoint": "adm-n0/d1", "method": "read_version", "delay": 1.5},
    {"op": "drive", "endpoint": "adm-n0/d2", "method": "rename_data", "error": "faulty"},
    {"op": "drive", "endpoint": "adm-n0/d2", "method": "read_all", "error": "timeout"},
    {"op": "drive_slow", "endpoint": "adm-n0/d3", "chunkDelay": 0.05},
    {"op": "drive_slow", "endpoint": "adm-n0/d0", "chunkDelay": "hang"},
)


def test_admin_documents_describe_as_in_jax():
    from minio_tpu.chaos import naughty as jax_naughty

    answers = {}
    for pkg, mod in (("jax", jax_naughty), ("torch", naughty)):
        mod.clear_all()
        disks = [mod.NaughtyDisk(_Named(f"/srv/{pkg}/adm-n0/d{i}")) for i in range(4)]
        rows = []
        for doc in ADMIN_DOCS:
            rows.append(mod.apply_admin(dict(doc)))
        for bad in ({"op": "drive", "endpoint": "nowhere", "method": "x"},
                    {"op": "drive", "endpoint": "adm-n0/d1"},
                    {"op": "drive", "endpoint": "adm-n0/d1", "method": "x",
                     "error": "gremlins"},
                    {"op": "drive_bogus", "endpoint": "adm-n0/d1"}):
            with pytest.raises(ValueError):
                mod.apply_admin(bad)
        cleared = mod.apply_admin({"op": "drive_clear", "endpoint": "adm-n0/d2"})
        rows.append({"cleared": cleared["cleared"],
                     "drives": cleared["drives"]})
        rows.append(mod.apply_admin({"op": "drive_clear"})["drives"])
        answers[pkg] = [_strip(r, pkg) for r in rows]
        assert not mod.any_armed() and len(disks) == 4
    assert answers["torch"] == answers["jax"]


def _strip(doc, pkg):
    """An answer with this package's endpoint prefix taken out and its
    drive rows in endpoint order (the registry is a set)."""
    import json

    doc = json.loads(json.dumps(doc).replace(f"/srv/{pkg}/", "/srv/"))
    rows = doc.get("drives") if isinstance(doc, dict) else doc
    rows.sort(key=lambda r: r["endpoint"])
    return doc


def test_wrapped_drive_programs_and_release(tmp_path, monkeypatch):
    """MTPU_CHAOS_DRIVE_WRAP=1: each local drive of the port's ErasureSets
    carries an inert NaughtyDisk under its health checker; a program
    armed through apply_admin faults the drive, a HANG parks the caller
    until clear_all, and the WAL submits still count as blocking."""
    import threading

    from minio_tpu_torch.erasure import sysstore
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.storage.healthcheck import HealthChecker
    from minio_tpu_torch.storage.idcheck import DiskIDChecker

    monkeypatch.setenv(naughty.WRAP_ENV, "1")
    roots = [str(tmp_path / f"w{i}") for i in range(4)]
    sets = ErasureSets([LocalDrive(r) for r in roots], parity=1, device="cpu")
    try:
        for d in sets.drives:
            assert isinstance(d, HealthChecker)
            nd = d._inner
            assert isinstance(nd, NaughtyDisk) and isinstance(nd.inner, DiskIDChecker)
            assert not nd.armed()
        assert sysstore.submits_may_block(sets.drives)
        es = sets.sets[0]
        es.make_bucket("bkt")
        data = os.urandom(100_000)
        es.put_object("bkt", "k", io.BytesIO(data), len(data))
        naughty.apply_admin({"op": "drive", "endpoint": roots[1],
                             "method": "read_all", "error": "io"})
        rows = naughty.describe()
        assert [r["endpoint"] for r in rows] == [roots[1]]
        with pytest.raises(OSError):
            sets.drives[1]._inner.read_all(".mtpu.sys", "format.json")
        naughty.apply_admin({"op": "drive", "endpoint": roots[2],
                             "method": "stat_vol", "delay": "hang"})
        parked = threading.Event()
        done = threading.Event()

        def call():
            parked.set()
            sets.drives[2]._inner.stat_vol("bkt")
            done.set()

        t = threading.Thread(target=call, daemon=True)
        t.start()
        assert parked.wait(5) and not done.wait(0.2)
        assert chaos.clear_all()["drive_faults"] == 2
        assert done.wait(5), "clear_all did not release the HANG"
        assert _read(es, "k") == data
    finally:
        sets.close()
        for r in sets.drives:
            r._inner.close_wal()


class _StreamDrive:
    """A drive with the two stream entries and a WAL submit."""

    data = b"abcdef" * 1000

    def endpoint(self):
        return "streams"

    def read_file_stream(self, volume, path):
        return io.BytesIO(self.data)

    def read_file_range_stream(self, volume, path, offset, length):
        return io.BytesIO(self.data[offset:offset + length])

    def journal_commit_async(self, volume, path, fi, raw):
        return None


def test_stream_pacing_and_read_entry_fallbacks():
    """read_file_range_stream honours read_file_stream's program, the
    WAL's two-phase entries their synchronous twins', and a paced stream
    sleeps on every read (HANG: until release)."""
    import threading
    import time

    nd = NaughtyDisk(_StreamDrive(),
                     per_method={"read_file_stream": se.FaultyDisk("rs")})
    with pytest.raises(se.FaultyDisk):
        nd.read_file_range_stream("v", "f", 0, 4)
    nd.clear_faults()
    nd.per_method["write_metadata_single"] = se.FaultyDisk("wm")
    with pytest.raises(se.FaultyDisk):
        nd.journal_commit_async("v", "g", None, b"")
    nd.clear_faults()
    nd.stream_chunk_delay = 0.05
    with nd.read_file_range_stream("v", "f", 0, 6) as s:
        t0 = time.monotonic()
        assert s.read(6) == b"abcdef"
        assert time.monotonic() - t0 >= 0.05
    nd.stream_chunk_delay = HANG
    got = []
    s = nd.read_file_stream("v", "f")
    t = threading.Thread(target=lambda: got.append(s.read(3)), daemon=True)
    t.start()
    t.join(0.2)
    assert t.is_alive()
    nd.clear_faults()
    t.join(5)
    assert got == [b"abc"]
    s.close()
