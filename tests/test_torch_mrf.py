"""The MRF heal queue of the port (minio_tpu_torch/erasure/healing.py
MRFHealer, plain PyTorch on the CPU) beside the JAX package's.

Each scenario runs once per package, each on its own 12 tmp drives at
EC 8+4 (64 KiB blocks) with enable_mrf on: a PUT and a Complete that
reach quorum while 2 drives refuse writes, a GET over a flipped byte, a
heal tried while a drive is still offline, a shallow entry upgraded to
deep, and a deleted object dropping out. After the queue drains, the other
package's heal_object(dry_run=True) must find every drive ok, and the
healed shard files must equal what a clean write left. The JAX side runs
with both batch planes off and bitrot_algorithm="mxsum256". The retry
interval is pinned small in both packages so no test sleeps through the
1 s default. Tolerance: exact bytes."""

import glob
import io
import os
import threading

import numpy as np
import pytest

from minio_tpu.erasure import healing as jax_healing
from minio_tpu.erasure.multipart import MIN_PART_SIZE
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.erasure.types import CompletePart as JaxPart
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.utils import errors as jax_se
from minio_tpu_torch.erasure import healing as torch_healing
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.types import CompletePart as TorchPart
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import errors as torch_se

BS = 64 << 10
BUCKET = "mrf"
PKGS = ["jax", "torch"]
WAIT = 30.0


@pytest.fixture(autouse=True)
def fast_retries(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    for mod in (jax_healing, torch_healing):
        monkeypatch.setattr(mod, "MRF_RETRY_INTERVAL", 0.05)
        monkeypatch.setattr(mod, "MRF_RETRY_CAP", 0.2)


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _paths(root, n=12):
    return [str(root / f"d{i:02d}") for i in range(n)]


def _layer(pkg, paths, enable_mrf=True):
    if pkg == "jax":
        return JaxObjects([JaxDrive(p) for p in paths], parity=4, block_size=BS,
                          bitrot_algorithm="mxsum256", enable_mrf=enable_mrf)
    return TorchObjects([TorchDrive(p) for p in paths], parity=4, block_size=BS,
                        device="cpu", enable_mrf=enable_mrf)


def _other(pkg):
    return "torch" if pkg == "jax" else "jax"


@pytest.fixture
def layers():
    """Open layers, closed (MRF threads joined) after the test."""
    opened = []

    def make(pkg, paths, enable_mrf=True):
        lay = _layer(pkg, paths, enable_mrf)
        opened.append(lay)
        return lay

    yield make
    for lay in opened:
        lay.close()


WRITES = ("create_file", "rename_data", "write_metadata", "write_metadata_single")


class _Refuse:
    """Make drives refuse writes (and, with offline, journal reads too:
    the heal then classifies them OFFLINE and the queue backs off)."""

    def __init__(self, pkg, drives, offline=True):
        self.drives = drives
        self.methods = WRITES + (("read_version",) if offline else ())
        faulty = (jax_se if pkg == "jax" else torch_se).FaultyDisk

        def fail(*_a, **_kw):
            raise faulty("injected")

        for d in drives:
            for m in self.methods:
                setattr(d, m, fail)

    def restore(self):
        for d in self.drives:
            for m in self.methods:
                delattr(d, m)


def _all_ok(pkg, paths, key, version_id=""):
    """The other package's dry-run heal finds every drive ok."""
    res = _layer(pkg, paths, enable_mrf=False).heal_object(
        BUCKET, key, version_id, dry_run=True)
    return [s.state for s in res.before] == ["ok"] * len(paths)


def _files(paths, key):
    out = {}
    for i, p in enumerate(paths):
        for f in sorted(glob.glob(os.path.join(p, BUCKET, key, "*", "part.*"))):
            out[(i, os.path.basename(f))] = open(f, "rb").read()
    return out


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("size", [300 << 10, 2000], ids=["streamed", "inline"])
def test_partial_put_queues_and_drains(tmp_path, layers, pkg, size):
    """A PUT with 2 drives refusing writes answers success and queues the
    object; once the drives are back, the queue drains it and the other
    package sees every drive ok. (The JAX package queues streamed PUTs
    only: its inline PUT leaves the missed journals to the next heal.)"""
    paths = _paths(tmp_path)
    lay = layers(pkg, paths)
    lay.make_bucket(BUCKET)
    data = _payload(size, 1)
    bad = _Refuse(pkg, [lay.drives[3], lay.drives[8]])
    info = lay.put_object(BUCKET, "obj", io.BytesIO(data), size)
    assert info.size == size
    queued = not (pkg == "jax" and size <= 16 << 10)
    bad.restore()
    assert lay.mrf.wait_idle(WAIT)
    assert _all_ok(_other(pkg), paths, "obj") is queued
    _info, it = _layer(_other(pkg), paths, False).get_object(BUCKET, "obj")
    assert b"".join(bytes(c) for c in it) == data


@pytest.mark.parametrize("pkg", PKGS)
def test_partial_complete_queues_and_drains(tmp_path, layers, pkg):
    paths = _paths(tmp_path)
    lay = layers(pkg, paths)
    lay.make_bucket(BUCKET)
    parts = [_payload(MIN_PART_SIZE, 2), _payload(100_000, 3)]
    uid = lay.new_multipart_upload(BUCKET, "mp")
    etags = [lay.put_object_part(BUCKET, "mp", uid, n, io.BytesIO(p), len(p)).etag
             for n, p in enumerate(parts, 1)]
    Part = JaxPart if pkg == "jax" else TorchPart
    bad = _Refuse(pkg, [lay.drives[0], lay.drives[11]])
    lay.complete_multipart_upload(BUCKET, "mp", uid,
                                  [Part(n, e) for n, e in enumerate(etags, 1)])
    bad.restore()
    assert lay.mrf.wait_idle(WAIT)
    assert _all_ok(_other(pkg), paths, "mp")
    assert len(_files(paths, "mp")) == 2 * 12


@pytest.mark.parametrize("pkg", PKGS)
def test_corrupt_get_queues_a_deep_heal(tmp_path, layers, pkg):
    """A GET over a flipped byte in a data shard returns the right bytes
    and queues a deep heal, which rewrites that shard file equal to the
    original."""
    paths = _paths(tmp_path)
    lay = layers(pkg, paths)
    lay.make_bucket(BUCKET)
    data = _payload(700 << 10, 4)
    lay.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    assert lay.mrf.wait_idle(WAIT)
    orig = _files(paths, "obj")
    fi = TorchDrive(paths[0]).read_version(BUCKET, "obj")
    victim = fi.erasure.distribution.index(1)      # holds data shard 1
    f = glob.glob(os.path.join(paths[victim], BUCKET, "obj", "*", "part.1"))[0]
    raw = bytearray(open(f, "rb").read())
    raw[40] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    _info, it = lay.get_object(BUCKET, "obj")
    assert b"".join(bytes(c) for c in it) == data
    assert lay.mrf.wait_idle(WAIT)
    assert _files(paths, "obj") == orig


@pytest.mark.parametrize("pkg", PKGS)
def test_offline_heal_is_requeued_until_the_drive_returns(tmp_path, layers, pkg):
    paths = _paths(tmp_path)
    lay = layers(pkg, paths)
    lay.make_bucket(BUCKET)
    data = _payload(200 << 10, 5)
    bad = _Refuse(pkg, [lay.drives[6]])
    lay.put_object(BUCKET, "obj", io.BytesIO(data), len(data))
    assert not lay.mrf.wait_idle(0.6)          # backing off while offline
    assert lay.mrf._attempts.get((BUCKET, "obj", ""), 0) >= 2
    bad.restore()
    assert lay.mrf.wait_idle(WAIT)
    assert _all_ok(_other(pkg), paths, "obj")
    assert not lay.mrf._attempts                   # the episode is over


class _Gate:
    """A stand-in object layer whose first heal blocks until released."""

    def __init__(self):
        self.calls, self.release, self.entered = [], threading.Event(), threading.Event()

    def heal_object(self, bucket, obj, version_id="", scan_deep=False, **_kw):
        self.calls.append((obj, scan_deep))
        if len(self.calls) == 1:
            self.entered.set()
            self.release.wait(WAIT)
        return torch_healing.HealResultItem()


@pytest.mark.parametrize("pkg", PKGS)
def test_shallow_entry_upgraded_to_deep(pkg):
    """While one heal runs, a shallow add and then a deep add of another
    key leave one pending entry, deep; a repeat add of the running key
    queues it again (it read its metadata before the new damage)."""
    mod = jax_healing if pkg == "jax" else torch_healing
    gate = _Gate()
    mrf = mod.MRFHealer(gate)
    try:
        mrf.add_partial(BUCKET, "a")
        assert gate.entered.wait(WAIT)
        mrf.add_partial(BUCKET, "b")
        mrf.add_partial(BUCKET, "b", deep=True)
        mrf.add_partial(BUCKET, "b")               # stays deep
        mrf.add_partial(BUCKET, "a", deep=True)    # in flight: queued again
        gate.release.set()
        assert mrf.wait_idle(WAIT)
    finally:
        mrf.close()
    assert gate.calls == [("a", False), ("b", True), ("a", True)]


@pytest.mark.parametrize("pkg", PKGS)
def test_deleted_object_drops_out(tmp_path, layers, pkg):
    paths = _paths(tmp_path)
    lay = layers(pkg, paths)
    lay.make_bucket(BUCKET)
    data = _payload(100 << 10, 6)
    lay.put_object(BUCKET, "gone", io.BytesIO(data), len(data))
    lay.delete_object(BUCKET, "gone")
    lay.mrf.add_partial(BUCKET, "gone")
    lay.mrf.add_partial(BUCKET, "never-was", deep=True)
    assert lay.mrf.wait_idle(WAIT)
    assert not lay.mrf._attempts and not lay.mrf._retry


def test_close_joins_the_thread(tmp_path):
    lay = _layer("torch", _paths(tmp_path))
    t = lay.mrf._thread
    assert t.is_alive() and t.daemon
    lay.close()
    assert not t.is_alive()
    assert _layer("torch", _paths(tmp_path), enable_mrf=False).mrf is None
