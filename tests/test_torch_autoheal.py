"""Drive heal of the port (minio_tpu_torch/erasure/autoheal.py and
format.py heal_format, plain PyTorch on the CPU) beside the JAX package's,
mirroring tests/test_autoheal.py with cross-package checks: the tracker
document both ways, a wrecked drive healed at boot by each package on
copies of the same drives (byte-equal trees), a resume from a bookmark,
live replacement and a stale UUID under a running AutoHealer, pacing, a
foreign drive never reformatted, and the S3 server's MRF and healer
threads. Intervals are pinned small (0.05 s) and every wait is bounded
(30 s). The JAX side runs with both batch planes off and
bitrot_algorithm="mxsum256". Tolerance: exact bytes."""

import io
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from minio_tpu.erasure import autoheal as jax_autoheal
from minio_tpu.erasure import format as jax_format
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu_torch.erasure import autoheal as torch_autoheal
from minio_tpu_torch.erasure import format as torch_format
from minio_tpu_torch.erasure import healing as torch_healing
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive

BS = 64 << 10
WAIT = 30.0


@pytest.fixture(autouse=True)
def planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _paths(root, n=6):
    return [str(root / f"d{i}") for i in range(n)]


def _tree(paths):
    """{(drive, relative path): bytes} of every file but the tmp area's."""
    out = {}
    for i, p in enumerate(paths):
        for root, dirs, files in os.walk(p):
            rel = os.path.relpath(root, p)
            if rel.split(os.sep)[:2] == [".mtpu.sys", "tmp"]:
                dirs[:] = []
                continue
            for f in files:
                full = os.path.join(root, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, p))] = fh.read()
    return out


def _wipe(root):
    """Remove a drive's tree and leave its empty root (a blank drive
    mounted at the same path). Retried: a live healer may be writing."""
    for _ in range(100):
        try:
            shutil.rmtree(root)
            break
        except OSError:
            time.sleep(0.05)
    else:
        raise AssertionError(f"could not wipe {root}")
    os.makedirs(root, exist_ok=True)


def _wait(cond, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        try:
            if cond():
                return
        except Exception:  # noqa: BLE001 - the drive is mid-rebuild
            pass
        time.sleep(0.05)
    raise AssertionError(f"{what} not reached in {WAIT} s")


# -- the tracker document --

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tracker_round_trips_between_packages(tmp_path, writer):
    fields = dict(drive_uuid="u1", started=1700000000.25, bucket="bkt", obj="o5",
                  healed=7, failed=1, finished_buckets=["abc"])
    w, r = ((jax_autoheal, torch_autoheal) if writer == "jax"
            else (torch_autoheal, jax_autoheal))
    Drive = JaxDrive if writer == "jax" else TorchDrive
    d = Drive(str(tmp_path / "d0"))
    assert w.HealingTracker.load(d) is None
    w.HealingTracker(**fields).save(d)
    raw = open(tmp_path / "d0" / ".mtpu.sys" / "healing.json", "rb").read()
    rd = (TorchDrive if writer == "jax" else JaxDrive)(str(tmp_path / "d0"))
    other = r.HealingTracker.load(rd)
    assert other.to_doc() == json.loads(raw)
    # The reader's save writes the same bytes back.
    other.save(rd)
    assert open(tmp_path / "d0" / ".mtpu.sys" / "healing.json", "rb").read() == raw
    r.HealingTracker.delete(rd)
    assert w.HealingTracker.load(d) is None


# -- boot-time heal --

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wrecked_drive_heals_at_boot(tmp_path, writer):
    """tests/test_autoheal.py::test_wrecked_drive_heals_on_restart in both
    packages on copies of the same drives: a blank drive 2 is claimed into
    its slot with a tracker at boot, one AutoHealer pass rebuilds it and
    removes the tracker, and the two healed trees are byte-equal."""
    paths = _paths(tmp_path / "orig")
    drives = [TorchDrive(p) for p in paths]
    torch_format.init_format_erasure(drives, 6)
    Layer = JaxObjects if writer == "jax" else TorchObjects
    kw = ({"bitrot_algorithm": "mxsum256"} if writer == "jax" else {"device": "cpu"})
    es = Layer([(JaxDrive if writer == "jax" else TorchDrive)(p) for p in paths],
               block_size=BS, **kw)
    es.make_bucket("bkta")
    es.make_bucket("bktb")
    payloads = {("bkta", "small"): _payload(100, 1), ("bkta", "big"): _payload(200_000, 2),
                ("bktb", "x/y/z"): _payload(70_000, 3)}
    for (b, name), p in payloads.items():
        es.put_object(b, name, io.BytesIO(p), len(p))
    _wipe(paths[2])
    shutil.rmtree(paths[2])                    # replaced: not even a root yet
    trees = {}
    for pkg in ("jax", "torch"):
        cp = [str(tmp_path / pkg / f"d{i}") for i in range(6)]
        for a, b in zip(paths, cp):
            if os.path.isdir(a):
                shutil.copytree(a, b)
        Drive, fmt, ah = ((JaxDrive, jax_format, jax_autoheal) if pkg == "jax"
                          else (TorchDrive, torch_format, torch_autoheal))
        drives2 = [Drive(p) for p in cp]
        fmt.init_format_erasure(drives2, 6)
        wrecked = next(d for d in drives2 if d.root.endswith("d2"))
        assert ah.HealingTracker.load(wrecked) is not None
        es2 = (JaxObjects(drives2, block_size=BS, bitrot_algorithm="mxsum256")
               if pkg == "jax" else TorchObjects(drives2, block_size=BS, device="cpu"))
        assert ah.AutoHealer(es2).run_once() == 1
        assert ah.HealingTracker.load(wrecked) is None
        for (b, name), want in payloads.items():
            _info, it = es2.get_object(b, name)
            assert b"".join(bytes(c) for c in it) == want
        trees[pkg] = _tree(cp)
    assert trees["jax"] == trees["torch"]
    assert any(k[0] == 2 and k[1].startswith("bkta/big/") for k in trees["torch"])


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_resume_skips_names_before_the_bookmark(tmp_path, pkg):
    paths = _paths(tmp_path)
    Drive, ah = ((JaxDrive, jax_autoheal) if pkg == "jax"
                 else (TorchDrive, torch_autoheal))
    drives = [Drive(p) for p in paths]
    torch_format.init_format_erasure([TorchDrive(p) for p in paths], 6)
    es = (JaxObjects(drives, block_size=BS, bitrot_algorithm="mxsum256")
          if pkg == "jax" else TorchObjects(drives, block_size=BS, device="cpu"))
    es.make_bucket("bkt")
    for i in range(6):
        p = _payload(50_000, 10 + i)
        es.put_object("bkt", f"o{i}", io.BytesIO(p), len(p))
    healed = []
    orig = es.heal_object

    def spy(bucket, obj, *a, **kw):
        healed.append(obj)
        return orig(bucket, obj, *a, **kw)

    es.heal_object = spy
    ah.HealingTracker(drive_uuid="u", bucket="bkt", obj="o2").save(drives[1])
    ah.AutoHealer(es).run_once()
    assert healed == ["o3", "o4", "o5"]
    assert ah.HealingTracker.load(drives[1]) is None


# -- live replacement --

def _live_set(tmp_path, n_objects, size):
    roots = _paths(tmp_path, 4)
    s = TorchSets([TorchDrive(r) for r in roots], parity=1, block_size=BS,
                  device="cpu")
    s.make_bucket("live")
    payloads = {}
    for i in range(n_objects):
        payloads[f"o{i}"] = data = _payload(size, 40 + i)
        s.put_object("live", f"o{i}", io.BytesIO(data), len(data))
    return roots, s, payloads


def test_live_replacement_under_a_running_healer(tmp_path):
    """A drive wiped under a running AutoHealer is claimed into its slot
    (format.json byte-equal to what the JAX package writes for it) and
    rebuilt, with no restart; reads then serve with another drive gone."""
    roots, s, payloads = _live_set(tmp_path, 8, 120_000)
    victim_uuid = s.format.sets[0][0]
    before = _tree(roots)
    healer = torch_autoheal.AutoHealer(s, interval=0.05)
    healer.start()
    try:
        _wipe(roots[0])
        _wait(lambda: (s.drives[0].read_format()["erasure"]["this"] == victim_uuid
                       and torch_autoheal.HealingTracker.load(s.drives[0]) is None),
              "reformat and rebuild of the wiped drive")
    finally:
        healer.close()
    ref = tmp_path / "jax-format"
    os.makedirs(ref)
    doc = jax_format.FormatInfo.from_doc(s.drives[1].read_format())
    JaxDrive(str(ref)).write_format(doc.to_doc(victim_uuid))
    assert (open(os.path.join(roots[0], ".mtpu.sys", "format.json"), "rb").read()
            == open(ref / ".mtpu.sys" / "format.json", "rb").read())
    after = _tree(roots)
    assert {k: v for k, v in after.items() if k[0] == 0 and k[1].startswith("live/")} \
        == {k: v for k, v in before.items() if k[0] == 0 and k[1].startswith("live/")}
    shutil.rmtree(os.path.join(roots[2], "live"))
    for name, data in payloads.items():
        _info, it = s.sets[0].get_object("live", name)
        assert b"".join(bytes(c) for c in it) == data
    s.close()


def test_stale_uuid_drive_is_reclaimed_live(tmp_path):
    """A drive of this deployment whose UUID no slot holds: the disk-ID
    guard refuses it, and the live healer reclaims it into its slot."""
    from minio_tpu_torch.utils import errors as se

    roots, s, payloads = _live_set(tmp_path, 5, 90_000)
    uuid0 = s.format.sets[0][0]
    base = s.drives[0]
    assert base.get_disk_id() == uuid0
    doc = base.read_format()
    doc["erasure"]["this"] = "00000000-dead-beef-0000-000000000000"
    shutil.rmtree(os.path.join(roots[0], "live"))
    base.write_format(doc)
    with pytest.raises(se.InconsistentDisk):
        base.get_disk_id()
    healer = torch_autoheal.AutoHealer(s, interval=0.05)
    healer.start()
    try:
        _wait(lambda: (base.get_disk_id() == uuid0
                       and torch_autoheal.HealingTracker.load(base) is None
                       and all(os.path.isdir(os.path.join(roots[0], "live", n))
                               for n in payloads)),
              "reclaim of the stale-UUID drive")
    finally:
        healer.close()
    for name, data in payloads.items():
        _info, it = s.sets[0].get_object("live", name)
        assert b"".join(bytes(c) for c in it) == data
    s.close()


def test_foreign_drive_is_never_reformatted(tmp_path):
    """A drive of another deployment in a slot: neither package's claim
    takes it, and heal_format leaves its format.json as it was."""
    roots, s, _ = _live_set(tmp_path, 1, 1000)
    doc = s.drives[3].read_format()
    doc["id"] = "11111111-2222-3333-4444-555555555555"
    s.drives[3].write_format(doc)
    raw = open(os.path.join(roots[3], ".mtpu.sys", "format.json"), "rb").read()
    assert torch_format.heal_format(s) == 0
    slot = s.format.sets[0][3]
    assert not torch_format._claim_slot(s.drives[3], s.format, slot)
    jfmt = jax_format.FormatInfo.from_doc(s.drives[0].read_format())
    assert not jax_format._claim_slot(JaxDrive(roots[3]), jfmt, slot)
    assert open(os.path.join(roots[3], ".mtpu.sys", "format.json"), "rb").read() == raw
    assert torch_autoheal.HealingTracker.load(s.drives[3]) is None
    s.close()


class _Config:
    def __init__(self, **kv):
        self.kv = kv

    def get(self, subsys, key):
        return self.kv[key] if subsys == "heal" else ""


def test_pacing_sleeps_under_load_only(tmp_path):
    """heal.max_sleep / heal.max_io: a busy server (load above max_io)
    sleeps up to max_sleep after each object; an idle one does not."""
    roots, s, _ = _live_set(tmp_path, 6, 1000)
    cfg = _Config(max_sleep="100ms", max_io="2")
    victim = s.drives[0]
    torch_autoheal.mark_drive_healing(victim, s.format.sets[0][0])
    t0 = time.monotonic()
    torch_autoheal.AutoHealer(s, config=cfg, load_fn=lambda: 5).run_once()
    busy = time.monotonic() - t0
    assert busy >= 0.5
    assert torch_autoheal.HealingTracker.load(victim) is None
    torch_autoheal.mark_drive_healing(victim, s.format.sets[0][0])
    t0 = time.monotonic()
    torch_autoheal.AutoHealer(s, config=cfg, load_fn=lambda: 0).run_once()
    assert time.monotonic() - t0 < busy / 2
    assert torch_autoheal.parse_duration("1.5s") == 1.5
    assert torch_autoheal.parse_duration("bad", 3.0) == 3.0
    s.close()


# -- the S3 server --

def _heal_threads():
    return [t for t in threading.enumerate()
            if t.name in ("mtpu-mrf", "mtpu-autoheal") and t.is_alive()]


def test_server_heals_a_partial_put_and_closes_its_threads(tmp_path, monkeypatch):
    from minio_tpu_torch.s3.server import build_server
    from minio_tpu_torch.utils import errors as se
    from tests.conftest import S3_ACCESS, S3_SECRET
    from tests.s3client import SigV4Client

    monkeypatch.setattr(torch_healing, "MRF_RETRY_INTERVAL", 0.05)
    monkeypatch.setattr(torch_healing, "MRF_RETRY_CAP", 0.2)
    roots = _paths(tmp_path)
    srv = build_server(roots, S3_ACCESS, S3_SECRET, device="cpu").start()
    srv.start_auto_heal(interval=0.05)
    es = srv.obj.pools[0].sets[0]
    try:
        assert es.mrf is not None and len(srv.auto_healer) == 1
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        assert cl.put("/web").status_code == 200
        data = _payload(300_000, 60)

        def fail(*_a, **_kw):
            raise se.FaultyDisk("injected")

        bad = es.drives[4]
        for m in ("create_file", "rename_data", "read_version"):
            setattr(bad, m, fail)
        assert cl.put("/web/obj", data=data).status_code == 200
        for m in ("create_file", "rename_data", "read_version"):
            delattr(bad, m)
        assert es.mrf.wait_idle(WAIT)
        res = es.heal_object("web", "obj", dry_run=True)
        assert [s.state for s in res.before] == ["ok"] * 6
        r = cl.get("/web/obj")
        assert r.status_code == 200 and r.content == data
        assert srv.current_requests == 0
    finally:
        srv.close()
    assert not _heal_threads()
