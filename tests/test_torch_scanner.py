"""The data scanner of the port (minio_tpu_torch/scanner/) against the JAX
package's (minio_tpu/scanner/), on the CPU.

- usage and update-tracker documents: the bytes each package writes are
  the other's, and each reads the other's;
- a cycle interrupted under one package resumes under the other from the
  checkpoint at scanner/cycle-position.mp;
- one cycle by each package over copies of the same drive directories
  (lifecycle expiry of latest versions, of noncurrent versions by their
  successor's time, of a lone delete marker, and of stale multipart
  uploads): equal usage bytes, equal surviving versions, equal uploads;
- `heal bitrotscan=on`: a byte flipped in a shard file is rebuilt, by the
  deep cycle, equal to a copy of the shard taken before;
- the live `scanner.cycle` and pacing keys read as the JAX scanner reads
  them.

Both packages run with the metadata and data planes off
(MTPU_METAPLANE=0, MTPU_BATCHED_DATAPLANE=0), so every journal is on disk
when a call returns; the JAX side writes mxsum256. Tolerance: exact.
"""

import glob
import io
import os
import shutil

import msgpack
import numpy as np
import pytest

from minio_tpu.bucket.meta import BucketMetadataSys as JaxMeta
from minio_tpu.erasure.pools import ErasureServerPools as JaxPools
from minio_tpu.erasure.sets import ErasureSets as JaxSets
from minio_tpu.erasure.types import ObjectOptions as JaxOpts
from minio_tpu.scanner import scanner as jscan
from minio_tpu.scanner import tracker as jtracker
from minio_tpu.scanner import usage as jusage
from minio_tpu.storage.local import LocalDrive as JaxDrive
from minio_tpu.utils import errors as jax_se
from minio_tpu_torch.bucket.meta import BucketMetadataSys as TorchMeta
from minio_tpu_torch.erasure.pools import ErasureServerPools as TorchPools
from minio_tpu_torch.erasure.sets import ErasureSets as TorchSets
from minio_tpu_torch.scanner import scanner as tscan
from minio_tpu_torch.scanner import tracker as ttracker
from minio_tpu_torch.scanner import usage as tusage
from minio_tpu_torch.storage.local import LocalDrive as TorchDrive
from minio_tpu_torch.utils import errors as tse

DAY = 86400.0
BS = 64 << 10
PINNED_T = 1_760_000_123.456789


@pytest.fixture(autouse=True)
def _planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


class _Clock:
    @staticmethod
    def time():
        return PINNED_T


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


class _MemStore:
    """A sys store in memory; a missing document raises `missing` (each
    package's own FileNotFound)."""

    def __init__(self, missing=tse.FileNotFound):
        self.docs = {}
        self.missing = missing

    def read_sys_config(self, path):
        try:
            return self.docs[path]
        except KeyError:
            raise self.missing(path) from None

    def write_sys_config(self, path, data):
        self.docs[path] = bytes(data)

    def delete_sys_config(self, path):
        self.docs.pop(path, None)


def _usage(mod, seed):
    rng = np.random.default_rng(seed)
    u = mod.DataUsageCache()
    u.cycles = int(rng.integers(0, 1 << 20))
    u.last_update = float(rng.random()) * 2e9
    for b in range(int(rng.integers(1, 6))):
        e = u.bucket(f"bucket-{b}")
        for _ in range(int(rng.integers(0, 40))):
            size = int(rng.choice([0, 1, 1023, 1024, 5 << 20, 70 << 20, 600 << 20,
                                   (1 << 33) + 7]))
            e.add_version(size, bool(rng.random() < 0.7), bool(rng.random() < 0.1))
    return u


@pytest.mark.parametrize("seed", range(6))
def test_usage_bytes_match_jax(seed):
    ju, tu = _usage(jusage, seed), _usage(tusage, seed)
    raw = ju.serialize()
    assert tu.serialize() == raw
    assert tusage.DataUsageCache.parse(raw).to_info() == ju.to_info()
    assert jusage.DataUsageCache.parse(tu.serialize()).to_info() == tu.to_info()
    for size in (0, 1023, 1024, (1 << 20) - 1, 1 << 20, 10 << 20, 64 << 20, 128 << 20,
                 512 << 20, 1 << 40):
        assert tusage.size_bucket(size) == jusage.size_bucket(size)


def test_usage_saved_by_one_loads_in_the_other(monkeypatch):
    monkeypatch.setattr(jusage, "time", _Clock)
    monkeypatch.setattr(tusage, "time", _Clock)
    js, ts = _MemStore(jax_se.FileNotFound), _MemStore()
    _usage(jusage, 7).save(js)
    _usage(tusage, 7).save(ts)
    assert ts.docs == js.docs
    assert tusage.DataUsageCache.load(js).to_info() == \
        jusage.DataUsageCache.load(ts).to_info()
    assert tusage.DataUsageCache.load(_MemStore()).buckets == {}
    assert jusage.DataUsageCache.load(_MemStore(jax_se.FileNotFound)).buckets == {}


def test_tracker_documents_match_jax():
    js, ts = _MemStore(jax_se.FileNotFound), _MemStore()
    jt, tt = jtracker.UpdateTracker(js), ttracker.UpdateTracker(ts)
    buckets = [f"b{i}" for i in range(6)]
    rng = np.random.default_rng(3)
    for cycle in range(40):
        for b in rng.choice(buckets, size=int(rng.integers(0, 4))):
            jt.mark(str(b))
            tt.mark(str(b))
        assert ts.docs == js.docs
        assert tt.begin_cycle(buckets) == jt.begin_cycle(buckets), cycle
        assert ts.docs == js.docs
    # Each package resumes the other's document.
    jt.mark("b1")
    ts.docs = dict(js.docs)
    t2 = ttracker.UpdateTracker(ts)
    j2 = jtracker.UpdateTracker(js)
    assert t2.begin_cycle(buckets) == j2.begin_cycle(buckets)
    assert ttracker.FULL_SWEEP_EVERY == jtracker.FULL_SWEEP_EVERY
    assert ttracker.PATH == jtracker.PATH


# -- object layers over drive directories --


def _jax_layer(paths):
    pools = JaxPools([JaxSets([JaxDrive(p) for p in paths], parity=2, block_size=BS,
                              bitrot_algorithm="mxsum256")])
    return pools, JaxMeta(pools)


def _torch_layer(paths):
    pools = TorchPools([TorchSets([TorchDrive(p) for p in paths], parity=2,
                                  block_size=BS, device="cpu")])
    return pools, TorchMeta(pools)


def _paths(root, n=6):
    return [str(root / f"d{i}") for i in range(n)]


def _close(layer):
    close = getattr(layer, "close", None)
    if close is not None:
        close()


LIFECYCLE = (b"<LifecycleConfiguration>"
             b"<Rule><ID>old-logs</ID><Status>Enabled</Status><Filter><Prefix>logs/"
             b"</Prefix></Filter><Expiration><Days>3</Days></Expiration></Rule>"
             b"<Rule><ID>noncurrent</ID><Status>Enabled</Status><Filter><Prefix>v/"
             b"</Prefix></Filter><NoncurrentVersionExpiration><NoncurrentDays>2"
             b"</NoncurrentDays></NoncurrentVersionExpiration></Rule>"
             b"<Rule><ID>markers</ID><Status>Enabled</Status><Filter><Prefix>m/"
             b"</Prefix></Filter><Expiration><ExpiredObjectDeleteMarker>true"
             b"</ExpiredObjectDeleteMarker></Expiration></Rule>"
             b"<Rule><ID>mpu</ID><Status>Enabled</Status><Filter><Prefix></Prefix>"
             b"</Filter><AbortIncompleteMultipartUpload><DaysAfterInitiation>1"
             b"</DaysAfterInitiation></AbortIncompleteMultipartUpload></Rule>"
             b"</LifecycleConfiguration>")


def _populate(root, now):
    """Drives written by the JAX package: an unversioned bucket with logs
    due and not due, a versioned bucket with noncurrent versions and a
    lone delete marker, a bucket without rules, and multipart uploads."""
    paths = _paths(root)
    pools, meta = _jax_layer(paths)
    for b in ("plain", "ver", "norule"):
        pools.make_bucket(b)
    meta.update("plain", lifecycle_xml=LIFECYCLE)
    meta.update("ver", lifecycle_xml=LIFECYCLE, versioning_status="Enabled")
    seed = 0
    for i in range(6):
        age = (1 + i) * DAY
        for b in ("plain", "norule"):
            data = _payload(int(np.random.default_rng(i).integers(1, 200_000)), seed)
            seed += 1
            pools.put_object(b, f"logs/{i}.log", io.BytesIO(data), len(data),
                             JaxOpts(mod_time=now - age))
    for i in range(3):
        for v in range(3):
            data = _payload(1000 + 97 * v, seed)
            seed += 1
            pools.put_object("ver", f"v/{i}", io.BytesIO(data), len(data),
                             JaxOpts(versioned=True, mod_time=now - (10 - 3 * v - i) * DAY))
    data = _payload(500, seed)
    pools.put_object("ver", "m/lone", io.BytesIO(data), len(data),
                     JaxOpts(versioned=True, mod_time=now - 9 * DAY))
    info = pools.delete_object("ver", "m/lone", JaxOpts(versioned=True))
    pools.delete_object("ver", "m/lone", JaxOpts(versioned=True,
                                                 version_id=pools.list_object_versions(
                                                     "ver", "m/").objects[-1].version_id))
    assert info.delete_marker
    for b in ("plain", "norule"):
        pools.new_multipart_upload(b, "upload/one", JaxOpts())
    _close(pools)
    return paths


def _survivors(pools, bucket):
    out = []
    res = pools.list_object_versions(bucket, "", "", "", "", 10000)
    for o in res.objects:
        out.append((o.name, o.delete_marker, "" if o.delete_marker else o.version_id,
                    o.size, "" if o.delete_marker else o.etag))
    return sorted(out)


def test_one_cycle_same_outcome_as_jax(tmp_path, monkeypatch):
    import time

    now = time.time()
    _populate(tmp_path / "src", now)
    shutil.copytree(tmp_path / "src", tmp_path / "j")
    shutil.copytree(tmp_path / "src", tmp_path / "t")
    monkeypatch.setattr(jusage, "time", _Clock)
    monkeypatch.setattr(tusage, "time", _Clock)
    later = now + 1.5 * DAY
    jp, jm = _jax_layer(_paths(tmp_path / "j"))
    tp, tm = _torch_layer(_paths(tmp_path / "t"))
    try:
        ju = jscan.DataScanner(jp, jm).scan_once(now=later)
        tu = tscan.DataScanner(tp, tm).scan_once(now=later)
        assert tu.serialize() == ju.serialize()
        assert ju.to_info()["objectsCount"] > 0
        jdocs = {p: jp.read_sys_config(p) for p in (jusage.DataUsageCache.PATH,
                                                    jtracker.PATH)}
        tdocs = {p: tp.read_sys_config(p) for p in jdocs}
        assert tdocs == jdocs
        for b in ("plain", "ver", "norule"):
            assert _survivors(tp, b) == _survivors(jp, b), b
            assert sorted(u.object for u in tp.list_multipart_uploads(b, "", 100)) == \
                sorted(u.object for u in jp.list_multipart_uploads(b, "", 100)), b
        # What expired: logs older than 3 days in "plain" only; the two
        # noncurrent versions whose successor is older than 2 days; the
        # lone delete marker; the stale upload of "plain".
        assert {n for n, *_ in _survivors(tp, "plain")} == {"logs/0.log"}
        assert len(_survivors(tp, "norule")) == 6
        assert not any(n == "m/lone" for n, *_ in _survivors(tp, "ver"))
        assert tp.list_multipart_uploads("plain", "", 100) == []
        assert len(tp.list_multipart_uploads("norule", "", 100)) == 1
    finally:
        _close(jp)
        _close(tp)


@pytest.mark.parametrize("first", ["jax", "torch"])
def test_interrupted_cycle_resumes_in_the_other_package(tmp_path, first):
    import time

    now = time.time()
    paths = _populate(tmp_path, now)
    build = {"jax": (_jax_layer, jscan), "torch": (_torch_layer, tscan)}
    (mk1, mod1), (mk2, mod2) = build[first], build["torch" if first == "jax" else "jax"]
    pools, meta = mk1(paths)
    sc = mod1.DataScanner(pools, meta)
    real = sc._scan_bucket
    seen = []

    def scan_then_stop(bucket, *a, **kw):
        real(bucket, *a, **kw)
        seen.append(bucket)
        sc._stop.set()   # a graceful stop after the first bucket

    sc._scan_bucket = scan_then_stop
    partial = sc.scan_once(now=now)
    assert seen == ["norule"] and partial.cycles == 1
    ckpt = pools.read_sys_config(mod1.POSITION_PATH)
    _close(pools)

    # A write to the finished bucket after the checkpoint: the resumed
    # cycle keeps the checkpoint's accounting of that bucket.
    pools, meta = mk2(paths)
    data = _payload(4321, 99)
    pools.put_object("norule", "late", io.BytesIO(data), len(data))
    sc2 = mod2.DataScanner(pools, meta)
    assert sc2._load_position() == msgpack.unpackb(ckpt, strict_map_key=False)
    done = sc2.scan_once(now=now)
    try:
        assert done.cycles == 1
        assert done.buckets["norule"].objects == 6   # from the checkpoint
        assert done.buckets["plain"].objects == 6 and done.buckets["ver"].versions > 0
        with pytest.raises(Exception):
            pools.read_sys_config(mod2.POSITION_PATH)   # cleared when complete
    finally:
        _close(pools)


def _shard_files(paths, bucket, key):
    return sorted(glob.glob(os.path.join(p, bucket, key, "*", "part.1")) for p in paths)


@pytest.mark.parametrize("bitrotscan", ["on", "off"])
def test_deep_cycle_heals_a_flipped_byte_with_bitrotscan(tmp_path, bitrotscan):
    from minio_tpu_torch.s3.server import build_server

    paths = _paths(tmp_path, 12)
    srv = build_server(paths, "scanroot", "scanroot-secret", device="cpu",
                       enable_mrf=False)
    try:
        srv.obj.make_bucket("deep")
        data = _payload((2 << 20) + 333, 5)
        srv.obj.put_object("deep", "obj", io.BytesIO(data), len(data))
        files = [f for fs in _shard_files(paths, "deep", "obj") for f in fs]
        assert len(files) == 12
        victim = files[3]
        good = open(victim, "rb").read()
        flipped = bytearray(good)
        flipped[len(flipped) // 2] ^= 0x5A
        with open(victim, "wb") as f:
            f.write(flipped)
        srv.config.set_kv("heal", {"bitrotscan": bitrotscan})
        srv.start_scanner(loop=False)
        srv.scanner.usage.cycles = tscan.HEAL_EVERY_N_CYCLES - 1   # next is deep
        usage = srv.scanner.scan_once()
        assert usage.cycles == tscan.HEAL_EVERY_N_CYCLES
        assert open(victim, "rb").read() == (good if bitrotscan == "on" else bytes(flipped))
        _info, it = srv.obj.get_object("deep", "obj")
        assert b"".join(bytes(c) for c in it) == data
    finally:
        srv.close()


class _Config:
    def __init__(self, kv):
        self.kv = kv

    def get(self, subsys, key):
        return self.kv.get((subsys, key), "")


@pytest.mark.parametrize("kv", [
    {}, {("scanner", "cycle"): "1m"}, {("scanner", "cycle"): "5s"},
    {("scanner", "cycle"): "250ms", ("scanner", "delay"): "2", ("scanner", "max_wait"): "3s"},
    {("scanner", "cycle"): "bogus"}, {("scanner", "delay"): "0"},
    {("heal", "bitrotscan"): "on"}])
def test_live_cycle_and_pacing_keys_read_as_in_jax(kv):
    cfg = _Config(kv)
    js = jscan.DataScanner(None, None, store=None, interval=42.0, config=cfg)
    ts = tscan.DataScanner(None, None, store=None, interval=42.0, config=cfg)
    assert ts._cycle_pause() == js._cycle_pause()
    js._load_pacing()
    ts._load_pacing()
    assert (ts._pace_delay, ts._pace_cap) == (js._pace_delay, js._pace_cap)
    assert (tscan.SCAN_INTERVAL, tscan.HEAL_EVERY_N_CYCLES, tscan.PAGE, tscan.POSITION_PATH) \
        == (jscan.SCAN_INTERVAL, jscan.HEAL_EVERY_N_CYCLES, jscan.PAGE, jscan.POSITION_PATH)


def test_server_starts_no_scanner_unless_asked(tmp_path):
    from minio_tpu_torch.s3.server import build_server

    srv = build_server(_paths(tmp_path, 4), "scanroot", "scanroot-secret", device="cpu",
                       enable_mrf=False)
    try:
        assert srv.scanner is None
        srv.start_scanner(interval=3600.0)
        assert srv.scanner._thread.is_alive()
    finally:
        srv.close()
    assert not srv.scanner._thread.is_alive()


def test_cli_scan_interval_default_and_off(monkeypatch):
    from minio_tpu_torch.s3 import server as tserver

    seen = {}

    class _Stop(Exception):
        pass

    def fake_build(*a, **kw):
        class S:
            def start_scanner(self, interval):
                seen["interval"] = interval

            def start_auto_heal(self):
                raise _Stop

        return S()

    monkeypatch.setattr(tserver, "build_server", fake_build)
    for argv, want in ((["d1"], 60.0), (["--scan-interval", "5", "d1"], 5.0),
                       (["--scan-interval", "0", "d1"], None)):
        seen.clear()
        with pytest.raises(_Stop):
            tserver.main(argv)
        assert seen.get("interval") == want, argv
