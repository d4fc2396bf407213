"""Wire parity of the port's node fabric (minio_tpu_torch/dist) with the JAX
package's (minio_tpu/dist): tokens, the msgpack documents every plane
sends, the fault plane's seeded draws, and every route of the storage,
lock, peer and bootstrap planes driven by each package's client against
each package's NodeServer. The four (client, server) pairings must give
the same answers and the same typed errors, offline included. Inputs are
made from a seed with numpy; tolerance: exact bytes."""

import hashlib
import time

import msgpack
import numpy as np
import pytest

from tests import torch_dist as td
from tests.torch_dist import fast_clients  # noqa: F401 - the fixture

PKGS = ("jax", "torch")


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


# -- tokens and documents -----------------------------------------------------

def test_tokens_equal_and_cross_verify():
    now = 1_700_000_000.25
    for secret in ("s", "cluster-secret", "ünïcode-sécret"):
        tj = td.jax_rpc.sign_token(secret, now=now)
        tt = td.torch_rpc.sign_token(secret, now=now)
        assert tj == tt
        assert td.torch_rpc.verify_token(secret, tj, now=now + 10)
        assert td.jax_rpc.verify_token(secret, tt, now=now + 10)
        assert not td.torch_rpc.verify_token(secret + "x", tj, now=now)
        assert not td.torch_rpc.verify_token(secret, tj, now=now + 901)
    assert not td.torch_rpc.verify_token("s", "garbage")


def _fi_doc(pkg, seed):
    """One FileInfo of each package (float mod times, bin checksums,
    inline data) as its wire document."""
    m = td.PKG[pkg]
    from minio_tpu.storage import fileinfo as jfi
    from minio_tpu_torch.storage import fileinfo as tfi

    f = jfi if pkg == "jax" else tfi
    rng = np.random.default_rng(seed)
    fi = f.FileInfo(volume="bkt", name="a/b.bin", version_id="v-1",
                    data_dir="dd-1", mod_time=1_700_000_000.123456,
                    size=123_457, metadata={"etag": "e" * 32, "content-type": "x/y"},
                    fresh=True)
    fi.parts = [f.PartInfo(1, 123_457, 123_457, 1_700_000_000.5, "p1")]
    fi.erasure = f.ErasureInfo(data_blocks=8, parity_blocks=4, block_size=1 << 20,
                               index=3, distribution=list(range(1, 13)),
                               checksums=[f.ChecksumInfo(1, "mxsum256",
                                                         rng.bytes(32))])
    fi.inline_data = rng.bytes(700)
    return m.storage.fi_to_wire(fi)


def test_pack_equals_jax_on_every_document_type():
    docs = [
        _fi_doc("torch", 3),
        {"err": "FileNotFound", "msg": "bkt/obj"},
        {"total": 1 << 40, "free": 123, "used": 456, "used_inodes": 7,
         "endpoint": "http://h:9000/d1", "mount_path": "/d1", "id": "u-1",
         "healing": False, "error": "", "metrics": {}},
        [{"name": "bkt", "created": 1_700_000_000.5}],
        {"uid": "u", "res": ["bkt/obj", "bkt/o2"], "owner": "h:9000", "ro": False},
        {"ok": True},
        {"sig": "ab" * 32, "version": "1", "time": 1_700_000_000.75},
        {"node": "h:9000", "timelines": [{"api": "PutObject", "stages": [0.5, 1.25]}]},
        {"n": "a/b", "m": _payload(3000, 1)},
        {"token": ""}, {"n": 1 << 33}, {"size": -1}, {"hb": 1},
    ]
    for doc in docs:
        assert td.torch_rpc.pack(doc) == td.jax_rpc.pack(doc) == msgpack.packb(doc)
        assert td.torch_rpc.unpack(td.jax_rpc.pack(doc)) == doc
    assert td.torch_rpc.pack(_fi_doc("torch", 3)) == td.jax_rpc.pack(_fi_doc("jax", 3))
    # Each package's FileInfo survives the other's wire decoding.
    tfi = td.torch_storage.fi_from_wire(td.jax_rpc.unpack(
        td.jax_rpc.pack(_fi_doc("jax", 5))))
    assert td.torch_rpc.pack(td.torch_storage.fi_to_wire(tfi)) == \
        td.jax_rpc.pack(_fi_doc("jax", 5))


def test_lock_args_documents_equal():
    for ro in (False, True):
        a = td.jax_dsync.LockArgs("u1", ["b/o", "b/p"], "own", ro)
        b = td.torch_dsync.LockArgs("u1", ["b/o", "b/p"], "own", ro)
        assert td.jax_rpc.pack(a.to_doc()) == td.torch_rpc.pack(b.to_doc())
        assert td.torch_dsync.LockArgs.from_doc(a.to_doc()) == b


def test_faultplane_schedule_equal_for_a_seed():
    for seed in (0, 7, 1 << 40):
        planes = [m.FaultPlane(seed=seed) for m in (td.jax_faultplane, td.torch_faultplane)]
        for fp in planes:
            fp.add_rule("delay", peer="a:1", delay=0.01, jitter=0.5)
            fp.add_rule("delay", route="read_version", delay=0.0, jitter=2.0, times=3)
            fp.add_rule("truncate", after_bytes=100)
            fp.partition("p1", ["a:1"], ["b:2", "c:3"])
            fp.isolate("half", "a:1", "d:4")
        assert planes[0].schedule(16) == planes[1].schedule(16)
        assert planes[0].describe() == planes[1].describe()
    from minio_tpu import chaos as jax_chaos
    from minio_tpu_torch import chaos as torch_chaos

    for name in ("net", "drive"):
        assert torch_chaos.subseed(5, name) == jax_chaos.subseed(5, name)


# -- every route, each client against each server ------------------------------

def _shard_file(fi_doc, data):
    """A sha256-framed shard file of `data` for the erasure info in fi_doc
    (the host algorithm both packages verify the same way)."""
    ec = fi_doc["ec"]
    shard = -(-ec["bs"] // ec["k"])
    out = b""
    for i in range(0, len(data), shard):
        c = data[i:i + shard]
        out += hashlib.sha256(c).digest() + c
    return out


def _small_fi_doc(pkg):
    """A 2+2 version with one 100-byte part and sha256 bitrot: each shard
    file holds chunks of 32 and 18 bytes."""
    m = td.PKG[pkg]
    doc = {"t": 1, "vid": "", "mt": 1_700_000_001.5, "dd": "dd-9", "sz": 100,
           "meta": {"etag": "x"}, "parts": [{"number": 1, "size": 100,
                                              "actual_size": 100,
                                              "mod_time": 1_700_000_001.5,
                                              "etag": ""}],
           "ec": {"algo": "rs-vandermonde", "k": 2, "m": 2, "bs": 64, "idx": 1,
                  "dist": [1, 2, 3, 4], "cks": [{"p": 1, "a": "sha256", "h": b""}]},
           "_vol": "bkt", "_name": "obj", "_fresh": False}
    return m.storage.fi_from_wire(doc), doc


def _seek_read(f, off, n):
    f.seek(off)
    return f.read(n)


def _run_routes(cpkg, port, disk, spkg_drive_root):
    """Drive every route through `cpkg`'s client pieces; -> the list of
    (step, normalized result or typed error name)."""
    m = td.PKG[cpkg]
    out = []

    def step(name, fn, norm=lambda r: r):
        try:
            out.append((name, norm(fn())))
        except Exception as e:  # noqa: BLE001 - the typed error is the answer
            out.append((name, "ERR:" + type(e).__name__))

    c = td.client(cpkg, port)
    d = m.storage.RemoteDrive(c, disk, endpoint="http://n:9000" + disk)
    bogus = m.storage.RemoteDrive(c, "/no/such", endpoint="x")
    fi, fi_doc = _small_fi_doc(cpkg)
    part = _payload(50, 11)
    fmt = {"version": 1, "format": "xl", "id": "dep-1",
           "erasure": {"this": "u-1", "sets": [["u-1", "u-2"]],
                       "distribution_algo": "SIPMOD+PARITY"}}

    step("read_format_blank", d.read_format)
    step("write_format", lambda: d.write_format(fmt))
    step("read_format", d.read_format)
    step("get_disk_id", d.get_disk_id)
    step("set_disk_id", lambda: d.set_disk_id("u-1"))
    step("disk_info", d.disk_info,
         lambda di: (di.endpoint, di.id, di.healing, di.total > 0))
    step("bogus_disk", lambda: bogus.read_format())
    step("stat_vol_missing", lambda: d.stat_vol("bkt"))
    step("make_vol", lambda: d.make_vol("bkt"))
    step("make_vol_again", lambda: d.make_vol("bkt"))
    step("list_vols", d.list_vols, lambda vs: [v.name for v in vs])
    step("stat_vol", lambda: d.stat_vol("bkt"), lambda v: v.name)
    step("write_all", lambda: d.write_all("bkt", "cfg/a.json", b'{"a": 1}'))
    step("read_all", lambda: d.read_all("bkt", "cfg/a.json"))
    step("read_all_missing", lambda: d.read_all("bkt", "cfg/zz"))
    step("list_dir", lambda: d.list_dir("bkt", "cfg"))
    step("create_file", lambda: d.create_file(
        "bkt", "tmp1/part.1", iter([_shard_file(fi_doc, part)[:40],
                                         _shard_file(fi_doc, part)[40:]])))
    step("append_file", lambda: d.append_file("bkt", "log/x", b"one"))
    step("append_file2", lambda: d.append_file("bkt", "log/x", b"two"))
    step("read_appended", lambda: d.read_all("bkt", "log/x"))
    step("stat_file", lambda: d.read_file_stream("bkt", "tmp1/part.1").seek(0, 2))
    step("stat_file_missing", lambda: d.read_file_stream("bkt", "nope"))
    step("read_file_stream", lambda: d.read_file_stream(
        "bkt", "tmp1/part.1").read(70))
    step("read_range", lambda: _seek_read(d.read_file_stream("bkt", "tmp1/part.1"),
                                          10, 30))
    step("rename_file", lambda: d.rename_file("bkt", "cfg/a.json", "bkt", "cfg/b.json"))
    step("list_dir2", lambda: d.list_dir("bkt", "cfg"))
    step("rename_data", lambda: d.rename_data("bkt", "tmp1", fi, "bkt", "obj",
                                              defer_reclaim=True), lambda t: t)
    step("read_version", lambda: d.read_version("bkt", "obj"),
         lambda f: td.PKG[cpkg].rpc.pack(m.storage.fi_to_wire(f)))
    step("read_version_missing", lambda: d.read_version("bkt", "nope"))
    step("read_xl", lambda: d.read_xl("bkt", "obj"))
    step("check_parts", lambda: d.check_parts("bkt", "obj", fi))
    step("verify_file", lambda: d.verify_file("bkt", "obj", fi))
    step("verify_file_missing", lambda: d.verify_file("bkt", "nope", fi))
    fi2, _ = _small_fi_doc(cpkg)
    fi2.version_id, fi2.data_dir = "v-2", ""
    fi2.inline_data, fi2.parts = b"inline!", []
    step("write_metadata", lambda: d.write_metadata("bkt", "obj", fi2))
    j = m.storage.XLMeta()
    fi3, _ = _small_fi_doc(cpkg)
    fi3.name, fi3.data_dir, fi3.inline_data = "single", "", b"tiny"
    j.add_version(fi3)
    raw = j.serialize()
    step("write_metadata_single", lambda: d.write_metadata_single(
        "bkt", "single", fi3, raw, defer_reclaim=False))
    step("read_xl_single", lambda: d.read_xl("bkt", "single"))
    step("walk_dir", lambda: [(e.name, e.meta) for e in d.walk_dir("bkt")])
    step("walk_dir_after", lambda: [e.name for e in d.walk_dir("bkt", "", "obj")])
    step("delete_version", lambda: d.delete_version("bkt", "obj", fi2))
    step("read_xl_after_delete", lambda: d.read_xl("bkt", "obj"))
    step("undo_rename", lambda: d.undo_rename("bkt", "obj", fi, None))
    step("read_version_undone", lambda: d.read_version("bkt", "obj"))
    step("commit_rename", lambda: d.commit_rename("reclaim-none"))
    step("delete", lambda: d.delete("bkt", "log/x"))
    step("delete_missing", lambda: d.delete("bkt", "log/x"))
    step("delete_vol_not_empty", lambda: d.delete_vol("bkt"))
    step("delete_vol_force", lambda: d.delete_vol("bkt", force=True))
    step("list_vols_after", d.list_vols, lambda vs: [v.name for v in vs])

    # -- lock plane --
    lk = m.dsync.RemoteLocker(c)
    A = m.dsync.LockArgs
    w1, w2 = A("u1", ["b/o"], "n1"), A("u2", ["b/o"], "n2")
    r1, r2 = A("u3", ["b/p"], "n1", True), A("u4", ["b/p"], "n2", True)
    for name, call in (("lock", lambda: lk.lock(w1)), ("lock_busy", lambda: lk.lock(w2)),
                       ("rlock_on_write", lambda: lk.rlock(A("u5", ["b/o"], "x", True))),
                       ("refresh", lambda: lk.refresh(w1)),
                       ("refresh_unknown", lambda: lk.refresh(w2)),
                       ("unlock", lambda: lk.unlock(w1)), ("lock2", lambda: lk.lock(w2)),
                       ("rlock", lambda: lk.rlock(r1)), ("rlock2", lambda: lk.rlock(r2)),
                       ("lock_on_read", lambda: lk.lock(A("u6", ["b/p"], "x"))),
                       ("runlock", lambda: lk.runlock(r1)),
                       ("force_unlock", lambda: lk.force_unlock(A("", ["b/o", "b/p"], "a"))),
                       ("lock_after_force", lambda: lk.lock(A("u7", ["b/o", "b/p"], "x"))),
                       ("is_online", lk.is_online)):
        step(name, call)

    # -- peer and bootstrap planes --
    pc = m.peer.PeerClient(c, name="n2:9000")
    step("health", pc.health)
    step("invalidate", lambda: pc.invalidate_bucket_metadata("bkt"))
    step("reload_iam", pc.reload_iam)
    step("server_info", pc.server_info)
    step("obd_info", pc.obd_info)
    step("metrics", pc.metrics)
    step("perf_timeline", lambda: pc.perf_timeline({"traceid": "t1", "api": "", "worst": "2"}))
    step("slo", pc.slo)
    step("consolelog", lambda: list(pc.console_stream()))
    step("profile_start", lambda: pc.profile_start("cpu"))
    step("profile_download", pc.profile_download)
    step("verify_bootstrap", pc.verify_bootstrap, lambda doc: (doc["sig"], doc["version"]))
    pc.close()
    c.close()
    return out


def _hooks(pkg, seen):
    h = td.PKG[pkg].peer.PeerHooks()
    h.on_bucket_metadata_invalidate = lambda b: seen.append(("inv", b))
    h.on_iam_reload = lambda: seen.append(("iam",))
    h.server_info = lambda: {"node": "n2:9000", "mode": "online", "uptime": 1.5}
    h.obd_info = lambda: {"node": "n2:9000", "drives": []}
    h.metrics = lambda: b"# HELP x y\n# TYPE x gauge\nx 1\n"
    h.perf_timeline = lambda p: {"node": "n2:9000", "params": dict(p)}
    return h


def test_every_route_same_answers_both_ways(tmp_path, fast_clients):
    results = {}
    for spkg in PKGS:
        for cpkg in PKGS:
            root = tmp_path / f"{spkg}-{cpkg}"
            drive = td.make_drive(spkg, root, endpoint="http://n:9000/d1")
            seen = []
            kw = {"device": "cpu"} if spkg == "torch" else {}
            srv, _locker, _hooks_ = td.node_server(spkg, {"/d1": drive},
                                                   sig="s" * 64,
                                                   hooks=_hooks(spkg, seen), **kw)
            try:
                results[(spkg, cpkg)] = (_run_routes(cpkg, srv.port, "/d1", root),
                                         seen)
            finally:
                srv.close()
                drive.close_wal()
    base = results[("jax", "jax")]
    steps = [s for s, _ in base[0]]
    assert len(steps) > 60
    for key, got in results.items():
        assert [s for s, _ in got[0]] == steps
        for (s, a), (_, b) in zip(base[0], got[0]):
            assert a == b, (key, s, a, b)
        assert got[1] == [("inv", "bkt"), ("iam",)], key
    answers = dict(base[0])
    # The script exercises what it claims: typed errors and real answers.
    assert answers["read_all_missing"] == "ERR:FileNotFound"
    assert answers["bogus_disk"] == "ERR:DiskNotFound"
    assert answers["make_vol_again"] == "ERR:VolumeExists"
    assert answers["delete_vol_not_empty"] == "ERR:VolumeNotEmpty"
    assert answers["verify_file"] is None and answers["check_parts"] is None
    assert answers["verify_file_missing"] == "ERR:FileNotFound"
    assert answers["profile_start"] == "ERR:FaultyDisk"
    assert answers["lock"] is True and answers["lock_busy"] is False
    assert answers["lock_after_force"] is True
    assert answers["read_appended"] == b"onetwo"
    assert answers["walk_dir_after"] == ["single"]


def test_trace_stream_crosses_both_ways(fast_clients):
    import threading

    from minio_tpu.admin.pubsub import PubSub as JaxBus
    from minio_tpu_torch.admin.pubsub import PubSub as TorchBus

    for spkg, bus_cls in (("jax", JaxBus), ("torch", TorchBus)):
        for cpkg in PKGS:
            hooks = td.PKG[spkg].peer.PeerHooks()
            hooks.trace_bus = bus_cls()
            srv, _, _ = td.node_server(spkg, {}, hooks=hooks)
            try:
                pc = td.PKG[cpkg].peer.PeerClient(td.client(cpkg, srv.port))
                got = []

                def pull(it=pc.trace_stream()):
                    for doc in it:
                        got.append(doc)
                        if len(got) == 2:
                            return

                t = threading.Thread(target=pull, daemon=True)
                t.start()
                deadline = time.monotonic() + 5
                while not hooks.trace_bus.has_subscribers and time.monotonic() < deadline:
                    time.sleep(0.01)
                hooks.trace_bus.publish({"api": "PutObject", "durationNs": 12})
                hooks.trace_bus.publish({"api": "GetObject", "b": b"\x00\x01"})
                t.join(timeout=5)
                assert got == [{"api": "PutObject", "durationNs": 12},
                               {"api": "GetObject", "b": b"\x00\x01"}], (spkg, cpkg)
            finally:
                srv.close()


def test_offline_peer_gives_the_same_typed_answers(fast_clients):
    port = td.free_port()   # nothing listens there
    out = {}
    for cpkg in PKGS:
        m = td.PKG[cpkg]
        c = td.client(cpkg, port, timeout=1.0)
        d = m.storage.RemoteDrive(c, "/d1")
        answers = []
        for call in (d.read_format, lambda: d.read_all("b", "x"), d.disk_info):
            try:
                call()
                answers.append("ok")
            except Exception as e:  # noqa: BLE001
                answers.append(type(e).__name__)
        answers.append(c.breaker_state())
        answers.append(m.dsync.RemoteLocker(c).lock(m.dsync.LockArgs("u", ["r"], "o")))
        answers.append(d.is_online())
        try:
            m.peer.PeerClient(c).health()
        except Exception as e:  # noqa: BLE001
            answers.append(type(e).__name__)
        c.close()
        out[cpkg] = answers
    assert out["jax"] == out["torch"] == [
        "DiskNotFound", "DiskNotFound", "DiskNotFound",
        td.torch_rpc.BREAKER_OPEN, False, False, "DiskNotFound"]


def test_bad_token_is_refused_by_both_servers():
    for spkg in PKGS:
        srv, _, _ = td.node_server(spkg, {})
        try:
            for cpkg in PKGS:
                c = td.PKG[cpkg].rpc.RestClient("127.0.0.1", srv.port, "wrong",
                                                timeout=2.0, retries=0)
                with pytest.raises(Exception) as ei:
                    c.call("/rpc/peer/v1/health")
                assert type(ei.value).__name__ == "FaultyDisk"
                assert "403" in str(ei.value)
                c.close()
        finally:
            srv.close()
