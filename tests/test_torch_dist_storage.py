"""Remote drives across packages (minio_tpu_torch/dist/storage_remote.py
against minio_tpu/dist/storage_remote.py): one 12-drive set at EC 8+4
and 64 KiB blocks (the block cut to keep the CPU run short), whose
drives 0-3 are the writer's own and drives 4-11 sit behind two
NodeServers of the other package (4 drives each). The port's
ErasureObjects writes shard files and journals byte-equal to what the
JAX ErasureObjects writes over the same layout; each package reads, and
degraded-reads with one NodeServer's 4 drives refused by its fault plane,
the other's objects. Also the repairs of the port's drive plane for
remote drives: an inline PUT commits on every drive (the WAL's two-phase
submit exists only on a local drive), and the port-only drive entries
are never asked of a remote drive, or answer as a drive that cannot say.

Runs with both packages' metadata plane on (the default) and off. Inputs
from a seed with numpy; tolerance: exact bytes."""

import io
import os

import numpy as np
import pytest

import minio_tpu.erasure.objects as jax_objects_mod
import minio_tpu.storage.fileinfo as jax_fileinfo_mod
import minio_tpu_torch.erasure.objects as torch_objects_mod
import minio_tpu_torch.storage.fileinfo as torch_fileinfo_mod
from minio_tpu.erasure.objects import ErasureObjects as JaxObjects
from minio_tpu_torch.erasure.objects import ErasureObjects as TorchObjects
from tests import torch_dist as td
from tests.torch_dist import fast_clients  # noqa: F401 - the fixture

BS = 64 << 10
BUCKET = "remote"
SIZES = {"inline.bin": 1 << 10, "mid.bin": 300 << 10, "big.bin": (1 << 20) + 12345}
OTHER = {"jax": "torch", "torch": "jax"}
MODS = {"jax": (jax_objects_mod, jax_fileinfo_mod),
        "torch": (torch_objects_mod, torch_fileinfo_mod)}


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture(params=["metaplane_on", "metaplane_off"])
def metaplane(request, monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "1" if request.param == "metaplane_on" else "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    return request.param == "metaplane_on"


class Layout:
    """`pkg`'s ErasureObjects over 4 own drives and 8 drives served by two
    NodeServers of the other package (named srv1 and srv2)."""

    def __init__(self, root, pkg):
        self.root, self.pkg = root, pkg
        self.paths = [str(root / f"d{i}") for i in range(12)]
        spkg = OTHER[pkg]
        kw = {"device": "cpu"} if spkg == "torch" else {}
        self.served = [td.make_drive(spkg, p) for p in self.paths[4:]]
        self.servers = []
        for g in range(2):
            drives = {f"/d{4 + 4 * g + i}": self.served[4 * g + i] for i in range(4)}
            self.servers.append(td.node_server(spkg, drives, **kw)[0])
        self.layer = None
        self.mount(pkg)

    def mount(self, pkg):
        """(Re)build the layer in `pkg` over the same layout (the local
        drives change hands; the served ones stay with their servers)."""
        if self.layer is not None:
            self.layer.close()
            for d in self.local:
                d.close_wal()
            for c in self.clients:
                c.close()
        self.pkg = pkg
        m = td.PKG[pkg]
        self.local = [td.make_drive(pkg, p) for p in self.paths[:4]]
        self.clients = [td.client(pkg, s.port, name=f"srv{g + 1}")
                        for g, s in enumerate(self.servers)]
        remote = [m.storage.RemoteDrive(self.clients[(i - 4) // 4], f"/d{i}")
                  for i in range(4, 12)]
        drives = self.local + remote
        if pkg == "jax":
            self.layer = JaxObjects(drives, parity=4, block_size=BS,
                                    bitrot_algorithm="mxsum256")
        else:
            self.layer = TorchObjects(drives, parity=4, block_size=BS, device="cpu")
        return self.layer

    def settle(self):
        """Every journal on disk: close every WAL (they reopen on use)."""
        for d in self.local + self.served:
            d.close_wal()

    def tree(self):
        self.settle()
        out = {}
        for i, p in enumerate(self.paths):
            base = os.path.join(p, BUCKET)
            for root, _dirs, files in os.walk(base):
                for f in files:
                    full = os.path.join(root, f)
                    with open(full, "rb") as fh:
                        out[(i, os.path.relpath(full, base))] = fh.read()
        return out

    def close(self):
        self.layer.close()
        for c in self.clients:
            c.close()
        for s in self.servers:
            s.close()
        for d in self.local + self.served:
            d.close_wal()


def _get(layer, key):
    _info, it = layer.get_object(BUCKET, key)
    return b"".join(bytes(c) for c in it)


def _write_all(layer, pkg, clock):
    for t, (key, size) in enumerate(SIZES.items()):
        clock[0] = 1_700_000_000.0 + t
        layer.put_object(BUCKET, key, io.BytesIO(_payload(size, t)), size)


def test_shard_files_and_journals_byte_equal(tmp_path, metaplane, monkeypatch,
                                              fast_clients):
    layouts = {pkg: Layout(tmp_path / pkg, pkg) for pkg in ("jax", "torch")}
    try:
        for pkg, lay in layouts.items():
            clock = [0.0]
            td.pin(monkeypatch, *MODS[pkg], clock)
            clock[0] = 1_699_999_999.0
            lay.layer.make_bucket(BUCKET)
            _write_all(lay.layer, pkg, clock)
        trees = {pkg: lay.tree() for pkg, lay in layouts.items()}
        assert trees["torch"] == trees["jax"]
        keys = {k for _i, k in trees["torch"]}
        assert "inline.bin/meta.mp" in keys
        assert sum(1 for _i, k in trees["torch"] if k.endswith("part.1")) == 24
        # Every drive holds a journal of every key, remote ones included.
        assert len([1 for _i, k in trees["torch"] if k.endswith("meta.mp")]) == 36
    finally:
        for lay in layouts.values():
            lay.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_each_reads_and_degraded_reads_the_other(tmp_path, metaplane, writer,
                                                 fast_clients):
    lay = Layout(tmp_path, writer)
    try:
        lay.layer.make_bucket(BUCKET)
        for t, (key, size) in enumerate(SIZES.items()):
            lay.layer.put_object(BUCKET, key, io.BytesIO(_payload(size, t)), size)
        reader = OTHER[writer]
        lay.mount(reader)
        for t, (key, size) in enumerate(SIZES.items()):
            assert _get(lay.layer, key) == _payload(size, t)
        fp = td.PKG[reader].faultplane.install(seed=1)
        try:
            fp.isolate("cut", "", "srv2")   # drives 8-11 refused
            for t, (key, size) in enumerate(SIZES.items()):
                assert _get(lay.layer, key) == _payload(size, t)
            assert lay.clients[1].breaker_state() == td.PKG[reader].rpc.BREAKER_OPEN
        finally:
            td.PKG[reader].faultplane.uninstall()
    finally:
        lay.close()


def test_inline_put_commits_on_every_drive(tmp_path, monkeypatch, fast_clients):
    """Repair of the WAL submit: with the metadata plane on, an inline PUT
    through the port over remote drives commits on all 12 drives (a
    remote drive has no journal_commit_async, and the set takes the
    synchronous fan-out, as the JAX package does)."""
    monkeypatch.setenv("MTPU_METAPLANE", "1")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    lay = Layout(tmp_path, "torch")
    try:
        assert lay.layer._setcache is not None   # the two-phase path is live
        lay.layer.make_bucket(BUCKET)
        data = _payload(3000, 4)
        lay.layer.put_object(BUCKET, "tiny", io.BytesIO(data), len(data))
        for d in lay.layer.drives:
            fi = d.read_version(BUCKET, "tiny")
            assert fi.inline_data == data
        assert _get(lay.layer, "tiny") == data
    finally:
        lay.close()


def test_port_only_drive_entries_never_reach_a_remote_drive(tmp_path, monkeypatch,
                                                            fast_clients):
    """Repair of the port-only drive entries: a RemoteDrive lacks the WAL's
    two-phase submits, meta_sig, journal_known_absent, sys_volume,
    flush_wal and close_wal, and answers stat_file as a drive that cannot
    say, without an RPC; sys documents, the set FileInfo cache and the
    bucket documents work over it."""
    from minio_tpu_torch.bucket.meta import BucketMetadataSys

    monkeypatch.setenv("MTPU_METAPLANE", "1")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    lay = Layout(tmp_path, "torch")
    try:
        remote = lay.layer.drives[4]
        for name in ("journal_commit_async", "write_all_async", "meta_sig",
                     "journal_known_absent", "sys_volume", "flush_wal", "close_wal"):
            assert not hasattr(remote, name), name
        routes = []
        for c in lay.clients:
            call = c.call

            def counted(path, *a, _call=call, **kw):
                routes.append(path.rsplit("/", 1)[-1])
                return _call(path, *a, **kw)

            c.call = counted
        assert remote.stat_file(".mtpu.sys", "config/x") is None
        assert routes == []
        lay.layer.make_bucket(BUCKET)
        bm = BucketMetadataSys(lay.layer)
        bm.update(BUCKET, versioning_status="Enabled")
        sig = lay.layer.sys_config_signature(f"buckets/{BUCKET}/metadata.mp")
        assert all(s is not None for s in sig[:4]) and all(s is None for s in sig[4:])
        assert bm.get(BUCKET).versioning_enabled
        routes.clear()
        assert bm.get(BUCKET).versioning_enabled   # a cache hit
        assert routes == []
        data = _payload(200 << 10, 6)
        lay.layer.put_object(BUCKET, "k", io.BytesIO(data), len(data))
        assert _get(lay.layer, "k") == data
        assert _get(lay.layer, "k") == data         # the set cache's hit
    finally:
        lay.close()
