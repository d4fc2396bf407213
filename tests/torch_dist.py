"""Shared pieces of the distributed-plane tests (tests/test_torch_dist_*.py,
tests/test_torch_cluster.py): both packages' fabric modules side by side,
free ports, a NodeServer of either package with all four planes, and the
pinning of version ids and clocks that makes journals byte-equal.

Every wait in these tests has a deadline: RestClients take short
timeouts and retry intervals (`fast_clients`), bootstrap waits are a few
seconds, and lock waits are bounded.
"""

import itertools
import socket
import time
import types
import uuid

import pytest

from minio_tpu.admin import metrics as jax_metrics
from minio_tpu.dist import cluster as jax_cluster
from minio_tpu.dist import dsync as jax_dsync
from minio_tpu.dist import endpoint as jax_endpoint
from minio_tpu.dist import faultplane as jax_faultplane
from minio_tpu.dist import nslock as jax_nslock
from minio_tpu.dist import peer as jax_peer
from minio_tpu.dist import rpc as jax_rpc
from minio_tpu.dist import server as jax_server
from minio_tpu.dist import storage_remote as jax_storage
from minio_tpu.storage import local as jax_local
from minio_tpu_torch.admin import metrics as torch_metrics
from minio_tpu_torch.dist import cluster as torch_cluster
from minio_tpu_torch.dist import dsync as torch_dsync
from minio_tpu_torch.dist import endpoint as torch_endpoint
from minio_tpu_torch.dist import faultplane as torch_faultplane
from minio_tpu_torch.dist import nslock as torch_nslock
from minio_tpu_torch.dist import peer as torch_peer
from minio_tpu_torch.dist import rpc as torch_rpc
from minio_tpu_torch.dist import server as torch_server
from minio_tpu_torch.dist import storage_remote as torch_storage
from minio_tpu_torch.storage import local as torch_local

SECRET = "cluster-secret"
LOCAL = {"127.0.0.1"}

PKG = {
    "jax": types.SimpleNamespace(
        rpc=jax_rpc, server=jax_server, storage=jax_storage, dsync=jax_dsync,
        nslock=jax_nslock, peer=jax_peer, endpoint=jax_endpoint,
        cluster=jax_cluster, faultplane=jax_faultplane, local=jax_local),
    "torch": types.SimpleNamespace(
        rpc=torch_rpc, server=torch_server, storage=torch_storage,
        dsync=torch_dsync, nslock=torch_nslock, peer=torch_peer,
        endpoint=torch_endpoint, cluster=torch_cluster,
        faultplane=torch_faultplane, local=torch_local),
}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def make_drive(pkg: str, root, endpoint: str = ""):
    return PKG[pkg].local.LocalDrive(str(root), endpoint=endpoint)


def node_server(pkg: str, drives: dict, sig: str = "sig", hooks=None,
                locker=None, **storage_kw):
    """A started NodeServer of `pkg` serving the storage plane over
    `drives` ({endpoint path: that package's LocalDrive}), a lock plane, a
    peer plane and a bootstrap plane. -> (server, locker, hooks)."""
    m = PKG[pkg]
    srv = m.server.NodeServer(port=0, secret=SECRET)
    locker = locker if locker is not None else m.dsync.LocalLocker()
    hooks = hooks if hooks is not None else m.peer.PeerHooks()
    srv.register_plane("storage", m.storage.storage_routes(drives, **storage_kw))
    srv.register_plane("lock", m.dsync.lock_routes(locker))
    srv.register_plane("peer", m.peer.peer_routes(hooks))
    srv.register_plane("bootstrap", m.peer.bootstrap_routes(sig))
    srv.start()
    return srv, locker, hooks


def client(pkg: str, port: int, host: str = "127.0.0.1", **kw):
    """A RestClient of `pkg` with short deadlines (no retry sleeps)."""
    kw.setdefault("timeout", 5.0)
    kw.setdefault("retries", 0)
    return PKG[pkg].rpc.RestClient(host, port, SECRET, **kw)


@pytest.fixture
def fast_clients(monkeypatch):
    """Short probe cadence on both packages' clients."""
    for m in (jax_rpc, torch_rpc):
        monkeypatch.setattr(m, "HEALTH_INTERVAL", 0.05)
        monkeypatch.setattr(m, "HEALTH_BACKOFF_CAP", 0.2)


def pin(monkeypatch, objects_mod, fileinfo_mod, clock):
    """Version ids, data dirs and clocks drawn from a counter and `clock`
    instead of uuid4 and the wall clock (tests/test_torch_versioning.py),
    so two packages running the same operations write the same bytes."""
    counter = itertools.count(1)
    fake_uuid = types.SimpleNamespace(**{k: getattr(uuid, k) for k in dir(uuid)
                                         if not k.startswith("__")})
    fake_uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    fake_time = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                         if not k.startswith("__")})
    fake_time.time = lambda: clock[0]
    for mod in (objects_mod, fileinfo_mod):
        monkeypatch.setattr(mod, "uuid", fake_uuid)
        monkeypatch.setattr(mod, "time", fake_time)


def bare_drives(layer) -> list:
    """The drives under an object layer's health and disk-ID wrappers."""
    subs = getattr(layer, "pools", None) or getattr(layer, "sets", None)
    if subs:
        return [d for sub in subs for d in bare_drives(sub)]
    out = []
    for d in layer.drives:
        while True:
            own = getattr(d, "__dict__", {})
            inner = own.get("_inner") or own.get("inner")
            if inner is None:
                break
            d = inner
        out.append(d)
    return out
