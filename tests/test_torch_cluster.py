"""A distributed cluster across packages (minio_tpu_torch/dist/cluster.py,
the port's S3Server.attach_cluster): two nodes on this host, one of each
package, serve one 8-drive erasure set at EC 5+3 (the port node owns 5
drives, the JAX node 3), each node's S3 front door in front of the set.
An object PUT through either node's S3 reads back byte-equal, with its
ETag, through the other's; with the JAX node's drives refused to the port
node, a PUT through the port commits within parity; heal over the
storage plane rebuilds shard files equal to the JAX heal's; the federated
scrape carries both `server` labels. Then a cluster of two port nodes
whose set of system documents lives wholly on one of them: a bucket
policy or an IAM user written through one node binds the other's next
request (a same-length policy rewrite too), and the admin plane's
force-unlock, top/locks, peerFabric and readiness.

The port node runs on the CPU (plain versions of the kernels); the JAX
node writes mxsum256, the port's algorithm. Tolerance: exact bytes."""

import asyncio
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

from tests import torch_dist as td
from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client
from tests.torch_dist import fast_clients  # noqa: F401 - the fixture

BUCKET = "mixed"
SIZES = {"inline.bin": 2 << 10, "mid.bin": 300 << 10, "big.bin": (1 << 20) + 12345}


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


class _JaxNode:
    """The JAX package's cluster node and S3Server, aiohttp on a thread."""

    def __init__(self, node, layer):
        from aiohttp import web

        from minio_tpu.s3 import sigv4
        from minio_tpu.s3.server import S3Server

        self.node = node
        self.srv = S3Server(layer, sigv4.Credentials(S3_ACCESS, S3_SECRET),
                            notification_sys=node.notification)
        self.srv.attach_cluster(node)
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def start():
                self.runner = web.AppRunner(self.srv.app)
                await self.runner.setup()
                await web.TCPSite(self.runner, "127.0.0.1", node.port).start()
                started.set()

            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30)
        self.url = f"http://127.0.0.1:{node.port}"

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.node.close()
        for d in self.node.local_drives.values():
            d.close_wal()


class _TorchNode:
    def __init__(self, node, layer):
        from minio_tpu_torch.s3 import sigv4
        from minio_tpu_torch.s3.server import S3Server

        self.node = node
        self.srv = S3Server(layer, sigv4.Credentials(S3_ACCESS, S3_SECRET),
                            f"127.0.0.1:{node.port}",
                            notification_sys=node.notification)
        self.srv.attach_cluster(node)
        self.srv.start()
        self.url = self.srv.url

    def close(self):
        self.srv.close()


def _boot(tmp_path, specs, pools=None, parity=None):
    """specs: [(pkg, n_drives)]; one pool over every node's drives (or
    `pools`: a list of pools, each a list of node indexes). -> nodes."""
    ports = [td.free_port() for _ in specs]
    rpc = {p: td.free_port() for p in ports}
    groups = pools or [list(range(len(specs)))]
    args = [[f"http://127.0.0.1:{ports[i]}/n{i}/d{{1...{specs[i][1]}}}" for i in g]
            for g in groups]
    cnodes = []
    for i, (pkg, _n) in enumerate(specs):
        kw = {"device": "cpu"} if pkg == "torch" else {}
        cnodes.append(td.PKG[pkg].cluster.ClusterNode(
            args, host="127.0.0.1", port=ports[i], secret=S3_SECRET,
            root_dir_map=lambda p: str(tmp_path / p.strip("/").replace("/", "_")),
            local_names=td.LOCAL, rpc_port=rpc[ports[i]],
            rpc_port_of=lambda h, p: rpc[p], parity=parity, **kw))
    for c in cnodes:
        c.wait_for_peers(timeout=10)
    # The boot loop of build_cluster_server: a node whose pool's leader
    # has not minted the format yet retries after the others' turn.
    layers = [None] * len(cnodes)
    deadline = time.monotonic() + 30
    while any(x is None for x in layers):
        assert time.monotonic() < deadline, "cluster did not format"
        for i, ((pkg, _n), c) in enumerate(zip(specs, cnodes)):
            if layers[i] is not None:
                continue
            kw = {"bitrot_algorithm": "mxsum256"} if pkg == "jax" else {}
            try:
                layers[i] = c.build_object_layer(enable_mrf=False, **kw)
            except Exception as e:  # noqa: BLE001 - either package's timeout
                assert type(e).__name__ == "OperationTimedOut", e
    return [(_JaxNode if pkg == "jax" else _TorchNode)(c, layer)
            for (pkg, _n), c, layer in zip(specs, cnodes, layers)]


@pytest.fixture
def mixed(tmp_path, fast_clients, monkeypatch):
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    # The port node's client to the JAX node keeps its breaker closed
    # while the storage plane is refused, so the lock plane stays up.
    monkeypatch.setattr(td.torch_rpc, "BREAKER_FAILURES", 1 << 30)
    nodes = _boot(tmp_path, [("torch", 5), ("jax", 3)], parity=3)
    yield nodes
    for n in reversed(nodes):
        n.close()


def _client(node):
    return SigV4Client(node.url, S3_ACCESS, S3_SECRET)


def _files(node, key):
    """{drive path: {relative path: bytes}} of `key` on a node's drives."""
    out = {}
    for path, d in sorted(node.node.local_drives.items()):
        base = os.path.join(d.root, BUCKET, key)
        files = {}
        for root, _dirs, names in os.walk(base):
            for f in names:
                full = os.path.join(root, f)
                files[os.path.relpath(full, base)] = open(full, "rb").read()
        out[path] = files
    return out


def _settle(nodes):
    for n in nodes:
        for d in n.node.local_drives.values():
            wal = getattr(d, "_wal", None)
            if wal is not None:
                wal.flush()


def test_put_through_one_get_through_the_other(mixed):
    tn, jn = mixed
    tc, jc = _client(tn), _client(jn)
    assert tc.put(f"/{BUCKET}").status_code == 200
    for seed, (key, size) in enumerate(SIZES.items()):
        data = _payload(size, seed)
        for w, r, name in ((tc, jc, "t-" + key), (jc, tc, "j-" + key)):
            put = w.put(f"/{BUCKET}/{name}", data=data)
            assert put.status_code == 200, put.text
            got = r.get(f"/{BUCKET}/{name}")
            assert got.status_code == 200 and got.content == data
            assert got.headers["ETag"] == put.headers["ETag"]
    # Every drive of both nodes holds a journal of each key.
    _settle(mixed)
    for n in mixed:
        for files in _files(n, "t-big.bin").values():
            assert "meta.mp" in files
    listed = tc.get(f"/{BUCKET}", query={"list-type": "2"}).text
    assert listed.count("<Key>") == 6


def test_put_commits_with_one_nodes_drives_refused_and_heal_matches(mixed):
    tn, jn = mixed
    tc, jc = _client(tn), _client(jn)
    assert tc.put(f"/{BUCKET}").status_code == 200
    data = _payload((1 << 20) + 999, 21)
    fp = td.torch_faultplane.install(seed=3)
    try:
        fp.add_rule("reset", src=tn.node.node_name, peer=jn.node.node_name,
                    plane="storage")
        r = tc.put(f"/{BUCKET}/degraded", data=data)
        assert r.status_code == 200, r.text
        assert tc.get(f"/{BUCKET}/degraded").content == data
    finally:
        td.torch_faultplane.uninstall()
    _settle(mixed)
    assert all(not f for f in _files(jn, "degraded").values())   # never reached
    # The port node's health checkers took refused drives offline (or
    # faulty); the offline probes bring them back once the fabric answers.
    deadline = time.monotonic() + 20
    drives = tn.srv.obj.pools[0].sets[0].drives
    while time.monotonic() < deadline and any(d.health_state() == "offline"
                                              for d in drives):
        time.sleep(0.1)
    assert all(d.health_state() != "offline" for d in drives)
    # Heal over RPC: each package's heal rebuilds the JAX node's shards.
    healed = {}
    for healer in ("jax", "torch"):
        node = jn if healer == "jax" else tn
        for d in jn.node.local_drives.values():
            shutil.rmtree(os.path.join(d.root, BUCKET, "degraded"), ignore_errors=True)
        node.srv.obj.heal_object(BUCKET, "degraded")
        _settle(mixed)
        healed[healer] = _files(jn, "degraded")
        assert all(any(k.endswith("part.1") for k in f) for f in healed[healer].values())
    assert healed["torch"] == healed["jax"]
    assert jc.get(f"/{BUCKET}/degraded").content == data


def _scrapes_and_fabric(tn, jn):
    """Both nodes' cluster scrapes and the port node's admin info."""
    scrapes = {}
    for node in (tn, jn):
        r = _client(node).get("/minio/v2/metrics/cluster")
        assert r.status_code == 200
        scrapes[node] = r.text
    return scrapes, json.loads(_client(tn).get("/minio/admin/v3/info").content)


def test_federated_scrape_carries_both_servers(mixed, monkeypatch):
    tn, jn = mixed
    # A peer's part of the scrape is its whole process registry, rendered
    # by the peer: in a test process that has run many files before this
    # one (an xdist worker) that is every earlier test's label sets, and
    # on a loaded host it can outlast the 2 s peer deadline, which drops
    # the peer from that scrape. The fabric breaker may also be in the
    # HALF_OPEN state the boot left it in until a fabric call closes it.
    # So wait, with a bound, for the state the test asserts: the peers'
    # deadline is raised for it, and each round sends one ListBuckets
    # through the port node, which reaches the JAX node's drives.
    for m in (td.jax_metrics, td.torch_metrics):
        monkeypatch.setattr(m, "PEER_SCRAPE_DEADLINE", 15.0)
    names = [n.node.node_name for n in (tn, jn)]
    deadline = time.monotonic() + 90
    while True:
        scrapes, info = _scrapes_and_fabric(tn, jn)
        if ((all(f'server="{o}"' in text for text in scrapes.values()
                 for o in names)
             and info["peerFabric"]
             and info["peerFabric"][0]["state"] == "closed")
                or time.monotonic() > deadline):
            break
        _client(tn).get("/")
        time.sleep(0.2)
    for node, text in scrapes.items():
        for other in names:
            assert f'server="{other}"' in text, node
    assert [p["peer"] for p in info["peerFabric"]] == [jn.node.node_name]
    assert info["peerFabric"][0]["state"] == "closed"


# -- two port nodes: cross-node freshness and the admin plane ----------------

@pytest.fixture
def pair(tmp_path, fast_clients, monkeypatch):
    """Pool 0 on node B only, pool 1 on node A only: A reaches every copy
    of the system documents (bucket policy, IAM) over the storage plane."""
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    nodes = _boot(tmp_path, [("torch", 4), ("torch", 4)], pools=[[1], [0]])
    yield nodes
    for n in reversed(nodes):
        n.close()


def _policy(effect, sid):
    return json.dumps({"Version": "2012-10-17", "Statement": [{
        "Sid": sid, "Effect": effect, "Principal": {"AWS": ["*"]},
        "Action": ["s3:GetObject"], "Resource": [f"arn:aws:s3:::{BUCKET}/*"]}]}).encode()


def test_bucket_policy_and_iam_written_on_one_node_bind_the_other(pair):
    import requests

    a, b = pair
    ac, bc = _client(a), _client(b)
    assert bc.put(f"/{BUCKET}").status_code == 200
    assert bc.put(f"/{BUCKET}/o", data=b"hello").status_code == 200

    def anon_get():
        return requests.get(f"{a.url}/{BUCKET}/o", timeout=30).status_code

    assert anon_get() == 403
    allow, deny = _policy("Allow", "s1"), _policy("Deny", "s12")
    assert len(allow) == len(deny)
    for doc, want in ((allow, 200), (deny, 403), (allow, 200)):
        assert bc.put(f"/{BUCKET}", query={"policy": ""}, data=doc).status_code in (200, 204)
        assert anon_get() == want
    # IAM: a user added through B signs on A.
    r = bc.request("PUT", "/minio/admin/v3/add-user", query={"accessKey": "alice"},
                   data=json.dumps({"secretKey": "alice-secret-1"}).encode())
    assert r.status_code == 200
    r = bc.request("POST", "/minio/admin/v3/set-user-or-group-policy",
                   query={"userOrGroup": "alice", "policyName": "readwrite"})
    assert r.status_code == 200
    alice = SigV4Client(a.url, "alice", "alice-secret-1")
    assert alice.get(f"/{BUCKET}/o").content == b"hello"


def test_locks_admin_and_readiness(pair):
    a, b = pair
    ac = _client(a)
    node_a = a.node
    lease = node_a.object_layer.pools[0].sets[0].nslock
    with lease.lock(BUCKET, "held"):
        r = ac.get("/minio/admin/v3/top/locks")
        assert r.status_code == 200
        assert f"{BUCKET}/held" in json.loads(r.content)["locks"]
    # A stale entry left by a dead holder: force-unlock clears it.
    from minio_tpu_torch.dist.dsync import LockArgs

    node_a.locker.lock(LockArgs("dead", [f"{BUCKET}/stuck"], "gone:1"))
    r = ac.post("/minio/admin/v3/force-unlock", query={"paths": f"{BUCKET}/stuck"})
    assert r.status_code == 200
    assert f"{BUCKET}/stuck" not in node_a.locker.dump()
    assert ac.post("/minio/admin/v3/force-unlock").status_code == 400
    r = ac.get("/minio/health/ready")
    assert r.status_code == 200 and r.headers["X-Minio-Peers-Online"] == "1"
    # Node B gone: an even split of two stays up on A's own count of the
    # fabric (the JAX rule), and peerFabric shows the open breaker.
    for c in node_a._clients.values():
        c.mark_offline()
    r = ac.get("/minio/health/ready")
    assert r.headers["X-Minio-Peers-Offline"] == "1"
    info = json.loads(ac.get("/minio/admin/v3/info").content)
    assert info["peerFabric"][0]["state"] == "open"
    t0 = time.monotonic()
    r = ac.get("/minio/v2/metrics/cluster")
    assert r.status_code == 200 and time.monotonic() - t0 < 10
    assert "minio_tpu_peer_scrape_errors_total" in r.text


def _console_lines(node, query, out, stop):
    import requests

    cl = _client(node)
    path = "/minio/admin/v3/consolelog"
    signed = cl._sign("GET", path, query, {}, b"")
    with requests.get(node.url + path, params=query, headers=signed, stream=True,
                      timeout=30) as r:
        assert r.status_code == 200
        for line in r.iter_lines():
            if line:
                out.append(json.loads(line))
            if stop.is_set():
                return


def test_consolelog_federates_across_packages(mixed):
    """Each node's consolelog stream carries the other node's log lines
    (the peer plane's consolelog route, fed by the logger's console bus
    that attach_cluster hands the peer hooks), and ?all=false this node's
    only. The two packages' loggers are separate buses in this process,
    so a line logged on one node reaches the other only over the peer
    plane."""
    port_node, jax_node = mixed
    got = {}
    for reader, writer in ((port_node, jax_node), (jax_node, port_node)):
        for query in ({}, {"all": "false"}):
            lines, stop = [], threading.Event()
            t = threading.Thread(target=_console_lines, daemon=True,
                                 args=(reader, query, lines, stop))
            t.start()
            bus = reader.srv.logger.console_bus
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline and not bus.has_subscribers:
                time.sleep(0.02)
            time.sleep(1.0)   # the peer pullers subscribe on the other node
            msg = f"from {type(writer).__name__} all={query.get('all', 'true')}"
            writer.srv.logger.warning(msg, n=1)
            reader.srv.logger.info(f"local {msg}")
            while time.monotonic() < deadline and not any(
                    x.get("message") == f"local {msg}" for x in lines):
                time.sleep(0.05)
            if not query:
                while time.monotonic() < deadline and not any(
                        x.get("message") == msg for x in lines):
                    time.sleep(0.05)
            stop.set()
            reader.srv.logger.info("wake the stream")
            t.join(10)
            got[(type(reader).__name__, query.get("all", "true"))] = sorted(
                x["message"] for x in lines if x.get("message", "").endswith(msg))
    for reader in ("_TorchNode", "_JaxNode"):
        writer = "_JaxNode" if reader == "_TorchNode" else "_TorchNode"
        assert got[(reader, "true")] == sorted([f"from {writer} all=true",
                                                f"local from {writer} all=true"])
        assert got[(reader, "false")] == [f"local from {writer} all=false"]
