"""Peer control plane + bootstrap verification (counterpart of
minio_tpu/dist/peer.py, on the same wire).

Role-equivalent of cmd/peer-rest-{server,client}.go (the node-to-node admin
fabric) and cmd/bootstrap-peer-server.go (pre-start topology handshake).
The peer plane starts minimal — health, layout verification, cache
invalidation hooks — and grows with the subsystems that need fan-out
(IAM reload, bucket-metadata invalidation, trace subscription).
"""

from __future__ import annotations

import time
from typing import Callable

from minio_tpu_torch.dist.rpc import RestClient, pack
from minio_tpu_torch.utils import errors as se

PLANE = "peer"
BOOTSTRAP_PLANE = "bootstrap"


# --- server side -------------------------------------------------------------

def bootstrap_routes(layout_sig: str, version: str = "1") -> dict:
    """The handshake target: peers compare topology before serving
    (cmd/bootstrap-peer-server.go:162)."""

    def h_verify(params, body):
        return pack({"sig": layout_sig, "version": version,
                     "time": time.time()})

    return {"verify": h_verify}


class PeerHooks:
    """Callbacks the peer plane invokes on this node. Subsystems register
    theirs at init (NotificationSys role, cmd/notification.go:60)."""

    def __init__(self):
        self.on_bucket_metadata_invalidate: Callable[[str], None] = lambda b: None
        self.on_iam_reload: Callable[[], None] = lambda: None
        self.health: Callable[[], dict] = lambda: {"ok": True}
        # Observability fan-in (cmd/peer-rest-common.go:27-61 breadth):
        self.server_info: Callable[[], dict] = lambda: {}
        self.obd_info: Callable[[], dict] = lambda: {}
        self.trace_bus = None        # admin.pubsub.PubSub | None
        self.console_bus = None      # admin.pubsub.PubSub | None
        self.profiler = None         # admin.profiling.Profiler | None
        # Node-scope Prometheus exposition (bytes) — what the federated
        # cluster scrape pulls and relabels under server=<this node>.
        self.metrics: Callable[[], bytes] = lambda: b""
        # Flight-recorder query: params {traceid, api, worst} -> this
        # node's stage timelines (admin perf/timeline federation).
        self.perf_timeline: Callable[[dict], dict] = lambda params: {
            "node": "", "timelines": []}
        # SLO plane (obs/slo.py): this node's worker-merged burn-rate
        # state, pulled by the federated GET /minio/admin/v3/slo.
        self.slo: Callable[[], dict] = lambda: {}


def _stream_bus(bus):
    """Chunked-stream a pubsub as msgpack docs with 1 s heartbeats (the
    heartbeat is what lets the server notice a gone subscriber)."""
    if bus is None:
        return
    with bus.subscribe() as sub:
        while True:
            item = sub.get(timeout=1.0)
            yield pack({"hb": 1} if item is None else item)


def peer_routes(hooks: PeerHooks) -> dict:
    def h_health(params, body):
        return pack(hooks.health())

    def h_invalidate_bucket_metadata(params, body):
        hooks.on_bucket_metadata_invalidate(params.get("bucket", ""))

    def h_reload_iam(params, body):
        hooks.on_iam_reload()

    def h_server_info(params, body):
        return pack(hooks.server_info())

    def h_obd_info(params, body):
        return pack(hooks.obd_info())

    def h_metrics(params, body):
        return bytes(hooks.metrics())

    def h_perf_timeline(params, body):
        return pack(hooks.perf_timeline(params or {}))

    def h_slo(params, body):
        return pack(hooks.slo())

    def h_trace(params, body):
        return _stream_bus(hooks.trace_bus)

    def h_consolelog(params, body):
        return _stream_bus(hooks.console_bus)

    def h_profile_start(params, body):
        if hooks.profiler is None:
            raise se.FaultyDisk("no profiler on this node")
        kinds = tuple((params.get("kinds") or "cpu").split(","))
        hooks.profiler.start(kinds)
        return pack({"ok": True})

    def h_profile_download(params, body):
        if hooks.profiler is None:
            raise se.FaultyDisk("no profiler on this node")
        return pack(hooks.profiler.stop_collect())

    return {"health": h_health,
            "invalidate_bucket_metadata": h_invalidate_bucket_metadata,
            "reload_iam": h_reload_iam,
            "server_info": h_server_info,
            "obd_info": h_obd_info,
            "metrics": h_metrics,
            "perf_timeline": h_perf_timeline,
            "slo": h_slo,
            "trace": h_trace,
            "consolelog": h_consolelog,
            "profile_start": h_profile_start,
            "profile_download": h_profile_download}


# --- client side -------------------------------------------------------------

class PeerClient:
    """One per peer node (cmd/peer-rest-client.go)."""

    def __init__(self, client: RestClient, name: str = ""):
        """name: the peer's ADVERTISED identity (S3 host:port) — what its
        own trace records carry as `node` and its scrape carries as the
        `server` label. Falls back to the fabric address (RPC port)."""
        self._client = client
        self._name = name
        self._obs_client: RestClient | None = None

    def _metrics_client(self) -> RestClient:
        """Dedicated client for the federated metrics pull. The scrape
        must NEVER ride the shared fabric client: a peer whose metrics
        hook stalls past the adaptive metadata deadline would otherwise
        mark the whole peer offline (storage, locks, everything) and
        inflate the shared DynamicTimeout — an observability call
        degrading the data plane. This clone keeps its own offline state
        and deadline convergence, scoped to the metrics route."""
        if self._obs_client is None:
            c = self._client
            # name= pins the same advertised identity as the fabric
            # client, so the `peer` metric labels and fault-injection
            # destination agree across both clients: a partition
            # covering the peer blacks out the metrics pull too (its
            # breaker stays independent by design), and dashboards see
            # one peer, not a transport-address phantom.
            self._obs_client = RestClient(
                c.host, c.port, c.secret, timeout=c.timeout,
                name=c.fault_dst, lane="metrics")
            self._obs_client.fault_src = c.fault_src
        return self._obs_client

    @property
    def name(self) -> str:
        return self._name or f"{self._client.host}:{self._client.port}"

    def health(self) -> dict:
        return self._client.call_msgpack(f"/rpc/{PLANE}/v1/health")

    def invalidate_bucket_metadata(self, bucket: str) -> None:
        self._client.call(f"/rpc/{PLANE}/v1/invalidate_bucket_metadata",
                          {"bucket": bucket})

    def reload_iam(self) -> None:
        self._client.call(f"/rpc/{PLANE}/v1/reload_iam")

    def verify_bootstrap(self) -> dict:
        return self._client.call_msgpack(f"/rpc/{BOOTSTRAP_PLANE}/v1/verify")

    def server_info(self) -> dict:
        return self._client.call_msgpack(f"/rpc/{PLANE}/v1/server_info")

    def obd_info(self) -> dict:
        return self._client.call_msgpack(f"/rpc/{PLANE}/v1/obd_info")

    def metrics(self) -> bytes:
        """The peer's node-scope Prometheus exposition (raw bytes)."""
        return self._metrics_client().call(f"/rpc/{PLANE}/v1/metrics")

    def perf_timeline(self, params: dict | None = None) -> dict:
        """The peer's flight-recorder timelines (filtered server-side).
        Rides the dedicated observability client for the same reason as
        metrics(): a stalled query must not poison the fabric client."""
        return self._metrics_client().call_msgpack(
            f"/rpc/{PLANE}/v1/perf_timeline", params or {})

    def slo(self) -> dict:
        """The peer's worker-merged SLO burn-rate state (obs/slo.py).
        Same dedicated observability client as metrics()."""
        return self._metrics_client().call_msgpack(
            f"/rpc/{PLANE}/v1/slo")

    def trace_stream(self, heartbeats: bool = False):
        """Iterator over the peer's trace records — the remote half of
        `mc admin trace` (cmd/peer-rest-client.go:782). heartbeats=True
        also yields the 1 s keepalive docs ({"hb": 1}) so a consumer can
        re-check its stop condition on an idle peer."""
        for doc in self._client.iter_msgpack(f"/rpc/{PLANE}/v1/trace"):
            if doc.get("hb") and not heartbeats:
                continue
            yield doc

    def console_stream(self, heartbeats: bool = False):
        for doc in self._client.iter_msgpack(f"/rpc/{PLANE}/v1/consolelog"):
            if doc.get("hb") and not heartbeats:
                continue
            yield doc

    def profile_start(self, kinds: str = "cpu") -> None:
        self._client.call(f"/rpc/{PLANE}/v1/profile_start", {"kinds": kinds})

    def profile_download(self) -> dict:
        """-> {filename: bytes} of the peer's collected profiles."""
        return self._client.call_msgpack(f"/rpc/{PLANE}/v1/profile_download")

    def is_online(self) -> bool:
        return self._client.is_online()

    def close(self) -> None:
        """Release the dedicated metrics client (the shared fabric client
        is owned and closed by the cluster node)."""
        if self._obs_client is not None:
            self._obs_client.close()
            self._obs_client = None


def verify_cluster_bootstrap(peers: list[PeerClient], layout_sig: str,
                             timeout: float = 60.0,
                             interval: float = 0.25) -> None:
    """Retry until every peer answers with the same topology signature
    (the reference's retry loop, cmd/server-main.go:484-498). Raises
    CorruptedFormat on a signature mismatch (misconfigured cluster) and
    OperationTimedOut if peers never come up."""
    deadline = time.monotonic() + timeout
    pending = list(peers)
    while pending:
        still = []
        for p in pending:
            try:
                doc = p.verify_bootstrap()
            except Exception:
                still.append(p)
                continue
            if doc.get("sig") != layout_sig:
                raise se.CorruptedFormat(
                    f"peer topology mismatch: {doc.get('sig')!r} != "
                    f"{layout_sig!r} — all nodes must be started with the "
                    f"same endpoint arguments")
        pending = still
        if pending:
            if time.monotonic() > deadline:
                raise se.OperationTimedOut(
                    "", "", f"{len(pending)} peers unreachable during bootstrap")
            time.sleep(interval)


class NotificationSys:
    """Fan-out wrapper over all peers (cmd/notification.go:60): best-effort
    broadcast of control-plane events; a down peer reconciles from
    persistent state when it returns."""

    def __init__(self, peers: list[PeerClient]):
        self.peers = peers

    def _fanout(self, fn: Callable[[PeerClient], object]) -> list:
        """Concurrent best-effort broadcast — latency is one peer's RPC
        (bounded by the client timeout), not the sum over peers (the
        reference fans out in goroutines, cmd/notification.go)."""
        if not self.peers:
            return []
        from concurrent.futures import ThreadPoolExecutor

        def one(p):
            try:
                return fn(p)
            except Exception as e:  # noqa: BLE001 - best-effort plane
                return e

        with ThreadPoolExecutor(max_workers=min(16, len(self.peers))) as ex:
            return list(ex.map(one, self.peers))

    def invalidate_bucket_metadata(self, bucket: str) -> None:
        self._fanout(lambda p: p.invalidate_bucket_metadata(bucket))

    def reload_iam(self) -> None:
        self._fanout(lambda p: p.reload_iam())

    # -- observability fan-in (cmd/notification.go:286-1237) --

    def perf_all(self, params: dict | None = None) -> list[dict]:
        """Every peer's flight-recorder timelines — the perf/timeline
        endpoint's cluster fan-out; a peer that fails answers {"error",
        "node"})."""
        results = self._fanout(lambda p: p.perf_timeline(params))
        return [r if not isinstance(r, Exception)
                else {"error": str(r), "node": p.name}
                for p, r in zip(self.peers, results)]
