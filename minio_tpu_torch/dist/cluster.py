"""Cluster assembly: endpoint args → a running distributed node
(counterpart of minio_tpu/dist/cluster.py; plain HTTP: the fabric over
TLS, certs_dir, is not ported yet).

Role-equivalent of cmd/server-main.go:404-553 for the distributed path:
expand endpoints, start the RPC fabric (storage + lock + peer + bootstrap
planes), verify topology with peers, then build pools × sets over
local + remote drives. Every node is symmetric — any node serves any S3
request; per-drive calls route to the drive's owner over the storage plane.

The RPC fabric listens on its own port (S3 port + RPC_PORT_OFFSET by
default — the reference muxes both onto one listener; two listeners keep
the async S3 front door and the threaded RPC plane independent).
"""

from __future__ import annotations

from minio_tpu_torch.dist import endpoint as epmod
from minio_tpu_torch.dist.dsync import LocalLocker, RemoteLocker, lock_routes
from minio_tpu_torch.dist.nslock import NamespaceLockMap
from minio_tpu_torch.dist.peer import (
    NotificationSys,
    PeerClient,
    PeerHooks,
    bootstrap_routes,
    peer_routes,
    verify_cluster_bootstrap,
)
from minio_tpu_torch.dist.rpc import RestClient
from minio_tpu_torch.dist.server import NodeServer
from minio_tpu_torch.dist.storage_remote import RemoteDrive, storage_routes
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.local import LocalDrive

RPC_PORT_OFFSET = 1000


class ClusterNode:
    """One symmetric node of a distributed deployment."""

    def __init__(self, pool_args: list[list[str]], host: str, port: int,
                 secret: str, root_dir_map=None, set_drive_count: int = 0,
                 local_names: set[str] | None = None,
                 rpc_port: int | None = None, parity: int | None = None,
                 rpc_port_of=None, device="cuda"):
        """pool_args: endpoint args per pool (already split). host/port:
        this node's advertised S3 address — endpoints matching it are local.
        root_dir_map: optional fn(endpoint_path) -> local fs dir (tests map
        drive paths into tmp dirs; production uses the path as-is).
        rpc_port_of: fn(host, s3_port) -> rpc port for a peer (defaults to
        s3_port + RPC_PORT_OFFSET; tests use OS-assigned ports).
        device: where this node's sets encode and its storage plane
        verifies (the card by default; tests pass "cpu")."""
        self.host = host
        self.port = port
        self.secret = secret
        self.device = device
        self.rpc_port = rpc_port if rpc_port is not None else port + RPC_PORT_OFFSET
        self._rpc_port_of = rpc_port_of or (
            lambda h, p: p + RPC_PORT_OFFSET)
        root_dir_map = root_dir_map or (lambda p: p)

        self.pools_layout = epmod.create_pool_layouts(
            pool_args, local_host=host, local_port=port,
            set_drive_count=set_drive_count, local_names=local_names)
        self.layout_sig = epmod.layout_signature(self.pools_layout)

        # --- local drives + RPC fabric ---
        self.local_drives: dict[str, LocalDrive] = {}
        for pool in self.pools_layout:
            for ep in pool.endpoints:
                if ep.is_local and ep.path not in self.local_drives:
                    self.local_drives[ep.path] = LocalDrive(
                        root_dir_map(ep.path), endpoint=ep.url)

        self.locker = LocalLocker()
        self.hooks = PeerHooks()
        # Advertised identity: the `node` stamp on trace records emitted
        # while serving peers, and the `server` label this node's scrape
        # carries in the federated cluster metrics.
        self.node_name = f"{host}:{port}"
        self.node_server = NodeServer(host="0.0.0.0" if host not in
                                      ("127.0.0.1", "localhost") else host,
                                      port=self.rpc_port, secret=secret,
                                      node_name=self.node_name)
        self.node_server.register_plane(
            "storage", storage_routes(self.local_drives, device=device))
        self.node_server.register_plane("lock", lock_routes(self.locker))
        self.node_server.register_plane("peer", peer_routes(self.hooks))
        self.node_server.register_plane(
            "bootstrap", bootstrap_routes(self.layout_sig))
        self.node_server.start()
        self.rpc_port = self.node_server.port  # resolves OS-assigned port 0

        # --- peer clients (one RestClient per remote node) ---
        self._clients: dict[tuple[str, int], RestClient] = {}
        self.peer_nodes: list[tuple[str, int]] = []
        seen = set()
        for pool in self.pools_layout:
            for ep in pool.endpoints:
                if ep.is_local or not ep.host or ep.node in seen:
                    continue
                seen.add(ep.node)
                self.peer_nodes.append(ep.node)
        self.peers = [PeerClient(self._client_for(n), name=f"{n[0]}:{n[1]}")
                      for n in self.peer_nodes]
        self.notification = NotificationSys(self.peers)

        # Quorum lockers: this node's local locker + every peer's.
        self.lockers: list = [self.locker] + [
            RemoteLocker(self._client_for(n)) for n in self.peer_nodes]

        self._parity = parity
        self.object_layer = None

    def _client_for(self, node: tuple[str, int]) -> RestClient:
        if node not in self._clients:
            host, port = node
            # name: advertised S3 identity, so metric `peer` labels and
            # fault-injection partitions are declared in TOPOLOGY terms
            # (not transport ports) — asymmetric partitions then work
            # with many in-process nodes.
            c = RestClient(
                host, self._rpc_port_of(host, port), self.secret,
                name=f"{host}:{port}")
            c.fault_src = self.node_name
            self._clients[node] = c
        return self._clients[node]

    def peer_fabric_info(self) -> list[dict]:
        """Per-peer circuit breaker state + retry/shed counters — the
        admin server-info surface of the peer-resilience plane (mirror of
        the per-drive healthState entries)."""
        return [self._client_for(n).breaker_info() for n in self.peer_nodes]

    # -- boot --

    def wait_for_peers(self, timeout: float = 60.0) -> None:
        verify_cluster_bootstrap(self.peers, self.layout_sig, timeout=timeout)

    def drive_for(self, ep: epmod.Endpoint) -> StorageAPI:
        if ep.is_local:
            return self.local_drives[ep.path]
        return RemoteDrive(self._client_for(ep.node), ep.path, endpoint=ep.url)

    def build_object_layer(self, **set_kwargs):
        """Pools × sets over the expanded endpoints. Distributed topologies
        get a dsync-quorum namespace lock spanning all nodes."""
        from minio_tpu_torch.erasure.pools import ErasureServerPools
        from minio_tpu_torch.erasure.sets import ErasureSets

        set_kwargs.setdefault("device", self.device)
        distributed = bool(self.peer_nodes)
        pools = []
        try:
            for pool in self.pools_layout:
                drives = [self.drive_for(ep) for ep in pool.endpoints]
                nslock = NamespaceLockMap(
                    distributed=distributed, lockers=self.lockers,
                    owner=f"{self.host}:{self.port}") if distributed else None
                # Fresh-format leadership: only the node owning the pool's
                # FIRST endpoint may mint a deployment id; everyone else
                # retries until the leader's format lands (reference
                # firstDisk gating in waitForFormatErasure).
                pools.append(ErasureSets(
                    drives, set_drive_count=pool.set_drive_count,
                    parity=self._parity, nslock=nslock,
                    can_format_fresh=pool.endpoints[0].is_local,
                    **set_kwargs))
        except Exception:
            # A later pool failing (e.g. waiting on the format leader)
            # must not leak earlier pools' worker threads across the
            # caller's boot retries.
            for p in pools:
                try:
                    p.close()
                except Exception:  # noqa: BLE001 — teardown only
                    pass
            raise
        self.object_layer = ErasureServerPools(pools)
        return self.object_layer

    def close(self) -> None:
        if self.object_layer is not None:
            self.object_layer.close()
        for p in self.peers:
            p.close()
        for c in self._clients.values():
            c.close()
        self.node_server.close()
        for d in self.local_drives.values():
            d.close_wal()
