"""Endpoint topology: ellipses expansion → pools × sets × drives layout
(counterpart of minio_tpu/dist/endpoint.py; layout_signature is the JAX
one, string for string: the bootstrap handshake compares it across
nodes of either package).

Role-equivalent of pkg/ellipses + cmd/endpoint-ellipses.go:254,279 +
cmd/endpoint.go: server args like

    http://host{1...4}:9000/data/disk{1...16}     (distributed)
    /data/disk{1...16}                            (single node)

expand to drive endpoints; each arg group is one pool; the erasure set
drive count is the largest "nice" divisor of the drive count (16 down to
2, cmd/endpoint-ellipses.go setSizes) unless pinned explicitly.
"""

from __future__ import annotations

import itertools
import re
import socket
import urllib.parse
from dataclasses import dataclass

_ELLIPSIS = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

# Candidate set sizes, preferred large→small (cmd/endpoint-ellipses.go:28).
SET_SIZES = [16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2]

_LOCAL_NAMES = {"localhost", "127.0.0.1", "::1", ""}


def expand_ellipses(arg: str) -> list[str]:
    """Expand every {a...b} range in arg (cartesian, left-to-right)."""
    spans = list(_ELLIPSIS.finditer(arg))
    if not spans:
        return [arg]
    ranges = []
    for m in spans:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ValueError(f"bad ellipsis range {m.group(0)} in {arg!r}")
        width = len(m.group(1)) if m.group(1).startswith("0") else 0
        ranges.append([str(v).zfill(width) for v in range(lo, hi + 1)])
    out = []
    for combo in itertools.product(*ranges):
        s, last = "", 0
        for m, val in zip(spans, combo):
            s += arg[last:m.start()] + val
            last = m.end()
        out.append(s + arg[last:])
    return out


@dataclass(frozen=True)
class Endpoint:
    """One drive endpoint: local path or remote URL (cmd/endpoint.go:51)."""

    host: str        # "" for a plain path
    port: int        # 0 for a plain path
    path: str
    is_local: bool

    @property
    def url(self) -> str:
        if not self.host:
            return self.path
        return f"http://{self.host}:{self.port}{self.path}"

    @property
    def node(self) -> tuple[str, int]:
        return (self.host, self.port)


def _local_hostnames() -> set[str]:
    names = set(_LOCAL_NAMES)
    try:
        hn = socket.gethostname()
        names.add(hn)
        names.add(socket.getfqdn())
        try:
            names.update(socket.gethostbyname_ex(hn)[2])
        except OSError:
            pass
    except OSError:
        pass
    return names


def parse_endpoint(arg: str, local_host: str = "", local_port: int = 0,
                   local_names: set[str] | None = None) -> Endpoint:
    if "://" not in arg:
        return Endpoint("", 0, arg, True)
    u = urllib.parse.urlsplit(arg)
    if u.scheme not in ("http", "https") or not u.path or u.path == "/":
        raise ValueError(f"invalid endpoint {arg!r}")
    host = u.hostname or ""
    port = u.port or 9000
    names = local_names if local_names is not None else _local_hostnames()
    is_local = (host in names or host == local_host) and (
        local_port == 0 or port == local_port)
    return Endpoint(host, port, u.path.rstrip("/"), is_local)


@dataclass
class PoolLayout:
    """One pool: drives grouped into erasure sets of set_drive_count."""

    endpoints: list[Endpoint]
    set_drive_count: int

    @property
    def set_count(self) -> int:
        return len(self.endpoints) // self.set_drive_count


def choose_set_drive_count(n_drives: int, n_nodes: int = 1,
                           pinned: int = 0) -> int:
    """Largest candidate that divides the drive count and spreads evenly
    across nodes when possible (cmd/endpoint-ellipses.go:80-150)."""
    if pinned:
        if n_drives % pinned:
            raise ValueError(
                f"set drive count {pinned} does not divide {n_drives} drives")
        return pinned
    if n_drives == 1:
        return 1
    # Prefer sizes that are also multiples of the node count (symmetric
    # spread), then any divisor.
    for require_node_spread in (True, False):
        for c in SET_SIZES:
            if c > n_drives or n_drives % c:
                continue
            if require_node_spread and n_nodes > 1 and c % n_nodes:
                continue
            return c
    raise ValueError(f"no valid erasure set size for {n_drives} drives")


def create_pool_layouts(args_groups: list[list[str]],
                        local_host: str = "", local_port: int = 0,
                        set_drive_count: int = 0,
                        local_names: set[str] | None = None
                        ) -> list[PoolLayout]:
    """Each args group (one server invocation arg) becomes one pool
    (cmd/endpoint-ellipses.go:254)."""
    pools = []
    for group in args_groups:
        expanded = [e for arg in group for e in expand_ellipses(arg)]
        eps = [parse_endpoint(e, local_host, local_port, local_names)
               for e in expanded]
        nodes = {ep.node for ep in eps}
        c = choose_set_drive_count(len(eps), len(nodes), set_drive_count)
        pools.append(PoolLayout(eps, c))
    return pools


def layout_signature(pools: list[PoolLayout]) -> str:
    """Deterministic topology fingerprint for bootstrap verification
    (cmd/bootstrap-peer-server.go:99 compares server config across peers)."""
    import hashlib

    h = hashlib.sha256()
    for p in pools:
        h.update(f"set={p.set_drive_count};".encode())
        for ep in p.endpoints:
            h.update(ep.url.encode())
            h.update(b"|")
        h.update(b"//")
    return h.hexdigest()
