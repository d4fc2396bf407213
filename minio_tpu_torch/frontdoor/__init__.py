"""Multi-process front door (counterpart of minio_tpu/frontdoor/, the same
environment variables, ring layout and metric families).

One server process serves every request with one interpreter lock. This
package runs N worker processes, each the port's full S3 server, under a
supervisor that spawns them, respawns one that dies and drains them, and
keeps both batch planes coalesced across them:

- metaplane: each worker journals into its own per-drive WAL segment
  (`journal.w<id>.wal`); a mount folds every segment no live worker
  holds, and journals materialize inside the ack, so a write acknowledged
  by one worker reads back through any other.
- dataplane: lane work of every worker coalesces into shared K1 and K2
  launches in worker 0 through a shared-memory ring (shm.py): worker 0
  serves it (laneserver.LaneServer), the others submit to it
  (laneserver.LaneClient) and fall back to their own plane, which
  launches the same kernels in their own CUDA context, when the ring
  cannot serve. The hot tier lives in worker 0; siblings probe it over
  the ring (OP_HOTGET).

Each worker is a process of its own with its own CUDA context, started
with `subprocess.Popen`; the supervisor never touches CUDA. The ring
carries host bytes; worker 0 stages them through its pinned rings like
any other lane work.

Worker identity threads into obs: trace records carry `<addr>#w<id>` as
the node, every response carries `X-Mtpu-Worker`, and the
`minio_tpu_frontdoor_*` families label by `worker`.

Run: python -m minio_tpu_torch.frontdoor --workers 4 --device cuda \\
         --address 127.0.0.1:9000 /tmp/d{0...11}
"""

from __future__ import annotations

import os

WORKERS_ENV = "MTPU_FRONTDOOR_WORKERS"
WORKER_ID_ENV = "MTPU_FRONTDOOR_WORKER"
DRAIN_ENV = "MTPU_FRONTDOOR_DRAIN_S"
SHARD_ENV = "MTPU_FRONTDOOR_SHARD"
RING_ENV = "MTPU_FRONTDOOR_RING"
SHARED_LANES_ENV = "MTPU_FRONTDOOR_SHARED_LANES"
CONTROL_ENV = "MTPU_FRONTDOOR_CONTROL"


def worker_count() -> int:
    """Configured worker-pool width (1 = one process)."""
    try:
        return max(1, int(os.environ.get(WORKERS_ENV, "1") or 1))
    except ValueError:
        return 1


def worker_id() -> int | None:
    """This process's worker id, or None outside a front-door worker."""
    raw = os.environ.get(WORKER_ID_ENV, "")
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def multiworker() -> bool:
    """True inside a worker of a pool with siblings: the mode in which the
    cross-process rules (WAL segments, eager materialization, stat-based
    cache signatures) apply."""
    return worker_id() is not None and worker_count() > 1


def drain_timeout() -> float:
    """Seconds a draining worker gives its in-flight requests."""
    try:
        return float(os.environ.get(DRAIN_ENV, "10") or 10)
    except ValueError:
        return 10.0


def shard_policy() -> str:
    """`router` (default: the supervisor accepts and passes each connection
    round-robin, balanced on every kernel) or `reuseport` (every worker
    listens on the address and the kernel spreads the accepts)."""
    return os.environ.get(SHARD_ENV, "router") or "router"


def control_path() -> str:
    """The router's control socket, published by the supervisor."""
    return os.environ.get(CONTROL_ENV, "")


def shared_lanes() -> bool:
    """Cross-process lane coalescing over the shm ring."""
    return os.environ.get(SHARED_LANES_ENV, "") in ("1", "true", "on")


def ring_name() -> str:
    """The shm ring's name, published by the supervisor."""
    return os.environ.get(RING_ENV, "")
