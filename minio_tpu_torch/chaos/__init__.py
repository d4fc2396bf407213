"""Composed chaos plane — one seed drives every fault plane (counterpart
of minio_tpu/chaos/, the same seeds, schedules, ledger folds and checks).

Three fault planes meet here: drive faults (`chaos/naughty.py`, the
NaughtyDisk StorageAPI decorator), network faults (`dist/faultplane.py`)
and process crash and restart (the process harnesses of the tests and of
`chip_smoke.py`):

- **seed discipline** (this module): every plane derives its RNG seed
  from one master integer (`MTPU_CHAOS_SEED`), so one number reproduces
  the whole storm, in either package;
- **schedule.py** — a deterministic timeline of drive, network and
  process fault events, previewable without consuming
  (`ChaosProgram.schedule(n)`), executed against pluggable actuators;
- **ledger.py** — a write-ahead ledger of acknowledged S3 operations,
  the ground truth the invariants replay after the storm;
- **workload.py** — a mixed PUT/GET/DELETE/multipart/list client fleet
  on the stdlib HTTP client that records every acknowledged op;
- **invariants.py** — zero lost acknowledged writes, no torn reads,
  heal convergence, cross-node agreement and the SLO check, every
  failure message carrying the seed that replays the storm.
"""

from __future__ import annotations

import hashlib
import os

#: One integer reproduces the whole storm: network jitter, drive fault
#: placement, crash timing, and the workload's key and content streams.
MASTER_SEED_ENV = "MTPU_CHAOS_SEED"


def master_seed(default: int = 0) -> int:
    """The composed-chaos master seed (`MTPU_CHAOS_SEED`, default 0)."""
    try:
        return int(os.environ.get(MASTER_SEED_ENV, "") or default)
    except ValueError:
        return default


def subseed(master: int, plane: str) -> int:
    """Stable per-plane child seed. sha256, not `hash()`: string hashing
    is salted per process, and the SAME integer must replay the SAME
    storm in the test process and in every server process it boots."""
    h = hashlib.sha256(f"{master}:{plane}".encode()).digest()
    return int.from_bytes(h[:8], "big") & 0x7FFFFFFFFFFFFFFF


def clear_all() -> dict:
    """Teardown across the planes: release every NaughtyDisk fault
    program (HANG sentinels included), uninstall the network fault plane
    (healing every partition), and re-close every peer and replication
    target breaker. Returns what was cleared (all zeros on a clean
    run)."""
    from minio_tpu_torch.chaos import naughty
    from minio_tpu_torch.dist import faultplane, rpc
    from minio_tpu_torch.replication import client as repl_client

    cleared = {"drive_faults": naughty.clear_all(),
               "net_plane": 0, "breakers_reset": 0}
    if faultplane.get() is not None:
        faultplane.uninstall()
        cleared["net_plane"] = 1
    cleared["breakers_reset"] = (rpc.reset_breakers()
                                 + repl_client.reset_breakers())
    return cleared


def anything_armed() -> bool:
    """Cheap leak probe after a test: is any fault plane still armed? A
    live client's breaker that is not CLOSED counts: a storm that
    uninstalled its plane but left breakers open would bleed instant
    DiskNotFound into the next test's first RPCs."""
    from minio_tpu_torch.chaos import naughty
    from minio_tpu_torch.dist import faultplane, rpc

    return (faultplane.get() is not None or naughty.any_armed()
            or any(not c._closed
                   and c.breaker_state() != rpc.BREAKER_CLOSED
                   for c in rpc._clients()))
