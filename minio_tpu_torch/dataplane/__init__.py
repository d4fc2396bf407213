"""Batched device data plane (counterpart of minio_tpu/dataplane/).

Aggregates concurrent codec work (PUT shard-encodes, GET verifies and
reconstructions, heal rebuilds, deep scans) from request threads into
coalesced lane launches of K1 and K2 (batcher.py), staged through a ring
of pinned slots allocated once (ring.py), instead of one launch per
object.

ON BY DEFAULT, as in the JAX package: `MTPU_BATCHED_DATAPLANE=0` opts out
and restores the per-object codec path, which also serves every block
above the width gates and every submit the plane sheds. The process-wide
plane of a device is created on first use and lives for the process (its
threads are daemons named `mtpu-dataplane-*`); tests that build their own
planes close() them. A worker of the multi-process front door installs a
router (`set_router`) whose LaneClient sends lane work over the shm ring
to worker 0's plane (frontdoor/laneserver.py).
"""

from __future__ import annotations

import os
import threading

import torch

from minio_tpu_torch.dataplane.batcher import BatchPlane  # noqa: F401
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se

ENABLE_ENV = "MTPU_BATCHED_DATAPLANE"

_global_mu = threading.Lock()
_global_planes: dict[torch.device, BatchPlane] = {}
# Optional plane router, consulted by maybe_plane before the process's own
# plane: fn() -> a plane-shaped object, or None for the local plane.
_router = None


def enabled() -> bool:
    """Read the env gate live. Default ON; "0"/"false"/"off" opts out."""
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


def get_plane(device: "torch.device | str" = "cuda") -> BatchPlane:
    """The process-wide plane of `device`, created on first use."""
    device = device_mod.resolve(device)
    with _global_mu:
        plane = _global_planes.get(device)
        if plane is None or plane.closed:
            plane = _global_planes[device] = BatchPlane(device=device)
        return plane


def set_router(fn) -> None:
    """Install (or clear, with None) the plane router maybe_plane consults
    first."""
    global _router
    _router = fn


def maybe_plane(device: torch.device) -> BatchPlane | None:
    """The plane of `device` when the gate is on, else None (per-object
    codec path): the router's when one is installed and answers, else the
    process's own. The serving integration points call this per batch."""
    if not enabled():
        return None
    if _router is not None:
        plane = _router()
        if plane is not None:
            return plane
    return get_plane(device)


def digest_chunks(chunks: list, cap: int, device: torch.device) -> list[bytes]:
    """mxsum256 digests of ragged chunks (each <= cap), as the JAX read,
    heal and deep-verify paths take them: through the plane when it is on
    and takes chunks of width `cap` (MTPU_DP_MAX_WIDTH), else, or when the
    plane sheds the submit, in one launch of their own."""
    from minio_tpu_torch.ops import fused

    plane = maybe_plane(device)
    if plane is not None and plane.accepts_chunk(cap):
        try:
            return plane.digest_chunks(chunks, cap)
        except se.OperationTimedOut:
            pass  # plane saturated: the per-object launch below serves
    return fused.digest_chunks_host(chunks, cap, device)


def reset_global() -> None:
    """Close and drop every process-wide plane (tests; safe when none
    was built)."""
    with _global_mu:
        planes = list(_global_planes.values())
        _global_planes.clear()
    for plane in planes:
        plane.close()
