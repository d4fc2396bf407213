"""HBM-resident hot-object tier (counterpart of minio_tpu/hottier/).

The hottest objects' data shards (and their mxsum digest baselines) stay
resident in device memory, so a hot GET is one K2 launch over a window of
a resident tensor and one download: no drive opened, no quorum fan-out.

Gate: `MTPU_HOTTIER=1` (opt-in: the tier pins device memory). The drive
path is the fallback on every miss and the byte-exactness oracle. A hit
requires the freshly elected FileInfo to match the resident entry's
identity, so a stale entry can only miss, never serve.

The process-wide tier of a device is created on first use. Under the
multi-process front door the tier lives in worker 0 beside its
LaneServer; sibling workers install a router (`set_router`) whose client
probes it over the shm ring (OP_HOTGET), so every worker's hot GETs share
one residence and its launches (frontdoor/laneserver.py).
"""

from __future__ import annotations

import os
import threading

import torch

from minio_tpu_torch.utils import device as device_mod

ENABLE_ENV = "MTPU_HOTTIER"

_global_mu = threading.Lock()
_global_tiers: dict = {}
# Optional tier router, consulted by maybe_tier before the process's own
# tier (a sibling front-door worker's HotRingClient).
_router = None
# Optional process-wide admit reader: fn(bucket, obj) -> (info, byte
# iterator), used when a miss note carries no reader of its own.
_reader = None


def enabled() -> bool:
    """Read the env gate live: opt-in."""
    return os.environ.get(ENABLE_ENV, "0") in ("1", "true", "on")


def get_tier(device: "torch.device | str" = "cuda"):
    """The process-wide tier of `device`, created on first use."""
    from minio_tpu_torch.hottier.tier import HotObjectTier

    device = device_mod.resolve(device)
    with _global_mu:
        tier = _global_tiers.get(device)
        if tier is None or tier.closed:
            tier = _global_tiers[device] = HotObjectTier(device=device)
        return tier


def set_router(fn) -> None:
    """Install (or clear, with None) the tier router maybe_tier consults
    first."""
    global _router
    _router = fn


def set_reader(fn) -> None:
    """Register the process-wide admit reader (or clear it with None)."""
    global _reader
    _reader = fn


def default_reader():
    return _reader


def maybe_tier(device: torch.device):
    """The tier of `device` when the gate is on, else None (drive path).
    The GET integration point calls this per request."""
    if not enabled():
        return None
    if _router is not None:
        tier = _router()
        if tier is not None:
            return tier
    return get_tier(device)


def reset_global() -> None:
    """Close and drop every process-wide tier (tests; safe when none was
    built)."""
    with _global_mu:
        tiers = list(_global_tiers.values())
        _global_tiers.clear()
    for tier in tiers:
        tier.close()
