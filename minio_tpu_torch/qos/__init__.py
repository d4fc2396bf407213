"""Per-tenant QoS plane: identity, arming, and fair-queue wiring
(counterpart of minio_tpu/qos/__init__.py, the same knobs and defaults).

A *tenant* is (access key, bucket), the unit the front door can
isolate. It is resolved once per request in `S3Server.dispatch`
(s3/server.py), right after authentication, and carried in a contextvar
exactly like the trace id (obs/span.py): it crosses thread hops via
`obs.ctx_wrap`, and crosses the front door's shm ring as a 12-byte tag
in the slot header (MTPUFDR3), so worker 0's coalesced lanes know whose
work each row is.

Arming: `MTPU_QOS=1` turns the subsystem on. Disarmed (the default),
`plane_queue()` returns a plain bounded `queue.Queue` and `ring_gate()`
returns None. Armed, each batch plane's admission queue becomes a
`scheduler.FairQueue` (deficit round robin + per-tenant backlog shares
+ token-bucket quotas; see that module for the model and the starvation
bound) and OP_HOTGET ring probes pass a `scheduler.RingGate`.

Knobs (the JAX package's names and defaults):
  MTPU_QOS            arm the subsystem (default 0)
  MTPU_QOS_WEIGHTS    "key=weight,..." — key is "access_key/bucket",
                      "access_key", or "*"; unlisted tenants weigh 1
  MTPU_QOS_QUANTUM    DRR quantum (items per weight unit per round)
  MTPU_QOS_MIN_SHARE  per-tenant backlog floor (items)
  MTPU_QOS_RATE_OPS   per-tenant submissions/sec token bucket (0=off)
  MTPU_QOS_RATE_BYTES per-tenant payload bytes/sec token bucket (0=off)
  MTPU_QOS_BURST_S    seconds of rate accumulated as bucket burst
  MTPU_QOS_HOTGET_OPS per-tenant OP_HOTGET ring probes/sec (0=off)

Requests with no tenant (pre-auth rejects, /minio/ admin surface,
internal maintenance) ride the reserved "-" system lane.
"""

from __future__ import annotations

import contextvars
import os

from minio_tpu_torch.qos import scheduler
from minio_tpu_torch.qos.scheduler import FairQueue, QuotaFull, RingGate, TokenBucket

__all__ = [
    "FairQueue", "QuotaFull", "RingGate", "TokenBucket", "Tenant",
    "armed", "bind", "bind_key", "reset", "current", "current_key",
    "metric_key", "parse_weights", "plane_queue", "ring_gate",
    "tenant_tag", "key_from_tag", "UNATTRIBUTED", "METRIC_OVERFLOW",
    "TAG_LEN",
]

UNATTRIBUTED = "-"
METRIC_OVERFLOW = "~other"   # fold label once the cardinality cap hits
TAG_LEN = 12   # tenant tag width in the shm slot header (bytes)


class Tenant:
    """Immutable (access_key, bucket) identity. `key` is the string
    every queue/metric/label uses: "access_key/bucket", or just the
    access key for requests with no bucket (ListBuckets, admin)."""

    __slots__ = ("access_key", "bucket")

    def __init__(self, access_key: str, bucket: str = ""):
        self.access_key = access_key or ""
        self.bucket = bucket or ""

    @property
    def key(self) -> str:
        if not self.access_key:
            return UNATTRIBUTED
        return f"{self.access_key}/{self.bucket}" if self.bucket \
            else self.access_key

    def __repr__(self) -> str:
        return f"Tenant({self.key!r})"


_tenant: contextvars.ContextVar = contextvars.ContextVar(
    "mtpu_tenant", default=None)


def bind(access_key: str, bucket: str = ""):
    """Bind the calling context's tenant; returns a reset token."""
    return _tenant.set(Tenant(access_key, bucket))


def bind_key(key: str):
    """Re-bind from a serialized key (ring slot tag, RPC header)."""
    if not key or key == UNATTRIBUTED:
        return _tenant.set(None)
    ak, _, bkt = key.partition("/")
    return _tenant.set(Tenant(ak, bkt))


def reset(token) -> None:
    _tenant.reset(token)


def current():
    return _tenant.get()


def current_key() -> str:
    t = _tenant.get()
    return t.key if t is not None else UNATTRIBUTED


# -- metric label hygiene ---------------------------------------------
#
# The tenant key embeds the bucket SEGMENT OF THE URL, taken before any
# bucket-existence check — an unauthenticated scanner sweeping paths
# would mint one time-series per probe ("anonymous/<path>") in every
# per-tenant metric family. The FairQueue has its own 4096-lane
# backstop; this is the registry-side one: after _METRIC_TENANTS_CAP
# distinct keys, new tenants fold into the single METRIC_OVERFLOW
# label. Scheduling/quotas are never folded — only metric labels.

_METRIC_TENANTS_CAP = 1024
_metric_tenants: set = set()


def metric_key(key: str | None = None) -> str:
    """Tenant label safe for unbounded-cardinality metric families:
    the tenant key itself until the distinct-label backstop fills,
    METRIC_OVERFLOW after. First-come-first-labeled; benign races
    under the GIL can only overshoot the cap by a few entries."""
    if key is None:
        key = current_key()
    if key == UNATTRIBUTED or key in _metric_tenants:
        return key
    if len(_metric_tenants) >= _METRIC_TENANTS_CAP:
        return METRIC_OVERFLOW
    _metric_tenants.add(key)
    return key


# -- serialization across the shm ring -------------------------------

def tenant_tag() -> bytes:
    """Current tenant key as the fixed-width slot-header tag (utf-8,
    truncated to TAG_LEN — the tag is an attribution/scheduling hint,
    not an auth boundary, so truncation only coarsens fairness)."""
    key = current_key()
    return b"" if key == UNATTRIBUTED else key.encode("utf-8")[:TAG_LEN]


def key_from_tag(tag: bytes) -> str:
    if not tag:
        return UNATTRIBUTED
    return tag.rstrip(b"\x00").decode("utf-8", "replace") or UNATTRIBUTED


# -- knobs -----------------------------------------------------------

def armed() -> bool:
    return os.environ.get("MTPU_QOS", "0") == "1"


def parse_weights(spec: str | None = None) -> dict[str, float]:
    """Parse MTPU_QOS_WEIGHTS ("key=weight,key=weight"). Malformed
    entries are dropped — a bad knob must not take down admission."""
    if spec is None:
        spec = os.environ.get("MTPU_QOS_WEIGHTS", "")
    out: dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        key, _, val = part.rpartition("=")
        try:
            w = float(val)
        except ValueError:
            continue
        if key and w > 0:
            out[key] = w
    return out


def _fenv(raw: str, default: float) -> float:
    """Float knob value with a safe fallback — env reads stay literal
    at the call sites, where each knob name reads in full."""
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


# -- wiring factories ------------------------------------------------

def plane_queue(plane: str, cap: int, *, tenant_of=None, cost_of=None,
                is_control=None, is_barrier=None):
    """The admission queue for one batch plane: a plain bounded
    `queue.Queue` when disarmed (bit-identical legacy behavior), a
    tenant-fair `FairQueue` when armed. `is_barrier` marks items that
    must keep strict submit order against everything else (the WAL's
    tombstone records — see scheduler.py's fence contract)."""
    if not armed():
        import queue
        return queue.Queue(maxsize=cap)
    return FairQueue(
        cap,
        weights=parse_weights(),
        quantum=int(_fenv(os.environ.get("MTPU_QOS_QUANTUM", "4"), 4)),
        min_share=int(_fenv(os.environ.get("MTPU_QOS_MIN_SHARE", "1"), 1)),
        rate_ops=_fenv(os.environ.get("MTPU_QOS_RATE_OPS", "0"), 0.0),
        rate_bytes=_fenv(os.environ.get("MTPU_QOS_RATE_BYTES", "0"), 0.0),
        burst_s=_fenv(os.environ.get("MTPU_QOS_BURST_S", "1"), 1.0),
        tenant_of=tenant_of,
        cost_of=cost_of,
        is_control=is_control,
        is_barrier=is_barrier,
        unattributed=UNATTRIBUTED)


def ring_gate(slots: int):
    """Client-side OP_HOTGET admission gate, or None when disarmed."""
    if not armed():
        return None
    return RingGate(
        slots,
        weights=parse_weights(),
        rate_ops=_fenv(os.environ.get("MTPU_QOS_HOTGET_OPS", "0"), 0.0),
        burst_s=_fenv(os.environ.get("MTPU_QOS_BURST_S", "1"), 1.0))
