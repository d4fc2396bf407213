"""Admission control of the batch planes (counterpart of
minio_tpu/utils/admission.py).

A plane whose bounded queue is full, or that is closed, rejects the
submit with AdmissionShed, an OperationTimedOut that the S3 error map
answers as 503 SlowDown. Each shed is counted by (plane, cause), with the
JAX package's slugs (planes "dataplane", "metaplane"; causes "lane_full",
"wal_full", "wal_flush_full", "closed", and "tenant_quota" when a QoS
token bucket refused the op), in the family
minio_tpu_admission_shed_total{plane,cause,tenant}. The tenant label is
the request's (qos.metric_key(): "-" for unattributed work, "~other"
past the label cardinality cap). `stats()` returns this process's counts
by (plane, cause).
"""

from __future__ import annotations

import threading

from minio_tpu_torch import obs, qos
from minio_tpu_torch.utils import errors as se

_SHED = obs.counter(
    "minio_tpu_admission_shed_total",
    "Requests shed at a full batch-plane admission queue "
    "(surfaces as 503 SlowDown)",
    ("plane", "cause", "tenant"))

_mu = threading.Lock()
_sheds: dict[tuple[str, str], int] = {}


def shed(plane: str, cause: str, msg: str) -> se.AdmissionShed:
    """Count one shed and build the typed rejection; the caller raises it."""
    _SHED.labels(plane=plane, cause=cause, tenant=qos.metric_key()).inc()
    with _mu:
        _sheds[(plane, cause)] = _sheds.get((plane, cause), 0) + 1
    return se.AdmissionShed(msg=msg)


def stats() -> dict[tuple[str, str], int]:
    """Sheds so far, by (plane, cause)."""
    with _mu:
        return dict(_sheds)
