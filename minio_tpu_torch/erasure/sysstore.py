"""Mirrored small-file writes across a drive set (the part of
minio_tpu/erasure/sysstore.py multipart needs).

Small documents (multipart session and part journals) are not striped:
each is written whole to every drive, and reads elect the content by
majority, so they survive the drive losses the data path survives.
"""

from __future__ import annotations

from minio_tpu_torch.erasure.metadata import parallel_map


def mirror_write_all(drives, vol: str, rel: str, data: bytes) -> list:
    """Write `data` to `vol/rel` on every drive in parallel, each with its
    own fsync (the JAX function's branch for drives without a group-commit
    WAL, which the port's drives do not have). Returns per-drive outcomes
    (None | Exception) for the caller's quorum reducer."""
    return parallel_map([lambda d=d: d.write_all(vol, rel, data) for d in drives])
