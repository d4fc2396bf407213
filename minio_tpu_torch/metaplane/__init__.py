"""Group-commit metadata plane (counterpart of minio_tpu/metaplane/).

Concurrent journal commits on one drive coalesce into one durable WAL
fsync per batch, and a set-level FileInfo cache answers GET/HEAD without
the N-drive quorum read while the journals it was elected from are
unchanged:

- `wal.py`: the per-drive journal format (CRC-framed records, a scan
  that stops at a torn tail, the replay fold), byte for byte the JAX
  package's, so either package replays what the other left;
- `groupcommit.py`: `DriveWAL`, one committer thread per drive; the ack
  of a journal store is the WAL fsync covering its record, the meta.mp
  files materialize later, and reads consult the pending overlay first;
- `setcache.py`: `SetFileInfoCache`, the post-election cache validated by
  each local drive's per-key WAL sequence number.

On by default, as in the JAX package: MTPU_METAPLANE=0 (or false, off)
restores the per-request write + fsync + rename of every journal. A WAL
left on a drive is replayed at mount whatever the gate says. The knobs
are the JAX package's environment variables with its defaults; the port
adds none. Under the multi-process front door (`frontdoor/`) every
worker journals into its own segment (`wal_segment()`), and the
cross-process rules of `single_owner()` apply.
"""

from __future__ import annotations

import os

ENABLE_ENV = "MTPU_METAPLANE"


def enabled() -> bool:
    """The gate, read live (tests flip it per case). Default on."""
    return os.environ.get(ENABLE_ENV, "1") not in ("0", "false", "off")


def wal_max_bytes() -> int:
    """WAL size past which the committer checkpoints (materialize all,
    one sync, truncate)."""
    return int(os.environ.get("MTPU_WAL_MAX_BYTES", str(16 << 20)))


def wal_max_pending() -> int:
    """Pending keys past which the committer materializes even under
    sustained commit load."""
    return int(os.environ.get("MTPU_WAL_MAX_PENDING", "4096"))


def wal_max_batch() -> int:
    """Records per group commit."""
    return int(os.environ.get("MTPU_WAL_MAX_BATCH", "256"))


def wal_queue_depth() -> int:
    """Bounded submission queue per drive; a full queue sheds the submit
    (503 SlowDown through utils/admission.py)."""
    return int(os.environ.get("MTPU_WAL_QUEUE", "8192"))


def lazy_materialize() -> bool:
    """Never materialize between checkpoints (reads serve from the
    overlay): the crash tests pin the fsynced-but-not-materialized state
    with it."""
    return os.environ.get("MTPU_WAL_LAZY_MATERIALIZE", "") == "1"


def wal_segment() -> str:
    """Journal segment suffix of this process (`journal.<seg>.wal`); empty
    for the single-owner `journal.wal`. The front-door supervisor stamps
    MTPU_WAL_SEGMENT=w<id> into every worker, so each segment file has one
    writer process."""
    return os.environ.get("MTPU_WAL_SEGMENT", "")


def single_owner() -> bool:
    """True when this process is its drives' only journal writer. False in
    a worker of a multi-worker front door: journals then materialize inside
    the ack (still no per-file fsync), the set cache validates by stat
    instead of sequence numbers, and a fresh volume proves no key absent
    (a sibling may have journaled it)."""
    from minio_tpu_torch import frontdoor

    return not frontdoor.multiworker()


def eager_materialize() -> bool:
    """Materialize each batch before its futures resolve: forced under a
    multi-worker front door (read-your-write across processes flows
    through the filesystem), opt-in with MTPU_WAL_EAGER=1 otherwise."""
    return not single_owner() or os.environ.get("MTPU_WAL_EAGER", "") == "1"


def cache_objects() -> int:
    """Set-level FileInfo cache capacity, in objects (LRU)."""
    return int(os.environ.get("MTPU_METAPLANE_CACHE", "4096"))
