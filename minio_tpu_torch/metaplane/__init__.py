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
adds none. The port has no multi-process front door yet, so it is always
the only writer of its drives' journals (`single_owner()`).
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


def single_owner() -> bool:
    """True when this process is its drives' only journal writer. The
    port has no multi-worker front door, so it always is."""
    return True


def eager_materialize() -> bool:
    """Materialize each batch before its futures resolve (MTPU_WAL_EAGER=1;
    forced under a multi-worker front door in the JAX package)."""
    return not single_owner() or os.environ.get("MTPU_WAL_EAGER", "") == "1"


def cache_objects() -> int:
    """Set-level FileInfo cache capacity, in objects (LRU)."""
    return int(os.environ.get("MTPU_METAPLANE_CACHE", "4096"))
