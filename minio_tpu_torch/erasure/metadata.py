"""Erasure metadata helpers: deterministic drive ordering, quorum election,
and the drive fan-out (counterpart of minio_tpu/erasure/metadata.py).

hash_order must match the JAX package bit for bit: it decides which drive
holds which shard, so two packages serving one drive set must agree.
"""

from __future__ import annotations

import hashlib
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

from minio_tpu_torch import obs
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.utils import errors as se


def hash_order(key: str, card: int) -> list[int]:
    """Deterministic 1-based drive ordering for an object key: a rotation of
    [1..card] starting at a blake2b-derived index (reference hashOrder,
    cmd/erasure-metadata-utils.go:100, keyed differently)."""
    if card <= 0:
        return []
    seed = int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")
    start = seed % card
    return [(start + i) % card + 1 for i in range(card)]


def shuffle_by_distribution(items: Sequence, distribution: Sequence[int]) -> list:
    """result[shard_index-1] = the item of the physical drive holding that
    shard: distribution[i] is the 1-based shard index of physical drive i
    (cmd/erasure-metadata-utils.go:148-210)."""
    out = [None] * len(items)
    for physical, shard_idx in enumerate(distribution):
        out[shard_idx - 1] = items[physical]
    return out


_POOL: ThreadPoolExecutor | None = None
_POOL_LOCK = threading.Lock()


def _shared_pool() -> ThreadPoolExecutor:
    """One process-wide drive-I/O pool (its workers outlive requests, as
    the JAX package's `mtpu-io` pool does)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=64,
                                       thread_name_prefix="mtpu-io")
        return _POOL


def parallel_map(fns: Sequence[Callable]) -> list:
    """Run per-drive closures concurrently; exceptions come back as values
    (the reference's errgroup-with-indexed-errors). A caller steals any
    closure the pool has not started, so nested fan-outs cannot deadlock.
    Per-drive deadlines and hedging are later work (ROADMAP.md)."""
    results: list = [None] * len(fns)

    def run(i: int) -> None:
        try:
            results[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - per-drive errors are data
            results[i] = e

    if len(fns) <= 1:
        for i in range(len(fns)):
            run(i)
        return results
    pool = _shared_pool()
    # ctx_wrap per submission: pool workers do not inherit context
    # variables, and the drives' trace records need the request's.
    futs = [pool.submit(obs.ctx_wrap(run), i) for i in range(len(fns))]
    for i, f in enumerate(futs):
        if f.cancel():
            run(i)
        else:
            f.result()
    return results


def reduce_write_quorum(results: Sequence[object], quorum: int,
                        bucket: str = "", obj: str = "") -> None:
    """Raise unless at least `quorum` drives succeeded: the dominant error
    when IT reached quorum, else InsufficientWriteQuorum
    (cmd/erasure-metadata-utils.go:72-100)."""
    keys = [None if not isinstance(r, Exception) else type(r).__name__
            for r in results]
    if not keys:
        raise se.InsufficientWriteQuorum(bucket, obj, "no drives")
    (key, count), = Counter(keys).most_common(1)
    if count >= quorum:
        if key is None:
            return
        raise next(r for r in results
                   if isinstance(r, Exception) and type(r).__name__ == key)
    summary = ", ".join(type(r).__name__ if isinstance(r, Exception) else "ok"
                        for r in results)
    raise se.InsufficientWriteQuorum(
        bucket, obj, f"write quorum {quorum} not met: {summary}")


def election_sig(fi: FileInfo) -> tuple:
    """Drives agreeing on this tuple hold the same logical version."""
    return (round(fi.mod_time, 6), fi.data_dir, fi.version_id, fi.deleted)


def find_fileinfo_in_quorum(fis: Sequence[object], quorum: int,
                            bucket: str, obj: str) -> FileInfo:
    """Elect the authoritative FileInfo: at least `quorum` drives must agree
    (reference findFileInfoInQuorum, cmd/erasure-metadata.go:124-155)."""
    counter = Counter(election_sig(fi) for fi in fis if isinstance(fi, FileInfo))
    if counter:
        best, count = counter.most_common(1)[0]
        if count >= quorum:
            return next(fi for fi in fis
                        if isinstance(fi, FileInfo) and election_sig(fi) == best)
    errs = [r for r in fis if isinstance(r, Exception)]
    if errs:
        name, count = Counter(type(e).__name__ for e in errs).most_common(1)[0]
        if count >= quorum:
            raise next(e for e in errs if type(e).__name__ == name)
    raise se.InsufficientReadQuorum(bucket, obj, f"metadata quorum {quorum} not met")
