"""Erasure metadata helpers: deterministic drive ordering, quorum election,
and the drive fan-out (counterpart of minio_tpu/erasure/metadata.py).

hash_order must match the JAX package bit for bit: it decides which drive
holds which shard, so two packages serving one drive set must agree.
parallel_map takes the fan-out's deadline (the drives' adaptive deadlines,
storage/healthcheck.py fleet_deadlines), so a hung drive costs a request
one deadline and counts as a failed drive.
"""

from __future__ import annotations

import hashlib
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
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


_HUNG_WORKERS = obs.counter(
    "minio_tpu_hung_workers_total",
    "Worker threads abandoned on a hung drive op (pool capacity refilled)")


def note_leaked_worker(pool=None, fut=None) -> None:
    """Account a worker left inside a hung drive call and, for a pool,
    lend it one more worker until that call returns (`fut` done), so a
    hung drive never starves the healthy ones."""
    _HUNG_WORKERS.labels().inc()
    if pool is None:
        return
    with _POOL_LOCK:
        pool._max_workers += 1
    if fut is not None:
        def returned(_f, pool=pool):
            with _POOL_LOCK:
                if pool._max_workers > 1:
                    pool._max_workers -= 1

        fut.add_done_callback(returned)


def _await_run(fut, started: Callable[[], float], deadline: float,
               grace_end: float) -> bool:
    """Wait for `fut` until `deadline` seconds after its closure began
    (`started()`, on the monotonic clock, 0.0 while it queues) or, while
    it still queues behind a saturated pool, until `grace_end`. True when
    it completed. Time spent queued is the pool's, not the drive's, so it
    never counts against the closure's deadline."""
    while True:
        s = started()
        limit = s + deadline if s else grace_end
        try:
            fut.result(timeout=max(0.0, limit - time.monotonic()))
            return True
        except FutureTimeout:
            if started() == s:
                return False


def run_bounded(fn: Callable, deadline: float) -> bool:
    """Run fn() on a shared-pool worker and wait at most `deadline`
    seconds from its start (it may queue up to twice that behind a
    saturated pool). True when it completed; False when it is still
    running, its worker then abandoned and accounted. Called from a pool
    worker, fn runs inline (the outer fan-out carries the deadline)."""
    if threading.current_thread().name.startswith("mtpu-io"):
        fn()
        return True
    started = [0.0]

    def run() -> None:
        started[0] = time.monotonic()
        fn()

    pool = _shared_pool()
    fut = pool.submit(obs.ctx_wrap(run))
    if _await_run(fut, lambda: started[0], deadline,
                  time.monotonic() + 2 * deadline):
        fut.result()
        return True
    if not fut.cancel():
        note_leaked_worker(pool, fut)
    return False


def parallel_map(fns: Sequence[Callable], deadline: float | None = None) -> list:
    """Run per-drive closures concurrently; exceptions come back as values
    (the reference's errgroup-with-indexed-errors). Without a deadline a
    caller steals any closure the pool has not started, so nested
    fan-outs cannot deadlock. With one, a closure still running
    `deadline` seconds after it began becomes an OperationTimedOut value
    (the quorum reducers count a hung drive as a failed one), its worker
    abandoned and accounted, and its late result dropped. A closure may
    queue behind a saturated pool for up to twice the deadline before it
    starts; its time in the queue does not count against it (under load
    the queue, not the drive, would strike it), so the caller waits at
    most three deadlines."""
    results: list = [None] * len(fns)

    def run(i: int) -> None:
        try:
            results[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - per-drive errors are data
            results[i] = e

    if deadline is None:
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

    mu = threading.Lock()
    abandoned = [False] * len(fns)
    started = [0.0] * len(fns)

    def run_guarded(i: int) -> None:
        started[i] = time.monotonic()
        try:
            r = fns[i]()
        except Exception as e:  # noqa: BLE001 - per-drive errors are data
            r = e
        with mu:
            if not abandoned[i]:
                results[i] = r

    pool = _shared_pool()
    futs = [pool.submit(obs.ctx_wrap(run_guarded), i) for i in range(len(fns))]
    grace_end = time.monotonic() + 2 * deadline
    for i, f in enumerate(futs):
        if _await_run(f, lambda i=i: started[i], deadline, grace_end):
            continue
        with mu:
            abandoned[i] = True
            results[i] = se.OperationTimedOut(
                msg=f"drive op exceeded {deadline:.2f}s deadline")
        if not f.cancel():
            note_leaked_worker(pool, f)
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
