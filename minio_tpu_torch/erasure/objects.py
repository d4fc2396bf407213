"""ErasureObjects — one erasure set: the core object engine (counterpart of
minio_tpu/erasure/objects.py, reference cmd/erasure-object.go).

PutObject streams blocks through the batched device codec (parity from
K1 and, under mxsum256 or mxhash256, the digest of every shard chunk from
K2 or K3) and fans bitrot-framed shards out to one writer thread per
drive, which hashes its chunks itself under a host algorithm (sip256,
highwayhash256, xxh64, blake2b256, sha256), then commits with
write-quorum accounting. GetObject elects metadata by quorum, reads any k
shards data-first, verifies every chunk read in one digest launch per
batch (a host algorithm: per chunk on the reader threads), and
reconstructs through the codec only when shards are missing or corrupt.
Objects up to INLINE_DATA_LIMIT live inside the journal.

The on-disk result is the JAX package's: same shard placement (hash_order),
same part files, same journals, so a drive set written by either package
is served by the other.

Two planes ride the same points as in the JAX package: the batched data
plane (dataplane/, on unless MTPU_BATCHED_DATAPLANE=0) coalesces the
encode, verify and degraded-decode launches of concurrent requests, and
the HBM hot tier (hottier/, opt-in MTPU_HOTTIER=1) serves GETs of hot
objects from device-resident shards. Mutations invalidate the tier
through `_meta_invalidate`, the JAX package's hook.

Multipart uploads come from MultipartMixin (erasure/multipart.py): each
part is one more _fan_out_encode stream, and GET walks fi.parts.

Both PUT commits defer reclaim: what an overwrite displaces waits in a
reclaim capsule on each drive until the commit reaches write quorum, and
comes back when it does not.

Versioning (opts.versioned, set by the S3 layer from the bucket's
metadata document) gives every PUT and Complete a fresh version id, so an
overwrite adds a version and displaces nothing, and a DELETE without a
version id writes a delete marker. A read that names a version bypasses
the hot tier, which holds latest versions only.

With enable_mrf (build_server's default), a PUT that reaches write
quorum with drives missing, and a GET that read around a dead or corrupt
shard, queue the object on the set's MRF healer (erasure/healing.py),
which rebuilds it in the background: deep, digest by digest, when the GET
saw bitrot. Unlike the JAX package, an inline PUT queues too, so the
journals it missed come back as the shard files of a streamed PUT do.

With the metadata plane armed (metaplane/, on unless MTPU_METAPLANE=0),
an inline PUT submits its journal to every drive's WAL and then waits
once for the shared fsyncs, and GET/HEAD answer from the set-level
FileInfo cache while every local drive's signature of the key is
unchanged; mutations invalidate it through `_meta_invalidate`.

Every drive fan-out carries the drives' adaptive deadline of its class
(storage/healthcheck.py), so a hung drive costs one deadline and counts
as a failed drive. A GET reads its shards first-k-wins: after a hedge
delay (four times the rolling shard-read latency) a spare reader starts
on an unused parity shard for each straggler, and the batch completes
with the first k results. A GET of more than one batch reads batch N+1
on a `shard-readahead` thread while batch N is verified, decoded and
sent.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
import uuid
from typing import BinaryIO, Iterator

from minio_tpu_torch import dataplane, hottier, metaplane, obs
from minio_tpu_torch.erasure import listing
from minio_tpu_torch.erasure.codec import (BATCH_BLOCKS, DEFAULT_BLOCK_SIZE,
                                           ErasureCodec)
from minio_tpu_torch.erasure.healing import TRANSITION_TIER_KEY, HealingMixin, MRFHealer
from minio_tpu_torch.erasure.metadata import (find_fileinfo_in_quorum,
                                              hash_order, note_leaked_worker,
                                              parallel_map, reduce_write_quorum,
                                              shuffle_by_distribution)
from minio_tpu_torch.erasure.multipart import MultipartMixin
from minio_tpu_torch.erasure.sysstore import SysConfigStore
from minio_tpu_torch.obs import flight
from minio_tpu_torch.erasure.types import (BucketInfo, DeletedObject,
                                           ListObjectsInfo,
                                           ListObjectVersionsInfo, ObjectInfo,
                                           ObjectOptions, ObjectToDelete)
from minio_tpu_torch.ops import bitrot
from minio_tpu_torch.storage import healthcheck
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.fileinfo import (ChecksumInfo, ErasureInfo,
                                              FileInfo, PartInfo)
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.storage.xlmeta import XLMeta
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.streams import IterReader


# Objects at or below this size are inlined into the journal instead of
# getting shard files (reference inlines small objects in xl.meta v2).
INLINE_DATA_LIMIT = 16 << 10

# Rolling erasure-encode throughput, EWMA over per-fan-out bytes/wall (the
# JAX package's gauge, minio_tpu/erasure/objects.py:73).
_ENCODE_GIBPS = obs.gauge(
    "minio_tpu_encode_gibps",
    "Rolling erasure encode+fan-out throughput in GiB/s (EWMA)")

# Latest-only caches (the hot tier) bypass explicitly versioned reads and
# account them here instead of as misses.
_CACHE_BYPASS = obs.counter(
    "minio_tpu_cache_bypass_total",
    "Reads that bypassed a latest-only cache tier by contract",
    ("reason",))

# Tail-latency hedging of shard reads (first-k-wins): spares launched,
# and how many of them beat the straggler they covered for.
_HEDGED_READS = obs.counter(
    "minio_tpu_hedged_reads_total",
    "Spare shard reads launched after the hedge delay").labels()
_HEDGED_WINS = obs.counter(
    "minio_tpu_hedged_reads_won_total",
    "Hedged shard reads that made quorum before the straggler").labels()

_WRITE_SENTINEL = None


def default_parity(n_drives: int) -> int:
    """Default parity per set width (reference storage-class defaults,
    cmd/config/storageclass/storage-class.go:234)."""
    if n_drives == 1:
        return 0
    if n_drives <= 3:
        return 1
    if n_drives <= 5:
        return 2
    if n_drives <= 7:
        return 3
    return 4


def _read_full(data: BinaryIO, n: int) -> bytes:
    """Read exactly n bytes unless EOF (short reads are legal for sockets)."""
    if n <= 0:
        return b""
    first = data.read(n)
    if not first or len(first) == n:
        return first or b""
    buf = bytearray(first)
    while len(buf) < n:
        chunk = data.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return bytes(buf)


class ErasureObjects(HealingMixin, MultipartMixin, SysConfigStore):
    def __init__(self, drives: list[StorageAPI], parity: int | None = None,
                 block_size: int = DEFAULT_BLOCK_SIZE, device="cuda",
                 enable_mrf: bool = False, bitrot_algorithm: str | None = None,
                 nslock=None):
        """nslock: the namespace lock around mutating commits; a cluster
        passes its dsync one (dist/nslock.py), shared by the sets. By
        default an in-process lock table."""
        if not drives:
            raise ValueError("empty drive set")
        self.device = device_mod.resolve(device)
        self.drives = drives
        self.n = len(drives)
        self.parity = default_parity(self.n) if parity is None else parity
        if not 0 <= self.parity <= self.n // 2:
            raise ValueError(f"parity {self.parity} invalid for {self.n} drives "
                             f"(bound: drives/2 = {self.n // 2})")
        self.block_size = block_size
        # The algorithm new objects are written with (the JAX constructor
        # argument; mxsum256 by default, the JAX package's choice on an
        # accelerator). Objects written with any registered algorithm stay
        # readable: each version names its own in its checksums. Looking
        # it up builds the host hash library for a host algorithm, and
        # raises if that fails.
        self.bitrot_algorithm = (bitrot_algorithm if bitrot_algorithm
                                 else bitrot.device_default_algorithm())
        bitrot.get_algorithm(self.bitrot_algorithm)
        if nslock is None:
            from minio_tpu_torch.dist.nslock import NamespaceLockMap

            nslock = NamespaceLockMap()
        self.nslock = nslock
        self.mrf: MRFHealer | None = MRFHealer(self) if enable_mrf else None
        self._encode_gibps: float | None = None
        self._read_pool = None
        self._read_pool_mu = threading.Lock()
        # Hedged shard reads: an EWMA of one shard's batch-read latency
        # sets the hedge delay; hedge_delay pins it (tests, operators).
        # No history and no pin: no hedge before the data deadline.
        self._shard_lat: float | None = None
        self.hedge_delay: float | None = None
        self._setcache = None
        if metaplane.enabled():
            from minio_tpu_torch.metaplane.setcache import SetFileInfoCache

            self._setcache = SetFileInfoCache(metaplane.cache_objects())

    def close(self) -> None:
        """Stop the MRF thread (queued heals are dropped) and the shard
        read pool."""
        if self.mrf is not None:
            self.mrf.close()
        with self._read_pool_mu:
            if self._read_pool is not None:
                # Kept referenced: a racing GET then gets RuntimeError from
                # submit (a quorum error), never a fresh leaked pool.
                self._read_pool.shutdown(wait=False, cancel_futures=True)

    def _meta_deadline(self) -> float:
        """The fan-out deadline of metadata calls: the largest of the
        drives' adaptive deadlines of the class."""
        return healthcheck.fleet_deadlines(self.drives)[0]

    def _data_deadline(self) -> float:
        return healthcheck.fleet_deadlines(self.drives)[1]

    def _walk_deadline(self) -> float:
        return healthcheck.fleet_deadlines(self.drives)[2]

    def _shard_read_pool(self):
        """The set's pool of shard readers (one per GET stream would pay
        thread starts on the read path)."""
        from concurrent.futures import ThreadPoolExecutor

        with self._read_pool_mu:
            if self._read_pool is None:
                self._read_pool = ThreadPoolExecutor(
                    max_workers=max(self.n, 8), thread_name_prefix="shard-read")
            return self._read_pool

    def _queue_partial(self, bucket: str, obj: str, fi: FileInfo,
                       outcomes: list) -> None:
        """After a commit that reached quorum: queue a heal when some
        drive missed it (reference addPartial, cmd/erasure-object.go:1150)."""
        if self.mrf is not None and any(isinstance(o, Exception) for o in outcomes):
            self.mrf.add_partial(bucket, obj, fi.version_id)

    def _meta_invalidate(self, bucket: str, obj: str) -> None:
        """After a mutating fan-out (PUT, DELETE, heal): drop the key's
        set-cache entry (signatures would catch the change too; this
        spares the next read a miss probe) and its residence in the hot
        tier (a still-hot key re-admits). The tier's is advisory: a hit
        also needs the freshly elected FileInfo to match."""
        if self._setcache is not None:
            self._setcache.invalidate(bucket, obj)
        tier = hottier.maybe_tier(self.device)
        if tier is not None:
            tier.invalidate(bucket, obj)

    def all_drives(self) -> list[StorageAPI]:
        return list(self.drives)

    def health(self) -> dict:
        """Drives online against write quorum (the JAX package's health,
        minio_tpu/erasure/objects.py:280): what the health probes, the
        scrape and the admin info read. A drive whose disk_info raises
        counts as offline."""
        results = parallel_map([lambda d=d: d.disk_info() for d in self.drives],
                               deadline=self._meta_deadline())
        online = sum(1 for r in results if not isinstance(r, Exception))
        quorum = self._write_quorum_data(self.parity)
        return {"healthy": online >= quorum,
                "sets": [{"online": online, "total": self.n, "write_quorum": quorum}]}

    def parity_for_class(self, sc: str) -> int:
        """Parity for a storage class (reference GetParityForSC,
        cmd/config/storageclass/storage-class.go:234), as the JAX
        package's: the `storageclass` config ("EC:N"), stamped on the set
        as sc_parity by the server, overrides per class, clamped to
        drives/2 (reference validateParity: beyond it a sub-majority write
        could claim quorum); otherwise STANDARD uses the set's parity and
        REDUCED_REDUNDANCY two below it (at least 1)."""
        sc_map = getattr(self, "sc_parity", None) or {}
        if sc == "REDUCED_REDUNDANCY":
            m = sc_map.get("RRS")
            if m is not None:
                return max(0, min(int(m), self.n // 2))
            return max(1, self.parity - 2) if self.n >= 4 else self.parity
        m = sc_map.get("STANDARD")
        if m is not None:
            return max(0, min(int(m), self.n // 2))
        return self.parity

    def _write_quorum_meta(self) -> int:
        return self.n // 2 + 1

    def _write_quorum_data(self, parity: int) -> int:
        """k drives, +1 when k == m so two conflicting half-writes can't both
        claim quorum (cmd/erasure-object.go:639-642)."""
        k = self.n - parity
        return k + (1 if k == parity else 0)

    # ------------------------------------------------------------------
    # buckets
    # ------------------------------------------------------------------

    def make_bucket(self, bucket: str) -> None:
        _validate_bucket_name(bucket)
        results = parallel_map([lambda d=d: d.make_vol(bucket) for d in self.drives],
                               deadline=self._meta_deadline())
        if sum(isinstance(r, se.VolumeExists) for r in results) \
                >= self._write_quorum_meta():
            raise se.BucketExists(bucket)
        results = [None if isinstance(r, se.VolumeExists) else r for r in results]
        reduce_write_quorum(results, self._write_quorum_meta(), bucket)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        results = parallel_map([lambda d=d: d.stat_vol(bucket) for d in self.drives],
                               deadline=self._meta_deadline())
        for r in results:
            if not isinstance(r, Exception):
                return BucketInfo(r.name, r.created)
        if any(isinstance(r, se.VolumeNotFound) for r in results):
            raise se.BucketNotFound(bucket)
        raise se.BucketNotFound(bucket, "", "no drive answered")

    def list_buckets(self) -> list[BucketInfo]:
        results = parallel_map([lambda d=d: d.list_vols() for d in self.drives],
                               deadline=self._meta_deadline())
        seen: dict[str, BucketInfo] = {}
        for r in results:
            if isinstance(r, Exception):
                continue
            for v in r:
                if v.name not in seen:
                    seen[v.name] = BucketInfo(v.name, v.created)
        return sorted(seen.values(), key=lambda b: b.name)

    def delete_bucket(self, bucket: str) -> None:
        tier = hottier.maybe_tier(self.device)
        if tier is not None:
            tier.invalidate_bucket(bucket)
        results = parallel_map([lambda d=d: d.delete_vol(bucket) for d in self.drives],
                               deadline=self._meta_deadline())
        if any(isinstance(r, se.VolumeNotEmpty) for r in results):
            raise se.BucketNotEmpty(bucket)
        if all(isinstance(r, se.VolumeNotFound) for r in results):
            raise se.BucketNotFound(bucket)
        reduce_write_quorum(results, self._write_quorum_meta(), bucket)

    # ------------------------------------------------------------------
    # put (cmd/erasure-object.go:606-810)
    # ------------------------------------------------------------------

    def put_object(self, bucket: str, obj: str, data: BinaryIO, size: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        _validate_object_name(obj)
        self.get_bucket_info(bucket)
        m = self.parity_for_class(opts.user_defined.get("x-amz-storage-class", ""))
        k = self.n - m
        write_quorum = self._write_quorum_data(m)

        fi = FileInfo.new(bucket, obj)
        if opts.versioned:
            fi.version_id = opts.version_id or str(uuid.uuid4())
        fi.mod_time = opts.mod_time or time.time()
        fi.metadata = dict(opts.user_defined)
        dist = hash_order(f"{bucket}/{obj}", self.n)
        fi.erasure = ErasureInfo(
            data_blocks=k, parity_blocks=m, block_size=self.block_size,
            distribution=dist,
            checksums=[ChecksumInfo(1, self.bitrot_algorithm)])
        codec = ErasureCodec(k, m, self.block_size, device=self.device)
        shuffled = shuffle_by_distribution(self.drives, dist)

        first_block = _read_full(
            data, min(self.block_size, size) if size >= 0 else self.block_size)
        # Timeline: the body up to the first block boundary (a small
        # object's whole body) is the rx_drain stage.
        flight.mark("rx_drain")
        if len(first_block) <= INLINE_DATA_LIMIT and (
                size < 0 and len(first_block) < self.block_size
                or 0 <= size <= INLINE_DATA_LIMIT):
            if 0 <= size != len(first_block):
                raise se.IncompleteBody(
                    bucket, obj, f"got {len(first_block)} of {size} bytes")
            fi.size = len(first_block)
            fi.inline_data = first_block
            fi.data_dir = ""
            fi.metadata.setdefault("etag", hashlib.md5(first_block).hexdigest())
            fi.parts = [PartInfo(1, fi.size, fi.size, fi.mod_time)]
            # No shard files: the shard index means nothing, and index 0 on
            # every drive makes all journals byte-identical (as in the JAX
            # package's single-journal inline commit).
            fi.erasure.index = 0
            journal = XLMeta()
            journal.add_version(fi)
            raw = journal.serialize()
            with self.nslock.lock(bucket, obj) as lease, \
                    obs.span("commit", bucket=bucket, object=obj, inline=True):
                self._check_put_precondition(bucket, obj, opts)
                # Each drive parks what the commit displaces and returns
                # its token, as rename_data does.
                outcomes = None
                if self._setcache is not None:
                    outcomes = self._inline_commit_fast(shuffled, bucket, obj,
                                                        fi, raw, journal)
                if outcomes is None:
                    outcomes = parallel_map(
                        [lambda d=d: d.write_metadata_single(
                            bucket, obj, fi, raw, defer_reclaim=True)
                         for d in shuffled],
                        deadline=self._meta_deadline())
                self._settle_commit(shuffled, outcomes, write_quorum,
                                    bucket, obj, fi, lease)
                if self._setcache is not None:
                    # Write-through: the committed journal is what an
                    # election would return (index 0 on every drive).
                    self._setcache.populate(bucket, obj, "", fi, shuffled)
            flight.mark("commit", "metaplane")
            self._queue_partial(bucket, obj, fi, outcomes)
            return listing.fi_to_object_info(bucket, obj, fi)

        tmp_rel = f"tmp/{uuid.uuid4().hex}"

        def cleanup_tmp():
            parallel_map([lambda d=d: d.delete(SYS_VOL, tmp_rel, recursive=True)
                          for d in shuffled],
                         deadline=self._meta_deadline())

        try:
            with obs.span("encode", bucket=bucket, object=obj) as sp:
                total, md5_hex, errs = self._fan_out_encode(
                    shuffled, f"{tmp_rel}/part.1", data, size, codec,
                    write_quorum, bucket, obj, first_block)
                sp.set(bytes=total)
            flight.mark("encode", "dataplane")
        except (se.StorageError, se.ObjectError):
            cleanup_tmp()
            raise
        if size >= 0 and total != size:
            cleanup_tmp()
            raise se.IncompleteBody(bucket, obj, f"got {total} of {size} bytes")
        fi.size = total
        fi.metadata.setdefault("etag", md5_hex)
        fi.parts = [PartInfo(1, total, total, fi.mod_time)]

        def commit(i: int, drive: StorageAPI) -> str | None:
            if errs[i] is not None:
                raise errs[i]
            return drive.rename_data(SYS_VOL, tmp_rel, _clone_for_drive(fi, i + 1),
                                     bucket, obj, defer_reclaim=True)

        with self.nslock.lock(bucket, obj) as lease, \
                obs.span("commit", bucket=bucket, object=obj):
            try:
                self._check_put_precondition(bucket, obj, opts)
            except se.ObjectError:
                cleanup_tmp()
                raise
            outcomes = parallel_map([lambda i=i, d=d: commit(i, d)
                                     for i, d in enumerate(shuffled)],
                                    deadline=self._meta_deadline())
            try:
                self._settle_commit(shuffled, outcomes, write_quorum,
                                    bucket, obj, fi, lease)
            except Exception:
                cleanup_tmp()
                raise
        flight.mark("commit", "metaplane")
        self._queue_partial(bucket, obj, fi, outcomes)
        return listing.fi_to_object_info(bucket, obj, fi)

    def _settle_commit(self, shuffled, outcomes, write_quorum: int,
                       bucket: str, obj: str, fi: FileInfo, lease=None) -> None:
        """After a deferred-reclaim commit fan-out (outcomes: a reclaim
        token or None per drive that committed, an exception per drive
        that did not), in the reference's order
        (minio_tpu/erasure/objects.py:484-505, 580-620): below write
        quorum, every drive that committed drops the new version and gets
        back what it displaced (undo_rename), so an overwrite that fails
        keeps the previous object; at quorum, the displaced state goes for
        good (commit_rename). Either way the key's hot-tier residence is
        dropped. A dsync `lease` that lost its refresh quorum during the
        commit rolls it back too (minio_tpu/erasure/objects.py:515,630):
        a writer on the other side of a partition may have committed."""
        self._meta_invalidate(bucket, obj)

        def undo():
            undo_fi = FileInfo(volume=bucket, name=obj, version_id=fi.version_id,
                               data_dir=fi.data_dir)
            parallel_map([lambda d=d, t=t: d.undo_rename(bucket, obj, undo_fi, t)
                          for d, t in zip(shuffled, outcomes)
                          if not isinstance(t, Exception)],
                         deadline=self._meta_deadline())

        try:
            reduce_write_quorum(outcomes, write_quorum, bucket, obj)
        except Exception:
            undo()
            raise
        if lease is not None and not lease.held:
            undo()
            raise se.OperationTimedOut(
                bucket, obj, "dsync lock quorum lost during commit; write rolled back")
        parallel_map([lambda d=d, t=t: d.commit_rename(t)
                      for d, t in zip(shuffled, outcomes)
                      if t and not isinstance(t, Exception)],
                     deadline=self._meta_deadline())

    def _inline_commit_fast(self, shuffled, bucket: str, obj: str,
                            fi: FileInfo, raw: bytes, journal: XLMeta):
        """The inline commit in two phases through the group-commit plane:
        submit the journal to every drive's WAL (journal_commit_async,
        through the drives' wrappers), then wait for every shared-fsync
        future under the meta deadline. Outcomes are the synchronous fan-
        out's: a reclaim token or an exception per drive. The submits are
        pure memory on a bare armed drive and run inline; when a wrapper
        may block them they run under run_bounded, and a wedged loop
        falls back to the synchronous fan-out (a repeated store of the
        same bytes is idempotent). None when a drive is not armed or has no
        two-phase entry."""
        from concurrent.futures import TimeoutError as FutureTimeout

        from minio_tpu_torch.erasure.metadata import run_bounded
        from minio_tpu_torch.erasure.sysstore import submits_may_block

        # A drive without the two-phase entry (a remote drive: the
        # storage plane has no such route) takes the synchronous fan-out,
        # as in the JAX package (minio_tpu/erasure/objects.py:2040-2047).
        fns = [getattr(d, "journal_commit_async", None) for d in shuffled]
        if any(fn is None for fn in fns):
            return None
        futs: list = []

        def submit_all():
            for fn in fns:
                try:
                    f = fn(bucket, obj, fi, raw, meta=journal, defer_reclaim=True)
                except Exception as e:  # noqa: BLE001 - per-drive outcome
                    futs.append(e)
                    continue
                if f is None:
                    futs.append(None)   # not armed: the synchronous fan-out
                    return
                futs.append(f)

        if submits_may_block(shuffled):
            if not run_bounded(submit_all, self._meta_deadline()):
                return None
        else:
            submit_all()
        if any(f is None for f in futs):
            return None
        end = time.monotonic() + self._meta_deadline()
        outcomes: list = []
        for f in futs:
            if isinstance(f, Exception):
                outcomes.append(f)
                continue
            try:
                outcomes.append(f.result(timeout=max(0.0, end - time.monotonic())))
            except FutureTimeout:
                outcomes.append(se.OperationTimedOut(
                    bucket, obj, "wal group commit exceeded deadline"))
            except Exception as e:  # noqa: BLE001 - per-drive outcome
                outcomes.append(e)
        return outcomes

    def _fan_out_encode(self, shuffled: list[StorageAPI], rel: str,
                        data: BinaryIO, size: int, codec: ErasureCodec,
                        write_quorum: int, bucket: str, obj: str,
                        initial: bytes) -> tuple[int, str, list]:
        """Stream `data` through the batched codec, fanning [digest][chunk]
        records to one create_file per drive (the io.Pipe + goroutine
        fan-out of cmd/erasure-encode.go:36-70, collapsed into queues).
        Up to three batches are in flight on the device while the host
        reads the next batch and feeds the drives the finished ones.
        Returns (bytes consumed, md5 hex, per-drive errors)."""
        qs = [queue.Queue(maxsize=8) for _ in range(self.n)]
        errs: list = [None] * self.n
        # A writer stuck in a hung create_file stops draining its queue:
        # once the queue stays full past the data deadline the drive is
        # timed out and fed no more, and the PUT completes at quorum (the
        # hung daemon thread is accounted as leaked).
        gave_up = [False] * self.n
        put_timeout = self._data_deadline()

        def feed(i: int, item) -> None:
            if gave_up[i]:
                return
            try:
                qs[i].put(item, timeout=put_timeout)
            except queue.Full:
                gave_up[i] = True
                if errs[i] is None:
                    errs[i] = se.OperationTimedOut(
                        msg=f"drive shard write stalled > {put_timeout:.1f}s")
                note_leaked_worker()
        # mxsum256 and mxhash256 digests come from the codec launch (K2 or
        # K3 after K1); a host algorithm hashes each chunk on its drive's
        # writer thread, the n drives side by side.
        algo = self.bitrot_algorithm
        device_algo = algo if algo in bitrot.DEVICE_ALGORITHMS else None
        host = bitrot.get_algorithm(algo)

        def writer(i: int, drive: StorageAPI):
            try:
                drive.create_file(SYS_VOL, rel, bitrot.frame_records(
                    iter(qs[i].get, _WRITE_SENTINEL), host))
            except Exception as e:  # noqa: BLE001 - per-drive failure is data
                errs[i] = e
                while qs[i].get() is not _WRITE_SENTINEL:
                    pass   # drain so the producer never blocks on a dead drive

        # ctx_wrap: each drive's records carry the request's trace id.
        threads = [threading.Thread(target=obs.ctx_wrap(writer), args=(i, d),
                                    daemon=True, name=f"shard-writer-{i}")
                   for i, d in enumerate(shuffled)]
        for t in threads:
            t.start()

        # Batched data plane: concurrent PUTs coalesce their encode
        # launches; blocks above its width gate take the per-object codec.
        # A full plane sheds the PUT as 503 SlowDown, as in the JAX package.
        # Its encode lanes compute mxsum256 digests or none, so mxhash256
        # PUTs take the per-object codec.
        plane = (dataplane.maybe_plane(self.device)
                 if codec.m and algo != "mxhash256" else None)

        def begin_encode(blocks: list[bytes]):
            if plane is not None and plane.accepts_chunk(
                    -(-max(len(b) for b in blocks) // codec.k)):
                return plane.begin_encode(codec.k, codec.m, codec.block_size,
                                          blocks,
                                          with_digests=algo == "mxsum256")
            return codec.begin_encode(blocks, device_algo)

        md5 = hashlib.md5()
        total = 0
        pending: list = []
        t_enc = time.perf_counter()

        def drain_one() -> None:
            chunk_rows, dig_rows = pending.pop(0).wait()
            for bi, chunks in enumerate(chunk_rows):
                for i in range(self.n):
                    # A None digest: the writer thread hashes the chunk.
                    feed(i, (dig_rows[bi][i] if dig_rows is not None else None,
                             chunks[i]))
            if sum(e is None for e in errs) < write_quorum:
                raise se.InsufficientWriteQuorum(bucket, obj,
                                                 "write fan-out lost quorum")

        try:
            bs = codec.block_size
            batch: list[bytes] = []
            block = initial or _read_full(data, min(bs, size) if size >= 0 else bs)
            while block:
                md5.update(block)
                total += len(block)
                batch.append(block)
                if len(batch) >= BATCH_BLOCKS:
                    pending.append(begin_encode(batch))
                    batch = []
                    if len(pending) >= 3:
                        drain_one()
                remaining = bs if size < 0 else min(bs, size - total)
                block = _read_full(data, remaining)
            if batch:
                pending.append(begin_encode(batch))
            while pending:
                drain_one()
        finally:
            for i, q in enumerate(qs):
                try:
                    q.put(_WRITE_SENTINEL, timeout=0.1 if gave_up[i] else put_timeout)
                except queue.Full:
                    gave_up[i] = True
            # A healthy writer drains to its sentinel well inside the
            # deadline; a wedged one is timed out and left behind.
            join_end = time.monotonic() + put_timeout
            for i, t in enumerate(threads):
                t.join(timeout=0.1 if gave_up[i]
                       else max(0.1, join_end - time.monotonic()))
                if t.is_alive():
                    gave_up[i] = True
                    if errs[i] is None:
                        errs[i] = se.OperationTimedOut(
                            msg="drive shard writer did not finish")
                        note_leaked_worker()
        self._note_encode_rate(total, time.perf_counter() - t_enc)
        return total, md5.hexdigest(), errs

    def _note_encode_rate(self, nbytes: int, wall: float) -> None:
        """Rolling encode throughput: EWMA over per-fan-out bytes/wall."""
        if nbytes <= 0 or wall <= 0.0:
            return
        gibps = nbytes / wall / (1 << 30)
        e = self._encode_gibps
        self._encode_gibps = gibps if e is None else 0.7 * e + 0.3 * gibps
        _ENCODE_GIBPS.set(self._encode_gibps)

    # ------------------------------------------------------------------
    # get (cmd/erasure-object.go:137-358)
    # ------------------------------------------------------------------

    def _read_quorum_fileinfo(self, bucket: str, obj: str,
                              version_id: str = "") -> FileInfo:
        sc = self._setcache
        pre_sigs = None
        if sc is not None:
            fi = sc.lookup(bucket, obj, version_id)
            if fi is not None:
                return fi   # signatures unchanged: no fan-out, no election
            # Taken before the election: a mutation racing the fan-out
            # leaves them stale, so the entry misses at the next lookup.
            pre_sigs = sc.snapshot_sigs(bucket, obj, self.drives)
        fi = self._elect_fileinfo(bucket, obj, version_id)
        if sc is not None:
            sc.populate(bucket, obj, version_id, fi, self.drives, sigs=pre_sigs)
        return fi

    def _elect_fileinfo(self, bucket: str, obj: str, version_id: str) -> FileInfo:
        with obs.span("quorum-read", bucket=bucket, object=obj):
            results = parallel_map([lambda d=d: d.read_version(bucket, obj, version_id)
                                    for d in self.drives],
                                   deadline=self._meta_deadline())
        if all(isinstance(r, se.FileNotFound) for r in results):
            self.get_bucket_info(bucket)   # a missing bucket answers as such
            raise se.ObjectNotFound(bucket, obj)
        if any(isinstance(r, se.FileVersionNotFound) for r in results) and not any(
                isinstance(r, FileInfo) for r in results):
            raise se.VersionNotFound(bucket, obj)
        ks = [r.erasure.data_blocks for r in results
              if isinstance(r, FileInfo) and not r.deleted and r.erasure.data_blocks]
        read_quorum = max(set(ks), key=ks.count) if ks else self.n // 2
        return find_fileinfo_in_quorum(results, max(1, read_quorum), bucket, obj)

    def latest_fileinfo(self, bucket: str, obj: str,
                        version_id: str = "") -> FileInfo:
        """The quorum-elected FileInfo, delete markers included: the
        existence probe of pool routing."""
        return self._read_quorum_fileinfo(bucket, obj, version_id)

    def _fi_to_object_info(self, bucket: str, obj: str, fi: FileInfo) -> ObjectInfo:
        return listing.fi_to_object_info(bucket, obj, fi)

    def get_object_info(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        """The version's info; a delete marker named by its id answers
        with its own info (delete_marker set), as in the JAX package."""
        opts = opts or ObjectOptions()
        fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
        if fi.deleted and not opts.version_id:
            raise se.ObjectIsDeleteMarker(bucket, obj, fi.version_id)
        return listing.fi_to_object_info(bucket, obj, fi)

    def get_object_reader(self, bucket: str, obj: str,
                          opts: ObjectOptions | None = None):
        """ONE quorum metadata read for info + data: returns (info,
        open_range), where open_range(offset, length) streams the object's
        bytes from the already-elected version (the HTTP layer needs the
        size before it can resolve a Range)."""
        opts = opts or ObjectOptions()
        fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
        # Timeline: the quorum metadata election (decode and transfer land
        # in the trailing resp_drain stage).
        flight.mark("meta_elect", "metaplane")
        if fi.deleted:
            raise se.ObjectIsDeleteMarker(bucket, obj, fi.version_id,
                                          named=bool(opts.version_id))
        # The hot tier holds latest versions only: a read that names a
        # version never consults it (minio_tpu/erasure/objects.py:735).
        pinned = bool(opts.version_id)

        def open_range(offset: int = 0, length: int = -1) -> Iterator[bytes]:
            return self._open_fi_range(bucket, obj, fi, offset, length, pinned)

        return listing.fi_to_object_info(bucket, obj, fi), open_range

    def _open_fi_range(self, bucket: str, obj: str, fi: FileInfo,
                       offset: int, length: int,
                       pinned: bool = False) -> Iterator[bytes]:
        if length < 0:
            length = fi.size - offset
        if offset < 0 or length < 0 or offset + length > fi.size:
            raise se.InvalidRange(bucket, obj,
                                  f"[{offset}, {offset + length}) of {fi.size}")
        if fi.inline_data:
            return iter([fi.inline_data[offset:offset + length]])
        tier_name = fi.metadata.get(TRANSITION_TIER_KEY, "") if fi.metadata else ""
        if tier_name and not fi.data_dir:
            from minio_tpu_torch.scanner import tiers

            # A transitioned version (minio_tpu/erasure/objects.py:754-770):
            # its stored bytes stream from the tier, ahead of the hot tier
            # and the erasure stream, so no kernel runs. The parts survive
            # in the stub, so multipart SSE decrypts as from the drives. A
            # tier that cannot serve answers ObjectNotFound, not a 500.
            reg = tiers.global_registry()
            try:
                if reg is None:
                    raise tiers.TierError("no tier registry configured")
                return reg.get(tier_name).get(
                    fi.metadata.get(tiers.TRANSITION_KEY, ""), offset, length)
            except tiers.TierError as e:
                raise se.ObjectNotFound(bucket, obj, f"tier {tier_name!r}: {e}") from e
        hot = hottier.maybe_tier(self.device)
        if hot is not None and pinned:
            # Latest-only tier: a read that names a version bypasses it.
            _CACHE_BYPASS.labels(reason="hottier_versioned").inc()
        elif hot is not None:
            served = hot.serve(bucket, obj, fi, offset, length)
            if served is not None:
                # Device-resident hit: one digest launch and one download,
                # no drive opened.
                return served
            hot.note_miss(bucket, obj, fi.size,
                          reader=lambda b=bucket, o=obj: self.get_object(b, o),
                          grid=(fi.erasure.data_blocks, fi.erasure.block_size))
        return self._stream_erasure(bucket, obj, fi, offset, length)

    def get_object(self, bucket: str, obj: str, offset: int = 0, length: int = -1,
                   opts: ObjectOptions | None = None
                   ) -> tuple[ObjectInfo, Iterator[bytes]]:
        """(info, iterator over [offset, offset+length) of the object)."""
        info, open_range = self.get_object_reader(bucket, obj, opts)
        return info, open_range(offset, length)

    def _stream_erasure(self, bucket: str, obj: str, fi: FileInfo,
                        offset: int, length: int) -> Iterator[bytes]:
        part_off = 0
        for part in fi.parts:
            part_end = part_off + part.size
            if part_end > offset and part_off < offset + length:
                lo = max(offset, part_off) - part_off
                hi = min(offset + length, part_end) - part_off
                yield from self._stream_one_part(bucket, obj, fi, part, lo, hi - lo)
            part_off = part_end

    def _stream_one_part(self, bucket: str, obj: str, fi: FileInfo, part,
                         offset: int, length: int) -> Iterator[bytes]:
        if length <= 0:
            return
        k = fi.erasure.data_blocks
        n = k + fi.erasure.parity_blocks
        bs = fi.erasure.block_size
        codec = ErasureCodec(k, fi.erasure.parity_blocks, bs, device=self.device)
        algo = next((c.algorithm for c in fi.erasure.checksums), self.bitrot_algorithm)
        shuffled = shuffle_by_distribution(self.drives, fi.erasure.distribution)
        rel = f"{obj}/{fi.data_dir}/part.{part.number}"
        shard_data_size = codec.shard_file_size(part.size)
        readers: list = [None] * n

        def open_reader(i: int) -> bitrot.BitrotReader:
            f = shuffled[i].read_file_stream(bucket, rel)
            return bitrot.BitrotReader(f, shard_data_size, codec.shard_size(), algo)

        # Drives known dead (health OFFLINE) start excluded, so selection
        # goes straight to reconstruction. Hedge losers are benched:
        # healthy but slow, never heal-triggering, and taken back when
        # selection runs short.
        dead: set[int] = {i for i, d in enumerate(shuffled) if not d.is_online()}
        corrupt: set[int] = set()   # the shards of `dead` that showed bitrot
        benched: set[int] = set()
        pool = self._shard_read_pool()

        def read_batch(ids: list[int], lens: list[int]):
            while True:
                # Data shards first, parity only on demand (the staggered
                # any-k read, cmd/erasure-decode.go:120-188).
                chosen = [i for i in range(n) if i not in dead and i not in benched][:k]
                if len(chosen) < k and benched:
                    benched.clear()   # slow beats no quorum
                    chosen = [i for i in range(n) if i not in dead][:k]
                if len(chosen) < k:
                    raise se.InsufficientReadQuorum(bucket, obj, "not enough live shards")
                try:
                    return self._read_chunk_rows(open_reader, readers, chosen, ids, lens,
                                                 codec, n, dead, algo, corrupt, pool,
                                                 benched)
                except se.StorageError:
                    continue   # a shard died: re-choose and retry the batch

        def emit(ids: list[int], lens: list[int], rows) -> Iterator[bytes]:
            decoded = self._decode_rows(codec, rows, lens)
            for j, b in enumerate(ids):
                blk_start = b * bs
                lo = max(offset, blk_start) - blk_start
                hi = min(offset + length, blk_start + lens[j]) - blk_start
                if hi > lo:
                    yield from _yield_block_range(decoded[j], lo, hi)

        batches = []
        bi, last_block = offset // bs, (offset + length - 1) // bs
        while bi <= last_block:
            ids = list(range(bi, min(bi + BATCH_BLOCKS, last_block + 1)))
            batches.append((ids, [min(bs, part.size - b * bs) for b in ids]))
            bi = ids[-1] + 1

        def close_readers() -> None:
            for r in readers:
                if r is not None:
                    r.src.close()

        def heal_if_degraded() -> None:
            # The read went around a dead or corrupt shard: heal it in the
            # background (reference cmd/erasure-object.go:321-344).
            if dead and self.mrf is not None:
                self.mrf.add_partial(bucket, obj, fi.version_id, deep=bool(corrupt))

        if len(batches) == 1:
            # One batch (a small or ranged GET): nothing to overlap.
            try:
                ids, lens = batches[0]
                yield from emit(ids, lens, read_batch(ids, lens))
            finally:
                close_readers()
                heal_if_degraded()
            return

        # Read-ahead: one producer thread reads batch N+1 while this
        # generator verifies, decodes and sends batch N. Only the producer
        # touches readers, dead and the re-selection; the bounded queue and
        # stop-checked puts end it promptly when the consumer closes early.
        out_q: queue.Queue = queue.Queue(maxsize=2)
        stop = threading.Event()
        cleanup_mu = threading.Lock()
        cleaned = [False]

        def offer(item) -> bool:
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def close_once() -> None:
            # From the consumer's finally, or from the producer's exit when
            # the consumer gave up waiting on a hung read.
            with cleanup_mu:
                if cleaned[0]:
                    return
                cleaned[0] = True
            close_readers()

        def producer() -> None:
            try:
                for ids, lens in batches:
                    if stop.is_set():
                        return
                    rows = read_batch(ids, lens)
                    if not offer(("rows", ids, lens, rows)):
                        return
                offer(("done", None, None, None))
            except BaseException as e:  # noqa: BLE001 - relayed to the consumer
                offer(("err", e, None, None))
            finally:
                if stop.is_set():
                    close_once()

        prod = threading.Thread(target=obs.ctx_wrap(producer), daemon=True,
                                name="shard-readahead")
        prod.start()
        try:
            while True:
                tag, ids, lens, rows = out_q.get()
                if tag == "done":
                    break
                if tag == "err":
                    raise ids
                yield from emit(ids, lens, rows)
        finally:
            # Runs at the end and at an early close: stop and join the
            # producer before closing the readers it owns.
            stop.set()
            while True:
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            prod.join(timeout=5.0)
            if not prod.is_alive():
                close_once()
            heal_if_degraded()

    def _hedge_delay(self) -> float | None:
        """Seconds to wait on a straggling shard before a spare reader
        starts on an unused parity shard: pinned by self.hedge_delay, else
        four times the rolling shard-read latency (at least 20 ms); None
        without history (the data deadline then decides)."""
        if self.hedge_delay is not None:
            return self.hedge_delay
        e = self._shard_lat
        return None if e is None else max(4.0 * e, 0.02)

    def _note_shard_latency(self, dur: float) -> None:
        e = self._shard_lat
        self._shard_lat = dur if e is None else 0.8 * e + 0.2 * dur

    def _abandon_shard(self, i: int, fut, readers, dead, benched, failed: bool) -> None:
        """A straggler lost the hedge (benched, failed=False) or hit the
        data deadline (dead): its reader is closed when its read returns,
        and the pool worker it holds is lent back until then."""
        (dead if failed else benched).add(i)
        rdr = readers[i]
        readers[i] = None

        def cleanup(_f, rdr=rdr):
            if rdr is not None:
                rdr.src.close()

        if fut.cancel():
            cleanup(None)
            return
        note_leaked_worker(self._read_pool, fut)
        fut.add_done_callback(cleanup)

    def _read_chunk_rows(self, open_reader, readers, chosen, batch_ids, block_lens,
                         codec: ErasureCodec, n: int, dead: set, algo: str,
                         corrupt: set, pool, benched: set):
        """Read one batch of chunk rows from the chosen shards, one pool
        worker per shard, first-k-wins: after the hedge delay a spare
        reader starts on an unused shard for each straggler, and the batch
        completes with the first k results; stragglers still out then, or
        at the data deadline, are abandoned, never awaited. Then every
        mxsum256 or mxhash256 chunk read is verified in ONE digest launch
        (K2 or K3; the read path's verify-every-ReadAt,
        cmd/bitrot-streaming.go:115-158); a host algorithm verifies each
        chunk on its shard's reader. A failed or corrupt shard is marked
        dead (and, for bitrot, corrupt) and StorageError raised, so the
        caller re-selects."""
        from concurrent.futures import FIRST_COMPLETED, CancelledError
        from concurrent.futures import wait as futures_wait

        chunk_lens = [-(-bl // codec.k) for bl in block_lens]
        batched = algo in bitrot.DEVICE_ALGORITHMS
        shard_errors = (se.StorageError, OSError, CancelledError, RuntimeError)

        def read_shard(i: int) -> list:
            r = readers[i]
            if r is None:
                r = open_reader(i)
                if i in dead or i in benched:
                    r.src.close()   # abandoned while opening: publish nothing
                    raise se.FaultyDisk(f"shard {i}: abandoned")
                readers[i] = r
            out = []
            for j, b in enumerate(batch_ids):
                if batched:
                    want, chunk = r.read_record(b)
                else:
                    want, chunk = None, r.read_verified(b)
                if len(chunk) != chunk_lens[j]:
                    raise se.FileCorrupt(f"chunk {b} length {len(chunk)}")
                out.append((want, chunk))
            return out

        results: dict[int, list] = {}
        first_err: tuple[int, Exception] | None = None

        def record_failure(i: int, e: Exception) -> None:
            nonlocal first_err
            dead.add(i)
            if isinstance(e, se.FileCorrupt):
                corrupt.add(i)
            readers[i] = None
            if first_err is None:
                first_err = (i, e)

        futures: dict = {}
        rev: dict = {}
        started: dict[int, float] = {}

        def submit(i: int) -> bool:
            try:
                f = pool.submit(obs.ctx_wrap(read_shard), i)
            except RuntimeError:
                return False   # the set is closing
            futures[i] = f
            rev[f] = i
            started[i] = time.monotonic()
            return True

        if not all(submit(i) for i in chosen):
            # Closing mid-submit: the running reads share the readers'
            # seek state, so wait them out and fail the batch cleanly.
            for f in futures.values():
                f.cancel()
            futures_wait(list(futures.values()))
            for i in chosen:
                dead.add(i)
                readers[i] = None
            raise se.FileCorrupt("layer closing")

        need = len(chosen)
        t0 = time.monotonic()
        end = t0 + self._data_deadline()
        hd = self._hedge_delay()
        hedge_at = t0 + hd if hd is not None else None
        hedged: set[int] = set()
        pending = set(futures)
        while pending and len(results) < need:
            now = time.monotonic()
            if now >= end:
                break
            timeout = end - now
            if hedge_at is not None:
                timeout = min(timeout, max(0.0, hedge_at - now))
            done, _ = futures_wait({futures[i] for i in pending}, timeout=timeout,
                                   return_when=FIRST_COMPLETED)
            for f in done:
                i = rev[f]
                pending.discard(i)
                try:
                    results[i] = f.result()
                    self._note_shard_latency(time.monotonic() - started[i])
                    if (i in hedged and len(results) <= need
                            and any(j not in hedged for j in pending)):
                        _HEDGED_WINS.inc()
                except shard_errors as e:
                    record_failure(i, e)
            if (len(results) < need and pending and hedge_at is not None
                    and time.monotonic() >= hedge_at):
                # One spare per straggler, in parity order, never a shard
                # already dead, benched or in play.
                hedge_at = None
                spares = [s for s in range(n)
                          if s not in dead and s not in futures and s not in benched]
                for sp in spares[:len(pending)]:
                    if submit(sp):
                        pending.add(sp)
                        hedged.add(sp)
                        _HEDGED_READS.inc()
        # Leftovers: take the ones already done, abandon the rest.
        deadline_hit = len(results) < need
        for i in list(pending):
            f = futures[i]
            if f.done():
                try:
                    results[i] = f.result()
                except shard_errors as e:
                    record_failure(i, e)
                continue
            self._abandon_shard(i, f, readers, dead, benched, failed=deadline_hit)
            if deadline_hit and first_err is None:
                first_err = (i, se.OperationTimedOut(
                    msg="shard read exceeded the data deadline"))
        if len(results) < need:
            i, e = first_err if first_err is not None else (
                -1, se.FaultyDisk("no shard results"))
            raise se.FileCorrupt(f"shard {i}: {e}") from e

        rows = [[None] * n for _ in batch_ids]
        records = []
        for i in sorted(results):
            for j, (want, chunk) in enumerate(results[i]):
                rows[j][i] = chunk
                if batched:
                    records.append((i, want, chunk))
        if records:
            got = bitrot.device_digests(algo, [c for _i, _w, c in records],
                                        codec.shard_size(), self.device)
            for (i, want, _c), g in zip(records, got):
                if g != want:
                    corrupt.add(i)
                    _retire(readers, dead, i)
                    raise se.FileCorrupt(f"shard {i}: bitrot digest mismatch")
        return rows

    def _decode_rows(self, codec: ErasureCodec, rows, lens):
        """GET-path reconstruction: through the batched plane when it is on
        (concurrent GETs with different failure patterns share one launch:
        per-row decode matrices ride as data), else, or when the plane
        sheds the submit, the per-object codec."""
        plane = dataplane.maybe_plane(self.device) if codec.m else None
        if plane is not None and lens and plane.accepts_recon_chunk(
                -(-max(lens) // codec.k)):
            try:
                return plane.decode_blocks(codec.k, codec.m, rows, lens)
            except se.OperationTimedOut:
                pass  # plane saturated: per-object dispatch still serves
        return codec.decode_blocks(rows, lens)

    # ------------------------------------------------------------------
    # delete (cmd/erasure-object.go:894-1031)
    # ------------------------------------------------------------------

    def delete_object(self, bucket: str, obj: str,
                      opts: ObjectOptions | None = None) -> ObjectInfo:
        """Remove one version (the null version without an id), or, on a
        versioned bucket without an id, add a delete marker: the versions
        stay, and a GET without an id answers 404 (:1507-1545)."""
        opts = opts or ObjectOptions()
        self.get_bucket_info(bucket)
        if opts.versioned and not opts.version_id:
            marker = FileInfo(volume=bucket, name=obj, version_id=str(uuid.uuid4()),
                              deleted=True, mod_time=time.time())
            with self.nslock.lock(bucket, obj):
                results = parallel_map([lambda d=d: d.delete_version(bucket, obj, marker)
                                        for d in self.drives],
                                       deadline=self._meta_deadline())
                self._meta_invalidate(bucket, obj)
                reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)
            return ObjectInfo(bucket=bucket, name=obj, version_id=marker.version_id,
                              delete_marker=True, mod_time=marker.mod_time)
        with self.nslock.lock(bucket, obj):
            fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
            target = FileInfo(volume=bucket, name=obj, version_id=opts.version_id,
                              data_dir=fi.data_dir)
            results = parallel_map([lambda d=d: d.delete_version(bucket, obj, target)
                                    for d in self.drives],
                                   deadline=self._meta_deadline())
            self._meta_invalidate(bucket, obj)
            # A drive that never had the version is as good as deleted on it.
            results = [None if isinstance(r, (se.FileNotFound, se.FileVersionNotFound))
                       else r for r in results]
            reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)
        return ObjectInfo(bucket=bucket, name=obj, version_id=opts.version_id,
                          delete_marker=fi.deleted)

    def delete_objects(self, bucket: str, objects: list[ObjectToDelete],
                       opts: ObjectOptions | None = None
                       ) -> list[DeletedObject | Exception]:
        return listing.bulk_delete(self.delete_object, bucket, objects, opts)

    # ------------------------------------------------------------------
    # listing (streamed k-way merge; the metacache sits on top, in pools)
    # ------------------------------------------------------------------

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000) -> ListObjectsInfo:
        self.get_bucket_info(bucket)
        # Marker pushdown (subtree pruning, group-aware delimiter walks) is
        # the one policy every layer shares; paginate re-filters either way.
        return listing.paginate_objects(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter),
            lambda name, fi: listing.fi_to_object_info(bucket, name, fi),
            prefix, marker, delimiter, max_keys)

    def list_object_versions(self, bucket: str, prefix: str = "", marker: str = "",
                             version_marker: str = "", delimiter: str = "",
                             max_keys: int = 1000) -> ListObjectVersionsInfo:
        """ListObjectVersions over the same streamed merge: every version
        and delete marker of each name, newest first (:1570-1580)."""
        self.get_bucket_info(bucket)
        return listing.paginate_versions(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter, version_marker),
            lambda name, fi: listing.fi_to_object_info(bucket, name, fi),
            prefix, marker, version_marker, delimiter, max_keys)

    def stream_journals(self, bucket: str, prefix: str = "",
                        start_after: str = "") -> Iterator[tuple[str, XLMeta]]:
        """SORTED (name, elected journal) stream: the drives' sorted
        walk_dir streams k-way merged, newest journal winning, in
        O(drives) memory whatever the namespace (the reference's metacache
        listPath walk, cmd/metacache-set.go:534, metacache-entries.go:198).
        Names at or before start_after are skipped without reading their
        journals; each drive's walk runs behind a prefetch thread (the
        reference's per-drive WalkDir goroutines), the walk's threads
        reading in turns (listing.WalkBaton). Journals are parsed in the
        merge, once per distinct copy (listing.elect_journal_streams)."""
        def drive_stream(d: StorageAPI):
            try:
                # start_after pushes down into the walk (subtree pruning);
                # the re-check covers a drive that only best-efforts it.
                for e in d.walk_dir(bucket, prefix, start_after):
                    if not start_after or e.name > start_after:
                        yield e.name, e.meta
            except se.StorageError:
                return   # offline or unformatted drive: quorum covers it

        # A drive that stalls mid-walk past the walk deadline drops out of
        # the merge, as an offline drive would, instead of wedging the
        # listing; the other producers wait a quarter of that for its
        # turn, once.
        walk_deadline = self._walk_deadline()
        baton = listing.WalkBaton(walk_deadline / 4)
        return listing.elect_journal_streams(
            [listing.prefetch_stream(drive_stream(d), deadline=walk_deadline,
                                     baton=baton)
             for d in self.drives])

    def merged_journals(self, bucket: str, prefix: str) -> dict[str, XLMeta]:
        """Materialized journal map, O(namespace) memory: only for small
        bounded uses (tests, sys buckets). Listings use stream_journals."""
        return dict(self.stream_journals(bucket, prefix))

    # ------------------------------------------------------------------
    # metadata-only updates and tags (cmd/erasure-object.go:1031,1158)
    # ------------------------------------------------------------------

    def put_object_metadata(self, bucket: str, obj: str,
                            updates: dict[str, str | None],
                            opts: ObjectOptions | None = None) -> ObjectInfo:
        """Quorum metadata-only update of one version: its journal entry is
        rewritten on every drive, its data untouched. A None value deletes
        the key. Shard indexes are assigned as the JAX package assigns
        them (:1626-1658), so the journals are byte-equal."""
        opts = opts or ObjectOptions()
        with self.nslock.lock(bucket, obj):
            fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
            if fi.deleted:
                raise se.ObjectNotFound(bucket, obj)
            for k, v in updates.items():
                if v is None:
                    fi.metadata.pop(k, None)
                else:
                    fi.metadata[k] = v
            drives = (shuffle_by_distribution(self.drives, fi.erasure.distribution)
                      if fi.erasure.distribution else self.drives)
            results = parallel_map(
                [lambda d=d, f=_clone_for_drive(fi, i + 1): d.write_metadata(bucket, obj, f)
                 for i, d in enumerate(drives)],
                deadline=self._meta_deadline())
            self._meta_invalidate(bucket, obj)
            reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)
        return listing.fi_to_object_info(bucket, obj, fi)

    def put_object_tags(self, bucket: str, obj: str, tags: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        """Tags as the url-encoded x-amz-tagging value; "" removes them."""
        return self.put_object_metadata(bucket, obj, {"x-amz-tagging": tags or None},
                                        opts)

    def get_object_tags(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> str:
        return self.get_object_info(bucket, obj, opts).user_defined.get(
            "x-amz-tagging", "")

    def delete_object_tags(self, bucket: str, obj: str,
                           opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.put_object_tags(bucket, obj, "", opts)

    # ------------------------------------------------------------------
    # ILM tiers (minio_tpu/erasure/objects.py:1660-1721)
    # ------------------------------------------------------------------

    def transition_version(self, bucket: str, obj: str, version_id: str,
                           tier_name: str, tier_key: str,
                           storage_class: str = "",
                           expect_mod_time: float | None = None) -> None:
        """Mark a version transitioned: the journal keeps size, etag and
        parts (the part layout drives multipart-SSE decryption on
        read-through), its data dir empties and every drive reclaims the
        shard files (write_metadata drops the orphaned data dir).
        expect_mod_time: abort if the version changed since the caller
        copied its data to the tier (the scanner's TOCTOU guard)."""
        with self.nslock.lock(bucket, obj):
            fi = self._read_quorum_fileinfo(bucket, obj, version_id)
            if fi.deleted:
                raise se.ObjectNotFound(bucket, obj)
            if fi.inline_data:
                raise se.ObjectError(bucket, obj, "inline objects are too small to tier")
            if expect_mod_time is not None and abs(fi.mod_time - expect_mod_time) > 1e-6:
                raise se.ObjectError(bucket, obj,
                                     "object changed while its data was being tiered")
            fi = fi.clone()
            fi.metadata[TRANSITION_TIER_KEY] = tier_name
            fi.metadata["x-mtpu-internal-transition-key"] = tier_key
            if storage_class:
                fi.metadata["x-amz-storage-class"] = storage_class
            fi.data_dir = ""
            drives = (shuffle_by_distribution(self.drives, fi.erasure.distribution)
                      if fi.erasure.distribution else self.drives)
            results = parallel_map(
                [lambda d=d, f=_clone_for_drive(fi, i + 1): d.write_metadata(bucket, obj, f)
                 for i, d in enumerate(drives)],
                deadline=self._meta_deadline())
            self._meta_invalidate(bucket, obj)
            reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)

    def restore_transitioned(self, bucket: str, obj: str, version_id: str = "") -> None:
        """Bring a transitioned version's data back from its tier
        (RestoreObject): the stored bytes go through the normal PUT path
        (K1 encode, K2 digests) as the same version, less the transition
        markers, and the tier copy is removed. The conditional PUT
        (expect_mod_time, checked under the commit lock) never lets stale
        tier data clobber a client write that landed meanwhile."""
        from minio_tpu_torch.scanner import tiers

        fi = self._read_quorum_fileinfo(bucket, obj, version_id)
        tier_name = fi.metadata.get(TRANSITION_TIER_KEY, "")
        if not tier_name or fi.data_dir:
            return   # nothing to restore
        if len(fi.parts) > 1 and any(k.endswith("-sse") for k in fi.metadata):
            # Multipart SSE decrypts by the original part boundaries, which
            # a one-part restore would lose; reads stream through the tier.
            raise se.ObjectError(bucket, obj, "restore of multipart SSE objects is "
                                 "not supported; reads stream through the tier")
        reg = tiers.global_registry()
        if reg is None:
            raise se.ObjectError(bucket, obj, "no tier registry configured")
        tier = reg.get(tier_name)
        key = fi.metadata.get(tiers.TRANSITION_KEY, "")
        meta = {k: v for k, v in fi.metadata.items()
                if not k.startswith("x-mtpu-internal-transition-")}
        opts = ObjectOptions(version_id=fi.version_id, versioned=bool(fi.version_id),
                             user_defined=meta, mod_time=0.0,
                             expect_mod_time=fi.mod_time)
        self.put_object(bucket, obj, IterReader(tier.get(key)), fi.size, opts)
        tier.remove(key)

    def _check_put_precondition(self, bucket: str, obj: str,
                                opts: ObjectOptions) -> None:
        """The conditional write's guard, called under the commit lock
        (minio_tpu/erasure/objects.py:2090): abort unless the latest (or
        named) version's mod_time is still opts.expect_mod_time."""
        if opts.expect_mod_time is None:
            return
        try:
            cur = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
        except (se.ObjectNotFound, se.VersionNotFound):
            raise se.ObjectError(bucket, obj,
                                 "precondition failed: object vanished") from None
        if abs(cur.mod_time - opts.expect_mod_time) > 1e-6:
            raise se.ObjectError(bucket, obj, "precondition failed: object changed")


def _retire(readers: list, dead: set, i: int) -> None:
    """Mark shard i dead for this stream and close its reader."""
    dead.add(i)
    if readers[i] is not None:
        readers[i].src.close()
        readers[i] = None


def _yield_block_range(chunks, lo: int, hi: int):
    """Yield [lo, hi) of a decoded block as memoryview slices of its k data
    chunks (no join of the block into one buffer)."""
    pos = 0
    for c in chunks:
        if pos >= hi:
            return
        end = pos + len(c)
        a, b = max(lo, pos), min(hi, end)
        if b > a:
            yield memoryview(c)[a - pos:b - pos]
        pos = end


def _clone_for_drive(fi: FileInfo, index: int) -> FileInfo:
    out = fi.clone()
    out.erasure.index = index
    return out


def _validate_bucket_name(bucket: str) -> None:
    if not (3 <= len(bucket) <= 63) or bucket != bucket.lower() or "/" in bucket:
        raise se.BucketNameInvalid(bucket)
    if bucket.startswith(".") or bucket.startswith("-") or bucket.endswith("-"):
        raise se.BucketNameInvalid(bucket)
    if not all(c.isalnum() or c in ".-" for c in bucket):
        raise se.BucketNameInvalid(bucket)


def _validate_object_name(obj: str) -> None:
    if not obj or len(obj) > 1024 or obj.startswith("/"):
        raise se.ObjectNameInvalid("", obj)
    parts = obj.split("/")
    if any(p in ("..", "") for p in parts[:-1]) or parts[-1] == "..":
        raise se.ObjectNameInvalid("", obj)
