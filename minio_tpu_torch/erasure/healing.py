"""Heal: rebuild what a set lost, one bucket, one object or a whole
namespace at a time, and the MRF queue that heals partial writes and
damaged reads in the background (counterpart of
minio_tpu/erasure/healing.py; reference cmd/erasure-healing.go:56-760 and
cmd/erasure.go:41-75).

heal_object classifies every drive of the set as ok / offline / missing /
outdated / corrupt for the elected version; the target shards of every
part are rebuilt from any k healthy shards with the decode matrix as
runtime data, and the rebuilt chunks are digested in the same codec call
under a device algorithm (begin_reconstruct(..., algorithm): kernel K1
then K2 for mxsum256 or K3 for mxhash256, one launch each per batch) or
by the target drives' writer threads under a host algorithm, framed into
fresh [digest][chunk] shard files in the tmp area and committed with
rename_data. Inline objects, delete markers and
transitioned stubs heal by rewriting the journal; an object that can never
reach read quorum again (its journal gone from more drives than its
parity) is purged as dangling. As in the JAX package, the rebuilds and the
survivor verifies ride the batched data plane when it is on, and a heal
invalidates the hot tier's residence.

heal_bucket recreates a bucket on the drives that lack it; heal_objects
walks a prefix (stream_journals) and heals each name. MRFHealer is one
daemon thread per set: a PUT or Complete that reached quorum with drives
missing, or a GET that read around a dead or corrupt shard, queues the
object, and the thread heals it, backing off while the drives it needs
are still offline. The AutoHealer (erasure/autoheal.py) rebuilds a
replaced drive through the same heal_object.
"""

from __future__ import annotations

import os
import queue
import random
import threading
import time
import uuid
from dataclasses import dataclass, field

from minio_tpu_torch import dataplane, obs
from minio_tpu_torch.erasure.codec import BATCH_BLOCKS, ErasureCodec
from minio_tpu_torch.erasure.metadata import parallel_map, shuffle_by_distribution
from minio_tpu_torch.ops import bitrot
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils import errors as se


DRIVE_STATE_OK = "ok"
DRIVE_STATE_OFFLINE = "offline"
DRIVE_STATE_MISSING = "missing"
DRIVE_STATE_CORRUPT = "corrupt"
DRIVE_STATE_OUTDATED = "outdated"

# Journal key of a version whose data moved to a remote tier (the JAX
# package's ILM transition): its local stub has no data dir to rebuild.
TRANSITION_TIER_KEY = "x-mtpu-internal-transition-tier"


@dataclass
class HealDriveState:
    endpoint: str
    state: str


@dataclass
class HealResultItem:
    """Result of one heal (reference madmin.HealResultItem)."""

    heal_type: str = "object"
    bucket: str = ""
    object: str = ""
    version_id: str = ""
    object_size: int = 0
    data_blocks: int = 0
    parity_blocks: int = 0
    disk_count: int = 0
    before: list[HealDriveState] = field(default_factory=list)
    after: list[HealDriveState] = field(default_factory=list)
    dry_run: bool = False
    purged: bool = False

    @property
    def healed_count(self) -> int:
        return sum(1 for b, a in zip(self.before, self.after)
                   if b.state != DRIVE_STATE_OK and a.state == DRIVE_STATE_OK)


def latest_fileinfo(results: list) -> FileInfo | None:
    """The FileInfo cohort with the newest mod_time, preferring an entry
    that carries erasure geometry (cmd/erasure-healing-common.go:103)."""
    valid = [r for r in results if isinstance(r, FileInfo)]
    if not valid:
        return None
    latest_mt = max(fi.mod_time for fi in valid)
    cohort = [fi for fi in valid if fi.mod_time == latest_mt]
    for fi in cohort:
        if fi.deleted or fi.erasure.data_blocks:
            return fi
    return cohort[0]


def _same_version(fi: FileInfo, latest: FileInfo) -> bool:
    return (fi.mod_time == latest.mod_time and fi.data_dir == latest.data_dir
            and fi.version_id == latest.version_id
            and fi.deleted == latest.deleted)


def _clone_fi(fi: FileInfo, index: int) -> FileInfo:
    out = fi.clone()
    out.erasure.index = index
    return out


class _ShardWriters:
    """One streaming create_file per target drive for one part, fed from
    queues by the heal loop (daemon threads, joined by finish())."""

    def __init__(self, drives: dict[int, object], rel: dict[int, str],
                 errs: dict[int, Exception | None], host=None):
        self.errs = errs
        self.queues: dict[int, queue.Queue] = {}
        self.threads: list[threading.Thread] = []
        for pos, drive in drives.items():
            if errs[pos] is not None:
                continue
            q: queue.Queue = queue.Queue(maxsize=4)
            self.queues[pos] = q

            def writer(pos=pos, drive=drive, q=q):
                try:
                    drive.create_file(SYS_VOL, rel[pos],
                                      bitrot.frame_records(iter(q.get, None), host))
                except Exception as e:  # noqa: BLE001 - per-drive failure is data
                    self.errs[pos] = e
                    while q.get() is not None:
                        pass

            # ctx_wrap: the drive's records carry the heal's trace id.
            t = threading.Thread(target=obs.ctx_wrap(writer), daemon=True,
                                 name=f"heal-writer-{pos}")
            self.threads.append(t)
            t.start()

    def put(self, pos: int, digest: bytes | None, chunk: bytes) -> None:
        """Queue one record; a None digest is hashed by the writer thread
        under the host algorithm."""
        q = self.queues.get(pos)
        if q is not None:
            q.put((digest, chunk))

    def finish(self) -> None:
        for q in self.queues.values():
            q.put(None)
        for t in self.threads:
            t.join()


class HealingMixin:
    """Heal entry points for ErasureObjects (self provides drives, n,
    device, nslock, bitrot_algorithm, stream_journals, read_sys_config)."""

    # -- bucket heal (reference healBucket, cmd/erasure-healing.go:56) --

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> HealResultItem:
        """Recreate the bucket on every drive that lacks it, then read its
        metadata document, whose read-repair rewrites missing copies."""
        results = parallel_map([lambda d=d: d.stat_vol(bucket) for d in self.drives],
                               deadline=self._meta_deadline())
        res = HealResultItem(heal_type="bucket", bucket=bucket,
                             disk_count=self.n, dry_run=dry_run)
        have = [not isinstance(r, Exception) for r in results]
        for d, r, ok in zip(self.drives, results, have):
            st = (DRIVE_STATE_OK if ok else DRIVE_STATE_MISSING
                  if isinstance(r, se.VolumeNotFound) else DRIVE_STATE_OFFLINE)
            res.before.append(HealDriveState(d.endpoint(), st))
        if not any(have):
            raise se.BucketNotFound(bucket)
        res.after = [HealDriveState(s.endpoint, s.state) for s in res.before]
        if dry_run:
            return res
        for i, (r, ok) in enumerate(zip(results, have)):
            if ok or not isinstance(r, se.VolumeNotFound):
                continue
            try:
                self.drives[i].make_vol(bucket)
                res.after[i].state = DRIVE_STATE_OK
            except se.VolumeExists:
                res.after[i].state = DRIVE_STATE_OK
            except se.StorageError:
                pass
        try:
            self.read_sys_config(f"buckets/{bucket}/metadata.mp")
        except se.StorageError:
            pass    # no document (the default config) or below quorum
        return res

    # -- object heal (reference healObject, cmd/erasure-healing.go:233) --

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    dry_run: bool = False, remove_dangling: bool = True,
                    scan_deep: bool = False) -> HealResultItem:
        """Heal one object version. scan_deep verifies every shard's
        digests (the only way to find a flipped byte); otherwise a shard is
        checked for presence and framed size. dry_run classifies and
        changes nothing; remove_dangling=False raises instead of purging."""
        with self.nslock.lock(bucket, obj):
            return self._heal_object_locked(bucket, obj, version_id, dry_run,
                                            remove_dangling, scan_deep)

    def _heal_object_locked(self, bucket, obj, version_id, dry_run,
                            remove_dangling, scan_deep):
        results = parallel_map([lambda d=d: d.read_version(bucket, obj, version_id)
                                for d in self.drives],
                               deadline=self._meta_deadline())
        latest = latest_fileinfo(results)
        if latest is None:
            if all(isinstance(r, (se.FileNotFound, se.FileVersionNotFound))
                   for r in results):
                raise se.ObjectNotFound(bucket, obj)
            raise se.InsufficientReadQuorum(bucket, obj, "no readable metadata")
        if (latest.deleted or not latest.erasure.distribution
                or (latest.metadata.get(TRANSITION_TIER_KEY) and not latest.data_dir)):
            # A delete marker, or a transitioned stub whose data lives on
            # its tier: heal the journal only, never reconstruct or purge.
            return self._heal_metadata_only(bucket, obj, latest, results, dry_run)

        dist = latest.erasure.distribution
        k = latest.erasure.data_blocks
        shuffled_drives = shuffle_by_distribution(self.drives, dist)
        shuffled_results = shuffle_by_distribution(results, dist)
        states = self._classify(bucket, obj, latest, shuffled_drives,
                                shuffled_results, scan_deep)
        res = HealResultItem(
            bucket=bucket, object=obj, version_id=latest.version_id,
            object_size=latest.size, data_blocks=k,
            parity_blocks=latest.erasure.parity_blocks, disk_count=self.n,
            dry_run=dry_run,
            before=[HealDriveState(d.endpoint(), s)
                    for d, s in zip(shuffled_drives, states)])
        res.after = [HealDriveState(s.endpoint, s.state) for s in res.before]
        avail = [i for i, s in enumerate(states) if s == DRIVE_STATE_OK]
        targets = [i for i, s in enumerate(states)
                   if s in (DRIVE_STATE_MISSING, DRIVE_STATE_CORRUPT,
                            DRIVE_STATE_OUTDATED)]
        if len(avail) < k:
            # Dangling when the drives without its journal alone exceed
            # parity: no quorum can ever be reached again (reference
            # isObjectDangling, cmd/erasure-healing.go:758).
            notfound = sum(isinstance(r, (se.FileNotFound, se.FileVersionNotFound))
                           for r in results)
            if notfound > latest.erasure.parity_blocks and remove_dangling:
                if not dry_run:
                    self._purge_dangling(bucket, obj, latest)
                    res.purged = True
                return res
            raise se.InsufficientReadQuorum(bucket, obj,
                                            f"{len(avail)} of {k} shards available")
        if not targets or dry_run:
            return res
        if latest.inline_data:
            self._heal_write_metadata(bucket, obj, latest, shuffled_drives,
                                      targets, res)
            return res
        healed = self._reconstruct_to_targets(bucket, obj, latest,
                                              shuffled_drives, avail, targets)
        for pos in healed:
            res.after[pos].state = DRIVE_STATE_OK
        return res

    # -- journal-only heals (delete markers, transitioned stubs, inline) --

    def _heal_metadata_only(self, bucket, obj, latest, results, dry_run
                            ) -> HealResultItem:
        res = HealResultItem(bucket=bucket, object=obj,
                             version_id=latest.version_id,
                             object_size=latest.size, disk_count=self.n,
                             dry_run=dry_run)
        targets = []
        for i, r in enumerate(results):
            if isinstance(r, FileInfo) and _same_version(r, latest):
                st = DRIVE_STATE_OK
            elif isinstance(r, (se.FileNotFound, se.FileVersionNotFound, FileInfo)):
                st = DRIVE_STATE_MISSING
                targets.append(i)
            else:
                st = DRIVE_STATE_OFFLINE
            res.before.append(HealDriveState(self.drives[i].endpoint(), st))
        res.after = [HealDriveState(s.endpoint, s.state) for s in res.before]
        if dry_run:
            return res
        self._heal_write_metadata(bucket, obj, latest, self.drives, targets, res,
                                  positions_are_physical=True)
        return res

    def _heal_write_metadata(self, bucket, obj, latest, drives, targets, res,
                             positions_are_physical=False) -> None:
        """Write the elected journal entry to the target drives: shard
        index pos + 1 at distribution positions, 0 at physical ones (a
        journal-only heal), as the JAX package writes them."""
        self._meta_invalidate(bucket, obj)

        def write(pos):
            fi = _clone_fi(latest, 0 if positions_are_physical else pos + 1)
            if latest.deleted:
                drives[pos].delete_version(bucket, obj, fi)
            else:
                drives[pos].write_metadata(bucket, obj, fi)

        outcomes = parallel_map([lambda p=p: write(p) for p in targets],
                                deadline=self._meta_deadline())
        for pos, out in zip(targets, outcomes):
            if not isinstance(out, Exception):
                res.after[pos].state = DRIVE_STATE_OK

    # -- namespace heal (reference HealObjects, cmd/erasure-server-pool.go:1500) --

    def heal_objects(self, bucket: str, prefix: str = "", **kw):
        """Heal every object under prefix, in name order, streamed: yields
        each HealResultItem, or the ObjectError a name raised."""
        for name, _meta in self.stream_journals(bucket, prefix):
            try:
                yield self.heal_object(bucket, name, **kw)
            except se.ObjectError as e:
                yield e

    # -- dangling purge (reference purgeObjectDangling, :700) --

    def _purge_dangling(self, bucket: str, obj: str, latest: FileInfo) -> None:
        target = FileInfo(volume=bucket, name=obj, version_id=latest.version_id,
                          data_dir=latest.data_dir)
        self._meta_invalidate(bucket, obj)
        parallel_map([lambda d=d: d.delete_version(bucket, obj, target)
                      for d in self.drives],
                     deadline=self._meta_deadline())

    def _classify(self, bucket, obj, latest, shuffled_drives, shuffled_results,
                  scan_deep) -> list[str]:
        """Per shard position: ok / offline / missing / outdated / corrupt
        (reference disksWithAllParts, cmd/erasure-healing-common.go:161)."""
        states: list[str] = []
        checks = []
        for drive, r in zip(shuffled_drives, shuffled_results):
            if isinstance(r, (se.FileNotFound, se.FileVersionNotFound)):
                states.append(DRIVE_STATE_MISSING)
            elif isinstance(r, (se.FileCorrupt, se.CorruptedFormat)):
                states.append(DRIVE_STATE_CORRUPT)
            elif isinstance(r, Exception):
                states.append(DRIVE_STATE_OFFLINE)
            elif not _same_version(r, latest):
                states.append(DRIVE_STATE_OUTDATED)
            else:
                states.append(DRIVE_STATE_OK)
                if not latest.inline_data:
                    checks.append((len(states) - 1, drive))
        fns = [(lambda d=d: self._verify_parts(d, bucket, obj, latest))
               if scan_deep else (lambda d=d: d.check_parts(bucket, obj, latest))
               for _, d in checks]
        # A deep verify reads whole shard files: no deadline bounds it.
        deadline = None if scan_deep else self._data_deadline()
        for (i, _), out in zip(checks, parallel_map(fns, deadline=deadline)):
            if isinstance(out, Exception):
                states[i] = (DRIVE_STATE_CORRUPT
                             if isinstance(out, (se.FileCorrupt, se.FileNotFound))
                             else DRIVE_STATE_OFFLINE)
        return states

    def _verify_parts(self, drive, bucket: str, obj: str, fi: FileInfo) -> None:
        """Deep verify of one drive's shard files (reference VerifyFile):
        every chunk digested, in batched kernel launches for mxsum256 (K2)
        and mxhash256 (K3), per chunk for a host algorithm."""
        algo = next((c.algorithm for c in fi.erasure.checksums),
                    bitrot.WRITE_ALGORITHM)
        drive.check_parts(bucket, obj, fi)
        for part in fi.parts:
            with drive.read_file_stream(
                    bucket, f"{obj}/{fi.data_dir}/part.{part.number}") as f:
                bitrot.verify_shard_file(f, fi.erasure.shard_file_size(part.size),
                                         fi.erasure.shard_size(), algo, self.device)

    def _reconstruct_to_targets(self, bucket, obj, latest, shuffled_drives,
                                avail, targets) -> list[int]:
        """Rebuild every part's shards for the target positions and commit
        them; returns the positions healed."""
        k = latest.erasure.data_blocks
        m = latest.erasure.parity_blocks
        n = k + m
        bs = latest.erasure.block_size
        codec = ErasureCodec(k, m, bs, device=self.device)
        shard_size = codec.shard_size()
        algo = next((c.algorithm for c in latest.erasure.checksums),
                    self.bitrot_algorithm)
        # mxsum256 / mxhash256: the rebuilt chunks are digested on the
        # device after K1, one K2 or K3 launch per batch; a host algorithm
        # hashes on the target drives' writer threads.
        device_algo = algo if algo in bitrot.DEVICE_ALGORITHMS else None
        host_algo = bitrot.get_algorithm(algo)
        heal_id = uuid.uuid4().hex
        tmp_dirs = {pos: f"tmp/heal-{heal_id}-{pos}" for pos in targets}
        errs: dict[int, Exception | None] = {pos: None for pos in targets}
        chosen = avail[:k]
        t_tuple = tuple(targets)
        # Batched data plane: heal rebuilds coalesce onto the reconstruct
        # lanes (per-row decode matrices), sharing launches with concurrent
        # heals and degraded GETs; the per-object codec serves blocks above
        # the gate and submits the plane sheds. The lanes digest with
        # mxsum256 or not at all, so mxhash256 heals take the codec.
        plane = (dataplane.maybe_plane(self.device)
                 if m and algo != "mxhash256" else None)

        def begin_rebuild(rows, block_lens):
            if (plane is not None and block_lens
                    and plane.accepts_recon_chunk(-(-max(block_lens) // k))):
                try:
                    return plane.begin_reconstruct(
                        k, m, rows, block_lens, t_tuple,
                        with_digests=algo == "mxsum256")
                except se.OperationTimedOut:
                    pass  # plane saturated: per-object dispatch serves
            return codec.begin_reconstruct(rows, block_lens, t_tuple, device_algo)

        try:
            for part in latest.parts:
                rel = f"{obj}/{latest.data_dir}/part.{part.number}"
                readers = {pos: bitrot.BitrotReader(
                    shuffled_drives[pos].read_file_stream(bucket, rel),
                    latest.erasure.shard_file_size(part.size), shard_size, algo)
                    for pos in chosen}
                writers = _ShardWriters(
                    {pos: shuffled_drives[pos] for pos in targets},
                    {pos: f"{tmp_dirs[pos]}/part.{part.number}" for pos in targets},
                    errs, host_algo)
                try:
                    # Dispatch-ahead: the host reads batch N+1's survivors
                    # while the device rebuilds batch N.
                    pending: list = []

                    def drain_one() -> None:
                        chunk_rows, dig_rows = pending.pop(0).wait()
                        for j, chunks in enumerate(chunk_rows):
                            for ti, pos in enumerate(t_tuple):
                                writers.put(pos, dig_rows[j][ti]
                                            if dig_rows is not None else None,
                                            chunks[ti])

                    n_blocks = max(1, -(-part.size // bs))
                    for b0 in range(0, n_blocks, BATCH_BLOCKS):
                        ids = range(b0, min(b0 + BATCH_BLOCKS, n_blocks))
                        lens = [min(bs, part.size - b * bs) for b in ids]
                        rows = self._read_survivors(readers, chosen, ids, n,
                                                    shard_size, device_algo)
                        pending.append(begin_rebuild(rows, lens))
                        if len(pending) >= 2:
                            drain_one()
                    while pending:
                        drain_one()
                finally:
                    for r in readers.values():
                        r.src.close()
                    writers.finish()
        except Exception:
            parallel_map([lambda p=p: shuffled_drives[p].delete(
                SYS_VOL, tmp_dirs[p], recursive=True) for p in targets],
                         deadline=self._meta_deadline())
            raise

        self._meta_invalidate(bucket, obj)
        healed = []
        for pos in targets:
            if errs[pos] is not None:
                continue
            try:
                shuffled_drives[pos].rename_data(SYS_VOL, tmp_dirs[pos],
                                                 _clone_fi(latest, pos + 1),
                                                 bucket, obj)
                healed.append(pos)
            except se.StorageError:
                try:
                    shuffled_drives[pos].delete(SYS_VOL, tmp_dirs[pos],
                                                recursive=True)
                except se.StorageError:
                    pass
        return healed

    def _read_survivors(self, readers, chosen, ids, n, shard_size,
                        device_algo: str | None) -> list[list]:
        """Survivor chunks of one batch; mxsum256 and mxhash256 chunks
        verified in one digest launch (mxsum256 on the plane when it is
        on), host-algorithm chunks one by one (a corrupt survivor fails the
        heal: heal never rebuilds from bad data)."""
        batched = device_algo is not None
        rows = [[None] * n for _ in ids]
        records = []
        for pos in chosen:
            r = readers[pos]
            for j, b in enumerate(ids):
                if batched:
                    want, chunk = r.read_record(b)
                    records.append((pos, want, chunk))
                else:
                    chunk = r.read_verified(b)
                rows[j][pos] = chunk
        if records:
            got = bitrot.device_digests(device_algo, [c for _p, _w, c in records],
                                        shard_size, self.device)
            for (pos, want, _c), g in zip(records, got):
                if g != want:
                    raise se.FileCorrupt(f"shard {pos}: bitrot digest mismatch")
        return rows


# The JAX package's knobs, same names and defaults: the first retry's
# delay, the attempts per episode, and the cap of the doubling delay.
MRF_RETRY_INTERVAL = float(os.environ.get("MTPU_MRF_RETRY_INTERVAL", "1.0"))
MRF_RETRY_MAX = int(os.environ.get("MTPU_MRF_RETRY_MAX", "600"))
MRF_RETRY_CAP = float(os.environ.get("MTPU_MRF_RETRY_CAP", "60.0"))

_MRF_REQUEUES = obs.counter(
    "minio_tpu_mrf_requeues_total",
    "MRF heals requeued because target drives were still offline")


class MRFHealer:
    """Most-recently-failed heal queue of one set (reference mrfOpCh,
    cmd/erasure.go:41-75; minio_tpu/erasure/healing.py MRFHealer).

    add_partial queues (bucket, object, version); one daemon thread pops
    each entry before it heals it (so damage that arrives during the heal
    queues it again) and keeps it in an in-flight set until the heal ends.
    A heal that found target drives OFFLINE rebuilt nothing for them: the
    entry comes back after a jittered delay that doubles from
    MTPU_MRF_RETRY_INTERVAL up to MTPU_MRF_RETRY_CAP, at most
    MTPU_MRF_RETRY_MAX times, so a degraded write drains once its drives
    return and a dead drive costs one attempt per cap. An object deleted
    since drops out."""

    def __init__(self, er, maxsize: int = 10000):
        self.er = er
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._mu = threading.Lock()
        # key -> deep: a deep request upgrades a pending shallow one.
        self._pending: dict[tuple[str, str, str], bool] = {}
        self._attempts: dict[tuple[str, str, str], int] = {}
        self._inflight: set[tuple[str, str, str]] = set()
        self._retry: list[tuple[float, tuple[str, str, str], bool]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="mtpu-mrf")
        self._thread.start()

    def add_partial(self, bucket: str, obj: str, version_id: str = "",
                    deep: bool = False) -> None:
        """deep=True when the caller saw bitrot: the heal then verifies
        every shard's digests instead of checking presence and size."""
        key = (bucket, obj, version_id)
        with self._mu:
            if key in self._pending:
                if deep:
                    self._pending[key] = True
                return
            self._pending[key] = deep
        try:
            self.q.put_nowait(key)
        except queue.Full:
            with self._mu:
                self._pending.pop(key, None)

    def _pump_due_retries(self) -> None:
        now = time.monotonic()
        with self._mu:
            due = [(k, d) for t, k, d in self._retry if t <= now]
            self._retry = [e for e in self._retry if e[0] > now]
            to_queue = []
            for k, d in due:
                # As a first enqueue would: a pending entry absorbs the
                # retry, and a deep retry upgrades it.
                if k in self._pending:
                    self._pending[k] = self._pending[k] or d
                else:
                    self._pending[k] = d
                    to_queue.append(k)
        for key in to_queue:
            try:
                self.q.put_nowait(key)
            except queue.Full:
                with self._mu:
                    self._pending.pop(key, None)
                    self._attempts.pop(key, None)

    def _drain(self) -> None:
        while not self._stop.is_set():
            self._pump_due_retries()
            try:
                key = self.q.get(timeout=0.2)
            except queue.Empty:
                continue
            with self._mu:
                deep = self._pending.pop(key, False)
                self._inflight.add(key)
            requeue = False
            try:
                res = self.er.heal_object(*key, scan_deep=deep)
                requeue = any(s.state == DRIVE_STATE_OFFLINE
                              for s in (res.after or res.before))
            except (se.ObjectNotFound, se.FileNotFound, se.FileVersionNotFound):
                pass    # deleted since: nothing to heal
            except Exception:  # noqa: BLE001 - quorum or transport: try again
                requeue = True
            with self._mu:
                self._inflight.discard(key)
                self._attempts[key] = attempts = self._attempts.get(key, 0) + 1
                if requeue and attempts < MRF_RETRY_MAX and key not in self._pending:
                    delay = min(MRF_RETRY_INTERVAL * 2 ** (attempts - 1),
                                max(MRF_RETRY_INTERVAL, MRF_RETRY_CAP))
                    delay *= 1.0 + 0.25 * random.random()
                    self._retry.append((time.monotonic() + delay, key, deep))
                    _MRF_REQUEUES.labels().inc()
                elif requeue and key in self._pending:
                    # A concurrent add_partial queued it again: that entry
                    # is the retry, and keeps an observed bitrot deep.
                    self._pending[key] = self._pending[key] or deep
                elif key not in self._pending:
                    # Episode over: a later degraded write starts afresh.
                    self._attempts.pop(key, None)
            self.q.task_done()

    def backlog(self) -> int:
        """Entries queued, in flight or waiting to retry."""
        with self._mu:
            return len(self._pending) + len(self._inflight) + len(self._retry)

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Block until nothing is queued, in flight or waiting to retry;
        False if that took longer than `timeout` seconds."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                if (not self._pending and not self._retry
                        and not self._inflight and self.q.empty()):
                    return True
            time.sleep(0.01)
        return False

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
