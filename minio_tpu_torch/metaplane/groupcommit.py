"""DriveWAL: per-drive group commit over the WAL journal (counterpart of
minio_tpu/metaplane/groupcommit.py).

One committer thread per armed drive. Journal stores enqueue records and
wait on futures; the committer drains the queue, appends the whole batch
with one writev and fsyncs once, and only then resolves the futures, so
an acknowledgement is always the WAL fsync covering its record.

meta.mp files materialize later: after the fsync the batch is published
to a pending overlay that every read consults first (read-your-write
holds the instant a future resolves), and the committer writes the
journals, with no fsync of their own, when its queue goes idle (a 0.5 s
tick), at a flush barrier, or when the backlog passes
MTPU_WAL_MAX_PENDING. A checkpoint (the WAL past MTPU_WAL_MAX_BYTES, or
close) materializes everything, syncs once and truncates the WAL.

A crash before a batch's fsync tears the WAL's tail; `wal.scan` stops
before it, and those writes were never acknowledged. A crash after it
leaves records that the next mount replays (`replay_all`, run by every
LocalDrive whatever the gate), rewriting each key's last state; replay
is idempotent, so a crash inside a checkpoint loses nothing.

An append or fsync failure marks the WAL broken: the batch's futures
fail with FaultyDisk (the quorum counts the drive as failed) and later
submits fail at once. A materialization failure leaves the entry pending
(still served from memory, still in the WAL) and blocks truncation.

The submission queue is `qos.plane_queue`: a plain bounded queue, or
under MTPU_QOS=1 a tenant-fair DRR queue whose flush and close are
control items (released only after everything enqueued before them) and
whose tombstones (remove, remove_prefix, blob_remove) are ordering
fences, so file order equals submit order wherever replay depends on it.
Each record's tenant rides its future (`mtpu_tenant`) into the batch
record.

Under a multi-worker front door each worker writes its own segment,
`journal.<MTPU_WAL_SEGMENT>.wal` (`journal.w<id>.wal`), holding its flock
for its whole life; a mount folds only the segments no live process
holds. Batches then materialize before their acks (siblings read through
the filesystem) and `key_sig` answers None (a sibling's commits move
state this process's sequence numbers never see).
"""

from __future__ import annotations

import itertools
import os
import queue
import shutil
import threading
import time
import weakref
from collections import OrderedDict
from concurrent.futures import Future

from minio_tpu_torch import metaplane, obs, qos
from minio_tpu_torch.metaplane import wal as walfmt
from minio_tpu_torch.obs import flight
from minio_tpu_torch.utils import admission
from minio_tpu_torch.utils import errors as se

_COMMITS = obs.counter(
    "minio_tpu_metaplane_commits_total",
    "Journal records group-committed through the per-drive WAL",
    ("drive",))
_FSYNCS = obs.counter(
    "minio_tpu_metaplane_fsyncs_total",
    "WAL fsyncs — commits/fsyncs is the live group-commit amortization",
    ("drive",))
_BATCH_FILL = obs.histogram(
    "minio_tpu_metaplane_batch_fill",
    "Records per WAL group commit",
    ("drive",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256))
_WAL_BYTES = obs.gauge(
    "minio_tpu_metaplane_wal_bytes",
    "Current WAL journal size (truncates at checkpoint)",
    ("drive",))

_seq_lock = threading.Lock()
_seq = 0

# A LocalDrive mounted again over the same root in this process takes the
# segment over by closing its predecessor (the flock that guards the
# segment is per open file, so the predecessor must let go first).
_live_mu = threading.Lock()
_live_by_path: dict = {}
# Numbers every DriveWAL of the process once: with a record's lsn, which
# restarts at each mount, it names a pending write uniquely.
_GENERATIONS = itertools.count(1)


def _wal_cost(item) -> int:
    """Byte cost of one submit for QoS byte quotas: its serialized payload
    (index 3 of every record shape; "single" nests it at payload[1])."""
    raw = item[3]
    if isinstance(raw, tuple):
        raw = raw[1] if len(raw) > 1 else None
    if raw is None:
        return 0
    try:
        return len(raw)
    except TypeError:
        return 0


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


class Entry:
    """One committed-but-unmaterialized state. `raw is None` marks a
    deletion; `blob` a raw system file, whose `path` is the file itself
    (journal readers never see blob entries, and blob readers never see
    journal entries)."""

    __slots__ = ("lsn", "raw", "meta", "memo", "mt", "blob")

    def __init__(self, lsn: int, raw, meta, mt: float, blob: bool = False):
        self.lsn = lsn
        self.raw = raw
        self.meta = meta
        self.memo: dict = {}
        self.mt = mt
        self.blob = blob

    @property
    def removed(self) -> bool:
        return self.raw is None


def replay_all(drive, wal_dir: str) -> tuple[int, int]:
    """Replay every orphaned segment under a drive's wal dir in one merged
    fold; (applied, failed) record counts. A segment whose owner is alive
    (it holds an exclusive flock on its fd for its whole life; the kernel
    drops it even on SIGKILL) is left alone. Segments are truncated only
    when every record applied."""
    import fcntl

    os.makedirs(wal_dir, exist_ok=True)
    lfd = _replay_lock(wal_dir)
    try:
        applied, failed, _orphans = _replay_orphans(drive, wal_dir)
        return applied, failed
    finally:
        try:
            fcntl.flock(lfd, fcntl.LOCK_UN)
        finally:
            os.close(lfd)


def _replay_lock(wal_dir: str) -> int:
    import fcntl

    lfd = os.open(os.path.join(wal_dir, ".replay.lock"),
                  os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(lfd, fcntl.LOCK_EX)
    return lfd


def _replay_orphans(drive, wal_dir: str) -> tuple[int, int, list]:
    """replay_all's core; the caller holds `.replay.lock`. The orphans stay
    on disk when a record failed, so the caller can seed its overlay."""
    import fcntl

    orphan_fds: list[int] = []
    orphans: list[str] = []
    try:
        for p in walfmt.segment_paths(wal_dir):
            try:
                fd = os.open(p, os.O_RDWR)
            except OSError:
                continue
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(fd)  # live owner
                continue
            orphan_fds.append(fd)
            orphans.append(p)
        if not orphans:
            return 0, 0, []
        t0 = time.perf_counter()
        final = walfmt.fold_merged(orphans)
        applied, failed = _apply_fold(drive, final)
        if failed == 0:
            for p in orphans:
                walfmt.reset(p)
        drive.last_replay = (applied, failed, time.perf_counter() - t0)
        return applied, failed, orphans
    finally:
        for fd in orphan_fds:
            try:
                os.close(fd)
            except OSError:
                continue


def _apply_fold(drive, final) -> tuple[int, int]:
    """Write a replay fold back to the drive; (applied, failed). A record
    older than what the disk holds (state an unarmed process wrote after
    the crash) is skipped."""
    from minio_tpu_torch.storage.xlmeta import XLMeta

    applied = 0
    failed = 0
    for (vol, path), rec in final.items():
        stat_err = False
        if rec.rtype in (walfmt.REC_REPL_INTENT, walfmt.REC_REPL_DONE):
            # A replication intent belongs to the JAX package's own
            # segment; one in a drive journal is kept, never guessed at.
            failed += 1
            continue
        blob = rec.rtype in (walfmt.REC_BLOB, walfmt.REC_BLOB_REMOVE)
        try:
            disk_mt = (drive._disk_blob_mt(vol, path) if blob
                       else drive._disk_meta_mt(vol, path))
        except se.StorageError:
            disk_mt = None  # unreadable or corrupt on disk: the record wins
            stat_err = True
        if disk_mt is not None and disk_mt > rec.mt + 1e-9:
            continue
        if rec.rtype == walfmt.REC_BLOB:
            try:
                drive._store_blob_disk(vol, path, rec.raw)
                applied += 1
            except se.StorageError:
                failed += 1
            continue
        if rec.rtype == walfmt.REC_BLOB_REMOVE:
            try:
                drive._remove_blob_disk(vol, path)
                applied += 1
            except se.StorageError:
                failed += 1
            continue
        if rec.rtype == walfmt.REC_COMMIT:
            try:
                XLMeta.parse(rec.raw)
            except se.StorageError:
                continue  # CRC-valid but unparseable: quorum and heal absorb it
            try:
                drive._store_meta_disk(vol, path, rec.raw, fsync=False)
                applied += 1
            except se.StorageError:
                failed += 1
        elif rec.rtype == walfmt.REC_REMOVE:
            if disk_mt is None and not stat_err:
                continue  # already absent
            try:
                drive._remove_meta_disk(vol, path)
                applied += 1
            except se.StorageError:
                failed += 1
        else:
            failed += 1  # a type this build cannot apply: keep the journal
    if applied:
        os.sync()  # one barrier instead of an fsync per file
    return applied, failed


class DriveWAL:
    """Group-commit engine of one LocalDrive (see the module docstring)."""

    def __init__(self, drive):
        import fcntl

        self.drive = drive
        self.generation = next(_GENERATIONS)
        self._dir = os.path.join(drive.root, drive.sys_volume(), "wal")
        seg = metaplane.wal_segment()
        self.path = os.path.join(self._dir,
                                 f"journal.{seg}.wal" if seg else "journal.wal")
        os.makedirs(self._dir, exist_ok=True)
        self._max_bytes = metaplane.wal_max_bytes()
        self._max_pending = metaplane.wal_max_pending()
        self._max_batch = metaplane.wal_max_batch()
        self._lazy = metaplane.lazy_materialize()
        self._eager = metaplane.eager_materialize()
        self._multi = not metaplane.single_owner()

        with _live_mu:
            prior = _live_by_path.pop(self.path, None)
        if prior is not None:
            prior_wal = prior()
            if prior_wal is not None and not prior_wal._closed:
                prior_wal.close()

        # Replay, then claim our segment, under one replay lock.
        lfd = _replay_lock(self._dir)
        try:
            _applied, replay_failed, replay_kept = _replay_orphans(drive, self._dir)
            self._fd = os.open(self.path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                               0o644)
            try:
                fcntl.flock(self._fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                os.close(self._fd)
                raise se.FaultyDisk(
                    f"wal segment {self.path} is owned by a live writer") from None
        finally:
            try:
                fcntl.flock(lfd, fcntl.LOCK_UN)
            finally:
                os.close(lfd)
        if os.fstat(self._fd).st_size == 0:
            os.write(self._fd, walfmt.MAGIC)
            os.fsync(self._fd)
        self._bytes = os.fstat(self._fd).st_size

        self._q = qos.plane_queue(
            "metaplane", metaplane.wal_queue_depth(),
            tenant_of=lambda it: getattr(it[-1], "mtpu_tenant", None),
            cost_of=_wal_cost,
            is_control=lambda it: it[0] in ("flush", "close"),
            is_barrier=lambda it: it[0] in ("remove_prefix", "remove",
                                            "blob_remove"))
        self._mu = threading.Lock()  # pending overlay + per-key lsn map
        self._pending: OrderedDict[tuple[str, str], Entry] = OrderedDict()
        self._key_lsn: OrderedDict[tuple[str, str], int] = OrderedDict()
        self._key_lsn_cap = 65536
        # Blob keys that may still have a record in the WAL (cleared at
        # checkpoint); None once the cap is passed ("may exist" always).
        self._blob_keys: set | None = set()
        self._blob_keys_cap = 65536
        self._lsn = 0
        self._broken: str | None = None
        self._closed = False
        self._trash: list[str] = []
        if replay_failed:
            # Some acked records could not be written back: serve the
            # kept fold from the overlay and retry it at every drain.
            for (vol, path), rec in walfmt.fold_merged(replay_kept).items():
                if rec.rtype in (walfmt.REC_REPL_INTENT, walfmt.REC_REPL_DONE):
                    continue
                self._lsn += 1
                blob = rec.rtype in (walfmt.REC_BLOB, walfmt.REC_BLOB_REMOVE)
                self._pending[(vol, path)] = Entry(
                    self._lsn,
                    rec.raw if rec.rtype in (walfmt.REC_COMMIT, walfmt.REC_BLOB)
                    else None,
                    None, rec.mt, blob=blob)
                if not blob:
                    self._key_lsn[(vol, path)] = self._lsn

        self._c_commits = _COMMITS.labels(drive=drive.root)
        self._c_fsyncs = _FSYNCS.labels(drive=drive.root)
        self._h_fill = _BATCH_FILL.labels(drive=drive.root)
        self._g_bytes = _WAL_BYTES.labels(drive=drive.root)
        self._g_bytes.set(self._bytes)

        with _live_mu:
            _live_by_path[self.path] = weakref.ref(self)

        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"mtpu-metaplane-{_next_seq()}")
        self._thread.start()

    # ---------- submission (request threads) ----------

    def _bump_lsn(self, key: tuple[str, str]) -> int:
        with self._mu:
            self._lsn += 1
            self._key_lsn[key] = self._lsn
            self._key_lsn.move_to_end(key)
            while len(self._key_lsn) > self._key_lsn_cap:
                self._key_lsn.popitem(last=False)
            return self._lsn

    def _bump_lsn_only(self) -> int:
        """An lsn for a blob record (ordered in the overlay, absent from
        the per-key signatures)."""
        with self._mu:
            self._lsn += 1
            return self._lsn

    def _submit(self, item) -> Future:
        if self._broken is not None:
            raise se.FaultyDisk(f"wal broken: {self._broken}")
        if self._closed:
            raise se.FaultyDisk("wal closed")
        # The committer stamps the submitter's timeline with its wait for
        # the covering fsync and links the batch's trace ids.
        tid = obs.trace_id()
        tl = flight.current()
        if tid is not None or tl is not None:
            item[-1].mtpu_fctx = (tid, tl, time.perf_counter())
        tenant = qos.current_key()
        if tenant != qos.UNATTRIBUTED:
            item[-1].mtpu_tenant = tenant
        try:
            self._q.put_nowait(item)
        except queue.Full as e:
            if isinstance(e, qos.QuotaFull):
                raise admission.shed("metaplane", "tenant_quota",
                                     "tenant over wal rate quota") from None
            raise admission.shed("metaplane", "wal_full",
                                 "wal commit queue full (backpressure)") from None
        return item[-1]

    def submit_commit(self, volume: str, path: str, raw, meta) -> Future:
        """Enqueue a full-journal store; resolves after the covering fsync.
        `raw` is the serialized journal (not copied), `meta` its parse."""
        self.drive._note_journal_key(volume, path)
        lsn = self._bump_lsn((volume, path))
        mt = meta.latest_mt if meta is not None else time.time()
        return self._submit(("commit", volume, path, raw, meta, mt, lsn, Future()))

    def submit_remove(self, volume: str, path: str) -> Future:
        """Enqueue a journal deletion (its last version went)."""
        lsn = self._bump_lsn((volume, path))
        return self._submit(("remove", volume, path, None, None, time.time(),
                             lsn, Future()))

    def submit_blob(self, volume: str, path: str, raw) -> Future:
        """Enqueue a raw system file (the blob lane): acked by the shared
        WAL fsync, materialized later with no fsync of its own."""
        if not isinstance(raw, bytes):
            raw = memoryview(raw).tobytes()
        lsn = self._bump_lsn_only()
        with self._mu:
            if self._blob_keys is not None:
                self._blob_keys.add((volume, path))
                if len(self._blob_keys) > self._blob_keys_cap:
                    self._blob_keys = None
        return self._submit(("blob", volume, path, raw, None, time.time(), lsn,
                             Future()))

    def has_blob_state(self, volume: str, path: str) -> bool:
        """Whether the WAL may still hold a record of this blob (the gate
        of forget_blob, so deleting a file that never rode the lane costs
        nothing)."""
        key = (volume, path)
        with self._mu:
            ent = self._pending.get(key)
            if ent is not None and ent.blob:
                return True
            return self._blob_keys is None or key in self._blob_keys

    def forget_blob(self, volume: str, path: str) -> bool:
        """A blob file is being deleted: drop its overlay entry and log a
        BLOB_REMOVE so replay cannot bring it back. True when a live
        pending entry was dropped (the file may then not exist on disk)."""
        key = (volume, path)
        dropped = False
        with self._mu:
            ent = self._pending.get(key)
            if ent is not None and ent.blob:
                dropped = not ent.removed
                del self._pending[key]
        try:
            self._submit(("blob_remove", volume, path, None, None, time.time(),
                          self._bump_lsn_only(), Future()))
        except (se.StorageError, se.OperationTimedOut):
            pass  # broken or full: the stale copy loses the election
        return dropped

    def submit_single(self, volume: str, path: str, fi, raw, meta,
                      defer_reclaim: bool) -> Future:
        """Enqueue an inline-PUT single-journal store whose prework (the
        volume check, the displaced-version stash, the merge fallback)
        runs in the committer, so this call never touches the drive. The
        future resolves to the reclaim token or raises the drive's error.
        Same-key commits are serialized by the set's namespace lock."""
        assume_new = self.drive.journal_known_absent(volume, path)
        self.drive._note_journal_key(volume, path)
        lsn = self._bump_lsn((volume, path))
        mt = meta.latest_mt if meta is not None else time.time()
        return self._submit(("single", volume, path,
                             (fi, raw, defer_reclaim, assume_new),
                             meta, mt, lsn, Future()))

    def flush(self, timeout: float = 60.0) -> None:
        """Barrier: every record enqueued before the call is durable and
        materialized on return (walks and listings read meta.mp off the
        filesystem). Cheap when idle."""
        with self._mu:
            idle = not self._pending
        if idle and self._q.empty():
            return
        if self._broken is not None or self._closed:
            self._drain_materialize(force=True)
            return
        fut: Future = Future()
        try:
            self._q.put(("flush", fut), timeout=timeout)
        except queue.Full:
            raise admission.shed("metaplane", "wal_flush_full",
                                 "wal commit queue full (backpressure)") from None
        fut.result(timeout=timeout)

    def forget_subtree(self, volume: str, prefix: str) -> None:
        """A recursive delete removed journals out of band: drop pending
        entries and signature lsns under the prefix, and log one
        REMOVE_PREFIX so replay drops every earlier record there."""
        with self._mu:
            for k in [k for k in self._pending if walfmt._under(k, volume, prefix)]:
                del self._pending[k]
            for k in [k for k in self._key_lsn if walfmt._under(k, volume, prefix)]:
                del self._key_lsn[k]
        try:
            self._submit(("remove_prefix", volume, prefix, None, None,
                          time.time(), 0, Future()))
        except (se.StorageError, se.OperationTimedOut):
            return  # a resurrection here is the dangling case heal purges

    def forget_key(self, volume: str, path: str) -> None:
        """forget_subtree for one journal (nested keys are untouched)."""
        with self._mu:
            self._pending.pop((volume, path), None)
        try:
            self.submit_remove(volume, path)
        except (se.StorageError, se.OperationTimedOut):
            return

    # ---------- read overlay (request threads) ----------

    def pending_entry(self, volume: str, path: str) -> Entry | None:
        """The committed-but-unmaterialized journal of a key, or None when
        the disk is authoritative (`entry.removed` marks a deletion)."""
        with self._mu:
            ent = self._pending.get((volume, path))
            return None if ent is not None and ent.blob else ent

    def pending_blob(self, volume: str, path: str) -> Entry | None:
        """The committed-but-unmaterialized state of a raw system file."""
        with self._mu:
            ent = self._pending.get((volume, path))
            return ent if ent is not None and ent.blob else None

    def key_sig(self, volume: str, path: str):
        """("w", lsn) of the key's journal: every mutation bumps it at
        submit. None once the key left the LRU, and always under a
        multi-worker front door (callers stat instead)."""
        if self._multi:
            return None
        with self._mu:
            lsn = self._key_lsn.get((volume, path))
        return None if lsn is None else ("w", lsn)

    # ---------- committer ----------

    def _run(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.5)
            except queue.Empty:
                if self._closed:
                    return
                self._drain_materialize()
                continue
            batch = [item]
            while len(batch) < self._max_batch:
                try:
                    batch.append(self._q.get_nowait())
                except queue.Empty:
                    break
            close_fut = None
            flushes: list[Future] = []
            recs: list[tuple] = []
            for it in batch:
                if it[0] == "flush":
                    flushes.append(it[1])
                elif it[0] == "close":
                    close_fut = it[1]
                else:
                    recs.append(it)
            if recs:
                self._commit_batch(recs)
            with self._mu:
                backlog = len(self._pending)
            # Materialize on idle, at barriers and under backlog pressure,
            # never after every batch: a burst rides the WAL alone.
            if flushes or close_fut is not None or backlog > self._max_pending:
                self._drain_materialize(force=True)
            for f in flushes:
                f.set_result(None)
            if self._bytes > self._max_bytes and self._broken is None:
                self._checkpoint()
            if close_fut is not None:
                self._checkpoint()
                close_fut.set_result(None)
                return

    def _commit_batch(self, recs: list[tuple]) -> None:
        # A single's prework runs here; its failure fails its own future.
        staged: list[tuple] = []  # (rtype, vol, path, raw, meta, mt, lsn, fut, token)
        for kind, vol, path, payload, meta, mt, lsn, fut in recs:
            if kind == "single":
                fi, raw, defer_reclaim, assume_new = payload
                try:
                    self.drive._stat_vol_cached(vol)
                    token, merged = self.drive._single_prework(
                        vol, path, fi, defer_reclaim, assume_new=assume_new,
                        defer_fs=True)
                except Exception as e:  # noqa: BLE001 - the caller's quorum counts it
                    fut.set_exception(e if isinstance(e, se.StorageError)
                                      else se.FaultyDisk(str(e)))
                    continue
                if merged is not None:
                    meta = merged
                    raw = merged.serialize()
                    mt = merged.latest_mt
                staged.append((walfmt.REC_COMMIT, vol, path, raw, meta, mt, lsn,
                               fut, token))
            elif kind == "commit":
                staged.append((walfmt.REC_COMMIT, vol, path, payload, meta, mt,
                               lsn, fut, None))
            elif kind == "remove_prefix":
                staged.append((walfmt.REC_REMOVE_PREFIX, vol, path, b"", None, mt,
                               lsn, fut, None))
            elif kind == "blob":
                staged.append((walfmt.REC_BLOB, vol, path, payload, None, mt, lsn,
                               fut, None))
            elif kind == "blob_remove":
                staged.append((walfmt.REC_BLOB_REMOVE, vol, path, b"", None, mt,
                               lsn, fut, None))
            else:
                staged.append((walfmt.REC_REMOVE, vol, path, b"", None, mt, lsn,
                               fut, None))
        if not staged:
            return
        frames = [walfmt.frame_record(rtype, mt, vol, path, raw)
                  for rtype, vol, path, raw, _m, mt, _l, _f, _t in staged]
        try:
            n = walfmt.append_records(self._fd, frames)
            os.fsync(self._fd)
        except OSError as e:
            self._broken = str(e)
            err = se.FaultyDisk(f"wal append/fsync failed: {e}")
            for rec in staged:
                rec[7].set_exception(err)
            return
        self._bytes += n
        self._g_bytes.set(self._bytes)
        self._c_fsyncs.inc()
        self._c_commits.inc(len(staged))
        self._h_fill.observe(len(staged))
        # The fsync is the durability point: stamp each member's timeline
        # with its submit-to-fsync wait and link the group in one record.
        t_ack = time.perf_counter()
        members = []
        tenants = set()
        for rec in staged:
            ten = getattr(rec[7], "mtpu_tenant", None)
            if ten:
                tenants.add(ten)
            fctx = getattr(rec[7], "mtpu_fctx", None)
            if fctx is None:
                continue
            tid, tl, t_sub = fctx
            if tid:
                members.append(tid)
            if tl is not None:
                tl.stamp("wal_fsync_wait", t_ack - t_sub, "metaplane")
        if obs.has_subscribers():
            obs.publish({"type": "batch", "plane": "metaplane",
                         "records": len(staged), "members": members,
                         "tenants": sorted(tenants), "time": time.time()})
        # Publish the overlay before resolving: the instant an ack fires,
        # a read sees the new state. A newer published lsn is never
        # downgraded.
        with self._mu:
            for rtype, vol, path, raw, meta, mt, lsn, _fut, _tok in staged:
                if rtype == walfmt.REC_REMOVE_PREFIX:
                    for k in [k for k in self._pending
                              if walfmt._under(k, vol, path)]:
                        del self._pending[k]
                    continue
                key = (vol, path)
                cur = self._pending.get(key)
                if cur is not None and cur.lsn > lsn:
                    continue
                blob = rtype in (walfmt.REC_BLOB, walfmt.REC_BLOB_REMOVE)
                self._pending[key] = Entry(
                    lsn, raw if rtype in (walfmt.REC_COMMIT, walfmt.REC_BLOB)
                    else None, meta, mt, blob=blob)
                self._pending.move_to_end(key)
        if self._eager:
            self._drain_materialize(force=True)
        for rec in staged:
            rec[7].set_result(rec[8])

    def note_trash(self, path: str) -> None:
        """A displaced data dir parked by one rename during commit
        prework; it is removed at the next idle drain, not inside the
        batch."""
        self._trash.append(path)

    def _drain_trash(self) -> None:
        while self._trash:
            shutil.rmtree(self._trash.pop(), ignore_errors=True)

    def _drain_materialize(self, force: bool = False) -> None:
        """Write every pending entry to disk (no per-file fsync). Entries
        that fail stay pending and pin the checkpoint; entries superseded
        meanwhile keep their newer overlay. Unforced (the idle tick), it
        stops as soon as a submission waits: an acknowledgement never
        waits behind the backlog's files, each of which costs several
        returns of the interpreter lock to this thread (seconds, with a
        few hundred busy threads)."""
        self._drain_trash()
        if self._lazy and not (force or self._closed):
            return
        with self._mu:
            snapshot = list(self._pending.items())
        for key, entry in snapshot:
            if not force and not self._q.empty():
                return   # the rest drains at the next idle tick
            vol, path = key
            try:
                if entry.blob:
                    if entry.removed:
                        self.drive._remove_blob_disk(vol, path)
                    else:
                        self.drive._store_blob_disk(vol, path, entry.raw)
                elif entry.removed:
                    self.drive._remove_meta_disk(vol, path)
                else:
                    self.drive._store_meta_disk(vol, path, entry.raw, fsync=False)
            except se.StorageError:
                continue
            with self._mu:
                if self._pending.get(key) is entry:
                    del self._pending[key]

    def _checkpoint(self) -> None:
        """Materialize everything, one sync, truncate the WAL."""
        self._drain_materialize(force=True)
        with self._mu:
            if self._pending:
                return  # a stuck materialization pins the WAL
        try:
            os.sync()
            os.ftruncate(self._fd, 0)
            os.write(self._fd, walfmt.MAGIC)
            os.fsync(self._fd)
        except OSError as e:
            self._broken = str(e)
            return
        self._bytes = len(walfmt.MAGIC)
        self._g_bytes.set(self._bytes)
        with self._mu:
            self._blob_keys = set()

    # ---------- lifecycle ----------

    def abandon(self) -> None:
        """A crash, for tests: stop the committer and release the segment
        without materializing, checkpointing or resolving anything, so
        the disk holds exactly what a kill leaves."""
        self._closed = True
        self._broken = "abandoned (test crash)"
        self._thread.join(5.0)
        try:
            os.close(self._fd)
        except OSError:
            pass

    def close(self, timeout: float = 30.0) -> None:
        """Drain, checkpoint and stop the committer."""
        if self._closed:
            return
        try:
            fut: Future = Future()
            self._q.put(("close", fut), timeout=timeout)
            self._closed = True
            fut.result(timeout=timeout)
        except Exception:  # noqa: BLE001 - a broken WAL failed its waiters already
            self._closed = True
        self._thread.join(timeout=timeout)
        try:
            os.close(self._fd)
        except OSError:
            return
