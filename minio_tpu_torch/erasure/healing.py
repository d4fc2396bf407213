"""Object heal: rebuild missing, outdated and corrupt shards of one object
(counterpart of heal_object in minio_tpu/erasure/healing.py; reference
cmd/erasure-healing.go:233-498).

Every drive of the set is classified ok / offline / missing / outdated /
corrupt for the elected version; the target shards of every part are
rebuilt from any k healthy shards with the decode matrix as runtime data,
and the rebuilt chunks are digested in the same codec call
(begin_reconstruct(..., with_digests=True): kernel K1 then K2 on the
device), framed into fresh [digest][chunk] shard files in the tmp area and
committed with rename_data. Inline objects heal by rewriting the journal.
As in the JAX package, the rebuilds and the survivor verifies ride the
batched data plane when it is on (concurrent heals and degraded GETs share
its reconstruct lanes), and a heal invalidates the hot tier's residence.

Left for later slices (ROADMAP.md): bucket heal, dangling-object purge,
the MRF queue and the background auto-heal scanner.
"""

from __future__ import annotations

import queue
import threading
import uuid
from dataclasses import dataclass, field

from minio_tpu_torch import dataplane
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


@dataclass
class HealDriveState:
    endpoint: str
    state: str


@dataclass
class HealResultItem:
    """Result of one heal (reference madmin.HealResultItem)."""

    bucket: str = ""
    object: str = ""
    version_id: str = ""
    object_size: int = 0
    data_blocks: int = 0
    parity_blocks: int = 0
    disk_count: int = 0
    before: list[HealDriveState] = field(default_factory=list)
    after: list[HealDriveState] = field(default_factory=list)

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
                 errs: dict[int, Exception | None]):
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
                                      bitrot.frame_records(iter(q.get, None)))
                except Exception as e:  # noqa: BLE001 - per-drive failure is data
                    self.errs[pos] = e
                    while q.get() is not None:
                        pass

            t = threading.Thread(target=writer, daemon=True, name=f"heal-writer-{pos}")
            self.threads.append(t)
            t.start()

    def put(self, pos: int, digest: bytes, chunk: bytes) -> None:
        q = self.queues.get(pos)
        if q is not None:
            q.put((digest, chunk))

    def finish(self) -> None:
        for q in self.queues.values():
            q.put(None)
        for t in self.threads:
            t.join()


class HealingMixin:
    """heal_object for ErasureObjects (self provides drives, n, device,
    nslock, bitrot_algorithm)."""

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    scan_deep: bool = False) -> HealResultItem:
        """Heal one object version. scan_deep verifies every shard's
        digests (the only way to find a flipped byte); otherwise a shard is
        checked for presence and framed size."""
        with self.nslock.lock(bucket, obj):
            return self._heal_object_locked(bucket, obj, version_id, scan_deep)

    def _heal_object_locked(self, bucket, obj, version_id, scan_deep):
        results = parallel_map([lambda d=d: d.read_version(bucket, obj, version_id)
                                for d in self.drives])
        latest = latest_fileinfo(results)
        if latest is None:
            if all(isinstance(r, (se.FileNotFound, se.FileVersionNotFound))
                   for r in results):
                raise se.ObjectNotFound(bucket, obj)
            raise se.InsufficientReadQuorum(bucket, obj, "no readable metadata")
        if latest.deleted or not latest.erasure.distribution:
            raise se.ObjectNotFound(bucket, obj, "delete markers heal later")

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
            before=[HealDriveState(d.endpoint(), s)
                    for d, s in zip(shuffled_drives, states)])
        res.after = [HealDriveState(s.endpoint, s.state) for s in res.before]
        avail = [i for i, s in enumerate(states) if s == DRIVE_STATE_OK]
        targets = [i for i, s in enumerate(states)
                   if s in (DRIVE_STATE_MISSING, DRIVE_STATE_CORRUPT,
                            DRIVE_STATE_OUTDATED)]
        if len(avail) < k:
            raise se.InsufficientReadQuorum(bucket, obj,
                                            f"{len(avail)} of {k} shards available")
        if not targets:
            return res
        if latest.inline_data:
            outcomes = parallel_map([
                lambda p=p: shuffled_drives[p].write_metadata(
                    bucket, obj, _clone_fi(latest, 0)) for p in targets])
            healed = [p for p, o in zip(targets, outcomes)
                      if not isinstance(o, Exception)]
        else:
            healed = self._reconstruct_to_targets(bucket, obj, latest,
                                                  shuffled_drives, avail, targets)
        for pos in healed:
            res.after[pos].state = DRIVE_STATE_OK
        return res

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
        for (i, _), out in zip(checks, parallel_map(fns)):
            if isinstance(out, Exception):
                states[i] = (DRIVE_STATE_CORRUPT
                             if isinstance(out, (se.FileCorrupt, se.FileNotFound))
                             else DRIVE_STATE_OFFLINE)
        return states

    def _verify_parts(self, drive, bucket: str, obj: str, fi: FileInfo) -> None:
        """Deep verify of one drive's shard files (reference VerifyFile):
        every chunk digested, in batched kernel launches for mxsum256."""
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
        use_fused = algo == "mxsum256"
        host_algo = bitrot.get_algorithm(algo)
        heal_id = uuid.uuid4().hex
        tmp_dirs = {pos: f"tmp/heal-{heal_id}-{pos}" for pos in targets}
        errs: dict[int, Exception | None] = {pos: None for pos in targets}
        chosen = avail[:k]
        t_tuple = tuple(targets)
        # Batched data plane: heal rebuilds coalesce onto the reconstruct
        # lanes (per-row decode matrices), sharing launches with concurrent
        # heals and degraded GETs; the per-object codec serves blocks above
        # the gate and submits the plane sheds.
        plane = dataplane.maybe_plane(self.device) if m else None

        def begin_rebuild(rows, block_lens):
            if (plane is not None and block_lens
                    and plane.accepts_recon_chunk(-(-max(block_lens) // k))):
                try:
                    return plane.begin_reconstruct(
                        k, m, rows, block_lens, t_tuple,
                        with_digests=use_fused)
                except se.OperationTimedOut:
                    pass  # plane saturated: per-object dispatch serves
            return codec.begin_reconstruct(rows, block_lens, t_tuple,
                                           with_digests=use_fused)

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
                    errs)
                try:
                    # Dispatch-ahead: the host reads batch N+1's survivors
                    # while the device rebuilds batch N.
                    pending: list = []

                    def drain_one() -> None:
                        chunk_rows, dig_rows = pending.pop(0).wait()
                        for j, chunks in enumerate(chunk_rows):
                            for ti, pos in enumerate(t_tuple):
                                d = (dig_rows[j][ti] if dig_rows is not None
                                     else host_algo.digest(chunks[ti]))
                                writers.put(pos, d, chunks[ti])

                    n_blocks = max(1, -(-part.size // bs))
                    for b0 in range(0, n_blocks, BATCH_BLOCKS):
                        ids = range(b0, min(b0 + BATCH_BLOCKS, n_blocks))
                        lens = [min(bs, part.size - b * bs) for b in ids]
                        rows = self._read_survivors(readers, chosen, ids, n,
                                                    shard_size, use_fused)
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
                SYS_VOL, tmp_dirs[p], recursive=True) for p in targets])
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
                        batched) -> list[list]:
        """Survivor chunks of one batch; mxsum256 chunks verified in one
        digest launch, or on the plane (a corrupt survivor fails the heal:
        heal never rebuilds from bad data)."""
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
            got = dataplane.digest_chunks([c for _p, _w, c in records],
                                          shard_size, self.device)
            for (pos, want, _c), g in zip(records, got):
                if g != want:
                    raise se.FileCorrupt(f"shard {pos}: bitrot digest mismatch")
        return rows
