"""ErasureObjects — one erasure set: the core object engine (counterpart of
minio_tpu/erasure/objects.py, reference cmd/erasure-object.go).

PutObject streams blocks through the batched device codec (parity and the
mxsum256 digest of every shard chunk from the two kernels) and fans
bitrot-framed shards out to one writer thread per drive, then commits with
write-quorum accounting. GetObject elects metadata by quorum, reads any k
shards data-first, verifies every chunk read in one digest launch per
batch, and reconstructs through the codec only when shards are missing or
corrupt. Objects up to INLINE_DATA_LIMIT live inside the journal.

The on-disk result is the JAX package's: same shard placement (hash_order),
same part files, same journals, so a drive set written by either package
is served by the other.

Left for later slices (ROADMAP.md): multipart, listing, versioning, the
batch planes, per-drive deadlines and hedged reads, the read-ahead
producer, reclaim capsules for undoing a displaced version, MRF.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
import uuid
from contextlib import contextmanager
from typing import BinaryIO, Iterator

from minio_tpu_torch.erasure.codec import (BATCH_BLOCKS, DEFAULT_BLOCK_SIZE,
                                           ErasureCodec)
from minio_tpu_torch.erasure.healing import HealingMixin
from minio_tpu_torch.erasure.metadata import (find_fileinfo_in_quorum,
                                              hash_order, parallel_map,
                                              reduce_write_quorum,
                                              shuffle_by_distribution)
from minio_tpu_torch.erasure.types import BucketInfo, ObjectInfo, ObjectOptions
from minio_tpu_torch.ops import bitrot
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.fileinfo import (ChecksumInfo, ErasureInfo,
                                              FileInfo, PartInfo)
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se

SYS_VOL = ".mtpu.sys"

# Objects at or below this size are inlined into the journal instead of
# getting shard files (reference inlines small objects in xl.meta v2).
INLINE_DATA_LIMIT = 16 << 10

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


class _KeyLocks:
    """Per-(bucket, object) mutex around mutating commits (the in-process
    role of the reference's namespace lock, cmd/namespace-lock.go:48)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._locks: dict[tuple[str, str], list] = {}  # key -> [lock, refs]

    @contextmanager
    def lock(self, bucket: str, obj: str):
        key = (bucket, obj)
        with self._mu:
            ent = self._locks.setdefault(key, [threading.Lock(), 0])
            ent[1] += 1
        try:
            with ent[0]:
                yield
        finally:
            with self._mu:
                ent[1] -= 1
                if ent[1] == 0:
                    del self._locks[key]


class ErasureObjects(HealingMixin):
    def __init__(self, drives: list[StorageAPI], parity: int | None = None,
                 block_size: int = DEFAULT_BLOCK_SIZE, device="cuda"):
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
        # Objects written with another registered algorithm stay readable:
        # each version names its own in its checksums.
        self.bitrot_algorithm = bitrot.device_default_algorithm()
        self.nslock = _KeyLocks()

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
        results = parallel_map([lambda d=d: d.make_vol(bucket) for d in self.drives])
        if sum(isinstance(r, se.VolumeExists) for r in results) \
                >= self._write_quorum_meta():
            raise se.BucketExists(bucket)
        results = [None if isinstance(r, se.VolumeExists) else r for r in results]
        reduce_write_quorum(results, self._write_quorum_meta(), bucket)

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        results = parallel_map([lambda d=d: d.stat_vol(bucket) for d in self.drives])
        for r in results:
            if not isinstance(r, Exception):
                return BucketInfo(r.name, r.created)
        if any(isinstance(r, se.VolumeNotFound) for r in results):
            raise se.BucketNotFound(bucket)
        raise se.BucketNotFound(bucket, "", "no drive answered")

    # ------------------------------------------------------------------
    # put (cmd/erasure-object.go:606-810)
    # ------------------------------------------------------------------

    def put_object(self, bucket: str, obj: str, data: BinaryIO, size: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        _validate_object_name(obj)
        self.get_bucket_info(bucket)
        m = self.parity
        k = self.n - m
        write_quorum = self._write_quorum_data(m)

        fi = FileInfo.new(bucket, obj)
        fi.mod_time = time.time()
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
            with self.nslock.lock(bucket, obj):
                outcomes = parallel_map([
                    lambda d=d: d.write_metadata(bucket, obj, fi)
                    for d in shuffled])
                try:
                    reduce_write_quorum(outcomes, write_quorum, bucket, obj)
                except se.ObjectError:
                    self._undo_commit(shuffled, outcomes, bucket, obj, fi)
                    raise
            return _fi_to_object_info(bucket, obj, fi)

        tmp_rel = f"tmp/{uuid.uuid4().hex}"

        def cleanup_tmp():
            parallel_map([lambda d=d: d.delete(SYS_VOL, tmp_rel, recursive=True)
                          for d in shuffled])

        try:
            total, md5_hex, errs = self._fan_out_encode(
                shuffled, f"{tmp_rel}/part.1", data, size, codec, write_quorum,
                bucket, obj, first_block)
        except (se.StorageError, se.ObjectError):
            cleanup_tmp()
            raise
        if size >= 0 and total != size:
            cleanup_tmp()
            raise se.IncompleteBody(bucket, obj, f"got {total} of {size} bytes")
        fi.size = total
        fi.metadata.setdefault("etag", md5_hex)
        fi.parts = [PartInfo(1, total, total, fi.mod_time)]

        def commit(i: int, drive: StorageAPI):
            if errs[i] is not None:
                raise errs[i]
            drive.rename_data(SYS_VOL, tmp_rel, _clone_for_drive(fi, i + 1),
                              bucket, obj)

        with self.nslock.lock(bucket, obj):
            outcomes = parallel_map([lambda i=i, d=d: commit(i, d)
                                     for i, d in enumerate(shuffled)])
            try:
                reduce_write_quorum(outcomes, write_quorum, bucket, obj)
            except se.ObjectError:
                self._undo_commit(shuffled, outcomes, bucket, obj, fi)
                cleanup_tmp()
                raise
        return _fi_to_object_info(bucket, obj, fi)

    def _undo_commit(self, shuffled, outcomes, bucket, obj, fi) -> None:
        """Below write quorum: drop the version from the drives that did
        commit, so no listing or read sees a below-quorum object."""
        target = FileInfo(volume=bucket, name=obj, version_id=fi.version_id,
                          data_dir=fi.data_dir)
        parallel_map([lambda d=d: d.delete_version(bucket, obj, target)
                      for d, o in zip(shuffled, outcomes)
                      if not isinstance(o, Exception)])

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

        def writer(i: int, drive: StorageAPI):
            try:
                drive.create_file(SYS_VOL, rel, bitrot.frame_records(
                    iter(qs[i].get, _WRITE_SENTINEL)))
            except Exception as e:  # noqa: BLE001 - per-drive failure is data
                errs[i] = e
                while qs[i].get() is not _WRITE_SENTINEL:
                    pass   # drain so the producer never blocks on a dead drive

        threads = [threading.Thread(target=writer, args=(i, d), daemon=True,
                                    name=f"shard-writer-{i}")
                   for i, d in enumerate(shuffled)]
        for t in threads:
            t.start()

        md5 = hashlib.md5()
        total = 0
        pending: list = []

        def drain_one() -> None:
            chunk_rows, dig_rows = pending.pop(0).wait()
            for bi, chunks in enumerate(chunk_rows):
                for i in range(self.n):
                    qs[i].put((dig_rows[bi][i], chunks[i]))
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
                    pending.append(codec.begin_encode(batch))
                    batch = []
                    if len(pending) >= 3:
                        drain_one()
                remaining = bs if size < 0 else min(bs, size - total)
                block = _read_full(data, remaining)
            if batch:
                pending.append(codec.begin_encode(batch))
            while pending:
                drain_one()
        finally:
            for q in qs:
                q.put(_WRITE_SENTINEL)
            for t in threads:
                t.join()
        return total, md5.hexdigest(), errs

    # ------------------------------------------------------------------
    # get (cmd/erasure-object.go:137-358)
    # ------------------------------------------------------------------

    def _read_quorum_fileinfo(self, bucket: str, obj: str,
                              version_id: str = "") -> FileInfo:
        results = parallel_map([lambda d=d: d.read_version(bucket, obj, version_id)
                                for d in self.drives])
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

    def get_object_info(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
        if fi.deleted:
            raise se.ObjectNotFound(bucket, obj)
        return _fi_to_object_info(bucket, obj, fi)

    def get_object_reader(self, bucket: str, obj: str,
                          opts: ObjectOptions | None = None):
        """ONE quorum metadata read for info + data: returns (info,
        open_range), where open_range(offset, length) streams the object's
        bytes from the already-elected version (the HTTP layer needs the
        size before it can resolve a Range)."""
        opts = opts or ObjectOptions()
        fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
        if fi.deleted:
            raise se.ObjectNotFound(bucket, obj)

        def open_range(offset: int = 0, length: int = -1) -> Iterator[bytes]:
            if length < 0:
                length = fi.size - offset
            if offset < 0 or length < 0 or offset + length > fi.size:
                raise se.InvalidRange(bucket, obj,
                                      f"[{offset}, {offset + length}) of {fi.size}")
            if fi.inline_data:
                return iter([fi.inline_data[offset:offset + length]])
            return self._stream_erasure(bucket, obj, fi, offset, length)

        return _fi_to_object_info(bucket, obj, fi), open_range

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
        dead: set[int] = {i for i, d in enumerate(shuffled) if not d.is_online()}

        def open_reader(i: int) -> bitrot.BitrotReader:
            if readers[i] is None:
                f = shuffled[i].read_file_stream(bucket, rel)
                readers[i] = bitrot.BitrotReader(f, shard_data_size,
                                                 codec.shard_size(), algo)
            return readers[i]

        first_block = offset // bs
        last_block = (offset + length - 1) // bs
        try:
            bi = first_block
            while bi <= last_block:
                ids = list(range(bi, min(bi + BATCH_BLOCKS, last_block + 1)))
                lens = [min(bs, part.size - b * bs) for b in ids]
                while True:
                    # Data shards first, parity only on demand (the staggered
                    # any-k read, cmd/erasure-decode.go:120-188).
                    chosen = [i for i in range(n) if i not in dead][:k]
                    if len(chosen) < k:
                        raise se.InsufficientReadQuorum(bucket, obj,
                                                        "not enough live shards")
                    try:
                        rows = self._read_chunk_rows(open_reader, readers, chosen,
                                                     ids, lens, codec, n, dead, algo)
                        break
                    except se.StorageError:
                        continue   # a shard died: re-choose and retry the batch
                decoded = codec.decode_blocks(rows, lens)
                for j, b in enumerate(ids):
                    blk_start = b * bs
                    lo = max(offset, blk_start) - blk_start
                    hi = min(offset + length, blk_start + lens[j]) - blk_start
                    if hi > lo:
                        yield from _yield_block_range(decoded[j], lo, hi)
                bi = ids[-1] + 1
        finally:
            for r in readers:
                if r is not None:
                    r.src.close()

    def _read_chunk_rows(self, open_reader, readers, chosen, batch_ids, block_lens,
                         codec: ErasureCodec, n: int, dead: set, algo: str):
        """Read one batch of chunk rows from the chosen shards in parallel,
        then verify every mxsum256 chunk in ONE digest launch (the read
        path's form of the reference's verify-every-ReadAt,
        cmd/bitrot-streaming.go:115-158). A failed or corrupt shard is
        marked dead and StorageError raised, so the caller re-selects."""
        chunk_lens = [-(-bl // codec.k) for bl in block_lens]
        batched = algo == "mxsum256"

        def read_shard(i: int) -> list:
            r = open_reader(i)
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

        results = parallel_map([lambda i=i: read_shard(i) for i in chosen])
        failed = [(i, r) for i, r in zip(chosen, results) if isinstance(r, Exception)]
        for i, r in failed:
            if not isinstance(r, (se.StorageError, OSError)):
                raise r
            _retire(readers, dead, i)
        if failed:
            raise se.FileCorrupt(f"shard {failed[0][0]}: {failed[0][1]}")
        rows = [[None] * n for _ in batch_ids]
        records = []
        for i, res in zip(chosen, results):
            for j, (want, chunk) in enumerate(res):
                rows[j][i] = chunk
                if batched:
                    records.append((i, want, chunk))
        if records:
            got = codec.digest_chunks([c for _i, _w, c in records], codec.shard_size())
            for (i, want, _c), g in zip(records, got):
                if g != want:
                    _retire(readers, dead, i)
                    raise se.FileCorrupt(f"shard {i}: bitrot digest mismatch")
        return rows

    # ------------------------------------------------------------------
    # delete (cmd/erasure-object.go:894-1031)
    # ------------------------------------------------------------------

    def delete_object(self, bucket: str, obj: str,
                      opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        self.get_bucket_info(bucket)
        with self.nslock.lock(bucket, obj):
            fi = self._read_quorum_fileinfo(bucket, obj, opts.version_id)
            target = FileInfo(volume=bucket, name=obj, version_id=opts.version_id,
                              data_dir=fi.data_dir)
            results = parallel_map([lambda d=d: d.delete_version(bucket, obj, target)
                                    for d in self.drives])
            # A drive that never had the version is as good as deleted on it.
            results = [None if isinstance(r, (se.FileNotFound, se.FileVersionNotFound))
                       else r for r in results]
            reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)
        return ObjectInfo(bucket=bucket, name=obj, version_id=opts.version_id,
                          delete_marker=fi.deleted)


def _retire(readers: list, dead: set, i: int) -> None:
    """Mark shard i dead for this stream and close its reader."""
    dead.add(i)
    if readers[i] is not None:
        readers[i].src.close()
        readers[i] = None


def _fi_to_object_info(bucket: str, obj: str, fi: FileInfo) -> ObjectInfo:
    """FileInfo -> ObjectInfo (reference fileInfo.ToObjectInfo)."""
    return ObjectInfo(
        bucket=bucket, name=obj, mod_time=fi.mod_time, size=fi.size,
        etag=fi.metadata.get("etag", ""), version_id=fi.version_id,
        is_latest=fi.is_latest, delete_marker=fi.deleted,
        content_type=fi.metadata.get("content-type", ""),
        user_defined={k: v for k, v in fi.metadata.items()
                      if k not in ("etag", "content-type")},
        parity_blocks=fi.erasure.parity_blocks,
        data_blocks=fi.erasure.data_blocks, num_versions=fi.num_versions)


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
