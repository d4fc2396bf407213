"""Multipart uploads: per-part erasure streams composed at complete time
(counterpart of minio_tpu/erasure/multipart.py, reference
cmd/erasure-multipart.go).

An upload session lives under the sys volume at
multipart/<key-hash>/<upload-id>/ on every drive of the set: upload.json
(the session), part.N (one bitrot-framed shard file per drive) and
part.N.json (size, md5, mod_time). Each part is its own erasure stream
through _fan_out_encode, so every part byte goes through the parity and
digest kernels. CompleteMultipartUpload validates the client's part list
against the stored part journals, moves the part files into a fresh data
dir and commits the version with rename_data under the key lock, undoing
the commit on the drives that made it when quorum is missed.

The session documents are the JAX package's bytes (same keys, same
order, same json.dumps), so a session begun by either package can be
continued and completed by the other. On a versioned bucket Complete
gives the object a fresh version id. UploadPartCopy is a part PUT fed by
the S3 layer from a GET of the source range.

A Complete that reaches quorum with drives missing queues the object on
the set's MRF healer, as a PUT does.

Session and part journals ride each drive's WAL blob lane when the
metadata plane is armed (sysstore.mirror_write_all), and a session the
JAX package left in its WAL is replayed when the port mounts the drives.

Left for later slices (ROADMAP.md): SSE parts, the dsync lease.
"""

from __future__ import annotations

import hashlib
import json
import time
import uuid
from typing import BinaryIO

from minio_tpu_torch.erasure.codec import ErasureCodec
from minio_tpu_torch.erasure.metadata import (hash_order, parallel_map,
                                              reduce_write_quorum,
                                              shuffle_by_distribution)
from minio_tpu_torch.erasure.sysstore import mirror_write_all
from minio_tpu_torch.erasure.types import (CompletePart, MultipartInfo,
                                           ObjectInfo, ObjectOptions,
                                           PartInfoResult)
from minio_tpu_torch.storage.fileinfo import (ChecksumInfo, ErasureInfo,
                                              FileInfo, PartInfo)
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils import errors as se

MP_ROOT = "multipart"
MIN_PART_SIZE = 5 << 20  # S3 minimum for all but the last part
MAX_PARTS = 10_000


def _key_hash(bucket: str, obj: str) -> str:
    return hashlib.sha256(f"{bucket}/{obj}".encode()).hexdigest()[:32]


def multipart_etag(part_etags: list[str]) -> str:
    """S3 multipart ETag: md5 over the binary concatenation of the part
    md5s, suffixed with the part count."""
    md5 = hashlib.md5()
    for e in part_etags:
        md5.update(bytes.fromhex(e))
    return f"{md5.hexdigest()}-{len(part_etags)}"


class MultipartMixin:
    """Multipart entry points for ErasureObjects (self provides drives, n,
    parity, block_size, device, bitrot_algorithm, nslock and the quorum
    and commit helpers)."""

    def _mp_dir(self, bucket: str, obj: str, upload_id: str) -> str:
        return f"{MP_ROOT}/{_key_hash(bucket, obj)}/{upload_id}"

    def _elect_json(self, rel: str) -> dict | None:
        """Read a small JSON document from every drive and elect the
        majority content; ties go to the newer mod_time. A drive that
        missed a rewrite within write tolerance never serves stale state."""
        results = parallel_map([lambda d=d: d.read_all(SYS_VOL, rel)
                                for d in self.drives],
                               deadline=self._meta_deadline())
        tally: dict[bytes, tuple[int, bytes]] = {}
        for r in results:
            if isinstance(r, (bytes, bytearray)):
                h = hashlib.sha256(r).digest()
                n, _ = tally.get(h, (0, b""))
                tally[h] = (n + 1, r)
        if not tally:
            return None

        def rank(entry: tuple[int, bytes]):
            count, raw = entry
            try:
                mt = json.loads(raw).get("mod_time", 0.0)
            except ValueError:
                return (-1, 0.0)
            return (count, mt)

        _count, best = max(tally.values(), key=rank)
        try:
            return json.loads(best)
        except ValueError:
            return None

    def _read_mp_meta(self, bucket: str, obj: str, upload_id: str) -> dict:
        meta = self._elect_json(f"{self._mp_dir(bucket, obj, upload_id)}/upload.json")
        if meta is not None and meta.get("bucket") == bucket \
                and meta.get("object") == obj:
            return meta
        raise se.InvalidUploadID(bucket, obj, f"upload {upload_id} not found")

    # ------------------------------------------------------------------

    def new_multipart_upload(self, bucket: str, obj: str,
                             opts: ObjectOptions | None = None) -> str:
        opts = opts or ObjectOptions()
        self.get_bucket_info(bucket)
        upload_id = uuid.uuid4().hex
        meta = {
            "bucket": bucket,
            "object": obj,
            "upload_id": upload_id,
            "initiated": time.time(),
            "user_defined": dict(opts.user_defined),
            "distribution": hash_order(f"{bucket}/{obj}", self.n),
            "parity": self.parity_for_class(
                opts.user_defined.get("x-amz-storage-class", "")),
            "block_size": self.block_size,
            "bitrot": self.bitrot_algorithm,
        }
        results = mirror_write_all(
            self.drives, SYS_VOL,
            f"{self._mp_dir(bucket, obj, upload_id)}/upload.json",
            json.dumps(meta).encode())
        reduce_write_quorum(results, self._write_quorum_meta(), bucket, obj)
        return upload_id

    def get_multipart_info(self, bucket: str, obj: str,
                           upload_id: str) -> MultipartInfo:
        meta = self._read_mp_meta(bucket, obj, upload_id)
        return MultipartInfo(bucket, obj, upload_id, meta.get("initiated", 0.0),
                             meta.get("user_defined", {}))

    def put_object_part(self, bucket: str, obj: str, upload_id: str,
                        part_number: int, data: BinaryIO, size: int = -1,
                        opts: ObjectOptions | None = None) -> PartInfoResult:
        if not 1 <= part_number <= MAX_PARTS:
            raise se.InvalidPart(bucket, obj, f"part number {part_number}")
        meta = self._read_mp_meta(bucket, obj, upload_id)
        k = self.n - meta["parity"]
        write_quorum = self._write_quorum_data(meta["parity"])
        codec = ErasureCodec(k, meta["parity"], meta["block_size"],
                             device=self.device)
        shuffled = shuffle_by_distribution(self.drives, meta["distribution"])
        mp = self._mp_dir(bucket, obj, upload_id)

        # Encode into a tmp name, then rename into the session, so a
        # re-upload of the same part number never interleaves shards.
        tmp_rel = f"{mp}/tmp-{uuid.uuid4().hex}"

        def cleanup_tmp():
            parallel_map([lambda d=d: d.delete(SYS_VOL, tmp_rel)
                          for d in shuffled],
                         deadline=self._meta_deadline())

        try:
            total, md5_hex, errs = self._fan_out_encode(
                shuffled, tmp_rel, data, size, codec, write_quorum, bucket,
                obj, b"")
        except (se.StorageError, se.ObjectError):
            cleanup_tmp()
            raise
        if size >= 0 and total != size:
            cleanup_tmp()
            raise se.IncompleteBody(bucket, obj, f"got {total} of {size} bytes")

        mod_time = time.time()

        def commit(i, drive):
            if errs[i] is not None:
                raise errs[i]
            drive.rename_file(SYS_VOL, tmp_rel, SYS_VOL, f"{mp}/part.{part_number}")

        # No fan-out deadline, as in the JAX package: each rename is bounded
        # at the drive, and a commit stamped timed out would race the
        # cleanup below (renaming tmp_rel into part.N after its delete).
        outcomes = parallel_map([lambda i=i, d=d: commit(i, d)
                                 for i, d in enumerate(shuffled)])
        # The part journal goes only to drives whose shard rename landed,
        # after it: a part.N.json never elects without its shard data.
        ok_idx = [i for i, o in enumerate(outcomes) if not isinstance(o, Exception)]
        pj_out = mirror_write_all(
            [shuffled[i] for i in ok_idx], SYS_VOL, f"{mp}/part.{part_number}.json",
            json.dumps({"size": total, "etag": md5_hex,
                        "mod_time": mod_time}).encode())
        for i, o in zip(ok_idx, pj_out):
            if isinstance(o, Exception):
                outcomes[i] = o
        try:
            reduce_write_quorum(outcomes, write_quorum, bucket, obj)
        except se.ObjectError:
            cleanup_tmp()
            raise
        return PartInfoResult(part_number, md5_hex, total, total, mod_time)

    def list_parts(self, bucket: str, obj: str, upload_id: str,
                   part_marker: int = 0, max_parts: int = 1000
                   ) -> list[PartInfoResult]:
        mp = self._mp_dir(bucket, obj, upload_id)
        self._read_mp_meta(bucket, obj, upload_id)
        # Union of part numbers across drives: one drive may have missed a
        # part within quorum tolerance.
        listings = parallel_map([lambda d=d: d.list_dir(SYS_VOL, mp)
                                 for d in self.drives],
                                deadline=self._meta_deadline())
        numbers: set[int] = set()
        for names in listings:
            if isinstance(names, Exception):
                continue
            numbers.update(int(n[5:-5]) for n in names
                           if n.startswith("part.") and n.endswith(".json"))
        out: list[PartInfoResult] = []
        for num in sorted(numbers):
            if num <= part_marker or len(out) >= max_parts:
                continue
            pj = self._elect_json(f"{mp}/part.{num}.json")
            if pj is None:
                continue
            out.append(PartInfoResult(num, pj["etag"], pj["size"], pj["size"],
                                      pj["mod_time"]))
        return out

    def list_multipart_uploads(self, bucket: str, prefix: str = "",
                               max_uploads: int = 1000) -> list[MultipartInfo]:
        self.get_bucket_info(bucket)
        # Union of session dirs across all drives, then elect each.
        sessions: set[str] = set()
        listings = parallel_map([lambda d=d: d.list_dir(SYS_VOL, MP_ROOT)
                                 for d in self.drives],
                                deadline=self._meta_deadline())
        for drive, hash_dirs in zip(self.drives, listings):
            if isinstance(hash_dirs, Exception):
                continue
            for hd in hash_dirs:
                hd = hd.rstrip("/")
                try:
                    uploads = drive.list_dir(SYS_VOL, f"{MP_ROOT}/{hd}")
                except se.StorageError:
                    continue
                sessions.update(f"{MP_ROOT}/{hd}/{u.rstrip('/')}" for u in uploads)
        out: list[MultipartInfo] = []
        for sess in sorted(sessions):
            meta = self._elect_json(f"{sess}/upload.json")
            if meta is None or meta.get("bucket") != bucket:
                continue
            if prefix and not meta.get("object", "").startswith(prefix):
                continue
            out.append(MultipartInfo(bucket, meta["object"], meta["upload_id"],
                                     meta.get("initiated", 0.0),
                                     meta.get("user_defined", {})))
            if len(out) >= max_uploads:
                break
        return sorted(out, key=lambda u: (u.object, u.initiated))

    def abort_multipart_upload(self, bucket: str, obj: str, upload_id: str) -> None:
        self._read_mp_meta(bucket, obj, upload_id)
        mp = self._mp_dir(bucket, obj, upload_id)
        # A session's rmtree is O(parts) of I/O: the data deadline.
        parallel_map([lambda d=d: d.delete(SYS_VOL, mp, recursive=True)
                      for d in self.drives],
                     deadline=self._data_deadline())

    def complete_multipart_upload(self, bucket: str, obj: str, upload_id: str,
                                  parts: list[CompletePart],
                                  opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        meta = self._read_mp_meta(bucket, obj, upload_id)
        if not parts:
            raise se.InvalidPart(bucket, obj, "empty part list")
        numbers = [p.part_number for p in parts]
        if numbers != sorted(numbers) or len(set(numbers)) != len(numbers):
            raise se.InvalidPart(bucket, obj, "parts out of order")

        k = self.n - meta["parity"]
        write_quorum = self._write_quorum_data(meta["parity"])
        mp = self._mp_dir(bucket, obj, upload_id)
        shuffled = shuffle_by_distribution(self.drives, meta["distribution"])

        # Validate against the stored (majority-elected) part journals.
        stored: dict[int, dict] = {}
        for p in parts:
            pj = self._elect_json(f"{mp}/part.{p.part_number}.json")
            if pj is None:
                raise se.InvalidPart(bucket, obj, f"part {p.part_number} not uploaded")
            if pj["etag"] != p.etag.strip('"'):
                raise se.InvalidPart(bucket, obj, f"part {p.part_number} etag mismatch")
            stored[p.part_number] = pj
        for p in parts[:-1]:
            if stored[p.part_number]["size"] < MIN_PART_SIZE:
                raise se.PartTooSmall(bucket, obj, f"part {p.part_number}")

        fi = FileInfo.new(bucket, obj)
        if opts.versioned:
            # A versioned Complete adds a version (multipart.py:328).
            fi.version_id = opts.version_id or str(uuid.uuid4())
        fi.mod_time = opts.mod_time or time.time()
        fi.metadata = dict(meta.get("user_defined", {}))
        fi.metadata["etag"] = multipart_etag([p.etag.strip('"') for p in parts])
        fi.size = sum(stored[p.part_number]["size"] for p in parts)
        fi.parts = [PartInfo(p.part_number, stored[p.part_number]["size"],
                             stored[p.part_number]["size"],
                             stored[p.part_number]["mod_time"],
                             stored[p.part_number]["etag"]) for p in parts]
        fi.erasure = ErasureInfo(
            data_blocks=k, parity_blocks=meta["parity"],
            block_size=meta["block_size"], distribution=meta["distribution"],
            checksums=[ChecksumInfo(p.part_number,
                                    meta.get("bitrot", self.bitrot_algorithm))
                       for p in parts])

        tmp_rel = f"tmp/{uuid.uuid4().hex}"
        tokens: list = [None] * len(shuffled)

        def commit(i, drive):
            for p in parts:
                drive.rename_file(SYS_VOL, f"{mp}/part.{p.part_number}",
                                  SYS_VOL, f"{tmp_rel}/part.{p.part_number}")
            f = fi.clone()
            f.erasure.index = i + 1
            tokens[i] = drive.rename_data(SYS_VOL, tmp_rel, f, bucket, obj,
                                          defer_reclaim=True)

        # The quorum decision and any undo stay under the key lock: the
        # undo mutates the live namespace, and a PUT landing between the
        # commit and its undo must never lose its acknowledged version.
        with self.nslock.lock(bucket, obj) as lease:
            self._check_put_precondition(bucket, obj, opts)
            # No fan-out deadline, as in the JAX package: a commit is
            # O(parts) renames, each bounded at the drive, and one stamped
            # timed out would race _restore_session's rollback.
            outcomes = parallel_map([lambda i=i, d=d: commit(i, d)
                                     for i, d in enumerate(shuffled)])
            # Some drives moved, whatever the outcome: drop the residence.
            self._meta_invalidate(bucket, obj)
            try:
                reduce_write_quorum(outcomes, write_quorum, bucket, obj)
            except se.ObjectError:
                self._restore_session(shuffled, outcomes, tokens, fi, parts,
                                      mp, tmp_rel, bucket, obj)
                raise
            if not lease.held:
                # The dsync lock lost its refresh quorum mid-commit
                # (minio_tpu/erasure/multipart.py:427): roll back.
                self._restore_session(shuffled, outcomes, tokens, fi, parts,
                                      mp, tmp_rel, bucket, obj)
                raise se.OperationTimedOut(
                    bucket, obj, "dsync lock quorum lost during commit; "
                    "write rolled back")

        # Committed: drop what the commit displaced, the tmp leftovers of
        # drives whose commit failed, and the session.
        def post_commit(i, drive):
            if isinstance(outcomes[i], Exception):
                drive.delete(SYS_VOL, tmp_rel, recursive=True)
            elif tokens[i]:
                drive.commit_rename(tokens[i])

        # Both reclaim O(parts) trees: the data deadline.
        parallel_map([lambda i=i, d=d: post_commit(i, d)
                      for i, d in enumerate(shuffled)],
                     deadline=self._data_deadline())
        parallel_map([lambda d=d: d.delete(SYS_VOL, mp, recursive=True)
                      for d in self.drives],
                     deadline=self._data_deadline())
        self._queue_partial(bucket, obj, fi, outcomes)
        return self._fi_to_object_info(bucket, obj, fi)

    def _restore_session(self, shuffled, outcomes, tokens, fi, parts, mp,
                         tmp_rel, bucket, obj) -> None:
        """Below quorum: move the parts back into the session so the client
        can retry Complete (uploaded part data is never lost to a transient
        failure), and undo the rename on the drives that committed, so no
        read sees a below-quorum object."""
        undo_fi = fi.clone()

        def restore(i, drive):
            committed = outcomes[i] is None
            src_vol, src = ((bucket, f"{obj}/{fi.data_dir}") if committed
                            else (SYS_VOL, tmp_rel))
            for p in parts:
                try:
                    drive.rename_file(src_vol, f"{src}/part.{p.part_number}",
                                      SYS_VOL, f"{mp}/part.{p.part_number}")
                except se.StorageError:
                    pass
            if committed:
                try:
                    drive.undo_rename(bucket, obj, undo_fi, tokens[i])
                except se.StorageError:
                    pass
            try:
                drive.delete(SYS_VOL, tmp_rel, recursive=True)
            except se.StorageError:
                pass

        # Runs to completion on every drive (a rollback abandoned midway
        # strands a half-restored session); its calls are drive-bounded.
        parallel_map([lambda i=i, d=d: restore(i, d)
                      for i, d in enumerate(shuffled)])
