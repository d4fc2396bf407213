"""ErasureSets — several erasure sets behind one object namespace
(counterpart of minio_tpu/erasure/sets.py, reference erasureSets,
cmd/erasure-sets.go:55).

Each object is routed to one set by sipHashMod(key, set count, deployment
id) (:697-736), the same function as the JAX package's, so both packages
find every object on the same set's drives. Bucket calls fan out to every
set. Each set is a whole ErasureObjects engine: quorums, multipart, heal
and the MRF queue (enable_mrf) stay per set. A listing k-way merges the
sets' sorted journal streams; system documents (the metacache's blocks)
live on set 0. `format` is the elected format.json, which heal_format
(run by the AutoHealer) needs to claim a replaced drive live.

Once the format is known, every drive is wrapped as in the JAX package:
a disk-ID check (a swapped drive answers DiskNotFound) under a health
checker (adaptive per-call deadlines, ONLINE -> FAULTY -> OFFLINE, a
background probe whose restore leaves a healing tracker for the
AutoHealer). With `MTPU_CHAOS_DRIVE_WRAP=1` each local drive also gets an
inert NaughtyDisk (chaos/naughty.py) between the two, which the guarded
admin `faults` route programs, so injected hangs and errors run through
the real ONLINE -> FAULTY -> OFFLINE machinery. The ILM tier calls
(transition_version, restore_transitioned) go to the object's set.
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

from minio_tpu_torch.chaos import naughty
from minio_tpu_torch.erasure import listing
from minio_tpu_torch.erasure.format import init_format_erasure
from minio_tpu_torch.erasure.healing import HealResultItem
from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.erasure.objects import ErasureObjects
from minio_tpu_torch.erasure.types import (BucketInfo, CompletePart,
                                           DeletedObject, ListObjectsInfo,
                                           ListObjectVersionsInfo,
                                           MultipartInfo, ObjectInfo,
                                           ObjectOptions, ObjectToDelete,
                                           PartInfoResult)
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.healthcheck import wrap_with_healthcheck
from minio_tpu_torch.storage.idcheck import wrap_with_id_check
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.xlmeta import XLMeta
from minio_tpu_torch.utils.siphash import sip_hash_mod


def _raise_first(outcomes: list) -> None:
    for o in outcomes:
        if isinstance(o, Exception):
            raise o


class ErasureSets:
    def __init__(self, drives: list[StorageAPI], set_drive_count: int | None = None,
                 parity: int | None = None, enable_mrf: bool = False,
                 can_format_fresh: bool = True, **set_kwargs):
        """`drives` are formatted (or their format read) into sets of
        `set_drive_count` (default: one set); `enable_mrf` and
        `set_kwargs` (block_size, device, bitrot_algorithm, nslock) go to
        every set's engine. In a cluster (dist/cluster.py) `nslock` is the
        dsync namespace lock shared by the sets, and only the node owning
        the first endpoint may mint a fresh format (`can_format_fresh`)."""
        drives = list(drives)
        set_drive_count = set_drive_count or len(drives)
        self.format = init_format_erasure(drives, set_drive_count,
                                          can_format_fresh=can_format_fresh)
        drives = wrap_with_id_check(drives, self.format)
        if naughty.wrap_enabled():
            drives = naughty.wrap_drives(drives)
        drives = wrap_with_healthcheck(drives, self.format)
        self.deployment_id = self.format.deployment_id
        self.set_drive_count = set_drive_count
        self.set_count = len(drives) // set_drive_count
        self.drives = drives
        self.sets: list[ErasureObjects] = [
            ErasureObjects(drives[i * set_drive_count:(i + 1) * set_drive_count],
                           parity=parity, enable_mrf=enable_mrf, **set_kwargs)
            for i in range(self.set_count)]

    def close(self) -> None:
        """Stop every set's MRF thread."""
        for s in self.sets:
            s.close()

    @property
    def device(self):
        return self.sets[0].device

    def get_hashed_set(self, obj: str) -> ErasureObjects:
        return self.sets[sip_hash_mod(obj, self.set_count, self.deployment_id)]

    # -- buckets: every set --

    def make_bucket(self, bucket: str) -> None:
        _raise_first(parallel_map([lambda s=s: s.make_bucket(bucket)
                                   for s in self.sets]))

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.sets[0].get_bucket_info(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        return self.sets[0].list_buckets()

    def delete_bucket(self, bucket: str) -> None:
        _raise_first(parallel_map([lambda s=s: s.delete_bucket(bucket)
                                   for s in self.sets]))

    # -- objects: the hashed set --

    def put_object(self, bucket: str, obj: str, data: BinaryIO, size: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).put_object(bucket, obj, data, size, opts)

    def get_object(self, bucket: str, obj: str, offset: int = 0, length: int = -1,
                   opts: ObjectOptions | None = None):
        return self.get_hashed_set(obj).get_object(bucket, obj, offset, length, opts)

    def get_object_reader(self, bucket: str, obj: str,
                          opts: ObjectOptions | None = None):
        return self.get_hashed_set(obj).get_object_reader(bucket, obj, opts)

    def get_object_info(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).get_object_info(bucket, obj, opts)

    def delete_object(self, bucket: str, obj: str,
                      opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).delete_object(bucket, obj, opts)

    def delete_objects(self, bucket: str, objects: list[ObjectToDelete],
                       opts: ObjectOptions | None = None
                       ) -> list[DeletedObject | Exception]:
        return listing.bulk_delete(self.delete_object, bucket, objects, opts)

    def put_object_tags(self, bucket: str, obj: str, tags: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).put_object_tags(bucket, obj, tags, opts)

    def put_object_metadata(self, bucket: str, obj: str, updates,
                            opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).put_object_metadata(bucket, obj, updates, opts)

    def get_object_tags(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> str:
        return self.get_hashed_set(obj).get_object_tags(bucket, obj, opts)

    def delete_object_tags(self, bucket: str, obj: str,
                           opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).delete_object_tags(bucket, obj, opts)

    def transition_version(self, bucket: str, obj: str, version_id: str,
                           tier_name: str, tier_key: str, storage_class: str = "",
                           expect_mod_time: float | None = None) -> None:
        return self.get_hashed_set(obj).transition_version(
            bucket, obj, version_id, tier_name, tier_key, storage_class,
            expect_mod_time)

    def restore_transitioned(self, bucket: str, obj: str, version_id: str = "") -> None:
        return self.get_hashed_set(obj).restore_transitioned(bucket, obj, version_id)

    def latest_fileinfo(self, bucket: str, obj: str, version_id: str = "") -> FileInfo:
        return self.get_hashed_set(obj).latest_fileinfo(bucket, obj, version_id)

    # -- system documents: set 0 (small mirrored docs need no sharding) --

    def read_sys_config(self, path: str) -> bytes:
        return self.sets[0].read_sys_config(path)

    def write_sys_config(self, path: str, data: bytes) -> None:
        self.sets[0].write_sys_config(path, data)

    def delete_sys_config(self, path: str) -> None:
        self.sets[0].delete_sys_config(path)

    def list_sys_config(self, prefix: str = "") -> list[str]:
        return self.sets[0].list_sys_config(prefix)

    def sys_config_signature(self, path: str) -> tuple:
        return self.sets[0].sys_config_signature(path)

    # -- listing: merged view across sets --

    def stream_journals(self, bucket: str, prefix: str = "",
                        start_after: str = ""):
        """Sorted (name, journal) stream across every set: each set's
        drive-merged stream k-way merged again (an object routes to one
        set, so duplicates arise only from topology changes; newest wins).
        O(sets x drives) memory (cmd/metacache-server-pool.go:59)."""
        return listing.merge_journal_streams(
            [s.stream_journals(bucket, prefix, start_after) for s in self.sets])

    def merged_journals(self, bucket: str, prefix: str) -> dict[str, XLMeta]:
        return dict(self.stream_journals(bucket, prefix))

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000) -> ListObjectsInfo:
        self.get_bucket_info(bucket)
        return listing.paginate_objects(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter),
            lambda name, fi: listing.fi_to_object_info(bucket, name, fi),
            prefix, marker, delimiter, max_keys)

    def list_object_versions(self, bucket: str, prefix: str = "", marker: str = "",
                             version_marker: str = "", delimiter: str = "",
                             max_keys: int = 1000) -> ListObjectVersionsInfo:
        self.get_bucket_info(bucket)
        return listing.paginate_versions(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter, version_marker),
            lambda name, fi: listing.fi_to_object_info(bucket, name, fi),
            prefix, marker, version_marker, delimiter, max_keys)

    # -- multipart: the hashed set, uploads listed across sets --

    def new_multipart_upload(self, bucket: str, obj: str,
                             opts: ObjectOptions | None = None) -> str:
        return self.get_hashed_set(obj).new_multipart_upload(bucket, obj, opts)

    def put_object_part(self, bucket: str, obj: str, upload_id: str,
                        part_number: int, data: BinaryIO, size: int = -1,
                        opts: ObjectOptions | None = None) -> PartInfoResult:
        return self.get_hashed_set(obj).put_object_part(
            bucket, obj, upload_id, part_number, data, size, opts)

    def get_multipart_info(self, bucket: str, obj: str, upload_id: str):
        return self.get_hashed_set(obj).get_multipart_info(bucket, obj, upload_id)

    def list_parts(self, bucket: str, obj: str, upload_id: str,
                   part_marker: int = 0, max_parts: int = 1000):
        return self.get_hashed_set(obj).list_parts(bucket, obj, upload_id,
                                                   part_marker, max_parts)

    def list_multipart_uploads(self, bucket: str, prefix: str = "",
                               max_uploads: int = 1000) -> list[MultipartInfo]:
        results = parallel_map([
            lambda s=s: s.list_multipart_uploads(bucket, prefix, max_uploads)
            for s in self.sets])
        if all(isinstance(r, Exception) for r in results):
            raise results[0]
        out = [u for r in results if not isinstance(r, Exception) for u in r]
        return sorted(out, key=lambda u: (u.object, u.initiated))[:max_uploads]

    def abort_multipart_upload(self, bucket: str, obj: str, upload_id: str) -> None:
        self.get_hashed_set(obj).abort_multipart_upload(bucket, obj, upload_id)

    def complete_multipart_upload(self, bucket: str, obj: str, upload_id: str,
                                  parts: list[CompletePart],
                                  opts: ObjectOptions | None = None) -> ObjectInfo:
        return self.get_hashed_set(obj).complete_multipart_upload(
            bucket, obj, upload_id, parts, opts)

    # -- health --

    def all_drives(self) -> list:
        return [d for s in self.sets for d in s.drives]

    def health(self) -> dict:
        """Per-set drive health: online counts against write quorum
        (minio_tpu/erasure/sets.py:326)."""
        per_set = [s.health() for s in self.sets]
        return {"healthy": all(h["healthy"] for h in per_set),
                "sets": [h["sets"][0] for h in per_set]}

    # -- heal --

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> HealResultItem:
        """Every set's heal_bucket, drive states concatenated in set order."""
        results = [s.heal_bucket(bucket, dry_run) for s in self.sets]
        out = results[0]
        for r in results[1:]:
            out.before.extend(r.before)
            out.after.extend(r.after)
            out.disk_count += r.disk_count
        return out

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    **kw) -> HealResultItem:
        """kw: dry_run, remove_dangling, scan_deep."""
        return self.get_hashed_set(obj).heal_object(bucket, obj, version_id, **kw)

    def heal_objects(self, bucket: str, prefix: str = "",
                     **kw) -> Iterator[HealResultItem | Exception]:
        """Each set's heal_objects in turn, set 0 first (the JAX package's
        order, not one merged name order)."""
        for s in self.sets:
            yield from s.heal_objects(bucket, prefix, **kw)
