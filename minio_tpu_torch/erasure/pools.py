"""ErasureServerPools — pools of erasure sets, the top of the object layer
(counterpart of minio_tpu/erasure/pools.py, reference erasureServerPools,
cmd/erasure-server-pool.go:41).

A write lands in the pool that already holds the object, else in the pool
with the most free bytes (:176-293); reads and deletes go to the pool that
holds the object, found by asking every pool for its newest version; a
multipart call goes to the pool that holds its upload session. With one
pool every call passes straight through.

A listing k-way merges the pools' sorted journal streams. Its first page
renders the walk into the metacache (erasure/metacache.py), whose blocks
serve the continuation pages; PUT, DELETE and Complete mark the bucket
dirty, which retires the streams rendered before them. ListObjectVersions
renders its own stream of versions (kind "v").

A key's versions stay in one pool: the owner probe reads the latest
journal entry, delete markers included, so a delete marker lands in the
pool that holds the key and a versioned re-PUT after it stays there.

Left for later slices (ROADMAP.md): pools from more than one node (dist/).
"""

from __future__ import annotations

from typing import BinaryIO, Iterator

from minio_tpu_torch.erasure import listing
from minio_tpu_torch.erasure import metacache as metacache_mod
from minio_tpu_torch.erasure.healing import HealResultItem
from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.erasure.sets import ErasureSets, _raise_first
from minio_tpu_torch.erasure.types import (BucketInfo, CompletePart,
                                           DeletedObject, ListObjectsInfo,
                                           ListObjectVersionsInfo,
                                           MultipartInfo, ObjectInfo,
                                           ObjectOptions, ObjectToDelete,
                                           PartInfoResult)
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.healthcheck import fleet_deadlines
from minio_tpu_torch.storage.xlmeta import XLMeta
from minio_tpu_torch.utils import errors as se


class ErasureServerPools:
    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("no pools")
        self.pools = pools
        self.metacache = metacache_mod.Metacache(self)

    def close(self) -> None:
        """Stop the metacache's background renderer and every set's MRF
        thread."""
        self.metacache.close()
        for p in self.pools:
            p.close()

    @property
    def device(self):
        return self.pools[0].device

    # -- pool choice --

    @staticmethod
    def _pool_free(pool: ErasureSets) -> int:
        # statvfs alone: the drive id costs a read of format.json. An
        # unreadable or hung drive adds nothing.
        results = parallel_map([lambda d=d: d.disk_info(with_id=False)
                                for d in pool.drives],
                               deadline=fleet_deadlines(pool.drives)[0])
        return sum(r.free for r in results if not isinstance(r, Exception))

    def _get_pool_idx_existing(self, bucket: str, obj: str,
                               version_id: str = "") -> int | None:
        """Index of the pool holding the object's newest version (reference
        getPoolIdxExisting, cmd/erasure-server-pool.go:252)."""
        results = parallel_map([lambda p=p: p.latest_fileinfo(bucket, obj, version_id)
                                for p in self.pools])
        best, best_mt = None, -1.0
        for i, r in enumerate(results):
            if isinstance(r, FileInfo) and r.mod_time > best_mt:
                best, best_mt = i, r.mod_time
        return best

    def _get_pool_for_put(self, bucket: str, obj: str,
                          version_id: str = "") -> ErasureSets:
        if len(self.pools) == 1:
            return self.pools[0]
        existing = self._get_pool_idx_existing(bucket, obj, version_id)
        if existing is not None:
            return self.pools[existing]
        frees = [self._pool_free(p) for p in self.pools]
        return self.pools[max(range(len(frees)), key=frees.__getitem__)]

    def _owning_pool(self, bucket: str, obj: str, version_id: str = "") -> ErasureSets:
        if len(self.pools) == 1:
            return self.pools[0]
        idx = self._get_pool_idx_existing(bucket, obj, version_id)
        if idx is None:
            raise se.ObjectNotFound(bucket, obj)
        return self.pools[idx]

    def pool_of(self, bucket: str, obj: str) -> int:
        """Index of the pool that holds an object."""
        return self.pools.index(self._owning_pool(bucket, obj))

    # -- buckets --

    def make_bucket(self, bucket: str) -> None:
        _raise_first(parallel_map([lambda p=p: p.make_bucket(bucket)
                                   for p in self.pools]))

    def get_bucket_info(self, bucket: str) -> BucketInfo:
        return self.pools[0].get_bucket_info(bucket)

    def list_buckets(self) -> list[BucketInfo]:
        return self.pools[0].list_buckets()

    def delete_bucket(self, bucket: str) -> None:
        _raise_first(parallel_map([lambda p=p: p.delete_bucket(bucket)
                                   for p in self.pools]))

    # -- objects --

    def put_object(self, bucket: str, obj: str, data: BinaryIO, size: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        self.metacache.mark_dirty(bucket)
        return self._get_pool_for_put(bucket, obj, opts.version_id).put_object(
            bucket, obj, data, size, opts)

    def get_object(self, bucket: str, obj: str, offset: int = 0, length: int = -1,
                   opts: ObjectOptions | None = None):
        opts = opts or ObjectOptions()
        return self._owning_pool(bucket, obj, opts.version_id).get_object(
            bucket, obj, offset, length, opts)

    def get_object_reader(self, bucket: str, obj: str,
                          opts: ObjectOptions | None = None):
        opts = opts or ObjectOptions()
        self.get_bucket_info(bucket)
        return self._owning_pool(bucket, obj, opts.version_id).get_object_reader(
            bucket, obj, opts)

    def get_object_info(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        self.get_bucket_info(bucket)
        return self._owning_pool(bucket, obj, opts.version_id).get_object_info(
            bucket, obj, opts)

    def delete_object(self, bucket: str, obj: str,
                      opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        self.metacache.mark_dirty(bucket)
        if opts.versioned and not opts.version_id:
            # A delete marker lands in the pool that owns (or would own)
            # the key (minio_tpu/erasure/pools.py:171-175).
            idx = (self._get_pool_idx_existing(bucket, obj)
                   if len(self.pools) > 1 else 0)
            pool = self.pools[idx] if idx is not None else self.pools[0]
            return pool.delete_object(bucket, obj, opts)
        return self._owning_pool(bucket, obj, opts.version_id).delete_object(
            bucket, obj, opts)

    def delete_objects(self, bucket: str, objects: list[ObjectToDelete],
                       opts: ObjectOptions | None = None
                       ) -> list[DeletedObject | Exception]:
        return listing.bulk_delete(self.delete_object, bucket, objects, opts)

    def put_object_tags(self, bucket: str, obj: str, tags: str,
                        opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        return self._owning_pool(bucket, obj, opts.version_id).put_object_tags(
            bucket, obj, tags, opts)

    def transition_version(self, bucket: str, obj: str, version_id: str,
                           tier_name: str, tier_key: str, storage_class: str = "",
                           expect_mod_time: float | None = None) -> None:
        self.metacache.mark_dirty(bucket)
        return self._owning_pool(bucket, obj, version_id).transition_version(
            bucket, obj, version_id, tier_name, tier_key, storage_class,
            expect_mod_time)

    def restore_transitioned(self, bucket: str, obj: str, version_id: str = "") -> None:
        self.metacache.mark_dirty(bucket)
        return self._owning_pool(bucket, obj, version_id).restore_transitioned(
            bucket, obj, version_id)

    def put_object_metadata(self, bucket: str, obj: str, updates,
                            opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        return self._owning_pool(bucket, obj, opts.version_id).put_object_metadata(
            bucket, obj, updates, opts)

    def get_object_tags(self, bucket: str, obj: str,
                        opts: ObjectOptions | None = None) -> str:
        opts = opts or ObjectOptions()
        return self._owning_pool(bucket, obj, opts.version_id).get_object_tags(
            bucket, obj, opts)

    def delete_object_tags(self, bucket: str, obj: str,
                           opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
        return self._owning_pool(bucket, obj, opts.version_id).delete_object_tags(
            bucket, obj, opts)

    # -- multipart --

    def new_multipart_upload(self, bucket: str, obj: str,
                             opts: ObjectOptions | None = None) -> str:
        return self._get_pool_for_put(bucket, obj).new_multipart_upload(
            bucket, obj, opts)

    def _upload_pool(self, bucket: str, obj: str, upload_id: str) -> ErasureSets:
        for p in self.pools:
            try:
                p.get_hashed_set(obj)._read_mp_meta(bucket, obj, upload_id)
                return p
            except se.InvalidUploadID:
                continue
        raise se.InvalidUploadID(bucket, obj, f"upload {upload_id} not found")

    def put_object_part(self, bucket: str, obj: str, upload_id: str,
                        part_number: int, data: BinaryIO, size: int = -1,
                        opts: ObjectOptions | None = None) -> PartInfoResult:
        return self._upload_pool(bucket, obj, upload_id).put_object_part(
            bucket, obj, upload_id, part_number, data, size, opts)

    def get_multipart_info(self, bucket: str, obj: str, upload_id: str):
        return self._upload_pool(bucket, obj, upload_id).get_multipart_info(
            bucket, obj, upload_id)

    def list_parts(self, bucket: str, obj: str, upload_id: str,
                   part_marker: int = 0, max_parts: int = 1000):
        return self._upload_pool(bucket, obj, upload_id).list_parts(
            bucket, obj, upload_id, part_marker, max_parts)

    def list_multipart_uploads(self, bucket: str, prefix: str = "",
                               max_uploads: int = 1000) -> list[MultipartInfo]:
        out = [u for p in self.pools
               for u in p.list_multipart_uploads(bucket, prefix, max_uploads)]
        return sorted(out, key=lambda u: (u.object, u.initiated))[:max_uploads]

    def abort_multipart_upload(self, bucket: str, obj: str, upload_id: str) -> None:
        self._upload_pool(bucket, obj, upload_id).abort_multipart_upload(
            bucket, obj, upload_id)

    def complete_multipart_upload(self, bucket: str, obj: str, upload_id: str,
                                  parts: list[CompletePart],
                                  opts: ObjectOptions | None = None) -> ObjectInfo:
        self.metacache.mark_dirty(bucket)
        return self._upload_pool(bucket, obj, upload_id).complete_multipart_upload(
            bucket, obj, upload_id, parts, opts)

    # -- listing --

    def stream_journals(self, bucket: str, prefix: str = "",
                        start_after: str = ""):
        """Sorted (name, journal) stream across every pool
        (cmd/metacache-server-pool.go:59): O(pools x sets x drives) memory
        whatever the namespace."""
        return listing.merge_journal_streams(
            [p.stream_journals(bucket, prefix, start_after) for p in self.pools])

    def merged_journals(self, bucket: str, prefix: str) -> dict[str, XLMeta]:
        return dict(self.stream_journals(bucket, prefix))

    # Page 1 persists this many entries before it returns (bounding its
    # latency); a daemon renderer carries the SAME walk on up to
    # METACACHE_MAX_STREAM in blocks, so sequential continuations ride
    # the persisted stream while both sides stay O(block)
    # (cmd/metacache-stream.go).
    METACACHE_MAX_ENTRIES = 10_000
    METACACHE_MAX_STREAM = 1_000_000

    def list_objects(self, bucket: str, prefix: str = "", marker: str = "",
                     delimiter: str = "", max_keys: int = 1000) -> ListObjectsInfo:
        self.get_bucket_info(bucket)
        to_info = lambda name, fi: listing.fi_to_object_info(bucket, name, fi)  # noqa: E731
        # A continuation page seeks into the persisted stream that page 1
        # rendered (cmd/metacache-stream.go).
        if marker:
            cached = self.metacache.entries_from(bucket, prefix, marker)
            if cached is not None:
                it, complete = cached
                try:
                    r = listing.paginate_cached(it, prefix, marker, delimiter,
                                                max_keys)
                except metacache_mod.CacheGone:
                    r = None
                if r is not None and (r.is_truncated or complete):
                    return r
                # A capped stream drained mid-page (or a block vanished):
                # names past the rendered range may exist, so walk.
                self.metacache.misses += 1
        res = listing.paginate_objects(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter),
            to_info, prefix, marker, delimiter, max_keys)
        if (res.is_truncated and not marker
                and not self.metacache.recently_saved(bucket, prefix)):
            # More pages will follow: render a fresh walk into the block
            # stream (sync up to the page-1 bound, then in the background).
            self.metacache.render(
                bucket, prefix,
                listing.iter_entries_from_journals(
                    self.stream_journals(bucket, prefix), to_info),
                kind="o", sync_cap=self.METACACHE_MAX_ENTRIES,
                stream_cap=self.METACACHE_MAX_STREAM)
        return res

    def list_object_versions(self, bucket: str, prefix: str = "", marker: str = "",
                             version_marker: str = "", delimiter: str = "",
                             max_keys: int = 1000) -> ListObjectVersionsInfo:
        """As list_objects, over the stream of versions: page 1 renders a
        kind "v" block stream that continuation pages seek into
        (minio_tpu/erasure/pools.py:332)."""
        self.get_bucket_info(bucket)
        to_info = lambda name, fi: listing.fi_to_object_info(bucket, name, fi)  # noqa: E731
        if marker:
            cached = self.metacache.entries_from(bucket, prefix, marker, kind="v")
            if cached is not None:
                it, complete = cached
                try:
                    r = listing.paginate_versions_cached(
                        it, prefix, marker, version_marker, delimiter, max_keys)
                except metacache_mod.CacheGone:
                    r = None
                if r is not None and (r.is_truncated or complete):
                    return r
                self.metacache.misses += 1
        res = listing.paginate_versions(
            listing.pushdown_stream(
                lambda sa: self.stream_journals(bucket, prefix, sa),
                prefix, marker, delimiter, version_marker),
            to_info, prefix, marker, version_marker, delimiter, max_keys)
        if (res.is_truncated and not marker
                and not self.metacache.recently_saved_versions(bucket, prefix)):
            self.metacache.render(
                bucket, prefix,
                listing.iter_version_entries_from_journals(
                    self.stream_journals(bucket, prefix), to_info),
                kind="v", sync_cap=self.METACACHE_MAX_ENTRIES,
                stream_cap=self.METACACHE_MAX_STREAM)
        return res

    # -- system documents: pool 0 --

    def read_sys_config(self, path: str) -> bytes:
        return self.pools[0].read_sys_config(path)

    def write_sys_config(self, path: str, data: bytes) -> None:
        self.pools[0].write_sys_config(path, data)

    def delete_sys_config(self, path: str) -> None:
        self.pools[0].delete_sys_config(path)

    def list_sys_config(self, prefix: str = "") -> list[str]:
        return self.pools[0].list_sys_config(prefix)

    def sys_config_signature(self, path: str) -> tuple:
        return self.pools[0].sys_config_signature(path)

    # -- health --

    def all_drives(self) -> list:
        return [d for p in self.pools for d in p.all_drives()]

    def health(self) -> dict:
        """Every pool's health (minio_tpu/erasure/pools.py:412)."""
        pools = [p.health() for p in self.pools]
        return {"healthy": all(h["healthy"] for h in pools), "pools": pools}

    # -- heal --

    def heal_bucket(self, bucket: str, dry_run: bool = False) -> HealResultItem:
        results = [p.heal_bucket(bucket, dry_run) for p in self.pools]
        out = results[0]
        for r in results[1:]:
            out.before.extend(r.before)
            out.after.extend(r.after)
            out.disk_count += r.disk_count
        return out

    def heal_objects(self, bucket: str, prefix: str = "",
                     **kw) -> Iterator[HealResultItem | Exception]:
        for p in self.pools:
            yield from p.heal_objects(bucket, prefix, **kw)

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    **kw) -> HealResultItem:
        last: Exception | None = None
        for p in self.pools:
            try:
                return p.heal_object(bucket, obj, version_id, **kw)
            except se.ObjectError as e:
                last = e
        raise last or se.ObjectNotFound(bucket, obj)
