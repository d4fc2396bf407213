"""ErasureServerPools — pools of erasure sets, the top of the object layer
(counterpart of minio_tpu/erasure/pools.py, reference erasureServerPools,
cmd/erasure-server-pool.go:41).

A write lands in the pool that already holds the object, else in the pool
with the most free bytes (:176-293); reads and deletes go to the pool that
holds the object, found by asking every pool for its newest version; a
multipart call goes to the pool that holds its upload session. With one
pool every call passes straight through.

Left for later slices (ROADMAP.md): listing and the metacache, bucket
heal, and pools from more than one node (dist/).
"""

from __future__ import annotations

from typing import BinaryIO

from minio_tpu_torch.erasure.healing import HealResultItem
from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.erasure.sets import ErasureSets, _raise_first
from minio_tpu_torch.erasure.types import (BucketInfo, CompletePart,
                                           MultipartInfo, ObjectInfo,
                                           ObjectOptions, PartInfoResult)
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.utils import errors as se


class ErasureServerPools:
    def __init__(self, pools: list[ErasureSets]):
        if not pools:
            raise ValueError("no pools")
        self.pools = pools

    @property
    def device(self):
        return self.pools[0].device

    # -- pool choice --

    @staticmethod
    def _pool_free(pool: ErasureSets) -> int:
        free = 0
        for d in pool.drives:
            try:
                free += d.disk_info().free
            except Exception:  # noqa: BLE001 - an unreadable drive adds nothing
                pass
        return free

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

    # -- objects --

    def put_object(self, bucket: str, obj: str, data: BinaryIO, size: int = -1,
                   opts: ObjectOptions | None = None) -> ObjectInfo:
        opts = opts or ObjectOptions()
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
        return self._owning_pool(bucket, obj, opts.version_id).delete_object(
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
        return self._upload_pool(bucket, obj, upload_id).complete_multipart_upload(
            bucket, obj, upload_id, parts, opts)

    # -- heal --

    def heal_object(self, bucket: str, obj: str, version_id: str = "",
                    **kw) -> HealResultItem:
        last: Exception | None = None
        for p in self.pools:
            try:
                return p.heal_object(bucket, obj, version_id, **kw)
            except se.ObjectError as e:
                last = e
        raise last or se.ObjectNotFound(bucket, obj)
