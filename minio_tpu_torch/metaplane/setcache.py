"""SetFileInfoCache: the post-election FileInfo cache of one erasure set
(counterpart of minio_tpu/metaplane/setcache.py).

A GET or HEAD pays N per-drive `read_version` calls and a quorum election
even when nothing changed. This cache keeps the elected FileInfo (inline
payload included) by (bucket, object, version id) and revalidates it
with one signature per local drive instead of the fan-out: the drive's
("w", lsn) for the key while its WAL is armed (a dict lookup, bumped by
every journal mutation at submit), else the journal's (inode, mtime,
size). Signatures are taken before the election they validate, so a
mutation racing the fan-out leaves the entry stale and it misses at the
next lookup. Mutating paths invalidate eagerly as well.

Entries hand out clones both ways. Delete markers and errors are never
cached (a negative entry would turn an in-flight PUT into a 404).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from minio_tpu_torch import obs

_HITS = obs.counter(
    "minio_tpu_metaplane_cache_hits_total",
    "Set-level FileInfo cache hits (quorum fan-out + election skipped)"
).labels()
_MISSES = obs.counter(
    "minio_tpu_metaplane_cache_misses_total",
    "Set-level FileInfo cache misses (absent or signature-invalidated)"
).labels()
_INVALIDATIONS = obs.counter(
    "minio_tpu_metaplane_cache_invalidations_total",
    "Set-level FileInfo cache entries dropped by mutating paths"
).labels()


def _local_base(drive):
    """The LocalDrive under the health and disk-ID wrappers, or None."""
    from minio_tpu_torch.storage import healthcheck
    from minio_tpu_torch.storage.local import LocalDrive

    base = healthcheck.unwrap(drive)
    return base if isinstance(base, LocalDrive) else None


class SetFileInfoCache:
    def __init__(self, cap: int = 4096):
        self._cap = max(16, cap)
        self._mu = threading.Lock()
        # (bucket, obj) -> {version_id: (FileInfo, [(LocalDrive, sig)])}
        self._objects: OrderedDict[tuple[str, str], dict] = OrderedDict()

    def lookup(self, bucket: str, obj: str, version_id: str = ""):
        """A clone of the cached elected FileInfo when every recorded
        local-drive signature still matches; else None."""
        key = (bucket, obj)
        with self._mu:
            vids = self._objects.get(key)
            rec = vids.get(version_id) if vids else None
            if rec is not None:
                self._objects.move_to_end(key)
        if rec is None:
            _MISSES.inc()
            return None
        fi, sigs = rec
        for drive, sig in sigs:   # outside the lock: a stat may run
            if drive.meta_sig(bucket, obj) != sig:
                with self._mu:
                    vids = self._objects.get(key)
                    if vids is not None and vids.get(version_id) is rec:
                        del vids[version_id]
                        if not vids:
                            self._objects.pop(key, None)
                _MISSES.inc()
                return None
        _HITS.inc()
        return fi.clone()

    def snapshot_sigs(self, bucket: str, obj: str, drives) -> list:
        """Each local drive's signature, taken before an election (pass
        the list to populate)."""
        sigs = []
        for d in drives:
            base = _local_base(d)
            if base is not None:
                sigs.append((base, base.meta_sig(bucket, obj)))
        return sigs

    def populate(self, bucket: str, obj: str, version_id: str, fi, drives,
                 sigs: list | None = None) -> None:
        """Store an elected (or just committed) FileInfo. `sigs` must be a
        snapshot taken before the election; None (taken now) is safe only
        under the object's namespace lock around both the commit and this
        call. Nothing is stored unless every local signature is known."""
        if fi is None or getattr(fi, "deleted", False):
            return
        if sigs is None:
            sigs = self.snapshot_sigs(bucket, obj, drives)
        if not sigs or any(sig is None for _b, sig in sigs):
            return
        rec = (fi.clone(), sigs)
        key = (bucket, obj)
        with self._mu:
            vids = self._objects.get(key)
            if vids is None:
                vids = {}
                self._objects[key] = vids
            if version_id not in vids:
                while len(vids) >= 8:  # bound the versions of a hot object
                    vids.pop(next(iter(vids)))
            vids[version_id] = rec
            self._objects.move_to_end(key)
            while len(self._objects) > self._cap:
                self._objects.popitem(last=False)

    def invalidate(self, bucket: str, obj: str) -> None:
        """Drop every cached version of an object."""
        with self._mu:
            had = self._objects.pop((bucket, obj), None)
        if had:
            _INVALIDATIONS.inc()
