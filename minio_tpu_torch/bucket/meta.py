"""BucketMetadataSys: one document per bucket holding every bucket config
(counterpart of minio_tpu/bucket/meta.py; reference
cmd/bucket-metadata-sys.go:41, cmd/bucket-metadata.go).

The document lives in the mirrored sys store at buckets/<bucket>/metadata.mp,
msgpacked with the JAX package's keys, so either package reads and writes
the other's: the bytes are equal in both directions. The port serves
`versioning_status`, the bucket policy, the object-lock configuration and
the SSE default; every other field (lifecycle, tagging, quota,
notification, replication) is read and written back verbatim, never
interpreted.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass

from minio_tpu_torch.iam.policy import Policy
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils import msgpack

VERSIONING_ENABLED = "Enabled"
VERSIONING_SUSPENDED = "Suspended"


@dataclass
class BucketMetadata:
    """All config of one bucket (cmd/bucket-metadata.go:64-90). XML and
    JSON payloads are stored as the client sent them."""

    name: str = ""
    created: float = 0.0
    versioning_status: str = ""         # "", Enabled, Suspended
    policy_json: bytes = b""
    lifecycle_xml: bytes = b""
    tagging_xml: bytes = b""
    sse_xml: bytes = b""
    object_lock_xml: bytes = b""
    quota_json: bytes = b""
    notification_xml: bytes = b""
    replication_xml: bytes = b""

    def serialize(self) -> bytes:
        return msgpack.packb({
            "name": self.name, "created": self.created,
            "ver": self.versioning_status,
            "pol": self.policy_json, "ilm": self.lifecycle_xml,
            "tag": self.tagging_xml, "sse": self.sse_xml,
            "olk": self.object_lock_xml, "qta": self.quota_json,
            "ntf": self.notification_xml, "rep": self.replication_xml,
        })

    @classmethod
    def parse(cls, raw: bytes) -> "BucketMetadata":
        try:
            d = msgpack.unpackb(raw)
        except ValueError as e:
            raise se.CorruptedFormat(f"bucket metadata: {e}") from e
        if not isinstance(d, dict):
            raise se.CorruptedFormat("bucket metadata is not a map")
        return cls(name=d.get("name", ""), created=d.get("created", 0.0),
                   versioning_status=d.get("ver", ""),
                   policy_json=d.get("pol", b""),
                   lifecycle_xml=d.get("ilm", b""),
                   tagging_xml=d.get("tag", b""),
                   sse_xml=d.get("sse", b""),
                   object_lock_xml=d.get("olk", b""),
                   quota_json=d.get("qta", b""),
                   notification_xml=d.get("ntf", b""),
                   replication_xml=d.get("rep", b""))

    @property
    def versioning_enabled(self) -> bool:
        return self.versioning_status == VERSIONING_ENABLED


class BucketMetadataSys:
    """Cache over the persisted per-bucket documents
    (cmd/bucket-metadata-sys.go:41,424). `store` has read_sys_config,
    write_sys_config, delete_sys_config and sys_config_signature (any
    layer of the port).

    Every get() checks the document's per-drive stat signature and
    re-reads it when a copy was rewritten, so a port server sharing drives
    with a JAX server sees the JAX server's writes. A document written
    within _RACY_STAT_NS of the check is not cached: a coarse mtime tick
    could give two writes one signature. A remote drive cannot give a
    signature (dist/storage_remote.py), so in a cluster, as in the JAX
    package, every write is also broadcast: `notify(bucket)` fans out to
    the peers, whose invalidate() drops their entry, before the write
    returns.
    """

    _RACY_STAT_NS = 20_000_000

    def __init__(self, store, notify=None):
        self._store = store
        self._notify = notify
        # bucket -> (signature, BucketMetadata)
        self._cache: dict[str, tuple[tuple, BucketMetadata]] = {}
        self._mu = threading.Lock()

    @staticmethod
    def _path(bucket: str) -> str:
        return f"buckets/{bucket}/metadata.mp"

    def get(self, bucket: str) -> BucketMetadata:
        """The bucket's document, or the default config where it has none;
        callers must not mutate it."""
        path = self._path(bucket)
        sig = self._store.sys_config_signature(path)
        with self._mu:
            hit = self._cache.get(bucket)
        if hit is not None and hit[0] == sig:
            return hit[1]
        try:
            meta = BucketMetadata.parse(self._store.read_sys_config(path))
        except se.FileNotFound:
            meta = BucketMetadata(name=bucket, created=time.time())
        newest = max((s[1] for s in sig if s is not None), default=0)
        if time.time_ns() - newest > self._RACY_STAT_NS:
            with self._mu:
                self._cache[bucket] = (sig, meta)
        return meta

    def update(self, bucket: str, **changes) -> BucketMetadata:
        """Read-modify-write of one or more fields, persisted; the next
        get() reads it back. A bucket policy is validated here, on every
        write path, as in the JAX package (minio_tpu/bucket/meta.py:114-120):
        one whose conditions cannot be evaluated raises MalformedPolicy
        rather than being stored and failing open on a Deny."""
        if changes.get("policy_json"):
            Policy.parse(changes["policy_json"]).validate()
        meta = dataclasses.replace(self.get(bucket), **changes)
        self._store.write_sys_config(self._path(bucket), meta.serialize())
        self.invalidate(bucket)
        if self._notify is not None:
            self._notify(bucket)
        return meta

    def drop_bucket(self, bucket: str) -> None:
        """On DeleteBucket: remove the document and its cache entry."""
        try:
            self._store.delete_sys_config(self._path(bucket))
        except se.FileNotFound:
            pass
        self.invalidate(bucket)
        if self._notify is not None:
            self._notify(bucket)

    def invalidate(self, bucket: str) -> None:
        """Drop the cache entry (the peer plane's invalidation target,
        PeerHooks.on_bucket_metadata_invalidate)."""
        with self._mu:
            self._cache.pop(bucket, None)
