"""Remote tiers — ILM transition targets (counterpart of
minio_tpu/scanner/tiers.py).

Role-equivalent of the reference's tier subsystem (cmd/bucket-lifecycle.go
:108-135 transition workers + the madmin tier config): a named tier is a
cheaper/colder store; lifecycle Transition rules move an object's DATA
there, the cluster keeps a metadata stub (size/etag/versions intact), and
reads stream back through the tier transparently.

Backends: FSTier (a mounted directory — NAS/cold-HDD tier) and S3Tier (any
S3 endpoint via the same RemoteS3Client replication uses). Tier definitions
persist in the sys store (config/tiers.json), so every node sees them.

The object layer reaches the registry through the module-global handle
(set_global at server boot) — the seam where the reference's globalTierSys
lives.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Iterator

from minio_tpu_torch.utils import errors as se

# Metadata markers on a transitioned version (reference
# xlMetaV2Object.TransitionStatus/TransitionTier/TransitionedObjName).
TRANSITION_TIER = "x-mtpu-internal-transition-tier"
TRANSITION_KEY = "x-mtpu-internal-transition-key"

CONFIG_PATH = "config/tiers.json"


class TierError(Exception):
    pass


class FSTier:
    """Directory-backed tier (cold mount / NAS)."""

    kind = "fs"

    def __init__(self, name: str, directory: str):
        self.name = name
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        # Injective mapping: keep the key's own hierarchy ('/'-separated);
        # refuse traversal components. (A lossy flattening like
        # s/\//__/ would collide 'x/y' with 'x__y' — silent data loss.)
        parts = key.split("/")
        if any(p in ("", ".", "..") for p in parts):
            raise TierError(f"tier {self.name}: unsafe key {key!r}")
        return os.path.join(self.dir, *parts)

    def put(self, key: str, stream) -> int:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        n = 0
        with open(tmp, "wb") as f:
            for chunk in stream:
                f.write(chunk)
                n += len(chunk)
        os.replace(tmp, p)
        return n

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        p = self._path(key)
        if not os.path.exists(p):
            raise TierError(f"tier {self.name}: missing object {key}")

        def it():
            with open(p, "rb") as f:
                f.seek(offset)
                remaining = length if length >= 0 else None
                while remaining is None or remaining > 0:
                    want = 1 << 20 if remaining is None else min(1 << 20, remaining)
                    chunk = f.read(want)
                    if not chunk:
                        return
                    if remaining is not None:
                        remaining -= len(chunk)
                    yield chunk

        return it()

    def remove(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def to_doc(self) -> dict:
        return {"kind": "fs", "name": self.name, "dir": self.dir}


class S3Tier:
    """Remote-S3 tier (warm cloud bucket) over the replication client."""

    kind = "s3"

    def __init__(self, name: str, endpoint: str, access_key: str,
                 secret_key: str, bucket: str, prefix: str = "",
                 region: str = "us-east-1"):
        self.name = name
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        self.region = region

    def _client(self):
        from minio_tpu_torch.replication.client import RemoteS3Client

        return RemoteS3Client(self.endpoint, self.access_key,
                              self.secret_key, region=self.region)

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}" if self.prefix else key

    # Ranged fetch granularity: reads stream back in window-sized pieces
    # so a read-through GET never materializes the whole tiered object.
    WINDOW = 8 << 20

    def put(self, key: str, stream) -> int:
        # One signed PUT needs the full payload hash; tier puts buffer the
        # object once on the way out (transition is a background move).
        body = b"".join(stream)
        self._client().put_object(self.bucket, self._key(key), body, {})
        return len(body)

    def get(self, key: str, offset: int = 0,
            length: int = -1) -> Iterator[bytes]:
        client = self._client()
        rkey = self._key(key)

        def it():
            from minio_tpu_torch.replication.client import RemoteS3Error

            pos = offset
            remaining = length
            while remaining != 0:
                want = self.WINDOW if remaining < 0 else min(
                    self.WINDOW, remaining)
                try:
                    _h, body = client.get_object(self.bucket, rkey, pos, want)
                except RemoteS3Error as e:
                    if e.status == 416:  # ran off the end
                        return
                    raise TierError(
                        f"tier {self.name}: {e.status}") from e
                if not body:
                    return
                yield body
                pos += len(body)
                if remaining > 0:
                    remaining -= len(body)
                if len(body) < want:
                    return

        return it()

    def remove(self, key: str) -> None:
        try:
            self._client().delete_object(self.bucket, self._key(key))
        except Exception:  # noqa: BLE001
            pass

    def to_doc(self) -> dict:
        return {"kind": "s3", "name": self.name, "endpoint": self.endpoint,
                "accessKey": self.access_key, "secretKey": self.secret_key,
                "bucket": self.bucket, "prefix": self.prefix,
                "region": self.region}


def _from_doc(doc: dict):
    if doc.get("kind") == "fs":
        return FSTier(doc["name"], doc["dir"])
    if doc.get("kind") == "s3":
        return S3Tier(doc["name"], doc["endpoint"], doc["accessKey"],
                      doc["secretKey"], doc["bucket"],
                      doc.get("prefix", ""), doc.get("region", "us-east-1"))
    raise TierError(f"unknown tier kind {doc.get('kind')!r}")


class TierRegistry:
    def __init__(self, store=None):
        self._store = store
        self._mu = threading.Lock()
        self._tiers: dict[str, object] = {}
        if store is not None:
            self._load()

    def _load(self) -> None:
        try:
            docs = json.loads(self._store.read_sys_config(CONFIG_PATH))
        except (se.StorageError, ValueError):
            return
        for d in docs:
            try:
                self._tiers[d["name"]] = _from_doc(d)
            except (TierError, KeyError):
                continue

    def _persist(self) -> None:
        if self._store is not None:
            docs = [t.to_doc() for t in self._tiers.values()]
            self._store.write_sys_config(CONFIG_PATH,
                                         json.dumps(docs).encode())

    def add(self, tier) -> None:
        with self._mu:
            if tier.name in self._tiers:
                raise TierError(f"tier {tier.name!r} exists")
            self._tiers[tier.name] = tier
            self._persist()

    def remove(self, name: str, force: bool = False) -> None:
        """Deleting a tier strands every object transitioned to it (their
        only data copy lives there) — require an explicit force."""
        if not force:
            raise TierError(
                f"removing tier {name!r} makes objects transitioned to it "
                "unreadable; pass force=true to confirm")
        with self._mu:
            self._tiers.pop(name, None)
            self._persist()

    def get(self, name: str):
        with self._mu:
            t = self._tiers.get(name)
        if t is None:
            raise TierError(f"no such tier {name!r}")
        return t

    def names(self) -> list[str]:
        with self._mu:
            return sorted(self._tiers)

    def list_docs(self) -> list[dict]:
        with self._mu:
            return [{**t.to_doc(), "secretKey": "*REDACTED*"}
                    if "secretKey" in t.to_doc() else t.to_doc()
                    for t in self._tiers.values()]


_global: TierRegistry | None = None


def set_global(reg: TierRegistry | None) -> None:
    global _global
    _global = reg


def global_registry() -> TierRegistry | None:
    return _global
