"""Data usage accounting (counterpart of minio_tpu/scanner/usage.py; the
persisted document is its bytes, through utils/msgpack.py).

Role-equivalent of cmd/data-usage-cache.go: a hierarchical per-prefix
usage tree (object/version counts, total size, size histogram) built by
the scanner, merged bottom-up, persisted in the sys store, and served by
the admin DataUsageInfo API.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from minio_tpu_torch.utils import msgpack

# Size histogram buckets (cmd/data-usage-cache.go sizeHistogram).
SIZE_BUCKETS = [
    ("LESS_THAN_1024_B", 1024),
    ("BETWEEN_1024_B_AND_1_MB", 1 << 20),
    ("BETWEEN_1_MB_AND_10_MB", 10 << 20),
    ("BETWEEN_10_MB_AND_64_MB", 64 << 20),
    ("BETWEEN_64_MB_AND_128_MB", 128 << 20),
    ("BETWEEN_128_MB_AND_512_MB", 512 << 20),
    ("GREATER_THAN_512_MB", float("inf")),
]


def size_bucket(size: int) -> str:
    for name, limit in SIZE_BUCKETS:
        if size < limit:
            return name
    return SIZE_BUCKETS[-1][0]


@dataclass
class UsageEntry:
    objects: int = 0
    versions: int = 0
    delete_markers: int = 0
    size: int = 0
    histogram: dict[str, int] = field(default_factory=dict)

    def add_version(self, size: int, is_latest: bool,
                    delete_marker: bool) -> None:
        if delete_marker:
            self.delete_markers += 1
            return
        self.versions += 1
        self.size += size
        if is_latest:
            self.objects += 1
            b = size_bucket(size)
            self.histogram[b] = self.histogram.get(b, 0) + 1

    def merge(self, other: "UsageEntry") -> None:
        self.objects += other.objects
        self.versions += other.versions
        self.delete_markers += other.delete_markers
        self.size += other.size
        for k, v in other.histogram.items():
            self.histogram[k] = self.histogram.get(k, 0) + v

    def to_doc(self) -> dict:
        return {"o": self.objects, "v": self.versions,
                "dm": self.delete_markers, "s": self.size,
                "h": self.histogram}

    @classmethod
    def from_doc(cls, d: dict) -> "UsageEntry":
        return cls(objects=d.get("o", 0), versions=d.get("v", 0),
                   delete_markers=d.get("dm", 0), size=d.get("s", 0),
                   histogram=dict(d.get("h", {})))


class DataUsageCache:
    """Per-bucket usage entries + totals, persisted as one sys-store doc
    (the reference persists its tree per set; one flat bucket map is the
    part the admin API actually serves)."""

    PATH = "scanner/data-usage.mp"

    def __init__(self):
        self.buckets: dict[str, UsageEntry] = {}
        self.last_update: float = 0.0
        self.cycles: int = 0

    def bucket(self, name: str) -> UsageEntry:
        if name not in self.buckets:
            self.buckets[name] = UsageEntry()
        return self.buckets[name]

    def total(self) -> UsageEntry:
        out = UsageEntry()
        for e in self.buckets.values():
            out.merge(e)
        return out

    # -- persistence --

    def serialize(self) -> bytes:
        return msgpack.packb({
            "t": self.last_update, "c": self.cycles,
            "b": {k: v.to_doc() for k, v in self.buckets.items()},
        })

    @classmethod
    def parse(cls, raw: bytes) -> "DataUsageCache":
        d = msgpack.unpackb(raw)
        out = cls()
        out.last_update = d.get("t", 0.0)
        out.cycles = d.get("c", 0)
        out.buckets = {k: UsageEntry.from_doc(v)
                       for k, v in d.get("b", {}).items()}
        return out

    def save(self, store) -> None:
        self.last_update = time.time()
        store.write_sys_config(self.PATH, self.serialize())

    @classmethod
    def load(cls, store) -> "DataUsageCache":
        from minio_tpu_torch.utils import errors as se

        try:
            return cls.parse(store.read_sys_config(cls.PATH))
        except (se.FileNotFound, ValueError):
            return cls()

    # -- admin API shape (madmin DataUsageInfo) --

    def to_info(self) -> dict:
        tot = self.total()
        return {
            "lastUpdate": self.last_update,
            "objectsCount": tot.objects,
            "versionsCount": tot.versions,
            "deleteMarkersCount": tot.delete_markers,
            "objectsTotalSize": tot.size,
            "bucketsCount": len(self.buckets),
            "bucketsUsage": {
                b: {"objectsCount": e.objects, "versionsCount": e.versions,
                    "objectsTotalSize": e.size,
                    "objectsSizesHistogram": dict(e.histogram)}
                for b, e in self.buckets.items()},
        }
