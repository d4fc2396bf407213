"""Object-layer data types (the subset of minio_tpu/erasure/types.py this
slice uses; reference cmd/object-api-datatypes.go)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class BucketInfo:
    name: str
    created: float


@dataclass
class ObjectInfo:
    bucket: str
    name: str
    mod_time: float = 0.0
    size: int = 0
    etag: str = ""
    version_id: str = ""
    is_latest: bool = True
    delete_marker: bool = False
    content_type: str = ""
    user_defined: dict[str, str] = field(default_factory=dict)
    parity_blocks: int = 0
    data_blocks: int = 0
    num_versions: int = 0


@dataclass
class ObjectOptions:
    """Per-call options (reference cmd/object-api-interface.go:44-63)."""

    version_id: str = ""
    user_defined: dict[str, str] = field(default_factory=dict)
