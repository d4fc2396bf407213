"""Object-layer data types (the subset of minio_tpu/erasure/types.py the
port uses; reference cmd/object-api-datatypes.go).

ObjectInfo has the JAX class's fields in its order: the metacache
persists `dataclasses.asdict(ObjectInfo)` and decodes it with
`ObjectInfo(**d)`, so a block either package renders decodes in the
other."""

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
    is_dir: bool = False
    actual_size: int | None = None
    parts: list = field(default_factory=list)   # (number, size) pairs

    @property
    def storage_class(self) -> str:
        return self.user_defined.get("x-amz-storage-class", "STANDARD")


@dataclass
class ObjectOptions:
    """Per-call options (reference cmd/object-api-interface.go:44-63)."""

    version_id: str = ""
    versioned: bool = False     # the bucket keeps versions: ids and markers
    user_defined: dict[str, str] = field(default_factory=dict)
    mod_time: float = 0.0
    # A conditional write (the JAX package's, minio_tpu/erasure/types.py:55):
    # the commit aborts unless the latest (or named) version's mod_time is
    # still this one (a tier restore's and a transition's lost-update guard).
    expect_mod_time: float | None = None


@dataclass
class ListObjectsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class ListObjectVersionsInfo:
    is_truncated: bool = False
    next_marker: str = ""
    next_version_id_marker: str = ""
    objects: list[ObjectInfo] = field(default_factory=list)
    prefixes: list[str] = field(default_factory=list)


@dataclass
class ObjectToDelete:
    object_name: str
    version_id: str = ""


@dataclass
class DeletedObject:
    object_name: str = ""
    version_id: str = ""
    delete_marker: bool = False
    delete_marker_version_id: str = ""


@dataclass
class MultipartInfo:
    bucket: str
    object: str
    upload_id: str
    initiated: float = 0.0
    user_defined: dict[str, str] = field(default_factory=dict)


@dataclass
class CompletePart:
    part_number: int
    etag: str


@dataclass
class PartInfoResult:
    part_number: int
    etag: str
    size: int
    actual_size: int
    last_modified: float = 0.0
