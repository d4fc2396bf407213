"""Error taxonomy for the storage stack (the subset this slice raises).

Same class names and hierarchy as minio_tpu/utils/errors.py, so quorum
reducers and the S3 error mapping behave identically in both packages:
per-drive failures are StorageError values, object-layer outcomes are
ObjectError exceptions.
"""

from __future__ import annotations


class StorageError(Exception):
    """Base for all per-drive storage errors."""


class FaultyDisk(StorageError):
    """Drive returned an unexpected I/O error."""


class DiskAccessDenied(StorageError):
    pass


class UnformattedDisk(StorageError):
    """Drive has no format.json yet."""


class VolumeNotFound(StorageError):
    pass


class VolumeExists(StorageError):
    pass


class VolumeNotEmpty(StorageError):
    pass


class FileNotFound(StorageError):
    pass


class FileVersionNotFound(StorageError):
    pass


class FileAccessDenied(StorageError):
    pass


class FileCorrupt(StorageError):
    """Bitrot verification failed on read (reference errFileCorrupt,
    cmd/bitrot-streaming.go:139-158)."""


class IsNotRegular(StorageError):
    """Path exists but is a directory where a file was expected."""


class CorruptedFormat(StorageError):
    pass


# --- object-layer errors (reference cmd/object-api-errors.go) ---


class ObjectError(Exception):
    def __init__(self, bucket: str = "", object: str = "", msg: str = ""):
        self.bucket = bucket
        self.object = object
        super().__init__(msg or f"{type(self).__name__}: {bucket}/{object}")


class BucketNotFound(ObjectError):
    pass


class BucketExists(ObjectError):
    pass


class BucketNameInvalid(ObjectError):
    pass


class ObjectNotFound(ObjectError):
    pass


class VersionNotFound(ObjectError):
    pass


class ObjectNameInvalid(ObjectError):
    pass


class IncompleteBody(ObjectError):
    pass


class InsufficientReadQuorum(ObjectError):
    """Fewer than dataBlocks drives agreed on a readable object."""


class InsufficientWriteQuorum(ObjectError):
    """Fewer than writeQuorum drives accepted the write."""


class InvalidRange(ObjectError):
    pass

