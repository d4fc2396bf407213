"""Error taxonomy for the storage stack (the subset this slice raises).

Same class names and hierarchy as minio_tpu/utils/errors.py, so quorum
reducers and the S3 error mapping behave identically in both packages:
per-drive failures are StorageError values, object-layer outcomes are
ObjectError exceptions.
"""

from __future__ import annotations


class StorageError(Exception):
    """Base for all per-drive storage errors."""


class DiskNotFound(StorageError):
    """Drive is offline or not reachable: the health checker has it
    OFFLINE, or the disk-ID check found another drive in its slot."""


class FaultyDisk(StorageError):
    """Drive returned an unexpected I/O error."""


class DiskFull(StorageError):
    pass


class DiskAccessDenied(StorageError):
    pass


class UnformattedDisk(StorageError):
    """Drive has no format.json yet."""


class InconsistentDisk(StorageError):
    """The drive at a path is not the one placed in its slot (its
    format.json names another UUID)."""


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


class FileNameTooLong(StorageError):
    pass


class MethodNotAllowed(StorageError):
    pass


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


class BucketNotEmpty(ObjectError):
    pass


class ObjectNotFound(ObjectError):
    pass


class ObjectIsDeleteMarker(ObjectNotFound):
    """The version a GET or HEAD resolved is a delete marker: S3 answers 404
    (no version named) or 405 (the marker named by its id), either with
    x-amz-delete-marker and the marker's x-amz-version-id."""

    def __init__(self, bucket: str = "", object: str = "", version_id: str = "",
                 named: bool = False):
        super().__init__(bucket, object)
        self.version_id = version_id
        self.named = named


class VersionNotFound(ObjectError):
    pass


class ObjectNameInvalid(ObjectError):
    pass


class IncompleteBody(ObjectError):
    pass


class InvalidUploadID(ObjectError):
    pass


class InvalidPart(ObjectError):
    pass


class PartTooSmall(ObjectError):
    pass


class InsufficientReadQuorum(ObjectError):
    """Fewer than dataBlocks drives agreed on a readable object."""


class InsufficientWriteQuorum(ObjectError):
    """Fewer than writeQuorum drives accepted the write."""


class ObjectExistsAsDirectory(ObjectError):
    pass


class PreconditionFailed(ObjectError):
    pass


class InvalidRange(ObjectError):
    pass


class OperationTimedOut(ObjectError):
    pass


class AdmissionShed(OperationTimedOut):
    """A batch-plane admission rejection (utils/admission.shed): the
    request was shed by policy (a full queue or a closed plane), not lost
    to a sick drive. As an OperationTimedOut it answers 503 SlowDown."""



# --- IAM and policy errors (minio_tpu/utils/errors.py:176-205; reference
# cmd/iam-errors.go, pkg/iam/policy) ---


class IAMError(Exception):
    pass


class MalformedPolicy(IAMError):
    pass


class NoSuchPolicy(IAMError):
    pass


class NoSuchUser(IAMError):
    pass


class NoSuchGroup(IAMError):
    pass


class NoSuchServiceAccount(IAMError):
    pass


class InvalidAccessKey(IAMError):
    pass


class IAMActionNotAllowed(IAMError):
    pass


def by_name(name: str, msg: str = "") -> Exception:
    """Rebuild a typed storage or object error from its class name (the
    fabric's error documents, minio_tpu/utils/errors.py by_name)."""
    cls = globals().get(name)
    if isinstance(cls, type) and issubclass(cls, ObjectError):
        try:
            return cls(msg=msg)
        except TypeError:   # a subclass with its own fields
            return cls()
    if isinstance(cls, type) and issubclass(cls, StorageError):
        return cls(msg)
    return StorageError(f"{name}: {msg}")
