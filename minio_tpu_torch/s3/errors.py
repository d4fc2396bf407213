"""S3 API error codes + mapping from internal exceptions (the subset of
minio_tpu/s3/errors.py this slice answers; reference cmd/api-errors.go).
Codes, messages and statuses are the JAX package's, so both servers send
the same error documents."""

from __future__ import annotations

from dataclasses import dataclass

from minio_tpu_torch.utils import errors as se


@dataclass(frozen=True)
class APIError:
    code: str
    message: str
    http_status: int


ERRORS = {e.code: e for e in [
    APIError("AccessDenied", "Access Denied.", 403),
    APIError("AuthorizationHeaderMalformed", "The authorization header is malformed.", 400),
    APIError("BucketAlreadyOwnedByYou", "Your previous request to create the named bucket succeeded and you already own it.", 409),
    APIError("EntityTooLarge", "Your proposed upload exceeds the maximum allowed object size.", 400),
    APIError("IncompleteBody", "You did not provide the number of bytes specified by the Content-Length HTTP header.", 400),
    APIError("InternalError", "We encountered an internal error, please try again.", 500),
    APIError("InvalidAccessKeyId", "The Access Key Id you provided does not exist in our records.", 403),
    APIError("InvalidArgument", "Invalid Argument", 400),
    APIError("InvalidBucketName", "The specified bucket is not valid.", 400),
    APIError("InvalidRange", "The requested range is not satisfiable", 416),
    APIError("MethodNotAllowed", "The specified method is not allowed against this resource.", 405),
    APIError("MissingContentLength", "You must provide the Content-Length HTTP header.", 411),
    APIError("NoSuchBucket", "The specified bucket does not exist", 404),
    APIError("NoSuchKey", "The specified key does not exist.", 404),
    APIError("NoSuchVersion", "The specified version does not exist.", 404),
    APIError("NotImplemented", "A header you provided implies functionality that is not implemented", 501),
    APIError("RequestTimeTooSkewed", "The difference between the request time and the server's time is too large.", 403),
    APIError("SignatureDoesNotMatch", "The request signature we calculated does not match the signature you provided. Check your key and signing method.", 403),
    APIError("SlowDown", "Resource requested is unreadable, please reduce your request rate", 503),
    APIError("XAmzContentSHA256Mismatch", "The provided 'x-amz-content-sha256' header does not match what was computed.", 400),
]}


class S3Error(Exception):
    def __init__(self, code: str, message: str | None = None, resource: str = ""):
        self.api = ERRORS[code]
        self.message = message or self.api.message
        self.resource = resource
        super().__init__(f"{code}: {self.message}")


_EXC_MAP: list[tuple[type, str]] = [
    (se.BucketNameInvalid, "InvalidBucketName"),
    (se.BucketExists, "BucketAlreadyOwnedByYou"),
    (se.BucketNotFound, "NoSuchBucket"),
    (se.VersionNotFound, "NoSuchVersion"),
    (se.ObjectNotFound, "NoSuchKey"),
    (se.ObjectNameInvalid, "NoSuchKey"),
    (se.IncompleteBody, "IncompleteBody"),
    (se.InvalidRange, "InvalidRange"),
    (se.InsufficientReadQuorum, "SlowDown"),
    (se.InsufficientWriteQuorum, "SlowDown"),
    (se.FileNotFound, "NoSuchKey"),
    (se.StorageError, "InternalError"),
]


def from_exception(exc: Exception, resource: str = "") -> S3Error:
    if isinstance(exc, S3Error):
        return exc
    for etype, code in _EXC_MAP:
        if isinstance(exc, etype):
            return S3Error(code, resource=resource)
    return S3Error("InternalError", message=str(exc) or None, resource=resource)
