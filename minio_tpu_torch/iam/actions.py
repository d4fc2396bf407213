"""Map an S3 HTTP request to its IAM action name (the port's copy of
minio_tpu/iam/actions.py).

The action is what the server authorizes (identity policies and the
bucket policy), and its name after "s3:" is the `api` label of the
request families, the JAX server's label for the same request.
"""

from __future__ import annotations

# bucket subresource -> (GET action, PUT action, DELETE action)
_BUCKET_SUB = {
    "policy": ("s3:GetBucketPolicy", "s3:PutBucketPolicy",
               "s3:DeleteBucketPolicy"),
    "versioning": ("s3:GetBucketVersioning", "s3:PutBucketVersioning", None),
    "lifecycle": ("s3:GetLifecycleConfiguration",
                  "s3:PutLifecycleConfiguration",
                  "s3:PutLifecycleConfiguration"),
    "tagging": ("s3:GetBucketTagging", "s3:PutBucketTagging",
                "s3:PutBucketTagging"),
    "encryption": ("s3:GetEncryptionConfiguration",
                   "s3:PutEncryptionConfiguration",
                   "s3:PutEncryptionConfiguration"),
    "object-lock": ("s3:GetBucketObjectLockConfiguration",
                    "s3:PutBucketObjectLockConfiguration", None),
    "notification": ("s3:GetBucketNotification", "s3:PutBucketNotification",
                     None),
    "replication": ("s3:GetReplicationConfiguration",
                    "s3:PutReplicationConfiguration",
                    "s3:PutReplicationConfiguration"),
    "quota": ("admin:GetBucketQuota", "admin:SetBucketQuota", None),
    "acl": ("s3:GetBucketAcl", "s3:PutBucketAcl", None),
    "website": ("s3:GetBucketWebsite", "s3:PutBucketWebsite",
                "s3:DeleteBucketWebsite"),
    "accelerate": ("s3:GetAccelerateConfiguration",
                   "s3:PutAccelerateConfiguration", None),
    "requestPayment": ("s3:GetBucketRequestPayment",
                       "s3:PutBucketRequestPayment", None),
    "logging": ("s3:GetBucketLogging", "s3:PutBucketLogging", None),
}

_OBJECT_SUB = {
    "tagging": ("s3:GetObjectTagging", "s3:PutObjectTagging",
                "s3:DeleteObjectTagging"),
    "retention": ("s3:GetObjectRetention", "s3:PutObjectRetention", None),
    "legal-hold": ("s3:GetObjectLegalHold", "s3:PutObjectLegalHold", None),
    "acl": ("s3:GetObjectAcl", "s3:PutObjectAcl", None),
}


def action_for(method: str, sub: set[str], bucket: str, key: str,
               headers=None) -> str:
    """The s3:* action this request performs."""
    m = method.upper()
    if not bucket:
        return "s3:ListAllMyBuckets"

    if not key:
        for name, (g, p, d) in _BUCKET_SUB.items():
            if name in sub:
                act = {"GET": g, "HEAD": g, "PUT": p, "DELETE": d}.get(m)
                if act:
                    return act
        if m in ("GET", "HEAD"):
            if "uploads" in sub:
                return "s3:ListBucketMultipartUploads"
            if "versions" in sub:
                return "s3:ListBucketVersions"
            if "location" in sub:
                return "s3:GetBucketLocation"
            return "s3:ListBucket"
        if m == "PUT":
            return "s3:CreateBucket"
        if m == "DELETE":
            return "s3:DeleteBucket"
        if m == "POST" and "delete" in sub:
            return "s3:DeleteObject"
        return "s3:ListBucket"

    for name, (g, p, d) in _OBJECT_SUB.items():
        if name in sub:
            act = {"GET": g, "HEAD": g, "PUT": p, "DELETE": d}.get(m)
            if act:
                return act
    if "uploadId" in sub or "uploads" in sub:
        if m == "GET":
            return "s3:ListMultipartUploadParts"
        if m == "DELETE":
            return "s3:AbortMultipartUpload"
        return "s3:PutObject"  # initiate/part/complete all write the object
    if m in ("GET", "HEAD"):
        if "versionId" in sub:
            return "s3:GetObjectVersion"
        return "s3:GetObject"
    if m == "PUT":
        if headers is not None and headers.get("x-amz-copy-source"):
            return "s3:PutObject"
        return "s3:PutObject"
    if m == "DELETE":
        if "versionId" in sub:
            return "s3:DeleteObjectVersion"
        return "s3:DeleteObject"
    if m == "POST":
        return "s3:PutObject"
    return "s3:GetObject"
