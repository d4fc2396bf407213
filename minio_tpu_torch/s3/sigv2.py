"""AWS Signature Version 2 — legacy header and presigned auth (the port's
copy of minio_tpu/s3/sigv2.py, plus `presign_url`, the signer the
port's own clients use).

Role-equivalent of cmd/signature-v2.go: older SDKs/tools (s3cmd classic
mode, old boto) sign with HMAC-SHA1 over a canonicalized string instead of
SigV4's scoped HMAC-SHA256 chain.

    Authorization: AWS <AccessKey>:<base64(HMAC-SHA1(secret, StringToSign))>
    StringToSign  = Method \n Content-MD5 \n Content-Type \n Date \n
                    CanonicalizedAmzHeaders + CanonicalizedResource

Presigned form carries ?AWSAccessKeyId=&Expires=&Signature= with the Expires
epoch in the Date slot (cmd/signature-v2.go doesPresignedSignatureMatchV2).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import time
import urllib.parse

from minio_tpu_torch.s3.errors import S3Error

V2_PREFIX = "AWS "

# Subresources included in the canonical resource, in sorted order
# (cmd/signature-v2.go resourceList).
SUBRESOURCES = (
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "select", "select-type", "tagging", "torrent", "uploadId", "uploads",
    "versionId", "versioning", "versions", "website", "encryption",
    "object-lock", "retention", "legal-hold", "replication",
)


def is_v2_header(headers) -> bool:
    a = headers.get("Authorization", "")
    return a.startswith(V2_PREFIX) and ":" in a


def is_v2_presigned(q: dict) -> bool:
    return "AWSAccessKeyId" in q and "Signature" in q and "Expires" in q


def _canonical_amz_headers(headers) -> str:
    amz: dict[str, list[str]] = {}
    for k in headers:
        lk = k.lower()
        if lk.startswith("x-amz-"):
            amz.setdefault(lk, []).append(" ".join(str(headers[k]).split()))
    return "".join(f"{k}:{','.join(v)}\n" for k, v in sorted(amz.items()))


def _canonical_resource(path: str, query_items: list[tuple[str, str]]) -> str:
    sub = []
    for k, v in query_items:
        if k in SUBRESOURCES:
            sub.append(f"{k}={v}" if v else k)
    out = path
    if sub:
        out += "?" + "&".join(sorted(sub))
    return out


def _string_to_sign(method: str, headers, path: str,
                    query_items: list[tuple[str, str]],
                    date_slot: str) -> str:
    return "\n".join([
        method,
        headers.get("Content-MD5", ""),
        headers.get("Content-Type", ""),
        date_slot,
    ]) + "\n" + _canonical_amz_headers(headers) + _canonical_resource(
        path, query_items)


def _sign(secret: str, string_to_sign: str) -> str:
    mac = hmac.new(secret.encode(), string_to_sign.encode(), hashlib.sha1)
    return base64.b64encode(mac.digest()).decode()


def verify_header_auth(method: str, path: str,
                       query_items: list[tuple[str, str]], headers,
                       creds_lookup):
    """-> Credentials. Raises S3Error on mismatch."""
    auth = headers.get("Authorization", "")
    try:
        access_key, sig = auth[len(V2_PREFIX):].split(":", 1)
    except ValueError:
        raise S3Error("InvalidArgument", "malformed V2 Authorization") from None
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    # Date slot: empty when x-amz-date is present (it rides in the amz
    # headers instead), else the Date header.
    date_slot = "" if headers.get("x-amz-date") else headers.get("Date", "")
    sts = _string_to_sign(method, headers, path, query_items, date_slot)
    if not hmac.compare_digest(_sign(creds.secret_key, sts), sig):
        raise S3Error("SignatureDoesNotMatch")
    return creds


def verify_presigned(method: str, path: str,
                     query_items: list[tuple[str, str]], headers,
                     creds_lookup):
    q = dict(query_items)
    creds = creds_lookup(q.get("AWSAccessKeyId", ""))
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    try:
        expires = int(q["Expires"])
    except (KeyError, ValueError):
        raise S3Error("InvalidArgument", "bad Expires") from None
    if time.time() > expires:
        raise S3Error("AccessDenied", "presigned URL expired")
    items = [(k, v) for k, v in query_items
             if k not in ("AWSAccessKeyId", "Signature", "Expires")]
    sts = _string_to_sign(method, headers, path, items, str(expires))
    # query_items arrive URL-decoded (parse_qsl) — compare directly.
    sig = q.get("Signature", "")
    if not hmac.compare_digest(_sign(creds.secret_key, sts), sig):
        raise S3Error("SignatureDoesNotMatch")
    return creds


def presign_url(method: str, path: str, access_key: str, secret: str,
                expires: int, query_items: list[tuple[str, str]] = ()) -> str:
    """`path?query` of a SigV2 presigned request valid until the epoch
    second `expires` (what old SDKs' generate_url sends)."""
    sts = _string_to_sign(method, {}, path, list(query_items), str(expires))
    q = list(query_items) + [("AWSAccessKeyId", access_key), ("Expires", str(expires)),
                             ("Signature", _sign(secret, sts))]
    return urllib.parse.quote(path) + "?" + urllib.parse.urlencode(q)
