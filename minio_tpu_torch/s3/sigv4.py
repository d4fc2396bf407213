"""AWS Signature Version 4: header-auth verification and request signing.

The verification half mirrors minio_tpu/s3/sigv4.py (reference
cmd/signature-v4.go doesSignatureMatch): canonical request ->
string-to-sign -> HMAC chain, for header auth with a signed payload hash
or UNSIGNED-PAYLOAD. The signing half (`sign_request`) is what the port's
own clients use (chip_smoke.py speaks S3 over http.client with it).

Presigned URLs and streaming aws-chunked bodies come in a later slice.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import re
import time
import urllib.parse
from dataclasses import dataclass

from minio_tpu_torch.s3.errors import S3Error

ALGORITHM = "AWS4-HMAC-SHA256"
STREAMING_PAYLOAD = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
# sha256(""): the payload hash of header-signed requests that omit
# x-amz-content-sha256 (cmd/signature-v4-utils.go:62).
EMPTY_SHA256 = ("e3b0c44298fc1c149afbf4c8996fb924"
                "27ae41e4649b934ca495991b7852b855")
MAX_SKEW_SECONDS = 15 * 60


@dataclass
class Credentials:
    access_key: str
    secret_key: str


@dataclass
class ParsedAuth:
    access_key: str
    scope_date: str      # yyyymmdd
    region: str
    service: str
    signed_headers: list[str]
    signature: str


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def signing_key(secret: str, scope_date: str, region: str, service: str) -> bytes:
    k = _hmac(("AWS4" + secret).encode(), scope_date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    return _hmac(k, "aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    return urllib.parse.quote(s, safe="-._~" if encode_slash else "-._~/")


def canonical_query(query_items: list[tuple[str, str]]) -> str:
    items = sorted((uri_encode(k), uri_encode(v)) for k, v in query_items)
    return "&".join(f"{k}={v}" for k, v in items)


def parse_auth_header(value: str) -> ParsedAuth:
    if not value.startswith(ALGORITHM + " "):
        raise S3Error("AuthorizationHeaderMalformed")
    parts: dict[str, str] = {}
    for item in value[len(ALGORITHM):].split(","):
        item = item.strip()
        if "=" not in item:
            raise S3Error("AuthorizationHeaderMalformed")
        k, v = item.split("=", 1)
        parts[k] = v
    try:
        cred = parts["Credential"].split("/")
        scope_date, region, service, terminal = cred[-4:]
        if terminal != "aws4_request":
            raise S3Error("AuthorizationHeaderMalformed")
        return ParsedAuth(access_key="/".join(cred[:-4]), scope_date=scope_date,
                          region=region, service=service,
                          signed_headers=parts["SignedHeaders"].lower().split(";"),
                          signature=parts["Signature"])
    except (KeyError, ValueError):
        raise S3Error("AuthorizationHeaderMalformed") from None


def _canonical_request(method: str, path: str, query: str, headers,
                       signed_headers: list[str], payload_hash: str) -> str:
    canon = "".join(f"{h}:{' '.join(headers.get(h, '').split())}\n"
                    for h in signed_headers)
    return "\n".join([method, uri_encode(path, encode_slash=False), query,
                      canon, ";".join(signed_headers), payload_hash])


def _string_to_sign(amz_date: str, scope: str, canonical: str) -> str:
    return "\n".join([ALGORITHM, amz_date, scope,
                      hashlib.sha256(canonical.encode()).hexdigest()])


_AMZ_DATE_RE = re.compile(r"\A\d{8}T\d{6}Z\Z", re.ASCII)


def _check_skew(amz_date: str) -> None:
    if _AMZ_DATE_RE.match(amz_date) is None:
        raise S3Error("AccessDenied", "invalid x-amz-date")
    try:
        t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        raise S3Error("AccessDenied", "invalid x-amz-date") from None
    if abs(time.time() - t) > MAX_SKEW_SECONDS:
        raise S3Error("RequestTimeTooSkewed")


def verify_header_auth(method: str, path: str, query_items: list[tuple[str, str]],
                       headers, creds_lookup) -> tuple[Credentials, str]:
    """Verify an Authorization-header signed request. `headers` needs a
    case-insensitive .get. Returns (credentials, declared payload hash);
    raises S3Error on any mismatch."""
    auth = parse_auth_header(headers.get("Authorization", ""))
    creds = creds_lookup(auth.access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    amz_date = headers.get("x-amz-date") or headers.get("Date", "")
    _check_skew(amz_date)
    if not amz_date.startswith(auth.scope_date):
        raise S3Error("SignatureDoesNotMatch")
    payload_hash = headers.get("x-amz-content-sha256", EMPTY_SHA256)
    scope = f"{auth.scope_date}/{auth.region}/{auth.service}/aws4_request"
    canonical = _canonical_request(method, path, canonical_query(query_items),
                                   headers, auth.signed_headers, payload_hash)
    key = signing_key(creds.secret_key, auth.scope_date, auth.region, auth.service)
    want = hmac.new(key, _string_to_sign(amz_date, scope, canonical).encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, auth.signature):
        raise S3Error("SignatureDoesNotMatch")
    return creds, payload_hash


class _LowerDict(dict):
    def get(self, key, default=None):
        return super().get(key.lower(), default)


def sign_request(method: str, path: str, query: dict, headers: dict, host: str,
                 creds: Credentials, payload_hash: str,
                 region: str = "us-east-1") -> dict:
    """Headers for a header-auth SigV4 request: the given headers plus
    host, x-amz-date, x-amz-content-sha256 and Authorization. Pass
    UNSIGNED_PAYLOAD or the body's sha256 hex as payload_hash."""
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    scope_date = amz_date[:8]
    out = _LowerDict({k.lower(): str(v) for k, v in headers.items()})
    out.update({"host": host, "x-amz-date": amz_date,
                "x-amz-content-sha256": payload_hash})
    signed = sorted(out)
    canonical = _canonical_request(method, path,
                                   canonical_query(list(query.items())),
                                   out, signed, payload_hash)
    scope = f"{scope_date}/{region}/s3/aws4_request"
    key = signing_key(creds.secret_key, scope_date, region, "s3")
    sig = hmac.new(key, _string_to_sign(amz_date, scope, canonical).encode(),
                   hashlib.sha256).hexdigest()
    out["authorization"] = (f"{ALGORITHM} Credential={creds.access_key}/{scope}, "
                            f"SignedHeaders={';'.join(signed)}, Signature={sig}")
    return dict(out)
