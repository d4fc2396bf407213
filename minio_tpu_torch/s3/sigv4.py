"""AWS Signature Version 4: verification and request signing.

The verification half mirrors minio_tpu/s3/sigv4.py (reference
cmd/signature-v4.go doesSignatureMatch :332, presigned :206,
cmd/streaming-signature-v4.go): canonical request -> string-to-sign ->
HMAC chain, for header auth (a signed payload hash, UNSIGNED-PAYLOAD or
STREAMING-AWS4-HMAC-SHA256-PAYLOAD, whose aws-chunked body
ChunkedSigV4Reader decodes chunk by chunk), presigned URLs and the
browser POST policy. The signing half (`sign_request`, `presign_url`,
`chunked_body`) is what the port's own clients use (chip_smoke.py speaks
S3 over http.client with it).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
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


def canonical_query(query_items: list[tuple[str, str]],
                    drop_signature: bool = False) -> str:
    items = sorted((uri_encode(k), uri_encode(v)) for k, v in query_items
                   if not (drop_signature and k == "X-Amz-Signature"))
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


def verify_presigned(method: str, path: str, query_items: list[tuple[str, str]],
                     headers, creds_lookup) -> Credentials:
    """Verify a presigned-URL request (X-Amz-* query auth). The payload
    hash is the signed query's X-Amz-Content-Sha256, else UNSIGNED-PAYLOAD."""
    q = dict(query_items)
    if q.get("X-Amz-Algorithm") != ALGORITHM:
        raise S3Error("AuthorizationHeaderMalformed")
    try:
        cred = q["X-Amz-Credential"].split("/")
        access_key = "/".join(cred[:-4])
        scope_date, region, service, _ = cred[-4:]
        amz_date = q["X-Amz-Date"]
        expires = int(q.get("X-Amz-Expires", "604800"))
        signed_headers = q["X-Amz-SignedHeaders"].lower().split(";")
        signature = q["X-Amz-Signature"]
    except (KeyError, ValueError):
        raise S3Error("AuthorizationHeaderMalformed") from None
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    try:
        t = datetime.datetime.strptime(amz_date, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc)
    except ValueError:
        raise S3Error("AuthorizationHeaderMalformed", "invalid X-Amz-Date") from None
    if datetime.datetime.now(datetime.timezone.utc) > t + datetime.timedelta(seconds=expires):
        raise S3Error("AccessDenied", "Request has expired")
    scope = f"{scope_date}/{region}/{service}/aws4_request"
    canonical = _canonical_request(method, path,
                                   canonical_query(query_items, drop_signature=True),
                                   headers, signed_headers,
                                   q.get("X-Amz-Content-Sha256", UNSIGNED_PAYLOAD))
    key = signing_key(creds.secret_key, scope_date, region, service)
    want = hmac.new(key, _string_to_sign(amz_date, scope, canonical).encode(),
                    hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, signature):
        raise S3Error("SignatureDoesNotMatch")
    return creds


_EMPTY_HASH = hashlib.sha256(b"").hexdigest()


def _chunk_string_to_sign(amz_date: str, scope: str, prev_sig: str, chunk) -> str:
    return "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev_sig,
                      _EMPTY_HASH, hashlib.sha256(chunk).hexdigest()])


class ChunkedSigV4Reader:
    """Decodes and verifies a STREAMING-AWS4-HMAC-SHA256-PAYLOAD body
    (aws-chunked: <hex-len>;chunk-signature=<sig>\\r\\n<data>\\r\\n ...,
    ended by a chunk of length 0), each chunk's signature chained from the
    previous one and the first from the header's seed signature.

    `feed(data)` returns memoryviews into the internal buffer, one per
    verified chunk, valid only until the next feed(): it releases them and
    compacts the consumed prefix before appending, so verified bytes are
    hashed and written once and never re-joined."""

    def __init__(self, creds: Credentials, auth_signature: str, amz_date: str,
                 scope_date: str, region: str, service: str):
        self._key = signing_key(creds.secret_key, scope_date, region, service)
        self._prev_sig = auth_signature
        self._amz_date = amz_date
        self._scope = f"{scope_date}/{region}/{service}/aws4_request"
        self._buf = bytearray()
        self._consumed = 0
        self._views: list = []
        self._done = False

    def feed(self, data) -> list:
        """Append wire bytes; -> the newly verified payload chunks."""
        for v in self._views:
            v.release()
        self._views = []
        if self._consumed:
            del self._buf[:self._consumed]
            self._consumed = 0
        self._buf += data
        out: list = []
        base = None
        while not self._done:
            nl = self._buf.find(b"\r\n", self._consumed)
            if nl < 0:
                break
            header = self._buf[self._consumed:nl].decode("latin-1")
            try:
                size_hex, _, rest = header.partition(";")
                size = int(size_hex, 16)
                sig = rest.split("chunk-signature=")[1].strip()
            except (ValueError, IndexError):
                raise S3Error("SignatureDoesNotMatch", "malformed chunk header") from None
            need = nl + 2 + size + 2
            if len(self._buf) < need:
                break
            if base is None:
                base = memoryview(self._buf)
            chunk = base[nl + 2: nl + 2 + size]
            want = hmac.new(self._key, _chunk_string_to_sign(
                self._amz_date, self._scope, self._prev_sig, chunk).encode(),
                hashlib.sha256).hexdigest()
            if not hmac.compare_digest(want, sig):
                raise S3Error("SignatureDoesNotMatch", "chunk signature mismatch")
            self._prev_sig = want
            self._consumed = need
            if size == 0:
                self._done = True
            else:
                out.append(chunk)
        # Keep every exported view (the base too) so the next feed can
        # release them before compacting the bytearray.
        self._views = list(out)
        if base is not None:
            self._views.append(base)
        return out

    @property
    def done(self) -> bool:
        return self._done


def verify_post_policy(form: dict, creds_lookup) -> Credentials:
    """Verify a browser POST upload's policy signature
    (cmd/signature-v4.go:153 doesPolicySignatureMatch): the string to sign
    is the base64 policy document itself, whose `expiration` must be ahead."""
    policy_b64 = form.get("policy", "")
    if form.get("x-amz-algorithm") != ALGORITHM:
        raise S3Error("AuthorizationHeaderMalformed")
    try:
        parts = form.get("x-amz-credential", "").split("/")
        access_key = "/".join(parts[:-4])
        scope_date, region, service, _ = parts[-4:]
    except ValueError:
        raise S3Error("AuthorizationHeaderMalformed") from None
    creds = creds_lookup(access_key)
    if creds is None:
        raise S3Error("InvalidAccessKeyId")
    key = signing_key(creds.secret_key, scope_date, region, service)
    want = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(want, form.get("x-amz-signature", "")):
        raise S3Error("SignatureDoesNotMatch")
    try:
        expiry = json.loads(base64.b64decode(policy_b64)).get("expiration", "")
        if expiry:
            exp = datetime.datetime.fromisoformat(expiry.replace("Z", "+00:00")).timestamp()
            if exp < time.time():
                raise S3Error("AccessDenied", "policy has expired")
    except (ValueError, TypeError):
        raise S3Error("AuthorizationHeaderMalformed", "bad policy document") from None
    return creds


def check_post_policy_conditions(policy_b64: str, form: dict, file_size: int) -> None:
    """Enforce the policy's conditions on the submitted form
    (cmd/postpolicyform.go checkPostPolicy): eq, starts-with and
    content-length-range."""
    for cond in json.loads(base64.b64decode(policy_b64)).get("conditions", []):
        if isinstance(cond, dict):
            for k, v in cond.items():
                if form.get(k.lower(), "") != str(v):
                    raise S3Error("AccessDenied", f"policy condition failed: {k}")
        elif isinstance(cond, list) and len(cond) == 3:
            op, field, value = cond
            name = str(field).lstrip("$").lower()
            if op == "eq":
                if form.get(name, "") != str(value):
                    raise S3Error("AccessDenied", f"policy condition failed: eq {name}")
            elif op == "starts-with":
                if not form.get(name, "").startswith(str(value)):
                    raise S3Error("AccessDenied",
                                  f"policy condition failed: starts-with {name}")
            elif op == "content-length-range":
                lo, hi = int(field), int(value)
                if not lo <= file_size <= hi:
                    raise S3Error("EntityTooLarge" if file_size > hi else "EntityTooSmall")


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


def presign_url(method: str, path: str, host: str, creds: Credentials,
                expires: int = 3600, query: dict | None = None,
                content_sha256: str = "", region: str = "us-east-1") -> str:
    """`path?query` of a presigned request (host the one signed header);
    `content_sha256` pins the body a presigned PUT may carry."""
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    q = dict(query or {})
    q.update({"X-Amz-Algorithm": ALGORITHM,
              "X-Amz-Credential": f"{creds.access_key}/{scope}",
              "X-Amz-Date": amz_date, "X-Amz-Expires": str(expires),
              "X-Amz-SignedHeaders": "host"})
    if content_sha256:
        q["X-Amz-Content-Sha256"] = content_sha256
    canonical = _canonical_request(method, path, canonical_query(list(q.items())),
                                   {"host": host}, ["host"],
                                   content_sha256 or UNSIGNED_PAYLOAD)
    key = signing_key(creds.secret_key, amz_date[:8], region, "s3")
    q["X-Amz-Signature"] = hmac.new(key, _string_to_sign(amz_date, scope, canonical)
                                    .encode(), hashlib.sha256).hexdigest()
    return (uri_encode(path, encode_slash=False) + "?"
            + "&".join(f"{uri_encode(k)}={uri_encode(v)}" for k, v in q.items()))


def sign_chunked(method: str, path: str, query: dict, headers: dict, host: str,
                 creds: Credentials, payload, chunk_size: int = 64 << 10,
                 region: str = "us-east-1") -> tuple[dict, bytes]:
    """(headers, body) of a STREAMING-AWS4-HMAC-SHA256-PAYLOAD request:
    `payload` cut into aws-chunked chunks of `chunk_size` bytes (minio-go's
    64 KiB), each signed in a chain from the header's seed signature."""
    headers = dict(headers, **{"content-encoding": "aws-chunked",
                               "x-amz-decoded-content-length": str(len(payload))})
    signed = sign_request(method, path, query, headers, host, creds,
                          STREAMING_PAYLOAD, region)
    amz_date = signed["x-amz-date"]
    scope = f"{amz_date[:8]}/{region}/s3/aws4_request"
    key = signing_key(creds.secret_key, amz_date[:8], region, "s3")
    prev = signed["authorization"].rsplit("Signature=", 1)[1]
    view = memoryview(payload)
    body = bytearray()
    for off in [*range(0, len(payload), chunk_size), len(payload)]:
        chunk = view[off:off + chunk_size]
        prev = hmac.new(key, _chunk_string_to_sign(amz_date, scope, prev, chunk).encode(),
                        hashlib.sha256).hexdigest()
        body += b"%x;chunk-signature=%s\r\n" % (len(chunk), prev.encode())
        body += chunk
        body += b"\r\n"
    signed["content-length"] = str(len(body))
    return signed, bytes(body)
