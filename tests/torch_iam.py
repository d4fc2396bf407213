"""Shared pieces of the port's identity-and-access tests: the two servers
(the JAX S3Server on a thread, the port's on its own) over drives with
both planes off, clients for the root, an IAM user and no one, the admin
IAM calls, and request signers written here, apart from both packages
(aws-chunked SigV4 and SigV2), so each package's verifier is held to a
third implementation."""

import base64
import datetime
import hashlib
import hmac
import json
import urllib.parse
import xml.etree.ElementTree as ET

import pytest
import requests

from tests import torch_atrest as ta
from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client

REGION = "us-east-1"
S3_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"
PKGS = ("jax", "torch")


@pytest.fixture
def planes_off(monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")


def server(pkg, paths):
    return ta.JaxServer(paths) if pkg == "jax" else ta.port_server(paths)


def root(url) -> SigV4Client:
    return SigV4Client(url, S3_ACCESS, S3_SECRET)


def admin(cl: SigV4Client, method: str, op: str, query=None, body=None):
    data = body if isinstance(body, (bytes, type(None))) else json.dumps(body).encode()
    return cl.request(method, f"/minio/admin/v3/{op}", query=query or {}, data=data or b"")


def add_user(cl: SigV4Client, ak: str, sk: str, policy: str = "readwrite") -> SigV4Client:
    """An IAM user with `policy` attached; -> its client."""
    r = admin(cl, "PUT", "add-user", {"accessKey": ak}, {"secretKey": sk})
    assert r.status_code == 200, r.text
    if policy:
        r = admin(cl, "POST", "set-user-or-group-policy",
                  {"userOrGroup": ak, "policyName": policy})
        assert r.status_code == 200, r.text
    return SigV4Client(cl.endpoint, ak, sk)


def anon(url: str, method: str, path: str, **kw) -> requests.Response:
    return requests.request(method, url + urllib.parse.quote(path), timeout=30, **kw)


def error_code(r) -> str:
    return ET.fromstring(r.content).findtext("Code") if r.content else ""


def _signing_key(sk: str, date: str) -> bytes:
    key = ("AWS4" + sk).encode()
    for part in (date, REGION, "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    return key


def chunked_request(url: str, method: str, path: str, ak: str, sk: str, payload: bytes,
                    chunk_size: int = 64 << 10, query=None, tamper_chunk: int | None = None,
                    cut: int = 0, extra_headers=None, decoded_length: bool = True,
                    session_token: str = "") -> requests.Response:
    """A STREAMING-AWS4-HMAC-SHA256-PAYLOAD request: `payload` in signed
    aws-chunked chunks. `tamper_chunk` flips a byte of that chunk after
    signing; `cut` drops that many bytes off the end of the body."""
    query = dict(query or {})
    host = urllib.parse.urlparse(url).netloc
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    scope = f"{amz_date[:8]}/{REGION}/s3/aws4_request"
    headers = {"host": host, "x-amz-content-sha256": "STREAMING-AWS4-HMAC-SHA256-PAYLOAD",
               "x-amz-date": amz_date, "content-encoding": "aws-chunked"}
    if decoded_length:
        headers["x-amz-decoded-content-length"] = str(len(payload))
    if session_token:
        headers["x-amz-security-token"] = session_token
    headers.update({k.lower(): v for k, v in (extra_headers or {}).items()})
    signed = sorted(headers)
    cq = "&".join(f"{urllib.parse.quote(k, safe='-._~')}={urllib.parse.quote(v, safe='-._~')}"
                  for k, v in sorted(query.items()))
    canonical = "\n".join([method, urllib.parse.quote(path, safe="/-._~"), cq,
                           "".join(f"{h}:{headers[h]}\n" for h in signed), ";".join(signed),
                           headers["x-amz-content-sha256"]])
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(canonical.encode()).hexdigest()])
    key = _signing_key(sk, amz_date[:8])
    prev = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (f"AWS4-HMAC-SHA256 Credential={ak}/{scope}, "
                                f"SignedHeaders={';'.join(signed)}, Signature={prev}")
    body = bytearray()
    offsets = list(range(0, len(payload), chunk_size)) + [len(payload)]
    for i, off in enumerate(offsets):
        chunk = payload[off:off + chunk_size]
        csts = "\n".join(["AWS4-HMAC-SHA256-PAYLOAD", amz_date, scope, prev,
                          hashlib.sha256(b"").hexdigest(), hashlib.sha256(chunk).hexdigest()])
        prev = hmac.new(key, csts.encode(), hashlib.sha256).hexdigest()
        if i == tamper_chunk:
            chunk = bytes([chunk[0] ^ 1]) + chunk[1:]
        body += f"{len(chunk):x};chunk-signature={prev}\r\n".encode() + chunk + b"\r\n"
    if cut:
        del body[-cut:]
    return requests.request(method, url + urllib.parse.quote(path), params=query,
                            data=bytes(body), headers=headers, timeout=60)


def v2_string_to_sign(method: str, headers: dict, path: str, subresources: str,
                      date_slot: str) -> str:
    amz = sorted((k.lower(), v) for k, v in headers.items() if k.lower().startswith("x-amz-"))
    return "\n".join([method, headers.get("Content-MD5", ""), headers.get("Content-Type", ""),
                      date_slot]) + "\n" + "".join(f"{k}:{v}\n" for k, v in amz) + path \
        + (f"?{subresources}" if subresources else "")


def v2_sign(sk: str, sts: str) -> str:
    return base64.b64encode(hmac.new(sk.encode(), sts.encode(), hashlib.sha1).digest()).decode()


def v2_request(url: str, method: str, path: str, ak: str, sk: str, data: bytes = b"",
               headers=None, subresources: str = "") -> requests.Response:
    """A SigV2 header-signed request (old boto, s3cmd)."""
    headers = dict(headers or {})
    headers["Date"] = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%a, %d %b %Y %H:%M:%S GMT")
    sts = v2_string_to_sign(method, headers, path, subresources, headers["Date"])
    headers["Authorization"] = f"AWS {ak}:{v2_sign(sk, sts)}"
    q = "?" + subresources if subresources else ""
    return requests.request(method, url + urllib.parse.quote(path) + q, data=data,
                            headers=headers, timeout=30)


def v2_presigned(url: str, method: str, path: str, ak: str, sk: str, expires: int) -> str:
    sts = v2_string_to_sign(method, {}, path, "", str(expires))
    q = urllib.parse.urlencode({"AWSAccessKeyId": ak, "Expires": str(expires),
                                "Signature": v2_sign(sk, sts)})
    return f"{url}{urllib.parse.quote(path)}?{q}"


def version_ids(r) -> list[str]:
    """VersionIds of a ListObjectVersions answer, in order."""
    root_el = ET.fromstring(r.content)
    return [v.findtext(S3_NS + "VersionId") for v in root_el.iter(S3_NS + "Version")]
