"""SigV4 beyond header auth in the port (minio_tpu_torch/s3/sigv4.py:
presigned URLs, aws-chunked bodies, the browser POST policy; the server's
body rules) against the JAX package, on the CPU.

- aws-chunked: bodies the port's signer makes decode in the JAX
  package's ChunkedSigV4Reader and in the port's alike, fed in seeded
  pieces, and a flipped byte fails both; presigned URLs the port signs
  verify in the JAX package, and URLs tests/s3client.py signs (the JAX
  package's test signer) verify in the port, both refusing an expired
  URL under an injected clock;
- over HTTP, each package on its own drives, an IAM user (the chunk key
  derives from the requester's secret): aws-chunked PutObject and
  UploadPart store the bytes and ETags the JAX server stores; a tampered
  chunk, a cut body, a missing x-amz-decoded-content-length, a wrong
  secret, a presigned request that tries to stream, and a presigned PUT
  against its pinned X-Amz-Content-Sha256 answer as the JAX server
  answers, leaving the key as it was; presigned GET and PUT; the browser
  POST policy upload and its conditions.

Tolerance: exact (bytes, ETags, statuses, error codes)."""

import base64
import datetime
import hashlib
import hmac
import io
import json
import urllib.parse

import numpy as np
import pytest
import requests

from minio_tpu.s3 import errors as jerrors
from minio_tpu.s3 import sigv4 as jsigv4
from minio_tpu_torch.s3 import errors as perrors
from minio_tpu_torch.s3 import sigv4
from tests import torch_atrest as ta
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

CREDS = sigv4.Credentials("alice", "alice-secret-1")
JCREDS = jsigv4.Credentials("alice", "alice-secret-1")
HOST = "127.0.0.1:9000"


def _decode(reader_cls, creds, headers, body, rng):
    auth = sigv4.parse_auth_header(headers["authorization"])
    reader = reader_cls(creds, auth.signature, headers["x-amz-date"], auth.scope_date,
                        auth.region, auth.service)
    out = bytearray()
    pos = 0
    while pos < len(body):
        n = int(rng.integers(1, 70_000))
        for view in reader.feed(body[pos:pos + n]):
            out += view
        pos += n
    return bytes(out), reader.done


@pytest.mark.parametrize("size,chunk", [(0, 65536), (1, 65536), (65535, 65536),
                                        (65536, 65536), (65537, 65536), (200_000, 8192),
                                        (300_001, 65536)])
def test_port_chunked_body_decodes_in_both(size, chunk):
    data = ta.payload(size, size)
    headers, body = sigv4.sign_chunked("PUT", "/b/k", {}, {}, HOST, CREDS, data, chunk)
    for cls, creds in ((sigv4.ChunkedSigV4Reader, CREDS), (jsigv4.ChunkedSigV4Reader, JCREDS)):
        got, done = _decode(cls, creds, headers, body, np.random.default_rng(size))
        assert (got, done) == (data, True)
    assert headers["x-amz-decoded-content-length"] == str(size)
    assert int(headers["content-length"]) == len(body)


@pytest.mark.parametrize("where", [0, 1, "last"])
def test_tampered_chunk_fails_in_both(where):
    data = ta.payload(150_000, 3)
    headers, body = sigv4.sign_chunked("PUT", "/b/k", {}, {}, HOST, CREDS, data, 65536)
    body = bytearray(body)
    pos = {0: body.index(b"\r\n") + 2, 1: body.index(b"\r\n", 65600) + 10,
           "last": len(body) - 5}[where]   # the final chunk's signature
    body[pos] ^= 1
    for cls, creds, err in ((sigv4.ChunkedSigV4Reader, CREDS, perrors.S3Error),
                            (jsigv4.ChunkedSigV4Reader, JCREDS, jerrors.S3Error)):
        with pytest.raises(err) as e:
            _decode(cls, creds, headers, bytes(body), np.random.default_rng(1))
        assert e.value.api.code == "SignatureDoesNotMatch"


class _Later(datetime.datetime):
    """datetime with now() a week and a minute ahead: an injected clock."""

    @classmethod
    def now(cls, tz=None):
        return datetime.datetime.now(tz) + datetime.timedelta(days=7, minutes=1)


def _verify(mod, url, lookup, method="GET"):
    path, _, qs = url.partition("?")
    items = urllib.parse.parse_qsl(qs, keep_blank_values=True)
    try:
        mod.verify_presigned(method, urllib.parse.unquote(path), items, {"host": HOST},
                             lookup)
        return "ok"
    except (perrors.S3Error, jerrors.S3Error) as e:
        return e.api.code


@pytest.mark.parametrize("expires", [60, 604800])
def test_presigned_urls_verify_both_ways(monkeypatch, expires):
    plook = {"alice": CREDS}.get
    jlook = {"alice": JCREDS}.get
    port_url = sigv4.presign_url("GET", "/b/a key+x", HOST, CREDS, expires,
                                 {"versionId": "v1"})
    test_url = ti.SigV4Client(f"http://{HOST}", "alice", "alice-secret-1").presigned_url(
        "GET", "/b/a-key", expires)[len(f"http://{HOST}"):]
    for url in (port_url, test_url):
        assert _verify(sigv4, url, plook) == _verify(jsigv4, url, jlook) == "ok"
        assert _verify(sigv4, url, plook, "PUT") == _verify(jsigv4, url, jlook, "PUT") == \
            "SignatureDoesNotMatch"
        assert _verify(sigv4, url, {}.get) == _verify(jsigv4, url, {}.get) == \
            "InvalidAccessKeyId"
    for mod in (sigv4, jsigv4):
        monkeypatch.setattr(mod, "datetime", type("dt", (), {
            "datetime": _Later, "timezone": datetime.timezone,
            "timedelta": datetime.timedelta}))
    for url in (port_url, test_url):
        assert _verify(sigv4, url, plook) == _verify(jsigv4, url, jlook) == "AccessDenied"


# --- over HTTP ------------------------------------------------------------------

def _pair(tmp_path):
    """Both servers on their own drives, each with user alice (readwrite)
    and bucket chunkb holding `obj`; -> {pkg: server}."""
    out = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        cl = ti.root(srv.url)
        cl.put("/chunkb")
        cl.put("/chunkb/obj", data=b"the original")
        ti.add_user(cl, "alice", "alice-secret-1")
        out[pkg] = srv
    return out


def _close(servers):
    for srv in servers.values():
        srv.close()


@pytest.mark.parametrize("size,chunk", [(0, 65536), (65536, 65536), (200_003, 65536),
                                        (1 << 20, 8192)])
def test_chunked_put_stores_what_jax_stores(planes_off, tmp_path, size, chunk):
    data = ta.payload(size, 40 + size)
    servers = _pair(tmp_path)
    try:
        got = {}
        for pkg, srv in servers.items():
            r = ti.chunked_request(srv.url, "PUT", "/chunkb/c", "alice", "alice-secret-1",
                                   data, chunk)
            assert r.status_code == 200, r.text
            g = ti.root(srv.url).get("/chunkb/c")
            got[pkg] = (r.headers["ETag"], g.content == data)
        assert got["torch"] == got["jax"] == (f'"{hashlib.md5(data).hexdigest()}"', True)
    finally:
        _close(servers)


def test_chunked_upload_part_equals_jax(planes_off, tmp_path):
    parts = [ta.payload(5 << 20, 61), ta.payload(100_000, 62)]
    servers = _pair(tmp_path)
    try:
        got = {}
        for pkg, srv in servers.items():
            alice = ti.SigV4Client(srv.url, "alice", "alice-secret-1")
            r = alice.post("/chunkb/mp", query={"uploads": ""})
            uid = r.text.split("<UploadId>")[1].split("</UploadId>")[0]
            etags = []
            for n, part in enumerate(parts, 1):
                r = ti.chunked_request(srv.url, "PUT", "/chunkb/mp", "alice",
                                       "alice-secret-1", part,
                                       query={"partNumber": str(n), "uploadId": uid})
                assert r.status_code == 200, r.text
                etags.append(r.headers["ETag"])
            doc = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
            r = alice.post("/chunkb/mp", query={"uploadId": uid}, data=doc.encode())
            assert r.status_code == 200, r.text
            got[pkg] = (etags, alice.get("/chunkb/mp").content == b"".join(parts))
        assert got["torch"] == got["jax"] and got["torch"][1]
    finally:
        _close(servers)


def _bad_body_script(srv):
    data = ta.payload(150_000, 77)
    url, out = srv.url, []
    cases = [dict(tamper_chunk=1), dict(cut=40), dict(cut=70_000),
             dict(decoded_length=False), dict(sk="wrong-secret-9"),
             dict(extra_headers={"x-amz-decoded-content-length": "12x"})]
    for case in cases:
        sk = case.pop("sk", "alice-secret-1")
        r = ti.chunked_request(url, "PUT", "/chunkb/obj", "alice", sk, data, **case)
        out.append((r.status_code, ti.error_code(r)))
        out.append(ti.root(url).get("/chunkb/obj").content)
    host = urllib.parse.urlparse(url).netloc
    alice = sigv4.Credentials("alice", "alice-secret-1")
    stream = sigv4.presign_url("PUT", "/chunkb/obj", host, alice,
                               content_sha256=sigv4.STREAMING_PAYLOAD)
    r = requests.put(url + stream, data=b"5;chunk-signature=x\r\nhello\r\n", timeout=30,
                     headers={"x-amz-decoded-content-length": "5"})
    out.append((r.status_code, ti.error_code(r)))
    pinned = sigv4.presign_url("PUT", "/chunkb/pinned", host, alice,
                               content_sha256=hashlib.sha256(b"exactly this").hexdigest())
    for body in (b"something else", b"exactly this"):
        r = requests.put(url + pinned, data=body, timeout=30)
        out.append((r.status_code, ti.error_code(r)))
    out.append(requests.get(url + sigv4.presign_url("GET", "/chunkb/pinned", host, alice),
                            timeout=30).content)
    plain = sigv4.presign_url("PUT", "/chunkb/presigned", host, alice, 300)
    out.append(requests.put(url + plain, data=b"any bytes", timeout=30).status_code)
    out.append(requests.get(url + sigv4.presign_url("GET", "/chunkb/presigned", host, alice),
                            timeout=30).content)
    r = requests.get(url + sigv4.presign_url("GET", "/chunkb/presigned", host,
                                             sigv4.Credentials("alice", "nope")), timeout=30)
    out.append((r.status_code, ti.error_code(r)))
    return out


def test_body_and_presign_rules_answer_as_jax(planes_off, tmp_path):
    servers = _pair(tmp_path)
    try:
        got = {pkg: _bad_body_script(srv) for pkg, srv in servers.items()}
    finally:
        _close(servers)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == (403, "SignatureDoesNotMatch")
    assert got["torch"][1] == b"the original"


# --- the browser POST policy -------------------------------------------------------

def _post_form(url, bucket, fields, file_bytes, ak="alice", sk="alice-secret-1",
               conditions=None, expiration=None):
    amz_date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    cred = f"{ak}/{amz_date[:8]}/us-east-1/s3/aws4_request"
    exp = expiration or (datetime.datetime.now(datetime.timezone.utc)
                         + datetime.timedelta(hours=1)).strftime("%Y-%m-%dT%H:%M:%SZ")
    doc = {"expiration": exp, "conditions": conditions or []}
    policy = base64.b64encode(json.dumps(doc).encode()).decode()
    key = ("AWS4" + sk).encode()
    for part in (amz_date[:8], "us-east-1", "s3", "aws4_request"):
        key = hmac.new(key, part.encode(), hashlib.sha256).digest()
    form = {**fields, "policy": policy, "x-amz-algorithm": "AWS4-HMAC-SHA256",
            "x-amz-credential": cred, "x-amz-date": amz_date,
            "x-amz-signature": hmac.new(key, policy.encode(), hashlib.sha256).hexdigest()}
    return requests.post(f"{url}/{bucket}", data=form, timeout=30,
                         files={"file": ("photo.jpg", io.BytesIO(file_bytes))})


def _post_script(url):
    out = []

    def rec(r, key=None):
        out.append((r.status_code, ti.error_code(r) if r.status_code >= 300 else
                    r.content.replace(url.encode(), b"")))
        if key:
            out.append(ti.root(url).get(f"/chunkb/{key}").content)

    data = ta.payload(3000, 5)
    rec(_post_form(url, "chunkb", {"key": "up/${filename}", "x-amz-meta-tag": "t1"}, data,
                   conditions=[{"bucket": "chunkb"}, ["starts-with", "$key", "up/"],
                               ["content-length-range", 1, 10_000]]), "up/photo.jpg")
    rec(_post_form(url, "chunkb", {"key": "k201", "success_action_status": "201"}, data),
        "k201")
    rec(_post_form(url, "chunkb", {"key": "big"}, data,
                   conditions=[["content-length-range", 1, 100]]))
    rec(_post_form(url, "chunkb", {"key": "other/x"}, data,
                   conditions=[["starts-with", "$key", "up/"]]))
    rec(_post_form(url, "chunkb", {"key": "eq"}, data, conditions=[["eq", "$key", "no"]]))
    rec(_post_form(url, "chunkb", {"key": "old"}, data, expiration="2001-01-01T00:00:00Z"))
    rec(_post_form(url, "chunkb", {"key": "bad"}, data, sk="wrong-secret"))
    rec(_post_form(url, "chunkb", {}, data))
    rec(_post_form(url, "chunkb", {"key": "ro"}, data, ak="reader", sk="reader-secret"))
    return out


def test_post_policy_upload_answers_as_jax(planes_off, tmp_path):
    servers = _pair(tmp_path)
    try:
        got = {}
        for pkg, srv in servers.items():
            ti.add_user(ti.root(srv.url), "reader", "reader-secret", "readonly")
            got[pkg] = _post_script(srv.url)
    finally:
        _close(servers)
    assert got["torch"] == got["jax"]
    assert got["torch"][0][0] == 204 and got["torch"][1] == ta.payload(3000, 5)
