"""The port's S3 server (minio_tpu_torch.s3.server, plain PyTorch on the
CPU) against the JAX package's: one request script, sent through the same
SigV4 client to both servers, must get equal statuses, bodies (error XML
compared without RequestId/HostId), ETag, Content-Length, Content-Range and
Content-Type."""

import uuid
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client


@pytest.fixture(scope="module")
def torch_server(tmp_path_factory):
    from minio_tpu_torch.s3.server import build_server

    root = tmp_path_factory.mktemp("torch-drives")
    srv = build_server([str(root / f"d{i}") for i in range(4)], S3_ACCESS,
                       S3_SECRET, device="cpu").start()
    yield srv.url
    srv.close()


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _script(bucket):
    """(name, method, path, headers, body) steps; each sees the server
    state the earlier steps left."""
    objs = {"small.txt": _payload(1 << 10, 1), "mid.bin": _payload(300 << 10, 2),
            "big": _payload((1 << 20) + 12345, 3)}
    steps = [("create", "PUT", f"/{bucket}", {}, b""),
             ("create-again", "PUT", f"/{bucket}", {}, b""),
             ("head-bucket", "HEAD", f"/{bucket}", {}, b""),
             ("head-missing-bucket", "HEAD", f"/{bucket}-none", {}, b""),
             ("get-missing-bucket", "GET", f"/{bucket}-none/k", {}, b"")]
    for key, data in objs.items():
        steps += [(f"put-{key}", "PUT", f"/{bucket}/{key}",
                   {"Content-Type": "application/x-test"} if key == "big" else {}, data),
                  (f"get-{key}", "GET", f"/{bucket}/{key}", {}, b""),
                  (f"head-{key}", "HEAD", f"/{bucket}/{key}", {}, b""),
                  (f"range-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=100-1099"}, b""),
                  (f"suffix-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=-50"}, b""),
                  (f"open-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=1000-"}, b""),
                  (f"badrange-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": f"bytes={len(data)}-"}, b"")]
    steps += [("get-missing-key", "GET", f"/{bucket}/nope", {}, b""),
              ("head-missing-key", "HEAD", f"/{bucket}/nope", {}, b""),
              ("delete", "DELETE", f"/{bucket}/small.txt", {}, b""),
              ("get-deleted", "GET", f"/{bucket}/small.txt", {}, b"")]
    return steps


def _error_fields(body):
    root = ET.fromstring(body)
    return {c.tag: c.text for c in root if c.tag not in ("RequestId", "HostId")}


def _view(r):
    h = {k: r.headers.get(k) for k in ("ETag", "Content-Length", "Content-Range",
                                       "Content-Type", "Location")}
    body = r.content
    if r.status_code >= 300 and body:
        body = _error_fields(body)
    return r.status_code, h, body


def test_same_responses_as_jax_server(server, torch_server):
    bucket = f"cmp-{uuid.uuid4().hex[:12]}"
    jc = SigV4Client(server, S3_ACCESS, S3_SECRET)
    tc = SigV4Client(torch_server, S3_ACCESS, S3_SECRET)
    for name, method, path, headers, body in _script(bucket):
        want = _view(jc.request(method, path, headers=headers, data=body))
        got = _view(tc.request(method, path, headers=headers, data=body))
        assert got == want, name


def test_bad_signature_matches_jax(server, torch_server):
    for url in (server, torch_server):
        r = SigV4Client(url, S3_ACCESS, "wrong-secret").get("/any/key")
        assert r.status_code == 403
        assert _error_fields(r.content)["Code"] == "SignatureDoesNotMatch"


def test_port_signer_is_accepted(torch_server):
    """chip_smoke.py's client path: http.client + the port's own signer,
    with an unsigned payload."""
    import http.client
    import urllib.parse

    from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, Credentials, sign_request

    host = urllib.parse.urlparse(torch_server).netloc
    creds = Credentials(S3_ACCESS, S3_SECRET)
    bucket = f"signer-{uuid.uuid4().hex[:8]}"
    data = _payload(70000, 4)
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        for method, path, body in (("PUT", f"/{bucket}", b""),
                                   ("PUT", f"/{bucket}/o", data),
                                   ("GET", f"/{bucket}/o", b"")):
            conn.request(method, urllib.parse.quote(path), body=body,
                         headers=sign_request(method, path, {}, {}, host, creds,
                                              UNSIGNED_PAYLOAD))
            r = conn.getresponse()
            got = r.read()
            assert r.status == 200, got
        assert got == data
    finally:
        conn.close()


def test_payload_hash_mismatch_matches_jax(server, torch_server):
    """A body that does not hash to its signed x-amz-content-sha256 is
    refused by both servers before anything commits."""
    import hashlib
    import http.client
    import urllib.parse

    from minio_tpu_torch.s3.sigv4 import Credentials, sign_request

    creds = Credentials(S3_ACCESS, S3_SECRET)
    bucket = f"sha-{uuid.uuid4().hex[:8]}"
    views = []
    for url in (server, torch_server):
        host = urllib.parse.urlparse(url).netloc
        conn = http.client.HTTPConnection(host, timeout=30)
        try:
            out = []
            for path, body, signed_body in ((f"/{bucket}", b"", b""),
                                            (f"/{bucket}/o", b"payload", b"other"),
                                            (f"/{bucket}/o", b"", b"")):
                method = "GET" if body == b"" and path.endswith("/o") else "PUT"
                conn.request(method, path, body=body, headers=sign_request(
                    method, path, {}, {}, host, creds,
                    hashlib.sha256(signed_body).hexdigest()))
                r = conn.getresponse()
                data = r.read()
                out.append((r.status, _error_fields(data) if r.status >= 300 else b""))
            views.append(out)
        finally:
            conn.close()
    assert views[0] == views[1]
    assert views[1][1][0] == 400
    assert views[1][1][1]["Code"] == "XAmzContentSHA256Mismatch"
    assert views[1][2][0] == 404
