"""SigV2 in the port (minio_tpu_torch/s3/sigv2.py and the server's
classification) against the JAX package, on the CPU.

- the string to sign of both modules over a seeded corpus of methods,
  headers (Content-MD5, Content-Type, x-amz-* with repeats and folded
  spaces, x-amz-date in place of Date) and subresources is equal; each
  module verifies what the other's signature covers, and both refuse a
  wrong key, an unknown access key and an expired presigned URL (an
  Expires in the past: no clock waits);
- over HTTP, each package on its own drives: header-signed PUT, GET,
  ?tagging and DELETE, presigned GET, a wrong signature and an expired
  URL, for the root and for an IAM user, answer as the JAX server's.

Tolerance: exact."""

import time
import urllib.parse

import numpy as np
import pytest
import requests

from minio_tpu.s3 import errors as jerrors
from minio_tpu.s3 import sigv2 as jsigv2
from minio_tpu.s3 import sigv4 as jsigv4
from minio_tpu_torch.s3 import errors as perrors
from minio_tpu_torch.s3 import sigv2, sigv4
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

SUBS = ["", "acl", "uploads", "versionId", "tagging", "policy", "delete", "location",
        "partNumber", "uploadId", "list-type", "prefix", "retention", "legal-hold"]


def _corpus(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        method = str(rng.choice(["GET", "PUT", "HEAD", "DELETE", "POST"]))
        headers = {}
        if rng.random() < 0.5:
            headers["Content-MD5"] = "1B2M2Y8AsgTpgAEAAAAAAA=="
        if rng.random() < 0.5:
            headers["Content-Type"] = str(rng.choice(["text/plain", "application/xml"]))
        if rng.random() < 0.5:
            headers["X-Amz-Meta-Note"] = str(rng.choice(["a  b", " spaced ", "x"]))
        if rng.random() < 0.5:
            headers["x-amz-date"] = "Sun, 18 Oct 2026 12:00:00 GMT"
        else:
            headers["Date"] = "Sun, 18 Oct 2026 12:00:00 GMT"
        path = str(rng.choice(["/", "/bkt", "/bkt/a/b c", "/bkt/ünï"]))
        items = [(str(k), str(rng.choice(["", "v1", "a b"])))
                 for k in rng.choice(SUBS, size=int(rng.integers(0, 3)), replace=False) if k]
        yield method, headers, path, items


class _Headers(dict):
    """A case-insensitive header map, as the servers hand the modules."""

    def get(self, key, default=None):
        for k, v in self.items():
            if k.lower() == key.lower():
                return v
        return default


@pytest.mark.parametrize("seed", range(4))
def test_string_to_sign_and_verification_equal_jax(seed):
    for method, headers, path, items in _corpus(seed):
        h = _Headers(headers)
        slot = "" if h.get("x-amz-date") else h.get("Date", "")
        sts = sigv2._string_to_sign(method, h, path, items, slot)
        assert sts == jsigv2._string_to_sign(method, h, path, items, slot)
        sig = ti.v2_sign("secret-1", sts)
        h["Authorization"] = f"AWS ak1:{sig}"
        for mod, creds, errors in ((sigv2, sigv4.Credentials, perrors),
                                   (jsigv2, jsigv4.Credentials, jerrors)):
            got = []
            for lookup in ({"ak1": creds("ak1", "secret-1")}.get,
                           {"ak1": creds("ak1", "secret-2")}.get, {}.get):
                try:
                    mod.verify_header_auth(method, path, items, h, lookup)
                    got.append("ok")
                except errors.S3Error as e:
                    got.append(e.api.code)
            assert got == ["ok", "SignatureDoesNotMatch", "InvalidAccessKeyId"]


@pytest.mark.parametrize("delta", [-5, 3600])
def test_presigned_equals_jax(delta):
    expires = int(time.time()) + delta
    url = sigv2.presign_url("GET", "/bkt/k y", "ak1", "secret-1", expires)
    path, _, qs = url.partition("?")
    items = urllib.parse.parse_qsl(qs)
    got = []
    for mod, creds, errors in ((sigv2, sigv4.Credentials, perrors),
                               (jsigv2, jsigv4.Credentials, jerrors)):
        assert mod.is_v2_presigned(dict(items))
        try:
            mod.verify_presigned("GET", urllib.parse.unquote(path), items, _Headers(),
                                 {"ak1": creds("ak1", "secret-1")}.get)
            got.append("ok")
        except errors.S3Error as e:
            got.append(e.api.code)
    assert got == (["AccessDenied"] * 2 if delta < 0 else ["ok", "ok"])


def _v2_script(url):
    cl = ti.root(url)
    cl.put("/v2b")
    ti.add_user(cl, "alice", "alice-secret-1", "readonly")
    out = []

    def rec(r):
        out.append((r.status_code, ti.error_code(r) if r.status_code >= 300 else r.content))

    root = (ti.S3_ACCESS, ti.S3_SECRET)
    rec(ti.v2_request(url, "PUT", "/v2b/k", *root, data=b"v2 bytes",
                      headers={"Content-Type": "text/plain", "x-amz-meta-a": "1"}))
    rec(ti.v2_request(url, "GET", "/v2b/k", *root))
    rec(ti.v2_request(url, "PUT", "/v2b/k", *root, subresources="tagging",
                      data=b"<Tagging><TagSet><Tag><Key>a</Key><Value>b</Value></Tag>"
                           b"</TagSet></Tagging>"))
    rec(ti.v2_request(url, "GET", "/v2b/k", *root, subresources="tagging"))
    rec(ti.v2_request(url, "GET", "/v2b/k", "alice", "alice-secret-1"))
    rec(ti.v2_request(url, "PUT", "/v2b/alice", "alice", "alice-secret-1", data=b"no"))
    rec(ti.v2_request(url, "GET", "/v2b/k", "alice", "wrong"))
    rec(ti.v2_request(url, "GET", "/v2b/k", "nobody", "x"))
    rec(requests.get(ti.v2_presigned(url, "GET", "/v2b/k", "alice", "alice-secret-1",
                                     int(time.time()) + 60), timeout=30))
    rec(requests.get(ti.v2_presigned(url, "GET", "/v2b/k", "alice", "alice-secret-1",
                                     int(time.time()) - 1), timeout=30))
    rec(requests.put(ti.v2_presigned(url, "GET", "/v2b/k", "alice", "alice-secret-1",
                                     int(time.time()) + 60), data=b"x", timeout=30))
    rec(ti.v2_request(url, "DELETE", "/v2b/k", *root))
    rec(ti.v2_request(url, "GET", "/v2b/k", *root))
    return out


def test_v2_requests_answer_as_jax(planes_off, tmp_path):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _v2_script(srv.url)
        finally:
            srv.close()
    assert results["torch"] == results["jax"]
    assert results["torch"][1] == (200, b"v2 bytes")
