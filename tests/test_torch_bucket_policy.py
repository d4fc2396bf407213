"""Bucket policies in the port (the server's _check_access and the ?policy
routes) against the JAX package, on the CPU.

- F2: a bucket document the JAX server wrote, holding a Deny of
  s3:DeleteObject for "*" and an anonymous Allow of s3:GetObject: through
  the port the root's DELETE answers AccessDenied with the object intact,
  and an unsigned GET returns the bytes the JAX server returns (before the
  repair the port ignored the document: it deleted, and refused the GET);
- the decision order: a seeded grid of bucket policies x identities
  (root, user, anonymous) x actions x condition contexts through both
  servers' _check_access, over the same IAM state;
- the ?policy routes (PUT, GET, DELETE, NoSuchBucketPolicy, a statement
  without Principal, a condition that cannot be evaluated) answer as the
  JAX server's, each package on its own drives.

Tolerance: exact."""

import json
import types

import numpy as np
import pytest

from minio_tpu.iam import sys as jsys
from minio_tpu.s3 import errors as jerrors
from minio_tpu.s3.server import S3Server as JaxS3Server
from tests import torch_atrest as ta
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

F2_POLICY = {"Version": "2012-10-17", "Statement": [
    {"Effect": "Deny", "Principal": "*", "Action": ["s3:DeleteObject"],
     "Resource": ["arn:aws:s3:::polb/*"]},
    {"Effect": "Allow", "Principal": {"AWS": ["*"]}, "Action": ["s3:GetObject"],
     "Resource": ["arn:aws:s3:::polb/*"]}]}


def _jax_writes_policy_bucket(paths):
    js = ta.JaxServer(paths)
    try:
        cl = ti.root(js.url)
        assert cl.put("/polb").status_code == 200
        data = ta.payload(50_000, 21)
        assert cl.put("/polb/obj", data=data).status_code == 200
        r = cl.put("/polb", data=json.dumps(F2_POLICY).encode(), query={"policy": ""})
        assert r.status_code == 204, r.text
        jax_delete = cl.delete("/polb/obj")
        jax_get = ti.anon(js.url, "GET", "/polb/obj")
        return data, jax_delete, jax_get
    finally:
        js.close()


def test_f2_jax_bucket_policy_deny_binds_the_root(planes_off, tmp_path):
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    data, jax_delete, _ = _jax_writes_policy_bucket(paths)
    assert (jax_delete.status_code, ti.error_code(jax_delete)) == (403, "AccessDenied")
    ts = ta.port_server(paths)
    try:
        cl = ti.root(ts.url)
        r = cl.delete("/polb/obj")
        assert (r.status_code, ti.error_code(r)) == (403, "AccessDenied")
        assert cl.get("/polb/obj").content == data
        # The Deny names DeleteObject only: the root still writes.
        assert cl.put("/polb/other", data=b"ok").status_code == 200
    finally:
        ts.close()


def test_f2_jax_anonymous_allow_is_served(planes_off, tmp_path):
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    data, _, jax_get = _jax_writes_policy_bucket(paths)
    assert jax_get.status_code == 200 and jax_get.content == data
    ts = ta.port_server(paths)
    try:
        r = ti.anon(ts.url, "GET", "/polb/obj")
        assert r.status_code == 200 and r.content == jax_get.content
        # Only what the policy allows: no anonymous listing, PUT or DELETE.
        for method, path in (("GET", "/polb"), ("PUT", "/polb/anon"),
                             ("DELETE", "/polb/obj")):
            r = ti.anon(ts.url, method, path)
            assert (r.status_code, ti.error_code(r)) == (403, "AccessDenied"), method
    finally:
        ts.close()


# --- the decision order -------------------------------------------------------

ACTIONS = ("s3:GetObject", "s3:PutObject", "s3:DeleteObject", "s3:ListBucket",
           "s3:DeleteObjectVersion", "s3:GetBucketPolicy")


def _random_policy(rng) -> dict:
    stmts = []
    for _ in range(int(rng.integers(1, 4))):
        st = {"Effect": str(rng.choice(["Allow", "Deny"])),
              "Principal": str(rng.choice(["*", "alice", "bob"])) if rng.random() < 0.5
              else {"AWS": [str(rng.choice(["*", "alice", "bob"]))]},
              "Action": [str(a) for a in rng.choice(
                  list(ACTIONS) + ["s3:*", "s3:Get*"], size=int(rng.integers(1, 3)),
                  replace=False)],
              "Resource": [str(rng.choice(["arn:aws:s3:::bkt/*", "arn:aws:s3:::bkt",
                                           "arn:aws:s3:::bkt/a*", "arn:aws:s3:::*"]))]}
        if rng.random() < 0.4:
            st["Condition"] = {str(rng.choice(["IpAddress", "NotIpAddress"])): {
                "aws:SourceIp": str(rng.choice(["10.0.0.0/8", "192.168.1.0/24"]))}}
        stmts.append(st)
    return {"Version": "2012-10-17", "Statement": stmts}


def _deciders():
    """_check_access of each package's server over one bucket document and
    one IAM state: alice has readonly, bob nothing."""
    from minio_tpu_torch.iam import sys as psys
    from minio_tpu_torch.s3.errors import S3Error
    from minio_tpu_torch.s3.server import S3Server

    out = {}
    for name, cls, sysmod, err in (("jax", JaxS3Server, jsys, jerrors.S3Error),
                                   ("torch", S3Server, psys, S3Error)):
        iam = sysmod.IAMSys("root", "root-secret")
        iam.set_user("alice", "alice-secret")
        iam.set_user("bob", "bob-secret")
        iam.attach_policy("alice", ["readonly"])
        doc = {}
        fake = types.SimpleNamespace(
            iam=iam, bucket_meta=types.SimpleNamespace(
                get=lambda b, doc=doc: types.SimpleNamespace(policy_json=doc.get(b, b""))))

        def decide(who, action, key, ctx, fake=fake, iam=iam, sysmod=sysmod, cls=cls,
                   err=err, doc=doc, name=name):
            ident = sysmod.ANONYMOUS if who == "anonymous" else iam.identify(who)
            # The port's caller hands it the document it read for the request.
            extra = (doc.get("bkt", b""),) if name == "torch" else ()
            try:
                cls._check_access(fake, ident, action, "bkt", key, ctx, *extra)
                return "allow"
            except err as e:
                return e.api.code

        out[name] = (decide, doc)
    return out


@pytest.mark.parametrize("seed", range(12))
def test_check_access_order_equals_jax(seed):
    rng = np.random.default_rng(seed)
    deciders = _deciders()
    for _ in range(4):
        raw = json.dumps(_random_policy(rng)).encode()
        for _decide, doc in deciders.values():
            doc["bkt"] = raw
        for who in ("root", "alice", "bob", "anonymous"):
            for action in ACTIONS:
                key = "" if action in ("s3:ListBucket", "s3:GetBucketPolicy") else \
                    str(rng.choice(["a1", "b2"]))
                ctx = {"aws:sourceip": [str(rng.choice(["10.1.2.3", "192.168.1.7",
                                                        "8.8.8.8"]))]}
                got = {n: d(who, action, key, ctx) for n, (d, _doc) in deciders.items()}
                assert got["torch"] == got["jax"], (raw, who, action, key, ctx)


# --- the routes -----------------------------------------------------------------

def _policy_script(cl, url):
    out = []

    def rec(r):
        out.append((r.status_code, ti.error_code(r) if r.status_code >= 300 else r.content))

    good = json.dumps(F2_POLICY).encode()
    rec(cl.get("/nob", query={"policy": ""}))
    rec(cl.put("/polb"))
    rec(cl.put("/polb/obj", data=b"policy bytes"))
    rec(cl.get("/polb", query={"policy": ""}))
    rec(cl.delete("/polb", query={"policy": ""}))
    rec(cl.put("/polb", data=b"{not json", query={"policy": ""}))
    rec(cl.put("/polb", query={"policy": ""}, data=json.dumps(
        {"Statement": [{"Effect": "Allow", "Action": "s3:GetObject",
                        "Resource": "arn:aws:s3:::polb/*"}]}).encode()))
    rec(cl.put("/polb", query={"policy": ""}, data=json.dumps(
        {"Statement": [{"Effect": "Deny", "Principal": "*", "Action": "s3:GetObject",
                        "Resource": "arn:aws:s3:::polb/*",
                        "Condition": {"StringWobbles": {"aws:username": "x"}}}]}).encode()))
    rec(cl.put("/polb", query={"policy": ""}, data=json.dumps(
        {"Statement": [{"Effect": "Allow", "Principal": "*", "Action": "s3:GetObject",
                        "Resource": "arn:aws:s3:::polb/*",
                        "Condition": {"IpAddress": {"aws:SourceIp": "not-an-ip"}}}]}).encode()))
    rec(cl.put("/polb", query={"policy": ""}, data=good))
    rec(cl.get("/polb", query={"policy": ""}))
    rec(ti.anon(url, "GET", "/polb/obj"))
    rec(ti.anon(url, "GET", "/polb", params={"policy": ""}))
    rec(cl.delete("/polb/obj"))
    rec(cl.delete("/polb", query={"policy": ""}))
    rec(cl.get("/polb", query={"policy": ""}))
    rec(ti.anon(url, "GET", "/polb/obj"))
    rec(cl.delete("/polb/obj"))
    return out


def test_policy_routes_answer_as_jax(planes_off, tmp_path):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _policy_script(ti.root(srv.url), srv.url)
        finally:
            srv.close()
    assert results["torch"] == results["jax"]


def test_stored_policy_that_cannot_be_evaluated_is_refused():
    """bucket/meta.py validates on every write path, as the JAX package's."""
    from minio_tpu_torch.bucket.meta import BucketMetadataSys
    from minio_tpu_torch.utils import errors as se

    class Store:
        docs = {}

        def read_sys_config(self, path):
            if path not in self.docs:
                raise se.FileNotFound(path)
            return self.docs[path]

        def write_sys_config(self, path, data):
            self.docs[path] = data

        def sys_config_signature(self, path):
            return (None,)

    bm = BucketMetadataSys(Store())
    bad = json.dumps({"Statement": [{"Effect": "Deny", "Principal": "*", "Action": "s3:*",
                                     "Condition": {"Bool": {"aws:SecureTransport": "maybe"}}}]})
    with pytest.raises(se.MalformedPolicy):
        bm.update("bkt", policy_json=bad.encode())
    assert not Store.docs
