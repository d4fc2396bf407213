"""IAM in the port (minio_tpu_torch/iam/: condition.py, policy.py,
actions.py, sys.py; the admin IAM routes and the admin authorization)
against the JAX package, on the CPU.

- Policy.is_allowed over a seeded corpus of policies x requests for every
  condition operator of minio_tpu/iam/condition.py:135-265 and its
  negations, keys present and missing, Allow and Deny; strict validation
  and the fail-closed reading of a stored condition that cannot be
  evaluated; action, NotAction and resource matching; merge_is_allowed;
  the canned policies; action_for over the request shapes;
- IAMSys: the same operations on both (users, groups, canned and custom
  policies, service accounts, temporary credentials with session
  policies) give the same identities and decisions, with the JAX
  package's randomness and clock pinned in both;
- over HTTP: the admin IAM routes answer as the JAX server's; an IAM user
  is authorized by its policies on both servers (S3 and admin ops); the
  users, service accounts and temporary credentials of a JAX deployment
  authenticate through the port on the same drives.

Tolerance: exact."""

import json
import types

import numpy as np
import pytest

from minio_tpu.iam import actions as jactions
from minio_tpu.iam import condition as jcond
from minio_tpu.iam import policy as jpolicy
from minio_tpu.iam import sys as jsys
from minio_tpu.utils import errors as jse
from minio_tpu_torch.iam import actions, condition, policy
from minio_tpu_torch.iam import sys as psys
from minio_tpu_torch.utils import errors as se
from tests import torch_atrest as ta
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

# operator -> (condition key, policy values, request values to draw from)
OPERATOR_CASES = {
    "String": ("aws:username", ["alice", "bob", "Alice"], ["alice", "ALICE", "carol", "bob"]),
    "StringEqualsIgnoreCase": ("s3:x-amz-acl", ["Private", "public-read"],
                               ["private", "PUBLIC-READ", "authenticated-read"]),
    "StringLike": ("s3:prefix", ["home/*", "logs/20??/*", "a[b]*"],
                   ["home/x", "logs/2024/a", "logs/202/a", "ab", "a[b]c", "other"]),
    "Bool": ("aws:securetransport", ["true"], ["true", "false", "True", "yes"]),
    "Null": ("s3:x-amz-server-side-encryption", ["true"], ["AES256", "aws:kms"]),
    "BinaryEquals": ("s3:x-amz-content-sha256", ["aGVsbG8=", "d29ybGQ="],
                     ["hello", "world", "HELLO"]),
    "Numeric": ("s3:max-keys", ["10", "100.5"], ["9", "10", "100", "101", "abc", "10.0"]),
    "Date": ("aws:currenttime", ["2026-01-01T00:00:00Z", "1800000000"],
             ["2025-12-31T23:59:59Z", "2026-01-01T00:00:00Z", "2026-06-01T00:00:00+02:00",
              "1800000001", "bad-date"]),
    "IpAddress": ("aws:sourceip", ["10.0.0.0/8", "2001:db8::/32"],
                  ["10.1.2.3", "11.0.0.1", "::ffff:10.9.9.9", "2001:db8::1", "nonsense"]),
}
OPERATORS = sorted(jcond.SUPPORTED_OPERATORS)


def _family(op: str) -> str:
    if op.startswith("String"):
        return "StringEqualsIgnoreCase" if "IgnoreCase" in op else \
            ("StringLike" if "Like" in op else "String")
    for fam in ("Numeric", "Date", "Bool", "Null", "BinaryEquals"):
        if op.startswith(fam):
            return fam
    return "IpAddress"


def test_operators_are_the_jax_packages():
    assert condition.SUPPORTED_OPERATORS == jcond.SUPPORTED_OPERATORS
    assert len(OPERATORS) == 23


def _both(fn):
    """fn(module triple) for the port and the JAX package; -> the two
    results, an exception's class name standing for it."""
    out = []
    for mods in ((policy, condition, se), (jpolicy, jcond, jse)):
        try:
            out.append(fn(*mods))
        except Exception as e:  # noqa: BLE001 - compared by class
            out.append(type(e).__name__)
    return out


@pytest.mark.parametrize("op", OPERATORS)
def test_is_allowed_equals_jax_for_every_operator(op):
    key, want, have = OPERATOR_CASES[_family(op)]
    rng = np.random.default_rng(OPERATORS.index(op))
    for _ in range(40):
        values = list(rng.choice(want, size=int(rng.integers(1, len(want) + 1)), replace=False))
        if op == "Null":
            values = [str(rng.choice(["true", "false"]))]
        effect = str(rng.choice(["Allow", "Deny"]))
        doc = {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::*"]}
            if effect == "Deny" else None,
            {"Effect": effect, "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::b/*"],
             "Condition": {op: {key: values if len(values) > 1 else values[0]}}}]}
        doc["Statement"] = [s for s in doc["Statement"] if s]
        raw = json.dumps(doc)
        for _ in range(6):
            ctx = {}
            if rng.random() < 0.8:
                ctx[key] = list(rng.choice(have, size=int(rng.integers(1, 3)), replace=False))
            if rng.random() < 0.5:
                ctx["aws:username"] = ["alice"]
            got = _both(lambda p, c, e: p.Policy.parse(raw).is_allowed(
                p.PolicyArgs(action="s3:GetObject", bucket="b", object="k",
                             conditions=dict(ctx))))
            assert got[0] == got[1], (raw, ctx)


BAD_CONDITIONS = [
    {"StringWobbles": {"aws:username": "x"}},
    {"StringEquals": {"aws:nosuchkey": "x"}},
    {"StringEquals": {}},
    {"StringEquals": {"aws:username": []}},
    {"Bool": {"aws:securetransport": "maybe"}},
    {"Null": {"aws:username": ["true", "false"]}},
    {"NumericLessThan": {"s3:max-keys": "ten"}},
    {"DateEquals": {"aws:currenttime": "yesterday"}},
    {"IpAddress": {"aws:sourceip": "999.1.1.1"}},
    {"BinaryEquals": {"s3:x-amz-content-sha256": "!!notbase64"}},
    "not-a-dict",
    {"StringLike": {"jwt:groups": "admins*"}},
    {"StringEquals": {"ldap:username": "u1"}},
]


@pytest.mark.parametrize("cond", BAD_CONDITIONS, ids=range(len(BAD_CONDITIONS)))
def test_validation_and_fail_closed_equal_jax(cond):
    """validate() refuses what cannot be evaluated; a stored document with
    it makes a Deny apply and an Allow not apply, in both."""
    for effect in ("Allow", "Deny"):
        raw = json.dumps({"Statement": [
            {"Effect": "Allow", "Action": "s3:*", "Resource": "*"},
            {"Effect": effect, "Action": "s3:GetObject", "Resource": "*",
             "Condition": cond}]})
        assert _both(lambda p, c, e: p.Policy.parse(raw).validate()) in (
            [None, None], ["MalformedPolicy", "MalformedPolicy"])
        got = _both(lambda p, c, e: p.Policy.parse(raw).is_allowed(
            p.PolicyArgs(action="s3:GetObject", bucket="b", object="k",
                         conditions={"aws:username": ["u1"], "ldap:username": ["u1"]})))
        assert got[0] == got[1]


MATCH_POLICIES = [
    {"Statement": [{"Effect": "Allow", "Action": "s3:Get*", "Resource": "arn:aws:s3:::b/*"}]},
    {"Statement": [{"Effect": "Allow", "NotAction": ["s3:Delete*"], "Resource": "*"}]},
    {"Statement": [{"Effect": "Allow", "Action": "s3:*", "Resource": "arn:aws:s3:::b/a?c*"}]},
    {"Statement": [{"Effect": "Allow", "Action": "s3:*", "Resource": "arn:aws:s3:::b/[x]*"}]},
    {"Statement": [{"Effect": "Allow", "Action": ["s3:ListBucket", "s3:DeleteBucket",
                                                  "s3:GetBucketLocation"],
                    "Resource": "arn:aws:s3:::b/*"}]},
    {"Statement": [{"Effect": "Allow", "Action": "*", "Resource": "*"},
                   {"Effect": "Deny", "Action": "s3:PutObject", "Resource": "arn:aws:s3:::b"}]},
    {"Statement": {"Effect": "Allow", "Action": "admin:*"}},
    {"Statement": [{"Effect": "Maybe", "Action": "s3:*"}]},
]
ARGS = [("s3:GetObject", "b", "abc"), ("s3:GetObject", "b", "[x]y"), ("s3:PutObject", "b", ""),
        ("s3:DeleteObject", "b", "k"), ("s3:ListBucket", "b", ""), ("s3:DeleteBucket", "b", ""),
        ("s3:GetBucketLocation", "b", ""), ("admin:ServerInfo", "", ""),
        ("s3:GetObject", "c", "abc")]


@pytest.mark.parametrize("doc", MATCH_POLICIES, ids=range(len(MATCH_POLICIES)))
def test_action_and_resource_matching_equals_jax(doc):
    raw = json.dumps(doc)
    for action, bucket, key in ARGS:
        got = _both(lambda p, c, e: p.Policy.parse(raw).is_allowed(
            p.PolicyArgs(action=action, bucket=bucket, object=key)))
        assert got[0] == got[1], (doc, action, bucket, key)


def test_merge_and_canned_policies_equal_jax():
    assert policy.CANNED_POLICIES == jpolicy.CANNED_POLICIES
    docs = [json.dumps(d) for d in MATCH_POLICIES[:7]] + list(policy.CANNED_POLICIES.values())
    rng = np.random.default_rng(5)
    for _ in range(60):
        pick = list(rng.choice(len(docs), size=int(rng.integers(1, 4)), replace=False))
        for action, bucket, key in ARGS:
            got = _both(lambda p, c, e: p.merge_is_allowed(
                [p.Policy.parse_cached(docs[i]) for i in pick],
                p.PolicyArgs(action=action, bucket=bucket, object=key)))
            assert got[0] == got[1]


@pytest.mark.parametrize("method", ["GET", "HEAD", "PUT", "DELETE", "POST"])
def test_action_for_equals_jax(method):
    subs = [set(), {"versionId"}, {"uploads"}, {"uploadId"}, {"delete"}, {"location"},
            {"versions"}, {"retention"}, {"legal-hold"}, {"tagging"}, {"acl"}]
    subs += [{name} for name in actions._BUCKET_SUB]
    for sub in subs:
        for bucket, key in (("", ""), ("b", ""), ("b", "k")):
            for headers in (None, {"x-amz-copy-source": "/a/b"}):
                assert actions.action_for(method, sub, bucket, key, headers) == \
                    jactions.action_for(method, sub, bucket, key, headers)


# --- IAMSys ---------------------------------------------------------------------

class _Counter:
    """A stand-in for the `secrets` module: token bytes from one seeded
    stream, so both packages draw the same keys."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def token_bytes(self, n):
        return self.rng.bytes(n)

    def token_hex(self, n):
        return self.token_bytes(n).hex()


@pytest.fixture
def pinned(monkeypatch):
    """Pin both packages' IAM randomness and clock (`pysecrets`, `time`)."""
    clock = types.SimpleNamespace(now=1_800_000_000.0)
    fake_time = types.SimpleNamespace(time=lambda: clock.now)
    for mod, seed in ((psys, 1), (jsys, 1)):
        monkeypatch.setattr(mod, "pysecrets", _Counter(seed))
        monkeypatch.setattr(mod, "time", fake_time)
    return clock


SESSION = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::b/pub/*"]}]})
CUSTOM = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:PutObject", "s3:GetObject"],
     "Resource": ["arn:aws:s3:::b/${aws:username}/*", "arn:aws:s3:::b/pub/*"]},
    {"Effect": "Deny", "Action": ["s3:*"], "Resource": ["arn:aws:s3:::b/secret*"],
     "Condition": {"StringNotEquals": {"aws:username": ["root"]}}}]})


def _populate(iam):
    """One script of IAM operations; -> the generated credentials."""
    iam.set_user("alice", "alice-secret")
    iam.set_user("bob", "bob-secret")
    iam.set_user("carol", "carol-secret", status="off")
    iam.set_policy("custom", CUSTOM)
    iam.attach_policy("alice", ["readonly"])
    iam.add_group_members("writers", ["bob", "alice"])
    iam.attach_policy("writers", ["custom"], group=True)
    svc = iam.add_service_account("alice", SESSION)
    svc_root = iam.add_service_account("root", "", "SVCROOT", "svc-root-secret")
    sts = iam.assume_role("bob", 1800, SESSION)
    sts_plain = iam.assume_role("alice", 100)
    fed = iam.assume_role_with_claims("sub-1", ["readwrite"], 600,
                                      claims={"jwt:sub": "sub-1"})
    return [svc.access_key, svc_root.access_key, sts.access_key, sts_plain.access_key,
            fed.access_key]


def _identity_view(ident):
    return (ident.access_key, ident.kind, ident.parent, ident.policies,
            ident.session_policy is not None, ident.claims)


def test_iam_sys_decisions_equal_jax(pinned):
    port, jax = psys.IAMSys("root", "root-secret"), jsys.IAMSys("root", "root-secret")
    keys = _populate(port)
    assert keys == _populate(jax)
    assert {k: vars(v) for k, v in port.temp_creds.items()} == \
        {k: vars(v) for k, v in jax.temp_creds.items()}
    who = ["root", "alice", "bob", "carol", "nobody"] + keys
    for ak in who:
        secrets, idents = [], []
        for iam in (port, jax):
            try:
                secrets.append(iam.get_secret(ak))
            except (se.InvalidAccessKey, jse.InvalidAccessKey):
                secrets.append(None)
        assert secrets[0] == secrets[1], ak
        for iam in (port, jax):
            try:
                idents.append(_identity_view(iam.identify(ak)))
            except (se.InvalidAccessKey, jse.InvalidAccessKey):
                idents.append("InvalidAccessKey")
        assert idents[0] == idents[1], ak
        if idents[0] == "InvalidAccessKey":
            continue
        for action in ("s3:GetObject", "s3:PutObject", "s3:DeleteObject", "admin:ServerInfo"):
            for key in ("pub/x", "bob/x", "alice/x", "secret1"):
                decisions = []
                for iam, mod in ((port, policy), (jax, jpolicy)):
                    args = mod.PolicyArgs(action=action, bucket="b", object=key,
                                          conditions={"aws:username": [ak]})
                    decisions.append(iam.is_allowed(iam.identify(ak), args))
                assert decisions[0] == decisions[1], (ak, action, key)
    # The clock: temporary credentials expire in both at once.
    pinned.now += 1000
    assert [port.verify_session_token(k, port.temp_creds[k].session_token) for k in keys] == \
        [jax.verify_session_token(k, jax.temp_creds[k].session_token) for k in keys] == \
        [True, True, True, False, False]


def test_iam_sys_errors_equal_jax(pinned):
    port, jax = psys.IAMSys("root", "root-secret"), jsys.IAMSys("root", "root-secret")
    for iam in (port, jax):
        _populate(iam)
    calls = [lambda i: i.set_user("root", "x"), lambda i: i.delete_user("nobody"),
             lambda i: i.set_user_status("nobody", "off"),
             lambda i: i.set_policy("bad", "{"), lambda i: i.delete_policy("readonly"),
             lambda i: i.delete_policy("nope"), lambda i: i.attach_policy("alice", ["nope"]),
             lambda i: i.attach_policy("nogroup", ["readonly"], group=True),
             lambda i: i.attach_policy("nobody", ["readonly"]),
             lambda i: i.add_group_members("g", ["nobody"]),
             lambda i: i.remove_group_members("nogroup", ["a"]),
             lambda i: i.remove_group_members("writers", []),
             lambda i: i.delete_service_account("nope"),
             lambda i: i.assume_role("alice", 900, '{"Statement": [{"Effect": "Allow", '
                                     '"Action": "s3:*", "Condition": {"Bad": {}}}]}'),
             lambda i: i.delete_user("bob")]
    for call in calls:
        got = []
        for iam in (port, jax):
            try:
                call(iam)
                got.append(None)
            except Exception as e:  # noqa: BLE001 - compared by class
                got.append(type(e).__name__)
        assert got[0] == got[1]
    assert sorted(port.temp_creds) == sorted(jax.temp_creds)


# --- over HTTP ------------------------------------------------------------------

def _admin_script(cl):
    out = []

    def rec(r):
        body = r.content
        if r.status_code == 200 and body[:1] == b"{":
            body = json.loads(body)
        out.append((r.status_code, ti.error_code(r) if r.status_code >= 300 else body))

    rec(ti.admin(cl, "PUT", "add-user", {"accessKey": "alice"}, {"secretKey": "alice-secret"}))
    rec(ti.admin(cl, "PUT", "add-user", {"accessKey": "bob"},
                 {"secretKey": "bob-secret", "status": "off"}))
    rec(ti.admin(cl, "PUT", "add-user", {"accessKey": ti.S3_ACCESS}, {"secretKey": "x"}))
    rec(ti.admin(cl, "GET", "list-users"))
    rec(ti.admin(cl, "POST", "set-user-status", {"accessKey": "bob", "status": "on"}))
    rec(ti.admin(cl, "POST", "set-user-status", {"accessKey": "nobody", "status": "on"}))
    rec(ti.admin(cl, "PUT", "add-canned-policy", {"name": "custom"}, CUSTOM.encode()))
    rec(ti.admin(cl, "PUT", "add-canned-policy", {"name": "broken"}, b'{"Statement": 5'))
    rec(ti.admin(cl, "GET", "list-canned-policies"))
    rec(ti.admin(cl, "POST", "set-user-or-group-policy",
                 {"userOrGroup": "alice", "policyName": "readonly,custom"}))
    rec(ti.admin(cl, "POST", "set-user-or-group-policy",
                 {"userOrGroup": "alice", "policyName": "nope"}))
    rec(ti.admin(cl, "POST", "update-group-members", None,
                 {"group": "devs", "members": ["alice", "bob"]}))
    rec(ti.admin(cl, "POST", "set-user-or-group-policy",
                 {"userOrGroup": "devs", "policyName": "readwrite", "isGroup": "true"}))
    rec(ti.admin(cl, "POST", "update-group-members", None,
                 {"group": "devs", "members": ["bob"], "isRemove": True}))
    rec(ti.admin(cl, "PUT", "add-service-account", None,
                 {"parent": "alice", "accessKey": "SVCALICE", "secretKey": "svc-secret-1"}))
    rec(ti.admin(cl, "POST", "delete-service-account", {"accessKey": "SVCALICE"}))
    rec(ti.admin(cl, "POST", "delete-service-account", {"accessKey": "SVCALICE"}))
    rec(ti.admin(cl, "POST", "remove-canned-policy", {"name": "readonly"}))
    rec(ti.admin(cl, "POST", "remove-canned-policy", {"name": "custom"}))
    rec(ti.admin(cl, "POST", "remove-user", {"accessKey": "bob"}))
    rec(ti.admin(cl, "POST", "remove-user", {"accessKey": "bob"}))
    rec(ti.admin(cl, "GET", "list-users"))
    return out


def test_admin_iam_routes_answer_as_jax(planes_off, tmp_path):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _admin_script(ti.root(srv.url))
        finally:
            srv.close()
    assert results["torch"] == results["jax"]


def _user_script(url):
    """A user's and an anonymous client's S3 and admin calls; -> statuses."""
    cl = ti.root(url)
    cl.put("/userb")
    cl.put("/userb/pub/x", data=b"public")
    ti.admin(cl, "PUT", "add-canned-policy", {"name": "custom"},
             CUSTOM.replace("arn:aws:s3:::b/", "arn:aws:s3:::userb/")
             .replace("${aws:username}", "alice").encode())
    alice = ti.add_user(cl, "alice", "alice-secret", "custom")
    diag = ti.add_user(cl, "diag", "diag-secret", "diagnostics")
    off = ti.add_user(cl, "off", "off-secret", "readwrite")
    ti.admin(cl, "POST", "set-user-status", {"accessKey": "off", "status": "off"})
    calls = [alice.put("/userb/alice/1", data=b"mine"), alice.put("/userb/bob/1", data=b"x"),
             alice.get("/userb/pub/x"), alice.get("/userb/alice/1"),
             alice.delete("/userb/alice/1"), alice.get("/userb"),
             alice.put("/userb/secret1", data=b"s"), alice.get("/"),
             ti.admin(alice, "GET", "info"), ti.admin(alice, "GET", "list-users"),
             ti.admin(diag, "GET", "info"), ti.admin(diag, "GET", "list-users"),
             diag.get("/minio/v2/metrics/cluster"), alice.get("/minio/v2/metrics/cluster"),
             off.get("/userb/pub/x"),
             ti.anon(url, "GET", "/userb/pub/x"), ti.anon(url, "GET", "/minio/admin/v3/info")]
    return [(r.status_code, ti.error_code(r) if r.status_code >= 300 else "") for r in calls]


def test_users_are_authorized_as_in_jax(planes_off, tmp_path):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _user_script(srv.url)
        finally:
            srv.close()
    assert results["torch"] == results["jax"]
    assert results["torch"][0] == (200, "") and results["torch"][1] == (403, "AccessDenied")


def test_jax_identities_authenticate_through_the_port(planes_off, tmp_path):
    """Users, service accounts and temporary credentials a JAX deployment
    made (sealed in its IAM store on the drives) sign requests the port
    accepts, with the same rights; a session token is still required."""
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    js = ta.JaxServer(paths)
    try:
        cl = ti.root(js.url)
        cl.put("/idb")
        cl.put("/idb/obj", data=b"shared object")
        ti.add_user(cl, "alice", "alice-secret", "readonly")
        r = ti.admin(cl, "PUT", "add-service-account", None,
                     {"parent": "alice", "accessKey": "SVCA", "secretKey": "svc-a-secret"})
        assert r.status_code == 200, r.text
        tc = js.srv.iam.assume_role("alice", 3600)
    finally:
        js.close()
    ts = ta.port_server(paths)
    try:
        for ak, sk, token in (("alice", "alice-secret", ""), ("SVCA", "svc-a-secret", ""),
                              (tc.access_key, tc.secret_key, tc.session_token)):
            c = ti.SigV4Client(ts.url, ak, sk, session_token=token)
            assert c.get("/idb/obj").content == b"shared object", ak
            r = c.put("/idb/new", data=b"x")
            assert (r.status_code, ti.error_code(r)) == (403, "AccessDenied"), ak
        r = ti.SigV4Client(ts.url, tc.access_key, tc.secret_key).get("/idb/obj")
        assert (r.status_code, ti.error_code(r)) == (400, "InvalidToken")
    finally:
        ts.close()
