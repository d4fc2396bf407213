"""STS in the port (the server's STS handler, iam/oidc.py, iam/ldap.py and
the session-token check) against the JAX package, on the CPU.

- AssumeRole: a user's temporary credentials work with their session
  token and answer InvalidToken without it or with another; a session
  policy narrows them; temporary credentials and the anonymous cannot
  assume a role; the answers of both servers agree, and the credentials
  expire under an injected clock (no waits);
- AssumeRoleWithWebIdentity and AssumeRoleWithClientGrants: JWTs signed
  with a locally generated RSA key (RS256, RS384, RS512) and an HS256
  shared secret, checked against a JWKS in the config; expired tokens,
  foreign keys, wrong audiences and missing policy claims refused alike;
  the JWT claims reach the condition context (jwt:sub);
- AssumeRoleWithLDAPIdentity: a simple bind to a stub directory on a
  local socket (it answers success for one DN and password); refused
  binds, missing fields and an unconfigured directory answer alike.

Tolerance: exact (statuses, error codes, rights of the credentials)."""

import base64
import hashlib
import hmac
import json
import socket
import threading
import time
import types
import xml.etree.ElementTree as ET

import pytest

from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

STS_NS = "{https://sts.amazonaws.com/doc/2011-06-15/}"


def _creds(r, action="AssumeRole"):
    res = ET.fromstring(r.content).find(f"{STS_NS}{action}Result/{STS_NS}Credentials")
    return tuple(res.findtext(STS_NS + k) for k in ("AccessKeyId", "SecretAccessKey",
                                                      "SessionToken", "Expiration"))


def _rec(r):
    return r.status_code, ti.error_code(r) if r.status_code >= 300 else ""


SESSION = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::stsb/pub/*"]}]})


def _assume_role_script(url):
    cl = ti.root(url)
    cl.put("/stsb")
    cl.put("/stsb/pub/a", data=b"public a")
    cl.put("/stsb/priv", data=b"private")
    bob = ti.add_user(cl, "bob", "bob-secret-1", "readwrite")
    out = []
    r = bob.post("/", data=b"Action=AssumeRole&DurationSeconds=900&Version=2011-06-15")
    out.append(_rec(r))
    ak, sk, token, _exp = _creds(r)
    good = ti.SigV4Client(url, ak, sk, session_token=token)
    out += [_rec(good.get("/stsb/priv")), _rec(good.put("/stsb/new", data=b"n")),
            _rec(ti.SigV4Client(url, ak, sk).get("/stsb/priv")),
            _rec(ti.SigV4Client(url, ak, sk, session_token=token[:-2] + "xx").get(
                "/stsb/priv")),
            _rec(good.post("/", data=b"Action=AssumeRole"))]
    r = bob.post("/", data=("Action=AssumeRole&Policy=" + SESSION).encode())
    out.append(_rec(r))
    narrow = ti.SigV4Client(url, *_creds(r)[:2], session_token=_creds(r)[2])
    out += [_rec(narrow.get("/stsb/pub/a")), _rec(narrow.get("/stsb/priv")),
            _rec(narrow.put("/stsb/pub/b", data=b"x"))]
    out += [_rec(ti.anon(url, "POST", "/", data=b"Action=AssumeRole")),
            _rec(bob.post("/", data=b"Action=AssumeRole&Policy=%7Bbad")),
            _rec(bob.post("/", data=b"Action=GetFederationToken")),
            _rec(ti.chunked_request(url, "PUT", "/stsb/chunked", ak, sk, b"z" * 70_000,
                                    session_token=token))]
    return out, (ak, sk, token)


def test_assume_role_answers_as_jax(planes_off, tmp_path, monkeypatch):
    from minio_tpu_torch.iam import sys as psys

    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg], (ak, sk, token) = _assume_role_script(srv.url)
            if pkg == "torch":
                # Past its 900 s: the credential is unknown (an injected clock).
                later = time.time() + 901
                with monkeypatch.context() as m:
                    m.setattr(psys, "time", types.SimpleNamespace(time=lambda: later))
                    r = ti.SigV4Client(srv.url, ak, sk, session_token=token).get(
                        "/stsb/priv")
                assert _rec(r) == (403, "InvalidAccessKeyId")
        finally:
            srv.close()
    assert results["torch"] == results["jax"]
    assert results["torch"][1:4] == [(200, ""), (200, ""), (400, "InvalidToken")]


# --- OpenID Connect ------------------------------------------------------------------

def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


@pytest.fixture(scope="module")
def rsa_keys():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return {kid: rsa.generate_private_key(public_exponent=65537, key_size=2048)
            for kid in ("k1", "k2")}


def _jwks(rsa_keys):
    keys = []
    for kid in ("k1",):
        pub = rsa_keys[kid].public_key().public_numbers()
        keys.append({"kty": "RSA", "kid": kid,
                     "n": _b64url(pub.n.to_bytes((pub.n.bit_length() + 7) // 8, "big")),
                     "e": _b64url(pub.e.to_bytes(3, "big"))})
    keys.append({"kty": "oct", "kid": "h1", "k": _b64url(b"shared-hmac-secret-0123456789")})
    return json.dumps({"keys": keys})


def _jwt(rsa_keys, claims, alg="RS256", kid="k1"):
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    head = _b64url(json.dumps({"alg": alg, "kid": kid, "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    msg = f"{head}.{body}".encode()
    if alg.startswith("HS"):
        sig = hmac.new(b"shared-hmac-secret-0123456789", msg, hashlib.sha256).digest()
    else:
        h = {"RS256": hashes.SHA256, "RS384": hashes.SHA384, "RS512": hashes.SHA512}[alg]()
        sig = rsa_keys[kid].sign(msg, padding.PKCS1v15(), h)
    return f"{head}.{body}.{_b64url(sig)}"


def _oidc_script(url, rsa_keys):
    cl = ti.root(url)
    cl.put("/oidcb")
    cl.put("/oidcb/obj", data=b"federated read")
    ti.admin(cl, "PUT", "add-canned-policy", {"name": "subonly"}, json.dumps(
        {"Version": "2012-10-17", "Statement": [
            {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::oidcb/*"],
             "Condition": {"StringEquals": {"jwt:sub": "user-7"}}}]}).encode())
    now = int(time.time())
    base = {"sub": "user-7", "iss": "https://idp.example", "aud": "minio",
            "exp": now + 3600, "policy": "readonly,subonly"}
    out = []
    for alg, kid, claims, action in (
            ("RS256", "k1", base, "AssumeRoleWithWebIdentity"),
            ("RS384", "k1", {**base, "sub": "user-8"}, "AssumeRoleWithClientGrants"),
            ("RS512", "k1", base, "AssumeRoleWithWebIdentity"),
            ("HS256", "h1", {**base, "policy": ["subonly"]}, "AssumeRoleWithWebIdentity"),
            ("RS256", "k2", base, "AssumeRoleWithWebIdentity"),
            ("RS256", "k1", {**base, "exp": now - 100}, "AssumeRoleWithWebIdentity"),
            ("RS256", "k1", {**base, "aud": "other"}, "AssumeRoleWithWebIdentity"),
            ("RS256", "k1", {k: v for k, v in base.items() if k != "policy"},
             "AssumeRoleWithWebIdentity"),
            ("RS256", "k1", {k: v for k, v in base.items() if k != "exp"},
             "AssumeRoleWithWebIdentity")):
        field = "Token" if action.endswith("ClientGrants") else "WebIdentityToken"
        r = ti.anon(url, "POST", "/", data={"Action": action, "DurationSeconds": "900",
                                            field: _jwt(rsa_keys, claims, alg, kid)})
        out.append(_rec(r))
        if r.status_code == 200:
            ak, sk, token, _ = _creds(r, action)
            fed = ti.SigV4Client(url, ak, sk, session_token=token)
            out += [_rec(fed.get("/oidcb/obj")), _rec(fed.put("/oidcb/x", data=b"x"))]
    out.append(_rec(ti.anon(url, "POST", "/", data={"Action": "AssumeRoleWithWebIdentity"})))
    return out


def test_web_identity_answers_as_jax(planes_off, tmp_path, monkeypatch, rsa_keys):
    monkeypatch.setenv("MTPU_IDENTITY_OPENID_ENABLE", "on")
    monkeypatch.setenv("MTPU_IDENTITY_OPENID_JWKS", _jwks(rsa_keys))
    monkeypatch.setenv("MTPU_IDENTITY_OPENID_ISSUER", "https://idp.example")
    monkeypatch.setenv("MTPU_IDENTITY_OPENID_AUDIENCE", "minio")
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _oidc_script(srv.url, rsa_keys)
        finally:
            srv.close()
    assert results["torch"] == results["jax"]
    # RS256 for user-7: readonly reads, subonly too, no writes; user-8's
    # token reads through readonly only.
    assert results["torch"][:3] == [(200, ""), (200, ""), (403, "AccessDenied")]


def test_web_identity_unconfigured_answers_as_jax(planes_off, tmp_path, rsa_keys):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _rec(ti.anon(srv.url, "POST", "/", data={
                "Action": "AssumeRoleWithWebIdentity",
                "WebIdentityToken": _jwt(rsa_keys, {"exp": time.time() + 60})}))
        finally:
            srv.close()
    assert results["torch"] == results["jax"] == (501, "NotImplemented")


# --- LDAP --------------------------------------------------------------------------

def _ber(tag, payload):
    n = len(payload)
    length = bytes([n]) if n < 0x80 else bytes([0x81, n])
    return bytes([tag]) + length + payload


class _Directory:
    """An LDAPv3 stub on a local socket: a simple bind of `dn` with
    `password` succeeds (resultCode 0), any other gets 49."""

    def __init__(self, dn, password):
        self.dn, self.password = dn.encode(), password.encode()
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self.binds = []
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                msg = conn.recv(4096)
                # [SEQUENCE [INTEGER id] [APPLICATION 0 [INTEGER 3]
                #  [OCTET STRING dn] [0x80 password]]]
                op = msg[msg.index(b"\x60"):]
                pos = 2 + 3                                # op header, version
                dn = op[pos + 2:pos + 2 + op[pos + 1]]
                pos += 2 + op[pos + 1]
                pw = op[pos + 2:pos + 2 + op[pos + 1]]
                self.binds.append(dn.decode())
                code = 0 if (dn, pw) == (self.dn, self.password) else 49
                resp = _ber(0x61, _ber(0x0A, bytes([code])) + _ber(0x04, b"") + _ber(0x04, b""))
                conn.sendall(_ber(0x30, _ber(0x02, b"\x01") + resp))

    def close(self):
        self.sock.close()


def _ldap_script(url):
    cl = ti.root(url)
    cl.put("/ldapb")
    cl.put("/ldapb/obj", data=b"directory read")
    out = []
    for user, pw in (("alice", "alice-pw"), ("alice", "wrong"), ("mallory", "x"),
                     ("alice,dc=evil", "alice-pw"), ("alice", "")):
        r = ti.anon(url, "POST", "/", data={"Action": "AssumeRoleWithLDAPIdentity",
                                            "LDAPUsername": user, "LDAPPassword": pw})
        out.append(_rec(r))
        if r.status_code == 200:
            ak, sk, token, _ = _creds(r, "AssumeRoleWithLDAPIdentity")
            dirc = ti.SigV4Client(url, ak, sk, session_token=token)
            out += [_rec(dirc.get("/ldapb/obj")), _rec(dirc.put("/ldapb/x", data=b"x")),
                    _rec(dirc.delete("/ldapb/obj"))]
    return out


def test_ldap_identity_answers_as_jax(planes_off, tmp_path, monkeypatch):
    directory = _Directory("uid=alice,ou=people,dc=example", "alice-pw")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_ENABLE", "on")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_SERVER_ADDR", f"ldap://127.0.0.1:{directory.port}")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_USER_DN_FORMAT", "uid=%s,ou=people,dc=example")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_STS_POLICY", "readonly")
    results = {}
    try:
        for pkg in ti.PKGS:
            srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
            try:
                results[pkg] = _ldap_script(srv.url)
            finally:
                srv.close()
    finally:
        directory.close()
    assert results["torch"] == results["jax"]
    assert results["torch"][:4] == [(200, ""), (200, ""), (403, "AccessDenied"),
                                    (403, "AccessDenied")]
    assert directory.binds.count("uid=alice,ou=people,dc=example") == 4


@pytest.mark.parametrize("setting", [{}, {"MTPU_IDENTITY_LDAP_USER_DN_FORMAT": "uid=%s%d"},
                                     {"MTPU_IDENTITY_LDAP_STS_POLICY": ""}])
def test_ldap_misconfigured_answers_as_jax(planes_off, tmp_path, monkeypatch, setting):
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_SERVER_ADDR", "ldap://127.0.0.1:9")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_USER_DN_FORMAT", "uid=%s")
    monkeypatch.setenv("MTPU_IDENTITY_LDAP_STS_POLICY", "readonly")
    if setting:
        monkeypatch.setenv("MTPU_IDENTITY_LDAP_ENABLE", "on")
        for k, v in setting.items():
            monkeypatch.setenv(k, v)
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = [_rec(ti.anon(srv.url, "POST", "/", data={
                "Action": "AssumeRoleWithLDAPIdentity", "LDAPUsername": "u",
                "LDAPPassword": "p"}))]
        finally:
            srv.close()
    assert results["torch"] == results["jax"]
