"""Key management in the port (minio_tpu_torch/crypto/kms.py, kes.py, the
admin kms routes) against the JAX package, on the CPU.

- LocalKMS: the same key file, MTPU_KMS_SECRET_KEY and
  MTPU_KMS_DEFAULT_KEY give the same keys and status; a data key sealed by
  one package unseals in the other and only for its object; a key minted
  by create_key is persisted where the other package's LocalKMS loads it;
  bad ids and blobs are refused alike;
- KESClient against a stdlib stub of the KES API (tests/test_kes.py's):
  create, generate, decrypt and list both ways, context binding, the
  errors, status; kms_from_config picks the same backend as the JAX
  package's;
- the servers: with `kms kes_endpoint` set through config-kv, the port's
  server seals SSE-KMS data keys through KES and the JAX server over the
  same drives reads them, and the reverse; admin kms/status,
  kms/key-status and kms/key/create answer as the JAX server's;
- the cases again with `cryptography` hidden.

Tolerance: exact."""

import base64
import json
import os
import secrets
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minio_tpu.crypto import kes as jkes
from minio_tpu.crypto import kms as jkms
from minio_tpu.crypto.aead import AESGCM as JaxAESGCM
from minio_tpu_torch.crypto import kes, kms
from tests import torch_atrest as ta
from tests.conftest import free_port

FALLBACK = os.environ.get(ta.FALLBACK_ENV) == "1"


@pytest.fixture
def key_file(tmp_path, monkeypatch):
    monkeypatch.delenv("MTPU_KMS_SECRET_KEY", raising=False)
    monkeypatch.delenv("MTPU_KMS_DEFAULT_KEY", raising=False)
    path = ta.write_key_file(tmp_path / "keys")
    monkeypatch.setenv("MTPU_KMS_KEY_FILE", path)
    return path


# --- LocalKMS -----------------------------------------------------------------------

@pytest.mark.parametrize("env", [{}, {"MTPU_KMS_DEFAULT_KEY": "k2"},
                                 {"MTPU_KMS_SECRET_KEY": "s3cret"}])
def test_local_kms_reads_the_same_keys(key_file, monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, theirs = kms.LocalKMS(), jkms.LocalKMS()
    assert ours.status() == theirs.status()
    assert ours._keys == theirs._keys


@pytest.mark.parametrize("sealer", ["jax", "torch"])
def test_data_keys_unseal_across_packages_for_their_object_only(key_file, sealer):
    ours, theirs = kms.LocalKMS(), jkms.LocalKMS()
    a, b = (theirs, ours) if sealer == "jax" else (ours, theirs)
    for kid in ("", "k2"):
        used, plain, sealed = a.generate_data_key(kid, context="bkt/obj")
        assert used == (kid or "k1") and sealed.startswith(f"v1:{used}:")
        assert b.decrypt_data_key(sealed, context="bkt/obj") == plain
        with pytest.raises((kms.KMSError, jkms.KMSError)):
            b.decrypt_data_key(sealed, context="bkt/other")
    for bad in ("v2:k1:AAAA", "garbage", "v1:nokey:AAAA"):
        for backend, err in ((ours, kms.KMSError), (theirs, jkms.KMSError)):
            with pytest.raises(err):
                backend.decrypt_data_key(bad)


def test_created_keys_persist_for_either_package(key_file):
    ours = kms.LocalKMS()
    ours.create_key("minted")
    _kid, plain, sealed = ours.generate_data_key("minted", context="b/o")
    theirs = jkms.LocalKMS()
    assert "minted" in theirs.key_ids()
    assert theirs.decrypt_data_key(sealed, context="b/o") == plain
    theirs.create_key("minted-by-jax")
    assert kms.LocalKMS().key_ids() == theirs.key_ids()
    for bad in ("a:b", "x\ny", "", "minted"):
        with pytest.raises(kms.KMSError):
            ours.create_key(bad)


def test_no_keys_no_data_keys(tmp_path, monkeypatch):
    monkeypatch.delenv("MTPU_KMS_SECRET_KEY", raising=False)
    monkeypatch.delenv("MTPU_KMS_DEFAULT_KEY", raising=False)
    monkeypatch.setenv("MTPU_KMS_KEY_FILE", str(tmp_path / "none"))
    assert kms.LocalKMS().status() == jkms.LocalKMS().status()
    with pytest.raises(kms.KMSError):
        kms.LocalKMS().generate_data_key()


# --- KES -------------------------------------------------------------------------------

class _StubKES(BaseHTTPRequestHandler):
    """The KES HTTP API over master keys held in memory (tests/test_kes.py's
    stub, sealing with the JAX package's AEAD so it runs under either
    provider)."""

    keys: dict[str, bytes] = {}

    def log_message(self, *a):
        pass

    def _json(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/version":
            return self._json(200, {"version": "stub-kes/1"})
        if self.path.startswith("/v1/key/list/"):
            return self._json(200, [{"name": k} for k in sorted(self.keys)])
        return self._json(404, {"message": "not found"})

    def do_POST(self):
        parts = self.path.strip("/").split("/")
        if len(parts) != 4 or parts[:2] != ["v1", "key"]:
            return self._json(404, {"message": "not found"})
        op, name = parts[2], parts[3]
        if op == "create":
            if name in self.keys:
                return self._json(400, {"message": "key already exists"})
            self.keys[name] = secrets.token_bytes(32)
            return self._json(200, {})
        if name not in self.keys:
            return self._json(404, {"message": "key does not exist"})
        n = int(self.headers.get("Content-Length") or 0)
        body = json.loads(self.rfile.read(n) or b"{}")
        ctx = base64.b64decode(body.get("context", "") or "")
        aead = JaxAESGCM(self.keys[name])
        if op == "generate":
            pt, nonce = secrets.token_bytes(32), secrets.token_bytes(12)
            return self._json(200, {"plaintext": base64.b64encode(pt).decode(),
                                    "ciphertext": base64.b64encode(
                                        nonce + aead.encrypt(nonce, pt, ctx)).decode()})
        if op == "decrypt":
            try:
                raw = base64.b64decode(body["ciphertext"])
                pt = aead.decrypt(raw[:12], raw[12:], ctx)
            except Exception:  # noqa: BLE001 - the stub answers as KES does
                return self._json(400, {"message": "decryption failed"})
            return self._json(200, {"plaintext": base64.b64encode(pt).decode()})
        return self._json(404, {"message": "not found"})


@pytest.fixture
def kes_url():
    _StubKES.keys = {}
    httpd = ThreadingHTTPServer(("127.0.0.1", free_port()), _StubKES)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    t.join(10)
    assert not t.is_alive()


@pytest.mark.parametrize("sealer", ["jax", "torch"])
def test_kes_client_both_ways(kes_url, sealer):
    ours, theirs = kes.KESClient(kes_url), jkes.KESClient(kes_url)
    a, b = (theirs, ours) if sealer == "jax" else (ours, theirs)
    a.create_key("obj-key")
    assert a.default_key_id == "obj-key"
    kid, plain, sealed = a.generate_data_key(context="bkt/obj")
    assert kid == "obj-key" and len(plain) == 32 and sealed.startswith("kes:v1:obj-key:")
    assert b.decrypt_data_key(sealed, context="bkt/obj") == plain
    with pytest.raises((kms.KMSError, jkms.KMSError)):
        b.decrypt_data_key(sealed, context="bkt/other")
    assert ours.key_ids() == theirs.key_ids() == ["obj-key"]
    assert ours.status() == {**theirs.status(), "defaultKeyId": ours.default_key_id}


def test_kes_errors_equal_jax(kes_url):
    for mod, err in ((kes, kms.KMSError), (jkes, jkms.KMSError)):
        c = mod.KESClient(kes_url)
        with pytest.raises(err):
            c.generate_data_key("nosuchkey")
        with pytest.raises(err):
            c.generate_data_key()
        with pytest.raises(err):
            c.decrypt_data_key("v1:default:AAAA")
        with pytest.raises(err):
            c.generate_data_key("../secrets")
        with pytest.raises(err):
            mod.KESClient("ftp://kes:7373")
        down = mod.KESClient("http://127.0.0.1:1")
        with pytest.raises(err):
            down.generate_data_key("k")
        st = down.status()
        assert st["online"] is False and "error" in st


class _Cfg:
    def __init__(self, values):
        self.values = values

    def get(self, sub, key):
        return self.values.get(f"{sub}.{key}", "")


@pytest.mark.parametrize("values", [{}, {"kms.default_key": "k2"},
                                    {"kms.kes_endpoint": "http://kes:7373",
                                     "kms.default_key": "obj"}])
def test_kms_from_config_picks_the_jax_packages_backend(key_file, values):
    ours, theirs = kes.kms_from_config(_Cfg(values)), jkes.kms_from_config(_Cfg(values))
    assert type(ours).__name__ == type(theirs).__name__
    assert ours.default_key_id == theirs.default_key_id


# --- the servers ----------------------------------------------------------------------

@pytest.fixture
def kmsenv(tmp_path, monkeypatch, key_file):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    return [str(tmp_path / f"d{i}") for i in range(4)]


def _server(pkg, paths):
    return ta.JaxServer(paths) if pkg == "jax" else ta.port_server(paths)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_sse_kms_through_kes_across_servers(kmsenv, kes_url, writer, reader):
    data = ta.payload(150_000, 3)
    _StubKES.keys["kes-key"] = secrets.token_bytes(32)
    srv = _server(writer, kmsenv)
    try:
        cl = ta.client(srv.url)
        r = cl.put("/minio/admin/v3/config-kv", data=json.dumps(
            {"kms": {"kes_endpoint": kes_url, "default_key": "kes-key"}}).encode())
        assert r.status_code == 200 and r.json() == {"restart": ["kms"]}
    finally:
        srv.close()
    sealed = {}
    for pkg in (writer, reader):
        srv = _server(pkg, kmsenv)
        try:
            cl = ta.client(srv.url)
            status = cl.get("/minio/admin/v3/kms/status").json()
            assert status["backend"] == "kes" and status["online"], status
            if pkg == writer:
                assert cl.put("/kmsb").status_code == 200
                r = cl.put("/kmsb/obj", data=data,
                           headers={"x-amz-server-side-encryption": "aws:kms"})
                assert r.status_code == 200, r.text
            r = cl.get("/kmsb/obj")
            assert r.status_code == 200 and r.content == data
            assert r.headers["x-amz-server-side-encryption-aws-kms-key-id"] == "kes-key"
            obj = srv.srv.obj if pkg == "jax" else srv.obj
            sealed[pkg] = obj.get_object_info("kmsb", "obj").user_defined[
                "x-mtpu-internal-sse-sealed-key"]
        finally:
            srv.close()
    assert sealed[writer] == sealed[reader] and sealed[writer].startswith("kes:v1:kes-key:")


def test_admin_kms_routes_answer_as_the_jax_servers(kmsenv):
    answers = {}
    for pkg in ("jax", "torch"):
        paths = [p + pkg for p in kmsenv]
        srv = _server(pkg, paths)
        try:
            cl = ta.client(srv.url)
            got = [cl.get("/minio/admin/v3/kms/status").json(),
                   cl.get("/minio/admin/v3/kms/key-status").json()]
            r = cl.post("/minio/admin/v3/kms/key/create", query={"key-id": f"new-{pkg}"})
            got.append((r.status_code, r.json()))
            r = cl.post("/minio/admin/v3/kms/key/create", query={"key-id": "k1"})
            got.append((r.status_code, b"InvalidRequest" in r.content))
            got.append(cl.get("/minio/admin/v3/kms/status").json()["keys"])
            answers[pkg] = got
        finally:
            srv.close()
    # One key file: the port's LocalKMS loads the key the JAX server made.
    for pkg, keys in (("jax", ["k1", "k2"]), ("torch", ["k1", "k2", "new-jax"])):
        assert answers[pkg][0] == answers[pkg][1] == {
            "configured": True, "defaultKeyId": "k1", "keys": keys}
    assert answers["torch"][2:4] == answers["jax"][2:4] == [(200, {}), (400, True)]
    assert answers["jax"][4] == ["k1", "k2", "new-jax"]
    assert answers["torch"][4] == ["k1", "k2", "new-jax", "new-torch"]


def test_cases_under_the_fallback_provider():
    if FALLBACK:
        pytest.skip("this is the child run")
    ta.run_under_fallback("tests/test_torch_kms.py", "not fallback_provider")
