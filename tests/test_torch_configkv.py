"""The config plane in the port (minio_tpu_torch/admin/configkv.py,
crypto/configcrypt.py, the server's config-kv route, storage class and
heal pacing) against the JAX package, on the CPU.

- ConfigSys: the same subsystems, defaults and dynamic set; the same
  operations (set, reset, bad values, unknown keys, the environment
  override) give the same answers and persist the same JSON;
- sealed payloads both ways: the JAX package seals with argon2id (its
  C++ library) and with scrypt (hashlib, as without it) and the port
  opens both; the port seals with argon2id and the JAX package opens it; a wrong credential, a tampered
  header and unreasonable cost parameters are refused by both; one
  derivation per salt;
- over HTTP: config-kv GET and PUT answer as the JAX server's; the config
  is sealed on the drives and read back after a restart by either
  package; a `storageclass standard=EC:N` set by either package moves the
  parity of the next PUT on the other's server; the auto-healer's pacing
  reads heal.max_sleep and heal.max_io from the server's config;
- the HTTP case again with `cryptography` hidden.

Tolerance: exact."""

import json
import os

import pytest

from minio_tpu.admin import configkv as jkv
from minio_tpu.crypto import configcrypt as jcc
from minio_tpu.erasure import autoheal as jautoheal
from minio_tpu.native import lib as jlib
from minio_tpu_torch.admin import configkv as kv
from minio_tpu_torch.crypto import configcrypt as cc
from minio_tpu_torch.utils import errors as se
from tests import torch_atrest as ta
from tests.torch_native import jax_native_library

jax_native_library()
FALLBACK = os.environ.get(ta.FALLBACK_ENV) == "1"
SECRET = "root-secret-123"


class _MemStore:
    def __init__(self):
        self.docs = {}

    def read_sys_config(self, path):
        if path not in self.docs:
            raise se.FileNotFound(path)
        return self.docs[path]

    def write_sys_config(self, path, data):
        self.docs[path] = bytes(data)

    def delete_sys_config(self, path):
        self.docs.pop(path, None)

    def list_sys_config(self, prefix=""):
        return sorted(p for p in self.docs if p.startswith(prefix))


class _JaxMemStore(_MemStore):
    def read_sys_config(self, path):
        from minio_tpu.utils import errors as jse

        if path not in self.docs:
            raise jse.FileNotFound(path)
        return self.docs[path]


# --- ConfigSys ------------------------------------------------------------------

def test_subsystems_defaults_and_dynamic_set_equal_jax():
    assert kv.DEFAULTS == jkv.DEFAULTS
    assert kv.DYNAMIC == jkv.DYNAMIC
    assert kv.PATH == jkv.PATH


OPS = [("set", "storageclass", {"standard": "EC:2"}),
       ("set", "heal", {"max_sleep": "250ms", "max_io": "3"}),
       ("set", "compression", {"enable": "on", "extensions": ".log"}),
       ("set", "bandwidth", {"default": "1000", "mybucket": "5e6"}),
       ("set", "notify_webhook", {"enable": "on", "endpoint": "http://x"}),
       ("set", "storageclass", {"standard": "EC:17"}),
       ("set", "storageclass", {"standard": "RS:2"}),
       ("set", "bandwidth", {"default": "nan"}),
       ("set", "heal", {"nope": "1"}),
       ("set", "nosuch", {"a": "b"}),
       ("reset", "compression", None),
       ("reset", "nosuch", None),
       ("dump", "heal", None),
       ("dump", "nosuch", None)]


def _apply(sys_, op, subsys, arg, err):
    try:
        if op == "set":
            sys_.set_kv(subsys, arg)
            return "ok"
        if op == "reset":
            sys_.reset(subsys)
            return "ok"
        return sys_.dump(subsys)
    except err as e:
        return f"error: {e}"


def test_the_same_operations_give_the_same_answers_and_json():
    from minio_tpu.utils import errors as jse

    ours, theirs = kv.ConfigSys(_MemStore()), jkv.ConfigSys(_JaxMemStore())
    for op, subsys, arg in OPS:
        assert _apply(ours, op, subsys, arg, kv.ConfigError) == \
            _apply(theirs, op, subsys, arg, jse.IAMError), (op, subsys, arg)
    assert ours.dump() == theirs.dump()
    assert ours._store.docs == theirs._store.docs
    assert ours.generation == theirs.generation
    assert [ours.is_dynamic(s) for s in kv.DEFAULTS] == [theirs.is_dynamic(s)
                                                          for s in kv.DEFAULTS]
    # Each reads the other's persisted JSON.
    again = kv.ConfigSys(theirs._store)
    assert again.dump() == theirs.dump()


def test_environment_beats_the_stored_value(monkeypatch):
    ours, theirs = kv.ConfigSys(_MemStore()), jkv.ConfigSys(_JaxMemStore())
    for c in (ours, theirs):
        c.set_kv("heal", {"max_io": "5"})
    monkeypatch.setenv("MTPU_HEAL_MAX_IO", "9")
    assert ours.get("heal", "max_io") == theirs.get("heal", "max_io") == "9"
    with pytest.raises(kv.ConfigError):
        ours.get("heal", "nope")


# --- sealed payloads -----------------------------------------------------------------

@pytest.fixture
def jax_scrypt(monkeypatch):
    """The JAX package as a deployment without its C++ library seals."""
    monkeypatch.setattr(jlib, "argon2id_available", lambda: False)


@pytest.mark.parametrize("writer,kdf", [("jax", "argon2id"), ("jax", "scrypt"),
                                        ("torch", "argon2id")])
def test_sealed_payloads_open_both_ways(request, kdf, writer):
    """The port seals with argon2id only (its host library is always
    built); it opens both KDFs, since a JAX deployment without its C++
    library seals with scrypt."""
    data = json.dumps(kv.DEFAULTS).encode()
    if writer == "jax":
        if kdf == "scrypt":
            request.getfixturevalue("jax_scrypt")
        blob = jcc.encrypt_data(SECRET, data)
        opened = cc.decrypt_data(SECRET, blob)
    else:
        blob = cc.encrypt_data(SECRET, data)
        opened = jcc.decrypt_data(SECRET, blob)
    assert opened == data
    assert blob[len(cc.MAGIC)] == (cc.KDF_ARGON2ID if kdf == "argon2id" else cc.KDF_SCRYPT)
    for dec, err in ((cc.decrypt_data, cc.ConfigCryptError),
                     (jcc.decrypt_data, jcc.ConfigCryptError)):
        with pytest.raises(err):
            dec("wrong-secret", blob)
        tampered = bytearray(blob)
        tampered[-1] ^= 1
        with pytest.raises(err):
            dec(SECRET, bytes(tampered))


@pytest.mark.parametrize("params", [(1, 5, 1, 1), (1, 1, 1 << 19, 1), (1, 5, 64, 0),
                                    (2, 9, 8, 1), (2, 15, 9, 1), (2, 15, 8, 5), (3, 1, 1, 1)])
def test_unreasonable_headers_are_refused_by_both(params):
    import struct

    kdf, p1, p2, p3 = params
    blob = cc.MAGIC + struct.pack("<BIII", kdf, p1, p2, p3) + bytes(28) + bytes(40)
    with pytest.raises(cc.ConfigCryptError):
        cc.decrypt_data(SECRET, blob)
    with pytest.raises(jcc.ConfigCryptError):
        jcc.decrypt_data(SECRET, blob)


def test_sealed_store_derives_once_per_salt_and_passes_plain_through(monkeypatch):
    calls = []
    real = cc._derive
    monkeypatch.setattr(cc, "_derive", lambda *a: calls.append(a[2]) or real(*a))
    inner = _MemStore()
    store = cc.SealedSysStore(inner, SECRET)
    for i in range(3):
        store.write_sys_config(f"p{i}", b"doc%d" % i)
    assert [store.read_sys_config(f"p{i}") for i in range(3)] == [b"doc0", b"doc1", b"doc2"]
    assert len(calls) == 1 and all(cc.is_encrypted(v) for v in inner.docs.values())
    inner.docs["plain"] = b"{}"
    assert store.read_sys_config("plain") == b"{}"
    # The JAX package's store opens the port's entries, and the reverse.
    jstore = jcc.SealedSysStore(inner, SECRET)
    assert jstore.read_sys_config("p1") == b"doc1"
    jstore.write_sys_config("j", b"from jax")
    assert store.read_sys_config("j") == b"from jax"
    assert len(calls) == 2   # the JAX entry's salt, once


# --- the server's config plane over HTTP -------------------------------------------------

@pytest.fixture
def kvenv(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    return [str(tmp_path / f"d{i}") for i in range(6)]


def _server(pkg, paths):
    return ta.JaxServer(paths) if pkg == "jax" else ta.port_server(paths)


def _parity(srv, pkg, key):
    obj = srv.srv.obj if pkg == "jax" else srv.obj
    return obj.get_object_info("cfg", key).parity_blocks


def _config_file(paths):
    hits = []
    for p in paths:
        for dirpath, _d, files in os.walk(os.path.join(p, ".mtpu.sys")):
            hits += [os.path.join(dirpath, f) for f in files if f == "config.json"]
    return hits


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_config_kv_round_trip_storage_class_and_restart(kvenv, writer, reader):
    answers = {}
    for step, pkg in enumerate((writer, reader)):
        srv = _server(pkg, kvenv)
        try:
            cl = ta.client(srv.url)
            if step == 0:
                assert cl.put("/cfg").status_code == 200
                r = cl.put("/cfg/before", data=b"x" * 100_000)
                assert r.status_code == 200 and _parity(srv, pkg, "before") == 3
                bad = cl.put("/minio/admin/v3/config-kv",
                             data=json.dumps({"storageclass": {"standard": "EC:x"}}).encode())
                r = cl.put("/minio/admin/v3/config-kv", data=json.dumps(
                    {"storageclass": {"standard": "EC:1"},
                     "heal": {"max_sleep": "250ms", "max_io": "3"},
                     "notify_nats": {"enable": "on", "address": "nats:4222"},
                     "identity_ldap": {"server_addr": "ldap:636"}}).encode())
                answers[pkg] = (bad.status_code, r.status_code, r.json())
            r = cl.put(f"/cfg/after-{pkg}", data=b"y" * 100_000)
            assert r.status_code == 200
            assert _parity(srv, pkg, f"after-{pkg}") == 1, pkg
            got = cl.get("/minio/admin/v3/config-kv").json()
            assert got["storageclass"]["standard"] == "EC:1"
            assert got["notify_nats"]["address"] == "nats:4222"
            assert got["identity_ldap"]["server_addr"] == "ldap:636"
            answers[pkg, "heal"] = cl.get("/minio/admin/v3/config-kv",
                                          query={"subsys": "heal"}).json()
        finally:
            srv.close()
    assert answers[writer] == (400, 200, {"restart": ["identity_ldap"]})
    assert answers[writer, "heal"] == answers[reader, "heal"] == {
        "heal": {"bitrotscan": "off", "max_sleep": "250ms", "max_io": "3"}}
    files = _config_file(kvenv)
    assert len(files) == len(kvenv)
    for f in files:
        raw = open(f, "rb").read()
        assert raw.startswith(cc.MAGIC) and b"storageclass" not in raw


def test_the_auto_healer_is_paced_by_the_heal_config(kvenv):
    srv = ta.port_server(kvenv)
    try:
        cl = ta.client(srv.url)
        srv.start_auto_heal(interval=3600)
        (healer,) = srv.auto_healer
        assert healer.config is srv.config
        assert healer._pacing() == (1.0, 10)       # the defaults: 1s, 10
        r = cl.put("/minio/admin/v3/config-kv", data=json.dumps(
            {"heal": {"max_sleep": "250ms", "max_io": "3"}}).encode())
        assert r.status_code == 200 and r.json() == {"restart": []}
        want = jautoheal.AutoHealer(None, config=srv.config)._pacing()
        assert healer._pacing() == want == (0.25, 3)
    finally:
        srv.close()


def test_reduced_redundancy_takes_the_configured_parity(kvenv):
    """storageclass.rrs defaults to EC:1 in both packages' servers."""
    srv = ta.port_server(kvenv)
    try:
        cl = ta.client(srv.url)
        assert cl.put("/cfg").status_code == 200
        r = cl.put("/cfg/rrs", data=b"z" * 100_000,
                   headers={"x-amz-storage-class": "REDUCED_REDUNDANCY"})
        assert r.status_code == 200 and _parity(srv, "torch", "rrs") == 1
    finally:
        srv.close()


def test_http_case_under_the_fallback_provider():
    if FALLBACK:
        pytest.skip("this is the child run")
    ta.run_under_fallback("tests/test_torch_configkv.py",
                          "round_trip_storage_class or open_both_ways")
