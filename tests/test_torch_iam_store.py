"""The IAM store in the port (minio_tpu_torch/iam/sys.py over the sealed
sys store, crypto/configcrypt.py) against the JAX package's, on the CPU.

- the same operations on both IAMSys, each over its own sealed memory
  store, with `os.urandom` of both configcrypt modules and the IAM
  `secrets` pinned to one seeded source: the same keys, and the same
  documents, sealed byte for byte and equal once unsealed;
- each package loads the other's sealed store (and a real drive set's,
  through each server's boot) and sees the same users, groups, policies
  and credentials; deletes cascade alike;
- a store sealed under another root secret refuses to load in both; a
  temporary credential that expired (an injected clock) is dropped at
  load in both.

Tolerance: exact bytes."""

import json
import types

import numpy as np
import pytest

from minio_tpu.crypto import configcrypt as jcc
from minio_tpu.iam import sys as jsys
from minio_tpu.utils import errors as jse
from minio_tpu_torch.crypto import configcrypt as cc
from minio_tpu_torch.iam import sys as psys
from minio_tpu_torch.utils import errors as se
from tests import torch_atrest as ta
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture
from tests.torch_native import jax_native_library

jax_native_library()
SECRET = "root-secret-123"


class _Store:
    def __init__(self, errors):
        self.docs = {}
        self._errors = errors

    def read_sys_config(self, path):
        if path not in self.docs:
            raise self._errors.FileNotFound(path)
        return self.docs[path]

    def write_sys_config(self, path, data):
        self.docs[path] = bytes(data)

    def delete_sys_config(self, path):
        if self.docs.pop(path, None) is None:
            raise self._errors.FileNotFound(path)

    def list_sys_config(self, prefix=""):
        return sorted(p for p in self.docs if p.startswith(prefix))


class _Seeded:
    """os.urandom and secrets.token_* from one seeded stream."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def urandom(self, n):
        return self.rng.bytes(n)

    token_bytes = urandom

    def token_hex(self, n):
        return self.urandom(n).hex()


@pytest.fixture
def clock(monkeypatch):
    """Both packages' IAM clock, pinned and movable."""
    now = types.SimpleNamespace(t=1_800_000_000.0)
    fake = types.SimpleNamespace(time=lambda: now.t)
    for mod in (psys, jsys):
        monkeypatch.setattr(mod, "time", fake)
    return now


def _pin(monkeypatch, seed):
    for ccmod, sysmod in ((cc, psys), (jcc, jsys)):
        src = _Seeded(seed)
        monkeypatch.setattr(ccmod, "os", src)
        monkeypatch.setattr(sysmod, "pysecrets", src)


POLICY = json.dumps({"Version": "2012-10-17", "Statement": [
    {"Effect": "Allow", "Action": ["s3:GetObject"], "Resource": ["arn:aws:s3:::b/*"],
     "Condition": {"IpAddress": {"aws:SourceIp": "10.0.0.0/8"}}}]})


def _operations(iam):
    iam.set_user("alice", "alice-secret")
    iam.set_user("bob", "bob-secret", status="off")
    iam.set_policy("custom", POLICY)
    iam.attach_policy("alice", ["readonly", "custom"])
    iam.add_group_members("devs", ["alice", "bob"])
    iam.attach_policy("devs", ["readwrite"], group=True)
    iam.add_service_account("alice", POLICY)
    iam.add_service_account("bob", "", "SVCBOB", "svc-bob-secret")
    iam.assume_role("alice", 3600, POLICY)
    iam.assume_role_with_claims("sub-9", ["readonly"], 1200, claims={"jwt:sub": "sub-9"})
    iam.set_user_status("bob", "on")


def _view(iam):
    return ({k: vars(u) for k, u in iam.users.items()},
            {k: vars(g) for k, g in iam.groups.items()}, dict(iam.policies),
            {k: vars(t) for k, t in iam.temp_creds.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_store_documents_equal_jax(monkeypatch, clock, seed):
    _pin(monkeypatch, seed)
    stores = {"torch": _Store(se), "jax": _Store(jse)}
    port = psys.IAMSys("root", SECRET, store=cc.SealedSysStore(stores["torch"], SECRET))
    jax = jsys.IAMSys("root", SECRET, store=jcc.SealedSysStore(stores["jax"], SECRET))
    _operations(port)
    _operations(jax)
    assert _view(port) == _view(jax)
    assert sorted(stores["torch"].docs) == sorted(stores["jax"].docs)
    assert len(stores["torch"].docs) == 8   # 2 users, a policy, a group, 4 credentials
    for path, sealed in stores["torch"].docs.items():
        assert sealed.startswith(cc.MAGIC) and sealed == stores["jax"].docs[path], path
        assert cc.decrypt_data(SECRET, sealed) == jcc.decrypt_data(SECRET, sealed)
        json.loads(cc.decrypt_data(SECRET, sealed))


@pytest.mark.parametrize("writer", ti.PKGS)
def test_each_package_loads_the_others_store(monkeypatch, clock, writer):
    _pin(monkeypatch, 7)
    store = _Store(se if writer == "torch" else jse)
    wmod, wcc = (psys, cc) if writer == "torch" else (jsys, jcc)
    first = wmod.IAMSys("root", SECRET, store=wcc.SealedSysStore(store, SECRET))
    _operations(first)
    first.delete_user("bob")           # cascades to SVCBOB
    loaded = {"torch": psys.IAMSys("root", SECRET, store=cc.SealedSysStore(store, SECRET)),
              "jax": jsys.IAMSys("root", SECRET, store=jcc.SealedSysStore(store, SECRET))}
    assert _view(loaded["torch"]) == _view(loaded["jax"]) == _view(first)
    assert "SVCBOB" not in loaded["torch"].temp_creds
    # Expired temporary credentials are dropped at load, in both.
    clock.t += 1300
    again = [m.IAMSys("root", SECRET, store=c.SealedSysStore(store, SECRET))
             for m, c in ((psys, cc), (jsys, jcc))]
    assert _view(again[0]) == _view(again[1])
    assert len(again[0].temp_creds) == len(first.temp_creds) - 1


@pytest.mark.parametrize("writer", ti.PKGS)
def test_wrong_root_secret_refuses_to_load_in_both(writer):
    store = _Store(se if writer == "torch" else jse)
    wmod, wcc = (psys, cc) if writer == "torch" else (jsys, jcc)
    wmod.IAMSys("root", SECRET, store=wcc.SealedSysStore(store, SECRET)).set_user(
        "alice", "alice-secret")
    with pytest.raises(cc.ConfigCryptError):
        psys.IAMSys("root", "another-secret", store=cc.SealedSysStore(store, "another-secret"))
    with pytest.raises(jcc.ConfigCryptError):
        jsys.IAMSys("root", "another-secret", store=jcc.SealedSysStore(store, "another-secret"))


def test_server_boots_the_jax_drives_iam(planes_off, tmp_path):
    """The port's server loads the IAM store the JAX server sealed on the
    drives, and the JAX server loads what the port's wrote after."""
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    js = ta.JaxServer(paths)
    try:
        ti.add_user(ti.root(js.url), "alice", "alice-secret", "readonly")
        jax_view = _view(js.srv.iam)
    finally:
        js.close()
    ts = ta.port_server(paths)
    try:
        assert _view(ts.iam) == jax_view
        ti.add_user(ti.root(ts.url), "bob", "bob-secret", "readwrite")
        port_view = _view(ts.iam)
    finally:
        ts.close()
    js = ta.JaxServer(paths)
    try:
        assert _view(js.srv.iam) == port_view
        assert set(port_view[0]) == {"alice", "bob"}
    finally:
        js.close()
