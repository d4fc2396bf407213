"""Hygiene of the port (minio_tpu_torch) and chip_smoke.py:

- no module imports jax or the JAX package, nor a library the card's
  machine lacks (aiohttp, msgpack, requests, xxhash), checked on the AST;
- only crypto/aead.py and iam/oidc.py import `cryptography`, each inside
  a try / except ImportError gate, so the port runs where the package is
  missing;
- an IAM store whose every sealed entry fails to decrypt (a wrong root
  secret) refuses to load, never serving an IAM that is silently empty;
- every entry point raises without CUDA unless given device="cpu";
- a tensor that is not on the CPU never falls back to a plain version:
  with no kernel library it raises.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "minio_tpu", "aiohttp", "msgpack", "requests", "xxhash"}

# Modules of the metadata plane and drive-resilience slice, of the
# data-at-rest slice, of the identity-and-access slice, of the front
# door and QoS slice, of the distributed cluster slice, of the background
# plane slice and of the SLO and chaos slice, each its own copy of the JAX
# module it ports:
# they must be in the scan.
SLICE_MODULES = ("metaplane/__init__.py", "metaplane/wal.py",
                 "metaplane/groupcommit.py", "metaplane/setcache.py",
                 "storage/idcheck.py", "storage/healthcheck.py",
                 "utils/dyntimeout.py", "utils/bufpool.py",
                 "crypto/__init__.py", "crypto/aead.py", "crypto/sse.py",
                 "crypto/compress.py", "crypto/configcrypt.py", "crypto/kms.py",
                 "crypto/kes.py", "admin/configkv.py", "s3/atrest.py",
                 "iam/__init__.py", "iam/actions.py", "iam/condition.py",
                 "iam/policy.py", "iam/reqctx.py", "iam/sys.py", "iam/oidc.py",
                 "iam/ldap.py", "bucket/objectlock.py", "s3/sigv2.py",
                 "qos/__init__.py", "qos/scheduler.py", "frontdoor/__init__.py",
                 "frontdoor/__main__.py", "frontdoor/shm.py",
                 "frontdoor/laneserver.py", "frontdoor/listener.py",
                 "frontdoor/router.py", "frontdoor/worker.py",
                 "frontdoor/supervisor.py", "utils/sysres.py",
                 "dist/__init__.py", "dist/faultplane.py", "dist/rpc.py",
                 "dist/server.py", "dist/endpoint.py", "dist/storage_remote.py",
                 "dist/dsync.py", "dist/nslock.py", "dist/peer.py",
                 "dist/cluster.py", "utils/msgpack.py",
                 "scanner/__init__.py", "scanner/lifecycle.py", "scanner/usage.py",
                 "scanner/tracker.py", "scanner/tiers.py", "scanner/scanner.py",
                 "event/__init__.py", "event/event.py", "event/rules.py",
                 "event/targets.py", "event/notifier.py", "logger/__init__.py",
                 "logger/logger.py", "replication/__init__.py",
                 "replication/client.py", "utils/streams.py",
                 "obs/tsdb.py", "obs/slo.py", "obs/calibration.py",
                 "chaos/__init__.py", "chaos/naughty.py", "chaos/schedule.py",
                 "chaos/ledger.py", "chaos/workload.py", "chaos/invariants.py")


def _port_files():
    return sorted((ROOT / "minio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_are_scanned_and_import(module):
    import importlib

    path = ROOT / "minio_tpu_torch" / module
    assert path in _port_files()
    name = "minio_tpu_torch." + module[:-3].replace("/", ".").removesuffix(".__init__")
    assert pathlib.Path(importlib.import_module(name).__file__).resolve() == path


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for f in _port_files():
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    assert len(_port_files()) > 20


def _imports_of(tree, top: str):
    """(import node, its enclosing nodes) for every import of `top`."""
    found = []

    def walk(node, stack):
        if isinstance(node, ast.Import) and any(a.name.split(".")[0] == top
                                                for a in node.names):
            found.append((node, stack))
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and (node.module or "").split(".")[0] == top):
            found.append((node, stack))
        for child in ast.iter_child_nodes(node):
            walk(child, stack + [node])

    walk(tree, [])
    return found


def _catches_import_error(try_node) -> bool:
    for h in try_node.handlers:
        names = h.type.elts if isinstance(h.type, ast.Tuple) else [h.type]
        if any(isinstance(n, ast.Name) and n.id in ("ImportError", "ModuleNotFoundError")
               for n in names):
            return True
    return False


def test_only_the_aead_gate_imports_cryptography():
    """The AEAD gate, and the OIDC validator's RS* check (which refuses an
    RS* token without the package), are the only importers."""
    gates = {ROOT / "minio_tpu_torch" / "crypto" / "aead.py",
             ROOT / "minio_tpu_torch" / "iam" / "oidc.py"}
    seen = set()
    for f in _port_files():
        for node, stack in _imports_of(ast.parse(f.read_text(), str(f)), "cryptography"):
            seen.add(f)
            assert f in gates, f"{f.relative_to(ROOT)}:{node.lineno} imports cryptography"
            tries = [t for t in stack if isinstance(t, ast.Try) and node in ast.walk(t)
                     and any(node in ast.walk(b) for b in t.body)]
            assert tries and _catches_import_error(tries[-1]), \
                f"{f.name}:{node.lineno} imports cryptography outside its ImportError gate"
    assert seen == gates


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from minio_tpu_torch.dataplane.batcher import BatchPlane
    from minio_tpu_torch.erasure.codec import ErasureCodec
    from minio_tpu_torch.erasure.objects import ErasureObjects
    from minio_tpu_torch.hottier.tier import HotObjectTier
    from minio_tpu_torch.ops import fused
    from minio_tpu_torch.s3 import server
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.utils.device import DeviceUnavailable

    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    for call in (lambda: ErasureCodec(2, 2),
                 lambda: ErasureObjects([LocalDrive(p) for p in paths]),
                 lambda: server.build_server(paths, "ak", "secret123"),
                 lambda: server.main([*paths, "--address", "127.0.0.1:0"]),
                 lambda: fused.digest_chunks_host([b"abc"], 16),
                 lambda: BatchPlane(),
                 lambda: HotObjectTier()):
        with pytest.raises(DeviceUnavailable):
            call()
    cpu = torch.device("cpu")
    assert ErasureCodec(2, 2, device="cpu").device == cpu
    assert ErasureObjects([LocalDrive(p) for p in paths], device="cpu").device == cpu
    assert len(fused.digest_chunks_host([b"abc"], 16, device="cpu")[0]) == 32
    for entry in (BatchPlane(device="cpu"), HotObjectTier(device="cpu")):
        assert entry.device == cpu
        entry.close()


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """With no kernel library (nvcc missing) a wrapper given a tensor that
    is not on the CPU raises; it does not run the plain version. A meta
    tensor stands in for a CUDA one here (this torch has no CUDA);
    tests/test_torch_kernels.py makes the same check with CUDA tensors on
    the card."""
    from minio_tpu_torch.ops import kernels, mxsum, rs

    def no_nvcc():
        raise kernels.KernelBuildError("nvcc not found")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "_digest", lambda: "missing-for-test")
    before = kernels.launches()
    x = torch.empty((2, 8, 64), dtype=torch.uint8, device="meta")
    w = torch.empty((64, 32), dtype=torch.int8, device="meta")
    with pytest.raises(kernels.KernelBuildError):
        rs.gf2_matmul(x, w, 4)
    with pytest.raises(kernels.KernelBuildError):
        mxsum.digest(torch.empty((3, 64), dtype=torch.uint8, device="meta"),
                     torch.empty(3, dtype=torch.int32, device="meta"))
    assert kernels.launches() == before


def test_kernel_build_is_keyed_by_sources_and_flags():
    from minio_tpu_torch.ops import kernels

    for name in kernels.SOURCES:
        assert (kernels.CSRC / name).is_file()
    assert "arch=compute_90a,code=sm_90a" in kernels.NVCC_FLAGS
    assert len(kernels._digest()) == 16


def test_sets_and_pools_raise_without_cuda(no_cuda, tmp_path):
    """The object layers above one set (ErasureSets, ErasureServerPools, the
    server over several sets) build their set engines on the card unless
    given device="cpu"."""
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.s3 import server
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.utils.device import DeviceUnavailable

    paths = [str(tmp_path / f"d{i}") for i in range(8)]
    for call in (lambda: ErasureSets([LocalDrive(p) for p in paths], 4),
                 lambda: server.build_server(paths, "ak", "secret123",
                                             set_drive_count=4)):
        with pytest.raises(DeviceUnavailable):
            call()
    sets = ErasureSets([LocalDrive(p) for p in paths], 4, device="cpu")
    pools = ErasureServerPools([sets])
    assert sets.set_count == 2 and pools.device == torch.device("cpu")
    assert all(s.device == torch.device("cpu") for s in sets.sets)


class _MemStore:
    def __init__(self):
        self.docs = {}

    def read_sys_config(self, path):
        from minio_tpu_torch.utils import errors as se

        if path not in self.docs:
            raise se.FileNotFound(path)
        return self.docs[path]

    def write_sys_config(self, path, data):
        self.docs[path] = data

    def delete_sys_config(self, path):
        self.docs.pop(path)

    def list_sys_config(self, prefix=""):
        return sorted(k for k in self.docs if k.startswith(prefix))


def test_iam_store_sealed_under_another_secret_refuses_to_load():
    """Every sealed entry failing to decrypt means a wrong root secret:
    IAMSys raises rather than boot with no users; one bad entry among good
    ones is skipped."""
    from minio_tpu_torch.crypto.configcrypt import ConfigCryptError, SealedSysStore
    from minio_tpu_torch.iam.sys import IAMSys

    store = _MemStore()
    iam = IAMSys("root", "root-secret-1", store=SealedSysStore(store, "root-secret-1"))
    iam.set_user("alice", "alice-secret-1")
    iam.set_user("bob", "bob-secret-12")
    with pytest.raises(ConfigCryptError):
        IAMSys("root", "other-secret", store=SealedSysStore(store, "other-secret"))
    sealed = store.docs["iam/users/bob"]
    store.docs["iam/users/bob"] = sealed[:-1] + bytes([sealed[-1] ^ 1])
    again = IAMSys("root", "root-secret-1", store=SealedSysStore(store, "root-secret-1"))
    assert set(again.users) == {"alice"}
