"""Hygiene of the port (minio_tpu_torch) and chip_smoke.py:

- no module imports jax or the JAX package (checked on the AST);
- every entry point raises without CUDA unless given device="cpu";
- a tensor that is not on the CPU never falls back to a plain version:
  with no kernel library it raises.
"""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "minio_tpu"}


def _port_files():
    return sorted((ROOT / "minio_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


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


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda, tmp_path):
    from minio_tpu_torch.erasure.codec import ErasureCodec
    from minio_tpu_torch.erasure.objects import ErasureObjects
    from minio_tpu_torch.ops import fused
    from minio_tpu_torch.s3 import server
    from minio_tpu_torch.storage.local import LocalDrive
    from minio_tpu_torch.utils.device import DeviceUnavailable

    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    for call in (lambda: ErasureCodec(2, 2),
                 lambda: ErasureObjects([LocalDrive(p) for p in paths]),
                 lambda: server.build_server(paths, "ak", "secret123"),
                 lambda: server.main([*paths, "--address", "127.0.0.1:0"]),
                 lambda: fused.digest_chunks_host([b"abc"], 16)):
        with pytest.raises(DeviceUnavailable):
            call()
    cpu = torch.device("cpu")
    assert ErasureCodec(2, 2, device="cpu").device == cpu
    assert ErasureObjects([LocalDrive(p) for p in paths], device="cpu").device == cpu
    assert len(fused.digest_chunks_host([b"abc"], 16, device="cpu")[0]) == 32


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
