"""Build, load and count the hand-written CUDA kernels.

The sources in minio_tpu_torch/csrc/ are compiled with nvcc for sm_90a
(Hopper) into one shared library with a plain C interface, loaded through
ctypes: each .cu file compiles to an object in its own nvcc process, all
started together, and one more nvcc call links them. The library is built
on first use into build/kernels/ under the checkout (listed in .gitignore),
named by a hash of the sources and flags so a changed source never loads a
stale build. Nothing here runs at import time: the CPU tests import every
module on a machine without nvcc.

A failed build raises KernelBuildError; a wrapper never falls back to a
plain version for a CUDA tensor.

Each wrapper adds one to its launch count where it launches its kernel
(`note_launch`) and nowhere else, so a run can show that the main path
went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("gf2_matmul.cu", "mxsum_digest.cu", "mxhash256.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("gf2_matmul", "mxsum_digest", "mxhash256")


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


_lib: ctypes.CDLL | None = None
_lib_mu = threading.Lock()
build_log = ""          # nvcc's output (-Xptxas -v: registers, smem, spills)

_launches = {name: 0 for name in KERNELS}
_launch_mu = threading.Lock()


def note_launch(name: str) -> None:
    with _launch_mu:
        _launches[name] += 1


def launches() -> dict[str, int]:
    """Launch count of each kernel since the last reset."""
    with _launch_mu:
        return dict(_launches)


def reset_launches() -> None:
    with _launch_mu:
        for name in _launches:
            _launches[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for c in cmds]
    logs = []
    failed = []
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        text = out.decode(errors="replace")
        logs.append(text)
        if p.returncode != 0:
            failed.append(f"{' '.join(c)}\n{text}")
    if failed:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return "".join(logs)


def _build(target: Path) -> str:
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)]
                    for s, o in zip(SOURCES, objs)])
    tmp = target.with_name(f"{target.name}.{tag}.tmp")
    log += _run_all([[nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
                      *map(str, objs), "-o", str(tmp)]])
    os.replace(tmp, target)
    for o in objs:
        o.unlink(missing_ok=True)
    return log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lib_mu:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libmtpu_torch_kernels-{_digest()}.so"
        if not target.exists():
            build_log = _build(target)
        lib = ctypes.CDLL(str(target))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.mtpu_gf2_matmul.argtypes = [p, p, p, i, i, i, ll, ll, p]
        lib.mtpu_gf2_matmul.restype = i
        lib.mtpu_mxsum_digest.argtypes = [p, p, p, ll, p, p, p, i, ll, p]
        lib.mtpu_mxsum_digest.restype = i
        lib.mtpu_mxsum_workspace_words.argtypes = [i]
        lib.mtpu_mxsum_workspace_words.restype = ll
        lib.mtpu_mxhash256.argtypes = [p, ll, p, p, p, i, p]
        lib.mtpu_mxhash256.restype = i
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero CUDA error code returned by a launcher."""
    if err:
        raise KernelLaunchError(f"{name}: CUDA error {err} (cudaError_t)")
