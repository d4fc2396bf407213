"""Build, load and call the host hash library (csrc/host_hash.cc).

The library holds the host bitrot hashes, sip256, HighwayHash-256 and
XXH64, behind a plain C interface. It is compiled with the host C++
compiler (`$CXX`, else `g++`: the compiler nvcc itself uses) as
`-O3 -shared -fPIC` on first use into build/host/ under the checkout
(listed in .gitignore), named by a hash of the source and flags, so a
changed source never loads a stale build. Nothing is built at import time.

ctypes releases the interpreter lock for each call, so the shard writer
and reader threads hash side by side. Buffers are passed by address,
without a copy (`_address`).

A failed build raises HostLibraryError. The serving path never falls back
to the pure-Python versions in native/plain.py: those are the plain
versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host_hash.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class HostLibraryError(RuntimeError):
    """The host compiler is missing or refused csrc/host_hash.cc."""


_lib: ctypes.CDLL | None = None
_lib_mu = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise HostLibraryError(
            f"host C++ compiler {cxx!r} not found; the host hash library "
            "cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    cxx = _cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise HostLibraryError(f"{cxx} failed to run: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise HostLibraryError(f"{cxx} refused {SOURCE.name}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The loaded host hash library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lib_mu:
        if _lib is not None:
            return _lib
        target = BUILD_DIR / f"libmtpu_torch_host-{_digest()}.so"
        if not target.exists():
            _build(target)
        try:
            lib = ctypes.CDLL(str(target))
        except OSError as e:
            raise HostLibraryError(f"cannot load {target}: {e}") from e
        p, u64 = ctypes.c_void_p, ctypes.c_uint64
        for name in ("mtpu_torch_sip256", "mtpu_torch_highwayhash256"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_char_p, p, u64, p]
            fn.restype = None
        lib.mtpu_torch_xxh64.argtypes = [p, u64, u64]
        lib.mtpu_torch_xxh64.restype = u64
        _lib = lib
        return lib


def _address(data) -> tuple[int, int, object]:
    """(address, length, owner) of any contiguous bytes-like object, with
    no copy: numpy borrows read-only buffers (bytes, memoryviews of them)
    as well as writable ones. Keep `owner` alive across the call."""
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.ctypes.data, arr.size, arr


def _digest32(fn, key32: bytes, data) -> bytes:
    addr, n, owner = _address(data)
    out = ctypes.create_string_buffer(32)
    fn(key32, addr, n, out)
    del owner
    return out.raw


def sip256(key32: bytes, data) -> bytes:
    """The JAX package's sip256 of `data` under a 32-byte key."""
    return _digest32(library().mtpu_torch_sip256, key32, data)


def highwayhash256(key32: bytes, data) -> bytes:
    """HighwayHash-256 of `data` under a 32-byte key."""
    return _digest32(library().mtpu_torch_highwayhash256, key32, data)


def xxh64(data, seed: int) -> int:
    """XXH64 of `data` under `seed`, as an integer."""
    lib = library()
    addr, n, owner = _address(data)
    h = lib.mtpu_torch_xxh64(addr, n, seed)
    del owner
    return h
