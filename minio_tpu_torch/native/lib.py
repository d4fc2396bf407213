"""Build, load and call the host library (csrc/host_hash.cc and
csrc/host_codec.cc).

The library holds the host bitrot hashes, sip256, HighwayHash-256 and
XXH64, and the host codecs of data at rest, the snappy block codec,
Argon2id and CRC-32C, behind a plain C interface. It is compiled with the
host C++ compiler (`$CXX`, else `g++`: the compiler nvcc itself uses) as
`-O3 -shared -fPIC` on first use into build/host/ under the checkout
(listed in .gitignore), named by a hash of the sources and flags, so a
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

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (_CSRC / "host_hash.cc", _CSRC / "host_codec.cc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class HostLibraryError(RuntimeError):
    """The host compiler is missing or refused the library's sources."""


_lib: ctypes.CDLL | None = None
_lib_mu = threading.Lock()


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise HostLibraryError(
            f"host C++ compiler {cxx!r} not found; the host library "
            "cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    cxx = _cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}-{threading.get_ident()}.tmp")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", str(tmp)],
                             capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise HostLibraryError(f"{cxx} failed to run: {e}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        names = ", ".join(s.name for s in SOURCES)
        raise HostLibraryError(f"{cxx} refused {names}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
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
        i64, u32 = ctypes.c_int64, ctypes.c_uint32
        lib.mtpu_torch_snappy_max_compressed.argtypes = [u64]
        lib.mtpu_torch_snappy_max_compressed.restype = u64
        lib.mtpu_torch_snappy_compress.argtypes = [p, u64, p]
        lib.mtpu_torch_snappy_compress.restype = i64
        lib.mtpu_torch_snappy_uncompressed_len.argtypes = [p, u64]
        lib.mtpu_torch_snappy_uncompressed_len.restype = i64
        lib.mtpu_torch_snappy_uncompress.argtypes = [p, u64, p, u64]
        lib.mtpu_torch_snappy_uncompress.restype = i64
        lib.mtpu_torch_crc32c.argtypes = [p, u64]
        lib.mtpu_torch_crc32c.restype = u32
        lib.mtpu_torch_argon2id.argtypes = [ctypes.c_char_p, u64, ctypes.c_char_p, u64,
                                            ctypes.c_char_p, u64, ctypes.c_char_p, u64,
                                            u32, u32, u32, p, u32]
        lib.mtpu_torch_argon2id.restype = ctypes.c_int
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


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`, as the JAX package's mtpu_crc32c."""
    lib = library()
    addr, n, owner = _address(data)
    crc = lib.mtpu_torch_crc32c(addr, n)
    del owner
    return crc


def snappy_compress(data) -> bytes:
    """One snappy block of `data`, by the JAX package's greedy matcher."""
    lib = library()
    addr, n, owner = _address(data)
    out = ctypes.create_string_buffer(lib.mtpu_torch_snappy_max_compressed(n))
    m = lib.mtpu_torch_snappy_compress(addr, n, out)
    del owner
    if m < 0:
        raise ValueError("snappy compress failed")
    return out.raw[:m]


def snappy_uncompress(data, max_len: int = 1 << 26) -> bytes:
    """Decode one snappy block; ValueError on a malformed one. `max_len`
    bounds the length its header claims before anything is allocated:
    that header is read from disk, so a bit-rotted block must not ask for
    gigabytes (S2 frames pass 64 KiB)."""
    lib = library()
    addr, n, owner = _address(data)
    ulen = lib.mtpu_torch_snappy_uncompressed_len(addr, n)
    if ulen < 0 or ulen > max_len:
        raise ValueError("corrupt snappy block (bad length header)")
    out = ctypes.create_string_buffer(max(ulen, 1))
    got = lib.mtpu_torch_snappy_uncompress(addr, n, out, ulen)
    del owner
    if got != ulen:
        raise ValueError("corrupt snappy block")
    return out.raw[:ulen]


def argon2id(password: bytes, salt: bytes, *, t: int = 1, m_kib: int = 65536,
             lanes: int = 4, outlen: int = 32, secret: bytes = b"",
             ad: bytes = b"") -> bytes:
    """Argon2id (RFC 9106, version 0x13) of `password`; ValueError on
    parameters the kernel refuses."""
    lib = library()
    out = ctypes.create_string_buffer(outlen)
    rc = lib.mtpu_torch_argon2id(password, len(password), salt, len(salt),
                                 secret, len(secret), ad, len(ad),
                                 t, m_kib, lanes, out, outlen)
    if rc != 0:
        raise ValueError("argon2id refused its parameters")
    return out.raw
