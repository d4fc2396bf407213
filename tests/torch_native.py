"""The JAX package's C++ host library for the port's interop tests.

The port's tests hold the port against the JAX package's native
functions (sip256, HighwayHash-256, snappy, argon2id, CRC-32C), and the
JAX package picks its defaults by whether that library loads (its bitrot
default on the CPU, its S2 compression scheme, its config KDF).

minio_tpu/native/lib.py builds the library on first use with
`make -C native`, which has g++ write native/libmtpu_native.so in place,
and loads it once: a process that finds the file while another process's
g++ is still writing it loads a partial library, fails, and never tries
again (`_tried`). With several pytest-xdist workers starting together that
happens (six staggered processes over a fresh native/ left one of them
without the library in two of three tries), and every test of that worker
that needs the library then fails or skips.

jax_native_library() takes that race out of the tests without touching
the JAX package: under an fcntl lock shared by all workers, the library
is built whole in a directory of its own under build/ (gitignored; named
by a hash of the sources, so each machine builds it once), and a process
whose library is not loaded is pointed at that build and loads it.
"""

import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess

ROOT = pathlib.Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native"
SOURCES = ("Makefile", "mtpu_native.cc", "mtpu_pyext.c")
BUILD_TIMEOUT_S = 900


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((NATIVE / name).read_bytes())
    return ROOT / "build" / f"jax-native-{h.hexdigest()[:16]}"


def jax_native_library() -> bool:
    """Load the JAX package's C++ library in this process (if it is not
    loaded yet) from a whole build; -> whether it is loaded."""
    from minio_tpu.native import lib as jlib

    if jlib._lib is not None:
        return True
    target = _build_dir()
    target.parent.mkdir(parents=True, exist_ok=True)
    with open(target.parent / "jax-native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not (target / "libmtpu_native.so").exists():
                tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
                shutil.rmtree(tmp, ignore_errors=True)
                tmp.mkdir()
                for name in SOURCES:
                    shutil.copy2(NATIVE / name, tmp / name)
                subprocess.run(["make", "-C", str(tmp)], check=True,
                               capture_output=True, timeout=BUILD_TIMEOUT_S)
                os.replace(tmp, target)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    with jlib._mu:
        if jlib._lib is None:
            jlib._REPO_NATIVE = str(target)
            jlib._tried = False
            if jlib._PYEXT is None:
                jlib._PYEXT = "unset"
    jlib._build_and_load()
    return jlib._lib is not None
