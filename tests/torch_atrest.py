"""Shared pieces of the port's interop tests over HTTP: the JAX S3Server
served by aiohttp on a thread beside the port's server, seeded payloads,
the SSE request headers, the key file both packages' LocalKMS read, and
a runner that repeats a test file's cases in a child interpreter with the
`cryptography` package hidden, so both AEAD providers are covered."""

import asyncio
import base64
import hashlib
import os
import subprocess
import sys
import threading

import numpy as np

from tests.conftest import S3_ACCESS, S3_SECRET, free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FALLBACK_ENV = "MTPU_TEST_HIDE_CRYPTOGRAPHY"


class JaxServer:
    """The JAX S3Server over its own drives (mxsum256, the port's default
    algorithm), served by aiohttp on a thread."""

    def __init__(self, paths, parity=None):
        from aiohttp import web

        from minio_tpu.erasure.pools import ErasureServerPools
        from minio_tpu.erasure.sets import ErasureSets
        from minio_tpu.s3 import sigv4
        from minio_tpu.s3.server import S3Server
        from minio_tpu.storage.local import LocalDrive

        sets = ErasureSets([LocalDrive(p) for p in paths], parity=parity,
                           bitrot_algorithm="mxsum256")
        self.srv = S3Server(ErasureServerPools([sets]),
                            sigv4.Credentials(S3_ACCESS, S3_SECRET))
        port = free_port()
        self.loop = asyncio.new_event_loop()
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)

            async def start():
                self.runner = web.AppRunner(self.srv.app)
                await self.runner.setup()
                await web.TCPSite(self.runner, "127.0.0.1", port).start()
                started.set()

            self.loop.run_until_complete(start())
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(30)
        self.url = f"http://127.0.0.1:{port}"

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(), self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        assert not self.thread.is_alive()
        close = getattr(self.srv.obj, "close", None)
        if close is not None:
            close()


def port_server(paths, parity=None):
    from minio_tpu_torch.s3.server import build_server

    return build_server(paths, S3_ACCESS, S3_SECRET, device="cpu", parity=parity,
                        enable_mrf=False).start()


def client(url):
    from tests.s3client import SigV4Client

    return SigV4Client(url, S3_ACCESS, S3_SECRET)


def payload(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    prefix = ("x-amz-copy-source-server-side-encryption-customer" if copy_source
              else "x-amz-server-side-encryption-customer")
    return {f"{prefix}-algorithm": "AES256",
            f"{prefix}-key": base64.b64encode(key).decode(),
            f"{prefix}-key-MD5": base64.b64encode(hashlib.md5(key).digest()).decode()}


SSEC_KEY = bytes(range(32))

# name -> the PUT / CreateMultipartUpload headers (and, for SSE-C, every
# later call's too).
SSE_CASES = {
    "sse-s3": {"x-amz-server-side-encryption": "AES256"},
    "sse-c": ssec_headers(SSEC_KEY),
    "sse-kms": {"x-amz-server-side-encryption": "aws:kms"},
    "sse-kms-k2": {"x-amz-server-side-encryption": "aws:kms",
                   "x-amz-server-side-encryption-aws-kms-key-id": "k2"},
}

BUCKET_DEFAULT = {
    "AES256": (b'<ServerSideEncryptionConfiguration><Rule>'
               b'<ApplyServerSideEncryptionByDefault><SSEAlgorithm>AES256'
               b'</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>'
               b'</ServerSideEncryptionConfiguration>'),
    "aws:kms": (b'<ServerSideEncryptionConfiguration><Rule>'
                b'<ApplyServerSideEncryptionByDefault><SSEAlgorithm>aws:kms'
                b'</SSEAlgorithm></ApplyServerSideEncryptionByDefault></Rule>'
                b'</ServerSideEncryptionConfiguration>'),
}


def write_key_file(path) -> str:
    """A LocalKMS key file with master keys k1 and k2 (fixed bytes)."""
    with open(path, "w", encoding="utf-8") as f:
        for i, kid in enumerate(("k1", "k2")):
            f.write(f"{kid}:{base64.b64encode(bytes([i + 1]) * 32).decode()}\n")
    return str(path)


def run_under_fallback(test_file: str, select: str, timeout: float = 600) -> str:
    """Run `select` (a -k expression) of `test_file` in a child pytest with
    `cryptography` hidden; -> its output. Raises if a case fails or none
    ran."""
    code = ("import os, sys; sys.modules['cryptography'] = None; import pytest; "
            f"sys.exit(pytest.main(['-q', '-p', 'no:cacheprovider', '-p', 'no:randomly', "
            f"'-p', 'no:xdist', {test_file!r}, '-k', {select!r}]))")
    env = dict(os.environ, **{FALLBACK_ENV: "1"})
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0 or " passed" not in out.stdout:
        raise AssertionError(f"fallback run of {test_file} -k {select!r} failed:\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-2000:]}")
    return out.stdout
