"""DARE-style authenticated streaming encryption (a copy of
minio_tpu/crypto/sse.py: the same framing, nonces and sealed keys, so each
package decrypts what the other stored).

Format (role-equivalent of the reference's DARE 2.0 via secure-io/sio-go,
cmd/encryption-v1.go:195): plaintext is split into fixed 64 KiB chunks;
chunk i is encrypted AES-256-GCM with nonce = base_nonce XOR i and the
16-byte tag appended, so every chunk is independently authenticated and
ranged reads decrypt only the chunks they touch. The final chunk's nonce
has the MSB of the XORed counter set, binding stream termination (a
truncated stream fails authentication).

Key hierarchy (cmd/crypto/key.go):
  object key  - random 32 bytes per object, encrypts the data
  sealing key - SSE-C: the client-supplied key; SSE-S3: the KMS master key
  sealed key  - AES-GCM(object key, sealing key, aad=bucket/object) stored
                in object metadata
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import BinaryIO

from minio_tpu_torch.crypto.aead import AESGCM

CHUNK_SIZE = 64 << 10
TAG_SIZE = 16
NONCE_SIZE = 12
ENC_CHUNK = CHUNK_SIZE + TAG_SIZE

# Internal metadata keys (reference crypto.MetaSealedKeySSEC etc.)
META_ALGO = "x-mtpu-internal-sse"           # "SSE-C" | "SSE-S3" | "SSE-KMS"
META_SEALED_KEY = "x-mtpu-internal-sse-sealed-key"
META_NONCE = "x-mtpu-internal-sse-nonce"
META_KEY_MD5 = "x-mtpu-internal-ssec-key-md5"
META_ACTUAL_SIZE = "x-mtpu-internal-actual-size"
META_KMS_KEY_ID = "x-mtpu-internal-sse-kms-key-id"


class SSEError(Exception):
    pass


def _chunk_nonce(base: bytes, index: int, final: bool) -> bytes:
    ctr = index | (1 << 63) if final else index
    return base[:4] + struct.pack(">Q", ctr)


def encrypted_size(plain: int) -> int:
    if plain == 0:
        return TAG_SIZE  # one empty authenticated chunk
    full, rem = divmod(plain, CHUNK_SIZE)
    return full * ENC_CHUNK + (rem + TAG_SIZE if rem else 0)


def encrypted_part_size(plain: int) -> int:
    """Stored size of one multipart part: 12-byte nonce prefix + DARE
    stream. Each part is an independent stream (its own random nonce),
    matching the reference where every part is encrypted separately
    (cmd/encryption-v1.go DecryptObjectInfo part walk)."""
    return NONCE_SIZE + encrypted_size(plain)


def part_plain_size(stored: int) -> int:
    """Invert encrypted_part_size — plaintext length from a part's stored
    length. Deterministic because the framing is fixed-size chunks."""
    e = stored - NONCE_SIZE
    if e <= TAG_SIZE:
        return 0
    full, rem = divmod(e, ENC_CHUNK)
    return full * CHUNK_SIZE + (rem - TAG_SIZE if rem else 0)


def decrypted_range(offset: int, length: int, actual_size: int
                    ) -> tuple[int, int, int]:
    """Map a plaintext range to (encrypted offset, encrypted length,
    skip-bytes-after-decrypt). Decryption must start at a chunk boundary."""
    first = offset // CHUNK_SIZE
    last = (offset + length - 1) // CHUNK_SIZE if length > 0 else first
    enc_off = first * ENC_CHUNK
    enc_end = min(encrypted_size(actual_size), (last + 1) * ENC_CHUNK)
    return enc_off, enc_end - enc_off, offset - first * CHUNK_SIZE


def derive_part_key(object_key: bytes, part_nonce: bytes) -> bytes:
    """Per-part data key for multipart SSE: HMAC-SHA256(object_key,
    part_nonce). Parts all descend from one sealed object key, but each
    encrypts under its own derived key — _chunk_nonce keeps only 4 bytes
    of the random nonce, so sharing the raw object key across parts would
    risk GCM (key, nonce) reuse between same-indexed chunks of different
    parts. Distinct keys make chunk-nonce collisions across parts
    harmless (the reference likewise encrypts each part under its own
    derived key, cmd/encryption-v1.go part crypto)."""
    import hmac as _hmac

    # Accept memoryview/bytearray nonces from zero-copy GET pipelines
    # (12 bytes — the coercion is not a payload copy).
    return _hmac.new(object_key, b"mtpu-part-key" + bytes(part_nonce),
                     hashlib.sha256).digest()


def seal_key(object_key: bytes, sealing_key: bytes, aad: str) -> str:
    nonce = os.urandom(NONCE_SIZE)
    sealed = AESGCM(sealing_key).encrypt(nonce, object_key, aad.encode())
    return base64.b64encode(nonce + sealed).decode()


def unseal_key(sealed_b64: str, sealing_key: bytes, aad: str) -> bytes:
    try:
        raw = base64.b64decode(sealed_b64)
        return AESGCM(sealing_key).decrypt(raw[:NONCE_SIZE],
                                           raw[NONCE_SIZE:], aad.encode())
    except Exception:
        raise SSEError("key unseal failed: wrong key or corrupt "
                       "metadata") from None


class EncryptReader:
    """File-like producing the DARE stream of an underlying plaintext
    reader; fed to put_object in place of the raw body."""

    def __init__(self, src: BinaryIO, object_key: bytes, base_nonce: bytes):
        self._src = src
        self._aes = AESGCM(object_key)
        self._nonce = base_nonce
        self._index = 0
        self._buf = b""
        self._pending: bytes | None = None
        self._eof = False

    def _refill(self) -> None:
        # One chunk of lookahead makes the final chunk knowable before it
        # is sealed (its nonce differs — truncation protection).
        if self._pending is None:
            self._pending = self._read_full(CHUNK_SIZE)
        chunk = self._pending
        self._pending = self._read_full(CHUNK_SIZE)
        final = len(self._pending) == 0
        nonce = _chunk_nonce(self._nonce, self._index, final)
        self._buf += self._aes.encrypt(nonce, chunk, None)
        self._index += 1
        if final:
            self._eof = True

    def _read_full(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            c = self._src.read(n - len(out))
            if not c:
                break
            out += c
        return bytes(out)

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            before = len(self._buf)
            self._refill()
            if len(self._buf) == before and self._eof:
                break
        if n < 0:
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        try:
            self._src.close()
        except Exception:
            pass


class DecryptReader:
    """Iterator of plaintext chunks from an iterator of DARE bytes.

    start_chunk: index of the first chunk present in the stream (ranged
    reads hand us a chunk-aligned suffix); total_chunks: chunk count of
    the whole object (to mark the final chunk's nonce)."""

    def __init__(self, it, object_key: bytes, base_nonce: bytes,
                 start_chunk: int = 0, total_chunks: int | None = None):
        self._it = iter(it)
        self._aes = AESGCM(object_key)
        self._nonce = bytes(base_nonce)  # 12B; views welcome upstream
        self._index = start_chunk
        self._total = total_chunks

    def __iter__(self):
        buf = bytearray()
        exhausted = False
        while True:
            # One byte of lookahead past the chunk: a full chunk is only
            # "last" if the stream truly ends right after it.
            while len(buf) <= ENC_CHUNK and not exhausted:
                try:
                    buf += next(self._it)
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            take = min(ENC_CHUNK, len(buf))
            chunk = bytes(buf[:take])
            del buf[:take]
            is_last = exhausted and not buf
            final = (self._total is not None
                     and self._index == self._total - 1) or (
                self._total is None and is_last)
            try:
                plain = self._aes.decrypt(
                    _chunk_nonce(self._nonce, self._index, final),
                    chunk, None)
            except Exception:
                raise SSEError(
                    f"chunk {self._index} failed authentication") from None
            self._index += 1
            yield plain


def total_chunks(actual_size: int) -> int:
    if actual_size == 0:
        return 1
    return (actual_size + CHUNK_SIZE - 1) // CHUNK_SIZE


def sse_headers_for(metadata: dict) -> dict:
    """Response headers advertising the encryption applied."""
    algo = metadata.get(META_ALGO, "")
    if algo == "SSE-C":
        return {"x-amz-server-side-encryption-customer-algorithm": "AES256",
                "x-amz-server-side-encryption-customer-key-MD5":
                    metadata.get(META_KEY_MD5, "")}
    if algo == "SSE-S3":
        return {"x-amz-server-side-encryption": "AES256"}
    if algo == "SSE-KMS":
        return {"x-amz-server-side-encryption": "aws:kms",
                "x-amz-server-side-encryption-aws-kms-key-id":
                    metadata.get(META_KMS_KEY_ID, "")}
    return {}


def parse_ssec_headers(headers, copy_source: bool = False) -> bytes | None:
    """Validate + decode the SSE-C key headers; returns the 32-byte key
    (cmd/crypto/sse-c.go ParseHTTP)."""
    prefix = ("x-amz-copy-source-server-side-encryption-customer"
              if copy_source else "x-amz-server-side-encryption-customer")
    algo = headers.get(f"{prefix}-algorithm")
    key_b64 = headers.get(f"{prefix}-key")
    md5_b64 = headers.get(f"{prefix}-key-md5") or headers.get(
        f"{prefix}-key-MD5")
    if not algo and not key_b64:
        return None
    if algo != "AES256" or not key_b64 or not md5_b64:
        raise SSEError("SSE-C requires algorithm=AES256, key and key-MD5")
    try:
        key = base64.b64decode(key_b64)
    except Exception:
        raise SSEError("SSE-C key is not valid base64") from None
    if len(key) != 32:
        raise SSEError("SSE-C key must be 32 bytes")
    if base64.b64encode(hashlib.md5(key).digest()).decode() != md5_b64:
        raise SSEError("SSE-C key MD5 mismatch")
    return key
