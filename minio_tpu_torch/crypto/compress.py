"""Transparent object compression (counterpart of
minio_tpu/crypto/compress.py; the klauspost/compress S2 role,
cmd/object-api-utils.go:926 newS2CompressReader / isCompressible:440).

Two schemes, recorded per object in x-mtpu-internal-compression:

- ``s2/1``: the snappy framing format over snappy blocks — 64 KiB
  frames, each carrying a masked CRC32C of its plaintext, compressed by
  the host library's greedy matcher (csrc/host_codec.cc, the JAX
  package's own, so both packages store the same frames), incompressible
  frames stored raw. The port always writes this scheme: its host library
  is built on first use wherever the port runs.
- ``zlib/1``: what a JAX deployment without its C++ library wrote. The
  port reads it and never writes it.

GET decompresses by the stored scheme; a ranged GET decompresses from the
start and skips (neither format can seek — the reference has the same
constraint).
"""

from __future__ import annotations

import fnmatch
import zlib
from typing import BinaryIO, Iterator

from minio_tpu_torch.native import lib as hostlib

META_COMPRESSION = "x-mtpu-internal-compression"
META_ACTUAL_SIZE = "x-mtpu-internal-uncompressed-size"
SCHEME_ZLIB = "zlib/1"
SCHEME_S2 = "s2/1"

# Snappy framing constants (the public framing format: stream identifier,
# then 4-byte chunk headers [type, len24le] + payload).
_STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_CHUNK_COMPRESSED = 0x00
_CHUNK_UNCOMPRESSED = 0x01
_CHUNK_PADDING = 0xFE
_FRAME_LEN = 1 << 16


def _mask_crc(crc: int) -> int:
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def is_compressible(key: str, content_type: str,
                    extensions: list[str], mime_types: list[str]) -> bool:
    """Extension/MIME gating (cmd/object-api-utils.go isCompressible).
    Empty filter lists mean "everything"."""
    ext_ok = not extensions or any(
        key.lower().endswith(e.lower()) for e in extensions if e)
    mime_ok = not mime_types or any(
        fnmatch.fnmatch(content_type or "", p) for p in mime_types if p)
    if extensions and mime_types:
        return ext_ok or mime_ok
    return ext_ok and mime_ok


class CompressReader:
    """File-like producing the S2 stream of an underlying reader."""

    def __init__(self, src: BinaryIO):
        self.scheme = SCHEME_S2
        self._src = src
        # bytearray: frames are appended 64 KiB at a time, and immutable
        # concatenation would copy the whole buffer per frame.
        self._buf = bytearray(_STREAM_ID)
        self._eof = False
        self.bytes_in = 0

    def _pump(self) -> None:
        chunk = self._src.read(_FRAME_LEN)
        if not chunk:
            self._eof = True
            return
        self.bytes_in += len(chunk)
        crc = _mask_crc(hostlib.crc32c(chunk))
        body = hostlib.snappy_compress(chunk)
        if len(body) >= len(chunk):  # incompressible frame: store raw
            body, ctype = chunk, _CHUNK_UNCOMPRESSED
        else:
            ctype = _CHUNK_COMPRESSED
        n = len(body) + 4
        self._buf += bytes((ctype, n & 0xFF, (n >> 8) & 0xFF, (n >> 16) & 0xFF))
        self._buf += crc.to_bytes(4, "little")
        self._buf += body

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            self._pump()
        if n < 0:
            out, self._buf = bytes(self._buf), bytearray()
        else:
            out = bytes(self._buf[:n])
            del self._buf[:n]
        return out

    def close(self) -> None:
        close = getattr(self._src, "close", None)
        if close is not None:
            close()


def _s2_frames(it: Iterator[bytes]) -> Iterator[bytes]:
    """Parse a snappy framing stream into plaintext frames, verifying each
    frame's masked CRC32C."""
    buf = bytearray()
    pos = 0
    it = iter(it)
    exhausted = False

    def fill(k: int) -> bool:
        nonlocal exhausted
        while len(buf) - pos < k and not exhausted:
            chunk = next(it, None)
            if chunk is None:
                exhausted = True
            else:
                buf.extend(chunk)
        return len(buf) - pos >= k

    while True:
        if not fill(4):
            if len(buf) - pos:
                raise ValueError("truncated s2 stream (partial header)")
            return
        ctype = buf[pos]
        clen = int.from_bytes(buf[pos + 1:pos + 4], "little")
        if not fill(4 + clen):
            raise ValueError("truncated s2 stream (partial chunk)")
        payload = bytes(buf[pos + 4:pos + 4 + clen])
        pos += 4 + clen
        if pos > (1 << 20):
            del buf[:pos]
            pos = 0
        if ctype == 0xFF:  # stream identifier (may repeat at concat points)
            if payload != _STREAM_ID[4:]:
                raise ValueError("bad s2 stream identifier")
            continue
        if ctype == _CHUNK_PADDING or 0x80 <= ctype <= 0xFD:
            continue  # padding / skippable
        if ctype not in (_CHUNK_COMPRESSED, _CHUNK_UNCOMPRESSED):
            raise ValueError(f"unskippable s2 chunk type {ctype:#x}")
        if clen < 4:
            raise ValueError("s2 chunk too short for checksum")
        want = int.from_bytes(payload[:4], "little")
        body = payload[4:]
        if ctype == _CHUNK_COMPRESSED:
            # Frames carry <= 64 KiB of plaintext (the framing-format cap);
            # bound the decode so a corrupt length header can't balloon.
            body = hostlib.snappy_uncompress(body, max_len=_FRAME_LEN)
        elif len(body) > _FRAME_LEN:
            raise ValueError("oversized s2 uncompressed chunk")
        if _mask_crc(hostlib.crc32c(body)) != want:
            raise ValueError("s2 frame checksum mismatch")
        yield body


def _zlib_chunks(it: Iterator[bytes]) -> Iterator[bytes]:
    z = zlib.decompressobj()
    for chunk in it:
        out = z.decompress(chunk)
        if out:
            yield out
    tail = z.flush()
    if tail:
        yield tail


def decompress_iter(it: Iterator[bytes], offset: int = 0, length: int = -1,
                    scheme: str = SCHEME_ZLIB) -> Iterator[bytes]:
    """Decompress a stored stream, yielding [offset, offset+length) of the
    plaintext. `scheme` is the object's recorded META_COMPRESSION value."""
    if scheme == SCHEME_S2:
        src = _s2_frames(it)
    elif scheme == SCHEME_ZLIB:
        src = _zlib_chunks(it)
    else:
        raise ValueError(f"unknown compression scheme {scheme!r}")
    skip = offset
    remaining = length
    for out in src:
        if skip:
            if len(out) <= skip:
                skip -= len(out)
                continue
            out = out[skip:]
            skip = 0
        if remaining >= 0:
            if len(out) >= remaining:
                yield out[:remaining]
                return
            remaining -= len(out)
        yield out
