"""CRC-32C (Castagnoli), the journal checksum of storage/xlmeta.py.

The JAX package computes it in its native host library; the port has no
native library on the card's machine, so it computes the same checksum
(same polynomial, init and final xor) with numpy, and both packages
accept each other's journals. A journal grows with its versions and parts
(a 320-part multipart object's is tens of KiB, four inline versions up to
64 KiB) and every journal read and write checks it, so the byte loop is
kept only for short inputs.

A CRC register is linear over GF(2): a byte b followed by k bytes adds
zeros_k(T[b]) to the final register, zeros_k being the map "feed k zero
bytes". So a 256-byte lane's register is the xor of one table entry per
byte (P), and the register of lanes in a row is the xor of each lane's
register moved past the zero bytes after it (Q[d]: 256 * d zero bytes,
one table per register byte): a few vectorized gathers instead of a
Python step per byte. Longer inputs go through in 256 KiB pieces.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import numpy as np

_POLY = 0x82F63B78  # reflected Castagnoli polynomial
_SHORT = 256        # below this many bytes the byte loop is faster
_LANE = 256         # bytes per lane (P's rows)
_LANES = 1024       # lanes per piece (Q's rows): 256 KiB


def _table() -> tuple[int, ...]:
    out = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        out.append(c)
    return tuple(out)


_TABLE = _table()


def _crc_bytes(data, crc: int) -> int:
    """The register after feeding `data` byte by byte from `crc`."""
    tbl = _TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _apply(op, x):
    """A register map given as four 256-entry tables (one per register
    byte), applied to a register (int) or an array of registers."""
    return (op[0][x & 0xFF] ^ op[1][(x >> 8) & 0xFF]
            ^ op[2][(x >> 16) & 0xFF] ^ op[3][(x >> 24) & 0xFF])


@lru_cache(maxsize=None)
def _zeros_op(log2_n: int) -> tuple:
    """The map of feeding 2**log2_n zero bytes, as four byte tables."""
    if log2_n == 0:
        cols = [_TABLE[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32)]
    else:
        half = _zeros_op(log2_n - 1)
        cols = [int(_apply(half, _apply(half, 1 << i))) for i in range(32)]
    tables = []
    for byte in range(4):
        t = [0] * 256
        for v in range(1, 256):
            low = v & -v
            t[v] = t[v ^ low] ^ cols[8 * byte + low.bit_length() - 1]
        tables.append(np.array(t, dtype=np.uint32))
    return tuple(tables)


_TABLES_MU = threading.Lock()


def _lane_tables() -> tuple:
    """The lane tables, built once: a commit checksums its journal on
    every drive's thread at once, and each would otherwise build them."""
    with _TABLES_MU:
        return _build_lane_tables()


@lru_cache(maxsize=1)
def _build_lane_tables() -> tuple:
    """P, flattened: the entry of byte b at lane position j is
    P[j * 256 + b]; and Q [_LANES, 4, 256]: Q[d] moves a register past
    256 * d zero bytes."""
    one = _zeros_op(0)
    p = np.empty((_LANE, 256), dtype=np.uint32)
    p[0] = np.array(_TABLE, dtype=np.uint32)
    for k in range(1, _LANE):
        p[k] = _apply(one, p[k - 1])
    lane = _zeros_op(_LANE.bit_length() - 1)
    q = np.empty((_LANES, 4, 256), dtype=np.uint32)
    v = np.arange(256, dtype=np.uint32)
    for i in range(4):
        q[0, i] = v << (8 * i)
    for d in range(1, _LANES):
        q[d] = _apply(lane, q[d - 1])
    # Position j of a lane is followed by _LANE - 1 - j bytes.
    return p[::-1].reshape(-1).copy(), q


def _piece_register(mv) -> int:
    """The register after feeding a piece (at most _LANE * _LANES bytes)
    from 0. Leading zero bytes leave a zero register unchanged, so the
    piece is padded in front to whole lanes."""
    p, q = _lane_tables()
    n = len(mv)
    lanes = -(-n // _LANE)
    buf = np.zeros(lanes * _LANE, dtype=np.uint8)
    buf[buf.size - n:] = np.frombuffer(mv, dtype=np.uint8)
    rows = buf.reshape(lanes, _LANE).astype(np.intp)
    rows += np.arange(0, _LANE * 256, 256, dtype=np.intp)
    regs = np.bitwise_xor.reduce(p[rows], axis=1)
    moves = q[lanes - 1::-1] if lanes < _LANES else q[::-1]
    at = np.arange(lanes)
    total = (moves[at, 0, regs & 0xFF] ^ moves[at, 1, (regs >> 8) & 0xFF]
             ^ moves[at, 2, (regs >> 16) & 0xFF] ^ moves[at, 3, regs >> 24])
    return int(np.bitwise_xor.reduce(total))


def crc32c(data, offset: int = 0) -> int:
    """CRC-32C of data[offset:] (bytes-like)."""
    mv = memoryview(data).cast("B")[offset:]
    n = len(mv)
    if n < _SHORT:
        return _crc_bytes(mv, 0xFFFFFFFF) ^ 0xFFFFFFFF
    # The initial register 0xFFFFFFFF equals a zero register with the
    # first 4 bytes inverted; each piece after the first moves the
    # register past its own length.
    piece = _LANE * _LANES
    reg = 0
    for start in range(0, n, piece):
        part = mv[start:start + piece]
        if start == 0:
            part = memoryview(bytes(b ^ 0xFF for b in part[:4]) + part[4:])
        for k in range(len(part).bit_length() if reg else 0):
            if len(part) >> k & 1:
                reg = int(_apply(_zeros_op(k), reg))
        reg ^= _piece_register(part)
    return reg ^ 0xFFFFFFFF
