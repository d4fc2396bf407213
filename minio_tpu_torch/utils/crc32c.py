"""CRC-32C (Castagnoli), the journal checksum of storage/xlmeta.py.

The JAX package computes it in its native host library; the port keeps a
table-driven pure-Python version (same polynomial, init and final xor), so
both packages accept each other's journals. Journals are small (a few
hundred bytes, at most the 16 KiB inline limit plus headers).
"""

from __future__ import annotations

_POLY = 0x82F63B78  # reflected Castagnoli polynomial


def _table() -> tuple[int, ...]:
    out = []
    for b in range(256):
        c = b
        for _ in range(8):
            c = (c >> 1) ^ (_POLY if c & 1 else 0)
        out.append(c)
    return tuple(out)


_TABLE = _table()


def crc32c(data, offset: int = 0) -> int:
    """CRC-32C of data[offset:] (bytes-like)."""
    tbl = _TABLE
    crc = 0xFFFFFFFF
    for b in memoryview(data).cast("B")[offset:]:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF
