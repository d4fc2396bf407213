"""SipHash-2-4 — deterministic keyed object→set routing (a copy of
minio_tpu/utils/siphash.py, so both packages route every key to the same
set).

The reference routes each object to an erasure set with
sipHashMod(key, setCount, deploymentID) (cmd/erasure-sets.go:697-736,
dchest/siphash). The hash must be identical on every node forever — it is
part of the on-disk layout — so this is a faithful SipHash-2-4, keyed by the
deployment ID's 16 raw UUID bytes.
"""

from __future__ import annotations

import uuid

_M = (1 << 64) - 1


def _round(v0: int, v1: int, v2: int, v3: int):
    v0 = (v0 + v1) & _M
    v1 = ((v1 << 13) | (v1 >> 51)) & _M
    v1 ^= v0
    v0 = ((v0 << 32) | (v0 >> 32)) & _M
    v2 = (v2 + v3) & _M
    v3 = ((v3 << 16) | (v3 >> 48)) & _M
    v3 ^= v2
    v0 = (v0 + v3) & _M
    v3 = ((v3 << 21) | (v3 >> 43)) & _M
    v3 ^= v0
    v2 = (v2 + v1) & _M
    v1 = ((v1 << 17) | (v1 >> 47)) & _M
    v1 ^= v2
    v2 = ((v2 << 32) | (v2 >> 32)) & _M
    return v0, v1, v2, v3


def siphash24(key: bytes, data: bytes) -> int:
    """64-bit SipHash-2-4 of data under a 16-byte key."""
    if len(key) != 16:
        raise ValueError("siphash key must be 16 bytes")
    k0 = int.from_bytes(key[0:8], "little")
    k1 = int.from_bytes(key[8:16], "little")
    v0 = 0x736F6D6570736575 ^ k0
    v1 = 0x646F72616E646F6D ^ k1
    v2 = 0x6C7967656E657261 ^ k0
    v3 = 0x7465646279746573 ^ k1
    n = len(data)
    for i in range(0, n - (n % 8), 8):
        mi = int.from_bytes(data[i:i + 8], "little")
        v3 ^= mi
        v0, v1, v2, v3 = _round(v0, v1, v2, v3)
        v0, v1, v2, v3 = _round(v0, v1, v2, v3)
        v0 ^= mi
    last = data[n - (n % 8):]
    mi = int.from_bytes(last + b"\x00" * (7 - len(last)), "little") | (
        (n & 0xFF) << 56
    )
    v3 ^= mi
    v0, v1, v2, v3 = _round(v0, v1, v2, v3)
    v0, v1, v2, v3 = _round(v0, v1, v2, v3)
    v0 ^= mi
    v2 ^= 0xFF
    for _ in range(4):
        v0, v1, v2, v3 = _round(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & _M


def sip_hash_mod(key: str, cardinality: int, deployment_id: str) -> int:
    """Route an object key to one of `cardinality` sets, keyed by the
    deployment ID (reference sipHashMod, cmd/erasure-sets.go:697)."""
    if cardinality <= 1:
        return 0
    dep = uuid.UUID(deployment_id).bytes
    return siphash24(dep, key.encode()) % cardinality
