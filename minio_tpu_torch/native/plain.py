"""Plain pure-Python versions of the host hashes in csrc/host_hash.cc.

The tests hold the host library against these; no serving path calls
them. `sip256_py` is a copy of the JAX package's `_sip256_py`
(minio_tpu/native/lib.py) and `highwayhash256_py` of its
`highwayhash256_py` (minio_tpu/native/hh_py.py, written from Google's
published portable reference; the byte placements in its length padding
are part of the HighwayHash definition). `xxh64_py` is written from the
published xxHash specification (XXH64).
"""

from __future__ import annotations

from minio_tpu_torch.utils.siphash import _round

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1


# --- sip256 -----------------------------------------------------------------


def sip256_py(key32: bytes, data: bytes) -> bytes:
    """4 SipHash-2-4 lanes over interleaved 8-byte words, word-absorbed:
    the final partial word is zero-padded and a per-lane tag binds the
    total length."""
    k0 = int.from_bytes(key32[0:8], "little")
    k1 = int.from_bytes(key32[8:16], "little")
    k2 = int.from_bytes(key32[16:24], "little")
    k3 = int.from_bytes(key32[24:32], "little")
    lane_keys = [
        (k0, k1),
        (k0 ^ 0xA5A5A5A5A5A5A5A5, k2),
        (k1 ^ 0x3C3C3C3C3C3C3C3C, k3),
        (k2 ^ 0x9696969696969696, k3 ^ k0),
    ]
    states = []
    for lk0, lk1 in lane_keys:
        states.append([0x736F6D6570736575 ^ lk0, 0x646F72616E646F6D ^ lk1,
                       0x6C7967656E657261 ^ lk0, 0x7465646279746573 ^ lk1])

    def absorb(s, m):
        s[3] ^= m
        s[0], s[1], s[2], s[3] = _round(*s)
        s[0], s[1], s[2], s[3] = _round(*s)
        s[0] ^= m

    data = bytes(data)
    n = len(data)
    ngroups = n // 32
    for g in range(ngroups):
        base = g * 32
        for i in range(4):
            absorb(states[i],
                   int.from_bytes(data[base + 8 * i:base + 8 * i + 8], "little"))
    rem = data[ngroups * 32:]
    lane_i = 0
    while len(rem) >= 8:
        absorb(states[lane_i & 3], int.from_bytes(rem[:8], "little"))
        rem = rem[8:]
        lane_i += 1
    if rem:
        absorb(states[lane_i & 3],
               int.from_bytes(rem + b"\x00" * (8 - len(rem)), "little"))

    out = b""
    for i, s in enumerate(states):
        absorb(s, (n ^ ((0x0101010101010101 * i) & _M64)) & _M64)
        s[2] ^= 0xFF
        for _ in range(4):
            s[0], s[1], s[2], s[3] = _round(*s)
        out += ((s[0] ^ s[1] ^ s[2] ^ s[3]) & _M64).to_bytes(8, "little")
    return out


# --- HighwayHash-256 ----------------------------------------------------------

_INIT0 = (0xDBE6D5D5FE4CCE2F, 0xA4093822299F31D0,
          0x13198A2E03707344, 0x243F6A8885A308D3)
_INIT1 = (0x3BD39E10CB0EF593, 0xC0ACF169B5F18A8C,
          0xBE5466CF34E90C6C, 0x452821E638D01377)


def _rot32(x: int) -> int:
    return ((x >> 32) | (x << 32)) & _M64


def _maskb(v: int, b: int) -> int:
    return v & (0xFF << (b * 8))


class _HH:
    def __init__(self, key32: bytes):
        k = [int.from_bytes(key32[8 * i:8 * i + 8], "little") for i in range(4)]
        self.v0 = [_INIT0[i] ^ k[i] for i in range(4)]
        self.v1 = [_INIT1[i] ^ _rot32(k[i]) for i in range(4)]
        self.mul0 = list(_INIT0)
        self.mul1 = list(_INIT1)

    def _zipper(self, v1: int, v0: int) -> tuple[int, int]:
        """-> (add1_delta, add0_delta)."""
        add0 = (((_maskb(v0, 3) + _maskb(v1, 4)) >> 24)
                + ((_maskb(v0, 5) + _maskb(v1, 6)) >> 16) + _maskb(v0, 2)
                + (_maskb(v0, 1) << 32) + (_maskb(v1, 7) >> 8)
                + (v0 << 56)) & _M64
        add1 = (((_maskb(v1, 3) + _maskb(v0, 4)) >> 24) + _maskb(v1, 2)
                + (_maskb(v1, 5) >> 16) + (_maskb(v1, 1) << 24)
                + (_maskb(v0, 6) >> 8) + (_maskb(v1, 0) << 48)
                + _maskb(v0, 7)) & _M64
        return add1, add0

    def update(self, lanes: list[int]) -> None:
        v0, v1, mul0, mul1 = self.v0, self.v1, self.mul0, self.mul1
        for i in range(4):
            v1[i] = (v1[i] + lanes[i] + mul0[i]) & _M64
            mul0[i] ^= ((v1[i] & _M32) * (v0[i] >> 32)) & _M64
            v0[i] = (v0[i] + mul1[i]) & _M64
            mul1[i] ^= ((v0[i] & _M32) * (v1[i] >> 32)) & _M64
        for a, b in ((0, 1), (2, 3)):
            d1, d0 = self._zipper(v1[b], v1[a])
            v0[b] = (v0[b] + d1) & _M64
            v0[a] = (v0[a] + d0) & _M64
        for a, b in ((0, 1), (2, 3)):
            d1, d0 = self._zipper(v0[b], v0[a])
            v1[b] = (v1[b] + d1) & _M64
            v1[a] = (v1[a] + d0) & _M64

    def update_packet(self, p: bytes) -> None:
        self.update([int.from_bytes(p[8 * i:8 * i + 8], "little") for i in range(4)])

    def update_remainder(self, tail: bytes) -> None:
        mod32 = len(tail)  # 1..31
        pair = ((mod32 << 32) + mod32) & _M64
        for i in range(4):
            self.v0[i] = (self.v0[i] + pair) & _M64
            lo = self.v1[i] & _M32
            hi = self.v1[i] >> 32
            lo = ((lo << mod32) | (lo >> (32 - mod32))) & _M32
            hi = ((hi << mod32) | (hi >> (32 - mod32))) & _M32
            self.v1[i] = (hi << 32) | lo
        mod4 = mod32 & 3
        head = tail[: mod32 & ~3]
        rem = tail[mod32 & ~3:]
        packet = bytearray(32)
        packet[: len(head)] = head
        if mod32 & 16:
            packet[28:32] = tail[mod32 - 4: mod32]
        elif mod4:
            last3 = rem[0] + (rem[mod4 >> 1] << 8) + (rem[mod4 - 1] << 16)
            packet[16:24] = last3.to_bytes(8, "little")
        self.update_packet(bytes(packet))

    def finalize256(self) -> bytes:
        for _ in range(10):
            permuted = [_rot32(self.v0[2]), _rot32(self.v0[3]),
                        _rot32(self.v0[0]), _rot32(self.v0[1])]
            self.update(permuted)
        r1, r0 = _mod_reduce(
            (self.v1[1] + self.mul1[1]) & _M64, (self.v1[0] + self.mul1[0]) & _M64,
            (self.v0[1] + self.mul0[1]) & _M64, (self.v0[0] + self.mul0[0]) & _M64)
        r3, r2 = _mod_reduce(
            (self.v1[3] + self.mul1[3]) & _M64, (self.v1[2] + self.mul1[2]) & _M64,
            (self.v0[3] + self.mul0[3]) & _M64, (self.v0[2] + self.mul0[2]) & _M64)
        return b"".join(x.to_bytes(8, "little") for x in (r0, r1, r2, r3))


def _shift128(bits: int, a1: int, a0: int) -> tuple[int, int]:
    return ((a1 << bits) | (a0 >> (64 - bits))) & _M64, (a0 << bits) & _M64


def _mod_reduce(a3: int, a2: int, a1: int, a0: int) -> tuple[int, int]:
    a3 &= 0x3FFFFFFFFFFFFFFF
    a3s1, a2s1 = _shift128(1, a3, a2)
    a3s2, a2s2 = _shift128(2, a3, a2)
    return a1 ^ a3s1 ^ a3s2, a0 ^ a2s1 ^ a2s2


def highwayhash256_py(key32: bytes, data: bytes) -> bytes:
    data = bytes(data)
    h = _HH(key32)
    n = len(data)
    i = 0
    while i + 32 <= n:
        h.update_packet(data[i:i + 32])
        i += 32
    if n & 31:
        h.update_remainder(data[i:])
    return h.finalize256()


# --- XXH64 ------------------------------------------------------------------

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _M64


def _xround(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _xmerge(acc: int, val: int) -> int:
    acc ^= _xround(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64_py(data: bytes, seed: int) -> int:
    """XXH64 of `data` under `seed`, as an integer."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64,
             (seed - _P1) & _M64]
        while p + 32 <= n:
            for i in range(4):
                v[i] = _xround(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8],
                                                    "little"))
            p += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12)
             + _rotl(v[3], 18)) & _M64
        for i in range(4):
            h = _xmerge(h, v[i])
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _xround(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h
