"""Plain pure-Python versions of the host library's functions
(csrc/host_hash.cc and csrc/host_codec.cc).

The tests hold the host library against these; no serving path calls
them. `sip256_py` is a copy of the JAX package's `_sip256_py`
(minio_tpu/native/lib.py) and `highwayhash256_py` of its
`highwayhash256_py` (minio_tpu/native/hh_py.py, written from Google's
published portable reference; the byte placements in its length padding
are part of the HighwayHash definition). `xxh64_py` is written from the
published xxHash specification (XXH64). `snappy_compress_py` is the
host library's greedy matcher step for step (so its blocks are the same
bytes), `snappy_uncompress_py` a copy of the JAX package's
`_snappy_uncompress_py`, and `argon2id_py` is written from RFC 9106 over
hashlib's BLAKE2b; the CRC-32C's plain version is utils/crc32c.py.
"""

from __future__ import annotations

import hashlib

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


# --- snappy block codec -----------------------------------------------------

_SNAP_HASH_BITS = 14


def _snap_varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _emit_literal(out: bytearray, lit) -> None:
    n = len(lit) - 1
    if n < 60:
        out.append(n << 2)
    else:
        nb = (n.bit_length() + 7) // 8
        out.append((59 + nb) << 2)
        out += n.to_bytes(nb, "little")
    out += lit


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    while length >= 68:
        out += bytes(((63 << 2) | 2, offset & 0xFF, offset >> 8))
        length -= 64
    if length > 64:
        out += bytes(((59 << 2) | 2, offset & 0xFF, offset >> 8))
        length -= 60
    if length >= 12 or offset >= 2048:
        out += bytes((((length - 1) << 2) | 2, offset & 0xFF, offset >> 8))
    else:
        out += bytes((((offset >> 8) << 5) | ((length - 4) << 2) | 1, offset & 0xFF))


def _compress_fragment(src: bytes, out: bytearray) -> None:
    n = len(src)
    table = [0] * (1 << _SNAP_HASH_BITS)

    def h(i):
        v = int.from_bytes(src[i:i + 4], "little")
        return ((v * 0x1E35A7BD) & 0xFFFFFFFF) >> (32 - _SNAP_HASH_BITS)

    ip = lit = 0
    if n >= 16:
        limit = n - 15
        while ip < limit:
            hv = h(ip)
            cand = table[hv]
            table[hv] = ip
            if cand < ip and src[cand:cand + 4] == src[ip:ip + 4]:
                m, c = ip + 4, cand + 4
                while m < n and src[m] == src[c]:
                    m += 1
                    c += 1
                if lit < ip:
                    _emit_literal(out, src[lit:ip])
                _emit_copy(out, ip - cand, m - ip)
                ip = lit = m
                if ip < limit:
                    table[h(ip - 1)] = ip - 1
            else:
                ip += 1
    if lit < n:
        _emit_literal(out, src[lit:])


def snappy_compress_py(data) -> bytes:
    """One snappy block: the varint length, then the greedy matcher over
    each 64 KiB fragment (a fresh hash table per fragment)."""
    data = bytes(data)
    out = bytearray(_snap_varint(len(data)))
    for pos in range(0, len(data), 1 << 16):
        _compress_fragment(data[pos:pos + (1 << 16)], out)
    return bytes(out)


def snappy_uncompress_py(data, max_len: int = 1 << 26) -> bytes:
    """Decode one snappy block; ValueError on a malformed one."""
    data = bytes(data)
    i = ulen = shift = 0
    while True:
        if i >= len(data) or shift >= 35:
            raise ValueError("corrupt snappy block (bad length header)")
        b = data[i]
        i += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    if ulen > max_len:
        raise ValueError("corrupt snappy block (bad length header)")
    out = bytearray()
    n = len(data)
    while i < n:
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            l6 = tag >> 2
            if l6 < 60:
                length = l6 + 1
            else:
                nb = l6 - 59
                if i + nb > n:
                    raise ValueError("corrupt snappy literal")
                length = int.from_bytes(data[i:i + nb], "little") + 1
                i += nb
            if i + length > n or len(out) + length > ulen:
                raise ValueError("corrupt snappy literal")
            out += data[i:i + length]
            i += length
            continue
        if kind == 1:
            if i >= n:
                raise ValueError("corrupt snappy copy")
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[i]
            i += 1
        elif kind == 2:
            if i + 2 > n:
                raise ValueError("corrupt snappy copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i:i + 2], "little")
            i += 2
        else:
            if i + 4 > n:
                raise ValueError("corrupt snappy copy")
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[i:i + 4], "little")
            i += 4
        if offset == 0 or offset > len(out) or len(out) + length > ulen:
            raise ValueError("corrupt snappy copy")
        if offset >= length:
            start = len(out) - offset
            out += out[start:start + length]
        else:
            for _ in range(length):
                out.append(out[-offset])
    if len(out) != ulen:
        raise ValueError("snappy length mismatch")
    return bytes(out)


# --- Argon2id (RFC 9106) -----------------------------------------------------


def _b2b(data: bytes, outlen: int) -> bytes:
    return hashlib.blake2b(data, digest_size=outlen).digest()


def _hprime(data: bytes, outlen: int) -> bytes:
    """H' (RFC 9106 3.3), the variable-length hash."""
    pre = outlen.to_bytes(4, "little") + data
    if outlen <= 64:
        return _b2b(pre, outlen)
    r = (outlen + 31) // 32 - 2
    v = _b2b(pre, 64)
    out = bytearray(v[:32])
    for _ in range(1, r):
        v = _b2b(v, 64)
        out += v[:32]
    out += _b2b(v, outlen - 32 * r)
    return bytes(out)


def _gb(v, a, b, c, d):
    def f(x, y):
        return (x + y + 2 * (x & _M32) * (y & _M32)) & _M64

    def rotr(x, n):
        return ((x >> n) | (x << (64 - n))) & _M64

    v[a] = f(v[a], v[b])
    v[d] = rotr(v[d] ^ v[a], 32)
    v[c] = f(v[c], v[d])
    v[b] = rotr(v[b] ^ v[c], 24)
    v[a] = f(v[a], v[b])
    v[d] = rotr(v[d] ^ v[a], 16)
    v[c] = f(v[c], v[d])
    v[b] = rotr(v[b] ^ v[c], 63)


def _p_round(v, idx) -> None:
    """The permutation P over the 16 words v[idx[0..15]]."""
    _gb(v, idx[0], idx[4], idx[8], idx[12])
    _gb(v, idx[1], idx[5], idx[9], idx[13])
    _gb(v, idx[2], idx[6], idx[10], idx[14])
    _gb(v, idx[3], idx[7], idx[11], idx[15])
    _gb(v, idx[0], idx[5], idx[10], idx[15])
    _gb(v, idx[1], idx[6], idx[11], idx[12])
    _gb(v, idx[2], idx[7], idx[8], idx[13])
    _gb(v, idx[3], idx[4], idx[9], idx[14])


_ROWS = [list(range(16 * i, 16 * i + 16)) for i in range(8)]
_COLS = [[2 * i + 16 * r + j for r in range(8) for j in (0, 1)] for i in range(8)]


def _compress_g(x: list[int], y: list[int]) -> list[int]:
    """G(X, Y) = P(X ^ Y) ^ (X ^ Y), P over the rows, then the columns."""
    r = [a ^ b for a, b in zip(x, y)]
    z = list(r)
    for idx in _ROWS:
        _p_round(z, idx)
    for idx in _COLS:
        _p_round(z, idx)
    return [a ^ b for a, b in zip(r, z)]


def _words(raw: bytes) -> list[int]:
    return [int.from_bytes(raw[8 * i:8 * i + 8], "little") for i in range(128)]


def argon2id_py(password: bytes, salt: bytes, *, t: int = 1, m_kib: int = 65536,
                lanes: int = 4, outlen: int = 32, secret: bytes = b"",
                ad: bytes = b"") -> bytes:
    """Argon2id, version 0x13, as RFC 9106 defines it."""
    m = max(m_kib, 8 * lanes)
    q = (m // (4 * lanes)) * 4
    seg = q // 4
    mp = q * lanes

    def le(n):
        return n.to_bytes(4, "little")

    h0 = _b2b(le(lanes) + le(outlen) + le(m_kib) + le(t) + le(0x13) + le(2)
              + le(len(password)) + password + le(len(salt)) + salt
              + le(len(secret)) + secret + le(len(ad)) + ad, 64)
    blocks: list[list[int] | None] = [None] * mp
    for lane in range(lanes):
        for i in range(2):
            blocks[lane * q + i] = _words(_hprime(h0 + le(i) + le(lane), 1024))
    zero = [0] * 128
    for ps in range(t):
        for sl in range(4):
            for lane in range(lanes):
                data_independent = ps == 0 and sl < 2
                addresses: list[int] = []
                counter = 0

                def next_addresses():
                    nonlocal counter
                    counter += 1
                    inp = [ps, lane, sl, mp, t, 2, counter] + [0] * 121
                    return _compress_g(zero, _compress_g(zero, inp))

                start = 2 if ps == 0 and sl == 0 else 0
                for i in range(start, seg):
                    col = sl * seg + i
                    cur = lane * q + col
                    prev = lane * q + q - 1 if col == 0 else cur - 1
                    if data_independent:
                        if i % 128 == 0 or not addresses:
                            addresses = next_addresses()
                        rand = addresses[i % 128]
                    else:
                        rand = blocks[prev][0]
                    j1 = rand & _M32
                    ref_lane = lane if ps == 0 and sl == 0 else (rand >> 32) % lanes
                    same = ref_lane == lane
                    if ps == 0:
                        if sl == 0:
                            area = i - 1
                        elif same:
                            area = sl * seg + i - 1
                        else:
                            area = sl * seg - (1 if i == 0 else 0)
                    elif same:
                        area = q - seg + i - 1
                    else:
                        area = q - seg - (1 if i == 0 else 0)
                    x = (j1 * j1) >> 32
                    y = (area * x) >> 32
                    rel = area - 1 - y
                    start_pos = 0 if ps == 0 else ((sl + 1) % 4) * seg
                    ref = ref_lane * q + (start_pos + rel) % q
                    new = _compress_g(blocks[prev], blocks[ref])
                    if ps > 0:
                        new = [a ^ b for a, b in zip(new, blocks[cur])]
                    blocks[cur] = new
    final = blocks[q - 1]
    for lane in range(1, lanes):
        final = [a ^ b for a, b in zip(final, blocks[lane * q + q - 1])]
    return _hprime(b"".join(w.to_bytes(8, "little") for w in final), outlen)
