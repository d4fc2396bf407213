"""GF(2^8) arithmetic, Reed-Solomon matrices, and the bit-matrix transform.

This is the host-side (numpy) foundation of the erasure codec. The reference
wraps klauspost/reedsolomon (cmd/erasure-coding.go:23,56), whose hot loops are
AVX2/AVX512 Galois multiply tables. On TPU there is no per-byte table-lookup
SIMD, so we use a different — and MXU-friendly — formulation:

    GF(2^8) is an 8-dimensional vector space over GF(2). Multiplication by a
    *constant* c is a linear map, i.e. an 8x8 bit-matrix B_c. A Reed-Solomon
    encode  parity[j] = XOR_i  M[j,i] * data[i]  therefore becomes one big
    GF(2) matrix product:

        out_bits[S, m*8] = in_bits[S, k*8] @ W[k*8, m*8]   (mod 2)

    with S = byte positions in a shard. Bits are materialized as {0,1}
    integers, the contraction runs on the MXU (bf16/int8 matmul is exact for
    sums < 2^8), and "mod 2" is a cheap elementwise epilogue. This mirrors
    what Intel GFNI (gf2p8affineqb) does in hardware, and is how the codec
    reaches matmul-unit throughput instead of gather throughput.

Everything in this file is pure numpy and runs at setup time (matrix
construction, inversion, bit-expansion) or in tests (bit-exact reference
encode). The device kernels live in rs.py (plain torch contraction) and
csrc/gf2_matmul.cu (the hand-written CUDA kernel).

This module is a copy of minio_tpu/ops/gf.py: the port imports nothing from
the JAX package, and tests/test_torch_gf.py holds the two byte-equal.

Field: the standard Reed-Solomon GF(2^8) with reducing polynomial
x^8+x^4+x^3+x^2+1 (0x11D), generator 2 — same field as klauspost/reedsolomon,
so encodings are interoperable at the math level.
"""

from __future__ import annotations

import functools

import numpy as np

GF_POLY = 0x11D  # x^8 + x^4 + x^3 + x^2 + 1
FIELD_SIZE = 256


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


@functools.lru_cache(maxsize=1)
def mul_table() -> np.ndarray:
    """Full 256x256 GF(2^8) multiplication table (64 KiB)."""
    a = np.arange(256)
    t = np.zeros((256, 256), dtype=np.uint8)
    la = GF_LOG[a[1:, None]]
    lb = GF_LOG[a[None, 1:]]
    t[1:, 1:] = GF_EXP[(la + lb) % 255]
    t.setflags(write=False)
    return t


def gf_mul(a, b):
    """Elementwise GF(2^8) multiply (numpy, any broadcastable shapes)."""
    return mul_table()[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8); 0**0 == 1 (matches klauspost galExp)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % 255])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of 0")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by 0")
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) - int(GF_LOG[b])) % 255])


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): (mul = table, add = xor)."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    # products[i, j, l] = a[i, l] * b[l, j]
    prod = mul_table()[a[:, None, :], b.T[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=2)


def gf_mat_inv(m: np.ndarray) -> np.ndarray:
    """Invert a square matrix over GF(2^8) by Gauss-Jordan elimination.

    Raises ValueError if singular (caller treats that as "too many shards
    lost" — the reference returns reedsolomon.ErrTooFewShards).
    """
    m = np.asarray(m, dtype=np.uint8)
    n = m.shape[0]
    if m.shape != (n, n):
        raise ValueError(f"not square: {m.shape}")
    aug = np.concatenate([m.copy(), np.eye(n, dtype=np.uint8)], axis=1)
    mt = mul_table()
    for col in range(n):
        pivot = -1
        for row in range(col, n):
            if aug[row, col]:
                pivot = row
                break
        if pivot < 0:
            raise ValueError("singular matrix over GF(2^8)")
        if pivot != col:
            aug[[col, pivot]] = aug[[pivot, col]]
        inv_p = gf_inv(int(aug[col, col]))
        aug[col] = mt[aug[col], inv_p]
        mask = aug[:, col].copy()
        mask[col] = 0
        # row_i ^= mask_i * row_col  (no-op where mask_i == 0)
        aug ^= mt[mask[:, None], aug[col][None, :]]
    return aug[:, n:]


# ---------------------------------------------------------------------------
# Reed-Solomon generator matrices
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def rs_generator_matrix(k: int, n: int) -> np.ndarray:
    """Systematic [n, k] Vandermonde generator matrix.

    Same construction as klauspost/reedsolomon buildMatrix (vendored by the
    reference via cmd/erasure-coding.go:56): take the n x k Vandermonde
    matrix V[r, c] = r**c (element exponent, 0**0 = 1), then right-multiply
    by the inverse of its top k x k block so the first k rows become the
    identity (data shards pass through unchanged, last n-k rows generate
    parity). Any k rows of the result are linearly independent (MDS).
    """
    if not (0 < k <= n <= FIELD_SIZE):
        raise ValueError(f"invalid RS shape k={k} n={n}")
    vm = np.zeros((n, k), dtype=np.uint8)
    for r in range(n):
        for c in range(k):
            vm[r, c] = gf_pow(r, c)
    top_inv = gf_mat_inv(vm[:k])
    g = gf_matmul(vm, top_inv)
    # Systematic by construction.
    assert np.array_equal(g[:k], np.eye(k, dtype=np.uint8))
    g.setflags(write=False)  # cached: callers must not mutate
    return g


def parity_matrix(k: int, m: int) -> np.ndarray:
    """[m, k] parity rows of the systematic generator (fresh copy)."""
    return rs_generator_matrix(k, k + m)[k:].copy()


def decode_matrix(k: int, n: int, survivors: tuple[int, ...], targets: tuple[int, ...]) -> np.ndarray:
    """[len(targets), k] matrix reconstructing `targets` shards from `survivors`.

    survivors: exactly k shard indices (0..n-1) that are intact.
    targets:   shard indices to (re)compute — missing data and/or parity.

    With G the systematic generator, surviving shards s_S = G[S] d, so
    d = inv(G[S]) s_S and s_T = G[T] inv(G[S]) s_S. The reference reaches the
    same math through reedsolomon.ReconstructData (cmd/erasure-coding.go:89).
    There are only C(n, <=m) failure patterns, so callers cache per-pattern
    matrices (this function is lru-cached at the bit-matrix level).
    """
    if len(survivors) != k:
        raise ValueError(f"need exactly k={k} survivors, got {len(survivors)}")
    g = rs_generator_matrix(k, n)
    sub = g[list(survivors)]
    inv = gf_mat_inv(sub)
    return gf_matmul(g[list(targets)], inv)


# ---------------------------------------------------------------------------
# Bit-matrix transform: GF(2^8) matrix -> GF(2) matrix for the MXU
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _const_mul_bitmatrices() -> np.ndarray:
    """[256, 8, 8] bit-matrix of multiply-by-c for every constant c.

    B[c, j, i] = bit j of (c * x^i): column i is the GF(2^8) product of c
    with the basis element x^i, decomposed into bits.
    """
    c = np.arange(256, dtype=np.uint8)
    basis = (1 << np.arange(8)).astype(np.uint8)          # x^i
    prod = mul_table()[c[:, None], basis[None, :]]         # [256, 8] : c * x^i
    bits = (prod[:, None, :] >> np.arange(8)[None, :, None]) & 1  # [256, j, i]
    bits = bits.astype(np.uint8)
    bits.setflags(write=False)
    return bits


def expand_to_bitmatrix(m: np.ndarray) -> np.ndarray:
    """Lift a GF(2^8) matrix [r, c] to a GF(2) matrix [c*8, r*8].

    Returned layout is (input_bits, output_bits), ready for
    out_bits[S, r*8] = in_bits[S, c*8] @ W (mod 2): W[ci*8 + bi, ro*8 + bo]
    = B[m[ro, ci]][bo, bi].
    """
    m = np.asarray(m, dtype=np.uint8)
    r, c = m.shape
    b = _const_mul_bitmatrices()[m]          # [r, c, 8(out), 8(in)]
    w = b.transpose(1, 3, 0, 2)              # [c, 8(in), r, 8(out)]
    w = np.ascontiguousarray(w.reshape(c * 8, r * 8))
    w.setflags(write=False)  # lru-cached by encode/decode_bitmatrix
    return w


@functools.lru_cache(maxsize=256)
def encode_bitmatrix(k: int, m: int) -> np.ndarray:
    """[k*8, m*8] GF(2) weights computing all m parity shards at once."""
    return expand_to_bitmatrix(parity_matrix(k, m))


@functools.lru_cache(maxsize=4096)
def decode_bitmatrix(
    k: int, n: int, survivors: tuple[int, ...], targets: tuple[int, ...]
) -> np.ndarray:
    """[k*8, t*8] GF(2) weights reconstructing `targets` from `survivors`."""
    return expand_to_bitmatrix(decode_matrix(k, n, survivors, targets))


# ---------------------------------------------------------------------------
# Bit-exact numpy reference codec (the ground truth for kernel tests)
# ---------------------------------------------------------------------------


def encode_ref(data: np.ndarray, m: int) -> np.ndarray:
    """Reference encode: data [k, S] u8 -> parity [m, S] u8 (table lookups)."""
    data = np.asarray(data, dtype=np.uint8)
    k = data.shape[0]
    pm = parity_matrix(k, m)                               # [m, k]
    prod = mul_table()[pm[:, :, None], data[None, :, :]]   # [m, k, S]
    return np.bitwise_xor.reduce(prod, axis=1)


def reconstruct_ref(
    shards: np.ndarray, k: int, survivors: tuple[int, ...], targets: tuple[int, ...]
) -> np.ndarray:
    """Reference reconstruct: shards [n, S] (rows outside survivors ignored)."""
    shards = np.asarray(shards, dtype=np.uint8)
    n = shards.shape[0]
    dm = decode_matrix(k, n, survivors, targets)           # [t, k]
    surv = shards[list(survivors)]                         # [k, S]
    prod = mul_table()[dm[:, :, None], surv[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)
