"""mxhash256 of the port (minio_tpu_torch/ops/mxhash.py, K3's plain
versions on the CPU) against the JAX package's minio_tpu/ops/mxhash.py, on
the same seeded numpy inputs: ragged lengths in one batch, the split form
(every block's data term, then a tree of SK powers), digest_host,
encode_with_bitrot, the codec's mxhash256 encode and rebuild; K3's key
layout and combine algebra emulated in numpy; and the digest keys of
mxsum256 and mxhash256 and the table of SK powers pinned by SHA-256.
Tolerance: exact bytes (integer work)."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import mxhash as jmxhash
from minio_tpu.ops import mxsum as jmxsum
from minio_tpu_torch.erasure.codec import ErasureCodec
from minio_tpu_torch.ops import kernels, mxhash, mxsum

# Ragged lengths across the padding edges: 503 + 9 = 512 fits one block,
# 504 + 9 = 513 needs two.
LENS = [0, 1, 503, 504, 512, 700, 4096, 87_382, 131_072]


def _jax_digest(row: np.ndarray) -> bytes:
    return bytes(np.asarray(jmxhash.mxhash256(jnp.asarray(row[None, :]), row.size))[0])


def test_ragged_batch_equals_jax_per_length():
    rng = np.random.default_rng(9)
    s = max(LENS)
    x = rng.integers(0, 256, (len(LENS), s), dtype=np.uint8)
    got = mxhash.mxhash256(torch.from_numpy(x),
                           torch.tensor(LENS, dtype=torch.int32)).numpy()
    for i, ln in enumerate(LENS):
        assert got[i].tobytes() == _jax_digest(x[i, :ln]), ln


@pytest.mark.parametrize("ln", [0, 1, 503, 504, 512, 700, 4096])
def test_digest_host_equals_jax(ln):
    data = np.random.default_rng(ln).integers(0, 256, ln, dtype=np.uint8).tobytes()
    assert mxhash.digest_host(data) == jmxhash.digest_host(data)
    assert mxhash.MXHash256.digest(memoryview(data)) == jmxhash.MXHash256.digest(data)


def test_bytes_past_the_length_and_strided_rows_are_ignored():
    """A row's digest depends on its first lens[r] bytes only, whatever the
    staging width and the row stride."""
    rng = np.random.default_rng(3)
    wide = torch.from_numpy(rng.integers(0, 256, (6, 3000), dtype=np.uint8))
    view = wide[:, 7:2100]                       # rows of stride 3000
    lens = torch.tensor([0, 5, 503, 504, 1500, 2093], dtype=torch.int32)
    got = mxhash.mxhash256(view, lens)
    for i in range(6):
        ln = int(lens[i])
        tight = view[i:i + 1, :ln].contiguous()
        assert torch.equal(got[i], mxhash.mxhash256(tight, lens[i:i + 1])[0])
        assert got[i].numpy().tobytes() == _jax_digest(view[i, :ln].numpy())


def test_encode_with_bitrot_equals_jax():
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, (2, 8, 4096), dtype=np.uint8)
    par, digs = mxhash.encode_with_bitrot(torch.from_numpy(data), 8, 4)
    jpar, jdigs = jmxhash.encode_with_bitrot(jnp.asarray(data), 8, 4)
    assert np.array_equal(par.numpy(), np.asarray(jpar))
    assert np.array_equal(digs.numpy(), np.asarray(jdigs))


def test_codec_mxhash_encode_and_rebuild_equal_jax_digests():
    """The codec's mxhash256 batch (K1 then K3 on the card) over ragged
    blocks: every shard chunk's digest is the JAX digest_host of it, and a
    rebuild with algorithm mxhash256 digests the rebuilt chunks alike."""
    k, m, bs = 8, 4, 1 << 13
    rng = np.random.default_rng(5)
    blocks = [rng.bytes(n) for n in (bs, bs, 4000, 17)]
    codec = ErasureCodec(k, m, bs, device="cpu")
    chunks, digs = codec.begin_encode(blocks, "mxhash256").wait()
    for row, drow in zip(chunks, digs):
        for c, d in zip(row, drow):
            assert d == jmxhash.digest_host(bytes(c))
    none_chunks, none_digs = codec.begin_encode(blocks, None).wait()
    assert none_digs is None
    assert [[bytes(c) for c in r] for r in none_chunks] == \
        [[bytes(c) for c in r] for r in chunks]
    targets = (0, 5, 9)
    rows = [[None if i in targets else bytes(c) for i, c in enumerate(r)]
            for r in chunks]
    rebuilt, rdigs = codec.begin_reconstruct(rows, [len(b) for b in blocks],
                                             targets, "mxhash256").wait()
    for bi, r in enumerate(chunks):
        for ti, pos in enumerate(targets):
            assert rebuilt[bi][ti] == bytes(r[pos])
            assert rdigs[bi][ti] == digs[bi][pos]


def test_packed_key_is_the_key_matrix():
    """K3's key, read back as the tensor cores read it: slice s, k-step ks
    of the 128-byte-swizzled B tiles times the A operand built from a
    group's bytes as K3 builds it ((word >> b) & 0x01010101), summed over
    every slice and k-step, is each group's term
    XOR_v (block v bits @ DK SK^(3 - v)) mod 2, and the stacked keys are
    DK SK^v."""
    gb = mxhash.GROUP_BLOCKS
    key = mxhash.tile_key()
    assert key.shape == (8 * gb, 4, 256, 128) and key.dtype == np.uint8
    keys = mxhash.group_keys()
    sk = mxhash._key_matrix()[:mxhash.STATE_BITS].astype(np.int64)
    dk = mxhash._key_matrix()[mxhash.STATE_BITS:].astype(np.int64)
    for v in range(gb):
        assert np.array_equal(keys[v], dk @ np.linalg.matrix_power(sk, v) % 2)
    grp = np.random.default_rng(8).integers(0, 256, (64, 512 * gb), dtype=np.uint8)
    want = np.zeros((64, 256), np.int64)
    for v in range(gb):
        bits = np.unpackbits(grp[:, 512 * v:512 * (v + 1)], axis=1, bitorder="little")
        want ^= (bits.astype(np.int64) @ keys[gb - 1 - v].astype(np.int64)) & 1
    n, kk = np.arange(256)[:, None], np.arange(128)[None, :]
    pos = 16 * ((kk // 16) ^ (n % 8)) + kk % 16
    got = np.zeros((64, 256), np.int64)
    for s in range(8 * gb):
        acc = np.zeros((64, 256), np.int64)
        base = 512 * (s // 8) + 64 * (s % 8)
        for ks in range(16):
            b_tile = np.take_along_axis(key[s, ks // 4], pos, axis=1)   # [n, 128]
            b_step = b_tile[:, 32 * (ks % 4):32 * (ks % 4) + 32]        # [n, k]
            raw = grp[:, base + 4 * ks:base + 4 * ks + 4]               # [row, e]
            a_step = np.stack([(raw >> b) & 1 for b in range(8)], 1).reshape(64, 32)
            acc += a_step.astype(np.int64) @ b_step.T.astype(np.int64)
        got ^= acc & 1
    assert np.array_equal(got, want)


def _power_np(e: int) -> np.ndarray:
    sk = mxhash._key_matrix()[:mxhash.STATE_BITS].astype(np.int64)
    p, b = np.eye(mxhash.STATE_BITS, dtype=np.int64), sk
    while e:
        if e & 1:
            p = p @ b % 2
        b = b @ b % 2
        e >>= 1
    return p


def test_sk_powers_are_squarings_and_pinned():
    """Each SK^(2^l) of the table is l squarings of SK over GF(2), the table
    matches its pinned SHA-256, and K3's combine columns are
    SK^(4 * 2^l), l < 9, bit p of word q of column c = P[32 q + p, c]."""
    table = mxhash.sk_powers()
    assert table.shape == (mxhash.POWER_LEVELS, 256, 256) and table.dtype == np.uint8
    assert hashlib.sha256(table.tobytes()).hexdigest() == mxhash.POWERS_SHA256
    p = mxhash._key_matrix()[:mxhash.STATE_BITS].astype(np.int64)
    for level in range(mxhash.POWER_LEVELS):
        assert np.array_equal(table[level], p), level
        p = p @ p % 2
    cols = mxhash.combine_columns()
    assert cols.shape == (mxhash.POWER_LEVELS, 256, 8) and cols.dtype == np.uint32
    for level in range(mxhash.POWER_LEVELS):
        bits = np.unpackbits(cols[level].view(np.uint8).reshape(256, 32), axis=1,
                             bitorder="little")                         # [c, p]
        assert np.array_equal(bits.T, _power_np(mxhash.GROUP_BLOCKS << level)), level


@pytest.mark.parametrize("seed,pad", [(21, 0), (22, 5), (23, 16)])
def test_split_plain_equals_jax_and_the_chain(seed, pad):
    """mxhash256_split_plain (every block's data term as one product, then
    the tree with SK^(2^l)) over one ragged batch of rows `pad` bytes wider
    than the longest (strided rows): byte-equal to the chain and, row by
    row, to the JAX mxhash256."""
    s = max(LENS)
    wide = np.random.default_rng(seed).integers(0, 256, (len(LENS), s + pad), dtype=np.uint8)
    view = torch.from_numpy(wide)[:, pad:]
    lens = torch.tensor(LENS, dtype=torch.int32)
    got = mxhash.mxhash256_split_plain(view, lens)
    assert torch.equal(got, mxhash.mxhash256_plain(view, lens))
    for i, ln in enumerate(LENS):
        assert got[i].numpy().tobytes() == _jax_digest(wide[i, pad:pad + ln]), ln


def test_group_terms_and_windowed_combine_equal_the_chain():
    """K3's algebra: the terms T_g = XOR_v (block bits @ DK SK^(3 - v)) of
    4-block groups counted from a row's end (zero blocks in front of the
    first), folded in windows of 256 terms by levels with K3's combine
    powers SK^(4 * 2^l) and the windows joined by Horner with SK^1024, give
    the chain's digest, here for rows of 1 to 1,201 blocks (over 256
    terms: two windows)."""
    lens = [0, 503, 2039, 2040, 20000, 1201 * 512 - 9]
    x = np.random.default_rng(31).integers(0, 256, (len(lens), max(lens)), dtype=np.uint8)
    tl = torch.tensor(lens, dtype=torch.int32)
    want = mxhash.mxhash256_plain(torch.from_numpy(x), tl).numpy()
    msg, nb = mxhash._padded_messages(torch.from_numpy(x), tl)
    keys = mxhash.group_keys().astype(np.int64)
    cols = mxhash.combine_columns()
    pw = [np.unpackbits(cols[level].view(np.uint8).reshape(256, 32), axis=1,
                        bitorder="little").T.astype(np.int64) for level in range(9)]
    gb = mxhash.GROUP_BLOCKS
    for r, ln in enumerate(lens):
        nbr = int(nb[r])
        bits = np.unpackbits(msg[r, :nbr * 512].numpy(), bitorder="little").reshape(nbr, 4096)
        terms = []
        for g in range(-(-nbr // gb)):
            t = np.zeros(256, np.int64)
            for v in range(gb):
                blk = nbr - gb * (g + 1) + v
                if blk >= 0:
                    t += bits[blk].astype(np.int64) @ keys[gb - 1 - v]
            terms.append(t % 2)
        acc = None
        for k in reversed(range(0, len(terms), 256)):
            e = terms[k:k + 256]
            level = 0
            while len(e) > 1:
                e = [(e[2 * j] + (e[2 * j + 1] @ pw[level] if 2 * j + 1 < len(e) else 0)) % 2
                     for j in range((len(e) + 1) // 2)]
                level += 1
            acc = e[0] if acc is None else (acc @ pw[8] + e[0]) % 2
        got = np.packbits(acc.astype(np.uint8), bitorder="little")
        assert got.tobytes() == want[r].tobytes(), ln


def test_keys_pinned_to_the_jax_packages():
    """The pinned SHA-256 constants are those of the JAX package's keys,
    and the port derives the same keys."""
    jkey = jmxhash._key_matrix()
    assert hashlib.sha256(jkey.tobytes()).hexdigest() == mxhash.KEY_SHA256
    assert np.array_equal(mxhash._key_matrix(), jkey)
    k0 = jmxsum._key_rows(mxsum._KEY_CHUNK)
    assert hashlib.sha256(k0.tobytes()).hexdigest() == mxsum.KEY_SHA256
    assert hashlib.sha256(jmxsum._len_key().tobytes()).hexdigest() == \
        mxsum.LEN_KEY_SHA256
    assert np.array_equal(mxsum._key_rows(mxsum._KEY_CHUNK), k0)


def test_a_key_that_differs_raises(monkeypatch):
    """A numpy whose stream gives another key makes key derivation raise
    (simulated: a generator whose integers are all ones)."""

    class _Ones:
        def __init__(self, *_a):
            pass

        def integers(self, lo, hi, shape, dtype):
            return np.ones(shape, dtype=dtype)

    with pytest.raises(mxsum.KeyMismatch):
        mxsum.check_key("k", np.zeros(4, np.uint8), mxsum.KEY_SHA256)
    monkeypatch.setattr(mxhash.np.random, "Generator", _Ones)
    monkeypatch.setattr(mxhash, "_gf2_rank", lambda m: mxhash.STATE_BITS)
    mxhash._key_matrix.cache_clear()
    try:
        with pytest.raises(mxsum.KeyMismatch):
            mxhash._key_matrix()
    finally:
        monkeypatch.undo()
        mxhash._key_matrix.cache_clear()
    assert hashlib.sha256(mxhash._key_matrix().tobytes()).hexdigest() == mxhash.KEY_SHA256


def test_non_cpu_tensor_never_falls_back(monkeypatch):
    """With no kernel library a tensor not on the CPU raises (a meta tensor
    stands in for a CUDA one); K3's launch count does not move."""
    def no_nvcc():
        raise kernels.KernelBuildError("nvcc not found")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "_digest", lambda: "missing-for-test")
    before = kernels.launches()["mxhash256"]
    with pytest.raises(kernels.KernelBuildError):
        mxhash.mxhash256(torch.empty((3, 64), dtype=torch.uint8, device="meta"),
                         torch.empty(3, dtype=torch.int32, device="meta"))
    with pytest.raises(kernels.KernelBuildError):
        mxhash.encode_with_bitrot(torch.empty((2, 8, 64), dtype=torch.uint8,
                                              device="meta"), 8, 4)
    assert kernels.launches()["mxhash256"] == before
    assert "mxhash256.cu" in kernels.SOURCES and "mxhash256" in kernels.KERNELS
