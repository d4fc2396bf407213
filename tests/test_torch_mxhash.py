"""mxhash256 of the port (minio_tpu_torch/ops/mxhash.py, K3's plain
version on the CPU) against the JAX package's minio_tpu/ops/mxhash.py, on
the same seeded numpy inputs: ragged lengths in one batch, digest_host,
encode_with_bitrot, the codec's mxhash256 encode and rebuild; and the
digest keys of mxsum256 and mxhash256 pinned by SHA-256 against the JAX
package's keys. Tolerance: exact bytes (integer work)."""

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
    """K3's key layout: bit p of word w of column c is K[64w + p, c]."""
    key = mxhash._key_matrix()
    packed = mxhash.packed_key()
    assert packed.shape == (mxhash.KEY_WORDS, 256) and packed.dtype == np.uint64
    bits = ((packed[:, :, None] >> np.arange(64, dtype=np.uint64)) & 1).astype(np.uint8)
    assert np.array_equal(bits.transpose(0, 2, 1).reshape(-1, 256), key)


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
