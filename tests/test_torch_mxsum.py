"""mxsum256 and the codec compositions of the port (minio_tpu_torch/ops/
mxsum.py and fused.py, plain PyTorch on the CPU) against the JAX package's
mxsum and fused launches on the same seeded inputs. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import fused as jfused
from minio_tpu.ops import mxsum as jmx
from minio_tpu.ops import rs_pallas
from minio_tpu_torch.ops import fused, mxsum

CPU = torch.device("cpu")


def test_key_stream_byte_identical_across_chunk_boundary():
    n = (1 << 16) + 777          # crosses the 65,536-row PCG64 chunk
    assert np.array_equal(mxsum._key_rows(n), jmx._key_rows(n))
    assert np.array_equal(mxsum._len_key(), jmx._len_key())


def test_device_key_is_a_prefix_of_the_stream():
    short = mxsum.device_key(10, CPU).numpy()
    long = mxsum.device_key(70000, CPU).numpy()
    assert np.array_equal(short, mxsum._key_rows(10).T)
    assert np.array_equal(long, jmx._key_rows(70000).T)
    again = mxsum.device_key(10, CPU)
    assert again.stride() == (mxsum._dev_key[CPU].shape[1], 1)
    assert again.stride(0) % mxsum.KEY_ALIGN == 0
    assert np.array_equal(again.numpy(), jmx._key_rows(10).T)


@pytest.mark.parametrize("s,have,want", [
    (0, 0, 64), (1, 0, 64), (64, 0, 64), (65, 0, 128), (131072, 0, 131072),
    (10, 64, 64), (64, 64, 64), (65, 64, 128), (1000, 64, 1024),
    (87382, 131072, 131072), (131073, 131072, 262144), (600000, 131072, 600000),
])
def test_key_capacity_grows_by_doubling_in_aligned_steps(s, have, want):
    assert mxsum.key_capacity(s, have) == want


@pytest.mark.parametrize("a,b", [(1, 64), (513, 70000), (65536, 65537 + 64)])
def test_transposed_key_is_prefix_stable_and_matches_jax(a, b):
    short, long = mxsum.transposed_key(a), mxsum.transposed_key(b)
    assert short.shape == (8, a) and short.flags.c_contiguous
    assert np.array_equal(long[:, :a], short)
    assert np.array_equal(long, jmx._key_rows(b).T)


@pytest.mark.parametrize("s", [0, 1, 511, 513, 65537])
def test_digest_matches_jax(s):
    data = np.random.default_rng(s).integers(0, 256, s, dtype=np.uint8)
    cap = max(s, 1)
    padded = np.zeros((1, cap), dtype=np.uint8)
    padded[0, :s] = data
    lens = np.array([s], dtype=np.int32)
    got = mxsum.digest(torch.from_numpy(padded), torch.from_numpy(lens)).numpy()
    want = np.asarray(jmx.digest_device(jnp.asarray(padded), jnp.asarray(lens)))
    assert got.tobytes() == want.tobytes()
    assert got[0].tobytes() == jmx.digest_np(data.tobytes())
    assert mxsum.digest_np(data.tobytes()) == jmx.digest_np(data.tobytes())


def test_digest_cap_independent():
    data = np.random.default_rng(1).integers(0, 256, 1000, dtype=np.uint8)
    base = jmx.digest_np(data.tobytes())
    for cap in (1000, 1001, 1024, 4096):
        padded = np.zeros((2, cap), dtype=np.uint8)
        padded[0, :1000] = data
        lens = torch.tensor([1000, 0], dtype=torch.int32)
        got = mxsum.digest(torch.from_numpy(padded), lens).numpy()
        assert got[0].tobytes() == base, cap
        assert got[1].tobytes() == jmx.digest_np(b""), cap


@pytest.mark.parametrize("k,m,s", [(4, 2, 700), (8, 4, 1024)])
def test_encode_compositions_match_jax(k, m, s):
    rng = np.random.default_rng(k + s)
    data = rng.integers(0, 256, (3, k, s), dtype=np.uint8)
    lens = np.array([s, s // 2, 1], dtype=np.int32)
    for b, ln in enumerate(lens):          # zero past each chunk's length
        data[b, :, ln:] = 0
    par, digs = fused.encode_with_digests(torch.from_numpy(data), k, m,
                                          torch.from_numpy(lens))
    jpar, jdigs = jfused.encode_with_digests(jnp.asarray(data), k, m,
                                             jnp.asarray(lens))
    assert np.array_equal(par.numpy(), np.asarray(jpar))
    assert np.array_equal(digs.numpy(), np.asarray(jdigs))
    only = fused.encode_only(torch.from_numpy(data), k, m).numpy()
    assert np.array_equal(only, np.asarray(jfused.encode_only(jnp.asarray(data), k, m)))


def test_reconstruct_weights_digests_matches_jax():
    k, n, s = 8, 12, 900
    surv, targets = (0, 1, 2, 3, 6, 7, 9, 11), (4, 5, 8, 10)
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, (2, k, s), dtype=np.uint8)
    lens = np.array([s, 300], dtype=np.int32)
    x[1, :, 300:] = 0
    w_t = rs_pallas._decode_weights_t(k, n, surv, targets)
    for with_digests in (True, False):
        got, gd = fused.reconstruct_weights_digests(
            torch.from_numpy(x), torch.from_numpy(w_t), torch.from_numpy(lens),
            len(targets), with_digests=with_digests)
        want, wd = jfused.reconstruct_weights_digests(
            jnp.asarray(x), jnp.asarray(w_t), jnp.asarray(lens), len(targets),
            with_digests=with_digests)
        assert np.array_equal(got.numpy(), np.asarray(want))
        if with_digests:
            assert np.array_equal(gd.numpy(), np.asarray(wd))
        else:
            assert gd is None and wd is None


@pytest.mark.parametrize("surv,targets", [
    ((0, 1, 2, 3, 6, 7, 9, 11), (4, 5, 8, 10)),     # 4 missing, the S3 shape
    ((0, 1, 2, 3, 4, 6, 7, 8), (5,)),                # a one-drive heal
])
def test_static_pattern_reconstructs_match_jax(surv, targets):
    """fused.reconstruct_with_digests / reconstruct_only and their plain
    versions against the JAX functions of the same names."""
    k, n, s = 8, 12, 700
    rng = np.random.default_rng(len(targets))
    shards = rng.integers(0, 256, (3, n, s), dtype=np.uint8)
    lens = np.array([s, 350, 1], dtype=np.int32)
    for b, ln in enumerate(lens):
        shards[b, :, ln:] = 0
    got, gd = fused.reconstruct_with_digests(torch.from_numpy(shards), k, n,
                                             surv, targets, torch.from_numpy(lens))
    want, wd = jfused.reconstruct_with_digests(jnp.asarray(shards), k, n, surv,
                                               targets, jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(gd.numpy(), np.asarray(wd))
    pg, pd = fused.reconstruct_with_digests_plain(torch.from_numpy(shards), k, n,
                                                  surv, targets, torch.from_numpy(lens))
    assert np.array_equal(pg.numpy(), got.numpy())
    assert np.array_equal(pd.numpy(), gd.numpy())
    only = fused.reconstruct_only(torch.from_numpy(shards), k, n, surv, targets)
    jonly = jfused.reconstruct_only(jnp.asarray(shards), k, n, surv, targets)
    assert np.array_equal(only.numpy(), np.asarray(jonly))
    assert np.array_equal(fused.reconstruct_only_plain(
        torch.from_numpy(shards), k, n, surv, targets).numpy(), only.numpy())


def test_verify_and_host_batch_match_jax():
    rng = np.random.default_rng(4)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (0, 1, 100, 512, 513, 2048)]
    assert fused.digest_chunks_host(chunks, 2048, CPU) == \
        jfused.digest_chunks_host(chunks, 2048)
    batch = np.zeros((4, 600), dtype=np.uint8)
    batch[0, :600] = rng.integers(0, 256, 600, dtype=np.uint8)
    lens = np.array([600, 0, 0, 0], dtype=np.int32)
    got = fused.verify_digests(torch.from_numpy(batch), torch.from_numpy(lens))
    want = jfused.verify_digests(jnp.asarray(batch), jnp.asarray(lens))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_staging_buckets_match_jax():
    for b in (1, 2, 3, 16, 17):
        assert fused.bucket_rows(b) == jfused.bucket_rows(b)
    for s in (1, 511, 512, 513, 131072, 131073):
        assert fused.bucket_width(s) == jfused.bucket_width(s)
