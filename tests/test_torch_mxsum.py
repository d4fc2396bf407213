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
    assert np.array_equal(short, mxsum._key_rows(10))
    assert np.array_equal(long, jmx._key_rows(70000))


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
