"""The port's Reed-Solomon contraction (minio_tpu_torch/ops/rs.py, plain
PyTorch on the CPU) against the JAX package: rs_xla, rs_pallas in
interpreter mode, and the numpy reference codec. Same seeded numpy inputs
into both; tolerance: exact (GF(2) integer math)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minio_tpu.ops import gf as jgf
from minio_tpu.ops import rs_pallas, rs_xla
from minio_tpu_torch.ops import rs



def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("k,m,s", [(4, 2, 1), (4, 2, 1000), (8, 4, 512),
                                   (8, 4, 3001), (12, 4, 64)])
def test_encode_matches_rs_xla_and_reference(k, m, s):
    data = _data((3, k, s), k * 1000 + s)
    got = rs.encode(torch.from_numpy(data), k, m).numpy()
    want = np.asarray(rs_xla.encode(jnp.asarray(data), k, m))
    assert np.array_equal(got, want)
    for b in range(3):
        assert np.array_equal(got[b], jgf.encode_ref(data[b], m))


@pytest.mark.parametrize("k,m", [(4, 2), (8, 4)])
def test_encode_matches_rs_pallas_interpret(k, m):
    data = _data((2, k, 1024), 5)
    want = np.asarray(rs_pallas.encode(jnp.asarray(data), k, m, interpret=True))
    assert np.array_equal(rs.encode(torch.from_numpy(data), k, m).numpy(), want)


@pytest.mark.parametrize("surv,targets", [
    ((0, 2, 4, 5, 8, 9, 10, 11), (1, 3, 6, 7)),
    ((4, 5, 6, 7, 8, 9, 10, 11), (0, 1, 2, 3)),
    ((0, 1, 2, 3, 4, 5, 6, 7), (8, 9, 10, 11)),
    ((1, 2, 3, 4, 5, 6, 7, 8), (0, 9)),
])
def test_reconstruct_matches_jax(surv, targets):
    k, n, s = 8, 12, 2049
    data = _data((2, k, s), 21)
    par = np.stack([jgf.encode_ref(d, 4) for d in data])
    shards = np.concatenate([data, par], axis=1)
    damaged = shards.copy()
    damaged[:, list(targets)] = 0
    got = rs.reconstruct(torch.from_numpy(damaged), k, n, surv, targets).numpy()
    assert np.array_equal(got, shards[:, list(targets)])
    want = np.asarray(rs_xla.reconstruct(jnp.asarray(damaged), k, n, surv, targets))
    assert np.array_equal(got, want)
    pal = np.asarray(rs_pallas.reconstruct(
        jnp.asarray(np.pad(damaged, ((0, 0), (0, 0), (0, 512 - s % 512)))),
        k, n, surv, targets, interpret=True))[:, :, :s]
    assert np.array_equal(got, pal)


def test_per_block_weights_match_gf2_matmul_multi():
    k, n, s = 8, 12, 1500
    pats = [((0, 1, 2, 3, 4, 5, 6, 7), (8, 9, 10, 11)),
            ((2, 3, 4, 5, 6, 7, 8, 9), (0, 1)),
            ((0, 1, 2, 3, 8, 9, 10, 11), (4, 5, 6))]
    t_max = 4
    x = _data((3, k, s), 8)
    w = np.zeros((3, k * 8, t_max * 8), dtype=np.int8)
    for b, (surv, targets) in enumerate(pats):
        w[b, :, :len(targets) * 8] = jgf.decode_bitmatrix(k, n, surv, targets)
    got = rs.gf2_matmul_multi(torch.from_numpy(x), torch.from_numpy(w), t_max).numpy()
    want = np.asarray(rs_xla.gf2_matmul_multi(jnp.asarray(x), jnp.asarray(w), t_max))
    assert np.array_equal(got, want)


def test_runtime_weights_match_pallas_layout():
    """rs_pallas takes w_t [t*8, k*8]; the port's kernel layout is
    w [k*8, t*8] — the same contraction after a transpose."""
    k, s = 8, 512
    x = _data((2, k, s), 9)
    w = rs.decode_weights_np(k, 12, (0, 1, 2, 3, 4, 5, 8, 9), (6, 7))
    want = np.asarray(rs_pallas.gf2_matmul_with_weights(
        jnp.asarray(x), jnp.asarray(np.ascontiguousarray(w.T)), 2, interpret=True))
    got = rs.gf2_matmul(torch.from_numpy(x), torch.from_numpy(w), 2).numpy()
    assert np.array_equal(got, want)


def test_reject_probes():
    shards = torch.zeros((1, 12, 64), dtype=torch.uint8)
    with pytest.raises(ValueError):   # fewer than k survivors
        rs.reconstruct(shards, 8, 12, (0, 1, 2, 3, 4, 5, 6), (7,))
    with pytest.raises(ValueError):   # duplicate survivors: singular
        rs.reconstruct(shards, 8, 12, (0, 0, 1, 2, 3, 4, 5, 6), (7,))


@pytest.mark.parametrize("k,m", [(1, 1), (2, 2), (4, 2), (8, 4), (12, 4),
                                 (16, 16), (20, 12), (32, 32)])
def test_kernel_geometry_admits_reference_geometries(k, m):
    """Every encode and every reconstruct of up to m lost shards of a
    reference geometry fits the kernel's packed tables: one word per entry
    up to 4 outputs, two up to 8, four up to 16, passes of 16 above."""
    assert jgf.encode_bitmatrix(k, m).shape == (k * 8, m * 8)
    for t in range(1, m + 1):
        nw, groups, smem = rs.kernel_geometry(k, t)
        assert nw == (1 if t <= 4 else 2 if t <= 8 else 4)
        assert groups == (1 if t <= 16 else -(-t // 16))
        assert smem == 256 + k * max(256, 32 * nw * groups * 4) + k * 8 * t
        assert smem <= rs.SMEM_LIMIT
    assert rs.kernel_geometry(8, 4)[2] == 256 + 8 * 256 + 8 * 8 * 4


@pytest.mark.parametrize("k,t", [(0, 4), (33, 4), (8, 0), (32, 400)])
def test_kernel_geometry_rejects_outside_limits(k, t):
    with pytest.raises(ValueError):
        rs.kernel_geometry(k, t)
