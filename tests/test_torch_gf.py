"""GF(2^8) host math of the port (minio_tpu_torch/ops/gf.py, a copy)
against the JAX package's: byte-equal tables, generator, encode and decode
bit-matrices for every failure pattern at EC 4+2 and a seeded sample at
EC 8+4, and the numpy reference codecs. Tolerance: exact (integer math)."""

import itertools

import numpy as np
import pytest

from minio_tpu.ops import gf as jgf
from minio_tpu_torch.ops import gf as tgf


def _patterns(k, n):
    """(survivors, targets) for every set of lost shards up to n-k."""
    for lost_n in range(1, n - k + 1):
        for lost in itertools.combinations(range(n), lost_n):
            present = [i for i in range(n) if i not in lost]
            yield tuple(present[:k]), tuple(lost)


def test_tables_and_generator_equal():
    assert np.array_equal(tgf.GF_EXP, jgf.GF_EXP)
    assert np.array_equal(tgf.GF_LOG, jgf.GF_LOG)
    assert np.array_equal(tgf.mul_table(), jgf.mul_table())
    for k, m in [(4, 2), (8, 4), (12, 4), (2, 2)]:
        assert np.array_equal(tgf.rs_generator_matrix(k, k + m),
                              jgf.rs_generator_matrix(k, k + m))
        assert np.array_equal(tgf.encode_bitmatrix(k, m),
                              jgf.encode_bitmatrix(k, m))


@pytest.mark.parametrize("k,m,sample", [(4, 2, None), (8, 4, 60)])
def test_decode_bitmatrix_every_pattern(k, m, sample):
    n = k + m
    pats = list(_patterns(k, n))
    if sample is not None:
        rng = np.random.default_rng(11)
        pats = [pats[i] for i in rng.choice(len(pats), sample, replace=False)]
    for surv, targets in pats:
        assert np.array_equal(tgf.decode_bitmatrix(k, n, surv, targets),
                              jgf.decode_bitmatrix(k, n, surv, targets)), (surv, targets)


def test_reference_codecs_equal():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (8, 777), dtype=np.uint8)
    par = tgf.encode_ref(data, 4)
    assert np.array_equal(par, jgf.encode_ref(data, 4))
    shards = np.concatenate([data, par])
    surv, targets = (0, 2, 4, 5, 8, 9, 10, 11), (1, 3, 6, 7)
    assert np.array_equal(tgf.reconstruct_ref(shards, 8, surv, targets),
                          shards[list(targets)])


def test_singular_pattern_rejected():
    with pytest.raises(ValueError):
        tgf.decode_matrix(4, 6, (0, 1, 2), (3,))
    with pytest.raises(ValueError):
        tgf.decode_matrix(4, 6, (0, 0, 1, 2), (3,))
