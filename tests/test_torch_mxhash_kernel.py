"""K3 (csrc/mxhash256.cu) against its plain PyTorch version on the card, at
small ragged shapes (the full-size check runs in chip_smoke.py). Without a
CUDA device they skip. On the card, where JAX is not installed, run them
without the suite's JAX conftest:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mxhash_kernel.py -q`.
Tolerance: exact (integer work)."""

import numpy as np
import pytest
import torch

from minio_tpu_torch.ops import kernels, mxhash


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,s", [(1, 0), (3, 1), (9, 513), (5, 4096), (7, 87382)])
def test_mxhash_kernel_equals_plain(dev, n, s):
    rng = np.random.default_rng(n + s)
    chunks = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
    lens = torch.from_numpy(rng.integers(0, s + 1, n).astype(np.int32)).to(dev)
    before = kernels.launches()["mxhash256"]
    got = mxhash.mxhash256(chunks, lens)
    torch.cuda.synchronize()
    assert torch.equal(got, mxhash.mxhash256_plain(chunks, lens))
    assert kernels.launches()["mxhash256"] == before + 1


def test_mxhash_kernel_on_strided_rows(dev):
    wide = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (6, 3001), dtype=np.uint8)).to(dev)
    view = wide[:, 5:2000]
    lens = torch.tensor([0, 1, 503, 504, 1995, 700], dtype=torch.int32, device=dev)
    assert torch.equal(mxhash.mxhash256(view, lens), mxhash.mxhash256_plain(view, lens))


def test_encode_with_bitrot_on_the_card(dev):
    data = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (2, 8, 4096), dtype=np.uint8)).to(dev)
    par, digs = mxhash.encode_with_bitrot(data, 8, 4)
    shards = torch.cat([data.cpu(), par.cpu()], dim=1).reshape(24, 4096)
    want = mxhash.mxhash256_plain(shards, torch.full((24,), 4096, dtype=torch.int32))
    assert torch.equal(digs.cpu().reshape(24, 32), want)
