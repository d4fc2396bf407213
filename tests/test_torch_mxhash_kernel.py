"""K3 (csrc/mxhash256.cu) against its plain PyTorch versions (the chain and
the split form) on the card, at small ragged shapes and across the edges of
K3's tiling: 128-block tiles of the flattened [N, ceil((S + 9) / 512)]
blocks, 8 slices of 64 bytes, 256-term windows of the combine (the
full-size check runs in chip_smoke.py). Without a
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


def _both_plain(dev, chunks, lens):
    before = kernels.launches()["mxhash256"]
    got = mxhash.mxhash256(chunks, lens)
    torch.cuda.synchronize()
    assert kernels.launches()["mxhash256"] == before + 1
    assert torch.equal(got, mxhash.mxhash256_plain(chunks, lens))
    assert torch.equal(got, mxhash.mxhash256_split_plain(chunks, lens))


def _rand(n, s, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, s), dtype=np.uint8))


@pytest.mark.parametrize("case", ["one row", "rows not a multiple of the tile",
                                  "one long row among one-block rows",
                                  "all rows of length 0", "padding edges",
                                  "more than one combine window"])
def test_mxhash_kernel_tiling_edges(dev, case):
    """Each case byte-equal to the chain and to the split form: N = 1; N
    not a multiple of the 128-block tile (and a tile spanning two rows); a
    257-block row among rows of one block (tiles past a short row's blocks
    are skipped); every row empty; lengths around the one-block (503/504)
    and nine-block (4087/4088) edges; a 600-block row (three windows)."""
    s, lens = {
        "one row": (131072, [131072]),
        "rows not a multiple of the tile": (4096, [4096] * 37),
        "one long row among one-block rows": (131072, [0, 1, 131072, 503, 17, 131072 - 9]),
        "all rows of length 0": (700, [0] * 5),
        "padding edges": (4096, [503, 504, 4087, 4088, 511, 512, 1015, 1016]),
        "more than one combine window": (600 * 512, [600 * 512 - 9, 256 * 512 - 9,
                                                    256 * 512 - 8, 1]),
    }[case]
    chunks = _rand(len(lens), s, len(lens) + s).to(dev)
    _both_plain(dev, chunks, torch.tensor(lens, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("offset,stride", [(5, 3001), (3, 4099), (16, 4112)])
def test_mxhash_kernel_row_strides(dev, offset, stride):
    """Rows of a wider tensor: strides that are not a multiple of 16 take
    the byte path for every piece, 4112 keeps 16-byte pieces aligned."""
    wide = _rand(9, stride, stride).to(dev)
    view = wide[:, offset:offset + 2600]
    lens = torch.tensor([0, 1, 503, 504, 2600, 700, 4, 2047, 2591],
                        dtype=torch.int32, device=dev)
    _both_plain(dev, view, lens)


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
