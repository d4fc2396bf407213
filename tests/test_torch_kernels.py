"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card, at small ragged shapes (the full-size check runs in
chip_smoke.py). Without a CUDA device they skip. On the card, where JAX
is not installed, run them without the suite's JAX conftest:
`python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q`.
Tolerance: exact (integer work)."""

import numpy as np
import pytest
import torch

from minio_tpu_torch.ops import kernels, mxsum, rs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,k,t,s", [(1, 8, 4, 1), (3, 8, 4, 517), (2, 4, 2, 4096),
                                     (16, 8, 4, 8192), (2, 12, 4, 1000)])
def test_gf2_matmul_kernel_equals_plain(dev, b, k, t, s):
    rng = np.random.default_rng(b * s)
    x = torch.from_numpy(rng.integers(0, 256, (b, k, s), dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(0, 2, (k * 8, t * 8), dtype=np.int8)).to(dev)
    wb = torch.from_numpy(rng.integers(0, 2, (b, k * 8, t * 8), dtype=np.int8)).to(dev)
    before = kernels.launches()["gf2_matmul"]
    assert torch.equal(rs.gf2_matmul(x, w, t), rs.gf2_matmul_plain(x, w, t))
    assert torch.equal(rs.gf2_matmul_multi(x, wb, t), rs.gf2_matmul_plain(x, wb, t))
    assert kernels.launches()["gf2_matmul"] == before + 2


@pytest.mark.parametrize("n,s", [(1, 0), (5, 1), (7, 513), (9, 4096), (13, 65537)])
def test_mxsum_kernel_equals_plain(dev, n, s):
    rng = np.random.default_rng(n + s)
    chunks = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
    lens = torch.full((n,), s, dtype=torch.int32, device=dev)
    got = mxsum.digest(chunks, lens)
    assert torch.equal(got, mxsum.digest_plain(chunks, lens))
    assert got[0].cpu().numpy().tobytes() == mxsum.digest_np(chunks[0].cpu().numpy())


def test_cuda_tensor_without_library_raises(dev, monkeypatch):
    """No fallback: with the kernel library unavailable, a CUDA tensor
    raises instead of taking the plain version."""
    def no_nvcc():
        raise kernels.KernelBuildError("nvcc not found")

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "_nvcc", no_nvcc)
    monkeypatch.setattr(kernels, "_digest", lambda: "missing-for-test")
    x = torch.zeros((1, 8, 64), dtype=torch.uint8, device=dev)
    w = torch.zeros((64, 32), dtype=torch.int8, device=dev)
    before = kernels.launches()
    with pytest.raises(kernels.KernelBuildError):
        rs.gf2_matmul(x, w, 4)
    with pytest.raises(kernels.KernelBuildError):
        mxsum.digest(torch.zeros((2, 64), dtype=torch.uint8, device=dev),
                     torch.zeros(2, dtype=torch.int32, device=dev))
    assert kernels.launches() == before




# The two tests below free a cached tensor while a launch queued on a side
# stream behind a half-second spin has yet to read it, then allocate a
# tensor of the same size. Both tensors are above 10 MiB, so the caching
# allocator gives each a segment of its own and the new tensor lands on the
# freed memory unless a stream still holds it. While the launch is pending
# it must not (the launch may also happen to win the race, since the card
# can order work of several streams behind one another); after it, the
# result must equal the plain version's. Nothing in that window may wait
# for the spin: each kernel has launched once before it (its first launch
# loads its module, which waits for the device), and every allocation
# there is served from the cache.


def _side_stream(dev, *warm):
    """A side stream whose cache already holds a block for each of the
    (shape, dtype) in `warm`."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for shape, dtype in warm:
            torch.empty(shape, dtype=dtype, device=dev)
    return side


def _spin(side):
    with torch.cuda.stream(side):
        torch.cuda._sleep(1_000_000_000)


def _launched(side):
    """An event behind the side stream's work queued so far."""
    ev = torch.cuda.Event()
    ev.record(side)
    return ev


def test_key_replaced_during_side_stream_digest(dev):
    """A wider width swaps in a larger device key and frees the old one
    while a digest queued on a side stream has yet to read it. The wider
    key is uploaded ahead and swapped in as device_key swaps it, since
    the upload waits for the device."""
    n, s = 4, 1 << 21                         # a 16 MiB key
    rng = np.random.default_rng(7)
    chunks = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
    lens = torch.full((n,), s, dtype=torch.int32, device=dev)
    want = mxsum.digest_plain(chunks, lens)
    mxsum._dev_key.pop(dev, None)
    torch.cuda.empty_cache()
    mxsum.digest(chunks, lens)                # the [s, 8] key, on the default stream
    old = mxsum._dev_key[dev].data_ptr()
    wider = torch.from_numpy(mxsum._key_rows(2 * s)).to(dev)
    side = _side_stream(dev, ((n, mxsum.DIGEST_LEN), torch.uint8))
    _spin(side)
    with torch.cuda.stream(side):
        got = mxsum.digest(chunks, lens)
    done = _launched(side)
    mxsum._dev_key[dev] = wider               # drops the [s, 8] key
    junk = torch.zeros((s, 8), dtype=torch.int8, device=dev)
    assert done.query() or junk.data_ptr() != old
    side.synchronize()
    del junk
    assert torch.equal(got, want)


def test_weights_dropped_during_side_stream_matmul(dev):
    """The same for weights that leave their cache while a side-stream
    launch still has to read them."""
    b, k, t, s = 4096, 12, 4, 64              # 12 MiB of per-block weights
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.integers(0, 256, (b, k, s), dtype=np.uint8)).to(dev)
    w = torch.from_numpy(rng.integers(0, 2, (b, k * 8, t * 8), dtype=np.int8)).to(dev)
    want = rs.gf2_matmul_plain(x, w, t)
    torch.cuda.empty_cache()
    rs.gf2_matmul_multi(x, w, t)
    old = w.data_ptr()
    side = _side_stream(dev, ((b, t, s), torch.uint8))
    _spin(side)
    with torch.cuda.stream(side):
        got = rs.gf2_matmul_multi(x, w, t)
    done = _launched(side)
    del w
    junk = torch.zeros((b, k * 8, t * 8), dtype=torch.int8, device=dev)
    assert done.query() or junk.data_ptr() != old
    side.synchronize()
    del junk
    assert torch.equal(got, want)
