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


def _gf2_case(dev, b, k, t, s, seed, offset=0):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, b * k * s + offset, dtype=np.uint8)
    x = torch.from_numpy(raw).to(dev)[offset:].view(b, k, s)
    w = torch.from_numpy(rng.integers(0, 2, (k * 8, t * 8), dtype=np.int8)).to(dev)
    wb = torch.from_numpy(rng.integers(0, 2, (b, k * 8, t * 8), dtype=np.int8)).to(dev)
    return x, w, wb


@pytest.mark.parametrize("k", [1, 8, 16, 32])
@pytest.mark.parametrize("t", [1, 4, 5, 8, 16, 20])
def test_gf2_matmul_table_widths(dev, k, t):
    """Every table-entry width (uint32, uint2, uint4, passes of 16 outputs)
    at kin from 1 to the admitted 32, shared and per-block weights, over
    one full tile and a partial one."""
    x, w, wb = _gf2_case(dev, 2, k, t, 4096 + 1024, 100 * k + t)
    assert torch.equal(rs.gf2_matmul(x, w, t), rs.gf2_matmul_plain(x, w, t))
    assert torch.equal(rs.gf2_matmul_multi(x, wb, t), rs.gf2_matmul_plain(x, wb, t))


@pytest.mark.parametrize("b,k,t,s,offset", [
    (1, 8, 4, 16, 0),         # B = 1, S below one tile
    (1, 8, 4, 4080, 0),       # S a multiple of 16, not of the tile
    (3, 8, 4, 131, 0),        # odd S: the byte path
    (2, 8, 4, 4096, 1),       # x one byte off alignment: the byte path
    (5, 16, 8, 4097, 3),      # both, with uint2 entries
    (37, 8, 4, 8192, 0),      # more tiles than one pass of the grid
])
def test_gf2_matmul_edge_geometry(dev, b, k, t, s, offset):
    x, w, wb = _gf2_case(dev, b, k, t, s, b * s + offset, offset)
    assert (x.data_ptr() % 16 != 0) == (offset % 16 != 0)
    assert torch.equal(rs.gf2_matmul(x, w, t), rs.gf2_matmul_plain(x, w, t))
    assert torch.equal(rs.gf2_matmul_multi(x, wb, t), rs.gf2_matmul_plain(x, wb, t))


@pytest.mark.parametrize("n,s", [(1, 16), (63, 4096), (65, 1000), (100, 513),
                                 (200, 2048 + 16), (3, 200001), (2, 1 << 18)])
def test_mxsum_kernel_edge_geometry(dev, n, s):
    """Rows not a multiple of the 16-row block, S not a multiple of 16,
    S above 128 KiB (sums that wrap mod 2^32 across segments), and
    lengths 0, 1, 513 and S among the rows."""
    rng = np.random.default_rng(n * 7 + s)
    chunks = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
    lens = torch.full((n,), s, dtype=torch.int32, device=dev)
    for row, ln in enumerate((0, 1, 513, s)[:n]):
        ln = min(ln, s)
        chunks[row, ln:] = 0
        lens[row] = ln
    got = mxsum.digest(chunks, lens)
    assert torch.equal(got, mxsum.digest_plain(chunks, lens))
    r = n - 1
    assert got[r].cpu().numpy().tobytes() == mxsum.digest_np(
        chunks[r, :int(lens[r])].cpu().numpy())


def test_mxsum_workspace_is_left_zero(dev):
    """Every launch leaves its stream's workspace zero, so the next launch
    on the stream starts clean: digests repeat bit-exactly, across row
    groups of different counts and on a second stream."""
    rng = np.random.default_rng(3)
    chunks = torch.from_numpy(rng.integers(0, 256, (150, 3000), dtype=np.uint8)).to(dev)
    lens = torch.full((150,), 3000, dtype=torch.int32, device=dev)
    want = mxsum.digest_plain(chunks, lens)
    for n in (150, 7, 150):
        assert torch.equal(mxsum.digest(chunks[:n], lens[:n]), want[:n])
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = mxsum.digest(chunks, lens)
    side.synchronize()
    assert torch.equal(got, want)
    stream = torch.cuda.current_stream(dev)
    assert not mxsum._work[(stream.device, stream.cuda_stream)].any()


# The lane shapes of the batched data plane and the hot tier's serve
# (minio_tpu_torch/dataplane/, hottier/): the widest full encode lane, the
# widest reconstruct lane with per-row decode matrices over 4 survivor
# patterns, the verify lanes at their widest (ragged lengths) and their
# narrowest, and K2 over a window of a resident tensor.


@pytest.mark.parametrize("b,s", [(32, 65536), (32, 512)])
def test_gf2_matmul_encode_lane(dev, b, s):
    rng = np.random.default_rng(b + s)
    x = torch.from_numpy(rng.integers(0, 256, (b, 8, s), dtype=np.uint8)).to(dev)
    w = rs.device_encode_weights(8, 4, dev)
    assert torch.equal(rs.gf2_matmul(x, w, 4), rs.gf2_matmul_plain(x, w, 4))


def test_gf2_matmul_reconstruct_lane_per_row_patterns(dev):
    """[32, 8, 16384] -> t_pad 4 with 32 per-row decode matrices over 4
    survivor patterns, padded target columns zero (the lane's staging),
    rebuilding the lost shards."""
    k, n, s = 8, 12, 16384
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (32, k, s), dtype=np.uint8)
    full = np.concatenate([data, rs.gf2_matmul_plain(
        torch.from_numpy(data), torch.from_numpy(rs.encode_weights_np(k, 4)),
        4).numpy()], axis=1)
    pats = [(0, 2, 4, 5, 8, 9, 10, 11), (2, 3, 4, 5, 6, 7, 8, 9),
            (0, 1, 2, 3, 8, 9, 10, 11), (1, 3, 5, 7, 8, 9, 10, 11)]
    x = np.zeros((32, k, s), dtype=np.uint8)
    w = np.zeros((32, k * 8, 32), dtype=np.int8)
    wants = []
    for r in range(32):
        sv = pats[r % 4]
        tg = tuple(i for i in range(k) if i not in sv)
        x[r] = full[r, list(sv)]
        w[r, :, :len(tg) * 8] = rs.decode_weights_np(k, n, sv, tg)
        wants.append(full[r, list(tg)])
    xd, wd = torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)
    got = rs.gf2_matmul_multi(xd, wd, 4)
    assert torch.equal(got, rs.gf2_matmul_plain(xd, wd, 4))
    got = got.cpu().numpy()
    for r, want in enumerate(wants):
        assert np.array_equal(got[r, :len(want)], want)


@pytest.mark.parametrize("n,s", [(128, 65536), (128, 512)])
def test_mxsum_verify_lane_ragged(dev, n, s):
    rng = np.random.default_rng(n + s + 1)
    lens_np = rng.integers(0, s + 1, n).astype(np.int32)
    chunks_np = rng.integers(0, 256, (n, s), dtype=np.uint8)
    chunks_np[np.arange(s)[None, :] >= lens_np[:, None]] = 0
    chunks = torch.from_numpy(chunks_np).to(dev)
    lens = torch.from_numpy(lens_np).to(dev)
    got = mxsum.digest(chunks, lens)
    assert torch.equal(got, mxsum.digest_plain(chunks, lens))
    for r in (0, n - 1):
        assert got[r].cpu().numpy().tobytes() == mxsum.digest_np(
            chunks_np[r, :lens_np[r]])


def test_mxsum_over_resident_window(dev):
    """K2 over rows [start, start+window) of a resident [rows, k, width]
    tensor, as the hot tier serves them: a contiguous view, no copy."""
    from minio_tpu_torch.hottier import arena

    rng = np.random.default_rng(12)
    data = torch.from_numpy(rng.integers(0, 256, (16, 8, 4096), dtype=np.uint8))
    lens = torch.from_numpy(rng.integers(1, 4097, 16).astype(np.int32))
    for r in range(16):
        data[r, :, int(lens[r]):] = 0
    stream = torch.cuda.Stream(dev)
    win, digs = arena.serve_window(data.to(dev), lens.to(dev), 4, 8, True, stream)
    want_win, want_digs = arena.serve_window(data, lens, 4, 8, True, None)
    assert np.array_equal(win, want_win) and np.array_equal(digs, want_digs)
    # The admit-time re-hash: the digests of the first blocks, alone.
    got = arena.resident_digests(data.to(dev), lens.to(dev), 12, stream)
    want = arena.resident_digests(data, lens, 12, None)
    assert np.array_equal(got, want)
    assert np.array_equal(want[4:12], want_digs)


def test_plane_ring_depth_overrun_on_card(dev):
    import torch_lane_cases

    torch_lane_cases.ring_overrun(dev)


def test_plane_reused_slot_tails_are_zeroed_on_card(dev):
    import torch_lane_cases

    torch_lane_cases.dirty_slot_tails(dev)


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
    n, s = 4, 1 << 21                         # a 16 MiB key [8, s]
    rng = np.random.default_rng(7)
    chunks = torch.from_numpy(rng.integers(0, 256, (n, s), dtype=np.uint8)).to(dev)
    lens = torch.full((n,), s, dtype=torch.int32, device=dev)
    want = mxsum.digest_plain(chunks, lens)
    mxsum._dev_key.pop(dev, None)
    torch.cuda.empty_cache()
    mxsum.digest(chunks, lens)                # the [8, s] key, on the default stream
    old = mxsum._dev_key[dev].data_ptr()
    wider = torch.from_numpy(mxsum.transposed_key(2 * s)).to(dev)
    words = kernels.library().mtpu_mxsum_workspace_words(n)
    side = _side_stream(dev, ((n, mxsum.DIGEST_LEN), torch.uint8),
                        ((words,), torch.int32))
    _spin(side)
    with torch.cuda.stream(side):
        got = mxsum.digest(chunks, lens)
    done = _launched(side)
    mxsum._dev_key[dev] = wider               # drops the [8, s] key
    junk = torch.zeros((8, s), dtype=torch.int8, device=dev)
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


def test_gf2_matmul_at_ec_12_4(dev):
    """The 16-drive set's main shapes (EC 12+4, 1 MiB blocks: 87,382-byte
    chunks, K1's ragged byte path): encode [16,12,87382]->4, and rebuilding
    4 lost shards from the 12 survivors gives the shards back."""
    rng = np.random.default_rng(1216)
    x = torch.from_numpy(rng.integers(0, 256, (16, 12, 87382), dtype=np.uint8)).to(dev)
    w = rs.device_encode_weights(12, 4, dev)
    parity = rs.gf2_matmul(x, w, 4)
    assert torch.equal(parity, rs.gf2_matmul_plain(x, w, 4))
    shards = torch.cat([x, parity], dim=1)
    surv, lost = (0, 1, 3, 4, 5, 7, 8, 10, 12, 13, 14, 15), (2, 6, 9, 11)
    xs = shards[:, list(surv)].contiguous()
    wd = rs.device_decode_weights(12, 16, surv, lost, dev)
    rebuilt = rs.gf2_matmul(xs, wd, 4)
    assert torch.equal(rebuilt, rs.gf2_matmul_plain(xs, wd, 4))
    assert torch.equal(rebuilt, shards[:, list(lost)])


@pytest.mark.parametrize("n", [256, 192])
def test_mxsum_at_ec_12_4(dev, n):
    """K2 at the PUT digest rows [256, 87382] and the GET verify rows
    [192, 87382], the last block of an object short."""
    rng = np.random.default_rng(n)
    chunks = rng.integers(0, 256, (n, 87382), dtype=np.uint8)
    lens = np.full(n, 87382, dtype=np.int32)
    lens[-16:] = 12345
    chunks[-16:, 12345:] = 0
    c, ln = torch.from_numpy(chunks).to(dev), torch.from_numpy(lens).to(dev)
    assert torch.equal(mxsum.digest(c, ln), mxsum.digest_plain(c, ln))


def test_mxsum_at_ec_12_4_get_staging(dev):
    """K2 at the GET verify launch as the path stages it: 16 blocks x 12
    chunks = 192 rows of 87,382 bytes, padded to 256 rows, the last 64 of
    length 0."""
    rng = np.random.default_rng(1922)
    chunks = np.zeros((256, 87382), dtype=np.uint8)
    chunks[:192] = rng.integers(0, 256, (192, 87382), dtype=np.uint8)
    lens = np.zeros(256, dtype=np.int32)
    lens[:192] = 87382
    c, ln = torch.from_numpy(chunks).to(dev), torch.from_numpy(lens).to(dev)
    got = mxsum.digest(c, ln)
    assert torch.equal(got, mxsum.digest_plain(c, ln))
    assert torch.equal(got[:192], mxsum.digest(c[:192].contiguous(), ln[:192]))
