"""Cases of the batched data plane's ring that run on any device: the
CPU tests (tests/test_torch_dataplane.py) call them with "cpu", the card
tests (tests/test_torch_kernels.py) with the CUDA device. No JAX import:
the card's machine has none. Tolerance: exact bytes."""

import numpy as np

from minio_tpu_torch.dataplane.batcher import BatchPlane
from minio_tpu_torch.erasure.codec import ErasureCodec
from minio_tpu_torch.ops import fused


def _blob(rng, size: int) -> bytes:
    return rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()


def _rows(chunks):
    return [[bytes(c) for c in r] for r in chunks]


def ring_overrun(device):
    """More batches than slots (ring depth 2, 4-row lanes), submitted back
    to back: every output equals the per-object codec's."""
    rng = np.random.default_rng(5)
    k, m, bs = 8, 4, 1 << 16
    p = BatchPlane(device=device, max_wait_s=0.0005, lane_blocks=4,
                   ring_depth=2)
    try:
        codec = ErasureCodec(k, m, bs, device=device)
        batches = [[_blob(rng, int(n)) for n in rng.integers(1, bs, 3)]
                   for _ in range(24)]
        pends = [p.begin_encode(k, m, bs, b, with_digests=True)
                 for b in batches]
        for b, pend in zip(batches, pends):
            got_c, got_d = pend.wait()
            want_c, want_d = codec.begin_encode(b).wait()
            assert _rows(got_c) == _rows(want_c)
            assert got_d == want_d
        assert p.stats()["launches"] > 2   # the ring of 2 slots wrapped
    finally:
        p.close()


def dirty_slot_tails(device):
    """A slot reused at a narrower chunk length inside one width bucket:
    the stage zeroes each row's tail, so parity and digests equal the
    codec's (lane padding is invisible on the device too)."""
    rng = np.random.default_rng(6)
    k, m, bs = 4, 2, 1 << 14
    p = BatchPlane(device=device, max_wait_s=0.0005, ring_depth=1)
    try:
        codec = ErasureCodec(k, m, bs, device=device)
        for size in (4 * 4096, 4 * 3000 + 1, 4 * 2049):   # width 4096 each
            blocks = [_blob(rng, size)]
            got = p.begin_encode(k, m, bs, blocks, with_digests=True).wait()
            want = codec.begin_encode(blocks).wait()
            assert _rows(got[0]) == _rows(want[0]) and got[1] == want[1]
        digs = p.digest_chunks([_blob(rng, 4000)], 4096)
        chunk = _blob(rng, 3000)
        assert p.digest_chunks([chunk], 4096) == \
            fused.digest_chunks_host([chunk], 4096, device)
        assert len(digs[0]) == 32
    finally:
        p.close()
