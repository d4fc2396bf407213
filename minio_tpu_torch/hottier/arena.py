"""Device residence accounting + the hot-GET serve launch (counterpart of
minio_tpu/hottier/arena.py).

A resident object is one uint8 tensor `[rows, k, width]` on the card: its
payload split on its own erasure grid (block_size blocks, each split into
its k data-shard chunks), with `rows` the pow-2 bucket of the block count
and `width` the pow-2 bucket of the chunk length (shardmath.pow2_bucket,
the rule the codec and the dataplane lanes stage by), so the tier lives
on a bounded set of shapes. The byte budget (MTPU_HOTTIER_BYTES) is
charged on those shapes (`shape_bytes`), not on what the caching
allocator holds: an evicted entry drops its tensor and the allocator
keeps the block for the next entry of that shape.

Host staging tensors (the admit-time copy target, pinned on CUDA so the
upload is one DMA) recycle through a per-shape free list. The upload
completes before `seal` returns, so a staging tensor is recycled as soon
as its entry is sealed: the resident tensor is the card's own copy.

Serve: `serve_window` slices `data[start:start+window]`, a contiguous
view, so the gather needs no kernel; with verify on, K2 digests the
window's rows (`view.reshape(window*k, width)`, the chunk lengths
repeated k times) in one launch, and the window comes back in one
download into pinned memory of its own. Decoding from the k resident
data shards of a systematic code is the identity solve, so the gather
IS the reconstruct.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from minio_tpu_torch.dataplane.ring import width_bucket
from minio_tpu_torch.utils.shardmath import pow2_bucket

DEFAULT_BUDGET_BYTES = 256 << 20   # device-resident byte budget


def rows_bucket(n: int) -> int:
    return pow2_bucket(max(1, n))


def entry_shape(nblocks: int, k: int, chunk_len: int) -> tuple:
    """The pow-2 bucketed resident shape of an object of `nblocks` erasure
    blocks with data-chunk length `chunk_len`."""
    return (rows_bucket(nblocks), k, width_bucket(chunk_len))


def shape_bytes(shape: tuple) -> int:
    r, k, w = shape
    # data + per-block lens (i32) + per-chunk digest baseline (32 B).
    return r * k * w + r * 4 + r * k * 32


class DeviceArena:
    """Budget-bounded device residence accounting + host staging reuse.

    acquire() hands out a zeroed host staging tensor of a shape (recycled
    when possible); seal() copies it to the device and charges the
    budget; release() uncharges. The bookkeeping lock is a leaf: no device
    work runs under it."""

    def __init__(self, device: torch.device,
                 budget_bytes: int = DEFAULT_BUDGET_BYTES):
        self.device = device
        self.budget = budget_bytes
        self._pinned = device.type == "cuda"
        self._mu = threading.Lock()
        self._used = 0
        self._free: dict[tuple, list[torch.Tensor]] = {}

    @property
    def used_bytes(self) -> int:
        return self._used

    def fits(self, shape: tuple) -> bool:
        with self._mu:
            return self._used + shape_bytes(shape) <= self.budget

    def acquire(self, shape: tuple) -> torch.Tensor:
        """A zeroed host staging tensor (not yet charged to the budget)."""
        with self._mu:
            pool = self._free.get(shape)
            buf = pool.pop() if pool else None
        if buf is None:
            return torch.zeros(shape, dtype=torch.uint8, pin_memory=self._pinned)
        buf.zero_()
        return buf

    def seal(self, shape: tuple, staging: torch.Tensor,
             stream: torch.cuda.Stream | None) -> torch.Tensor:
        """Copy the staged bytes to the device (on `stream`, waited for
        before return) and charge the budget. Returns the resident tensor,
        which shares no memory with the staging tensor."""
        if stream is None:
            dev = staging.clone()
        else:
            with torch.cuda.stream(stream):
                dev = staging.to(self.device, non_blocking=True)
            stream.synchronize()
        with self._mu:
            self._used += shape_bytes(shape)
        return dev

    def recycle_staging(self, shape: tuple, staging: torch.Tensor) -> None:
        with self._mu:
            self._free.setdefault(shape, []).append(staging)
            # Bound the per-shape free list: staging reuse is a fast path,
            # not a second cache.
            del self._free[shape][4:]

    def release(self, shape: tuple) -> None:
        with self._mu:
            self._used = max(0, self._used - shape_bytes(shape))

    def clear(self) -> None:
        with self._mu:
            self._used = 0
            self._free.clear()


def _window_digests(data: torch.Tensor, lens: torch.Tensor, start: int,
                    window: int) -> torch.Tensor:
    """K2 over the chunks of blocks [start, start+window): one launch,
    digests `[window, k, 32]` on the tensor's device."""
    from minio_tpu_torch.ops import mxsum

    _rows, k, width = data.shape
    win = data[start:start + window]
    digs = mxsum.digest(win.reshape(window * k, width),
                        lens[start:start + window].repeat_interleave(k))
    return digs.reshape(window, k, mxsum.DIGEST_LEN)


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Queue one download of `t` into pinned memory of its own."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def resident_digests(data: torch.Tensor, lens: torch.Tensor, nblocks: int,
                     stream: torch.cuda.Stream | None) -> np.ndarray:
    """The admit-time re-hash: digests of the first `nblocks` blocks of a
    resident tensor, with only the digests downloaded."""
    if stream is None:
        return _window_digests(data, lens, 0, nblocks).numpy()
    with torch.cuda.stream(stream):
        host = _to_host(_window_digests(data, lens, 0, nblocks))
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy()


def serve_window(data: torch.Tensor, lens: torch.Tensor, start: int,
                 window: int, verify: bool,
                 stream: torch.cuda.Stream | None):
    """The hot-GET launch: blocks [start, start+window) of a resident
    `[rows, k, width]` tensor and, with verify on, their chunks' mxsum
    digests. Returns host numpy arrays (window [window, k, width], digests
    [window, k, 32] | None) in memory of this call's own."""
    win = data[start:start + window]
    if stream is None:
        return win.numpy().copy(), (
            _window_digests(data, lens, start, window).numpy()
            if verify else None)
    with torch.cuda.stream(stream):
        host = _to_host(win)
        hdigs = (_to_host(_window_digests(data, lens, start, window))
                 if verify else None)
        done = torch.cuda.Event()
        done.record(stream)
    done.synchronize()
    return host.numpy(), (None if hdigs is None else hdigs.numpy())
