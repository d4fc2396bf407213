"""A capped pool of reusable host staging tensors (counterpart of
minio_tpu/utils/bufpool.py; reference pkg/bpool/bpool.go BytePoolCap).

The GET verify stages every batch of chunks into a [rows, cap] tensor,
pinned when the device is CUDA so its upload is one DMA. Allocating a
pinned buffer page-locks it, far slower than the copy it serves, so the
buffers are recycled. They are handed out dirty: callers write every
byte the launch reads.

A pinned buffer is read by a non-blocking copy that runs after `put`
could be called, so `put` takes the CUDA event recorded after the last
copy reading the buffer, and waits for it before the buffer can be taken
again: reusing it while the copy is in flight would corrupt the batch in
flight.
"""

from __future__ import annotations

import threading

import torch


class TensorPool:
    def __init__(self, max_per_shape: int = 4, max_shapes: int = 32):
        self._mu = threading.Lock()
        self._pools: dict[tuple, list[torch.Tensor]] = {}
        self.max_per_shape = max_per_shape
        self.max_shapes = max_shapes

    def get(self, shape: tuple[int, ...], dtype: torch.dtype,
            pinned: bool) -> torch.Tensor:
        """A host tensor of `shape` (dirty), pinned when asked."""
        key = (shape, dtype, pinned)
        with self._mu:
            lst = self._pools.get(key)
            t = lst.pop() if lst else None
        if t is None:
            t = torch.empty(shape, dtype=dtype, pin_memory=pinned)
        return t

    def put(self, t: torch.Tensor, copied=None) -> None:
        """Return a tensor; `copied` is the event recorded after the last
        copy that reads it (None when nothing reads it asynchronously)."""
        if copied is not None:
            copied.synchronize()
        key = (tuple(t.shape), t.dtype, t.is_pinned())
        with self._mu:
            if len(self._pools) >= self.max_shapes and key not in self._pools:
                self._pools.clear()   # shape churn: stay capped
            lst = self._pools.setdefault(key, [])
            if len(lst) < self.max_per_shape:
                lst.append(t)


GLOBAL_POOL = TensorPool()
