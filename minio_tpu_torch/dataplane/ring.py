"""Staging slots + lane launch functions of the batched data plane
(counterpart of minio_tpu/dataplane/ring.py).

A *lane* is a fixed launch geometry: (op, k, m|t, shard-width bucket,
rows). Every launch on a lane stages through one of a small ring of slots
allocated once: request bytes are copied into the slot's host tensors
(pinned on CUDA, so the upload is one DMA) through their numpy views, and
the steady-state path allocates no staging memory.

Slot reuse on CUDA: the upload out of a pinned slot is asynchronous, so a
slot goes back to its ring only after the event recorded behind its
launch (upload, kernels, download, all on the plane's stream) has
completed (batcher.py). `SlotRing.acquire` blocks while every slot is in
flight: the throttle when the card falls a full ring behind. Ring depth 2
or more is double buffering: the dispatcher stages batch N+1 while the
card runs batch N.

`lane_kernel` maps a lane to a plain Python function over the port's
ops/fused.py, i.e. over the hand-written kernels K1 (gf2_matmul) and K2
(mxsum_digest). There is nothing to compile, and one card, so the JAX
package's buffer donation and batch sharding have no counterpart; the
function cache stays so that `trace_count()` still bounds the lane set.
"""

from __future__ import annotations

import functools
import queue
import threading
from typing import NamedTuple

import torch

from minio_tpu_torch.utils.shardmath import pow2_bucket

OP_ENCODE = "encode"
OP_VERIFY = "verify"
OP_RECONSTRUCT = "reconstruct"

_MIN_WIDTH = 512  # narrowest staged shard width (bytes)


def width_bucket(s: int) -> int:
    """Shard-width bucket: next power of two >= s (floor _MIN_WIDTH). Zero
    padding is free for every lane op (parity columns never mix, mxsum
    digests are width-invariant with the length as data), so one lane
    serves every width inside its bucket."""
    return pow2_bucket(s, floor=_MIN_WIDTH)


def rows_bucket(b: int, cap: int) -> int:
    """Row-count bucket: next power of two >= b, capped at the lane
    capacity."""
    return min(pow2_bucket(b), cap)


class LaneKey(NamedTuple):
    """One launch geometry. `aux` is m for encode lanes, the padded target
    count for reconstruct lanes, 0 for verify lanes; `digests` marks the
    digest-fused encode and reconstruct lanes."""

    op: str
    k: int
    aux: int
    width: int
    rows: int
    digests: bool


class Slot:
    """One staging slot. `data`, `lens` and `weights` are numpy views of
    the host tensors `data_t`, `lens_t` and `weights_t` (pinned when
    `pinned`): `data` the batch the kernels consume, `lens` the per-row
    chunk lengths, `weights` the per-row decode matrices (reconstruct
    lanes only)."""

    __slots__ = ("data_t", "lens_t", "weights_t", "data", "lens", "weights")

    def __init__(self, key: LaneKey, pinned: bool):
        shape = ((key.rows, key.width) if key.op == OP_VERIFY
                 else (key.rows, key.k, key.width))
        self.data_t = torch.zeros(shape, dtype=torch.uint8, pin_memory=pinned)
        self.lens_t = torch.zeros((key.rows,), dtype=torch.int32,
                                  pin_memory=pinned)
        self.weights_t = (
            torch.zeros((key.rows, key.k * 8, key.aux * 8), dtype=torch.int8,
                        pin_memory=pinned)
            if key.op == OP_RECONSTRUCT else None)
        self.data = self.data_t.numpy()
        self.lens = self.lens_t.numpy()
        self.weights = (self.weights_t.numpy()
                        if self.weights_t is not None else None)


class SlotRing:
    """Fixed pool of staging slots for one lane. acquire() blocks while
    every slot is in flight."""

    def __init__(self, key: LaneKey, depth: int, pinned: bool):
        self._free: queue.Queue[Slot] = queue.Queue()
        for _ in range(depth):
            self._free.put(Slot(key, pinned))

    def acquire(self) -> Slot:
        return self._free.get()

    def release(self, slot: Slot) -> None:
        self._free.put(slot)


class RingPool:
    """Lazily built SlotRing per lane key (pinned slots on CUDA). The key
    space is bounded (pow-2 width buckets x the deployment's geometries),
    so rings live as long as the plane; close() drops them."""

    def __init__(self, depth: int, pinned: bool):
        self.depth = depth
        self.pinned = pinned
        self._mu = threading.Lock()
        self._rings: dict[LaneKey, SlotRing] = {}

    def ring(self, key: LaneKey) -> SlotRing:
        with self._mu:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = SlotRing(key, self.depth, self.pinned)
            return ring

    def clear(self) -> None:
        with self._mu:
            self._rings.clear()


@functools.lru_cache(maxsize=256)
def lane_kernel(key: LaneKey):
    """The lane's launch function over device tensors, cached per lane key:

    encode      (data [R,k,W], lens [R]) -> (parity [R,m,W], digs [R,k+m,32] | None)
    verify      (data [R,W],   lens [R]) -> digs [R,32]
    reconstruct (data [R,k,W], w [R,k*8,t*8]) -> rebuilt [R,t,W]
    reconstruct+digests (data, w, lens [R]) -> (rebuilt, digs [R,t,32]),
    the heal lane: the rebuilt chunks' digests come from the same call.

    The compositions are fused's, unobserved (`__wrapped__`): the
    dispatcher records each lane launch once, as dp_<op>.
    """
    from minio_tpu_torch.ops import fused, rs

    k, aux = key.k, key.aux
    if key.op == OP_ENCODE and key.digests:
        def launch(data, lens):
            return fused.encode_with_digests.__wrapped__(data, k, aux, lens)
    elif key.op == OP_ENCODE:
        def launch(data, lens):
            return fused.encode_only.__wrapped__(data, k, aux), None
    elif key.op == OP_VERIFY:
        def launch(data, lens):
            return fused.verify_digests.__wrapped__(data, lens)
    elif key.op == OP_RECONSTRUCT and key.digests:
        def launch(data, weights, lens):
            return fused.reconstruct_multi_digests(data, weights, lens, aux)
    else:
        def launch(data, weights):
            return rs.gf2_matmul_multi(data, weights, aux)
    return launch


def trace_count() -> int:
    """Lane-function count (bounded-lane-set probe for tests)."""
    return lane_kernel.cache_info().currsize
