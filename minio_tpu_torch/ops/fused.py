"""Codec + bitrot compositions — the port's device path (counterpart of
minio_tpu/ops/fused.py).

The serving paths call these:

  PutObject  -> encode_with_digests          (erasure/codec.py begin_encode)
  GetObject  -> verify_digests               (batched chunk verify on read)
  Heal       -> reconstruct_weights_digests  (rebuilt shards + digests)
  heal lane  -> reconstruct_multi_digests    (dataplane: per-row weights)

for mxsum256; device_digest picks a device algorithm's batched digest
(mxsum256: K2, mxhash256: K3), and stage_and_digest stages a ragged list
of byte chunks for it. mxhash256's encode is ops/mxhash.py
encode_with_bitrot.

reconstruct_with_digests and reconstruct_only are the JAX package's
static-pattern rebuilds (survivors and targets fixed per call, the decode
matrix built once per pattern and cached on the device); no path of
either package calls them yet. Each `*_plain` function is the same
composition over the plain versions of K1 and K2, which chip_smoke.py
holds the kernels' composition against on the card.

Where the JAX package fuses the GF(2) contraction and the digest into one
XLA launch, the port composes two kernel launches (K1 gf2_matmul, K2
mxsum_digest) on device tensors: parity stays on the device between them,
with no host round trip. K1 takes any shard width, so the 512-lane padding
the Pallas dispatch needs is gone; K2's digests are width-invariant, so
rows zero-padded to a staging width hash as their real length.

Each entry point below is observed under the JAX package's label
(minio_tpu_kernel_seconds / _launches_total{kernel,backend}, obs/kernel.py),
and each observed call launches:

    encode               K1            encode_digests       K1, K2
    reconstruct          K1            reconstruct_digests  K1, K2
    reconstruct_weights  K1 (and K2 with digests)
    verify_digests       K2

The batched data plane's lanes call the same compositions unobserved
(`.__wrapped__`) and record their launches as dp_<op> (dataplane/
batcher.py): dp_encode K1 and K2, dp_verify K2, dp_reconstruct K1 and, in
the heal lane, K2. As in the JAX package, the degraded-read decode
(erasure/codec.py decode_blocks, K1 alone), the hot tier's serve (K2) and
mxhash256's launches (K3) are not observed.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from minio_tpu_torch.obs import kernel as obs_kernel
from minio_tpu_torch.ops import mxhash, mxsum, rs
from minio_tpu_torch.utils import bufpool
from minio_tpu_torch.utils.device import resolve
from minio_tpu_torch.utils.shardmath import pow2_bucket


def bucket_rows(b: int) -> int:
    """Next power-of-two batch-row count (>= 1): the staging rule the JAX
    package uses to bound its trace count, kept so both packages stage
    identical batches."""
    return pow2_bucket(b)


def bucket_width(s: int) -> int:
    """Next power-of-two staging width (>= 512) for a chunk of s bytes:
    a small object's launch touches KiBs, not a full block's width."""
    return pow2_bucket(s, floor=512)


def _observed(kernel: str):
    """Record each call of an entry point as one launch of `kernel`: its
    first argument is the batch (shape[0] and size label the launch), and
    under MTPU_KERNEL_SYNC the record is the device time of the kernels
    it launched."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(data, *a, **kw):
            t0 = obs_kernel.start(data.device)
            try:
                out = fn(data, *a, **kw)
            finally:
                obs_kernel.stop(t0)
            obs_kernel.observe(kernel, obs_kernel.backend(data.device), t0,
                               blocks=data.shape[0], nbytes=data.numel())
            return out
        return wrapper
    return deco


@_observed("encode")
def encode_only(data: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """data [B, k, S] u8 -> parity [B, m, S] u8."""
    return rs.encode(data, k, m)


@_observed("encode_digests")
def encode_with_digests(data: torch.Tensor, k: int, m: int,
                        chunk_lens: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """data [B, k, S] u8 (rows zero-padded past each block's chunk length)
    -> (parity [B, m, S] u8, digests [B, k+m, 32] u8), digests over each
    shard's chunk_lens[b] bytes (chunk_lens [B] int32, default S)."""
    b, _, s = data.shape
    n = k + m
    if chunk_lens is None:
        chunk_lens = torch.full((b,), s, dtype=torch.int32, device=data.device)
    parity = rs.encode(data, k, m)
    shards = torch.cat([data, parity], dim=1)                 # [B, n, S]
    lens = chunk_lens.repeat_interleave(n)                    # row-major [B*n]
    digs = mxsum.digest(shards.reshape(b * n, s), lens)
    return parity, digs.reshape(b, n, mxsum.DIGEST_LEN)


@_observed("reconstruct_weights")
def reconstruct_weights_digests(surv: torch.Tensor, w_t: torch.Tensor,
                                chunk_lens: torch.Tensor, out_shards: int,
                                with_digests: bool = True):
    """Heal rebuild with the decode matrix as runtime data: surv
    [B, k, S] u8 survivor-compacted, w_t the pattern's [t*8, k*8]
    transposed decode matrix (rs_pallas's layout, as the JAX caller passes
    it) -> (rebuilt [B, t, S], digests [B, t, 32] | None)."""
    b, _, s = surv.shape
    rebuilt = rs.gf2_matmul(surv, w_t.t().contiguous(), out_shards)
    if not with_digests:
        return rebuilt, None
    lens = chunk_lens.repeat_interleave(out_shards)
    digs = mxsum.digest(rebuilt.reshape(b * out_shards, s), lens)
    return rebuilt, digs.reshape(b, out_shards, mxsum.DIGEST_LEN)


@_observed("reconstruct")
def reconstruct_only(shards: torch.Tensor, k: int, n: int,
                     survivors: tuple[int, ...],
                     targets: tuple[int, ...]) -> torch.Tensor:
    """shards [B, n, S] u8 (survivor rows meaningful) -> the `targets`
    rows [B, t, S] rebuilt from the first k `survivors` (K1)."""
    return rs.reconstruct(shards, k, n, survivors, targets)


@_observed("reconstruct_digests")
def reconstruct_with_digests(shards: torch.Tensor, k: int, n: int,
                             survivors: tuple[int, ...],
                             targets: tuple[int, ...],
                             chunk_lens: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """shards [B, n, S] u8 -> (rebuilt [B, t, S] u8, digests [B, t, 32]
    u8 of each rebuilt chunk's chunk_lens[b] bytes, default S): K1, then
    K2 on the rebuilt rows, still on the device."""
    b, _, s = shards.shape
    t = len(targets)
    if chunk_lens is None:
        chunk_lens = torch.full((b,), s, dtype=torch.int32, device=shards.device)
    rebuilt = rs.reconstruct(shards, k, n, survivors, targets)
    digs = mxsum.digest(rebuilt.reshape(b * t, s), chunk_lens.repeat_interleave(t))
    return rebuilt, digs.reshape(b, t, mxsum.DIGEST_LEN)


def reconstruct_only_plain(shards: torch.Tensor, k: int, n: int,
                           survivors: tuple[int, ...],
                           targets: tuple[int, ...]) -> torch.Tensor:
    """reconstruct_only over K1's plain version, on any device."""
    surv = tuple(survivors[:k])
    w = rs.device_decode_weights(k, n, surv, tuple(targets), shards.device)
    return rs.gf2_matmul_plain(shards[:, list(surv), :].contiguous(), w,
                               len(targets))


def reconstruct_with_digests_plain(shards: torch.Tensor, k: int, n: int,
                                   survivors: tuple[int, ...],
                                   targets: tuple[int, ...],
                                   chunk_lens: torch.Tensor | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """reconstruct_with_digests over the plain versions of K1 and K2."""
    b, _, s = shards.shape
    t = len(targets)
    if chunk_lens is None:
        chunk_lens = torch.full((b,), s, dtype=torch.int32, device=shards.device)
    rebuilt = reconstruct_only_plain(shards, k, n, survivors, targets)
    digs = mxsum.digest_plain(rebuilt.reshape(b * t, s),
                              chunk_lens.repeat_interleave(t))
    return rebuilt, digs.reshape(b, t, mxsum.DIGEST_LEN)


def reconstruct_multi_digests(data: torch.Tensor, weights: torch.Tensor,
                              lens: torch.Tensor, out_shards: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The dataplane's heal lane (minio_tpu/dataplane/ring.py:196-205):
    data [R, k, W] u8 survivor-compacted, weights [R, k*8, t*8] int8 (each
    row its own decode matrix), lens [R] int32 -> (rebuilt [R, t, W],
    digests [R, t, 32] of each rebuilt chunk's lens[r] bytes)."""
    rebuilt = rs.gf2_matmul_multi(data, weights, out_shards)
    r, t, w = rebuilt.shape
    digs = mxsum.digest(rebuilt.reshape(r * t, w), lens.repeat_interleave(t))
    return rebuilt, digs.reshape(r, t, mxsum.DIGEST_LEN)


def device_digest(algorithm: str):
    """The batched digest entry point of a device bitrot algorithm:
    chunks [N, S] u8, lens [N] int32 -> [N, 32] u8 (on CUDA, K2 for
    mxsum256, K3 for mxhash256)."""
    if algorithm == "mxsum256":
        return verify_digests
    if algorithm == "mxhash256":
        return mxhash.mxhash256
    raise ValueError(f"{algorithm} is not a device bitrot algorithm")


@_observed("verify_digests")
def verify_digests(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched read-path verify: chunks [N, S] u8 (zero-padded rows), lens
    [N] int32 -> digests [N, 32] u8, compared by the caller with the
    stored record digests."""
    return mxsum.digest(chunks, lens)


def digest_chunks_host(chunks: list, cap: int, device="cuda") -> list[bytes]:
    """mxsum256 digests of a ragged list of byte chunks (each <= cap) in
    one launch on `device`."""
    return stage_and_digest(chunks, cap, device, verify_digests)


def stage_and_digest(chunks: list, cap: int, device, digest) -> list[bytes]:
    """Stage a ragged list of byte chunks (each <= cap) as one [rows, cap]
    batch and digest it in one launch of `digest(chunks, lens)` on
    `device`. Rows pad to a power of two, as in the JAX package, with
    zeros past each chunk. The staging tensors come from the pinned pool
    (utils/bufpool.py) when the device is CUDA, so the upload is one DMA
    and no GET batch page-locks a buffer of its own; they go back once
    the copies reading them completed."""
    device = resolve(device)
    n = bucket_rows(len(chunks))
    pinned = device.type == "cuda"
    batch = bufpool.GLOBAL_POOL.get((n, cap), torch.uint8, pinned)
    lens = bufpool.GLOBAL_POOL.get((n,), torch.int32, pinned)
    copied = None
    try:
        arr, larr = batch.numpy(), lens.numpy()
        for i, c in enumerate(chunks):
            arr[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
            arr[i, len(c):] = 0
            larr[i] = len(c)
        arr[len(chunks):] = 0
        larr[len(chunks):] = 0
        dev_batch = batch.to(device, non_blocking=True)
        dev_lens = lens.to(device, non_blocking=True)
        if pinned:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(device))
        got = digest(dev_batch, dev_lens).cpu().numpy()
    finally:
        bufpool.GLOBAL_POOL.put(batch, copied)
        bufpool.GLOBAL_POOL.put(lens, copied)
    return [got[i].tobytes() for i in range(len(chunks))]
