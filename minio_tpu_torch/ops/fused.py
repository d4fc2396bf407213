"""Codec + bitrot compositions — the port's device path (counterpart of
minio_tpu/ops/fused.py).

The serving paths call these:

  PutObject  -> encode_with_digests          (erasure/codec.py begin_encode)
  GetObject  -> verify_digests               (batched chunk verify on read)
  Heal       -> reconstruct_weights_digests  (rebuilt shards + digests)

Where the JAX package fuses the GF(2) contraction and the digest into one
XLA launch, the port composes two kernel launches (K1 gf2_matmul, K2
mxsum_digest) on device tensors: parity stays on the device between them,
with no host round trip. K1 takes any shard width, so the 512-lane padding
the Pallas dispatch needs is gone; K2's digests are width-invariant, so
rows zero-padded to a staging width hash as their real length.
"""

from __future__ import annotations

import numpy as np
import torch

from minio_tpu_torch.ops import mxsum, rs
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


def encode_only(data: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """data [B, k, S] u8 -> parity [B, m, S] u8."""
    return rs.encode(data, k, m)


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


def verify_digests(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched read-path verify: chunks [N, S] u8 (zero-padded rows), lens
    [N] int32 -> digests [N, 32] u8, compared by the caller with the
    stored record digests."""
    return mxsum.digest(chunks, lens)


def digest_chunks_host(chunks: list, cap: int, device="cuda") -> list[bytes]:
    """mxsum256 digests of a ragged list of byte chunks (each <= cap) in
    one launch on `device`. Rows pad to a power of two, as in the JAX
    package; the staging buffer is pinned when the device is CUDA, so the
    upload is one DMA."""
    device = resolve(device)
    n = bucket_rows(len(chunks))
    pinned = device.type == "cuda"
    batch = torch.zeros((n, cap), dtype=torch.uint8, pin_memory=pinned)
    lens = torch.zeros(n, dtype=torch.int32, pin_memory=pinned)
    arr, larr = batch.numpy(), lens.numpy()
    for i, c in enumerate(chunks):
        arr[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
        larr[i] = len(c)
    got = verify_digests(batch.to(device, non_blocking=True),
                         lens.to(device, non_blocking=True)).cpu().numpy()
    return [got[i].tobytes() for i in range(len(chunks))]
