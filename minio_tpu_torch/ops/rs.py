"""Batched Reed-Solomon encode/reconstruct as GF(2) bit-matrix contractions.

Counterpart of minio_tpu/ops/rs_xla.py and rs_pallas.py. One function
serves encode (W = gf.encode_bitmatrix) and reconstruct (W =
gf.decode_bitmatrix for the failure pattern):

    out[b, t, s] = bits(x[b, :, s]) @ W   (mod 2), repacked to bytes

`gf2_matmul` is the entry point: for a CUDA tensor it launches the
hand-written kernel (csrc/gf2_matmul.cu, which replaces
rs_pallas._gf2_kernel) or raises; for a CPU tensor it runs
`gf2_matmul_plain`, the plain PyTorch version, which chip_smoke.py also
holds the kernel against on the card.

Weight layout everywhere in this module: w [kin*8, tout*8] int8 (0/1), the
gf.expand_to_bitmatrix layout rs_xla uses, or [B, kin*8, tout*8] for
per-block weights (rs_xla.gf2_matmul_multi). Callers holding rs_pallas's
pre-transposed w_t [tout*8, kin*8] transpose it first (ops/fused.py).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from minio_tpu_torch.ops import gf, kernels
from minio_tpu_torch.utils.device import upload

MAX_IN = 32            # kin limit of the kernel (registers per thread)
_SMEM_PER_TJ = 256 + 32 + 8
_SMEM_LIMIT = 232448   # bytes of shared memory a block may use on Hopper


def gf2_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                     out_shards: int) -> torch.Tensor:
    """Plain PyTorch contraction: x [B, kin, S] u8, w [kin*8, t*8] or
    [B, kin*8, t*8] int8 -> [B, t, S] u8.

    On the CPU the bits contract in int32 (torch keeps int8 @ int8 in int8,
    which would overflow). On CUDA, where torch has no integer matmul, in
    float32 with TF32 off: exact, since sums are at most kin*8 <= 2048."""
    b, kin, s = x.shape
    dt = torch.int32 if x.device.type == "cpu" else torch.float32
    shifts = torch.arange(8, device=x.device, dtype=torch.uint8)
    bits = (x.unsqueeze(-1) >> shifts) & 1                         # [B,kin,S,8]
    bits = bits.permute(0, 2, 1, 3).reshape(b, s, kin * 8).to(dt)  # [B,S,kin*8]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.matmul(bits, w.to(dt))                           # [B,S,t*8]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    y = y.to(torch.int32) & 1
    y = y.reshape(b, s, out_shards, 8) << shifts.to(torch.int32)
    return y.sum(dim=3).to(torch.uint8).permute(0, 2, 1).contiguous()


def gf2_matmul(x: torch.Tensor, w: torch.Tensor, out_shards: int) -> torch.Tensor:
    """GF(2) contraction with runtime weights (shared [kin*8, t*8] or
    per-block [B, kin*8, t*8]): x [B, kin, S] u8 -> [B, t, S] u8."""
    if x.device.type == "cpu":
        return gf2_matmul_plain(x, w, out_shards)
    lib = kernels.library()
    if x.dim() != 3 or x.dtype != torch.uint8 or not x.is_cuda:
        raise ValueError(f"x must be a [B, kin, S] uint8 CUDA tensor, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    b, kin, s = x.shape
    t = out_shards
    if w.dtype != torch.int8 or w.device != x.device:
        raise ValueError("w must be int8 on x's device")
    if w.dim() == 2 and tuple(w.shape) == (kin * 8, t * 8):
        stride = 0
    elif w.dim() == 3 and tuple(w.shape) == (b, kin * 8, t * 8):
        stride = kin * 8 * t * 8
    else:
        raise ValueError(f"w shape {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)} and out_shards={t}")
    if not 1 <= kin <= MAX_IN or t < 1 or t * kin * _SMEM_PER_TJ > _SMEM_LIMIT:
        raise ValueError(f"geometry kin={kin} tout={t} outside the kernel's "
                         "limits")
    if b > 65535:
        raise ValueError(f"batch {b} > 65535 blocks")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    out = torch.empty((b, t, s), dtype=torch.uint8, device=x.device)
    if b == 0 or s == 0:
        return out
    stream = torch.cuda.current_stream(x.device)
    # w may be a cached tensor allocated on another stream (the weight
    # caches below); until this launch has run, its memory must not go to
    # another tensor when the cache drops it.
    w.record_stream(stream)
    kernels.check(lib.mtpu_gf2_matmul(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                      b, kin, t, s, stride, stream.cuda_stream),
                  "gf2_matmul")
    kernels.note_launch("gf2_matmul")
    return out


# --- weight caches (host matrices per geometry / failure pattern) ---


@functools.lru_cache(maxsize=256)
def encode_weights_np(k: int, m: int) -> np.ndarray:
    return np.ascontiguousarray(gf.encode_bitmatrix(k, m), dtype=np.int8)


@functools.lru_cache(maxsize=4096)
def decode_weights_np(k: int, n: int, survivors: tuple[int, ...],
                      targets: tuple[int, ...]) -> np.ndarray:
    return np.ascontiguousarray(
        gf.decode_bitmatrix(k, n, survivors, targets), dtype=np.int8)


@functools.lru_cache(maxsize=256)
def device_encode_weights(k: int, m: int, device: torch.device) -> torch.Tensor:
    """Encode weights resident on `device` (uploaded once per geometry)."""
    return upload(encode_weights_np(k, m), device)


@functools.lru_cache(maxsize=4096)
def device_decode_weights(k: int, n: int, survivors: tuple[int, ...],
                          targets: tuple[int, ...],
                          device: torch.device) -> torch.Tensor:
    return upload(decode_weights_np(k, n, survivors, targets), device)


def encode(data: torch.Tensor, k: int, m: int) -> torch.Tensor:
    """data [B, k, S] u8 -> parity [B, m, S] u8."""
    return gf2_matmul(data, device_encode_weights(k, m, data.device), m)


def reconstruct(shards: torch.Tensor, k: int, n: int,
                survivors: tuple[int, ...],
                targets: tuple[int, ...]) -> torch.Tensor:
    """Rebuild `targets` from any-k `survivors`: shards [B, n, S] u8 with
    the survivor rows meaningful -> [B, t, S] u8."""
    surv = tuple(survivors[:k])
    x = shards[:, list(surv), :].contiguous()
    w = device_decode_weights(k, n, surv, tuple(targets), shards.device)
    return gf2_matmul(x, w, len(targets))


def gf2_matmul_multi(x: torch.Tensor, w: torch.Tensor,
                     out_shards: int) -> torch.Tensor:
    """Per-block weights: x [B, k, S] u8, w [B, k*8, t*8] int8 -> [B, t, S]
    (every block carries its own decode matrix: mixed failure patterns
    rebuild in one launch)."""
    if w.dim() != 3:
        raise ValueError("gf2_matmul_multi takes per-block weights [B, k*8, t*8]")
    return gf2_matmul(x, w, out_shards)
