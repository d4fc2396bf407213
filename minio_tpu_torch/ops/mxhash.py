"""mxhash256 — keyed GF(2) Merkle–Damgård bitrot hash (counterpart of
minio_tpu/ops/mxhash.py).

    state_{i+1} = ( [state_i bits ‖ block_i bits] @ K )  mod 2

K is a keyed [256 + 4096, 256] GF(2) matrix, full rank on its state rows,
derived from BITROT_KEY with numpy's PCG64 exactly as the JAX package
derives it and pinned by its SHA-256 (KEY_SHA256). Blocks are 512 bytes;
a chunk of len bytes is followed by a 0x80 terminator, zeros, and its bit
length as 8 little-endian bytes ending the last block, so it hashes in
ceil((len + 9) / 512) blocks. Bits are LSB-first within each byte; the
state starts at zero and is packed LSB-first into the 32-byte digest.

Implementations of the same function:
- `mxhash256_plain`: plain PyTorch over a batch with a length per row,
  on the CPU or the card;
- `mxhash256`: the entry point — for a CUDA tensor the hand-written kernel
  K3 (csrc/mxhash256.cu, replacing the JAX package's lax.scan) or an
  error, for a CPU tensor `mxhash256_plain`;
- `digest_host`: one chunk of bytes, on the CPU.

Unlike the JAX function, which compiles for one static length, every row
carries its own length, so an object's short last block hashes in the
same launch as its full ones.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from minio_tpu_torch.ops import kernels, rs
from minio_tpu_torch.ops.mxsum import check_key
from minio_tpu_torch.utils.device import upload

BLOCK_BYTES = 512               # one compression block
BLOCK_BITS = BLOCK_BYTES * 8
STATE_BITS = 256
DIGEST_LEN = 32
KEY_WORDS = (STATE_BITS + BLOCK_BITS) // 64   # 68 uint64 per key column

# SHA-256 of _key_matrix() as the JAX package derives it (uint8 [4352, 256],
# C order). NumPy does not promise PCG64's stream across versions.
KEY_SHA256 = "dfeedd5df9a4b42caab6d7ef308eb081f946879163a2485bfe088ddb8ef9f518"


@functools.lru_cache(maxsize=1)
def _key_matrix() -> np.ndarray:
    """Keyed [STATE_BITS + BLOCK_BITS, STATE_BITS] GF(2) matrix with the
    state block guaranteed invertible (keeps the chain a permutation of
    the state for fixed data)."""
    from minio_tpu_torch.ops.bitrot import BITROT_KEY

    seed = int.from_bytes(BITROT_KEY[:8], "little")
    rng = np.random.Generator(np.random.PCG64(seed))
    while True:
        sk = rng.integers(0, 2, (STATE_BITS, STATE_BITS), dtype=np.uint8)
        if _gf2_rank(sk.copy()) == STATE_BITS:
            break
    dk = rng.integers(0, 2, (BLOCK_BITS, STATE_BITS), dtype=np.uint8)
    key = np.concatenate([sk, dk], axis=0)
    check_key("mxhash256 key", key, KEY_SHA256)
    return key


def _gf2_rank(m: np.ndarray) -> int:
    rank = 0
    rows, cols = m.shape
    for c in range(cols):
        piv = None
        for r in range(rank, rows):
            if m[r, c]:
                piv = r
                break
        if piv is None:
            continue
        m[[rank, piv]] = m[[piv, rank]]
        mask = m[:, c].copy()
        mask[rank] = 0
        m ^= np.outer(mask, m[rank])
        rank += 1
    return rank


def _pad_blocks(n_bytes: int) -> int:
    """Blocks after terminator+length padding."""
    padded = n_bytes + 1 + 8
    return -(-padded // BLOCK_BYTES)


def packed_key() -> np.ndarray:
    """K3's key layout: [68, 256] uint64, word w of column c holding
    K[64w .. 64w+63, c] with bit p = K[64w + p, c]."""
    cols = np.ascontiguousarray(
        np.packbits(_key_matrix().T, axis=1, bitorder="little"))     # [256, 544]
    return np.ascontiguousarray(cols.view("<u8").T)                  # [68, 256]


_dev_mu = threading.Lock()
_dev_keys: dict[tuple[torch.device, str], torch.Tensor] = {}


def _device_key(device: torch.device, form: str) -> torch.Tensor:
    """The key cached on `device`: "packed" (K3's, int64 [68, 256]) or
    "float" (the plain version's, float32 [4352, 256])."""
    with _dev_mu:
        have = _dev_keys.get((device, form))
        if have is None:
            host = (packed_key().view(np.int64) if form == "packed"
                    else _key_matrix().astype(np.float32))
            have = _dev_keys[(device, form)] = upload(host, device)
        return have


# --- plain PyTorch --------------------------------------------------------


def _padded_messages(chunks: torch.Tensor, lens: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """chunks [N, S] u8, lens [N] -> (messages [N, nb_max * 512] u8, each
    row its len bytes, the terminator, zeros and the bit length ending its
    own last block; nb [N] int64 blocks per row)."""
    n, s = chunks.shape
    dev = chunks.device
    ln = lens.to(torch.int64)
    nb = (ln + 9 + BLOCK_BYTES - 1) // BLOCK_BYTES
    total = int(nb.max()) * BLOCK_BYTES if n else 0
    msg = torch.zeros((n, total), dtype=torch.uint8, device=dev)
    w = min(s, total)
    keep = torch.arange(w, device=dev) < ln.unsqueeze(1)
    msg[:, :w] = torch.where(keep, chunks[:, :w], torch.zeros((), dtype=torch.uint8,
                                                               device=dev))
    rows = torch.arange(n, device=dev)
    msg[rows, ln] = 0x80
    end = nb * BLOCK_BYTES
    bitlen = ln * 8
    for j in range(8):
        msg[rows, end - 8 + j] = ((bitlen >> (8 * j)) & 0xFF).to(torch.uint8)
    return msg, nb


def mxhash256_plain(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch mxhash256: chunks [N, S] u8, lens [N] int32 (each
    <= S; bytes past a row's length are ignored) -> [N, 32] u8.

    One [N, 4352] @ [4352, 256] product per block step, rows whose chain
    has ended keeping their state. The product is in float32, on the CPU
    and on the card, and exact: every entry is 0 or 1, so each sum is an
    integer of at most 4352 < 2^24 (TF32, where enabled, keeps 0 and 1
    exact too and accumulates in float32)."""
    n, _ = chunks.shape
    dev = chunks.device
    key = _device_key(dev, "float")
    msg, nb = _padded_messages(chunks, lens)
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    state = torch.zeros((n, STATE_BITS), dtype=torch.float32, device=dev)
    for i in range(msg.shape[1] // BLOCK_BYTES):
        block = msg[:, i * BLOCK_BYTES:(i + 1) * BLOCK_BYTES]
        bits = ((block.unsqueeze(-1) >> shifts) & 1).reshape(n, BLOCK_BITS)
        y = torch.cat([state, bits.to(torch.float32)], dim=1) @ key
        state = torch.where((i < nb).unsqueeze(1), torch.remainder(y, 2), state)
    packed = state.to(torch.int64).reshape(n, DIGEST_LEN, 8) << shifts.to(torch.int64)
    return packed.sum(-1).to(torch.uint8)


# --- the kernel -----------------------------------------------------------


def mxhash256(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched digest: chunks [N, S] u8, lens [N] int32 (each <= S) ->
    [N, 32] u8."""
    if chunks.device.type == "cpu":
        return mxhash256_plain(chunks, lens)
    lib = kernels.library()
    if chunks.dim() != 2 or chunks.dtype != torch.uint8 or not chunks.is_cuda:
        raise ValueError(f"chunks must be a [N, S] uint8 CUDA tensor, got "
                         f"{tuple(chunks.shape)} {chunks.dtype} on {chunks.device}")
    n, s = chunks.shape
    if lens.dtype != torch.int32 or tuple(lens.shape) != (n,) \
            or lens.device != chunks.device:
        raise ValueError("lens must be int32 [N] on the chunks' device")
    if n >= 1 << 31:
        raise ValueError(f"{n} rows > the kernel's grid limit")
    # A stride along a dimension of size 0 or 1 is never used.
    if (s > 1 and chunks.stride(1) != 1) or not lens.is_contiguous():
        raise ValueError("chunks rows and lens must be contiguous")
    out = torch.empty((n, DIGEST_LEN), dtype=torch.uint8, device=chunks.device)
    if n == 0:
        return out
    key = _device_key(chunks.device, "packed")
    stream = torch.cuda.current_stream(chunks.device)
    # The cached key was allocated on whatever stream first asked for it.
    key.record_stream(stream)
    kernels.check(lib.mtpu_mxhash256(chunks.data_ptr(), chunks.stride(0),
                                     lens.data_ptr(), key.data_ptr(),
                                     out.data_ptr(), n, stream.cuda_stream),
                  "mxhash256")
    kernels.note_launch("mxhash256")
    return out


def digest_host(data) -> bytes:
    """Digest of one chunk of bytes, on the CPU (the registry's host entry
    point)."""
    arr = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).copy())[None, :]
    lens = torch.tensor([arr.shape[1]], dtype=torch.int32)
    return mxhash256_plain(arr, lens)[0].numpy().tobytes()


# --- fused erasure encode + bitrot ------------------------------------------


def encode_with_bitrot(data: torch.Tensor, k: int, m: int,
                       chunk_lens: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """data [B, k, S] u8 -> (parity [B, m, S] u8, digests [B, k+m, 32] u8):
    K1, then one K3 launch over all B * (k+m) shard chunks, each hashed
    over chunk_lens[b] bytes ([B] int32, default S). The digests are the
    [digest][chunk] records of the shard files."""
    b, _, s = data.shape
    n = k + m
    if chunk_lens is None:
        chunk_lens = torch.full((b,), s, dtype=torch.int32, device=data.device)
    parity = rs.encode(data, k, m)
    shards = torch.cat([data, parity], dim=1)                 # [B, n, S]
    digs = mxhash256(shards.reshape(b * n, s), chunk_lens.repeat_interleave(n))
    return parity, digs.reshape(b, n, DIGEST_LEN)


class MXHash256:
    """Bitrot registry adapter (ops/bitrot.py): the host digest."""

    digest_len = DIGEST_LEN

    @staticmethod
    def digest(data) -> bytes:
        return digest_host(data)
