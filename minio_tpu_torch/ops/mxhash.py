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

The chain is linear over GF(2). With K = [SK; DK] (state rows, then
block rows), state_{i+1} = state_i·SK ⊕ D_i where D_i = (block_i·DK) mod 2
does not depend on the chain, so state_nb = ⊕_i D_i·SK^(nb-1-i): every
block's data term at once, then a log-depth combine with the powers
SK^(2^l) (`sk_powers`, pinned by POWERS_SHA256).

Implementations of the same function:
- `mxhash256_plain`: plain PyTorch over a batch with a length per row,
  one step per block as the definition reads, on the CPU or the card;
- `mxhash256_split_plain`: plain PyTorch of the split form (every block's
  data term as one product, then the tree combine);
- `mxhash256`: the entry point — for a CUDA tensor the hand-written kernel
  K3 (csrc/mxhash256.cu, the split form on the tensor cores, replacing the
  JAX package's lax.scan) or an error, for a CPU tensor `mxhash256_plain`;
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

from minio_tpu_torch.obs import kernel as obs_kernel
from minio_tpu_torch.ops import kernels, rs
from minio_tpu_torch.ops.mxsum import check_key
from minio_tpu_torch.utils.device import upload

BLOCK_BYTES = 512               # one compression block
BLOCK_BITS = BLOCK_BYTES * 8
STATE_BITS = 256
DIGEST_LEN = 32
KEY_WORDS = (STATE_BITS + BLOCK_BITS) // 64   # 68 uint64 per key column
POWER_LEVELS = 9                # SK^(2^l), l < 9: a 257-block chunk's tree
GROUP_BLOCKS = 4                # K3 folds 4 blocks into one term by its key
SPLIT_BLOCKS = 32               # block columns the split plain version expands at once

# SHA-256 of _key_matrix() as the JAX package derives it (uint8 [4352, 256],
# C order). NumPy does not promise PCG64's stream across versions.
KEY_SHA256 = "dfeedd5df9a4b42caab6d7ef308eb081f946879163a2485bfe088ddb8ef9f518"
# SHA-256 of sk_powers() (uint8 [9, 256, 256], C order).
POWERS_SHA256 = "5af5492c213bc605f8643a819fd345dcad51463334bafe37f55ecdb0efe98465"


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


@functools.lru_cache(maxsize=1)
def sk_powers() -> np.ndarray:
    """SK^(2^l) over GF(2) for l < POWER_LEVELS, uint8 [9, 256, 256]: each
    the square of the one before, pinned by POWERS_SHA256."""
    p = _key_matrix()[:STATE_BITS].astype(np.int64)
    table = [p]
    for _ in range(1, POWER_LEVELS):
        p = (p @ p) & 1
        table.append(p)
    out = np.stack(table).astype(np.uint8)
    check_key("mxhash256 state-key powers", out, POWERS_SHA256)
    return out


def _gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b over GF(2) for 0/1 uint8 matrices (float32 sums of at most
    2^24 ones are exact)."""
    return np.remainder(a.astype(np.float32) @ b.astype(np.float32), 2).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def sk_power(level: int) -> np.ndarray:
    """SK^(2^level) over GF(2), uint8 [256, 256]: the pinned table, squared
    further above it."""
    if level < POWER_LEVELS:
        return sk_powers()[level]
    p = sk_power(level - 1)
    return _gf2_matmul(p, p)


@functools.lru_cache(maxsize=1)
def group_keys() -> np.ndarray:
    """DK SK^v for v < GROUP_BLOCKS, uint8 [4, 4096, 256]. A group (4 blocks
    of a chunk counted from its end, the first group of a chunk padded with
    zero blocks in front) contributes [bits of the group] @
    [DK SK^3; DK SK^2; DK SK; DK] to the state, and the group g groups from
    the end is then multiplied by SK^(4 g)."""
    keys = [_key_matrix()[STATE_BITS:]]
    for _ in range(1, GROUP_BLOCKS):
        keys.append(_gf2_matmul(keys[-1], _key_matrix()[:STATE_BITS]))
    return np.stack(keys)


def tile_key() -> np.ndarray:
    """K3's group-term key: the stacked [DK SK^3; ...; DK] as 0/1 bytes in
    the tensor cores' shared-memory tiles, uint8 [32, 4, 256, 128] (4 MiB),
    indexed [slice s, k-block kb, output bit n, byte]: byte kk of row n is
    stored at 16 ((kk // 16) ^ (n % 8)) + kk % 16, and holds
    (DK SK^(3 - s // 8))[8 (64 (s % 8) + 4 ks + e) + b, n] with
    ks = 4 kb + kk // 32, b = (kk % 32) // 4, e = kk % 4.

    K3 cuts a group's 2 KiB in 32 slices of 64 bytes (slice s is bytes
    64 (s % 8) .. of the group's block s // 8) and a slice in 16 k-steps of
    4 bytes; k = 4 b + e of a step is bit b of its byte e. The B operand of
    4 k-steps is 256 rows (output bits) of 128 bytes, K-major, with the
    tensor cores' 128-byte swizzle (16-byte chunk c of row n at c ^ (n % 8))."""
    keys = group_keys()
    gb = GROUP_BLOCKS
    s, kb, n, kk = np.ix_(np.arange(8 * gb), np.arange(4), np.arange(256), np.arange(128))
    ks, b, e = 4 * kb + kk // 32, (kk % 32) // 4, kk % 4
    logical = keys[gb - 1 - s // 8, 8 * (64 * (s % 8) + 4 * ks + e) + b, n]
    out = np.empty_like(logical)
    pos = 16 * ((kk // 16) ^ (n % 8)) + kk % 16
    np.put_along_axis(out, np.broadcast_to(pos, logical.shape), logical, axis=3)
    return np.ascontiguousarray(out)


def combine_columns() -> np.ndarray:
    """K3's combine powers: SK^(4 * 2^l) = SK^(2^(l+2)) for l < 9 by
    columns, uint32 [9, 256, 8]: bit p of word q of column c of power l is
    SK^(4 * 2^l)[32 q + p, c]. The last, SK^1024, is the pinned table's
    SK^256 squared twice."""
    level = GROUP_BLOCKS.bit_length() - 1
    cols = np.stack([sk_power(level + l).T for l in range(POWER_LEVELS)])
    packed = np.packbits(cols, axis=2, bitorder="little")            # [9, 256, 32]
    return np.ascontiguousarray(packed).view("<u4")


_dev_mu = threading.Lock()
_dev_keys: dict[tuple[torch.device, str], torch.Tensor] = {}


def _device_key(device: torch.device, form: str) -> torch.Tensor:
    """A key form cached on `device`: "tiles" (K3's group-term key, uint8
    [4 MiB]), "powers" (K3's combine columns, int32 [9, 256, 8]) or
    "float" (the plain versions' key, float32 [4352, 256])."""
    with _dev_mu:
        have = _dev_keys.get((device, form))
        if have is None:
            host = {"tiles": lambda: tile_key().reshape(-1),
                    "powers": lambda: combine_columns().view(np.int32),
                    "float": lambda: _key_matrix().astype(np.float32)}[form]()
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


def _power(level: int, device: torch.device) -> torch.Tensor:
    """SK^(2^level) as float32 [256, 256] on `device`."""
    return torch.from_numpy(sk_power(level)).to(device=device, dtype=torch.float32)


def mxhash256_split_plain(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch of the split form, same arguments and result as
    `mxhash256_plain`: D = (bits of every block @ DK) mod 2 (float32,
    exact: sums of at most 4096 ones), then per row the terms
    E_j = D_(nb-1-j) folded pairwise, level l taking E_2j ⊕ E_2j+1·SK^(2^l),
    until one term, the state, is left. Block columns are expanded to bits
    SPLIT_BLOCKS at a time."""
    n, _ = chunks.shape
    dev = chunks.device
    if n == 0:
        return torch.empty((0, DIGEST_LEN), dtype=torch.uint8, device=dev)
    dk = _device_key(dev, "float")[STATE_BITS:]
    msg, nb = _padded_messages(chunks, lens)
    nbmax = msg.shape[1] // BLOCK_BYTES
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    d = torch.empty((n, nbmax, STATE_BITS), dtype=torch.float32, device=dev)
    for i0 in range(0, nbmax, SPLIT_BLOCKS):
        i1 = min(i0 + SPLIT_BLOCKS, nbmax)
        part = msg[:, i0 * BLOCK_BYTES:i1 * BLOCK_BYTES]
        bits = ((part.reshape(n, i1 - i0, BLOCK_BYTES, 1) >> shifts) & 1)
        d[:, i0:i1] = torch.remainder(
            bits.reshape(-1, BLOCK_BITS).to(torch.float32) @ dk, 2
        ).reshape(n, i1 - i0, STATE_BITS)
    j = torch.arange(nbmax, device=dev)
    idx = (nb.unsqueeze(1) - 1 - j).clamp(min=0)
    terms = torch.gather(d, 1, idx.unsqueeze(2).expand(-1, -1, STATE_BITS))
    terms = terms * (j < nb.unsqueeze(1)).unsqueeze(2).to(torch.float32)
    level = 0
    while terms.shape[1] > 1:
        if terms.shape[1] % 2:
            terms = torch.nn.functional.pad(terms, (0, 0, 0, 1))
        terms = torch.remainder(terms[:, 0::2] + terms[:, 1::2] @ _power(level, dev), 2)
        level += 1
    state = terms[:, 0]
    packed = state.to(torch.int64).reshape(n, DIGEST_LEN, 8) << shifts.to(torch.int64)
    return packed.sum(-1).to(torch.uint8)


# --- the kernel -----------------------------------------------------------


def mxhash256(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched digest: chunks [N, S] u8, lens [N] int32 (each <= S) ->
    [N, 32] u8. On the card one call runs K3's two kernels (the group
    terms, then the combine) and counts one launch."""
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
    if n * -(-_pad_blocks(s) // GROUP_BLOCKS) >= 1 << 31:
        raise ValueError(f"{n} rows of {s} bytes: more than 2^31 groups for one launch")
    # A stride along a dimension of size 0 or 1 is never used.
    if (s > 1 and chunks.stride(1) != 1) or not lens.is_contiguous():
        raise ValueError("chunks rows and lens must be contiguous")
    out = torch.empty((n, DIGEST_LEN), dtype=torch.uint8, device=chunks.device)
    if n == 0:
        return out
    key = _device_key(chunks.device, "tiles")
    powers = _device_key(chunks.device, "powers")
    stream = torch.cuda.current_stream(chunks.device)
    # The cached keys were allocated on whatever stream first asked for them.
    key.record_stream(stream)
    powers.record_stream(stream)
    # The 128 slices' partial group terms, written by the first kernel and
    # read by the second, both on this stream.
    part = torch.empty(lib.mtpu_mxhash256_scratch_bytes(n, s), dtype=torch.uint8,
                       device=chunks.device)
    begin = obs_kernel.device_begin(stream)
    kernels.check(lib.mtpu_mxhash256(chunks.data_ptr(), chunks.stride(0), s,
                                     lens.data_ptr(), key.data_ptr(),
                                     powers.data_ptr(), part.data_ptr(),
                                     out.data_ptr(), n, stream.cuda_stream),
                  "mxhash256")
    obs_kernel.device_end(begin, stream)
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
