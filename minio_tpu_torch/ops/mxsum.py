"""mxsum256 — keyed linear bitrot checksum (counterpart of minio_tpu/ops/mxsum.py).

    digest_c = sum_i int8(data_i) * K[i, c]  +  sum_j len_le[j] * L[j, c]   (mod 2^32)

for c = 0..7 (eight little-endian uint32 words, 32 bytes). K is an
unbounded keyed stream of int8 rows and L a fixed int8 length key, both
derived from BITROT_KEY with numpy's PCG64 exactly as the JAX package
derives them (byte-identical streams; tests/test_torch_mxsum.py holds
them equal, and KEY_SHA256 / LEN_KEY_SHA256 pin them wherever they are
derived). Zero padding is free, so a chunk hashes identically under any
staging width and the length rides in as data.

Three implementations of the same function:
- `digest_np`: host numpy over one chunk (exact int64, then mod 2^32);
- `digest_plain`: plain PyTorch on tensors (int64 on the CPU; float64 on
  CUDA, exact because every partial sum stays below 2^53);
- `digest`: the entry point — for a CUDA tensor the hand-written kernel
  (csrc/mxsum_digest.cu, replacing the XLA digest_device) or an error,
  for a CPU tensor `digest_plain`.
"""

from __future__ import annotations

import functools
import hashlib
import threading

import numpy as np
import torch

from minio_tpu_torch.ops import kernels
from minio_tpu_torch.utils.device import upload

DIGEST_LEN = 32
COLS = 8  # uint32 words per digest

_KEY_CHUNK = 1 << 16  # K-stream generation granularity (rows)

# SHA-256 of the first K chunk (rows 0..65535, int8) and of the length key
# as the JAX package derives them. NumPy does not promise PCG64's integer
# stream across versions; a digest under another stream would pass every
# check on one machine and be unreadable by the JAX package. Every K chunk
# comes from the same generator call under its own seed, so a changed
# stream shows in the first.
KEY_SHA256 = "d936f9959c13e19474fcfdaf7c5cf0623c5c8c50087c999e349b2e80006e6b0e"
LEN_KEY_SHA256 = "fcd229e5e44d90262a38b39342a36d65a0eca6405a3088232ab39daa58e4ff2c"


class KeyMismatch(RuntimeError):
    """numpy derived a key other than the JAX package's."""


def check_key(name: str, key: np.ndarray, want: str) -> None:
    got = hashlib.sha256(np.ascontiguousarray(key).tobytes()).hexdigest()
    if got != want:
        raise KeyMismatch(f"{name}: numpy {np.__version__} derived a key of "
                          f"SHA-256 {got}, not the pinned {want}")


_key_lock = threading.Lock()
_key_i8 = np.zeros((0, COLS), dtype=np.int8)
_key_i64 = np.zeros((0, COLS), dtype=np.int64)


def _grow_key(n_rows: int) -> None:
    global _key_i8, _key_i64
    from minio_tpu_torch.ops.bitrot import BITROT_KEY

    seed = int.from_bytes(BITROT_KEY[8:16], "little") ^ 0x6D78_73756D  # "mxsum"
    with _key_lock:
        have = _key_i8.shape[0]
        if have >= n_rows:
            return
        n_chunks = -(-n_rows // _KEY_CHUNK)
        parts = [_key_i8]
        for ci in range(have // _KEY_CHUNK, n_chunks):
            rng = np.random.Generator(np.random.PCG64(seed + ci))
            parts.append(rng.integers(-128, 128, (_KEY_CHUNK, COLS), dtype=np.int8))
            if ci == 0:
                check_key("mxsum256 key", parts[-1], KEY_SHA256)
        _key_i8 = np.concatenate(parts, axis=0)
        _key_i64 = _key_i8.astype(np.int64)


def _key_rows(n_rows: int) -> np.ndarray:
    """First n_rows of the keyed int8 stream K, shape [n_rows, 8]. K[:a] is
    always a prefix of K[:b]: a chunk's digest must not depend on the cap
    it was hashed under."""
    if _key_i8.shape[0] < n_rows:
        _grow_key(n_rows)
    return _key_i8[:n_rows]


def _key_rows_i64(n_rows: int) -> np.ndarray:
    if _key_i64.shape[0] < n_rows:
        _grow_key(n_rows)
    return _key_i64[:n_rows]


@functools.lru_cache(maxsize=1)
def _len_key() -> np.ndarray:
    from minio_tpu_torch.ops.bitrot import BITROT_KEY

    seed = int.from_bytes(BITROT_KEY[16:24], "little") ^ 0x6C656E
    rng = np.random.Generator(np.random.PCG64(seed))
    key = rng.integers(-128, 128, (8, COLS), dtype=np.int8)
    check_key("mxsum256 length key", key, LEN_KEY_SHA256)
    return key


# --- host (numpy) -------------------------------------------------------


def digest_np(data) -> bytes:
    """Host digest of one chunk (numpy, exact)."""
    arr = (np.frombuffer(data, dtype=np.uint8)
           if isinstance(data, (bytes, bytearray, memoryview)) else data)
    s = arr.size
    if s:
        acc = arr.astype(np.int8).astype(np.int64) @ _key_rows_i64(s)
    else:
        acc = np.zeros(COLS, np.int64)
    lrow = np.frombuffer(np.uint64(s).tobytes(), dtype=np.uint8)
    acc = acc + lrow.astype(np.int8).astype(np.int64) @ _len_key().astype(np.int64)
    return (acc & 0xFFFFFFFF).astype("<u4").tobytes()


# --- tensors --------------------------------------------------------------


def _len_bytes(lens: torch.Tensor) -> torch.Tensor:
    """lens [N] (< 2^32) -> its 4 little-endian bytes as int8 [N, 4]."""
    shifts = torch.arange(0, 32, 8, device=lens.device, dtype=torch.int64)
    by = (lens.to(torch.int64).unsqueeze(-1) >> shifts) & 0xFF
    return by.to(torch.uint8).view(torch.int8)


def _pack_words(acc: torch.Tensor) -> torch.Tensor:
    """acc [N, 8] int64 (any value) -> [N, 32] u8, words mod 2^32 LE."""
    shifts = torch.arange(0, 32, 8, device=acc.device, dtype=torch.int64)
    by = ((acc & 0xFFFFFFFF).unsqueeze(-1) >> shifts) & 0xFF     # [N, 8, 4]
    return by.to(torch.uint8).reshape(acc.shape[0], DIGEST_LEN)


def digest_plain(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch digest: chunks [N, S] u8 (zero-padded past each row's
    length), lens [N] int32 -> [N, 32] u8. Contracts in int64 on the CPU;
    on CUDA, which has no integer matmul in torch, in float64 (exact: every
    sum is below 2^53)."""
    n, s = chunks.shape
    dev = chunks.device
    dt = torch.int64 if dev.type == "cpu" else torch.float64
    lkey = torch.from_numpy(_len_key()[:4].astype(np.int64)).to(dev, dt)
    acc = (_len_bytes(lens).to(dt) @ lkey)
    if s:
        key = torch.from_numpy(_key_rows_i64(s)).to(dev, dt)
        acc = acc + chunks.view(torch.int8).to(dt) @ key
    return _pack_words(acc.to(torch.int64))


KEY_ALIGN = 64  # columns: the kernel reads the key in 16-byte loads


def key_capacity(s: int, have: int) -> int:
    """Columns of the transposed device key that serve width s, given a
    key of `have` columns: `have` itself when it is wide enough, else the
    larger of twice it and s, rounded up to KEY_ALIGN (never 0)."""
    if have >= s and have:
        return have
    need = max(s, 2 * have, 1)
    return -(-need // KEY_ALIGN) * KEY_ALIGN


def transposed_key(cols: int) -> np.ndarray:
    """K[:cols] transposed: [8, cols] int8, row c the column c of the key
    stream. Prefix-stable as the stream is: transposed_key(a) is
    transposed_key(b)[:, :a] for a <= b."""
    return np.ascontiguousarray(_key_rows(cols).T)


_dev_mu = threading.Lock()
_dev_key: dict[torch.device, torch.Tensor] = {}


def device_key(s: int, device: torch.device) -> torch.Tensor:
    """K[:s] transposed, [8, s] int8 on `device`: a view of the first s
    columns of one [8, cap] tensor per device (row stride cap, a multiple
    of KEY_ALIGN), grown as key_capacity says. A replaced tensor is freed
    once the launches that `digest` recorded on it have run."""
    with _dev_mu:
        have = _dev_key.get(device)
        cap = key_capacity(s, have.shape[1] if have is not None else 0)
        if have is None or have.shape[1] != cap:
            have = upload(transposed_key(cap), device)
            _dev_key[device] = have
        return have[:, :s]


@functools.lru_cache(maxsize=8)
def device_len_key(device: torch.device) -> torch.Tensor:
    return upload(_len_key()[:4], device)


_work_mu = threading.Lock()
_work: dict[tuple[torch.device, int], torch.Tensor] = {}


def _workspace(n: int, stream: torch.cuda.Stream, lib) -> torch.Tensor:
    """The zeroed workspace of `stream`. Every launch leaves it zero when
    it ends, and launches on one stream run in order, so one per stream
    serves them all; it is allocated on that stream (the caller's current
    one) and so freed in its order when a larger one replaces it."""
    words = lib.mtpu_mxsum_workspace_words(n)
    key = (stream.device, stream.cuda_stream)
    with _work_mu:
        have = _work.get(key)
        if have is None or have.numel() < words:
            size = max(words, 2 * (have.numel() if have is not None else 0))
            have = torch.zeros(size, dtype=torch.int32, device=stream.device)
            _work[key] = have
        return have


def digest(chunks: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Batched digest: chunks [N, S] u8 (zero-padded past each row's
    length), lens [N] int32 (< 2^32) -> [N, 32] u8."""
    if chunks.device.type == "cpu":
        return digest_plain(chunks, lens)
    lib = kernels.library()
    if chunks.dim() != 2 or chunks.dtype != torch.uint8 or not chunks.is_cuda:
        raise ValueError(f"chunks must be a [N, S] uint8 CUDA tensor, got "
                         f"{tuple(chunks.shape)} {chunks.dtype} on {chunks.device}")
    n, s = chunks.shape
    if lens.dtype != torch.int32 or tuple(lens.shape) != (n,) \
            or lens.device != chunks.device:
        raise ValueError("lens must be int32 [N] on the chunks' device")
    if n > 65535 * 16:
        raise ValueError(f"{n} rows > the kernel's grid limit")
    if not (chunks.is_contiguous() and lens.is_contiguous()):
        raise ValueError("chunks and lens must be contiguous")
    out = torch.empty((n, DIGEST_LEN), dtype=torch.uint8, device=chunks.device)
    if n == 0:
        return out
    key = device_key(s, chunks.device)
    lkey = device_len_key(chunks.device)
    stream = torch.cuda.current_stream(chunks.device)
    work = _workspace(n, stream, lib)
    # The cached keys were allocated on whatever stream first asked for
    # them, and device_key frees a key when a wider one replaces it: until
    # this launch has run, their memory must not go to another tensor.
    key.record_stream(stream)
    lkey.record_stream(stream)
    kernels.check(lib.mtpu_mxsum_digest(chunks.data_ptr(), lens.data_ptr(),
                                        key.data_ptr(), key.stride(0),
                                        lkey.data_ptr(), out.data_ptr(),
                                        work.data_ptr(), n, s, stream.cuda_stream),
                  "mxsum_digest")
    kernels.note_launch("mxsum_digest")
    return out


class MXSum256:
    """Bitrot registry adapter (ops/bitrot.py): the host digest."""

    digest_len = DIGEST_LEN

    @staticmethod
    def digest(data) -> bytes:
        return digest_np(data)
