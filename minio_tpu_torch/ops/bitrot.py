"""Bitrot protection: checksum registry + the streaming shard-file format.

Same format as minio_tpu/ops/bitrot.py (reference
cmd/bitrot-streaming.go:46-74): a shard file is a sequence of
[digest][chunk] records, one per shard_size chunk, each digest right
before its chunk. `frame_records` writes it, `BitrotReader` reads it.

Registry: `mxsum256` (the device checksum, computed by the codec kernels
on the write path and verified in batched kernel launches on the read
path) and `blake2b256` (keyed BLAKE2b-256, host), which the port only
reads: objects a JAX deployment wrote with it stay readable and healable.
The JAX package's other host algorithms (sip256, highwayhash256, xxh64)
live in its native library, which the port does not carry yet.
"""

from __future__ import annotations

import hashlib
from typing import BinaryIO, Iterable, Iterator

from minio_tpu_torch.utils import errors as se

# Fixed 256-bit bitrot key (same bytes as the JAX package: the keyed
# streams of mxsum256 and blake2b256 derive from it).
BITROT_KEY = bytes.fromhex(
    "6d696e696f5f7470755f626974726f74"  # "minio_tpu_bitrot"
    "5f6b65795f76315f3230323630373239"  # "_key_v1_20260729"
)

WRITE_ALGORITHM = "mxsum256"


class _Blake2b256:
    digest_len = 32

    @staticmethod
    def digest(data) -> bytes:
        return hashlib.blake2b(data, digest_size=32, key=BITROT_KEY).digest()


def _registry() -> dict:
    from minio_tpu_torch.ops.mxsum import MXSum256

    return {"mxsum256": MXSum256, "blake2b256": _Blake2b256}


def device_default_algorithm() -> str:
    """The algorithm the port writes. The JAX package picks mxsum256 on an
    accelerator and a native host hash on the CPU; the port has no native
    host lane, so it writes mxsum256 on CUDA and on the CPU alike (there
    through the plain PyTorch digest)."""
    return WRITE_ALGORITHM


def get_algorithm(name: str):
    try:
        return _registry()[name]
    except KeyError:
        raise se.CorruptedFormat(f"unknown bitrot algorithm {name!r}") from None


def digest_len(algorithm: str) -> int:
    return get_algorithm(algorithm).digest_len


def bitrot_shard_file_size(data_size: int, shard_size: int, algorithm: str) -> int:
    """On-disk size of a shard file holding data_size shard bytes
    (cmd/bitrot.go:140-145)."""
    if data_size == 0:
        return 0
    n_chunks = -(-data_size // shard_size)
    return data_size + n_chunks * digest_len(algorithm)


def frame_records(records: Iterable[tuple[bytes, bytes]]) -> Iterator[bytes]:
    """The shard-file writer: the byte stream of (digest, chunk) records,
    each digest right before its chunk (digests come from the device
    codec, or from a host algorithm). Yields the pieces unconcatenated, so
    no chunk is copied on its way to the file."""
    for digest, chunk in records:
        yield digest
        yield chunk


class BitrotReader:
    """Reader over a [digest][chunk] shard file.

    read_record returns a raw record for the batched device verify
    (mxsum256); read_verified checks one chunk host-side (blake2b256)."""

    def __init__(self, src: BinaryIO, data_size: int, shard_size: int,
                 algorithm: str):
        self.src = src
        self.data_size = data_size
        self.shard_size = shard_size
        self.algo = get_algorithm(algorithm)

    def read_record(self, chunk_index: int) -> tuple[bytes, bytes]:
        """One raw (digest, chunk) record, NOT verified."""
        dl = self.algo.digest_len
        first_byte = chunk_index * self.shard_size
        if not 0 <= first_byte < max(self.data_size, 1):
            raise se.FileCorrupt(f"chunk {chunk_index} outside shard")
        self.src.seek(chunk_index * (dl + self.shard_size))
        want = self.src.read(dl)
        chunk_len = min(self.shard_size, self.data_size - first_byte)
        chunk = self.src.read(chunk_len)
        if len(want) != dl or len(chunk) != chunk_len:
            raise se.FileCorrupt(f"short read at chunk {chunk_index}")
        return want, chunk

    def read_verified(self, chunk_index: int) -> bytes:
        """One chunk, verified host-side against its record digest."""
        want, chunk = self.read_record(chunk_index)
        if self.algo.digest(chunk) != want:
            raise se.FileCorrupt(f"bitrot digest mismatch at chunk {chunk_index}")
        return chunk


def verify_shard_file(src: BinaryIO, data_size: int, shard_size: int,
                      algorithm: str, device) -> None:
    """Whole-file deep verify (reference VerifyFile, cmd/xl-storage.go:2179).
    mxsum256 files verify in batched kernel launches, 32 chunks each."""
    reader = BitrotReader(src, data_size, shard_size, algorithm)
    n_chunks = -(-data_size // shard_size) if data_size else 0
    if algorithm != "mxsum256":
        for ci in range(n_chunks):
            reader.read_verified(ci)
        return
    from minio_tpu_torch.ops import fused

    group = 32
    for start in range(0, n_chunks, group):
        records = [reader.read_record(ci)
                   for ci in range(start, min(start + group, n_chunks))]
        got = fused.digest_chunks_host([c for _w, c in records], shard_size,
                                       device)
        for ci, ((want, _c), g) in enumerate(zip(records, got), start=start):
            if g != want:
                raise se.FileCorrupt(f"bitrot digest mismatch at chunk {ci}")
