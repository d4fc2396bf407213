"""Bitrot protection: checksum registry + the streaming shard-file format.

Same format as minio_tpu/ops/bitrot.py (reference
cmd/bitrot-streaming.go:46-74): a shard file is a sequence of
[digest][chunk] records, one per shard_size chunk, each digest right
before its chunk. `frame_records` writes it, `BitrotReader` reads it.

Registry: the JAX package's seven algorithms, so the port reads, writes
and heals any drive set a JAX deployment stores.
- device: `mxsum256` (keyed linear checksum, computed by K2 after K1 on
  the write path and verified in batched K2 launches on the read path;
  the default, as the JAX package's on an accelerator) and `mxhash256`
  (keyed GF(2) Merkle-Damgard hash, K3 after K1 on the write path,
  batched K3 launches on the read path);
- host, hashed per chunk on the shard writer and reader threads:
  `sip256` (4-lane keyed SipHash, the JAX package's default on a CPU
  host), `highwayhash256` (the reference MinIO's default, keyed with its
  magic key), `xxh64` (8-byte digest) from the C++ library of native/,
  and `blake2b256` (keyed) and `sha256` from hashlib. A host library that
  does not build raises: no serving path falls back to the pure-Python
  versions.
"""

from __future__ import annotations

import hashlib
import time
from typing import BinaryIO, Iterable, Iterator

from minio_tpu_torch.obs import kernel as obs_kernel
from minio_tpu_torch.utils import errors as se

# Fixed 256-bit bitrot key (same bytes as the JAX package: the keyed
# algorithms derive from it).
BITROT_KEY = bytes.fromhex(
    "6d696e696f5f7470755f626974726f74"  # "minio_tpu_bitrot"
    "5f6b65795f76315f3230323630373239"  # "_key_v1_20260729"
)

# The reference's magicHighwayHash256Key (cmd/bitrot.go:31): the
# highwayhash256 entry keys with it, as the JAX package's does.
HH_BITROT_KEY = bytes(
    [0x4B, 0xE7, 0x34, 0xFA, 0x8E, 0x23, 0x8A, 0xCD, 0x26, 0x3E, 0x83,
     0xE6, 0xBB, 0x96, 0x85, 0x52, 0x04, 0x0F, 0x93, 0x5D, 0xA3, 0x9F,
     0x44, 0x14, 0x97, 0xE0, 0x9D, 0x13, 0x22, 0xDE, 0x36, 0xA0])

XXH64_SEED = 0x6D74_7075   # the JAX package's seed ("mtpu")

WRITE_ALGORITHM = "mxsum256"

# Algorithms the codec computes on the device, in batched launches.
DEVICE_ALGORITHMS = ("mxsum256", "mxhash256")


class _Blake2b256:
    name = "blake2b256"
    digest_len = 32

    @staticmethod
    def digest(data) -> bytes:
        return hashlib.blake2b(data, digest_size=32, key=BITROT_KEY).digest()


class _Sha256:
    name = "sha256"
    digest_len = 32

    @staticmethod
    def digest(data) -> bytes:
        return hashlib.sha256(data).digest()


class _Sip256:
    name = "sip256"
    digest_len = 32

    @staticmethod
    def digest(data) -> bytes:
        from minio_tpu_torch.native import lib

        return lib.sip256(BITROT_KEY, data)


class _HighwayHash256:
    name = "highwayhash256"
    digest_len = 32

    @staticmethod
    def digest(data) -> bytes:
        from minio_tpu_torch.native import lib

        return lib.highwayhash256(HH_BITROT_KEY, data)


class _Xxh64:
    """XXH64 written big-endian: xxHash's canonical form, the bytes the
    xxhash package's digest() gives the JAX package."""

    name = "xxh64"
    digest_len = 8

    @staticmethod
    def digest(data) -> bytes:
        from minio_tpu_torch.native import lib

        return lib.xxh64(data, XXH64_SEED).to_bytes(8, "big")


_NATIVE = ("sip256", "highwayhash256", "xxh64")


def _registry() -> dict:
    from minio_tpu_torch.ops.mxhash import MXHash256
    from minio_tpu_torch.ops.mxsum import MXSum256

    return {"mxsum256": MXSum256, "mxhash256": MXHash256,
            "blake2b256": _Blake2b256, "sha256": _Sha256, "sip256": _Sip256,
            "highwayhash256": _HighwayHash256, "xxh64": _Xxh64}


def device_default_algorithm() -> str:
    """The algorithm the port writes unless told otherwise: mxsum256, the
    JAX package's choice on an accelerator, on CUDA and on the CPU alike
    (there through the plain PyTorch digest)."""
    return WRITE_ALGORITHM


def get_algorithm(name: str):
    """The registry entry (digest_len, digest(bytes)). For the host
    algorithms of native/, the library is built here if it is not yet:
    a failed build raises HostLibraryError."""
    try:
        algo = _registry()[name]
    except KeyError:
        raise se.CorruptedFormat(f"unknown bitrot algorithm {name!r}") from None
    if name in _NATIVE:
        from minio_tpu_torch.native import lib

        lib.library()
    return algo


def digest_len(algorithm: str) -> int:
    return get_algorithm(algorithm).digest_len


def bitrot_shard_file_size(data_size: int, shard_size: int, algorithm: str) -> int:
    """On-disk size of a shard file holding data_size shard bytes
    (cmd/bitrot.go:140-145)."""
    if data_size == 0:
        return 0
    n_chunks = -(-data_size // shard_size)
    return data_size + n_chunks * digest_len(algorithm)


def frame_records(records: Iterable[tuple[bytes | None, bytes]],
                  host=None) -> Iterator[bytes]:
    """The shard-file writer: the byte stream of (digest, chunk) records,
    each digest right before its chunk. A digest from the device codec
    comes with its chunk; a None digest is computed here by the `host`
    algorithm, on the thread that writes the file (the JAX package's
    per-drive writer hashing, cmd/bitrot-streaming.go:46). Yields the
    pieces unconcatenated, so no chunk is copied on its way to the file."""
    label = f"bitrot_{getattr(host, 'name', '')}"
    for digest, chunk in records:
        if digest is None:
            # The write path's host "kernel", in the family the device
            # launches feed (minio_tpu/ops/bitrot.py:195).
            t0 = time.perf_counter()
            digest = host.digest(chunk)
            obs_kernel.observe(label, "host", t0, nbytes=len(chunk))
        yield digest
        yield chunk


class BitrotReader:
    """Reader over a [digest][chunk] shard file.

    read_record returns a raw record for a batched device verify
    (mxsum256, mxhash256); read_verified checks one chunk host-side (the
    host algorithms)."""

    def __init__(self, src: BinaryIO, data_size: int, shard_size: int,
                 algorithm: str):
        self.src = src
        self.data_size = data_size
        self.shard_size = shard_size
        self.algo = get_algorithm(algorithm)
        self._obs_kernel = f"bitrot_verify_{algorithm}"

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
        t0 = time.perf_counter()
        got = self.algo.digest(chunk)
        obs_kernel.observe(self._obs_kernel, "host", t0, nbytes=len(chunk))
        if got != want:
            raise se.FileCorrupt(f"bitrot digest mismatch at chunk {chunk_index}")
        return chunk


def device_digests(algorithm: str, chunks: list, cap: int, device) -> list[bytes]:
    """Digests of a ragged list of chunks (each <= cap) under a device
    algorithm, in one launch: mxsum256 through the batched data plane
    when it is on (else K2 alone), mxhash256 by K3."""
    if algorithm == "mxsum256":
        from minio_tpu_torch import dataplane

        return dataplane.digest_chunks(chunks, cap, device)
    from minio_tpu_torch.ops import fused

    return fused.stage_and_digest(chunks, cap, device,
                                  fused.device_digest(algorithm))


def verify_shard_file(src: BinaryIO, data_size: int, shard_size: int,
                      algorithm: str, device) -> None:
    """Whole-file deep verify (reference VerifyFile, cmd/xl-storage.go:2179).
    mxsum256 and mxhash256 files verify in batched kernel launches, 32
    chunks each (with the batched data plane on, concurrent mxsum256 scans
    share its verify lanes); the host algorithms chunk by chunk."""
    reader = BitrotReader(src, data_size, shard_size, algorithm)
    n_chunks = -(-data_size // shard_size) if data_size else 0
    if algorithm not in DEVICE_ALGORITHMS:
        for ci in range(n_chunks):
            reader.read_verified(ci)
        return
    group = 32
    for start in range(0, n_chunks, group):
        records = [reader.read_record(ci)
                   for ci in range(start, min(start + group, n_chunks))]
        got = device_digests(algorithm, [c for _w, c in records], shard_size,
                             device)
        for ci, ((want, _c), g) in enumerate(zip(records, got), start=start):
            if g != want:
                raise se.FileCorrupt(f"bitrot digest mismatch at chunk {ci}")
