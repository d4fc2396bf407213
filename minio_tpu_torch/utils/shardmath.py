"""Shard-file geometry math, shared by the codec and the metadata model.

Single source of truth for the block->shard layout (reference
cmd/erasure-coding.go:115-143): both the write path (ErasureCodec) and
verification/metadata (ErasureInfo) must agree byte-for-byte on these.
"""

from __future__ import annotations


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pow2_bucket(n: int, floor: int = 1) -> int:
    """Next power of two >= n (and >= floor) — THE bucketing rule for
    every staged batch dimension (row counts, shard widths, target
    counts). One implementation on purpose: codec staging, the fused
    dispatch layer and the dataplane lane keys must round identically
    or they mint divergent jit-trace families (docs/DATAPLANE.md)."""
    w = max(floor, 1)
    while w < n:
        w *= 2
    return w


def shard_size(block_size: int, data_blocks: int) -> int:
    """Shard chunk width for one erasure block."""
    return ceil_div(block_size, data_blocks)


def shard_file_size(total_length: int, block_size: int, data_blocks: int) -> int:
    """Logical shard bytes (pre-bitrot-framing) for an object of
    total_length bytes."""
    if total_length == 0:
        return 0
    if total_length < 0:
        return -1
    full = total_length // block_size
    size = full * shard_size(block_size, data_blocks)
    last = total_length - full * block_size
    if last > 0:
        size += ceil_div(last, data_blocks)
    return size


def shard_file_offset(start: int, length: int, total_length: int,
                      block_size: int, data_blocks: int) -> int:
    """Shard offset up to which data must be read to serve
    [start, start+length) of the object."""
    ss = shard_size(block_size, data_blocks)
    till = ((start + length) // block_size) * ss + ss
    return min(till, shard_file_size(total_length, block_size, data_blocks))
