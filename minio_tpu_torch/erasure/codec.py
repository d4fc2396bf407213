"""ErasureCodec — erasure geometry + batched device codec for object streams
(counterpart of minio_tpu/erasure/codec.py).

The streaming loops hand the codec a batch of blocks per call, so each
kernel launch is sized by many 1 MiB blocks. Staging follows the JAX
package exactly: rows pad to a power of two (fused.bucket_rows), the shard
width stages at the power-of-two bucket of the batch's largest chunk
(fused.bucket_width), short blocks zero-pad to their chunk width and the
parity is cut back — parity columns never mix, so padding is free.

Dispatch-ahead: on CUDA, begin_encode/begin_reconstruct stage the batch in
pinned host memory and queue the upload, the kernels and the download on a
side stream, then record an event and return; the host reads the next
batch meanwhile. wait() synchronizes on the event; each result tensor came
back in one device-to-host copy into pinned memory. One card, no mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from minio_tpu_torch.ops import fused, mxhash, rs
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils import shardmath
from minio_tpu_torch.utils.shardmath import ceil_div

DEFAULT_BLOCK_SIZE = 1 << 20  # reference blockSizeV2, cmd/object-api-common.go:41
BATCH_BLOCKS = 16             # blocks per launch on the PUT, GET and heal loops


class _Launch:
    """Results of one queued launch: host tensors, valid after wait()."""

    def __init__(self, event, keep, outs):
        self._event = event
        self._keep = keep   # staging buffers the async copies still read
        self.outs = outs

    def wait(self) -> list:
        if self._event is not None:
            self._event.synchronize()
        self._keep = None
        return [None if t is None else t.numpy() for t in self.outs]


def _download(t: torch.Tensor | None) -> torch.Tensor | None:
    """Queue one device->host copy into pinned memory (CPU: identity)."""
    if t is None or t.device.type == "cpu":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class PendingEncode:
    """Handle to an in-flight encode launch (see begin_encode)."""

    def __init__(self, codec: "ErasureCodec", blocks: list, chunk_lens: list[int],
                 padded: list, launch: _Launch):
        self._codec = codec
        self._blocks = blocks
        self._lens = chunk_lens
        self._padded = padded
        self._launch = launch

    def wait(self) -> tuple[list[list[memoryview]], list[list[bytes]] | None]:
        """-> (per block the n shard chunks, per block the n chunk digests,
        or None when the launch computed none). Data chunks alias the
        caller's block buffers; parity chunks alias the downloaded array."""
        k, m = self._codec.k, self._codec.m
        parity, digs = self._launch.wait()
        out_chunks: list[list[memoryview]] = []
        out_digs: list[list[bytes]] | None = None if digs is None else []
        for bi, block in enumerate(self._blocks):
            s = self._lens[bi]
            src = self._padded[bi] if self._padded[bi] is not None else block
            mv = memoryview(src)
            chunks = [mv[i * s:(i + 1) * s] for i in range(k)]
            if m:
                chunks += [memoryview(parity[bi, j])[:s] for j in range(m)]
            out_chunks.append(chunks)
            if out_digs is not None:
                out_digs.append([bytes(digs[bi, i]) for i in range(k + m)])
        return out_chunks, out_digs


class PendingDecode:
    """Handle to an in-flight rebuild launch (see begin_reconstruct)."""

    def __init__(self, targets: tuple[int, ...], chunk_lens: list[int],
                 launch: _Launch | None):
        self.targets = targets
        self._lens = chunk_lens
        self._launch = launch

    def wait(self) -> tuple[list[list[bytes]], list[list[bytes]] | None]:
        """-> (per block the rebuilt chunk of each target, per block the
        digest of each target or None)."""
        if self._launch is None:
            return [], None
        rebuilt, digs = self._launch.wait()
        t = len(self.targets)
        out_chunks = [[rebuilt[bi, ti, :s].tobytes() for ti in range(t)]
                      for bi, s in enumerate(self._lens)]
        out_digs = None if digs is None else [
            [bytes(digs[bi, ti]) for ti in range(t)]
            for bi in range(len(self._lens))]
        return out_chunks, out_digs


class ErasureCodec:
    def __init__(self, data_blocks: int, parity_blocks: int,
                 block_size: int = DEFAULT_BLOCK_SIZE, device="cuda"):
        if data_blocks <= 0 or parity_blocks < 0:
            raise ValueError(f"bad geometry k={data_blocks} m={parity_blocks}")
        if data_blocks + parity_blocks > 256:
            raise ValueError("k+m exceeds GF(2^8) limit of 256")
        self.k = data_blocks
        self.m = parity_blocks
        self.block_size = block_size
        self.device = device_mod.resolve(device)
        self._stream = None

    # --- geometry (cmd/erasure-coding.go:115-143) ---

    def shard_size(self) -> int:
        return shardmath.shard_size(self.block_size, self.k)

    def shard_file_size(self, total_length: int) -> int:
        return shardmath.shard_file_size(total_length, self.block_size, self.k)

    # --- staging and dispatch ---

    def _host(self, shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _dispatch(self, fn, *host_inputs) -> _Launch:
        """Upload host_inputs, run fn on them and download its outputs; on
        CUDA all of it is queued on the codec's side stream."""
        if self.device.type == "cpu":
            return _Launch(None, None, list(fn(*host_inputs)))
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        # Work the caller queued on its own stream (weights uploaded for
        # this launch) comes first.
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            dev = [t.to(self.device, non_blocking=True) for t in host_inputs]
            outs = [_download(t) for t in fn(*dev)]
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Launch(event, host_inputs, outs)

    def _lens_tensor(self, lens: list[int]) -> torch.Tensor:
        return torch.tensor(lens, dtype=torch.int32).pin_memory() \
            if self.device.type == "cuda" else torch.tensor(lens, dtype=torch.int32)

    def begin_encode(self, blocks: list,
                     algorithm: str | None = "mxsum256") -> PendingEncode:
        """Queue one launch encoding a batch of erasure blocks: parity and
        the digest of every shard chunk under a device `algorithm`
        (mxsum256: K1 then K2; mxhash256: K1 then K3, the JAX
        encode_with_bitrot), or, with None, parity alone (a host algorithm
        hashes on the writer threads). Returns immediately; results come
        from PendingEncode.wait()."""
        s_full = self.shard_size()
        chunk_lens: list[int] = []
        for bi, block in enumerate(blocks):
            if not 0 < len(block) <= self.block_size:
                raise ValueError(f"block {bi} size {len(block)}")
            chunk_lens.append(ceil_div(len(block), self.k))
        rows = fused.bucket_rows(len(blocks))
        s_stage = min(s_full, fused.bucket_width(max(chunk_lens)))
        batch = self._host((rows, self.k, s_stage))
        arr = batch.numpy()
        padded: list = []
        for bi, block in enumerate(blocks):
            s = chunk_lens[bi]
            if s == s_stage and len(block) == self.k * s_stage:
                padded.append(None)
                arr[bi] = np.frombuffer(block, dtype=np.uint8).reshape(
                    self.k, s_stage)
            else:
                flat = np.zeros(self.k * s, dtype=np.uint8)
                flat[: len(block)] = np.frombuffer(block, dtype=np.uint8)
                padded.append(flat.tobytes())
                arr[bi, :, :s] = flat.reshape(self.k, s)
        lens = self._lens_tensor(chunk_lens + [0] * (rows - len(blocks)))
        k, m = self.k, self.m

        def run(data, lens_dev):
            if algorithm is None:
                return (rs.encode(data, k, m) if m else None), None
            if m:
                if algorithm == "mxhash256":
                    return mxhash.encode_with_bitrot(data, k, m, lens_dev)
                return fused.encode_with_digests(data, k, m, lens_dev)
            # parity-less geometry: digests of the k shards
            return None, fused.device_digest(algorithm)(
                data.reshape(rows * k, s_stage),
                lens_dev.repeat_interleave(k)).reshape(rows, k, -1)

        return PendingEncode(self, blocks, chunk_lens, padded,
                             self._dispatch(run, batch, lens))

    def _survivor_batch(self, shard_chunks, survivors, s_stage,
                        rows: int = 0) -> torch.Tensor:
        """Survivor-compacted staging [rows, k, s_stage] (rows default to
        the batch's block count; pad rows stay zero)."""
        batch = self._host((max(rows, len(shard_chunks)), self.k, s_stage))
        arr = batch.numpy()
        for bi, row in enumerate(shard_chunks):
            for si, shard_idx in enumerate(survivors):
                c = row[shard_idx]
                arr[bi, si, : len(c)] = np.frombuffer(c, dtype=np.uint8)
        return batch

    def begin_reconstruct(self, shard_chunks: list[list], block_lens: list[int],
                          targets: tuple[int, ...], algorithm: str | None = None,
                          *, with_digests: bool = False) -> PendingDecode:
        """Queue one rebuild launch for a batch of blocks sharing one
        failure pattern (the heal loop's shape). The decode matrix is
        runtime data (fused.reconstruct_weights_digests); a device
        `algorithm` also digests the rebuilt chunks on the device (K2 or K3
        after K1; with_digests=True, the older spelling, is short for
        "mxsum256"). Returns immediately."""
        if with_digests and algorithm is None:
            algorithm = "mxsum256"
        if not shard_chunks:
            return PendingDecode(tuple(targets), [], None)
        n = self.k + self.m
        pattern = [c is not None for c in shard_chunks[0]]
        for row in shard_chunks[1:]:
            if [c is not None for c in row] != pattern:
                raise ValueError(
                    "begin_reconstruct needs one failure pattern per batch "
                    "(use decode_blocks for mixed patterns)")
        present = [i for i in range(n) if pattern[i]]
        if len(present) < self.k:
            raise se.InsufficientReadQuorum(
                "", "", f"only {len(present)} of {self.k} shards available")
        survivors = tuple(present[: self.k])
        chunk_lens = [ceil_div(bl, self.k) for bl in block_lens]
        rows = fused.bucket_rows(len(shard_chunks))
        s_stage = min(self.shard_size(), fused.bucket_width(max(chunk_lens)))
        batch = self._survivor_batch(shard_chunks, survivors, s_stage, rows)
        w_t = rs.device_decode_weights(self.k, n, survivors, tuple(targets),
                                       self.device).t()
        lens = self._lens_tensor(chunk_lens + [0] * (rows - len(shard_chunks)))
        t = len(targets)

        def run(surv, lens_dev):
            rebuilt, _ = fused.reconstruct_weights_digests(
                surv, w_t, lens_dev, t, with_digests=False)
            if algorithm is None:
                return rebuilt, None
            b, _, s = rebuilt.shape
            digs = fused.device_digest(algorithm)(
                rebuilt.reshape(b * t, s), lens_dev.repeat_interleave(t))
            return rebuilt, digs.reshape(b, t, -1)

        return PendingDecode(tuple(targets), chunk_lens,
                             self._dispatch(run, batch, lens))

    # --- batched decode (GET path) ---

    def decode_blocks(self, shard_chunks: list[list],
                      block_lens: list[int]) -> list[list]:
        """Rebuild the data chunks of a batch of blocks: shard_chunks[b][i]
        is shard i's chunk of block b, or None if unavailable. Mixed
        failure patterns take decode_blocks_multi. Returns per block the k
        data chunks."""
        n = self.k + self.m
        if not shard_chunks:
            return []
        present = [shard_chunks[0][i] is not None for i in range(n)]
        for row in shard_chunks:
            if [c is not None for c in row] != present:
                return self.decode_blocks_multi(shard_chunks, block_lens)
        if sum(present) < self.k:
            raise se.InsufficientReadQuorum(
                "", "", f"only {sum(present)} of required {self.k} shards available")
        targets = [i for i in range(self.k) if not present[i]]
        if not targets:
            return [list(row[: self.k]) for row in shard_chunks]
        survivors = tuple([i for i in range(n) if present[i]][: self.k])
        chunk_lens = [ceil_div(bl, self.k) for bl in block_lens]
        s_stage = min(self.shard_size(), fused.bucket_width(max(chunk_lens)))
        batch = self._survivor_batch(shard_chunks, survivors, s_stage)
        w = rs.device_decode_weights(self.k, n, survivors, tuple(targets),
                                     self.device)
        rebuilt, = self._dispatch(
            lambda x: (rs.gf2_matmul(x, w, len(targets)),), batch).wait()
        out = []
        for bi, row in enumerate(shard_chunks):
            s = chunk_lens[bi]
            fixed = list(row)
            for ti, shard_idx in enumerate(targets):
                fixed[shard_idx] = rebuilt[bi, ti, :s].tobytes()
            out.append(fixed[: self.k])
        return out

    def decode_blocks_multi(self, shard_chunks: list[list],
                            block_lens: list[int]) -> list[list]:
        """decode_blocks for blocks with DIFFERENT failure patterns: each
        block carries its own decode matrix and the batch rebuilds in one
        launch (rs.gf2_matmul_multi, per-block weights)."""
        n = self.k + self.m
        if not shard_chunks:
            return []
        chunk_lens = [ceil_div(bl, self.k) for bl in block_lens]
        s_stage = min(self.shard_size(), fused.bucket_width(max(chunk_lens)))
        per_block = []
        t_max = 1
        for bi, row in enumerate(shard_chunks):
            present = [i for i in range(n) if row[i] is not None]
            if len(present) < self.k:
                raise se.InsufficientReadQuorum(
                    "", "", f"block {bi}: only {len(present)} of {self.k} shards")
            targets = tuple(i for i in range(self.k) if row[i] is None)
            per_block.append((tuple(present[: self.k]), targets))
            t_max = max(t_max, len(targets))
        if all(not t for _, t in per_block):
            return [list(row[: self.k]) for row in shard_chunks]
        batch = self._host((len(shard_chunks), self.k, s_stage))
        arr = batch.numpy()
        weights = torch.zeros((len(shard_chunks), self.k * 8, t_max * 8),
                              dtype=torch.int8,
                              pin_memory=self.device.type == "cuda")
        warr = weights.numpy()
        for bi, row in enumerate(shard_chunks):
            survivors, targets = per_block[bi]
            for si, shard_idx in enumerate(survivors):
                c = row[shard_idx]
                arr[bi, si, : len(c)] = np.frombuffer(c, dtype=np.uint8)
            if targets:
                warr[bi, :, : len(targets) * 8] = rs.decode_weights_np(
                    self.k, n, survivors, targets)
        rebuilt, = self._dispatch(
            lambda x, w: (rs.gf2_matmul_multi(x, w, t_max),),
            batch, weights).wait()
        out = []
        for bi, row in enumerate(shard_chunks):
            _, targets = per_block[bi]
            s = chunk_lens[bi]
            fixed = list(row)
            for ti, shard_idx in enumerate(targets):
                fixed[shard_idx] = rebuilt[bi, ti, :s].tobytes()
            out.append(fixed[: self.k])
        return out

