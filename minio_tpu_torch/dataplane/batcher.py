"""Submission plane: coalesce concurrent codec work into lane launches
(counterpart of minio_tpu/dataplane/batcher.py).

Request threads (PUT shard-encodes, GET reconstructions, bitrot verifies,
heal rebuilds) enqueue `CodecRequest`s and get futures back; ONE
dispatcher thread drains the queue into fixed-shape lane batches keyed by
(op, k, m|t, shard-width bucket) and launches each batch as one call of
its lane function (ring.lane_kernel: K1 and K2) instead of one launch per
object.

Batching policy (env-tunable, the JAX package's names and defaults):
  * launch when the lane FILLS (a burst rides one launch), OR
  * when the oldest request in the lane has waited MTPU_DP_MAX_WAIT_US
    (default 500 us), so a lone request keeps a bounded latency.

Backpressure: the submission queue is bounded (MTPU_DP_QUEUE requests);
a full queue rejects the submit with AdmissionShed, an OperationTimedOut
that the S3 layer answers as 503 SlowDown. Under MTPU_QOS=1 it is the
tenant-fair `qos.FairQueue` (each request carries the tenant that
submitted it), whose token buckets shed as "tenant_quota".

Device side (the codec's dispatch, erasure/codec.py, per plane): the
dispatcher stages a batch into a recycled pinned ring slot, then queues
the upload, the lane's kernels and one download per output into pinned
memory on the plane's own CUDA stream, and records an event. The
completion thread waits on that event (never on the whole device),
resolves the futures and only then returns the slot to its ring, so no
batch overwrites a slot whose upload is still in flight. Launches of one
plane run in order on its stream, so K2's per-stream workspace is never
shared by two launches at once. A launch that fails fails its futures;
nothing switches to another path.

Bit-exactness: lane padding is invisible in results. Parity columns
never mix (zero-padded shard tails encode to zero parity and are cut
off), and mxsum digests are width-invariant with the length as data; the
stage functions zero every row tail past its chunk length in the slot,
so the uploaded tails are zero on the card too. Batched output is
byte-identical to the per-object codec, which stays the path when the
plane is off (MTPU_BATCHED_DATAPLANE=0) or sheds a submit.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np
import torch

from minio_tpu_torch import obs, qos
from minio_tpu_torch.dataplane import ring
from minio_tpu_torch.obs import flight
from minio_tpu_torch.obs import kernel as obs_kernel
from minio_tpu_torch.ops import rs
from minio_tpu_torch.utils import admission
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.shardmath import ceil_div, pow2_bucket

_CLOSE = object()

DEFAULT_LANE_BLOCKS = 32    # encode/reconstruct rows per launch
DEFAULT_VERIFY_ROWS = 128   # verify chunks per launch
DEFAULT_MAX_WAIT_US = 500   # lone-request latency bound (microseconds)
DEFAULT_QUEUE_CAP = 256     # bounded submission queue (requests)
DEFAULT_RING_DEPTH = 4      # staging slots per lane (double buffer+)
DEFAULT_MAX_WIDTH = 65536   # widest chunk the serving gate coalesces
# The reconstruct gate is narrower (the JAX package measured its
# crossover on an 8-device CPU mesh); both gates keep the JAX package's
# values, and PERF.md records what they cost on the card.
DEFAULT_MAX_RECON_WIDTH = 16384


class _BaseKey(tuple):
    """Accumulation key: LaneKey minus the row bucket (rows are decided at
    launch time from the fill)."""

    __slots__ = ()

    def __new__(cls, op: str, k: int, aux: int, width: int, digests: bool):
        return super().__new__(cls, (op, k, aux, width, digests))

    @property
    def op(self) -> str:
        return self[0]


class CodecRequest:
    """One unit of submitted codec work: `rows` slot rows, a stage
    callback run by the dispatcher, a finish callback run by the
    completion thread, and the future the request thread waits on."""

    __slots__ = ("base", "rows", "stage", "finish", "future", "t_submit",
                 "trace_id", "tl", "tenant")

    def __init__(self, base: _BaseKey, rows: int, stage, finish):
        self.base = base
        self.rows = rows
        self.stage = stage
        self.finish = finish
        self.future: Future = Future()
        self.t_submit = time.perf_counter()
        # The submitting request's trace id and timeline ride the request
        # into the dispatcher thread, which has no request context.
        self.trace_id = obs.trace_id()
        self.tl = flight.current()
        # Whose lane slots this work takes: captured like the trace id, so
        # worker 0's lanes schedule ring work by the tenant its slot header
        # carried.
        self.tenant = qos.current_key()


class _OpenBatch:
    __slots__ = ("base", "reqs", "fill", "first_ts")

    def __init__(self, base: _BaseKey):
        self.base = base
        self.reqs: list[CodecRequest] = []
        self.fill = 0
        self.first_ts = time.perf_counter()


class PendingBatchedEncode:
    """Drop-in for codec.PendingEncode: wait() returns (per block the n
    shard chunks, per block the n chunk digests | None); data chunks alias
    the caller's block buffers, parity chunks the launch's download."""

    def __init__(self, k: int, m: int, groups):
        # groups: list of (request, blocks, chunk_lens, flats)
        self._k = k
        self._m = m
        self._groups = groups

    def wait(self):
        k, m = self._k, self._m
        out_chunks: list[list[memoryview]] = []
        out_digs: list[list[bytes]] | None = None
        for req, blocks, lens, flats in self._groups:
            parity, digs = req.future.result()
            if digs is not None and out_digs is None:
                out_digs = []
            for bi, block in enumerate(blocks):
                s = lens[bi]
                src = flats[bi] if flats[bi] is not None else block
                mv = memoryview(src)
                row = [mv[i * s:(i + 1) * s] for i in range(k)]
                row += [memoryview(parity[bi, j])[:s] for j in range(m)]
                out_chunks.append(row)
                if out_digs is not None:
                    out_digs.append([digs[bi, i].tobytes()
                                     for i in range(k + m)])
        return out_chunks, out_digs


class PendingBatchedReconstruct:
    """Drop-in for codec.PendingDecode: wait() returns (per block the
    rebuilt chunk of each target, per block each target's digest | None),
    rebuilt chunks and digests from one heal-lane call shared with every
    concurrent heal and degraded GET."""

    def __init__(self, targets: tuple[int, ...], chunk_lens: list[int],
                 groups, with_digests: bool):
        self.targets = targets
        self._lens = chunk_lens
        self._groups = groups  # list of (request, nrows)
        self._digests = with_digests

    def wait(self):
        t = len(self.targets)
        out_chunks: list[list[bytes]] = []
        out_digs: list[list[bytes]] | None = [] if self._digests else None
        bi = 0
        for req, nrows in self._groups:
            res = req.future.result()
            rebuilt, digs = res if isinstance(res, tuple) else (res, None)
            for r in range(nrows):
                s = self._lens[bi]
                out_chunks.append([rebuilt[r, ti, :s].tobytes()
                                   for ti in range(t)])
                if out_digs is not None:
                    out_digs.append([digs[r, ti].tobytes()
                                     for ti in range(t)])
                bi += 1
        return out_chunks, out_digs


def _download(outs):
    """Queue one device->host copy into pinned memory per output tensor
    (a tensor, a tuple of them, or None)."""
    if isinstance(outs, tuple):
        return tuple(_download(o) for o in outs)
    if outs is None:
        return None
    host = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
    host.copy_(outs, non_blocking=True)
    return host


def _numpy(outs):
    if isinstance(outs, tuple):
        return tuple(_numpy(o) for o in outs)
    return None if outs is None else outs.numpy()


class BatchPlane:
    """The batched device data plane of one device.

    One dispatcher and one completion thread; request threads only
    enqueue and wait on futures. The knobs resolve env vars at
    construction (the JAX package's names), so a plane follows deployment
    config and tests can pin values. `device` defaults to the card and
    raises without CUDA unless "cpu" is asked for (the plain versions)."""

    def __init__(self, *, device="cuda", lane_blocks: int | None = None,
                 max_wait_s: float | None = None,
                 queue_cap: int | None = None,
                 ring_depth: int | None = None):
        self.device = device_mod.resolve(device)
        env = os.environ.get
        self.lane_blocks = lane_blocks if lane_blocks is not None else int(
            env("MTPU_DP_LANE_BLOCKS", str(DEFAULT_LANE_BLOCKS)))
        self.verify_rows = int(env("MTPU_DP_VERIFY_ROWS",
                                   str(DEFAULT_VERIFY_ROWS)))
        self.max_wait_s = max_wait_s if max_wait_s is not None else float(
            env("MTPU_DP_MAX_WAIT_US", str(DEFAULT_MAX_WAIT_US))) / 1e6
        self.max_width = int(env("MTPU_DP_MAX_WIDTH", str(DEFAULT_MAX_WIDTH)))
        self.max_recon_width = int(env("MTPU_DP_MAX_RECON_WIDTH",
                                       str(DEFAULT_MAX_RECON_WIDTH)))
        cap = queue_cap if queue_cap is not None else int(
            env("MTPU_DP_QUEUE", str(DEFAULT_QUEUE_CAP)))
        depth = ring_depth if ring_depth is not None else int(
            env("MTPU_DP_RING_DEPTH", str(DEFAULT_RING_DEPTH)))
        cuda = self.device.type == "cuda"
        # Admission: a plain bounded queue, or under MTPU_QOS=1 a
        # tenant-fair DRR queue whose byte cost is rows x block width.
        self._q = qos.plane_queue(
            "dataplane", cap,
            tenant_of=lambda r: r.tenant,
            cost_of=lambda r: r.rows * max(1, r.base[3]),
            is_control=lambda it: it is _CLOSE)
        self._done_q: queue.Queue = queue.Queue()
        self._rings = ring.RingPool(depth=depth, pinned=cuda)
        self._stream = torch.cuda.Stream(self.device) if cuda else None
        self._open: dict[_BaseKey, _OpenBatch] = {}  # dispatcher-only
        self._closed = False
        self._close_mu = threading.Lock()
        self._broken: BaseException | None = None
        # Test hook: clearing the gate parks the dispatcher so the bounded
        # queue can be filled deterministically.
        self._gate = threading.Event()
        self._gate.set()
        # launches/requests/rows/capacity/op launches are written by the
        # dispatcher only; "rejected" by request threads under _close_mu.
        # The process-wide families (minio_tpu_dataplane_*, and
        # minio_tpu_kernel_*{kernel="dp_<op>"}) count the same launches.
        self._stats = {"launches": 0, "requests": 0, "rows": 0,
                       "capacity": 0, "rejected": 0}
        # Launches per lane op (the families' `op` label).
        self._op_launches = {ring.OP_ENCODE: 0, ring.OP_VERIFY: 0,
                             ring.OP_RECONSTRUCT: 0}
        self._dispatch_t = threading.Thread(
            target=self._dispatch_loop, daemon=True, name="mtpu-dataplane-dispatch")
        self._complete_t = threading.Thread(
            target=self._complete_loop, daemon=True, name="mtpu-dataplane-complete")
        self._dispatch_t.start()
        self._complete_t.start()

    # ------------------------------------------------------------------
    # submission API (request threads)
    # ------------------------------------------------------------------

    def accepts_chunk(self, s: int) -> bool:
        """Serving-gate width check (MTPU_DP_MAX_WIDTH): wider blocks take
        the per-object codec path."""
        return s <= self.max_width

    def accepts_recon_chunk(self, s: int) -> bool:
        """Reconstruct-lane width gate (MTPU_DP_MAX_RECON_WIDTH)."""
        return s <= self.max_recon_width

    def begin_encode(self, k: int, m: int, block_size: int,
                     blocks: list[bytes],
                     with_digests: bool = False) -> PendingBatchedEncode:
        """Queue a batch of erasure blocks for coalesced encode (+ the
        mxsum digests of every shard chunk). Same result contract as
        codec.begin_encode."""
        if m <= 0:
            raise ValueError("batched plane needs parity shards (m > 0)")
        if not blocks:
            return PendingBatchedEncode(k, m, [])
        # Validate every block before submitting any group.
        for bi, block in enumerate(blocks):
            if not 0 < len(block) <= block_size:
                raise ValueError(f"block {bi} size {len(block)}")
        # The lane width follows the batch's actual chunk length, so a
        # small object rides a narrow lane.
        width = ring.width_bucket(max(ceil_div(len(b), k) for b in blocks))
        base = _BaseKey(ring.OP_ENCODE, k, m, width, with_digests)
        groups = []
        for g0 in range(0, len(blocks), self.lane_blocks):
            grp = blocks[g0:g0 + self.lane_blocks]
            lens: list[int] = []
            flats: list[np.ndarray | None] = []
            views: list[np.ndarray] = []
            for block in grp:
                s = ceil_div(len(block), k)
                lens.append(s)
                if len(block) == k * s:
                    flats.append(None)
                    views.append(np.frombuffer(block, dtype=np.uint8)
                                 .reshape(k, s))
                else:
                    flat = np.zeros(k * s, dtype=np.uint8)
                    flat[:len(block)] = np.frombuffer(block, dtype=np.uint8)
                    flats.append(flat)
                    views.append(flat.reshape(k, s))

            def stage(slot, row0, views=views, lens=lens):
                for bi, v in enumerate(views):
                    s = lens[bi]
                    r = row0 + bi
                    slot.data[r, :, :s] = v
                    slot.data[r, :, s:] = 0
                    slot.lens[r] = s

            def finish(outs, row0, nrows=len(grp)):
                parity, digs = outs
                return (parity[row0:row0 + nrows],
                        digs[row0:row0 + nrows] if digs is not None else None)

            req = CodecRequest(base, len(grp), stage, finish)
            self._submit(req)
            groups.append((req, grp, lens, flats))
        return PendingBatchedEncode(k, m, groups)

    def digest_chunks(self, chunks: list, cap: int) -> list[bytes]:
        """Coalesced mxsum256 digests of a ragged list of chunks (each <=
        cap): fused.digest_chunks_host's contract, with many concurrent
        readers sharing one launch."""
        if not chunks:
            return []
        width = ring.width_bucket(max(len(c) for c in chunks) or 1)
        base = _BaseKey(ring.OP_VERIFY, 0, 0, width, True)
        reqs = []
        for g0 in range(0, len(chunks), self.verify_rows):
            grp = chunks[g0:g0 + self.verify_rows]

            def stage(slot, row0, grp=grp):
                for ci, c in enumerate(grp):
                    r = row0 + ci
                    ln = len(c)
                    slot.data[r, :ln] = np.frombuffer(c, dtype=np.uint8)
                    slot.data[r, ln:] = 0
                    slot.lens[r] = ln

            def finish(outs, row0, nrows=len(grp)):
                return outs[row0:row0 + nrows]

            req = CodecRequest(base, len(grp), stage, finish)
            self._submit(req)
            reqs.append(req)
        out: list[bytes] = []
        for req in reqs:
            digs = req.future.result()
            out.extend(digs[i].tobytes() for i in range(req.rows))
        return out

    @staticmethod
    def _stage_survivors(slot, r, row, survivors, w) -> None:
        """Stage one block's survivor chunks (zero tails) and its decode
        matrix (padded target columns zero) into slot row r."""
        for ci, si in enumerate(survivors):
            c = row[si]
            slot.data[r, ci, :len(c)] = np.frombuffer(c, dtype=np.uint8)
            slot.data[r, ci, len(c):] = 0
        if w is None:
            slot.weights[r] = 0
        else:
            tw = w.shape[1]
            slot.weights[r, :, :tw] = w
            slot.weights[r, :, tw:] = 0

    def decode_blocks(self, k: int, m: int,
                      shard_chunks: list[list[bytes | None]],
                      block_lens: list[int]) -> list[list[bytes]]:
        """codec.decode_blocks through the plane: per block its k data
        shards. Mixed failure patterns share one launch: every row carries
        its own decode matrix as data (rs.gf2_matmul_multi)."""
        n = k + m
        if not shard_chunks:
            return []
        chunk_lens = [ceil_div(bl, k) for bl in block_lens]
        per_block: list[tuple[tuple[int, ...], tuple[int, ...]]] = []
        t_max = 0
        for bi, row in enumerate(shard_chunks):
            present = [i for i in range(n) if row[i] is not None]
            if len(present) < k:
                raise se.InsufficientReadQuorum(
                    "", "", f"block {bi}: only {len(present)} of {k} shards")
            survivors = tuple(present[:k])
            targets = tuple(i for i in range(k) if row[i] is None)
            per_block.append((survivors, targets))
            t_max = max(t_max, len(targets))
        if t_max == 0:
            return [row[:k] for row in shard_chunks]

        t_pad = pow2_bucket(t_max)  # pow-2 target-count lane
        width = ring.width_bucket(max(chunk_lens))
        base = _BaseKey(ring.OP_RECONSTRUCT, k, t_pad, width, False)
        groups = []
        for g0 in range(0, len(shard_chunks), self.lane_blocks):
            rows_grp = shard_chunks[g0:g0 + self.lane_blocks]
            pb_grp = per_block[g0:g0 + self.lane_blocks]
            weights = [rs.decode_weights_np(k, n, sv, tg) if tg else None
                       for sv, tg in pb_grp]

            def stage(slot, row0, rows_grp=rows_grp, pb_grp=pb_grp,
                      weights=weights):
                for bi, row in enumerate(rows_grp):
                    self._stage_survivors(slot, row0 + bi, row,
                                          pb_grp[bi][0], weights[bi])

            def finish(outs, row0, nrows=len(rows_grp)):
                return outs[row0:row0 + nrows]

            req = CodecRequest(base, len(rows_grp), stage, finish)
            self._submit(req)
            groups.append((req, rows_grp, pb_grp,
                           chunk_lens[g0:g0 + self.lane_blocks]))

        out: list[list[bytes]] = []
        for req, rows_grp, pb_grp, lens_grp in groups:
            rebuilt = req.future.result()
            for bi, row in enumerate(rows_grp):
                s = lens_grp[bi]
                fixed = list(row)
                for ti, shard_idx in enumerate(pb_grp[bi][1]):
                    fixed[shard_idx] = rebuilt[bi, ti, :s].tobytes()
                out.append(fixed[:k])
        return out

    def begin_reconstruct(self, k: int, m: int,
                          shard_chunks: list[list[bytes | None]],
                          block_lens: list[int],
                          targets: tuple[int, ...],
                          with_digests: bool = False
                          ) -> PendingBatchedReconstruct:
        """codec.begin_reconstruct through the plane, the heal shape: one
        failure pattern per batch, but concurrent heals with different
        patterns still share a launch (per-row decode matrices), and
        with_digests digests the rebuilt chunks in the same lane call.
        Same result contract as codec.begin_reconstruct."""
        n = k + m
        targets = tuple(targets)
        if not shard_chunks:
            return PendingBatchedReconstruct(targets, [], [], False)
        pattern = [c is not None for c in shard_chunks[0]]
        for row in shard_chunks[1:]:
            if [c is not None for c in row] != pattern:
                raise ValueError(
                    "begin_reconstruct needs one failure pattern per "
                    "batch (use decode_blocks for mixed patterns)")
        present = [i for i in range(n) if pattern[i]]
        if len(present) < k:
            raise se.InsufficientReadQuorum(
                "", "", f"only {len(present)} of {k} shards available")
        survivors = tuple(present[:k])
        chunk_lens = [ceil_div(bl, k) for bl in block_lens]
        t_pad = pow2_bucket(max(1, len(targets)))
        width = ring.width_bucket(max(chunk_lens))
        base = _BaseKey(ring.OP_RECONSTRUCT, k, t_pad, width, with_digests)
        w = rs.decode_weights_np(k, n, survivors, targets) if targets else None
        groups = []
        for g0 in range(0, len(shard_chunks), self.lane_blocks):
            rows_grp = shard_chunks[g0:g0 + self.lane_blocks]
            lens_grp = chunk_lens[g0:g0 + self.lane_blocks]

            def stage(slot, row0, rows_grp=rows_grp, lens_grp=lens_grp):
                for bi, row in enumerate(rows_grp):
                    self._stage_survivors(slot, row0 + bi, row, survivors, w)
                    slot.lens[row0 + bi] = lens_grp[bi]

            def finish(outs, row0, nrows=len(rows_grp)):
                if isinstance(outs, tuple):  # digest-fused heal lane
                    rebuilt, digs = outs
                    return (rebuilt[row0:row0 + nrows],
                            digs[row0:row0 + nrows])
                return outs[row0:row0 + nrows]

            req = CodecRequest(base, len(rows_grp), stage, finish)
            self._submit(req)
            groups.append((req, len(rows_grp)))
        return PendingBatchedReconstruct(targets, chunk_lens, groups,
                                         with_digests)

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def _submit(self, req: CodecRequest) -> None:
        if self._closed:
            raise admission.shed("dataplane", "closed",
                                 "batched dataplane is closed")
        if self._broken is not None:
            raise se.OperationTimedOut(
                msg=f"batched dataplane failed: {self._broken}")
        try:
            self._q.put_nowait(req)
        except queue.Full as e:
            with self._close_mu:  # rejected count: cross-thread writes
                self._stats["rejected"] += 1
            obs_kernel.dataplane_rejected(req.base.op)
            if isinstance(e, qos.QuotaFull):
                raise admission.shed(
                    "dataplane", "tenant_quota",
                    "tenant over dataplane rate quota") from None
            raise admission.shed(
                "dataplane", "lane_full",
                "batched dataplane saturated (bounded queue full)") from None
        if self._closed and not self._dispatch_t.is_alive():
            # TOCTOU with close(): the closed check passed, but close()
            # drained the queue and joined the dispatcher before this put
            # landed. Fail every straggler so no future is orphaned.
            self._drain_failed(se.OperationTimedOut(
                msg="batched dataplane closed"))

    def _capacity(self, base: _BaseKey) -> int:
        return (self.verify_rows if base.op == ring.OP_VERIFY
                else self.lane_blocks)

    def _next_deadline(self) -> float | None:
        """Seconds until the oldest open batch must launch (None: no open
        batch, block on the queue)."""
        if not self._open:
            return None
        first = min(b.first_ts for b in self._open.values())
        return max(0.0, first + self.max_wait_s - time.perf_counter())

    def _dispatch_loop(self) -> None:
        try:
            while True:
                self._gate.wait()
                try:
                    item = self._q.get(timeout=self._next_deadline())
                except queue.Empty:
                    item = None
                if item is _CLOSE:
                    self._flush(force=True)
                    break
                if item is not None:
                    self._add(item)
                self._flush(force=False)
        except BaseException as e:  # noqa: BLE001 - relay to waiters
            self._broken = e
            self._fail_open(e)
            self._drain_failed(e)
        finally:
            self._done_q.put(_CLOSE)

    def _add(self, req: CodecRequest) -> None:
        cap = self._capacity(req.base)
        batch = self._open.get(req.base)
        if batch is not None and batch.fill + req.rows > cap:
            self._launch(batch)
            batch = None
        if batch is None:
            batch = self._open[req.base] = _OpenBatch(req.base)
        batch.reqs.append(req)
        batch.fill += req.rows

    def _flush(self, force: bool) -> None:
        now = time.perf_counter()
        for base in list(self._open):
            batch = self._open[base]
            if (force or batch.fill >= self._capacity(base)
                    or now - batch.first_ts >= self.max_wait_s):
                self._launch(batch)

    def _launch(self, batch: _OpenBatch) -> None:
        self._open.pop(batch.base, None)
        op, k, aux, width, digests = batch.base
        cap = self._capacity(batch.base)
        rb = ring.rows_bucket(batch.fill, cap)
        slot_key = ring.LaneKey(op, k, aux, width, cap, digests)
        slot = self._rings.ring(slot_key).acquire()
        event = None
        try:
            row0 = 0
            for req in batch.reqs:
                req.stage(slot, row0)
                row0 += req.rows
            kern = ring.lane_kernel(ring.LaneKey(op, k, aux, width, rb, digests))
            args = [slot.data_t[:rb]]
            if op == ring.OP_RECONSTRUCT:
                args.append(slot.weights_t[:rb])
            if op != ring.OP_RECONSTRUCT or digests:
                args.append(slot.lens_t[:rb])
            t0 = time.perf_counter()
            if self._stream is None:
                launch = obs_kernel.start(self.device)
                outs = kern(*args)
            else:
                with torch.cuda.stream(self._stream):
                    dev = [a.to(self.device, non_blocking=True) for a in args]
                    # Under MTPU_KERNEL_SYNC the record is the device time
                    # of the lane's kernels alone: not the upload before,
                    # nor the download after.
                    launch = obs_kernel.start(self.device)
                    try:
                        res = kern(*dev)
                    finally:
                        obs_kernel.stop(launch)
                    outs = _download(res)
                    event = torch.cuda.Event()
                    event.record(self._stream)
            obs_kernel.observe(f"dp_{op}", obs_kernel.backend(self.device), launch,
                               blocks=rb, nbytes=args[0].numel())
            now = time.perf_counter()
            obs_kernel.dataplane_launch(op, batch.fill, cap,
                                        [now - r.t_submit for r in batch.reqs])
            for r in batch.reqs:
                if r.tl is not None:
                    # Queue wait: submit to launch (batching wait + staging);
                    # launch: the whole batch's upload, kernels and
                    # download queued.
                    r.tl.stamp("dp_queue_wait", t0 - r.t_submit, "dataplane")
                    r.tl.stamp("dp_launch", now - t0, "dataplane")
            if obs.has_subscribers():
                obs.publish({
                    "type": "batch", "plane": "dataplane", "op": op,
                    "rows": batch.fill, "capacity": cap,
                    "requests": len(batch.reqs),
                    "members": [r.trace_id for r in batch.reqs if r.trace_id],
                    "time": time.time(), "durationNs": int((now - t0) * 1e9)})
            st = self._stats
            st["launches"] += 1
            self._op_launches[op] += 1
            st["requests"] += len(batch.reqs)
            st["rows"] += batch.fill
            st["capacity"] += cap
        except BaseException as e:  # noqa: BLE001 - fail this batch only
            for req in batch.reqs:
                if not req.future.done():
                    req.future.set_exception(
                        e if isinstance(e, Exception) else RuntimeError(repr(e)))
            self._release_after_stream(slot_key, slot)
            if not isinstance(e, Exception):
                raise
            return
        self._done_q.put((slot_key, slot, outs, event, batch.reqs))

    def _release_after_stream(self, slot_key, slot) -> None:
        """Return a slot whose launch failed: an upload queued before the
        failure may still read it, so wait for the plane's stream first."""
        try:
            if self._stream is not None:
                self._stream.synchronize()
        finally:
            self._rings.ring(slot_key).release(slot)

    def _complete_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is _CLOSE:
                return
            self._finish_host(*item)

    def _finish_host(self, slot_key, slot, outs, event, reqs) -> None:
        """Wait for one launch's event (its downloads are then in pinned
        memory), resolve its requests' futures, recycle the slot."""
        try:
            if event is not None:
                event.synchronize()
            mat = _numpy(outs)
            row0 = 0
            for req in reqs:
                try:
                    req.future.set_result(req.finish(mat, row0))
                except Exception as e:  # noqa: BLE001 - per-request
                    if not req.future.done():
                        req.future.set_exception(e)
                row0 += req.rows
        except BaseException as e:  # noqa: BLE001 - fail the whole batch
            for req in reqs:
                if not req.future.done():
                    req.future.set_exception(
                        e if isinstance(e, Exception) else RuntimeError(repr(e)))
        finally:
            self._rings.ring(slot_key).release(slot)

    def _fail_open(self, e: BaseException) -> None:
        err = e if isinstance(e, Exception) else RuntimeError(repr(e))
        for batch in self._open.values():
            for req in batch.reqs:
                if not req.future.done():
                    req.future.set_exception(err)
        self._open.clear()

    def _drain_failed(self, e: BaseException) -> None:
        err = e if isinstance(e, Exception) else RuntimeError(repr(e))
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is _CLOSE:
                continue
            try:
                item.future.set_exception(err)
            except InvalidStateError:
                pass  # a racing drainer already resolved this future

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, drain every in-flight batch (all futures
        resolve, none orphaned), then join both threads."""
        with self._close_mu:
            if self._closed:
                return
            self._closed = True
        self._gate.set()
        self._q.put(_CLOSE)
        self._dispatch_t.join(timeout)
        self._complete_t.join(timeout)
        # Late racers that slipped in after _CLOSE: fail them.
        self._drain_failed(se.OperationTimedOut(msg="batched dataplane closed"))
        self._rings.clear()

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> dict:
        st = dict(self._stats)
        st["op_launches"] = dict(self._op_launches)
        st["mean_occupancy"] = (st["rows"] / st["capacity"]
                                if st["capacity"] else 0.0)
        return st
