"""Cross-process lane service over the shm submission ring (counterpart
of minio_tpu/frontdoor/laneserver.py; either package's client and server
speak to each other).

`LaneServer` runs inside the lane-owner worker (worker 0): a scanner
thread claims SUBMITTED slots and hands them to a small pool that
submits the work into the owner's process-local `BatchPlane` — so ring
traffic from every worker coalesces with the owner's own request
threads into shared K1 and K2 launches on the card.

`LaneClient` runs inside every other worker and implements the subset
of the `BatchPlane` surface the serving integration points call
(`accepts_chunk`, `begin_encode`, `digest_chunks`, `decode_blocks`,
`begin_reconstruct`). Encode, digest and heal-shaped reconstruct
batches ride the ring (OP_RECONSTRUCT: one failure pattern per batch,
so a whole-set heal running in ANY worker coalesces into the owner's
lanes); mixed-pattern GET decodes (already coalesced per-process under
failure) stay on the local plane. Every ring miss — oversized batch,
no free slot, timeout, server dead — falls back to the local plane:
the ring is throughput, never correctness. A fallback launches the same
hand-written kernels in the sibling's own CUDA context, and is counted in
`minio_tpu_frontdoor_ring_fallbacks_total{reason}`.

The port's plane takes `begin_reconstruct(k, m, shard_chunks, block_lens,
targets, with_digests)` (no block size) and answers digests as bytes; the
client keeps that surface, and the bytes on the ring are the JAX ones.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from minio_tpu_torch import obs, qos
from minio_tpu_torch.frontdoor import shm
from minio_tpu_torch.obs import flight

_RING_SUBMITS = obs.counter(
    "minio_tpu_frontdoor_ring_submits_total",
    "Codec batches a worker submitted over the shared-memory ring",
    ("worker", "op"))
_RING_FALLBACKS = obs.counter(
    "minio_tpu_frontdoor_ring_fallbacks_total",
    "Ring misses served by the worker-local plane instead",
    ("worker", "reason"))
_RING_SERVED = obs.counter(
    "minio_tpu_frontdoor_ring_served_total",
    "Ring batches the lane-owner worker completed",
    ("worker", "op"))

_OP_NAMES = {
    shm.OP_DIGEST: "digest",
    shm.OP_ENCODE: "encode",
    shm.OP_RECONSTRUCT: "reconstruct",
    shm.OP_HOTGET: "hotget",
}


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _PendingRingEncode:
    """PendingBatchedEncode-shaped handle for a ring-submitted encode:
    wait() polls the slot, rebuilds the (chunk rows, digests) contract
    with data chunks aliasing the caller's block buffers, and falls
    back to the local plane on any ring fault."""

    def __init__(self, client: "LaneClient", slot: int, seq: int,
                 k: int, m: int, block_size: int, blocks: list,
                 with_digests: bool):
        self._c = client
        self._slot = slot
        self._seq = seq
        self._k = k
        self._m = m
        self._bs = block_size
        self._blocks = blocks
        self._digests = with_digests

    def _fallback(self):
        pend = self._c.local().begin_encode(
            self._k, self._m, self._bs, self._blocks,
            with_digests=self._digests)
        return pend.wait()

    def wait(self):
        resp = self._c._await_slot(self._slot, self._seq)
        if resp is None:
            self._c._note_fallback(shm.REASON_TIMEOUT)
            return self._fallback()
        k, m = self._k, self._m
        out_chunks: list[list] = []
        out_digs: list[list[bytes]] | None = [] if self._digests else None
        off = 0
        dig_w = (k + m) * 32
        for block in self._blocks:
            s = _ceil_div(len(block), k)
            if len(block) == k * s:
                src = block
            else:
                src = bytearray(k * s)
                src[:len(block)] = block
            mv = memoryview(src)
            row = [mv[i * s:(i + 1) * s] for i in range(k)]
            pmv = memoryview(resp)
            for j in range(m):
                row.append(pmv[off + j * s:off + (j + 1) * s])
            off += m * s
            out_chunks.append(row)
            if out_digs is not None:
                dv = pmv[off:off + dig_w]
                out_digs.append([dv[i * 32:(i + 1) * 32].tobytes()
                                 for i in range(k + m)])
                off += dig_w
        return out_chunks, out_digs


def _pack_hotget(bucket: str, obj: str, ident: tuple, offset: int,
                 length: int) -> bytes:
    """OP_HOTGET meta chunk: the key, the caller's elected-FileInfo
    identity (version, etag, size, mod_time — what must match the
    resident entry for a hit), and the byte range."""
    import struct

    vid, etag, size, mt = ident
    bb, ob = bucket.encode(), obj.encode()
    vb, eb = vid.encode(), etag.encode()
    return struct.pack("<dQQQHHHH", float(mt), int(size), offset,
                       length, len(bb), len(ob), len(vb),
                       len(eb)) + bb + ob + vb + eb


def _unpack_hotget(meta):
    import struct

    mt, size, offset, length, lb, lo, lv, le = struct.unpack_from(
        "<dQQQHHHH", meta, 0)
    off = struct.calcsize("<dQQQHHHH")
    # str(view, "utf-8") decodes straight off the ring's memoryview —
    # the header's key/identity strings never round-trip bytes().
    bucket = str(meta[off:off + lb], "utf-8"); off += lb
    obj = str(meta[off:off + lo], "utf-8"); off += lo
    vid = str(meta[off:off + lv], "utf-8"); off += lv
    etag = str(meta[off:off + le], "utf-8"); off += le
    return bucket, obj, (vid, etag, size, mt), offset, length


def _pack_recon_meta(survivors, targets, block_lens) -> bytes:
    """Meta chunk for an OP_RECONSTRUCT request: [u8 n_surv][surv*]
    [u8 n_tgt][tgt*][u32 block_len]* — positions fit u8 (n <= 256)."""
    import struct

    return struct.pack(
        f"<B{len(survivors)}BB{len(targets)}B{len(block_lens)}I",
        len(survivors), *survivors, len(targets), *targets, *block_lens)


def _unpack_recon_meta(meta):
    import struct

    ns = meta[0]
    survivors = tuple(meta[1:1 + ns])
    off = 1 + ns
    nt = meta[off]
    targets = tuple(meta[off + 1:off + 1 + nt])
    off += 1 + nt
    nlens = (len(meta) - off) // 4
    block_lens = list(struct.unpack_from(f"<{nlens}I", meta, off))
    return survivors, targets, block_lens


class _PendingRingReconstruct:
    """PendingDecode-shaped handle for a ring-submitted reconstruct:
    wait() polls the slot and rebuilds the (rebuilt chunk rows, digest
    rows) contract; any ring fault falls back to the local plane."""

    def __init__(self, client: "LaneClient", slot: int, seq: int,
                 k: int, m: int, shard_chunks, block_lens, targets: tuple,
                 with_digests: bool):
        self._c = client
        self._slot = slot
        self._seq = seq
        self._k = k
        self._m = m
        self._rows = shard_chunks
        self._lens = block_lens
        self.targets = targets
        self._digests = with_digests

    def _fallback(self):
        pend = self._c.local().begin_reconstruct(
            self._k, self._m, self._rows, self._lens, self.targets,
            with_digests=self._digests)
        return pend.wait()

    def wait(self):
        resp = self._c._await_slot(self._slot, self._seq)
        if resp is None:
            self._c._note_fallback(shm.REASON_TIMEOUT)
            return self._fallback()
        t = len(self.targets)
        out_chunks: list[list[bytes]] = []
        out_digs: list[list[bytes]] | None = [] if self._digests else None
        pmv = memoryview(resp)
        off = 0
        for bl in self._lens:
            s = _ceil_div(bl, self._k)
            row = []
            for _ti in range(t):
                row.append(pmv[off:off + s].tobytes())
                off += s
            out_chunks.append(row)
            if out_digs is not None:
                out_digs.append([pmv[off + i * 32:off + (i + 1) * 32]
                                 .tobytes() for i in range(t)])
                off += t * 32
        return out_chunks, out_digs


class LaneClient:
    """Ring-side stand-in for the process BatchPlane (non-owner
    workers). Not a subclass — it forwards everything it does not
    route over the ring to the worker-local plane."""

    def __init__(self, ring: shm.Ring, worker: int, nworkers: int,
                 device="cuda"):
        self.ring = ring
        self.device = device
        self.worker = worker
        per = max(1, ring.nslots // max(1, nworkers))
        self._lo = min(worker * per, ring.nslots)
        self._hi = min(self._lo + per, ring.nslots)
        self._mu = threading.Lock()
        self._leased: set[int] = set()
        self._seq = (os.getpid() & 0xFFFFFFFF) << 32
        self._degraded_until = 0.0
        self._timeout = shm.ring_timeout_s()
        self._wlabel = str(worker)
        # QoS (MTPU_QOS=1): per-tenant OP_HOTGET ring admission — a
        # tenant over its probe quota or slot share is denied the RING,
        # not the request (the local drive path still serves), so the
        # degradation is the existing fallback, reason "qos". None when
        # disarmed.
        self._hotget_gate = qos.ring_gate(max(1, self._hi - self._lo))
        self.closed = False

    # -- local-plane delegation ----------------------------------------

    def local(self):
        from minio_tpu_torch import dataplane

        return dataplane.get_plane(self.device)

    def accepts_chunk(self, s: int) -> bool:
        return self.local().accepts_chunk(s)

    def accepts_recon_chunk(self, s: int) -> bool:
        return self.local().accepts_recon_chunk(s)

    def decode_blocks(self, *a, **kw):
        return self.local().decode_blocks(*a, **kw)

    def _note_fallback(self, reason: str) -> None:
        _RING_FALLBACKS.labels(worker=self._wlabel, reason=reason).inc()

    def _tid(self) -> bytes:
        """The current request's trace id, as slot-header bytes — the
        lane server restores it around the serve so cross-process work
        stays attributed to the originating request."""
        t = obs.trace_id()
        return t.encode("ascii", "replace") if t else b""

    # -- slot machinery -------------------------------------------------

    def _acquire(self) -> tuple[int, int] | None:
        if time.monotonic() < self._degraded_until:
            return None
        with self._mu:
            for i in range(self._lo, self._hi):
                if i in self._leased:
                    continue
                if self.ring.state(i) == shm.FREE:
                    self._leased.add(i)
                    self._seq += 1
                    return i, self._seq
        return None

    def _release(self, slot: int, abandoned: bool = False) -> None:
        with self._mu:
            self._leased.discard(slot)
        if abandoned:
            # Server owns the slot now; it flips ABANDONED->FREE when
            # (and only when) its task for this seq completes.
            self.ring._set_state(slot, shm.ABANDONED)
            self._degraded_until = time.monotonic() + 5.0

    def _await_slot(self, slot: int, seq: int):
        """Poll until the server commits (DONE/ERROR) for `seq`; returns
        a private copy of the response bytes, or None on any miss. The
        whole wait lands on the request timeline as a `ring_wait` stamp
        (submission → response, i.e. the cross-process hop)."""
        t_wait = time.perf_counter()
        try:
            return self._poll_slot(slot, seq)
        finally:
            flight.stamp("ring_wait", time.perf_counter() - t_wait,
                         "ring")

    def _poll_slot(self, slot: int, seq: int):
        deadline = time.monotonic() + self._timeout
        pause = 20e-6
        while True:
            st = self.ring.state(slot)
            if st in (shm.DONE, shm.ERROR):
                head = self.ring.head(slot)
                resp_len, resp_seq = head[8], head[9]
                if resp_seq != seq:
                    # Stale response from a previous incarnation of this
                    # slot — treat as a miss; the slot recycles below.
                    self.ring._set_state(slot, shm.FREE)
                    self._release(slot)
                    return None
                resp = None
                if st == shm.DONE:
                    resp = bytearray(resp_len)
                    resp[:] = self.ring.resp_view(slot)[:resp_len]
                self.ring._set_state(slot, shm.FREE)
                self._release(slot)
                return resp
            if time.monotonic() > deadline:
                self._release(slot, abandoned=True)
                return None
            time.sleep(pause)
            pause = min(pause * 2, 500e-6)

    # -- BatchPlane surface --------------------------------------------

    def digest_chunks(self, chunks: list, cap: int) -> list[bytes]:
        need_req = shm.chunks_size(chunks)
        need_resp = len(chunks) * 32
        if (not chunks or need_req > self.ring.req_cap
                or need_resp > self.ring.resp_cap):
            if chunks:
                self._note_fallback(shm.REASON_OVERSIZE)
            return self.local().digest_chunks(chunks, cap)
        got = self._acquire()
        if got is None:
            self._note_fallback(shm.REASON_NO_SLOT)
            return self.local().digest_chunks(chunks, cap)
        slot, seq = got
        req_len = shm.pack_chunks(self.ring.req_view(slot), chunks)
        self.ring.publish(slot, shm.OP_DIGEST, 0, 0, 0, seq,
                          len(chunks), req_len, self._tid(),
                          qos.tenant_tag())
        _RING_SUBMITS.labels(worker=self._wlabel, op="digest").inc()
        resp = self._await_slot(slot, seq)
        if resp is None:
            self._note_fallback(shm.REASON_TIMEOUT)
            return self.local().digest_chunks(chunks, cap)
        return [bytes(resp[i * 32:(i + 1) * 32]) for i in range(len(chunks))]

    def begin_reconstruct(self, k: int, m: int, shard_chunks: list,
                          block_lens: list, targets,
                          with_digests: bool = False):
        """Heal-shaped reconstruct over the ring: one failure pattern
        per batch; per-block survivor rows ride as concatenated chunks
        behind a meta chunk. Any miss falls back to the local plane."""
        targets = tuple(targets)
        n = k + m
        if not shard_chunks or not targets:
            return self.local().begin_reconstruct(
                k, m, shard_chunks, block_lens, targets,
                with_digests=with_digests)
        survivors = tuple(
            i for i in range(n) if shard_chunks[0][i] is not None)[:k]
        rows = []
        for bi, row in enumerate(shard_chunks):
            s = _ceil_div(block_lens[bi], k)
            buf = bytearray(k * s)
            ok = len(row) == n
            for ci, si in enumerate(survivors):
                c = row[si] if ok and row[si] is not None else None
                if c is None or len(c) != s:
                    ok = False
                    break
                buf[ci * s:(ci + 1) * s] = c
            if not ok:
                # Ragged/mismatched pattern: the local plane validates
                # and serves (shared-lane coalescing is best-effort).
                return self.local().begin_reconstruct(
                    k, m, shard_chunks, block_lens, targets,
                    with_digests=with_digests)
            rows.append(buf)
        meta = _pack_recon_meta(survivors, targets, block_lens)
        chunks = [meta] + rows
        t = len(targets)
        need_resp = sum((_ceil_div(bl, k) * t
                         + (t * 32 if with_digests else 0))
                        for bl in block_lens)
        if (shm.chunks_size(chunks) > self.ring.req_cap
                or need_resp > self.ring.resp_cap):
            self._note_fallback(shm.REASON_OVERSIZE)
            return self.local().begin_reconstruct(
                k, m, shard_chunks, block_lens, targets,
                with_digests=with_digests)
        got = self._acquire()
        if got is None:
            self._note_fallback(shm.REASON_NO_SLOT)
            return self.local().begin_reconstruct(
                k, m, shard_chunks, block_lens, targets,
                with_digests=with_digests)
        slot, seq = got
        req_len = shm.pack_chunks(self.ring.req_view(slot), chunks)
        flags = shm.FLAG_DIGESTS if with_digests else 0
        self.ring.publish(slot, shm.OP_RECONSTRUCT, flags, k, m, seq,
                          len(chunks), req_len, self._tid(),
                          qos.tenant_tag())
        _RING_SUBMITS.labels(worker=self._wlabel, op="reconstruct").inc()
        return _PendingRingReconstruct(self, slot, seq, k, m, shard_chunks,
                                       block_lens, targets, with_digests)

    def begin_encode(self, k: int, m: int, block_size: int,
                     blocks: list, with_digests: bool = False):
        need_req = shm.chunks_size(blocks)
        need_resp = sum(m * _ceil_div(len(b), k) for b in blocks)
        if with_digests:
            need_resp += len(blocks) * (k + m) * 32
        if (not blocks or need_req > self.ring.req_cap
                or need_resp > self.ring.resp_cap):
            if blocks:
                self._note_fallback(shm.REASON_OVERSIZE)
            return self.local().begin_encode(k, m, block_size, blocks,
                                             with_digests=with_digests)
        got = self._acquire()
        if got is None:
            self._note_fallback(shm.REASON_NO_SLOT)
            return self.local().begin_encode(k, m, block_size, blocks,
                                             with_digests=with_digests)
        slot, seq = got
        req_len = shm.pack_chunks(self.ring.req_view(slot), blocks)
        flags = shm.FLAG_DIGESTS if with_digests else 0
        self.ring.publish(slot, shm.OP_ENCODE, flags, k, m, seq,
                          len(blocks), req_len, self._tid(),
                          qos.tenant_tag())
        _RING_SUBMITS.labels(worker=self._wlabel, op="encode").inc()
        return _PendingRingEncode(self, slot, seq, k, m, block_size,
                                  blocks, with_digests)

    def hot_get(self, bucket: str, obj: str, ident: tuple, offset: int,
                length: int) -> bytearray | None:
        """Probe the lane owner's hot-object tier for [offset,
        offset+length) of a key whose elected identity is `ident`;
        None on any miss (cold, identity mismatch, oversize, no slot,
        timeout) — the caller serves its local drive path. The probe
        itself feeds the owner's shared heat tracker, so sibling GETs
        drive admission exactly like the owner's own. A served ERROR
        and an abandoned slot are both accounted `hot_miss` (the poll
        cannot tell them apart after the slot recycles)."""
        meta = _pack_hotget(bucket, obj, ident, offset, length)
        if (4 + len(meta) > self.ring.req_cap
                or length > self.ring.resp_cap):
            self._note_fallback(shm.REASON_OVERSIZE)
            return None
        gate = self._hotget_gate
        tkey = qos.current_key() if gate is not None else ""
        if gate is not None and not gate.acquire(tkey):
            self._note_fallback(shm.REASON_QOS)
            return None
        try:
            got = self._acquire()
            if got is None:
                self._note_fallback(shm.REASON_NO_SLOT)
                return None
            slot, seq = got
            req_len = shm.pack_chunks(self.ring.req_view(slot), [meta])
            self.ring.publish(slot, shm.OP_HOTGET, 0, 0, 0, seq, 1,
                              req_len, self._tid(), qos.tenant_tag())
            _RING_SUBMITS.labels(worker=self._wlabel, op="hotget").inc()
            resp = self._await_slot(slot, seq)
        finally:
            if gate is not None:
                gate.release(tkey)
        if resp is None or len(resp) != length:
            self._note_fallback(shm.REASON_HOT_MISS)
            return None
        return resp

    def close(self) -> None:
        self.closed = True
        self.ring.close()


class HotRingClient:
    """Tier-shaped stand-in for sibling workers (hottier.set_router):
    hits ride the ring into worker 0's device-resident tier; misses,
    heat and invalidation all resolve server-side — the OP_HOTGET
    probe carries the caller's freshly elected identity, so a stale
    resident entry can only miss, never serve."""

    def __init__(self, lane: LaneClient):
        self._lane = lane

    def serve(self, bucket: str, obj: str, fi, offset: int, length: int):
        from minio_tpu_torch.hottier.tier import fi_ident

        return self.serve_ident(bucket, obj, fi_ident(fi), offset,
                                length)

    def serve_ident(self, bucket: str, obj: str, ident: tuple,
                    offset: int, length: int):
        if length <= 0:
            return None
        data = self._lane.hot_get(bucket, obj, ident, offset, length)
        if data is None:
            return None
        return iter([memoryview(data)])

    def note_miss(self, bucket: str, obj: str, size: int, reader=None,
                  grid=None) -> None:
        """No-op: the OP_HOTGET probe already fed the owner's heat."""

    def invalidate(self, bucket: str, obj: str) -> None:
        """No-op: the owner drops a stale entry the first time any
        worker's probe shows a newer elected identity."""

    def invalidate_bucket(self, bucket: str) -> None:
        """No-op — same contract as invalidate()."""


class LaneServer:
    """Drains the ring into the owner worker's local BatchPlane."""

    def __init__(self, ring: shm.Ring, plane=None, pool: int = 8,
                 worker: int = 0, device="cuda"):
        self.ring = ring
        self._plane = plane
        self.device = device
        self._stop = threading.Event()
        self._inflight: set[int] = set()
        self._mu = threading.Lock()
        self._wlabel = str(worker)
        self._pool = ThreadPoolExecutor(
            max_workers=pool, thread_name_prefix="mtpu-frontdoor-lane")
        ring.reset_stale()
        self._thread = threading.Thread(
            target=self._scan_loop, daemon=True,
            name="mtpu-frontdoor-ring")
        self._thread.start()

    def plane(self):
        if self._plane is not None:
            return self._plane
        from minio_tpu_torch import dataplane

        return dataplane.get_plane(self.device)

    def _scan_loop(self) -> None:
        while not self._stop.is_set():
            busy = False
            for i in range(self.ring.nslots):
                st = self.ring.state(i)
                if st == shm.ABANDONED:
                    # A producer stopped waiting AFTER our task finished
                    # (or a respawn fenced it): with no in-flight task
                    # the slot is provably quiescent — recycle it.
                    with self._mu:
                        if i not in self._inflight:
                            self.ring._set_state(i, shm.FREE)
                    continue
                if st != shm.SUBMITTED:
                    continue
                with self._mu:
                    if i in self._inflight:
                        continue
                    self._inflight.add(i)
                busy = True
                self._pool.submit(obs.ctx_wrap(
                    lambda i=i: self._serve_slot(i)))
            if not busy:
                # Idle poll: 500us keeps worst-case ring latency at the
                # same order as the plane's own max-wait batching bound.
                self._stop.wait(500e-6)

    def _serve_slot(self, i: int) -> None:
        try:
            (st, op, flags, k, m, seq, rows, req_len, _rl, _rs, tid_raw,
             ten_raw) = self.ring.head(i)
            if st != shm.SUBMITTED:
                return
            # Restore the submitting worker's trace AND tenant context
            # from the slot header: trace records and the server-side
            # timeline below attribute to the ORIGINATING request, not
            # to the lane owner's scanner thread — and the CodecRequests
            # this serve submits into the local plane carry the
            # originating tenant, so QoS charges the right lane.
            tid = shm.decode_tid(tid_raw)
            tenant = shm.decode_tenant(ten_raw)
            opname = _OP_NAMES.get(op, "unknown")
            tok = obs.set_trace_context(tid) if tid else None
            qtok = qos.bind_key(tenant) if tenant else None
            tl = flight.detached(tid, f"ring:{opname}") if tid else None
            t0 = time.perf_counter()
            ok = True
            try:
                try:
                    reqs = shm.unpack_chunks(self.ring.req_view(i), rows,
                                             req_len)
                    if op == shm.OP_DIGEST:
                        resp_len = self._do_digest(i, reqs)
                    elif op == shm.OP_ENCODE:
                        resp_len = self._do_encode(
                            i, reqs, k, m, bool(flags & shm.FLAG_DIGESTS))
                    elif op == shm.OP_RECONSTRUCT:
                        resp_len = self._do_reconstruct(
                            i, reqs, k, m, bool(flags & shm.FLAG_DIGESTS))
                    elif op == shm.OP_HOTGET:
                        resp_len = self._do_hotget(i, reqs)
                    else:
                        raise ValueError(f"unknown ring op {op}")
                except Exception as e:  # noqa: BLE001 - travels to the
                    # producer as a typed ring ERROR; it recomputes
                    # locally
                    ok = False
                    msg = f"{type(e).__name__}: {e}".encode()[
                        :self.ring.resp_cap]
                    self.ring.resp_view(i)[:len(msg)] = msg
                    self.ring.respond(i, seq, len(msg), ok=False)
                    return
                self.ring.respond(i, seq, resp_len, ok=True)
                _RING_SERVED.labels(worker=self._wlabel,
                                    op=opname).inc()
            finally:
                dur = time.perf_counter() - t0
                if tl is not None:
                    tl.mark("serve", "ring")
                    flight.finish(tl, status=200 if ok else 500)
                if obs.has_subscribers():
                    obs.publish({"type": "ring", "plane": "ring",
                                 "op": opname, "slot": i,
                                 "rows": rows, "ok": ok,
                                 "worker": self._wlabel,
                                 "tenant": tenant,
                                 "time": time.time(),
                                 "durationNs": int(dur * 1e9)})
                if qtok is not None:
                    qos.reset(qtok)
                if tok is not None:
                    obs.reset_trace_context(tok)
        finally:
            with self._mu:
                self._inflight.discard(i)

    def _do_digest(self, i: int, chunks: list) -> int:
        cap = max(len(c) for c in chunks)
        digs = self.plane().digest_chunks(chunks, cap)
        out = self.ring.resp_view(i)
        for j, d in enumerate(digs):
            out[j * 32:(j + 1) * 32] = bytes(d)
        return len(digs) * 32

    def _do_encode(self, i: int, blocks: list, k: int, m: int,
                   with_digests: bool) -> int:
        bs = max(len(b) for b in blocks)
        pend = self.plane().begin_encode(k, m, bs, blocks,
                                         with_digests=with_digests)
        chunk_rows, dig_rows = pend.wait()
        out = self.ring.resp_view(i)
        off = 0
        for bi, block in enumerate(blocks):
            s = _ceil_div(len(block), k)
            for j in range(m):
                out[off:off + s] = chunk_rows[bi][k + j]
                off += s
            if with_digests:
                for d in dig_rows[bi]:
                    out[off:off + 32] = d
                    off += 32
        return off

    def _do_hotget(self, i: int, reqs: list) -> int:
        """Serve a sibling's hot GET from this worker's tier; a miss
        raises (→ ring ERROR → the sibling's drive path) AFTER feeding
        the shared heat tracker, so sibling traffic drives admission."""
        from minio_tpu_torch import hottier

        bucket, obj, ident, offset, length = _unpack_hotget(reqs[0])
        tier = hottier.get_tier(self.device) if hottier.enabled() else None
        if tier is None:
            raise ValueError("hot tier disabled on the lane owner")
        served = tier.serve_ident(bucket, obj, ident, offset, length)
        if served is None:
            # ident[2] is the elected size; reader=None resolves to the
            # process-global reader this worker registered at boot.
            tier.note_miss(bucket, obj, ident[2])
            raise LookupError("hottier miss")
        out = self.ring.resp_view(i)
        off = 0
        for mv in served:
            ln = len(mv)
            out[off:off + ln] = mv
            off += ln
        return off

    def _do_reconstruct(self, i: int, reqs: list, k: int, m: int,
                        with_digests: bool) -> int:
        survivors, targets, block_lens = _unpack_recon_meta(reqs[0])
        n = k + m
        shard_chunks = []
        for bi, row_buf in enumerate(reqs[1:]):
            s = _ceil_div(block_lens[bi], k)
            row: list = [None] * n
            for ci, si in enumerate(survivors):
                row[si] = row_buf[ci * s:(ci + 1) * s]
            shard_chunks.append(row)
        pend = self.plane().begin_reconstruct(
            k, m, shard_chunks, block_lens, targets,
            with_digests=with_digests)
        chunk_rows, dig_rows = pend.wait()
        out = self.ring.resp_view(i)
        off = 0
        for bi, row in enumerate(chunk_rows):
            for c in row:
                out[off:off + len(c)] = c
                off += len(c)
            if with_digests:
                for d in dig_rows[bi]:
                    out[off:off + 32] = d
                    off += 32
        return off

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._thread.join(timeout)
        self._pool.shutdown(wait=False)
