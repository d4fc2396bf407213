"""Shared-memory submission ring: cross-process dataplane coalescing
(counterpart of minio_tpu/frontdoor/shm.py; the layout is byte for byte
the JAX one, so either package's workers share one ring).

Worker processes cannot share one in-process `BatchPlane`, but they CAN
share its launches: every worker submits codec work (PUT shard encodes,
bitrot digest batches) into a ring of fixed-size shared-memory slots;
the lane *server* (worker 0) drains the ring into its local plane, so
concurrent requests from ALL workers coalesce into the same fused
kernel launches — more rows per launch, not N smaller batchers.

Protocol (single-producer / single-consumer per slot):

- The ring is one `multiprocessing.shared_memory` segment: a header
  plus `nslots` slots. Each slot = a 64-byte slot header, a request
  area (written only by the owning worker) and a response area
  (written only by the lane server) — split areas mean a late server
  write can never clobber a successor request's bytes.
- Slots are partitioned by worker id: worker w owns `nslots/nworkers`
  contiguous slots and allocates among its own request threads under a
  process-local lock, so every slot has exactly one producer process.
- States: FREE -> SUBMITTED (producer, state byte written last) ->
  DONE|ERROR (server, after the response area + resp_seq land) ->
  FREE (producer, after copying the response out).
- Crash tolerance: a producer that stops waiting marks the slot
  ABANDONED; the server flips ABANDONED->FREE when its in-flight task
  for that slot completes (or at boot, when it has none). A dead
  worker's whole range is reset by the supervisor on respawn. Every
  claim is guarded by a per-use `seq` (seeded from the producer pid):
  the server re-checks (state, seq) before committing DONE and echoes
  the seq in `resp_seq`, so a response can never be attributed to a
  request it was not computed for.
- A worker that cannot get ring service (no free slot, timeout, server
  dead) falls back to its process-local plane — the ring is a
  throughput optimization, never a correctness dependency.

Byte ordering relies on CPython writing shared memory with plain
memcpy under x86-TSO (payload stores land before the state-byte
store); the state machine above makes every transition single-writer.
"""

from __future__ import annotations

import os
import struct
import threading

MAGIC = b"MTPUFDR3"   # v3: slot header carries trace id + tenant tag
_HDR = struct.Struct("<8sII")       # magic, nslots, slot_bytes
_HDR_SIZE = 64
# state, op, flags, k, m, pad, seq, rows, req_len, resp_len, resp_seq,
# trace id (16 ASCII bytes, NUL-padded — the S3 request id of the
# submitting worker's request, so the lane server's batch/ring records
# attribute cross-process work to the originating request), tenant tag
# (12 utf-8 bytes, NUL-padded — the originating tenant's key, truncated;
# worker 0 rebinds it before submitting into its local plane so the QoS
# scheduler charges ring work to the right lane). Exactly fills the
# 64-byte slot header.
_SLOT = struct.Struct("<BBBBBxxxQIIIQ16s12s")
_SLOT_SIZE = 64
assert _SLOT.size == _SLOT_SIZE

FREE, SUBMITTED, DONE, ERROR, ABANDONED = 0, 1, 2, 3, 4
# OP_RECONSTRUCT: heal/degraded-GET rebuilds ride the ring too
# — one failure pattern per batch (the heal shape); the request carries
# a meta chunk (survivors, targets, block lens) ahead of the per-block
# survivor rows, the response the rebuilt target chunks (+ digests).
# OP_HOTGET (hot-object tier): a sibling worker's hot
# GET probes worker 0's device-resident tier — the request is one meta
# chunk (key + elected-FileInfo identity + byte range), the DONE
# response the requested payload bytes; a miss travels as ERROR and
# the sibling serves its local drive path. The probe doubles as the
# heat feed, so every worker's GETs drive one shared admission policy.
OP_DIGEST, OP_ENCODE, OP_RECONSTRUCT, OP_HOTGET = 1, 2, 3, 4
# Every ring dispatch site (the LaneServer drain, its served-op label
# map, the LaneClient builders) handles every member.
RING_OPS = {
    "OP_DIGEST": OP_DIGEST,
    "OP_ENCODE": OP_ENCODE,
    "OP_RECONSTRUCT": OP_RECONSTRUCT,
    "OP_HOTGET": OP_HOTGET,
}
FLAG_DIGESTS = 1

# Why a LaneClient gave up on ring service and fell back to its local
# plane: the `ring_fallbacks_total{reason}` label set is exactly these.
REASON_OVERSIZE = "oversize"    # op exceeds the slot request area
REASON_NO_SLOT = "no_slot"      # worker's slot range fully in flight
REASON_TIMEOUT = "timeout"      # server missed the slot deadline
REASON_HOT_MISS = "hot_miss"    # hot-tier probe answered ERROR (miss)
REASON_QOS = "qos"              # tenant over its ring share/quota
RING_FALLBACK_REASONS = {
    "REASON_OVERSIZE": REASON_OVERSIZE,
    "REASON_NO_SLOT": REASON_NO_SLOT,
    "REASON_TIMEOUT": REASON_TIMEOUT,
    "REASON_HOT_MISS": REASON_HOT_MISS,
    "REASON_QOS": REASON_QOS,
}

_U32 = struct.Struct("<I")

DEFAULT_SLOT_BYTES = 1 << 20
DEFAULT_SLOTS_PER_WORKER = 4


def slot_bytes() -> int:
    return int(os.environ.get("MTPU_FRONTDOOR_SLOT_BYTES",
                              str(DEFAULT_SLOT_BYTES)))


def ring_timeout_s() -> float:
    """How long a producer waits on a submitted slot before abandoning
    it and recomputing locally."""
    return float(os.environ.get("MTPU_FRONTDOOR_RING_TIMEOUT_S", "2.0"))


class Ring:
    """Attachment to (or creation of) the shared submission ring."""

    def __init__(self, shm, nslots: int, slot_cap: int, owner: bool):
        self._shm = shm
        self.nslots = nslots
        self.slot_cap = slot_cap          # payload bytes per slot
        self.req_cap = (slot_cap * 3) // 4
        self.resp_cap = slot_cap - self.req_cap
        self._owner = owner
        self._stride = _SLOT_SIZE + slot_cap
        self.buf = shm.buf

    # -- construction ---------------------------------------------------

    @classmethod
    def create(cls, nslots: int, slot_cap: int | None = None) -> "Ring":
        from multiprocessing import shared_memory

        cap = slot_cap if slot_cap is not None else slot_bytes()
        size = _HDR_SIZE + nslots * (_SLOT_SIZE + cap)
        shm = shared_memory.SharedMemory(create=True, size=size)
        _HDR.pack_into(shm.buf, 0, MAGIC, nslots, cap)
        ring = cls(shm, nslots, cap, owner=True)
        for i in range(nslots):
            ring._set_state(i, FREE)
        return ring

    @classmethod
    def attach(cls, name: str) -> "Ring":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        # CPython registers attachments with the resource tracker as
        # if they owned the segment; the supervisor owns this one, so
        # deregister or every worker exit warns about (and may unlink)
        # a segment that is not its to clean up.
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        # tracker internals vary by Python
        # version; the tracking noise is cosmetic, never fatal.
        except Exception:  # noqa: BLE001
            pass
        magic, nslots, cap = _HDR.unpack_from(shm.buf, 0)
        if magic != MAGIC:
            shm.close()
            raise ValueError(f"shm segment {name!r} is not a frontdoor ring")
        return cls(shm, nslots, cap, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):
            return

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except OSError:
                return

    # -- slot accessors -------------------------------------------------

    def _off(self, i: int) -> int:
        return _HDR_SIZE + i * self._stride

    def head(self, i: int) -> tuple:
        """(state, op, flags, k, m, seq, rows, req_len, resp_len,
        resp_seq, tid, tenant)"""
        return _SLOT.unpack_from(self.buf, self._off(i))

    def state(self, i: int) -> int:
        return self.buf[self._off(i)]

    def _set_state(self, i: int, st: int) -> None:
        self.buf[self._off(i)] = st

    def req_view(self, i: int):
        off = self._off(i) + _SLOT_SIZE
        return memoryview(self.buf)[off:off + self.req_cap]

    def resp_view(self, i: int):
        off = self._off(i) + _SLOT_SIZE + self.req_cap
        return memoryview(self.buf)[off:off + self.resp_cap]

    def publish(self, i: int, op: int, flags: int, k: int, m: int,
                seq: int, rows: int, req_len: int,
                tid: bytes = b"", tenant: bytes = b"") -> None:
        """Producer: header first (state FREE), then the state byte —
        the SUBMITTED store is the commit point. `tid` is the
        originating request's trace id (≤16 ASCII bytes); `tenant` the
        originating tenant key tag (≤12 utf-8 bytes)."""
        _SLOT.pack_into(self.buf, self._off(i), FREE, op, flags, k, m,
                        seq, rows, req_len, 0, 0, tid[:16], tenant[:12])
        self._set_state(i, SUBMITTED)

    def respond(self, i: int, seq: int, resp_len: int, ok: bool) -> bool:
        """Server: commit the response written to resp_view. Re-checks
        (state, seq) so a response never lands on a slot the producer
        has already abandoned/reused; echoes seq as resp_seq."""
        off = self._off(i)
        st, op, flags, k, m, cur_seq, rows, req_len, _rl, _rs, tid, ten = \
            _SLOT.unpack_from(self.buf, off)
        if st != SUBMITTED or cur_seq != seq:
            if st == ABANDONED and cur_seq == seq:
                self._set_state(i, FREE)
            return False
        _SLOT.pack_into(self.buf, off, SUBMITTED, op, flags, k, m,
                        seq, rows, req_len, resp_len, seq, tid, ten)
        self._set_state(i, DONE if ok else ERROR)
        return True

    def reset_range(self, lo: int, hi: int) -> None:
        """Supervisor: a dead worker's slots go back to FREE (any
        in-flight server task for them is fenced off by seq)."""
        for i in range(lo, min(hi, self.nslots)):
            self._set_state(i, FREE)

    def reset_stale(self) -> None:
        """Server boot: nothing can be in flight, so ABANDONED/DONE
        leftovers from a dead predecessor all return to FREE."""
        for i in range(self.nslots):
            if self.state(i) in (ABANDONED, DONE, ERROR):
                self._set_state(i, FREE)


# -- request/response encodings ----------------------------------------


def pack_chunks(view, chunks) -> int:
    """[u32 len | bytes]* into `view`; returns bytes written."""
    off = 0
    for c in chunks:
        ln = len(c)
        _U32.pack_into(view, off, ln)
        view[off + 4:off + 4 + ln] = c
        off += 4 + ln
    return off


def unpack_chunks(area, rows: int, req_len: int) -> list:
    """Memoryview slices into the request area (valid until the slot
    recycles — the server consumes them within its task)."""
    out = []
    off = 0
    for _ in range(rows):
        (ln,) = _U32.unpack_from(area, off)
        out.append(area[off + 4:off + 4 + ln])
        off += 4 + ln
    if off != req_len:
        raise ValueError("ring request framing mismatch")
    return out


def chunks_size(chunks) -> int:
    return sum(4 + len(c) for c in chunks)


def decode_tid(tid: bytes) -> str:
    """Slot-header trace id bytes -> trace id string ('' when absent)."""
    return tid.rstrip(b"\x00").decode("ascii", "replace")


def decode_tenant(ten: bytes) -> str:
    """Slot-header tenant tag bytes -> tenant key ('' when absent)."""
    return ten.rstrip(b"\x00").decode("utf-8", "replace")


# -- flight-recorder spool ----------------------------------------------
#
# The admin perf endpoint must see EVERY worker's flight recorder, but
# timelines complete at request rate — far too hot for a control-socket
# round trip per request. Instead each worker owns a small shared-memory
# spool (single writer, round-robin over fixed slots) and appends every
# completed timeline snapshot as JSON; at query time any worker attaches
# its siblings' spools read-only and merges. Readers tolerate torn
# writes (a snapshot being overwritten mid-read) by construction: the
# length word is cleared before the payload is rewritten and stored
# last, and a JSON parse failure just skips the slot — the spool is a
# best-effort observability cache, never a correctness dependency.

FLIGHT_MAGIC = b"MTPUFLS1"
DEFAULT_FLIGHT_SLOTS = 128
DEFAULT_FLIGHT_SLOT_BYTES = 4096


class FlightSpool:
    """Per-worker shm ring of recent timeline snapshots (JSON)."""

    MAGIC = FLIGHT_MAGIC

    def __init__(self, shm, nslots: int, cap: int, owner: bool):
        self._shm = shm
        self.nslots = nslots
        self.cap = cap
        self._owner = owner
        self._cursor = 0
        # The port's server finishes timelines on many handler threads:
        # one writer at a time per spool.
        self._mu = threading.Lock()
        self.buf = shm.buf

    @classmethod
    def create(cls, name: str, nslots: int = DEFAULT_FLIGHT_SLOTS,
               cap: int = DEFAULT_FLIGHT_SLOT_BYTES) -> "FlightSpool":
        from multiprocessing import shared_memory

        size = _HDR_SIZE + nslots * (4 + cap)
        try:
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
        except FileExistsError:
            # Leftover from a crashed predecessor with the same name
            # (worker respawn): reclaim it.
            stale = shared_memory.SharedMemory(name=name)
            stale.close()
            stale.unlink()
            shm = shared_memory.SharedMemory(name=name, create=True,
                                             size=size)
        _HDR.pack_into(shm.buf, 0, cls.MAGIC, nslots, cap)
        return cls(shm, nslots, cap, owner=True)

    @classmethod
    def attach(cls, name: str) -> "FlightSpool":
        from multiprocessing import shared_memory

        shm = shared_memory.SharedMemory(name=name)
        try:
            from multiprocessing import resource_tracker

            resource_tracker.unregister(shm._name, "shared_memory")
        # tracker internals vary by Python
        # version; the tracking noise is cosmetic, never fatal.
        except Exception:  # noqa: BLE001
            pass
        magic, nslots, cap = _HDR.unpack_from(shm.buf, 0)
        if magic != cls.MAGIC:
            shm.close()
            raise ValueError(f"shm segment {name!r} is not a "
                             f"{cls.__name__} spool")
        return cls(shm, nslots, cap, owner=False)

    @property
    def name(self) -> str:
        return self._shm.name

    def _off(self, i: int) -> int:
        return _HDR_SIZE + i * (4 + self.cap)

    def put(self, snap: dict) -> None:
        """Owner only. Oversized snapshots are dropped (the local ring
        still has them; only the cross-worker view loses the entry)."""
        import json

        raw = json.dumps(snap, separators=(",", ":")).encode()
        if len(raw) > self.cap:
            return
        with self._mu:
            i = self._cursor
            self._cursor = (i + 1) % self.nslots
            off = self._off(i)
            _U32.pack_into(self.buf, off, 0)
            self.buf[off + 4:off + 4 + len(raw)] = raw
            _U32.pack_into(self.buf, off, len(raw))

    def read_all(self) -> list[dict]:
        import json

        out = []
        for i in range(self.nslots):
            off = self._off(i)
            (ln,) = _U32.unpack_from(self.buf, off)
            if not ln or ln > self.cap:
                continue
            try:
                # Decode straight off the shm view (json.loads takes
                # str) — no intermediate bytes copy.
                out.append(json.loads(str(
                    memoryview(self.buf)[off + 4:off + 4 + ln], "utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue  # torn write — writer is mid-overwrite
        return out

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):
            return

    def unlink(self) -> None:
        if self._owner:
            try:
                self._shm.unlink()
            except OSError:
                return


# -- SLO state spool ----------------------------------------------------
#
# The SLO route (obs/slo.py) needs every worker's latest evaluation, and
# there is exactly ONE current state per worker: the spool is a
# single-slot mailbox that the engine overwrites after every evaluation,
# and siblings attach read-only at query time. Same torn-write tolerance
# as FlightSpool; the bytes are the JAX StateSpool's.

STATE_MAGIC = b"MTPUSLS1"
DEFAULT_STATE_BYTES = 32768


class StateSpool(FlightSpool):
    """Per-worker latest-JSON-state mailbox (a FlightSpool with one slot
    and its own magic)."""

    MAGIC = STATE_MAGIC

    @classmethod
    def create(cls, name: str, nslots: int = 1,
               cap: int = DEFAULT_STATE_BYTES) -> "StateSpool":
        return super().create(name, nslots, cap)
