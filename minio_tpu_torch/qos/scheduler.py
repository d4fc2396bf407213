"""Deficit-round-robin fair queue and token buckets for the QoS plane
(counterpart of minio_tpu/qos/scheduler.py, the same model and order).

`FairQueue` is a drop-in replacement for the `queue.Queue` that guards
each batch plane's admission (dataplane lane submission, metaplane WAL
commit). It keeps one FIFO lane per tenant and serves them by deficit
round robin: each visit tops a lane's deficit up by `quantum x weight`
and drains items (unit cost each) until the deficit runs out, so over
any window a backlogged tenant receives service proportional to its
weight and no tenant waits more than one full round (the starvation
bound: at most `quantum x sum(weights of other active lanes)` items are
served between two services of a backlogged lane).

Admission is where isolation happens. A non-control `put_nowait` is
checked against (1) the tenant's backlog share, `max(min_share,
cap x w / W)` where `W` sums the weights of tenants that currently hold
backlog (plus the requester): a saturated tenant hits `queue.Full` at
its share while other tenants still have admission headroom (when only
one tenant is active its share is the whole cap, so the queue stays
work-conserving) — and only then (2) the tenant's token buckets —
ops/sec and bytes/sec, raising `QuotaFull` so call sites can label the
shed `tenant_quota`. Capacity is checked BEFORE quota so a put bounced
off its share never burns rate tokens: a blocking `put()` re-tries on
every wakeup, and debit-first would push a share-pinned tenant into
spurious QuotaFull sheds on its own rejected attempts.

Control items (the batcher's `_CLOSE`, the WAL's `("flush", fut)` /
`("close", fut)`) are never quota-checked and never count against any
lane, but they must not overtake data: every enqueue takes a global
sequence number and a control item is released from `get()` only once
all lanes' heads are newer than it. That preserves the WAL flush
barrier ("every record enqueued before flush() is durable on return")
under DRR reordering — the reordering is confined to items enqueued
after the barrier.

Barrier items (`is_barrier`) are stronger: a strict ordering FENCE.
They ride their tenant lane like data (share + quota accounted), but
`get()` releases nothing enqueued after a queued barrier until the
barrier itself has drained, and the barrier drains only after
everything enqueued before it. The WAL wires its tombstone records
(`remove_prefix`, `blob_remove`, `remove`) as barriers: replay's
`fold()` resolves dominance by WAL FILE ORDER, so a tombstone that
physically preceded an earlier-submitted commit under its prefix would
resurrect an rmtree'd journal — and a commit submitted after the
tombstone, written before it, would be replay-deleted. The fence pins
file order to submit order exactly at tombstones and nowhere else.

All state is guarded by one condition variable; nothing blocking runs
under the lock (token buckets are pure arithmetic).
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque


class QuotaFull(queue.Full):
    """Rejected by a per-tenant token bucket (not by backlog pressure).

    Subclasses `queue.Full` so existing `except queue.Full` admission
    paths keep working; call sites that care use `isinstance` to label
    the shed `tenant_quota` instead of `lane_full`/`wal_full`.
    """


class TokenBucket:
    """Classic token bucket: `rate` tokens/sec, capacity `burst`.

    `take(n)` is non-blocking — refills lazily from a monotonic clock
    and either debits `n` tokens or returns False. A rate of 0 means
    unlimited (every take succeeds without touching the clock).
    """

    __slots__ = ("rate", "burst", "_level", "_t")

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst) if burst > 0 else float(rate)
        self._level = self.burst
        self._t = time.monotonic()

    def take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic()
        self._level = min(self.burst, self._level + (now - self._t) * self.rate)
        self._t = now
        if self._level >= n:
            self._level -= n
            return True
        return False

    def untake(self, n: float = 1.0) -> None:
        """Refund tokens from a take whose admission was then rejected
        by another check — the op never entered the queue, so it must
        not count against the rate."""
        if self.rate <= 0:
            return
        self._level = min(self.burst, self._level + n)


class _Lane:
    __slots__ = ("key", "weight", "items", "deficit", "ops", "byt")

    def __init__(self, key, weight, rate_ops, rate_bytes, burst_s):
        self.key = key
        self.weight = float(weight)
        self.items = deque()        # (seq, item)
        self.deficit = 0.0
        self.ops = TokenBucket(rate_ops, rate_ops * burst_s)
        self.byt = TokenBucket(rate_bytes, rate_bytes * burst_s)


class FairQueue:
    """Tenant-fair bounded queue, API-compatible with the `queue.Queue`
    subset the batch planes use (`put_nowait`, `put`, `get`,
    `get_nowait`, `empty`, `qsize`).

    The hard cap is `2 x cap`: per-tenant shares are computed against
    `cap` (so single-tenant behavior matches the plain queue's depth),
    but a tenant that was alone at full share is not immediately Full
    for everyone else when a second tenant arrives — the newcomer's
    share is carved from the headroom above `cap`.
    """

    def __init__(self, cap: int, *, weights=None, quantum: int = 4,
                 min_share: int = 1, rate_ops: float = 0.0,
                 rate_bytes: float = 0.0, burst_s: float = 1.0,
                 tenant_of=None, cost_of=None, is_control=None,
                 is_barrier=None, unattributed: str = "-"):
        self.cap = max(1, int(cap))
        self.quantum = max(1, int(quantum))
        self.min_share = max(1, int(min_share))
        self._weights = dict(weights or {})
        self._rate_ops = float(rate_ops)
        self._rate_bytes = float(rate_bytes)
        self._burst_s = float(burst_s)
        self._tenant_of = tenant_of
        self._cost_of = cost_of
        self._is_control = is_control
        self._is_barrier = is_barrier
        self._unattributed = unattributed
        self._cond = threading.Condition(threading.Lock())
        self._lanes: dict[str, _Lane] = {}
        self._active: list[_Lane] = []   # lanes with backlog, DRR order
        self._control: deque = deque()   # (seq, item)
        self._fences: deque = deque()    # seqs of queued barrier items
        self._seq = 0
        self._total = 0
        self._ai = 0                     # DRR cursor into _active

    # -- admission ---------------------------------------------------

    def _weight_of(self, key: str) -> float:
        w = self._weights.get(key)
        if w is None and "/" in key:
            w = self._weights.get(key.split("/", 1)[0])
        if w is None:
            w = self._weights.get("*", 1.0)
        return max(w, 0.001)

    def _lane(self, key: str) -> _Lane:
        lane = self._lanes.get(key)
        if lane is None:
            lane = _Lane(key, self._weight_of(key), self._rate_ops,
                         self._rate_bytes, self._burst_s)
            self._lanes[key] = lane
            if len(self._lanes) > 4096:   # unbounded-tenant backstop
                for k in [k for k, l in self._lanes.items()
                          if not l.items and l is not lane][:2048]:
                    del self._lanes[k]
        return lane

    def _share(self, lane: _Lane) -> int:
        w_act = sum(l.weight for l in self._active)
        if not lane.items:
            w_act += lane.weight
        if w_act <= 0:
            return self.cap
        return max(self.min_share, int(self.cap * lane.weight / w_act))

    def _key_for(self, item) -> str:
        if self._tenant_of is not None:
            try:
                key = self._tenant_of(item)
            # attribution is best-effort: a
            # callback failure routes the item to the "-" system lane
            # (the error IS converted to a result), never drops work.
            except Exception:  # noqa: BLE001
                key = None
            if key:
                return str(key)
        return self._unattributed

    def _admit(self, item) -> bool:
        """Enqueue under the lock, or raise QuotaFull / queue.Full."""
        if self._is_control is not None and self._is_control(item):
            self._seq += 1
            self._control.append((self._seq, item))
            self._total += 1
            self._cond.notify_all()
            return True
        key = self._key_for(item)
        lane = self._lane(key)
        # Capacity before quota: a put destined to bounce off the
        # backlog share must not burn the tenant's rate tokens (a
        # blocking put() re-debits on every wakeup retry otherwise).
        if self._total >= 2 * self.cap or len(lane.items) >= self._share(lane):
            raise queue.Full(key)
        if not lane.ops.take(1.0):
            raise QuotaFull(key)
        if self._rate_bytes > 0 and self._cost_of is not None:
            try:
                cost = float(self._cost_of(item) or 0)
            # an unpriceable item costs 0 bytes
            # (quota waived for it) rather than failing admission; the
            # ops bucket above still meters it.
            except Exception:  # noqa: BLE001
                cost = 0.0
            if cost > 0 and not lane.byt.take(cost):
                lane.ops.untake(1.0)   # the op was never admitted
                raise QuotaFull(key)
        self._seq += 1
        lane.items.append((self._seq, item))
        self._total += 1
        if self._is_barrier is not None and self._is_barrier(item):
            self._fences.append(self._seq)
        if len(lane.items) == 1:
            self._active.append(lane)
        self._cond.notify_all()
        return True

    def put_nowait(self, item) -> None:
        with self._cond:
            self._admit(item)

    def put(self, item, block: bool = True, timeout=None) -> None:
        if not block:
            return self.put_nowait(item)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                try:
                    self._admit(item)
                    return
                except QuotaFull:
                    raise
                except queue.Full:
                    remaining = None
                    if deadline is not None:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise
                    # Woken by get(); shares may have shifted since.
                    if not self._cond.wait(remaining):
                        raise

    # -- service -----------------------------------------------------

    def _control_ready(self) -> bool:
        if not self._control:
            return False
        cseq = self._control[0][0]
        for lane in self._active:
            if lane.items and lane.items[0][0] < cseq:
                return False
        return True

    def _pick(self):
        """Pop one item per DRR. Caller holds the lock and guarantees
        `_total > 0`."""
        if self._control_ready():
            self._total -= 1
            return self._control.popleft()[1]
        fence = self._fences[0] if self._fences else None
        while True:
            if self._ai >= len(self._active):
                self._ai = 0
            lane = self._active[self._ai]
            if fence is not None:
                head = lane.items[0][0]
                # Ordering fence (WAL tombstones): nothing enqueued
                # after the fence may drain before it, and the fence
                # itself goes only once it is the oldest item queued —
                # file order equals submit order exactly at fences.
                # Never livelocks: while any pre-fence item remains it
                # is some lane's head (lanes are seq-sorted), and once
                # none remains the fence head itself is eligible.
                if head > fence or (head == fence and any(
                        l.items[0][0] < fence for l in self._active
                        if l is not lane)):
                    self._ai += 1
                    continue
            if lane.deficit < 1.0:
                lane.deficit += self.quantum * lane.weight
                if lane.deficit < 1.0:
                    lane.deficit = 1.0
            seq, item = lane.items.popleft()
            lane.deficit -= 1.0
            self._total -= 1
            if fence is not None and seq == fence:
                self._fences.popleft()
            if not lane.items:
                lane.deficit = 0.0
                self._active.pop(self._ai)
            elif lane.deficit < 1.0:
                self._ai += 1
            self._cond.notify_all()   # a slot freed; wake any blocked put()
            return item

    def get(self, block: bool = True, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._total == 0:
                if not block:
                    raise queue.Empty
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise queue.Empty
                if not self._cond.wait(remaining):
                    raise queue.Empty
            return self._pick()

    def get_nowait(self):
        return self.get(block=False)

    def empty(self) -> bool:
        return self._total == 0

    def qsize(self) -> int:
        return self._total

    # -- introspection (admin/debug only) ----------------------------

    def backlog_by_tenant(self) -> dict[str, int]:
        with self._cond:
            return {l.key: len(l.items) for l in self._active}


class RingGate:
    """Per-tenant admission for OP_HOTGET ring probes on the client
    side. Over-quota or over-share probes are DENIED RING ACCESS, not
    503'd — the request is still servable from the local drive path, so
    the correct degradation is the existing fallback, accounted under
    the `qos` fallback reason.

    Two guards: a per-tenant ops/sec token bucket (0 = off) and a
    weighted share of the worker's slot range — a tenant may hold at
    most `max(1, slots x w / W_active)` in-flight probes, where
    `W_active` sums the weights of tenants currently holding slots
    (plus the requester), so a storming tenant cannot monopolize the
    ring while an idle ring serves anyone.
    """

    def __init__(self, slots: int, *, weights=None, rate_ops: float = 0.0,
                 burst_s: float = 1.0):
        self.slots = max(1, int(slots))
        self._weights = dict(weights or {})
        self._rate = float(rate_ops)
        self._burst_s = float(burst_s)
        self._mu = threading.Lock()
        self._inflight: dict[str, int] = {}
        self._buckets: dict[str, TokenBucket] = {}

    def _weight_of(self, key: str) -> float:
        w = self._weights.get(key)
        if w is None and "/" in key:
            w = self._weights.get(key.split("/", 1)[0])
        if w is None:
            w = self._weights.get("*", 1.0)
        return max(w, 0.001)

    def acquire(self, key: str) -> bool:
        with self._mu:
            if self._rate > 0:
                b = self._buckets.get(key)
                if b is None:
                    b = self._buckets[key] = TokenBucket(
                        self._rate, self._rate * self._burst_s)
                if not b.take(1.0):
                    return False
            held = self._inflight.get(key, 0)
            w = self._weight_of(key)
            w_act = sum(self._weight_of(k)
                        for k, n in self._inflight.items() if n > 0)
            if held == 0:
                w_act += w
            share = max(1, int(self.slots * w / w_act)) if w_act else self.slots
            if held >= share:
                return False
            self._inflight[key] = held + 1
            return True

    def release(self, key: str) -> None:
        with self._mu:
            n = self._inflight.get(key, 0)
            if n <= 1:
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n - 1
