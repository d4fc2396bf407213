"""HotObjectTier: the device-resident hot-object serving tier (counterpart
of minio_tpu/hottier/tier.py).

An admitted object's payload is split on its own erasure grid (block_size
blocks, each split into its k data-shard chunks: for a systematic code
the data shards ARE contiguous block slices) and kept in one pow-2
bucketed `[rows, k, width]` uint8 tensor on the card (hottier/arena.py),
with a per-chunk mxsum digest baseline on the host. A hot GET then:

  1. elects FileInfo exactly as the drive path does,
  2. matches the elected identity (version, etag, size, mod_time) against
     the resident entry: any mismatch is a miss, never a stale serve,
  3. launches K2 over the requested block window of the resident tensor,
  4. downloads the window, compares the digests with the admit baseline,
     and returns memoryview slices of its own host copy.

No drive is opened. Every miss (absent, cold, identity changed, digest
mismatch) takes the drive path, which stays the byte-exactness oracle.

Heat: a per-object exponentially decaying count fed by the GET path. A key
whose heat crosses MTPU_HOTTIER_MIN_HEAT is queued for admission; one
daemon thread (mtpu-hottier-admit) re-reads it through the drive path,
stages it, digests it and installs it. Admission is epoch-fenced: every
invalidation bumps the key's epoch, and an admit installs only if the
epoch it captured before reading is still current. Eviction drops the
coldest entries when the byte budget needs room.

The JAX package's families count the same events process-wide
(minio_tpu_hottier_hits_total, _misses_total, _admits_total,
_evictions_total, _bytes, _hit_ratio, _heat{le}); a hit stamps
`hottier_serve` on the request's timeline and, while someone traces,
publishes a `hottier` record. `stats()` carries this tier's counts.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from minio_tpu_torch import obs
from minio_tpu_torch.hottier import arena
from minio_tpu_torch.obs import flight
from minio_tpu_torch.utils import device as device_mod
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.shardmath import ceil_div

_log = logging.getLogger(__name__)

_HITS = obs.counter(
    "minio_tpu_hottier_hits_total",
    "Hot-tier GETs served from device-resident shards (zero drive I/O)"
).labels()
_MISSES = obs.counter(
    "minio_tpu_hottier_misses_total",
    "Hot-tier lookups that fell back to the drive path "
    "(absent, cold, identity-changed, digest-mismatch, or oversize)"
).labels()
_ADMITS = obs.counter(
    "minio_tpu_hottier_admits_total",
    "Objects admitted (or re-admitted) into device residence").labels()
_EVICTIONS = obs.counter(
    "minio_tpu_hottier_evictions_total",
    "Resident entries dropped (budget pressure, invalidation, or "
    "digest mismatch)").labels()
_BYTES = obs.gauge(
    "minio_tpu_hottier_bytes",
    "Device bytes currently charged to resident hot objects")
_HIT_RATIO = obs.gauge(
    "minio_tpu_hottier_hit_ratio",
    "Hot-tier hit ratio (hits / lookups) since process start")
_HEAT = obs.gauge(
    "minio_tpu_hottier_heat",
    "Tracked keys whose decayed heat is <= le (cumulative buckets; "
    "+Inf = all tracked keys) — the admission-threshold tuning view",
    ("le",))
# Bucket bounds bracketing the admission threshold (the JAX package's).
_HEAT_BOUNDS = (0.5, 1.0, 2.0, 4.0, 8.0, 16.0)

DEFAULT_MAX_OBJECT = 8 << 20
# One GET scores ~1.0 heat; the default threshold sits between the first
# GET (1.0) and the second (just under 2.0 after decay), so a key admits
# on its second read inside the halflife window.
DEFAULT_MIN_HEAT = 1.5
DEFAULT_HALFLIFE_S = 60.0
# Eviction hysteresis: a victim must be this factor colder than the
# admitting key, or a uniform scan over a working set larger than the
# budget would churn every entry through the arena.
EVICT_MARGIN = 1.5
# Per-key admission cooldown: an admit is a full oracle read; one attempt
# per key per cooldown bounds what a churning key costs.
DEFAULT_ADMIT_COOLDOWN_S = 2.0
# The erasure grid assumed for a key noted without one (the deployment
# default block size, erasure/codec.py).
_DEFAULT_GRID = (4, 1 << 20)

# The admit thread must not re-note its own oracle reads: its GET runs
# through the same hook that feeds heat.
_tl = threading.local()


def fi_ident(fi) -> tuple:
    """The generation identity of an elected FileInfo: what must match for
    resident bytes to be the bytes this election describes."""
    return (fi.version_id or "", fi.metadata.get("etag", ""),
            int(fi.size), float(fi.mod_time))


def info_ident(info) -> tuple:
    """Same identity from an ObjectInfo (the admit reader's view)."""
    return (getattr(info, "version_id", "") or "", info.etag,
            int(info.size), float(info.mod_time))


class _Entry:
    __slots__ = ("ident", "k", "bs", "size", "nblocks", "shape",
                 "data", "lens_dev", "lens", "digs")

    def __init__(self, ident, k, bs, size, nblocks, shape, data, lens_dev,
                 lens, digs):
        self.ident = ident
        self.k = k
        self.bs = bs
        self.size = size
        self.nblocks = nblocks
        self.shape = shape
        self.data = data          # device [rows, k, width] u8
        self.lens_dev = lens_dev  # device [rows] i32 chunk lengths
        self.lens = lens          # host copy of lens_dev
        self.digs = digs          # host [rows, k, 32] admit baseline


class HotObjectTier:
    """The hot tier of one device. `device` defaults to the card and
    raises without CUDA unless "cpu" is asked for."""

    def __init__(self, *, device="cuda"):
        self.device = device_mod.resolve(device)
        env = os.environ.get
        self.max_object = int(env("MTPU_HOTTIER_MAX_OBJECT",
                                  str(DEFAULT_MAX_OBJECT)))
        self.min_heat = float(env("MTPU_HOTTIER_MIN_HEAT",
                                  str(DEFAULT_MIN_HEAT)))
        self.halflife = float(env("MTPU_HOTTIER_HALFLIFE_S",
                                  str(DEFAULT_HALFLIFE_S)))
        self.verify = env("MTPU_HOTTIER_VERIFY", "1") not in ("0", "false",
                                                             "off")
        self.admit_cooldown = float(env("MTPU_HOTTIER_ADMIT_COOLDOWN_S",
                                        str(DEFAULT_ADMIT_COOLDOWN_S)))
        self.arena = arena.DeviceArena(self.device, int(env(
            "MTPU_HOTTIER_BYTES", str(arena.DEFAULT_BUDGET_BYTES))))
        # Uploads and serves run on the tier's own stream; K2's workspace
        # is per stream, and launches on one stream run in order.
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._mu = threading.Lock()           # leaf: entries/heat/epochs
        self._entries: dict[tuple, _Entry] = {}
        self._heat: dict[tuple, tuple[float, float]] = {}  # (value, t)
        self._epoch: dict[tuple, int] = {}
        self._pending: set[tuple] = set()
        self._last_attempt: dict[tuple, float] = {}
        self._readers: dict[tuple, tuple] = {}
        self._q: queue.Queue = queue.Queue(maxsize=256)
        self.closed = False
        self._stats = {"hits": 0, "misses": 0, "admits": 0,
                       "evictions": 0, "admit_errors": 0}
        self._gauge_t = 0.0  # last heat/hit-ratio gauge refresh
        self._admit_t = threading.Thread(
            target=self._admit_loop, daemon=True, name="mtpu-hottier-admit")
        self._admit_t.start()

    # ------------------------------------------------------------------
    # heat
    # ------------------------------------------------------------------

    def _touch(self, key: tuple, now: float) -> float:
        """Bump the key's decaying heat; caller holds _mu."""
        val, t = self._heat.get(key, (0.0, now))
        val = val * (0.5 ** (max(0.0, now - t) / self.halflife)) + 1.0
        self._heat[key] = (val, now)
        if len(self._heat) > 8192:
            # Bound the heat map: drop the coldest half by decayed value.
            items = sorted(self._heat.items(), key=lambda kv: kv[1][0])
            for k, _v in items[:4096]:
                if k not in self._entries:
                    self._heat.pop(k, None)
        return val

    def _heat_of(self, key: tuple, now: float) -> float:
        val, t = self._heat.get(key, (0.0, now))
        return val * (0.5 ** (max(0.0, now - t) / self.halflife))

    def _refresh_gauges(self) -> None:
        """Throttled (1 s) refresh of the heat-distribution and hit-ratio
        gauges from whichever lookup got here first, so no lookup pays a
        full pass over the keys."""
        now = time.monotonic()
        with self._mu:
            if now - self._gauge_t < 1.0:
                return
            self._gauge_t = now
            heats = [v * (0.5 ** (max(0.0, now - t) / self.halflife))
                     for v, t in self._heat.values()]
            hits = self._stats["hits"]
            misses = self._stats["misses"]
        for b in _HEAT_BOUNDS:
            _HEAT.labels(le=str(b)).set(sum(1 for h in heats if h <= b))
        _HEAT.labels(le="+Inf").set(len(heats))
        if hits + misses:
            _HIT_RATIO.set(hits / (hits + misses))

    # ------------------------------------------------------------------
    # the serving path
    # ------------------------------------------------------------------

    def serve(self, bucket: str, obj: str, fi, offset: int, length: int):
        """Serve [offset, offset+length) from device residence, or None
        (drive path). `fi` is the caller's freshly elected FileInfo: its
        identity gates the hit."""
        return self.serve_ident(bucket, obj, fi_ident(fi), offset, length)

    def serve_ident(self, bucket: str, obj: str, ident: tuple,
                    offset: int, length: int):
        if length <= 0:
            return None
        key = (bucket, obj)
        drop = None
        with self._mu:
            entry = self._entries.get(key)
            if entry is not None and entry.ident != ident:
                # The identity moved under the entry (a mutation this tier
                # never saw): drop it now.
                drop = self._entries.pop(key)
                entry = None
            elif entry is not None:
                self._touch(key, time.monotonic())
        if drop is not None:
            self._evict(drop)
        if entry is None:
            return None
        t0 = time.perf_counter()
        out = self._serve_entry(entry, offset, length)
        if out is None:
            # Digest mismatch: resident bits rotted; evict, and the
            # caller's note_miss accounts the fallback.
            self.invalidate(bucket, obj)
            return None
        dt = time.perf_counter() - t0
        _HITS.inc()
        with self._mu:
            self._stats["hits"] += 1
        # The device serve replaces the drive read inside the request's
        # resp_drain stage.
        flight.stamp("hottier_serve", dt, "hottier")
        if obs.has_subscribers():
            obs.publish({"type": "hottier", "plane": "hottier",
                         "event": "hit", "bucket": bucket, "obj": obj,
                         "bytes": length, "time": time.time(),
                         "durationNs": int(dt * 1e9)})
        self._refresh_gauges()
        return out

    def _serve_entry(self, entry: _Entry, offset: int, length: int):
        rows, k, _width = entry.shape
        b0 = offset // entry.bs
        b1 = (offset + length - 1) // entry.bs + 1
        nb = arena.rows_bucket(b1 - b0)
        start = min(b0, rows - nb)
        mat, got = arena.serve_window(entry.data, entry.lens_dev, start, nb,
                                      self.verify, self._stream)
        if got is not None:
            for b in range(b0, min(b1, entry.nblocks)):
                if not np.array_equal(got[b - start], entry.digs[b]):
                    return None
        out: list[memoryview] = []
        end = offset + length
        for b in range(b0, b1):
            blk_start = b * entry.bs
            s = int(entry.lens[b])
            lo = max(offset, blk_start) - blk_start
            hi = min(end, blk_start + min(entry.bs, entry.size - blk_start))
            hi -= blk_start
            if hi <= lo:
                continue
            # Walk the block's k resident chunks, memoryview slices only.
            pos = 0
            row = mat[b - start]
            for i in range(k):
                if pos >= hi:
                    break
                cend = pos + s
                a = max(lo, pos)
                z = min(hi, cend)
                if z > a:
                    out.append(memoryview(row[i])[a - pos:z - pos])
                pos = cend
        return iter(out)

    # ------------------------------------------------------------------
    # heat feed + admission
    # ------------------------------------------------------------------

    def note_miss(self, bucket: str, obj: str, size: int,
                  reader=None, grid: tuple | None = None) -> None:
        """Feed heat for a GET the drive path served; queue admission once
        the key is hot. `reader` is a zero-arg callable returning
        (ObjectInfo, byte iterator) through the drive path; None uses the
        process-wide reader (hottier.set_reader). `grid` is the object's
        (data_blocks, block_size): it shapes the resident layout only."""
        if getattr(_tl, "in_admit", False):
            return  # the admit thread's own oracle read is not demand
        _MISSES.inc()
        with self._mu:
            self._stats["misses"] += 1
        self._refresh_gauges()
        if size <= 0 or size > self.max_object:
            return
        key = (bucket, obj)
        enqueue = False
        with self._mu:
            heat = self._touch(key, time.monotonic())
            prev = self._readers.get(key)
            self._readers[key] = (
                reader if reader is not None else (prev[0] if prev else None),
                grid if grid is not None else (prev[1] if prev else None),
                size or (prev[2] if prev else 0))
            if len(self._readers) > 8192:
                self._readers.pop(next(iter(self._readers)))
            if (heat >= self.min_heat and key not in self._entries
                    and key not in self._pending):
                self._pending.add(key)
                epoch = self._epoch.get(key, 0)
                enqueue = True
        if enqueue:
            self._enqueue(key, epoch)

    def _enqueue(self, key: tuple, epoch: int) -> None:
        try:
            self._q.put_nowait((key, epoch))
        except queue.Full:
            with self._mu:
                self._pending.discard(key)

    def invalidate(self, bucket: str, obj: str) -> None:
        """Drop residence for a mutated key and bump its epoch so an
        in-flight admission cannot install stale bytes. A key that was
        resident and is still hot re-admits (write-through)."""
        key = (bucket, obj)
        readmit = False
        with self._mu:
            self._epoch[key] = self._epoch.get(key, 0) + 1
            entry = self._entries.pop(key, None)
            if (entry is not None and key not in self._pending
                    and self._heat_of(key, time.monotonic()) >= self.min_heat
                    and key in self._readers):
                self._pending.add(key)
                epoch = self._epoch[key]
                readmit = True
        if entry is not None:
            self._evict(entry)
        if readmit:
            self._enqueue(key, epoch)

    def invalidate_bucket(self, bucket: str) -> None:
        with self._mu:
            victims = [k for k in self._entries if k[0] == bucket]
            entries = [self._entries.pop(k) for k in victims]
            for k in victims:
                self._epoch[k] = self._epoch.get(k, 0) + 1
        for e in entries:
            self._evict(e)

    # ------------------------------------------------------------------
    # the admit thread
    # ------------------------------------------------------------------

    def _admit_loop(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            key, epoch = item
            try:
                self._admit_one(key, epoch)
            except (se.StorageError, se.ObjectError, OSError) as e:
                # The oracle read failed (object gone, quorum lost): nothing
                # resident changes; the key can re-heat later.
                _log.debug("hottier admit %s/%s: %s", key[0], key[1], e)
                with self._mu:
                    self._stats["admit_errors"] += 1
            except Exception:  # noqa: BLE001 - admission is advisory: a bug
                # here must leave drive-path serving, not kill the thread.
                _log.exception("hottier admit %s/%s", key[0], key[1])
                with self._mu:
                    self._stats["admit_errors"] += 1
            finally:
                with self._mu:
                    self._pending.discard(key)

    def _admit_one(self, key: tuple, epoch: int) -> None:
        from minio_tpu_torch import hottier as _ht

        bucket, obj = key
        now = time.monotonic()
        with self._mu:
            if self._epoch.get(key, 0) != epoch or self.closed:
                return
            if now - self._last_attempt.get(key, -1e9) < self.admit_cooldown:
                return  # churny key: one oracle read per cooldown
            self._last_attempt[key] = now
            if len(self._last_attempt) > 8192:
                cut = now - max(self.admit_cooldown, 1.0)
                self._last_attempt = {k2: t for k2, t in
                                      self._last_attempt.items() if t >= cut}
            rec = self._readers.get(key)
        reader, grid, noted_size = rec if rec is not None else (None,) * 3
        if noted_size:
            # Skip the oracle read when the entry could not be installed
            # anyway (over budget, or no victim cold enough to evict).
            k_est, bs_est = self._grid(grid)
            est = arena.entry_shape(ceil_div(noted_size, bs_est), k_est,
                                    ceil_div(min(bs_est, noted_size), k_est))
            if not self._room_likely(key, est):
                return
        if reader is None:
            default = _ht.default_reader()
            if default is None:
                return
            reader = (lambda r=default, b=bucket, o=obj: r(b, o))
        _tl.in_admit = True
        try:
            info, stream = reader()
        finally:
            _tl.in_admit = False
        ident = info_ident(info)
        size = int(info.size)
        k, bs = self._grid(grid)
        if size <= 0 or size > self.max_object or k <= 0 or bs <= 0:
            self._drain(stream)
            return
        nblocks = ceil_div(size, bs)
        shape = arena.entry_shape(nblocks, k, ceil_div(min(bs, size), k))
        if not self._make_room(key, shape):
            self._drain(stream)
            return
        staging = self.arena.acquire(shape)
        try:
            lens = np.zeros((shape[0],), dtype=np.int32)
            if not self._stage(staging.numpy(), lens, stream, size, k, bs,
                               nblocks):
                return
            entry = self._seal(ident, k, bs, size, nblocks, shape, staging,
                               lens)
        finally:
            # The resident tensor is the card's own copy (arena.seal).
            self.arena.recycle_staging(shape, staging)
        if entry is None:
            return
        displaced = None
        with self._mu:
            installed = self._epoch.get(key, 0) == epoch and not self.closed
            if installed:
                displaced = self._entries.get(key)
                self._entries[key] = entry
                self._stats["admits"] += 1
        if not installed:
            self.arena.release(shape)
            return
        _ADMITS.inc()
        if displaced is not None:
            self.arena.release(displaced.shape)
        _BYTES.set(self.arena.used_bytes)

    def _grid(self, grid: tuple | None) -> tuple[int, int]:
        """(k, block_size): the object's erasure grid from the miss note,
        else the deployment default."""
        if grid is not None and grid[0] and grid[1]:
            return int(grid[0]), int(grid[1])
        return _DEFAULT_GRID

    @staticmethod
    def _stage(staging: np.ndarray, lens: np.ndarray, stream, size: int,
               k: int, bs: int, nblocks: int) -> bool:
        """Fold the oracle stream into the staging layout: the flat payload
        lands once, then each block's k data-shard chunks copy into their
        rows (tails stay zero)."""
        flat = np.empty(size, dtype=np.uint8)
        pos = 0
        for piece in stream:
            ln = len(piece)
            if pos + ln > size:
                return False  # stream longer than the elected size
            flat[pos:pos + ln] = np.frombuffer(piece, dtype=np.uint8)
            pos += ln
        if pos != size:
            return False
        for b in range(nblocks):
            blk = flat[b * bs:min((b + 1) * bs, size)]
            s = ceil_div(len(blk), k)
            lens[b] = s
            for i in range(k):
                c = blk[i * s:(i + 1) * s]
                if len(c):
                    staging[b, i, :len(c)] = c
        return True

    def _seal(self, ident, k, bs, size, nblocks, shape, staging, lens):
        """Upload + admit-time digest baseline. The baseline is hashed from
        the HOST staging bytes (fused.digest_chunks_host, a launch over its
        own upload); then K2 re-hashes the RESIDENT copy (only its digests
        come back), and a mismatch (the upload corrupted) refuses the
        entry."""
        from minio_tpu_torch.ops import fused

        rows, _k, width = shape
        arr = staging.numpy()
        chunks = [arr[b, i, :int(lens[b])]
                  for b in range(nblocks) for i in range(k)]
        base = fused.digest_chunks_host(chunks, width, self.device)
        digs = np.zeros((rows, k, 32), dtype=np.uint8)
        for ci, d in enumerate(base):
            digs[ci // k, ci % k] = np.frombuffer(d, dtype=np.uint8)
        data_dev = self.arena.seal(shape, staging, self._stream)
        lens_dev = torch.from_numpy(lens).to(self.device)
        if self.verify:
            got = arena.resident_digests(data_dev, lens_dev, nblocks,
                                         self._stream)
            if not np.array_equal(got, digs[:nblocks]):
                self.arena.release(shape)
                return None
        return _Entry(ident, k, bs, size, nblocks, shape, data_dev, lens_dev,
                      lens, digs)

    def _room_likely(self, key: tuple, shape: tuple) -> bool:
        """Non-destructive preview of _make_room: would the eviction policy
        find enough margin-colder victims? Runs before the admit pays its
        oracle read."""
        need = arena.shape_bytes(shape)
        if need > self.arena.budget:
            return False
        if self.arena.fits(shape):
            return True
        now = time.monotonic()
        with self._mu:
            my_heat = self._heat_of(key, now)
            freeable = sum(arena.shape_bytes(e2.shape)
                           for k2, e2 in self._entries.items()
                           if k2 != key and
                           self._heat_of(k2, now) * EVICT_MARGIN < my_heat)
        return self.arena.used_bytes - freeable + need <= self.arena.budget

    def _make_room(self, key: tuple, shape: tuple) -> bool:
        """Evict the coldest entries until `shape` fits the budget. Victims
        must be EVICT_MARGIN colder than the admitting key."""
        if arena.shape_bytes(shape) > self.arena.budget:
            return False
        while not self.arena.fits(shape):
            now = time.monotonic()
            with self._mu:
                my_heat = self._heat_of(key, now)
                victims = sorted((self._heat_of(k2, now), k2)
                                 for k2 in self._entries if k2 != key)
                if not victims or victims[0][0] * EVICT_MARGIN >= my_heat:
                    return False
                vkey = victims[0][1]
                entry = self._entries.pop(vkey)
                self._epoch[vkey] = self._epoch.get(vkey, 0) + 1
            self._evict(entry)
        return True

    @staticmethod
    def _drain(stream) -> None:
        for _ in stream:
            pass

    def _evict(self, entry: _Entry) -> None:
        """Uncharge an entry dropped from residence; its tensor goes with
        the last reference (a serve in flight keeps it until it is done)."""
        self.arena.release(entry.shape)
        _EVICTIONS.inc()
        _BYTES.set(self.arena.used_bytes)
        with self._mu:
            self._stats["evictions"] += 1

    # ------------------------------------------------------------------
    # lifecycle / introspection
    # ------------------------------------------------------------------

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until no admission is queued or in flight."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._mu:
                idle = not self._pending
            if idle and self._q.empty():
                return True
            time.sleep(0.01)
        return False

    def resident(self, bucket: str, obj: str) -> bool:
        with self._mu:
            return (bucket, obj) in self._entries

    def stats(self) -> dict:
        with self._mu:
            st = dict(self._stats)
            st["resident_objects"] = len(self._entries)
            st["pending"] = len(self._pending)
        st["resident_bytes"] = self.arena.used_bytes
        return st

    def close(self, timeout: float = 10.0) -> None:
        self.closed = True
        self._q.put(None)
        self._admit_t.join(timeout)
        with self._mu:
            self._entries.clear()
            self._heat.clear()
            self._pending.clear()
            self._readers.clear()
        self.arena.clear()
        _BYTES.set(0)
