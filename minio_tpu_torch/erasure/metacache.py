"""Metacache — persisted block-listing streams for resumable pagination
(counterpart of minio_tpu/erasure/metacache.py; blocks and index are the
JAX package's documents at its paths, so a stream either package renders
serves continuation pages in the other).

Role-equivalent of cmd/metacache-stream.go:57 / metacache-bucket.go:43 /
metacache-set.go: the first page of a large listing walks the drives once
and persists the merged, sorted result; every continuation page then
SEEKS into the persisted stream instead of re-walking the namespace.

The stream is stored the way the reference stores it — in blocks, written
progressively while the walk advances — so both sides stay O(block):

    {sys}/buckets/{b}/metacache/{kind}-{h}/idx      block index
    {sys}/buckets/{b}/metacache/{kind}-{h}/blk{i}   ~BLOCK entries each

Page-1 renders the first SYNC_CAP entries synchronously (bounding page-1
latency exactly like the previous single-window design), then a daemon
thread keeps walking and appending blocks up to the stream cap, updating
the index as it goes — a sequential client's continuations ride blocks
the renderer has already written, falling back to the marker-pushdown
walk only when they outrun it. Decoded blocks are memoized in-process, so
a block hit costs a bisect + slice, not a 10k-entry msgpack decode.

Caches are keyed by (bucket, prefix), expire by TTL, and are invalidated
by local mutations (mark_dirty); a renderer that observes its bucket
going dirty abandons the stream without publishing. Cross-node: blocks
travel through the same replicated sys-store as config/IAM; a peer's
re-render is picked up when the local index memo expires (<= TTL) — the
same staleness bound the listing itself has.
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import threading
import time
import uuid
from collections import OrderedDict

from minio_tpu_torch.erasure.types import ObjectInfo
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.msgpack import packb as pack
from minio_tpu_torch.utils.msgpack import unpackb as unpack

DEFAULT_TTL = 60.0
_PREFIX = "buckets"
BLOCK = 2000            # entries per persisted block
_IDX_EVERY = 4          # async renderer republishes the index every N blocks
_MEMO_BLOCKS = 48       # decoded-block memo bound (O(blocks), not namespace)


class CacheGone(Exception):
    """A block vanished/changed generation mid-page: caller re-walks."""


class Metacache:
    def __init__(self, store, ttl: float = DEFAULT_TTL):
        """store: read/write/delete_sys_config provider (the pools)."""
        self._store = store
        self.ttl = ttl
        self.hits = 0
        self.misses = 0
        self._saved_at: dict[tuple, float] = {}
        self._dirty_at: dict[str, float] = {}
        self._memo: "OrderedDict[str, tuple[float, object]]" = OrderedDict()
        self._memo_lock = threading.Lock()
        self._rendering: set[tuple] = set()
        self._render_lock = threading.Lock()
        self._last_read: dict[tuple, float] = {}
        self._closed = False
        # Stamped into every published idx: only the node that rendered a
        # generation may reclaim its replicated-store docs on expiry —
        # another node's clock/TTL view must never delete blocks a peer
        # is mid-publish on (its _rendering set is invisible here).
        self._owner = uuid.uuid4().hex[:16]

    # Background rendering continues only while someone keeps reading the
    # stream (the reference's metacache likewise stops feeding listings
    # nobody consumes); a page-1-only client costs one sync render, not a
    # full-namespace walk.
    RENDER_IDLE_ABANDON = 10.0

    def close(self) -> None:
        self._closed = True

    # -- invalidation ------------------------------------------------------

    def mark_dirty(self, bucket: str) -> None:
        """A mutation touched the bucket: streams rendered before this
        instant stop being served (the role the reference's bloom cycle
        plays for metacache invalidation)."""
        self._dirty_at[bucket] = time.time()
        if len(self._dirty_at) > 4096:
            self._dirty_at.clear()

    def _stale(self, bucket: str, created: float) -> bool:
        return created <= self._dirty_at.get(bucket, 0)

    def recently_saved(self, bucket: str, prefix: str,
                       kind: str = "o") -> bool:
        """True while this node rendered the stream within ttl/2 and
        nothing mutated the bucket since — page-1 requests of a hot
        bucket skip re-rendering."""
        saved = self._saved_at.get((bucket, prefix, kind), 0)
        return (time.time() - saved < self.ttl / 2
                and not self._stale(bucket, saved))

    def recently_saved_versions(self, bucket: str, prefix: str) -> bool:
        return self.recently_saved(bucket, prefix, "v")

    # -- paths / codec -----------------------------------------------------

    def _base(self, bucket: str, prefix: str, kind: str) -> str:
        h = hashlib.sha1(prefix.encode()).hexdigest()[:16]
        return f"{_PREFIX}/{bucket}/metacache/{kind}-{h}"

    def _encode_entries(self, kind: str, entries: list) -> list:
        if kind == "v":
            return [(n, [dataclasses.asdict(oi) for oi in infos])
                    for n, infos in entries]
        return [(n, dataclasses.asdict(oi)) for n, oi in entries]

    def _decode_entries(self, kind: str, raw_entries: list) -> list:
        if kind == "v":
            return [(n, [ObjectInfo(**d) for d in infos])
                    for n, infos in raw_entries]
        return [(n, ObjectInfo(**d)) for n, d in raw_entries]

    # -- memoized sys-store docs ------------------------------------------

    def _memo_get(self, path: str, created: float):
        with self._memo_lock:
            hit = self._memo.get(path)
            if hit is not None and hit[0] == created:
                self._memo.move_to_end(path)
                return hit[1]
        return None

    def _memo_put(self, path: str, created: float, value) -> None:
        with self._memo_lock:
            self._memo[path] = (created, value)
            self._memo.move_to_end(path)
            while len(self._memo) > _MEMO_BLOCKS:
                self._memo.popitem(last=False)

    def _memo_drop_prefix(self, base: str) -> None:
        with self._memo_lock:
            for k in [k for k in self._memo if k.startswith(base)]:
                del self._memo[k]

    # -- render ------------------------------------------------------------

    def render(self, bucket: str, prefix: str, entry_stream, kind: str = "o",
               sync_cap: int = 10_000, stream_cap: int = 1_000_000) -> None:
        """Persist `entry_stream` (sorted (name, info) iterator) as a
        block stream. The first sync_cap entries are written before this
        returns; a daemon thread continues up to stream_cap. A renderer
        is already running or recently finished -> no-op."""
        key = (bucket, prefix, kind)
        with self._render_lock:
            if self._rendering and key in self._rendering:
                return
            self._rendering.add(key)
        created = time.time()
        base = self._base(bucket, prefix, kind)
        # A previous generation may have more blocks than this render
        # will produce — remember how many so the final publish can sweep
        # the stale tail (a shrunken namespace must not leave orphans).
        old_blocks = 0
        with self._memo_lock:
            prev = self._memo.get(f"{base}/idx")
        if prev is not None:
            old_blocks = int(prev[1].get("blocks", 0))
        else:
            try:
                old = unpack(self._store.read_sys_config(f"{base}/idx"))
                old_blocks = int(old.get("blocks", 0))
            except (se.StorageError, ValueError, TypeError):
                pass
        state = {"starts": [], "blocks": 0, "count": 0,
                 "old_blocks": old_blocks}
        try:
            done = self._render_some(bucket, base, kind, created,
                                     entry_stream, state,
                                     limit=min(sync_cap, stream_cap))
            finished = done or state["count"] >= stream_cap
            self._publish_idx(base, created, state, complete=done,
                              final=finished)
            self._saved_at[key] = time.time()
            if len(self._saved_at) > 4096:
                self._saved_at.clear()
            if finished:
                with self._render_lock:
                    self._rendering.discard(key)
                return
        except Exception:   # noqa: BLE001 — cache is an optimization
            with self._render_lock:
                self._rendering.discard(key)
            return

        self._last_read.setdefault(key, time.time())

        def bg():
            finished = False
            try:
                while not self._closed:
                    if self._stale(bucket, created):
                        return      # bucket mutated: abandon silently
                    if time.time() - created > self.ttl:
                        return      # generation expired: unservable
                    if (time.time() - self._last_read.get(key, 0)
                            > self.RENDER_IDLE_ABANDON):
                        return      # no readers: stop walking
                    done = self._render_some(
                        bucket, base, kind, created, entry_stream, state,
                        limit=min(_IDX_EVERY * BLOCK,
                                  stream_cap - state["count"]))
                    finished = done or state["count"] >= stream_cap
                    self._publish_idx(base, created, state, complete=done,
                                      final=finished)
                    if finished:
                        return
            except Exception:   # noqa: BLE001 — drives may be closing
                pass
            finally:
                if not finished and not self._closed:
                    # Abandoned mid-stream: the final sweep never ran, so
                    # reclaim the previous generation's tail now — those
                    # blocks are beyond this idx's range and would
                    # otherwise leak in the replicated store forever.
                    for i in range(state["blocks"],
                                   state.get("old_blocks", 0)):
                        try:
                            self._store.delete_sys_config(f"{base}/blk{i}")
                        except se.StorageError:
                            pass
                with self._render_lock:
                    self._rendering.discard(key)

        threading.Thread(target=bg, daemon=True,
                         name=f"metacache-{bucket}").start()

    def _render_some(self, bucket, base, kind, created, entry_stream,
                     state, limit: int) -> bool:
        """Consume up to `limit` entries into blocks; True when the
        stream ended."""
        taken = 0
        buf: list = []
        for entry in entry_stream:
            buf.append(entry)
            taken += 1
            if len(buf) >= BLOCK:
                self._write_block(base, kind, created, state, buf)
                buf = []
            if taken >= limit:
                if buf:
                    self._write_block(base, kind, created, state, buf)
                return False
        if buf:
            self._write_block(base, kind, created, state, buf)
        return True

    def _write_block(self, base, kind, created, state, buf) -> None:
        i = state["blocks"]
        path = f"{base}/blk{i}"
        doc = {"v": 2, "created": created,
               "entries": self._encode_entries(kind, buf)}
        self._store.write_sys_config(path, pack(doc))
        self._memo_put(path, created, list(buf))
        state["starts"].append(buf[0][0])
        state["blocks"] += 1
        state["count"] += len(buf)

    def _publish_idx(self, base, created, state, complete: bool,
                     final: bool = False) -> None:
        doc = {"v": 2, "created": created, "starts": list(state["starts"]),
               "blocks": state["blocks"], "complete": complete,
               "owner": self._owner}
        self._store.write_sys_config(f"{base}/idx", pack(doc))
        self._memo_put(f"{base}/idx", created, doc)
        if final:
            # Sweep blocks of the previous (longer) generation.
            for i in range(state["blocks"], state.get("old_blocks", 0)):
                try:
                    self._store.delete_sys_config(f"{base}/blk{i}")
                except se.StorageError:
                    pass

    # -- page reads --------------------------------------------------------

    def _load_idx(self, bucket: str, prefix: str, kind: str):
        self._last_read[(bucket, prefix, kind)] = time.time()
        if len(self._last_read) > 4096:
            # Evict the oldest half — a blanket clear() would zero the
            # read clocks of every in-flight renderer and idle-abandon
            # them all at once.
            for k, _ in sorted(self._last_read.items(),
                               key=lambda kv: kv[1])[:2048]:
                self._last_read.pop(k, None)
        base = self._base(bucket, prefix, kind)
        # Any memoized generation within ttl and not dirty serves; a
        # peer's newer render is picked up when this expires.
        with self._memo_lock:
            hit = self._memo.get(f"{base}/idx")
        if hit is not None:
            created, doc = hit
            if (time.time() - created <= self.ttl
                    and not self._stale(bucket, created)):
                return doc
        try:
            raw = self._store.read_sys_config(f"{base}/idx")
            doc = unpack(raw)
        except (se.StorageError, ValueError, TypeError):
            return None
        created = doc.get("created", 0)
        if (doc.get("v") != 2 or time.time() - created > self.ttl
                or self._stale(bucket, created)):
            # Expired/stale generation: always reclaim the in-memory memo;
            # the REPLICATED docs are deleted only by the node that
            # rendered them (owner stamp) and only while no local renderer
            # is mid-publish of a new generation — a peer's expiry view
            # must not delete blocks another node just published under a
            # fresh idx (per-node _rendering/_dirty_at are invisible
            # cross-node; generation checks keep correctness, but the
            # deletes would degrade its continuations to full walks).
            # Hard-expired generations (owner restarted/died: its uuid is
            # gone forever) are fair game for ANY node — no peer can be
            # mid-render of something 10 TTLs old, and without this
            # escape hatch a dead owner's blocks would leak in the
            # replicated store indefinitely.
            self._memo_drop_prefix(base)
            with self._render_lock:
                rendering = (bucket, prefix, kind) in self._rendering
            hard_expired = time.time() - created > 10 * self.ttl
            if not rendering and (doc.get("owner") == self._owner
                                  or hard_expired):
                self.drop(bucket, prefix, kind)
            return None
        self._memo_put(f"{base}/idx", created, doc)
        return doc

    def _load_block(self, base: str, i: int, created: float, kind: str):
        path = f"{base}/blk{i}"
        hit = self._memo_get(path, created)
        if hit is not None:
            return hit
        try:
            doc = unpack(self._store.read_sys_config(path))
        except (se.StorageError, ValueError, TypeError):
            raise CacheGone(path) from None
        if doc.get("created") != created:
            raise CacheGone(path)
        entries = self._decode_entries(kind, doc["entries"])
        self._memo_put(path, created, entries)
        return entries

    def entries_from(self, bucket: str, prefix: str, marker: str = "",
                     kind: str = "o"):
        """-> (iterator over (name, info) from the block containing
        `marker`, complete: bool) or None. The iterator raises CacheGone
        if a block vanished/changed generation mid-page; `complete` False
        means the stream was capped — a page that drains the iterator
        without filling must fall back to the walk."""
        idx = self._load_idx(bucket, prefix, kind)
        if idx is None or not idx.get("blocks"):
            self.misses += 1
            return None
        starts = idx["starts"]
        # Rightmost block whose first name <= marker. A marker past the
        # rendered range lands in the final block and filters to empty;
        # complete=False then routes the caller to the walk, so a capped
        # stream can never masquerade as end-of-bucket.
        b0 = max(0, bisect.bisect_right(starts, marker) - 1) if marker else 0
        base = self._base(bucket, prefix, kind)
        created = idx["created"]

        def gen():
            for bi in range(b0, idx["blocks"]):
                for item in self._load_block(base, bi, created, kind):
                    yield item

        self.hits += 1
        return gen(), bool(idx["complete"])

    def stream_complete(self, bucket: str, prefix: str = "",
                        kind: str = "o") -> bool:
        """Public completeness probe: does a live (unexpired, non-stale)
        stream cover the whole namespace? Benchmarks and operators poll
        this instead of reaching into _load_idx."""
        idx = self._load_idx(bucket, prefix, kind)
        return bool(idx and idx.get("complete"))

    # -- drop --------------------------------------------------------------

    def drop(self, bucket: str, prefix: str = "", kind: str = "o") -> None:
        base = self._base(bucket, prefix, kind)
        idx = None
        try:
            idx = unpack(self._store.read_sys_config(f"{base}/idx"))
        except (se.StorageError, ValueError, TypeError):
            pass
        try:
            self._store.delete_sys_config(f"{base}/idx")
        except se.StorageError:
            pass
        for i in range(int(idx.get("blocks", 0)) if idx else 0):
            try:
                self._store.delete_sys_config(f"{base}/blk{i}")
            except se.StorageError:
                pass
        self._memo_drop_prefix(base)
