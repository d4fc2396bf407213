"""Shared listing pagination over sorted journal streams (counterpart of
minio_tpu/erasure/listing.py).

Every layer (one set, a sets group, a pools group) produces the same
shape, a stream of (object name, version journal) sorted by name, merged
with the newest journal winning, and pages it with the same S3 semantics
(prefix / marker / delimiter / max-keys), so sets and pools share one
implementation (the reference's merge lives in cmd/metacache-entries.go
and cmd/metacache-set.go). Streams are consumed up to the page boundary:
a listing holds O(page), never the namespace.
"""

from __future__ import annotations

import contextlib
import heapq
import itertools
import queue
import threading
from typing import Callable, Iterator

from minio_tpu_torch import obs
from minio_tpu_torch.erasure.types import (DeletedObject, ListObjectsInfo,
                                           ListObjectVersionsInfo, ObjectInfo,
                                           ObjectOptions)
from minio_tpu_torch.storage.api import MARKER_GROUP_PAD, group_start_after
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.xlmeta import XLMeta
from minio_tpu_torch.utils import errors as se


def fi_to_object_info(bucket: str, obj: str, fi: FileInfo) -> ObjectInfo:
    """FileInfo -> ObjectInfo (reference fileInfo.ToObjectInfo,
    cmd/erasure-metadata.go:44). Pure conversion, shared by every layer."""
    return ObjectInfo(
        bucket=bucket,
        name=obj,
        mod_time=fi.mod_time,
        size=fi.size,
        etag=fi.metadata.get("etag", ""),
        version_id=fi.version_id,
        is_latest=fi.is_latest,
        delete_marker=fi.deleted,
        content_type=fi.metadata.get("content-type", ""),
        user_defined={k: v for k, v in fi.metadata.items()
                      if k not in ("etag", "content-type")},
        parity_blocks=fi.erasure.parity_blocks,
        data_blocks=fi.erasure.data_blocks,
        num_versions=fi.num_versions,
        parts=[(p.number, p.size) for p in fi.parts],
    )


def bulk_delete(delete_object, bucket, objects, opts=None):
    """Per-key delete loop shared by every layer (reference DeleteObjects,
    cmd/erasure-server-pool.go): each key resolves on its own; errors come
    back as values, not raised. On a versioned bucket (opts.versioned) a
    key named without a VersionId gets a delete marker, reported with
    DeleteMarker and DeleteMarkerVersionId."""
    versioned = opts.versioned if opts else False
    out = []
    for o in objects:
        try:
            info = delete_object(bucket, o.object_name,
                                 ObjectOptions(version_id=o.version_id,
                                               versioned=versioned))
            out.append(DeletedObject(
                object_name=o.object_name, version_id=o.version_id,
                delete_marker=info.delete_marker,
                delete_marker_version_id=info.version_id if info.delete_marker else "",
            ))
        except Exception as e:  # noqa: BLE001 - per-key results
            out.append(e)
    return out


def merge_journal_streams(streams: list) -> "Iterator[tuple[str, XLMeta]]":
    """K-way merge of SORTED (name, XLMeta) streams, newest journal wins
    per name — the cross-set/cross-pool layer of the streamed listing
    (reference merges per-set metacache streams the same way,
    cmd/metacache-server-pool.go:59 / metacache-entries.go:198). Pulls
    lazily: memory is O(streams), not O(namespace)."""
    merged = heapq.merge(*streams, key=lambda t: t[0])
    cur_name: str | None = None
    cur_meta: XLMeta | None = None
    for name, meta in merged:
        if name != cur_name:
            if cur_meta is not None:
                yield cur_name, cur_meta
            cur_name, cur_meta = name, meta
        elif journal_newer(meta, cur_meta):
            cur_meta = meta
    if cur_meta is not None:
        yield cur_name, cur_meta


def grouped_journal_stream(make_stream, prefix: str, start_after: str,
                           delimiter: str):
    """Delimiter-aware journal stream: yields at most ONE member per
    CommonPrefix group. The restart (start_after = group +
    MARKER_GROUP_PAD, pruning the group's whole subtree) fires only when a
    SECOND member of the same group surfaces — single-member groups cost
    nothing extra, so a bucket of 50k one-object "directories" still
    streams in one pass, while a 100k-object group is skipped after two
    reads (reference forward-past behavior, cmd/metacache-entries.go
    filterPrefixes role). Paginate rolls the one yielded member into the
    prefix row exactly as it would the first of thousands. Non-grouped
    names stream through unchanged. `make_stream(start_after)` builds a
    fresh sorted (name, journal) stream."""
    plen = len(prefix)
    cur_group = None
    while True:
        stream = make_stream(start_after)
        restart = None
        try:
            for name, meta in stream:
                i = name.find(delimiter, plen)
                group = name[: i + len(delimiter)] if i >= 0 else None
                if group is not None and group == cur_group:
                    # Second member of the group: skip the rest of it.
                    restart = group + MARKER_GROUP_PAD
                    break
                cur_group = group
                yield name, meta
        finally:
            close = getattr(stream, "close", None)
            if close is not None:
                close()
        if restart is None:
            return
        start_after = restart


def pushdown_stream(self_stream, prefix: str, marker: str, delimiter: str,
                    version_marker: str = ""):
    """The one marker-pushdown policy every listing layer shares:
    - version_marker set: no pushdown (the key-marker object's remaining
      versions must still stream);
    - delimiter: group-aware stream resuming past whole CommonPrefix
      groups;
    - plain: marker as start_after (subtree pruning in the walk).
    `self_stream(start_after)` builds the layer's sorted journal stream."""
    if version_marker:
        return self_stream("")
    if delimiter:
        return grouped_journal_stream(
            self_stream, prefix, group_start_after(marker, delimiter),
            delimiter)
    return self_stream(marker)


class WalkBaton:
    """Turns for one walk's prefetch producers: each reads its next batch
    holding the baton, so one producer reads at a time. Producers reading
    side by side hand the interpreter lock over at every syscall and walk
    slower together than in turns (PERF.md 6.7); the threads are there so
    a hung drive can be left behind, not for overlap. A producer that
    waits `wait` seconds for the baton (its holder may be reading from a
    hung drive) breaks it: from then on the walk's producers read without
    turns, so a hang costs the walk one wait and other walks nothing."""

    def __init__(self, wait: float):
        self._lock = threading.Lock()
        self._wait = wait
        self._broken = False

    @contextlib.contextmanager
    def turn(self):
        held = not self._broken and self._lock.acquire(timeout=self._wait)
        if not held:
            self._broken = True
        try:
            yield
        finally:
            if held:
                self._lock.release()


def prefetch_stream(gen, depth: int = 128, deadline: float | None = None, *,
                    baton: WalkBaton):
    """Run `gen` in a producer thread behind a bounded queue (the
    reference's per-drive WalkDir goroutines, cmd/metacache-walk.go), so
    a drive that hangs mid-walk can be left behind. Items cross the queue
    in batches of up to `depth`, at most two batches queued, and the
    producer reads each batch in its turn on `baton` (one per walk).
    Abandoning the wrapper (early page end) stops the producer promptly —
    no thread leaks, no unbounded buffering.

    deadline: max seconds to wait for the NEXT batch. A producer stalled
    past it (hung drive mid-walk) ends this stream early — the k-way
    merge then lists at quorum from the remaining drives, exactly as if
    the drive were offline. The stalled producer thread is told to stop
    and leaks only until its blocking read returns."""
    q: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()
    DONE = object()

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def pump():
        it = iter(gen)
        try:
            while not stop.is_set():
                with baton.turn():
                    batch = list(itertools.islice(it, depth))
                if not batch or not put(batch):
                    return
        finally:
            put(DONE)

    t = threading.Thread(target=obs.ctx_wrap(pump), daemon=True, name="walk-prefetch")
    t.start()
    try:
        while True:
            if deadline is None:
                batch = q.get()
            else:
                try:
                    batch = q.get(timeout=deadline)
                except queue.Empty:
                    return  # producer stalled past the walk deadline
            if batch is DONE:
                return
            yield from batch
    finally:
        stop.set()


def elect_journal_streams(streams: list) -> "Iterator[tuple[str, XLMeta]]":
    """K-way merge of one set's drives' SORTED (name, raw journal bytes)
    streams into (name, XLMeta), newest journal winning per name, as
    merge_journal_streams elects: copies are weighed in stream order and a
    later one wins only when journal_newer. Each distinct copy of a name
    is parsed once (an inline object's journal is the same bytes on every
    drive); a corrupt copy drops out and the other drives elect."""
    merged = heapq.merge(*streams, key=lambda t: t[0])
    for name, group in itertools.groupby(merged, key=lambda t: t[0]):
        best = None
        parsed: dict = {}
        for _name, raw in group:
            if raw in parsed:
                meta = parsed[raw]
            else:
                try:
                    meta = XLMeta.parse(raw)
                except se.StorageError:
                    meta = None
                parsed[raw] = meta
            if meta is not None and (best is None or journal_newer(meta, best)):
                best = meta
        if best is not None:
            yield name, best


def _as_sorted_items(journals) -> "Iterator[tuple[str, XLMeta]]":
    """Paginators accept either a journal map (legacy, materialized) or an
    already-sorted lazy (name, XLMeta) stream — the streamed form is what
    keeps listing at O(page) memory."""
    if isinstance(journals, dict):
        return ((n, journals[n]) for n in sorted(journals))
    return iter(journals)


def journal_newer(a: XLMeta, b: XLMeta) -> bool:
    # Envelope accessors: the quorum comparator runs once per (object,
    # drive) during every listing merge and must not materialize bodies.
    amt, bmt = a.latest_mt, b.latest_mt
    if amt != bmt:
        return amt > bmt
    return a.version_count > b.version_count


def paginate_objects(
    journals,
    to_info: Callable[[str, FileInfo], object],
    prefix: str = "",
    marker: str = "",
    delimiter: str = "",
    max_keys: int = 1000,
) -> ListObjectsInfo:
    """S3 pagination over a journal map or sorted (name, XLMeta) stream;
    a stream is consumed only up to the page boundary (O(page) work)."""
    objects = []
    prefixes: list[str] = []
    seen_prefix: set[str] = set()
    truncated = False
    next_marker = ""
    for name, meta in _as_sorted_items(journals):
        if _skip_for_marker(name, marker, delimiter):
            continue
        if delimiter:
            rest = name[len(prefix):]
            d = rest.find(delimiter)
            if d >= 0:
                cp = prefix + rest[: d + len(delimiter)]
                if cp not in seen_prefix:
                    if len(objects) + len(seen_prefix) >= max_keys:
                        truncated = True
                        break
                    seen_prefix.add(cp)
                    prefixes.append(cp)
                    next_marker = cp
                continue
        try:
            fi = meta.to_fileinfo("", name, None)
        except se.StorageError:
            continue
        if fi.deleted:
            continue
        if len(objects) + len(seen_prefix) >= max_keys:
            truncated = True
            break
        objects.append(to_info(name, fi))
        next_marker = name
    return ListObjectsInfo(is_truncated=truncated,
                           next_marker=next_marker if truncated else "",
                           objects=objects, prefixes=prefixes)


def iter_entries_from_journals(journals, to_info):
    """Lazy form of entries_from_journals — the metacache block renderer
    consumes this incrementally (O(block) memory, cmd/metacache-stream.go
    progressive-write role)."""
    for name, meta in _as_sorted_items(journals):
        try:
            fi = meta.to_fileinfo("", name, None)
        except se.StorageError:
            continue
        if fi.deleted:
            continue
        yield name, to_info(name, fi)


def iter_version_entries_from_journals(journals, to_info):
    """Lazy version-stream form (delete markers included)."""
    for name, meta in _as_sorted_items(journals):
        try:
            infos = [to_info(name, fi)
                     for fi in meta.list_versions("", name)]
        except se.StorageError:
            continue
        if infos:
            yield name, infos



def paginate_cached(
    entries: list[tuple[str, object]],
    prefix: str = "",
    marker: str = "",
    delimiter: str = "",
    max_keys: int = 1000,
) -> ListObjectsInfo:
    """paginate_objects over a pre-rendered metacache entry stream —
    continuation pages pay a seek, not a namespace walk."""
    objects = []
    prefixes: list[str] = []
    seen_prefix: set[str] = set()
    truncated = False
    next_marker = ""
    for name, info in entries:
        if not name.startswith(prefix):
            continue
        if _skip_for_marker(name, marker, delimiter):
            continue
        if delimiter:
            rest = name[len(prefix):]
            d = rest.find(delimiter)
            if d >= 0:
                cp = prefix + rest[: d + len(delimiter)]
                if cp not in seen_prefix:
                    if len(objects) + len(seen_prefix) >= max_keys:
                        truncated = True
                        break
                    seen_prefix.add(cp)
                    prefixes.append(cp)
                    next_marker = cp
                continue
        if len(objects) + len(seen_prefix) >= max_keys:
            truncated = True
            break
        objects.append(info)
        next_marker = name
    return ListObjectsInfo(is_truncated=truncated,
                           next_marker=next_marker if truncated else "",
                           objects=objects, prefixes=prefixes)



def paginate_versions_cached(
    entries: list[tuple[str, list]],
    prefix: str = "",
    marker: str = "",
    version_marker: str = "",
    delimiter: str = "",
    max_keys: int = 1000,
) -> ListObjectVersionsInfo:
    """paginate_versions over a pre-rendered metacache version stream."""
    out = ListObjectVersionsInfo()
    seen_prefix: set[str] = set()
    count = 0
    for name, infos in entries:
        if not name.startswith(prefix):
            continue
        if name == marker and version_marker:
            pass  # resume mid-object below
        elif _skip_for_marker(name, marker, delimiter) or name == marker:
            continue
        if delimiter:
            rest = name[len(prefix):]
            d = rest.find(delimiter)
            if d >= 0:
                cp = prefix + rest[: d + len(delimiter)]
                if cp not in seen_prefix:
                    if count + len(seen_prefix) >= max_keys:
                        out.is_truncated = True
                        return out
                    seen_prefix.add(cp)
                    out.prefixes.append(cp)
                    out.next_marker = cp
                    out.next_version_id_marker = ""
                continue
        skipping = name == marker and bool(version_marker)
        for info in infos:
            if skipping:
                if info.version_id == version_marker:
                    skipping = False
                continue
            if count + len(seen_prefix) >= max_keys:
                out.is_truncated = True
                return out
            out.objects.append(info)
            out.next_marker = name
            out.next_version_id_marker = info.version_id
            count += 1
    out.next_marker = ""
    out.next_version_id_marker = ""
    return out


def _skip_for_marker(name: str, marker: str, delimiter: str) -> bool:
    """Resume semantics: skip names at or before the marker; a marker that
    names a common prefix also skips everything under it (so NextMarker may
    be a CommonPrefix, as in S3)."""
    if not marker:
        return False
    if name <= marker:
        return True
    return bool(delimiter) and marker.endswith(delimiter) and name.startswith(marker)


def paginate_versions(
    journals,
    to_info: Callable[[str, FileInfo], object],
    prefix: str = "",
    marker: str = "",
    version_marker: str = "",
    delimiter: str = "",
    max_keys: int = 1000,
) -> ListObjectVersionsInfo:
    out = ListObjectVersionsInfo()
    seen_prefix: set[str] = set()
    count = 0
    for name, meta in _as_sorted_items(journals):
        if name == marker and version_marker:
            pass  # resume mid-object below
        elif _skip_for_marker(name, marker, delimiter) or name == marker:
            continue
        if delimiter:
            rest = name[len(prefix):]
            d = rest.find(delimiter)
            if d >= 0:
                cp = prefix + rest[: d + len(delimiter)]
                if cp not in seen_prefix:
                    if count + len(seen_prefix) >= max_keys:
                        out.is_truncated = True
                        return out
                    seen_prefix.add(cp)
                    out.prefixes.append(cp)
                    out.next_marker = cp
                    out.next_version_id_marker = ""
                continue
        resuming = name == marker and bool(version_marker)
        skipping = resuming  # drop versions up to and incl. version_marker
        for fi in meta.list_versions("", name):
            if skipping:
                if fi.version_id == version_marker:
                    skipping = False
                continue
            if count + len(seen_prefix) >= max_keys:
                # Markers already name the last emitted item; resume skips
                # through it. Prefixes count against max_keys like versions
                # do (S3 bounds keys + common prefixes together).
                out.is_truncated = True
                return out
            out.objects.append(to_info(name, fi))
            out.next_marker = name
            out.next_version_id_marker = fi.version_id
            count += 1
    out.next_marker = ""
    out.next_version_id_marker = ""
    return out
