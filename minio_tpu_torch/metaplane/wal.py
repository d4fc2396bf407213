"""Per-drive WAL journal format and replay fold (counterpart of
minio_tpu/metaplane/wal.py; the frames are byte-equal).

One append-only file per drive at `<root>/.mtpu.sys/wal/journal.wal`:

    MAGIC "MTPUWAL1"
    record*   [u32 payload_len][u32 crc32(payload)][payload]
    payload = [u8 type][f64 mt][u16 vol_len][u16 path_len][u32 raw_len]
              [vol utf-8][path utf-8][raw bytes]

COMMIT carries the whole serialized journal of a key, REMOVE deletes it,
REMOVE_PREFIX drops every earlier record under a (volume, prefix) that a
recursive delete destroyed, BLOB/BLOB_REMOVE write or delete a raw system
file (a multipart part journal, a config document). `mt` is the wall
clock of the record, the replay tiebreak against state an unarmed process
wrote later. The replication intent types are the JAX package's; the
port writes none, and its replay keeps any it finds (it never truncates a
journal holding a record it cannot apply).

A record counts once the fsync covering it returned: `scan` stops at the
first short or corrupt frame, so a torn tail (a kill between append and
fsync) drops only writes that were never acknowledged. Within a file,
file order is commit order; across the segments a multi-worker front
door leaves (`journal.<seg>.wal`, either package's), the newest `mt` wins
per key.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterator, NamedTuple

MAGIC = b"MTPUWAL1"
REC_COMMIT = 1
REC_REMOVE = 2
REC_REMOVE_PREFIX = 3
REC_BLOB = 4
REC_BLOB_REMOVE = 5
REC_REPL_INTENT = 6
REC_REPL_DONE = 7

_FRAME = struct.Struct("<II")       # payload_len, crc32
_HEAD = struct.Struct("<BdHHI")     # type, mt, vol_len, path_len, raw_len

# writev gather-list bound: 4 buffers per record, far under IOV_MAX.
_IOV_RECORDS = 128


class Record(NamedTuple):
    rtype: int
    mt: float
    volume: str
    path: str
    raw: bytes


def frame_record(rtype: int, mt: float, volume: str, path: str, raw) -> list:
    """The writev gather list of one record: [frame + head, vol, path, raw].
    `raw` may be bytes or a memoryview; it is not copied."""
    vb = volume.encode("utf-8")
    pb = path.encode("utf-8")
    head = _HEAD.pack(rtype, mt, len(vb), len(pb), len(raw))
    crc = zlib.crc32(head)
    crc = zlib.crc32(vb, crc)
    crc = zlib.crc32(pb, crc)
    crc = zlib.crc32(raw, crc)
    payload_len = len(head) + len(vb) + len(pb) + len(raw)
    return [_FRAME.pack(payload_len, crc) + head, vb, pb, raw]


def append_records(fd: int, recs: list[list]) -> int:
    """writev framed records (gather lists from frame_record) to an
    O_APPEND fd, in chunks under IOV_MAX; returns the bytes written."""
    total = 0
    flat: list = []
    for gather in recs:
        flat.extend(gather)
        if len(flat) >= _IOV_RECORDS * 4:
            total += _writev_all(fd, flat)
            flat = []
    if flat:
        total += _writev_all(fd, flat)
    return total


def _writev_all(fd: int, bufs: list) -> int:
    want = sum(len(b) for b in bufs)
    done = os.writev(fd, bufs)
    while done < want:
        # Short writev: resume at the byte offset.
        skip = done
        rest = []
        for b in bufs:
            if skip >= len(b):
                skip -= len(b)
                continue
            rest.append(memoryview(b)[skip:] if skip else b)
            skip = 0
        bufs = rest
        n = os.writev(fd, bufs)
        if n <= 0:
            raise OSError("wal writev stalled")
        done += n
    return want


def scan(path: str) -> Iterator[Record]:
    """Durable records in file order, stopping at the first torn or
    corrupt frame. A file without the magic yields nothing."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return
    if not data.startswith(MAGIC):
        return
    off = len(MAGIC)
    n = len(data)
    while off + _FRAME.size <= n:
        payload_len, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        end = start + payload_len
        if payload_len < _HEAD.size or end > n:
            return  # torn tail
        if zlib.crc32(data[start:end]) != crc:
            return  # corrupt frame: stop at the last durable record
        rtype, mt, vl, pl, rl = _HEAD.unpack_from(data, start)
        so = start + _HEAD.size
        if so + vl + pl + rl != end:
            return
        vol = data[so:so + vl].decode("utf-8", "replace")
        key = data[so + vl:so + vl + pl].decode("utf-8", "replace")
        yield Record(rtype, mt, vol, key, data[so + vl + pl:end])
        off = end


def _under(key: tuple[str, str], volume: str, prefix: str) -> bool:
    return key[0] == volume and (not prefix or key[1] == prefix
                                 or key[1].startswith(prefix + "/"))


def fold(path: str) -> dict[tuple[str, str], Record]:
    """The last record per key of one WAL file (file order is commit
    order); a REMOVE_PREFIX drops every earlier record under its prefix
    and is itself consumed."""
    out: dict[tuple[str, str], Record] = {}
    for rec in scan(path):
        if rec.rtype == REC_REMOVE_PREFIX:
            for k in [k for k in out if _under(k, rec.volume, rec.path)]:
                del out[k]
            continue
        out[(rec.volume, rec.path)] = rec
    return out


def segment_paths(wal_dir: str) -> list[str]:
    """Every journal segment under a drive's wal dir, sorted: the classic
    `journal.wal` and a front-door worker's `journal.w<id>.wal`."""
    try:
        names = os.listdir(wal_dir)
    except OSError:
        return []
    return sorted(os.path.join(wal_dir, n) for n in names
                  if n.startswith("journal") and n.endswith(".wal"))


def fold_merged(paths: list[str]) -> dict[tuple[str, str], Record]:
    """The replay fold over several segments: within one, file order;
    across them, the newest `mt` per key, and a REMOVE_PREFIX drops other
    segments' records under its prefix that are not newer than it."""
    folds = []
    tombs: list[tuple[int, Record]] = []
    for si, p in enumerate(paths):
        out: dict[tuple[str, str], Record] = {}
        for rec in scan(p):
            if rec.rtype == REC_REMOVE_PREFIX:
                for k in [k for k in out if _under(k, rec.volume, rec.path)]:
                    del out[k]
                tombs.append((si, rec))
                continue
            out[(rec.volume, rec.path)] = rec
        folds.append(out)
    merged: dict[tuple[str, str], tuple[int, Record]] = {}
    for si, out in enumerate(folds):
        for k, rec in out.items():
            cur = merged.get(k)
            if cur is None or rec.mt >= cur[1].mt:
                merged[k] = (si, rec)
    for tsi, tomb in tombs:
        for k in [k for k, (si, rec) in merged.items()
                  if si != tsi and rec.mt <= tomb.mt
                  and _under(k, tomb.volume, tomb.path)]:
            del merged[k]
    return {k: rec for k, (_si, rec) in merged.items()}


def reset(path: str) -> None:
    """Rewrite an empty journal (the magic alone), durably: after a
    checkpoint or a replay that applied every record."""
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.write(fd, MAGIC)
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(os.path.dirname(path), os.O_RDONLY)
    except OSError:
        return  # the rename above already landed
    try:
        os.fsync(dfd)
    except OSError:
        return
    finally:
        os.close(dfd)
