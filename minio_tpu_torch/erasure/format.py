"""format.json — per-drive identity and the cluster's set layout.

Same document as minio_tpu/erasure/format.py writes, so a drive set
formatted by either package boots in the other:

    {"version": 1, "format": "erasure", "id": "<deployment uuid>",
     "erasure": {"this": "<drive uuid>",
                 "sets": [["<uuid>", ...]],
                 "distribution_algo": "sipmod"}}

Any subset of the drives proves by quorum what the layout is; a blank
or replaced drive is formatted into a free slot at boot. Live format heal
(heal_format) is later work (ROADMAP.md).
"""

from __future__ import annotations

import json
import time
import uuid
from dataclasses import dataclass

from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils import errors as se

FORMAT_ERASURE = "erasure"
DISTRIBUTION_ALGO = "sipmod"
TRACKER_PATH = "healing.json"   # minio_tpu/erasure/autoheal.py's tracker


@dataclass
class FormatInfo:
    deployment_id: str
    sets: list[list[str]]           # sets x drives UUID matrix
    this: str = ""

    def to_doc(self, this: str) -> dict:
        return {
            "version": 1,
            "format": FORMAT_ERASURE,
            "id": self.deployment_id,
            "erasure": {
                "this": this,
                "sets": self.sets,
                "distribution_algo": DISTRIBUTION_ALGO,
            },
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "FormatInfo":
        if doc.get("version") != 1 or doc.get("format") != FORMAT_ERASURE:
            raise se.CorruptedFormat(f"unrecognized format doc {doc.get('version')}")
        ec = doc.get("erasure", {})
        try:
            return cls(deployment_id=doc["id"], sets=ec["sets"],
                       this=ec.get("this", ""))
        except KeyError as e:
            raise se.CorruptedFormat(f"format doc missing {e}") from e


def init_format_erasure(drives: list[StorageAPI],
                        set_drive_count: int | None = None) -> FormatInfo:
    """Read or create the format of `set_drive_count`-drive sets (default:
    one set of all drives) over `drives`, as minio_tpu/erasure/format.py
    does (reference waitForFormatErasure): a fresh cluster is minted,
    existing formats are elected by quorum on (deployment, layout), and on
    return `drives` is reordered so drives[i] is the drive whose UUID holds
    slot i (set i // set_drive_count), whatever the argument order. Blank
    drives, and drives of this deployment with a stale UUID, are formatted
    into the free slots; a foreign drive or a layout change is refused."""
    n = len(drives)
    set_drive_count = set_drive_count or n
    if n % set_drive_count:
        raise ValueError(f"{n} drives not divisible into sets of {set_drive_count}")
    set_count = n // set_drive_count
    results = parallel_map([d.read_format for d in drives])
    existing = [FormatInfo.from_doc(r) for r in results if isinstance(r, dict)]
    if not existing:
        fmt = FormatInfo(deployment_id=str(uuid.uuid4()),
                         sets=[[str(uuid.uuid4()) for _ in range(set_drive_count)]
                               for _ in range(set_count)])
        outcomes = parallel_map([
            lambda i=i, d=d: d.write_format(fmt.to_doc(
                fmt.sets[i // set_drive_count][i % set_drive_count]))
            for i, d in enumerate(drives)])
        bad = [o for o in outcomes if isinstance(o, Exception)]
        if bad:
            raise bad[0]
        return fmt

    tally: dict[tuple, int] = {}
    for f in existing:
        key = (f.deployment_id, tuple(tuple(s) for s in f.sets))
        tally[key] = tally.get(key, 0) + 1
    (dep_id, sets_key), count = max(tally.items(), key=lambda kv: kv[1])
    if count <= len(existing) // 2:
        raise se.CorruptedFormat("no format quorum across drives")
    ref = FormatInfo(deployment_id=dep_id, sets=[list(s) for s in sets_key])
    if len(ref.sets) != set_count or any(len(s) != set_drive_count
                                         for s in ref.sets):
        raise se.CorruptedFormat(
            f"on-disk layout {len(ref.sets)}x{len(ref.sets[0])} does not match "
            f"requested {set_count}x{set_drive_count}")
    slot_of = {u: si * set_drive_count + di
               for si, s in enumerate(ref.sets) for di, u in enumerate(s)}
    ordered: list[StorageAPI | None] = [None] * n
    blank: list[int] = []       # unformatted, or a stale UUID: claimable
    unreadable: list[int] = []  # may hold a format that cannot be seen
    for i, r in enumerate(results):
        if isinstance(r, dict):
            f = FormatInfo.from_doc(r)
            if f.deployment_id != dep_id:
                raise se.CorruptedFormat(
                    f"drive {i} belongs to deployment {f.deployment_id}, not "
                    f"{dep_id}: refusing to reformat a foreign drive")
            slot = slot_of.get(f.this)
            if slot is not None and ordered[slot] is None:
                ordered[slot] = drives[i]
                continue
            blank.append(i)
        elif isinstance(r, se.UnformattedDisk):
            blank.append(i)
        else:
            unreadable.append(i)
    # While any drive is unreadable, blanks are placed but not formatted:
    # the unreadable one may hold the slot's UUID, and a second drive with
    # it would be a duplicate identity.
    heal_blanks = not unreadable
    for slot in range(n):
        if ordered[slot] is not None:
            continue
        i = blank.pop(0) if blank else unreadable.pop(0)
        ordered[slot] = drives[i]
        if heal_blanks:
            _claim_slot(drives[i], ref,
                        ref.sets[slot // set_drive_count][slot % set_drive_count])
    drives[:] = ordered
    return ref


def _claim_slot(drive: StorageAPI, fmt: FormatInfo, slot_uuid: str) -> None:
    """Format a blank drive, or one of this deployment with a stale UUID,
    into a slot (the boot path of minio_tpu/erasure/format.py:_claim_slot).
    The healing tracker goes first, so a formatted drive with no shards is
    never taken for a healthy one: the port has no auto-healer yet, but the
    tracker is the JAX package's, whose auto-healer rebuilds the drive."""
    try:
        try:
            cur = drive.read_format()
        except se.UnformattedDisk:
            cur = None
        except se.StorageError:
            return      # unmounted, dying or unparseable: refuse
        if cur is not None:
            try:
                f = FormatInfo.from_doc(cur)
            except (se.StorageError, KeyError, TypeError, ValueError):
                return
            if f.deployment_id != fmt.deployment_id or f.this == slot_uuid:
                return  # foreign, or claimed already
        try:
            drive.read_all(SYS_VOL, TRACKER_PATH)
        except se.FileNotFound:
            drive.write_all(SYS_VOL, TRACKER_PATH, json.dumps(
                {"drive_uuid": slot_uuid, "started": time.time(), "bucket": "",
                 "object": "", "healed": 0, "failed": 0,
                 "finished_buckets": []}).encode())
        drive.write_format(fmt.to_doc(slot_uuid))
    except se.StorageError:
        pass
