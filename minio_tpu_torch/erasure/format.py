"""format.json — per-drive identity and the cluster's set layout.

Same document as minio_tpu/erasure/format.py writes, so a drive set
formatted by either package boots in the other:

    {"version": 1, "format": "erasure", "id": "<deployment uuid>",
     "erasure": {"this": "<drive uuid>",
                 "sets": [["<uuid>", ...]],
                 "distribution_algo": "sipmod"}}

Any subset of the drives proves by quorum what the layout is; a blank
or replaced drive is formatted into a free slot at boot
(init_format_erasure) or while the server runs (heal_format, which the
AutoHealer calls on every pass). Either claim leaves a healing tracker on
the drive first, so the AutoHealer rebuilds its shards.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass

from minio_tpu_torch.erasure.autoheal import mark_drive_healing
from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.storage.healthcheck import fleet_deadlines, unwrap
from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.utils import errors as se

FORMAT_ERASURE = "erasure"
DISTRIBUTION_ALGO = "sipmod"


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
                        set_drive_count: int | None = None,
                        can_format_fresh: bool = True) -> FormatInfo:
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
    results = parallel_map([d.read_format for d in drives],
                           deadline=fleet_deadlines(drives)[0])
    existing = [FormatInfo.from_doc(r) for r in results if isinstance(r, dict)]
    if not existing:
        if not can_format_fresh:
            raise se.OperationTimedOut(
                "", "", "fresh cluster: waiting for the first node to "
                "write the format")
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
        for i, d in enumerate(drives):
            d.set_disk_id(fmt.sets[i // set_drive_count][i % set_drive_count])
        return fmt

    tally: dict[tuple, int] = {}
    for f in existing:
        key = (f.deployment_id, tuple(tuple(s) for s in f.sets))
        tally[key] = tally.get(key, 0) + 1
    (dep_id, sets_key), count = max(tally.items(), key=lambda kv: kv[1])
    if count <= len(existing) // 2:
        if not can_format_fresh:
            # A follower racing the leader's format writes: transient.
            raise se.OperationTimedOut(
                "", "", "format quorum not yet visible; waiting")
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
                drives[i].set_disk_id(f.this)
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
            # Boot classified every drive, so a placed but duplicate UUID
            # here is a real duplicate to reclaim.
            _claim_slot(drives[i], ref,
                        ref.sets[slot // set_drive_count][slot % set_drive_count],
                        allow_placed_reclaim=True)
    drives[:] = ordered
    return ref


def _claim_slot(drive: StorageAPI, fmt: FormatInfo, slot_uuid: str,
                allow_placed_reclaim: bool = False) -> bool:
    """Format a blank drive, or one of this deployment with a stale UUID,
    into a slot, bind its disk-ID guard, and leave a healing tracker so the
    AutoHealer rebuilds its shards (minio_tpu/erasure/format.py
    _claim_slot; reference healFreshDisk). Shared by boot and heal_format.
    Returns whether it claimed the drive."""
    # The tracker is written through the bare drive: the disk-ID check
    # rightly refuses a drive whose format does not name the slot yet.
    base = unwrap(drive)
    try:
        try:
            cur = base.read_format()
        except se.UnformattedDisk:
            cur = None
        except se.StorageError:
            return False    # unmounted, dying or unparseable: refuse
        if cur is not None:
            try:
                f = FormatInfo.from_doc(cur)
            except (se.StorageError, KeyError, TypeError, ValueError):
                return False
            if f.deployment_id != fmt.deployment_id or f.this == slot_uuid:
                return False    # foreign, or claimed already for this slot
            if any(f.this in s for s in fmt.sets) and not allow_placed_reclaim:
                # Placed in another slot: someone else claimed the drive.
                return False
        # The tracker goes first: a formatted drive with no shards and no
        # tracker would be taken for a healthy one.
        mark_drive_healing(base, slot_uuid)
        drive.write_format(fmt.to_doc(slot_uuid))
        drive.set_disk_id(slot_uuid)
        return True
    except se.StorageError:
        return False    # still dying: the next pass or boot retries


def heal_format(es_sets) -> int:
    """Live drive replacement (minio_tpu/erasure/format.py heal_format;
    reference HealFormat, cmd/erasure-server-pool.go:1366): probe every
    slot of a running ErasureSets and claim each drive that is blank, or
    of this deployment with a stale UUID that no slot holds. A foreign
    drive, or one whose format cannot be read or parsed, is never
    reformatted. Returns the number of slots claimed."""
    fmt: FormatInfo = es_sets.format
    sdc = es_sets.set_drive_count
    placed = {u for s in fmt.sets for u in s}
    healed = 0
    for slot, drive in enumerate(es_sets.drives):
        slot_uuid = fmt.sets[slot // sdc][slot % sdc]
        try:
            f = FormatInfo.from_doc(drive.read_format())
            if (f.deployment_id != fmt.deployment_id
                    or f.this == slot_uuid or f.this in placed):
                continue    # foreign, correct, or placed elsewhere
        except se.UnformattedDisk:
            pass
        except (se.StorageError, KeyError, TypeError, ValueError):
            continue
        if _claim_slot(drive, fmt, slot_uuid):
            healed += 1
    return healed
