"""format.json — per-drive identity and set layout for one erasure set.

Same document as minio_tpu/erasure/format.py writes, so a drive set
formatted by either package boots in the other:

    {"version": 1, "format": "erasure", "id": "<deployment uuid>",
     "erasure": {"this": "<drive uuid>",
                 "sets": [["<uuid>", ...]],
                 "distribution_algo": "sipmod"}}

This slice reads or creates the format of a single set; several sets,
pools and live format heal are later work (ROADMAP.md).
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass

from minio_tpu_torch.erasure.metadata import parallel_map
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


def init_format_erasure(drives: list[StorageAPI]) -> FormatInfo:
    """Read or create the format of one set over `drives`; on return
    `drives` is reordered so drives[i] is the drive whose UUID holds slot i
    (the layout comes from the format, not from argument order). Blank
    drives of an existing set are formatted into the free slots."""
    n = len(drives)
    results = parallel_map([d.read_format for d in drives])
    existing = [FormatInfo.from_doc(r) for r in results if isinstance(r, dict)]
    if not existing:
        fmt = FormatInfo(deployment_id=str(uuid.uuid4()),
                         sets=[[str(uuid.uuid4()) for _ in range(n)]])
        outcomes = parallel_map([
            lambda i=i, d=d: d.write_format(fmt.to_doc(fmt.sets[0][i]))
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
    if len(ref.sets) != 1 or len(ref.sets[0]) != n:
        raise se.CorruptedFormat(
            f"on-disk layout {len(ref.sets)}x{len(ref.sets[0])} is not one "
            f"set of {n} drives")
    slot_of = {u: i for i, u in enumerate(ref.sets[0])}
    ordered: list[StorageAPI | None] = [None] * n
    blank: list[int] = []
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
            raise r
    for slot in range(n):
        if ordered[slot] is None:
            i = blank.pop(0)
            drives[i].write_format(ref.to_doc(ref.sets[0][slot]))
            ordered[slot] = drives[i]
    drives[:] = ordered
    return ref
