"""Background drive heal with a resumable tracker kept on the drive
(counterpart of minio_tpu/erasure/autoheal.py, reference
cmd/background-newdisks-heal-ops.go).

When a blank or replaced drive is formatted into a slot (at boot by
init_format_erasure, live by heal_format), a healing tracker,
.mtpu.sys/healing.json, is written onto that drive before its format.json.
The AutoHealer finds every drive that carries one, walks its set's
buckets and objects through heal_object (the rebuild runs kernel K1 with
the decode matrix as runtime data, then K2 over the rebuilt chunks),
saves its bookmark every CHECKPOINT_EVERY objects so a restart resumes
the walk, and removes the tracker when the walk is done.

The tracker document is the JAX package's, byte for byte in both
directions: a drive that either package marked is healed by the other.
"""

from __future__ import annotations

import json
import threading
import time

from minio_tpu_torch.storage.api import StorageAPI
from minio_tpu_torch.storage.local import SYS_VOL
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.dyntimeout import parse_duration

TRACKER_PATH = "healing.json"
CHECKPOINT_EVERY = 16   # objects healed between tracker saves


class HealingTracker:
    """Progress bookmark kept on the drive being healed."""

    def __init__(self, drive_uuid: str = "", started: float = 0.0,
                 bucket: str = "", obj: str = "", healed: int = 0,
                 failed: int = 0, finished_buckets: list[str] | None = None):
        self.drive_uuid = drive_uuid
        self.started = started or time.time()
        self.bucket = bucket          # bucket being walked
        self.obj = obj                # last object healed in it
        self.healed = healed
        self.failed = failed
        self.finished_buckets = finished_buckets or []

    def to_doc(self) -> dict:
        return {"drive_uuid": self.drive_uuid, "started": self.started,
                "bucket": self.bucket, "object": self.obj,
                "healed": self.healed, "failed": self.failed,
                "finished_buckets": self.finished_buckets}

    @classmethod
    def from_doc(cls, doc: dict) -> "HealingTracker":
        return cls(drive_uuid=doc.get("drive_uuid", ""),
                   started=doc.get("started", 0.0),
                   bucket=doc.get("bucket", ""), obj=doc.get("object", ""),
                   healed=doc.get("healed", 0), failed=doc.get("failed", 0),
                   finished_buckets=doc.get("finished_buckets", []))

    def save(self, drive: StorageAPI) -> None:
        try:
            drive.make_vol(SYS_VOL)
        except se.StorageError:
            pass
        drive.write_all(SYS_VOL, TRACKER_PATH, json.dumps(self.to_doc()).encode())

    @staticmethod
    def load(drive: StorageAPI) -> "HealingTracker | None":
        try:
            raw = drive.read_all(SYS_VOL, TRACKER_PATH)
        except se.StorageError:
            return None
        try:
            return HealingTracker.from_doc(json.loads(raw))
        except (ValueError, KeyError, AttributeError):
            return None

    @staticmethod
    def delete(drive: StorageAPI) -> None:
        try:
            drive.delete(SYS_VOL, TRACKER_PATH)
        except se.StorageError:
            pass


def mark_drive_healing(drive: StorageAPI, drive_uuid: str) -> None:
    """Leave a fresh tracker on a drive just claimed into a slot, unless it
    carries one already (a resumed heal keeps its bookmark). The one
    writer of the tracker document (cmd/erasure-sets.go:197 healFreshDisk)."""
    if HealingTracker.load(drive) is None:
        HealingTracker(drive_uuid=drive_uuid).save(drive)


class AutoHealer:
    """Background monitor (reference monitorLocalDisksAndHeal): each pass
    first runs heal_format, when it was given an ErasureSets (which carries
    the format), so a wiped or swapped drive is claimed live; then it walks
    the set of every drive that carries a tracker through heal_object.

    `sets` is an ErasureSets, or one ErasureObjects. `config`, when given,
    answers config.get("heal", "max_sleep") and config.get("heal",
    "max_io"); `load_fn` returns the foreground request count. While that
    count is above max_io the walk sleeps up to max_sleep after each
    object (reference waitForLowHTTPReq); an idle server heals at full
    speed, and without a config there is no pacing."""

    def __init__(self, sets, interval: float = 10.0, config=None, load_fn=None):
        self._owner = sets if hasattr(sets, "format") else None
        self._sets = getattr(sets, "sets", None) or [sets]
        self.interval = interval
        self.config = config
        self.load_fn = load_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # The tracker of the last walk that ran to its end (its healed and
        # failed counts), for the caller: the drive's copy is deleted.
        self.last_walk: HealingTracker | None = None

    def _pacing(self) -> tuple[float, int]:
        """(max_sleep seconds, max_io); (0, 1) turns pacing off."""
        if self.config is None:
            return 0.0, 1
        try:
            max_sleep = parse_duration(self.config.get("heal", "max_sleep"), 0.0)
        except Exception:  # noqa: BLE001 - a bad value turns pacing off
            max_sleep = 0.0
        try:
            max_io = max(1, int(self.config.get("heal", "max_io") or 1))
        except Exception:  # noqa: BLE001
            max_io = 1
        return max(0.0, max_sleep), max_io

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mtpu-autoheal")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 - the monitor outlives a bad pass
                pass

    def run_once(self) -> int:
        """One pass: heal_format, then every drive carrying a tracker;
        returns the number of drives walked."""
        if self._owner is not None:
            from minio_tpu_torch.erasure.format import heal_format

            try:
                heal_format(self._owner)
            except Exception:  # noqa: BLE001 - the monitor outlives a bad pass
                pass
        walked = 0
        for es in self._sets:
            for drive in es.drives:
                if self._stop.is_set():
                    return walked
                tracker = HealingTracker.load(drive)
                if tracker is None:
                    continue
                self._heal_set_onto(es, drive, tracker)
                walked += 1
        return walked

    def _heal_set_onto(self, es, drive: StorageAPI, tracker: HealingTracker) -> None:
        """Walk the set's buckets and objects from the tracker's bookmark,
        healing each; heal_object rebuilds onto every drive that lacks the
        object, this one included. A walk heals latest versions only, as
        the JAX package's does (heal_object with no version id)."""
        buckets = sorted(b.name for b in es.list_buckets())
        since_save = 0
        max_sleep, max_io = self._pacing()
        for bucket in buckets:
            if bucket in tracker.finished_buckets:
                continue
            if tracker.bucket and bucket < tracker.bucket:
                tracker.finished_buckets.append(bucket)
                continue
            try:
                es.heal_bucket(bucket)
            except se.StorageError:
                pass
            start_after = tracker.obj if tracker.bucket == bucket else ""
            # The bookmark skips healed names without parsing their journals.
            for name, _meta in es.stream_journals(bucket, "", start_after=start_after):
                if self._stop.is_set():
                    tracker.save(drive)
                    return
                try:
                    es.heal_object(bucket, name)
                    tracker.healed += 1
                except Exception:  # noqa: BLE001 - counted, the walk goes on
                    tracker.failed += 1
                tracker.bucket, tracker.obj = bucket, name
                since_save += 1
                if (max_sleep > 0 and self.load_fn is not None
                        and self.load_fn() > max_io):
                    if self._stop.wait(max_sleep):
                        tracker.save(drive)
                        return
                if since_save >= CHECKPOINT_EVERY:
                    tracker.save(drive)
                    since_save = 0
            tracker.finished_buckets.append(bucket)
            tracker.bucket, tracker.obj = "", ""
            tracker.save(drive)
        self.last_walk = tracker
        HealingTracker.delete(drive)
