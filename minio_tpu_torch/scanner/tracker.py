"""Data update tracker — which namespaces changed since the last scan
(counterpart of minio_tpu/scanner/tracker.py; the same JSON document).

Role-equivalent of cmd/data-update-tracker.go:64 (a bloom-filter journal of
modified paths cycled via peer RPC): the scanner only deep-walks buckets
that saw writes since its last cycle, with a periodic full sweep as the
safety net. The set of buckets is small (vs the reference's per-path
bloom), so an exact dirty-set journal gives the same skip behavior without
false-positive tuning; the persisted form survives restarts.
"""

from __future__ import annotations

import json
import threading

from minio_tpu_torch.utils import errors as se

FULL_SWEEP_EVERY = 16        # cycles between unconditional full scans
PATH = "scanner/update-tracker.json"


class UpdateTracker:
    def __init__(self, store=None):
        self._store = store
        self._mu = threading.Lock()
        self._dirty: set[str] = set()
        self._cycle = 0
        if store is not None:
            self._load()

    def _load(self) -> None:
        try:
            doc = json.loads(self._store.read_sys_config(PATH))
            self._dirty = set(doc.get("dirty", []))
            self._cycle = int(doc.get("cycle", 0))
        except (se.FileNotFound, ValueError):
            pass

    def _persist(self) -> None:
        if self._store is None:
            return
        try:
            self._store.write_sys_config(PATH, json.dumps(
                {"dirty": sorted(self._dirty),
                 "cycle": self._cycle}).encode())
        except Exception:  # noqa: BLE001 - tracker is an optimization
            pass

    # -- data-path side --

    def mark(self, bucket: str) -> None:
        with self._mu:
            if bucket in self._dirty:
                return
            self._dirty.add(bucket)
        self._persist()

    # -- scanner side --

    def begin_cycle(self, all_buckets: list[str]) -> tuple[list[str], bool]:
        """Buckets to scan this cycle + whether it's a full sweep. Clears
        the dirty set (writes landing mid-scan re-mark)."""
        with self._mu:
            self._cycle += 1
            full = self._cycle % FULL_SWEEP_EVERY == 0 or not self._dirty
            scan = list(all_buckets) if full else [
                b for b in all_buckets if b in self._dirty]
            self._dirty.clear()
        self._persist()
        return scan, full
