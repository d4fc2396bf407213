"""DataScanner — the background crawl that feeds usage accounting,
lifecycle expiry, tier transitions and heal (counterpart of
minio_tpu/scanner/scanner.py; reference cmd/data-scanner.go,
initDataScanner:65, runDataScanner:72).

Each cycle walks every bucket's version listing, updates the usage tree,
applies due ILM actions through the object layer (expiry, noncurrent
expiry, delete-marker cleanup, the transition of a version's data to its
rule's tier), aborts expired multipart uploads and, every
HEAL_EVERY_N_CYCLES-th cycle, heals every object: with the `heal`
subsystem's bitrotscan=on that heal verifies every shard's digests (K2,
or K3 under mxhash256) and rebuilds bad ones (K1). The scanner does no
device work of its own: it reaches the card through the object layer's
heal, GET and PUT, on the layer's device. It runs as a daemon thread with
an adaptive pause; `scan_once(now=...)` is the deterministic unit tests
and the chip smoke drive. Its checkpoint and usage documents are the JAX
package's bytes (utils/msgpack.py), so a cycle interrupted under one
package resumes under the other.
"""

from __future__ import annotations

import logging
import threading
import time

from minio_tpu_torch.bucket.meta import BucketMetadataSys
from minio_tpu_torch.erasure.types import ObjectOptions
from minio_tpu_torch.scanner import lifecycle as lc
from minio_tpu_torch.scanner.usage import DataUsageCache, UsageEntry
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils import msgpack

log = logging.getLogger("minio_tpu_torch.scanner")

SCAN_INTERVAL = 60.0
HEAL_EVERY_N_CYCLES = 16   # objects deep-checked 1/N of cycles (reference
                           # healObjectSelectProb, data-scanner.go)
PAGE = 1000
POSITION_PATH = "scanner/cycle-position.mp"  # mid-cycle checkpoint


class DataScanner:
    def __init__(self, object_layer, bucket_meta: BucketMetadataSys,
                 store=None, notifier=None,
                 interval: float = SCAN_INTERVAL,
                 heal_objects: bool = False, tracker=None, config=None,
                 replication=None):
        self.obj = object_layer
        self.bucket_meta = bucket_meta
        # Config KV provider for the `heal` subsystem (bitrotscan toggle —
        # reference cmd/config/heal: scanner heals deep-verify shards when
        # heal.bitrotscan=on). Live: admin config-set applies next cycle.
        self.config = config
        self.store = store if store is not None else (
            object_layer if hasattr(object_layer, "read_sys_config") else None)
        self.notifier = notifier
        self.interval = interval
        self.heal_objects = heal_objects
        self.usage = (DataUsageCache.load(self.store)
                      if self.store is not None else DataUsageCache())
        # Change tracker: skip clean buckets between full sweeps
        # (cmd/data-update-tracker.go role).
        if tracker is None and self.store is not None:
            from minio_tpu_torch.scanner.tracker import UpdateTracker

            tracker = UpdateTracker(self.store)
        self.tracker = tracker
        # Replication MRF rider (docs/REPLICATION.md): each completed
        # cycle nudges the pool's resync pass, so stranded
        # PENDING/FAILED statuses requeue on the scanner cadence even
        # if the pool's own timer thread died.
        self.replication = replication
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle of the scanner itself --

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="data-scanner")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def _cycle_pause(self) -> float:
        """Pause between cycles: the live `scanner.cycle` config key when
        EXPLICITLY set (admin config-set applies on the NEXT wait, like
        the other scanner knobs), else the constructor interval. The
        built-in default ("1m") does not override the deployment's
        configured interval — only an operator's set does, mirroring the
        configured-values-only rule the storage-class clamp follows."""
        if self.config is not None:
            from minio_tpu_torch.admin.configkv import DEFAULTS
            from minio_tpu_torch.utils.dyntimeout import parse_duration

            raw = self.config.get("scanner", "cycle") or ""
            if raw and raw != DEFAULTS["scanner"]["cycle"]:
                v = parse_duration(raw, self.interval)
                if v > 0:
                    return v
        return self.interval

    def _loop(self) -> None:
        while not self._stop.wait(self._cycle_pause()):
            try:
                self.scan_once()
            except Exception:  # noqa: BLE001 - scanner must never die
                log.exception("scan cycle failed")

    # -- one full cycle --

    def scan_once(self, now: float | None = None) -> DataUsageCache:
        """Crawl everything once; returns the fresh usage cache.

        Mid-cycle resumable (reference healingTracker/scanner persistence
        pattern, SURVEY §5.4): a checkpoint doc records the cycle's work
        list and each bucket's finished accounting after that bucket
        completes, so a restart resumes the interrupted cycle at the next
        bucket instead of restarting the crawl.
        """
        fresh = DataUsageCache()
        fresh.cycles = self.usage.cycles + 1
        deep_heal = self.heal_objects and fresh.cycles % HEAL_EVERY_N_CYCLES == 0
        bitrot_scan = False
        if self.config is not None:
            try:
                bitrot_scan = (
                    self.config.get("heal", "bitrotscan") == "on")
            except Exception:  # noqa: BLE001 - config unavailable
                pass
        self._load_pacing()

        buckets = [b.name for b in self.obj.list_buckets()]
        lifecycles: dict[str, object] = {}
        for bucket in buckets:
            meta = self.bucket_meta.get(bucket) if self.bucket_meta else None
            if meta is not None and meta.lifecycle_xml:
                try:
                    lifecycles[bucket] = lc.parse_lifecycle_xml(
                        meta.lifecycle_xml)
                except ValueError:
                    pass

        ckpt = self._load_position()
        resume_done: dict[str, UsageEntry] = {}
        if ckpt is not None and ckpt.get("c") == fresh.cycles:
            # Interrupted cycle: reuse its work list and finished buckets.
            # Lifecycle-bearing buckets re-union in (a rule attached after
            # the checkpoint must still fire this cycle); already-finished
            # buckets stay skipped via resume_done.
            to_scan = sorted(
                {b for b in ckpt.get("ts", []) if b in buckets}
                | set(lifecycles))
            resume_done = {k: UsageEntry.from_doc(v)
                           for k, v in ckpt.get("d", {}).items()
                           if k in buckets}
        else:
            ckpt = None
            if self.tracker is not None:
                scan_set, _full = self.tracker.begin_cycle(buckets)
                # Time-based expiry must fire without writes:
                # lifecycle-bearing buckets always scan.
                to_scan = sorted(set(scan_set) | set(lifecycles))
            else:
                to_scan = buckets

        done_docs: dict[str, dict] = dict(ckpt.get("d", {})) if ckpt else {}
        scanned = 0
        last_ckpt = time.monotonic()
        interrupted = False
        for bucket in buckets:
            if self._stop.is_set():
                interrupted = True
                break
            lifecycle = lifecycles.get(bucket)
            if bucket in resume_done:
                fresh.buckets[bucket] = resume_done[bucket]
                continue
            if bucket not in to_scan:
                # Clean since last cycle: carry the previous accounting.
                prev = self.usage.buckets.get(bucket)
                if prev is not None:
                    fresh.buckets[bucket] = prev
                continue
            self._scan_bucket(bucket, lifecycle, fresh, deep_heal, now,
                              bitrot_scan)
            if lifecycle is not None:
                self._expire_mpus(bucket, lifecycle, now)
            done_docs[bucket] = fresh.bucket(bucket).to_doc()
            scanned += 1
            # Checkpoint after the first bucket, then every 16th / 5 s —
            # every-bucket rewrites of the full map would be O(n^2) I/O
            # across a many-bucket cycle.
            if scanned % 16 == 1 or time.monotonic() - last_ckpt > 5.0:
                self._save_position(fresh.cycles, to_scan, done_docs)
                last_ckpt = time.monotonic()

        if interrupted:
            # Graceful stop mid-cycle: leave the persisted usage at the
            # last COMPLETE cycle and keep the checkpoint so the next
            # start resumes this cycle instead of committing a partial
            # crawl as authoritative accounting.
            self._save_position(fresh.cycles, to_scan, done_docs)
            return fresh

        self.usage = fresh
        if self.store is not None:
            try:
                fresh.save(self.store)
            except Exception:  # noqa: BLE001 - accounting is best-effort
                log.exception("usage persist failed")
            self._clear_position()
        if self.replication is not None:
            try:
                self.replication.resync_once()
            except Exception:  # noqa: BLE001 - resync is best-effort here
                log.exception("replication resync (scanner) failed")
        return fresh

    # -- mid-cycle checkpoint --

    def _load_position(self) -> dict | None:
        if self.store is None:
            return None
        try:
            return msgpack.unpackb(self.store.read_sys_config(POSITION_PATH))
        except Exception:  # noqa: BLE001 - missing/corrupt = fresh cycle
            return None

    def _save_position(self, cycle: int, to_scan: list,
                       done_docs: dict) -> None:
        if self.store is None:
            return
        try:
            self.store.write_sys_config(POSITION_PATH, msgpack.packb(
                {"c": cycle, "ts": list(to_scan), "d": done_docs}))
        except Exception:  # noqa: BLE001 - checkpoint is best-effort
            log.exception("scanner checkpoint persist failed")

    def _clear_position(self) -> None:
        if self.store is None:
            return
        try:
            self.store.delete_sys_config(POSITION_PATH)
        except Exception:  # noqa: BLE001
            pass

    def _load_pacing(self) -> None:
        """Adaptive pacing from the `scanner` config (the reference's
        scannerSleeper, cmd/data-scanner.go): after each page the scanner
        sleeps delay x the time the page took, capped at max_wait — the
        crawl yields CPU/IO to foreground traffic proportionally to how
        expensive it is. delay=0 disables."""
        self._pace_delay = 0.0
        self._pace_cap = 15.0
        if self.config is None:
            return
        try:
            self._pace_delay = max(0.0, float(
                self.config.get("scanner", "delay") or 0))
        except Exception:  # noqa: BLE001
            pass
        from minio_tpu_torch.utils.dyntimeout import parse_duration

        try:
            self._pace_cap = parse_duration(
                self.config.get("scanner", "max_wait"), 15.0)
        except Exception:  # noqa: BLE001
            pass

    def _pace(self, elapsed: float) -> None:
        if getattr(self, "_pace_delay", 0.0) <= 0:
            return
        self._stop.wait(min(elapsed * self._pace_delay, self._pace_cap))

    def _scan_bucket(self, bucket: str, lifecycle, fresh: DataUsageCache,
                     deep_heal: bool, now: float | None,
                     bitrot_scan: bool = False) -> None:
        entry = fresh.bucket(bucket)
        marker = vmarker = ""
        while True:
            _t0 = time.monotonic()
            try:
                page = self.obj.list_object_versions(
                    bucket, "", marker, vmarker, "", PAGE)
            except se.BucketNotFound:
                return
            # Group versions per object so num_versions/successor times are
            # known to the lifecycle evaluator.
            by_key: dict[str, list] = {}
            for o in page.objects:
                by_key.setdefault(o.name, []).append(o)
            for key, versions in by_key.items():
                versions.sort(key=lambda o: o.mod_time, reverse=True)
                for i, o in enumerate(versions):
                    entry.add_version(o.size, o.is_latest, o.delete_marker)
                    if lifecycle is not None:
                        self._apply_ilm(bucket, o, lifecycle,
                                        num_versions=len(versions),
                                        successor=versions[i - 1].mod_time
                                        if i > 0 else 0.0,
                                        now=now)
                if deep_heal:
                    try:
                        # heal.bitrotscan=on upgrades the periodic heal to
                        # a full shard bitrot verify (reference scanner
                        # deep scan mode).
                        self.obj.heal_object(bucket, key,
                                             scan_deep=bitrot_scan)
                    except Exception:  # noqa: BLE001
                        pass
            self._pace(time.monotonic() - _t0)
            if not page.is_truncated:
                return
            marker = page.next_marker
            vmarker = page.next_version_id_marker

    def _apply_ilm(self, bucket: str, o, lifecycle, *, num_versions: int,
                   successor: float, now: float | None) -> None:
        from minio_tpu_torch.scanner import tiers as tiermod

        action = lifecycle.eval(
            o.name, o.mod_time, is_latest=o.is_latest,
            delete_marker=o.delete_marker, num_versions=num_versions,
            successor_mod_time=successor,
            transitioned=tiermod.TRANSITION_TIER in o.user_defined,
            now=now)
        if action == lc.TRANSITION:
            self._transition(bucket, o, lifecycle, now)
            return
        try:
            if action == lc.DELETE:
                # Expiring the latest version of a versioned object writes a
                # delete marker; unversioned objects are removed outright.
                versioned = (self.bucket_meta.get(bucket).versioning_enabled
                             if self.bucket_meta else False)
                self.obj.delete_object(
                    bucket, o.name, ObjectOptions(versioned=versioned))
            elif action in (lc.DELETE_VERSION, lc.DELETE_MARKER):
                self.obj.delete_object(
                    bucket, o.name,
                    ObjectOptions(version_id=o.version_id, versioned=True))
            else:
                return
        except (se.ObjectError, se.StorageError):
            return
        if self.notifier is not None:
            from minio_tpu_torch.event import event as evt
            from minio_tpu_torch.event import new_object_event

            self.notifier.send(new_object_event(
                evt.OBJECT_REMOVED_DELETE, bucket, o.name,
                version_id=o.version_id, user="minio_tpu:ilm"))

    def _transition(self, bucket: str, o, lifecycle,
                    now: float | None = None) -> None:
        """Move a due version's data to its rule's tier and stub the
        version (reference transition workers, cmd/bucket-lifecycle.go:
        108-135). Stored bytes (post-SSE/compression) move verbatim, so
        read-through decrypts exactly as local reads do."""
        from minio_tpu_torch.scanner import tiers as tiermod

        reg = tiermod.global_registry()
        if reg is None:
            return
        tier_name = lifecycle.transition_tier(o.name, o.mod_time, now=now)
        if not tier_name:
            return
        try:
            tier = reg.get(tier_name)
        except tiermod.TierError:
            return
        opts = ObjectOptions(version_id=o.version_id)
        tier_key = f"{bucket}/{o.name}/{o.version_id or 'null'}"
        try:
            _info, stream = self.obj.get_object(bucket, o.name, opts=opts)
            tier.put(tier_key, stream)
            # expect_mod_time guards the stub commit: if a client replaced
            # the object while we copied, the transition aborts and the
            # tier copy is discarded (no TOCTOU data loss).
            self.obj.transition_version(bucket, o.name, o.version_id,
                                        tier_name, tier_key,
                                        storage_class=tier_name,
                                        expect_mod_time=o.mod_time)
        except (se.ObjectError, se.StorageError, tiermod.TierError, OSError):
            tier.remove(tier_key)  # best-effort cleanup of a half-move

    def _expire_mpus(self, bucket: str, lifecycle, now: float | None) -> None:
        try:
            uploads = self.obj.list_multipart_uploads(bucket, "", 1000)
        except (se.ObjectError, se.StorageError):
            return
        for up in uploads:
            if lifecycle.mpu_expired(up.initiated, now):
                try:
                    self.obj.abort_multipart_upload(bucket, up.object,
                                                    up.upload_id)
                except (se.ObjectError, se.StorageError):
                    pass
