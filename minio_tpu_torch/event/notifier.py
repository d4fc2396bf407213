"""EventNotifier — rules in, targeted deliveries out (counterpart of
minio_tpu/event/notifier.py).

Role-equivalent of cmd/notification.go NotificationSys.Send (:835) +
cmd/event-notification.go: holds each bucket's parsed rules (fed from the
bucket metadata notification XML), registers targets by ARN, and routes
every data-path event through the matching targets' durable queues.
"""

from __future__ import annotations

import os
import threading

from minio_tpu_torch.event.event import Event
from minio_tpu_torch.event.rules import NotificationConfig, parse_notification_xml
from minio_tpu_torch.event.targets import DeliveryWorker, QueueStore


class EventNotifier:
    def __init__(self, queue_dir: str | None = None):
        self._configs: dict[str, NotificationConfig] = {}
        self._workers: dict[str, DeliveryWorker] = {}
        self._mu = threading.Lock()
        self._queue_dir = queue_dir

    # -- target registry --

    def register_target(self, target, queue_dir: str | None = None) -> None:
        qd = queue_dir or (os.path.join(self._queue_dir,
                                        target.arn.replace(":", "_"))
                           if self._queue_dir else None)
        if qd is None:
            raise ValueError("EventNotifier needs a queue dir for targets")
        with self._mu:
            self._workers[target.arn] = DeliveryWorker(target, QueueStore(qd))

    @property
    def target_arns(self) -> list[str]:
        with self._mu:
            return sorted(self._workers)

    def unregister_target(self, arn: str) -> None:
        """Stop and drop a target's delivery worker (dynamic reconfigure:
        endpoint changed or target disabled)."""
        with self._mu:
            worker = self._workers.pop(arn, None)
        if worker is not None:
            worker.close()

    # -- per-bucket rules --

    def set_bucket_rules(self, bucket: str, notification_xml: bytes) -> None:
        if not notification_xml:
            with self._mu:
                self._configs.pop(bucket, None)
            return
        cfg = parse_notification_xml(notification_xml)
        unknown = [a for a in cfg.arns if a not in self._workers]
        if unknown:
            raise ValueError(f"unknown notification target ARN(s): {unknown}")
        with self._mu:
            self._configs[bucket] = cfg

    def remove_bucket(self, bucket: str) -> None:
        with self._mu:
            self._configs.pop(bucket, None)

    def has_rules(self, bucket: str) -> bool:
        with self._mu:
            return bucket in self._configs

    # -- the send path --

    def send(self, event: Event) -> None:
        """Route one event; never raises into the data path."""
        with self._mu:
            cfg = self._configs.get(event.bucket)
            if cfg is None:
                return
            arns = cfg.match(event.event_name, event.key)
            workers = [self._workers[a] for a in arns if a in self._workers]
        doc = {"EventName": event.event_name,
               "Key": f"{event.bucket}/{event.key}",
               "Records": [event.to_record()]}
        for w in workers:
            try:
                w.enqueue(doc)
            except Exception:  # noqa: BLE001 - queue full: drop, never block IO
                pass

    def close(self) -> None:
        with self._mu:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            w.close()
