"""Bucket event notifications (counterpart of minio_tpu/event/;
reference pkg/event): S3 notification rules (parsed from the bucket
notification XML), ARN-addressed targets with an at-least-once
store-and-forward queue, and the event record schema S3 clients expect.
"""

from minio_tpu_torch.event.event import Event, new_object_event
from minio_tpu_torch.event.notifier import EventNotifier
from minio_tpu_torch.event.rules import NotificationConfig, parse_notification_xml
from minio_tpu_torch.event.targets import MemoryTarget, Target, WebhookTarget

__all__ = ["Event", "new_object_event", "NotificationConfig",
           "parse_notification_xml", "EventNotifier", "Target",
           "WebhookTarget", "MemoryTarget"]
