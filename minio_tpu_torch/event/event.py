"""S3 event records (counterpart of minio_tpu/event/event.py; reference
pkg/event/event.go: the notification JSON schema)."""

from __future__ import annotations

import datetime
import urllib.parse
from dataclasses import dataclass, field

# Event names (pkg/event/name.go).
OBJECT_CREATED_PUT = "s3:ObjectCreated:Put"
OBJECT_CREATED_POST = "s3:ObjectCreated:Post"
OBJECT_CREATED_COPY = "s3:ObjectCreated:Copy"
OBJECT_CREATED_COMPLETE_MULTIPART = "s3:ObjectCreated:CompleteMultipartUpload"
OBJECT_REMOVED_DELETE = "s3:ObjectRemoved:Delete"
OBJECT_REMOVED_DELETE_MARKER = "s3:ObjectRemoved:DeleteMarkerCreated"
OBJECT_ACCESSED_GET = "s3:ObjectAccessed:Get"
OBJECT_ACCESSED_HEAD = "s3:ObjectAccessed:Head"

ALL_EVENT_NAMES = [
    OBJECT_CREATED_PUT, OBJECT_CREATED_POST, OBJECT_CREATED_COPY,
    OBJECT_CREATED_COMPLETE_MULTIPART, OBJECT_REMOVED_DELETE,
    OBJECT_REMOVED_DELETE_MARKER, OBJECT_ACCESSED_GET, OBJECT_ACCESSED_HEAD,
]


def expand_event_pattern(name: str) -> list[str]:
    """s3:ObjectCreated:* -> every concrete created event
    (pkg/event/name.go Expand)."""
    if name.endswith(":*"):
        prefix = name[:-1]  # keep trailing ':'
        return [n for n in ALL_EVENT_NAMES if n.startswith(prefix)]
    return [name]


@dataclass
class Event:
    event_name: str
    bucket: str
    key: str
    size: int = 0
    etag: str = ""
    version_id: str = ""
    sequencer: str = ""
    region: str = ""
    user_identity: str = ""
    source_host: str = ""
    time: str = ""

    def to_record(self) -> dict:
        """One entry of the Records[] array (pkg/event/event.go:79)."""
        return {
            "eventVersion": "2.0",
            "eventSource": "minio_tpu:s3",
            "awsRegion": self.region,
            "eventTime": self.time,
            "eventName": self.event_name,
            "userIdentity": {"principalId": self.user_identity},
            "requestParameters": {"sourceIPAddress": self.source_host},
            "responseElements": {},
            "s3": {
                "s3SchemaVersion": "1.0",
                "bucket": {
                    "name": self.bucket,
                    "ownerIdentity": {"principalId": self.user_identity},
                    "arn": f"arn:aws:s3:::{self.bucket}",
                },
                "object": {
                    "key": urllib.parse.quote(self.key),
                    "size": self.size,
                    "eTag": self.etag,
                    "versionId": self.version_id,
                    "sequencer": self.sequencer,
                },
            },
        }


def new_object_event(event_name: str, bucket: str, key: str, *,
                     size: int = 0, etag: str = "", version_id: str = "",
                     user: str = "", host: str = "",
                     region: str = "") -> Event:
    now = datetime.datetime.now(datetime.timezone.utc)
    return Event(
        event_name=event_name, bucket=bucket, key=key, size=size,
        etag=etag, version_id=version_id,
        sequencer=f"{int(now.timestamp() * 1e6):016X}",
        region=region, user_identity=user, source_host=host,
        time=now.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
    )
