"""Notification rule parsing + matching (counterpart of
minio_tpu/event/rules.py).

Role-equivalent of pkg/event/rules.go + pkg/event/config.go: the bucket
notification XML declares (ARN, event patterns, prefix/suffix filters);
an event matches a rule when its name is covered and the key passes the
filters.
"""

from __future__ import annotations

import fnmatch
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from minio_tpu_torch.event.event import expand_event_pattern


@dataclass
class Rule:
    arn: str
    events: list[str]               # concrete event names (expanded)
    prefix: str = ""
    suffix: str = ""
    id: str = ""

    def matches(self, event_name: str, key: str) -> bool:
        return (event_name in self.events
                and key.startswith(self.prefix)
                and key.endswith(self.suffix))


@dataclass
class NotificationConfig:
    rules: list[Rule] = field(default_factory=list)

    def match(self, event_name: str, key: str) -> list[str]:
        """ARNs that want this event (deduplicated, stable order)."""
        out: list[str] = []
        for r in self.rules:
            if r.matches(event_name, key) and r.arn not in out:
                out.append(r.arn)
        return out

    @property
    def arns(self) -> list[str]:
        return sorted({r.arn for r in self.rules})


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def parse_notification_xml(body: bytes) -> NotificationConfig:
    """Parse <NotificationConfiguration> with QueueConfiguration /
    TopicConfiguration / CloudFunctionConfiguration entries (all three
    shapes carry the same fields; the reference accepts queue configs for
    its ARN targets)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise ValueError(f"malformed notification XML: {e}") from None
    cfg = NotificationConfig()
    for node in root:
        kind = _strip(node.tag)
        if kind not in ("QueueConfiguration", "TopicConfiguration",
                        "CloudFunctionConfiguration"):
            continue
        arn = ""
        rid = ""
        events: list[str] = []
        prefix = suffix = ""
        for child in node:
            t = _strip(child.tag)
            if t in ("Queue", "Topic", "CloudFunction"):
                arn = (child.text or "").strip()
            elif t == "Id":
                rid = (child.text or "").strip()
            elif t == "Event":
                events.extend(expand_event_pattern((child.text or "").strip()))
            elif t == "Filter":
                for fr in child.iter():
                    if _strip(fr.tag) == "FilterRule":
                        name = value = ""
                        for kv in fr:
                            if _strip(kv.tag) == "Name":
                                name = (kv.text or "").strip().lower()
                            elif _strip(kv.tag) == "Value":
                                value = kv.text or ""
                        if name == "prefix":
                            prefix = value
                        elif name == "suffix":
                            suffix = value
        if not arn or not events:
            raise ValueError("notification config needs ARN and Event")
        cfg.rules.append(Rule(arn=arn, events=events, prefix=prefix,
                              suffix=suffix, id=rid))
    return cfg
