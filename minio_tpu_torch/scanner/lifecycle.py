"""ILM lifecycle configuration: parse + evaluate (counterpart of
minio_tpu/scanner/lifecycle.py).

Role-equivalent of pkg/bucket/lifecycle (lifecycle.go Eval/ComputeAction):
rules with prefix/tag filters; supported actions — Expiration (Days/Date,
ExpiredObjectDeleteMarker), NoncurrentVersionExpiration,
AbortIncompleteMultipartUpload, and Transition: StorageClass names a
tier registered in scanner/tiers.py and the scanner moves eligible
versions' data to that tier backend (reads pass through transparently;
RestoreObject pulls data back).
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

# Actions (pkg/bucket/lifecycle/lifecycle.go:35-48)
NONE = "none"
DELETE = "delete"                     # expire the (latest) version
DELETE_VERSION = "delete-version"     # expire one noncurrent version
DELETE_MARKER = "delete-marker"       # remove an expired delete marker
TRANSITION = "transition"             # move data to a colder tier
ABORT_MPU = "abort-mpu"

_DAY = 86400.0


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def _text(node, name: str, default: str = "") -> str:
    for child in node:
        if _strip(child.tag) == name:
            return (child.text or "").strip()
    return default


def _child(node, name: str):
    for child in node:
        if _strip(child.tag) == name:
            return child
    return None


@dataclass
class Rule:
    id: str = ""
    status: str = "Enabled"
    prefix: str = ""
    tags: dict[str, str] = field(default_factory=dict)
    expiration_days: int = 0
    expiration_date: float = 0.0
    expired_object_delete_marker: bool = False
    noncurrent_days: int = 0
    abort_mpu_days: int = 0
    transition_days: int = 0          # StorageClass names a tier (tiers.py)
    transition_storage_class: str = ""

    @property
    def enabled(self) -> bool:
        return self.status == "Enabled"

    def matches(self, key: str, tags: dict[str, str] | None = None) -> bool:
        if not key.startswith(self.prefix):
            return False
        if self.tags:
            have = tags or {}
            return all(have.get(k) == v for k, v in self.tags.items())
        return True


@dataclass
class Lifecycle:
    rules: list[Rule] = field(default_factory=list)

    def eval(self, key: str, mod_time: float, *, is_latest: bool = True,
             delete_marker: bool = False, num_versions: int = 1,
             successor_mod_time: float = 0.0,
             tags: dict[str, str] | None = None,
             transitioned: bool = False,
             now: float | None = None) -> str:
        """Compute the due action for one object version
        (lifecycle.go ComputeAction). Expiry outranks transition; an
        already-transitioned version never re-transitions."""
        now = now if now is not None else datetime.datetime.now(
            datetime.timezone.utc).timestamp()
        due_transition = False
        for r in self.rules:
            if not r.enabled or not r.matches(key, tags):
                continue
            if not is_latest:
                # Noncurrent: age counts from when it *became* noncurrent
                # (successor's mod time), lifecycle.go:338.
                since = successor_mod_time or mod_time
                if r.noncurrent_days and now - since >= r.noncurrent_days * _DAY:
                    return DELETE_VERSION
                continue
            if delete_marker:
                # A delete marker with no other versions is expired debris.
                if r.expired_object_delete_marker and num_versions == 1:
                    return DELETE_MARKER
                continue
            if r.expiration_date and now >= r.expiration_date:
                return DELETE
            if r.expiration_days and now - mod_time >= r.expiration_days * _DAY:
                return DELETE
            if (r.transition_days and r.transition_storage_class
                    and not transitioned
                    and now - mod_time >= r.transition_days * _DAY):
                due_transition = True
        return TRANSITION if due_transition else NONE

    def transition_tier(self, key: str, mod_time: float,
                        tags: dict[str, str] | None = None,
                        now: float | None = None) -> str:
        """Tier (StorageClass) named by the first matching transition rule
        that is actually DUE — a matching-but-not-yet-due rule must not
        move the object early."""
        now = now if now is not None else datetime.datetime.now(
            datetime.timezone.utc).timestamp()
        for r in self.rules:
            if (r.enabled and r.matches(key, tags)
                    and r.transition_days and r.transition_storage_class
                    and now - mod_time >= r.transition_days * _DAY):
                return r.transition_storage_class
        return ""

    def mpu_expired(self, initiated: float, now: float | None = None) -> bool:
        now = now if now is not None else datetime.datetime.now(
            datetime.timezone.utc).timestamp()
        for r in self.rules:
            if r.enabled and r.abort_mpu_days and \
                    now - initiated >= r.abort_mpu_days * _DAY:
                return True
        return False

    @property
    def has_active_rules(self) -> bool:
        return any(r.enabled for r in self.rules)


def parse_lifecycle_xml(body: bytes) -> Lifecycle:
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise ValueError(f"malformed lifecycle XML: {e}") from None
    lc = Lifecycle()
    for node in root:
        if _strip(node.tag) != "Rule":
            continue
        r = Rule(id=_text(node, "ID"),
                 status=_text(node, "Status", "Enabled"))
        # Filter: <Prefix> directly, or inside <Filter> (possibly <And>).
        r.prefix = _text(node, "Prefix")
        flt = _child(node, "Filter")
        if flt is not None:
            r.prefix = _text(flt, "Prefix", r.prefix)
            and_node = _child(flt, "And")
            scan = and_node if and_node is not None else flt
            r.prefix = _text(scan, "Prefix", r.prefix)
            for tag_node in scan:
                if _strip(tag_node.tag) == "Tag":
                    r.tags[_text(tag_node, "Key")] = _text(tag_node, "Value")
        exp = _child(node, "Expiration")
        if exp is not None:
            days = _text(exp, "Days")
            r.expiration_days = int(days) if days else 0
            date = _text(exp, "Date")
            if date:
                r.expiration_date = datetime.datetime.fromisoformat(
                    date.replace("Z", "+00:00")).timestamp()
            r.expired_object_delete_marker = (
                _text(exp, "ExpiredObjectDeleteMarker").lower() == "true")
        nce = _child(node, "NoncurrentVersionExpiration")
        if nce is not None:
            days = _text(nce, "NoncurrentDays")
            r.noncurrent_days = int(days) if days else 0
        mpu = _child(node, "AbortIncompleteMultipartUpload")
        if mpu is not None:
            days = _text(mpu, "DaysAfterInitiation")
            r.abort_mpu_days = int(days) if days else 0
        tr = _child(node, "Transition")
        if tr is not None:
            days = _text(tr, "Days")
            r.transition_days = int(days) if days else 0
            r.transition_storage_class = _text(tr, "StorageClass")
        if not (r.expiration_days or r.expiration_date
                or r.expired_object_delete_marker or r.noncurrent_days
                or r.abort_mpu_days or r.transition_days):
            raise ValueError(f"lifecycle rule {r.id!r} has no action")
        lc.rules.append(r)
    if not lc.rules:
        raise ValueError("lifecycle configuration has no rules")
    return lc
