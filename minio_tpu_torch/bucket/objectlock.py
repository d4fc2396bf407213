"""Object lock: WORM retention + legal hold (the port's copy of
minio_tpu/bucket/objectlock.py).

Role-equivalent of pkg/bucket/object/lock + cmd/bucket-object-lock.go.
Retention/legal-hold live in the version's metadata under the standard
x-amz-object-lock-* keys; enforcement runs before any version-destroying
operation: COMPLIANCE blocks until expiry, GOVERNANCE yields to the
bypass header with the matching policy action, legal hold blocks
unconditionally while ON.
"""

from __future__ import annotations

import datetime
import xml.etree.ElementTree as ET

MODE_GOVERNANCE = "GOVERNANCE"
MODE_COMPLIANCE = "COMPLIANCE"

KEY_MODE = "x-amz-object-lock-mode"
KEY_UNTIL = "x-amz-object-lock-retain-until-date"
KEY_HOLD = "x-amz-object-lock-legal-hold"

_TIME_FMT = "%Y-%m-%dT%H:%M:%SZ"


def _strip(tag: str) -> str:
    return tag.split("}")[-1]


def parse_iso(ts: str) -> float:
    return datetime.datetime.fromisoformat(
        ts.replace("Z", "+00:00")).timestamp()


def to_iso(ts: float) -> str:
    return datetime.datetime.fromtimestamp(
        ts, datetime.timezone.utc).strftime(_TIME_FMT)


class WORMProtected(Exception):
    """Version is under retention/legal hold; mapped to AccessDenied."""


# --- XML payloads ------------------------------------------------------------

def parse_retention_xml(body: bytes) -> tuple[str, float]:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise ValueError("malformed retention XML") from None
    mode = until = ""
    for c in root:
        if _strip(c.tag) == "Mode":
            mode = (c.text or "").strip().upper()
        elif _strip(c.tag) == "RetainUntilDate":
            until = (c.text or "").strip()
    if mode not in (MODE_GOVERNANCE, MODE_COMPLIANCE) or not until:
        raise ValueError("retention needs Mode and RetainUntilDate")
    ts = parse_iso(until)
    return mode, ts


def retention_xml(mode: str, until: float) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<Retention xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f'<Mode>{mode}</Mode>'
            f'<RetainUntilDate>{to_iso(until)}</RetainUntilDate>'
            f'</Retention>').encode()


def parse_legal_hold_xml(body: bytes) -> str:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise ValueError("malformed legal hold XML") from None
    status = ""
    for c in root:
        if _strip(c.tag) == "Status":
            status = (c.text or "").strip().upper()
    if status not in ("ON", "OFF"):
        raise ValueError("legal hold Status must be ON or OFF")
    return status


def legal_hold_xml(status: str) -> bytes:
    return (f'<?xml version="1.0" encoding="UTF-8"?>'
            f'<LegalHold xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f'<Status>{status}</Status></LegalHold>').encode()


def parse_default_retention(object_lock_xml: bytes) -> tuple[str, float] | None:
    """(mode, seconds) from the bucket config's
    <Rule><DefaultRetention> (lock.go DefaultRetention)."""
    if not object_lock_xml:
        return None
    try:
        root = ET.fromstring(object_lock_xml)
    except ET.ParseError:
        return None
    for node in root.iter():
        if _strip(node.tag) != "DefaultRetention":
            continue
        mode = ""
        seconds = 0.0
        for c in node:
            t = _strip(c.tag)
            if t == "Mode":
                mode = (c.text or "").strip().upper()
            elif t == "Days":
                seconds = float(c.text or 0) * 86400
            elif t == "Years":
                seconds = float(c.text or 0) * 365 * 86400
        if mode and seconds:
            return mode, seconds
    return None


# --- enforcement -------------------------------------------------------------

def check_worm(metadata: dict, *, bypass_governance: bool = False,
               now: float | None = None) -> None:
    """Raise WORMProtected if this version may not be destroyed
    (enforceRetentionForDeletion, cmd/bucket-object-lock.go)."""
    if metadata.get(KEY_HOLD, "").upper() == "ON":
        raise WORMProtected("object is under legal hold")
    mode = metadata.get(KEY_MODE, "").upper()
    until = metadata.get(KEY_UNTIL, "")
    if not mode or not until:
        return
    now = now if now is not None else datetime.datetime.now(
        datetime.timezone.utc).timestamp()
    try:
        expiry = parse_iso(until)
    except ValueError:
        return
    if now >= expiry:
        return
    if mode == MODE_COMPLIANCE:
        raise WORMProtected("compliance retention until " + until)
    if mode == MODE_GOVERNANCE and not bypass_governance:
        raise WORMProtected("governance retention until " + until)
