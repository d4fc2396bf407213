"""Policy condition evaluation — the request-condition plane (the
port's copy of minio_tpu/iam/condition.py).

Role-equivalent of pkg/bucket/policy/condition (the reference's operator
registry, one file per function): a policy statement's `Condition` block
compiles here into evaluable clauses over the per-request condition
context that the S3 front door assembles (`getConditionValues` role,
cmd/bucket-policy.go:65-110).

Two properties are load-bearing:

* **Fail-closed at put time** — `parse_conditions(..., strict=True)` runs
  under `Policy.validate()` (PutBucketPolicy / PutUserPolicy / session
  policies) and rejects unknown operators, unknown keys, and values the
  operator can't parse with `MalformedPolicy`, mirroring the reference's
  unmarshal-time rejection. A condition that can't be evaluated must
  never be accepted and then silently skipped.

* **Fail-closed at evaluation** — a stored statement that still carries
  an unevaluable condition (pre-validation documents) makes a `Deny`
  statement APPLY and an `Allow` statement not apply. The seed's
  behavior ("unknown operator -> statement can't apply") let a
  conditioned Deny fail open; here the broken side always lands on deny.

Missing-key semantics follow AWS/the reference: positive operators are
false when the request context lacks the key; negated operators
(`StringNotEquals`, `NotIpAddress`, ...) are the complement and hence
true. `Null` tests key presence itself.
"""

from __future__ import annotations

import base64
import datetime
import fnmatch
import ipaddress

from minio_tpu_torch.utils import errors as se

# Condition keys the front door populates (docs/POLICY.md carries the
# user-facing table). Everything is matched lowercase: AWS condition keys
# are case-insensitive.
_EXACT_KEYS = frozenset({
    "aws:sourceip", "aws:securetransport", "aws:currenttime",
    "aws:epochtime", "aws:useragent", "aws:referer", "aws:username",
    "aws:userid", "aws:principaltype",
    "s3:prefix", "s3:delimiter", "s3:max-keys", "s3:versionid",
    "s3:authtype", "s3:signatureversion",
    "s3:object-lock-mode", "s3:object-lock-retain-until-date",
    "s3:object-lock-legal-hold",
    "s3:object-lock-remaining-retention-days",
    "s3:x-amz-acl", "s3:x-amz-copy-source", "s3:x-amz-storage-class",
    "s3:x-amz-metadata-directive", "s3:x-amz-server-side-encryption",
    "s3:x-amz-server-side-encryption-aws-kms-key-id",
    "s3:x-amz-content-sha256",
})
# Claim namespaces are open-ended: any IdP/directory attribute may ride
# in (cmd/iam.go policy variables for OIDC/LDAP claims).
_OPEN_PREFIXES = ("jwt:", "ldap:")


def _valid_key(key: str) -> bool:
    return key in _EXACT_KEYS or key.startswith(_OPEN_PREFIXES)


def _match(pattern: str, value: str) -> bool:
    """AWS wildcard match: * and ? only (fnmatch's [] escaped)."""
    return fnmatch.fnmatchcase(value, pattern.replace("[", "[[]"))


def _as_str_list(v) -> list[str]:
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [scalar_str(x) for x in v]
    return [scalar_str(v)]


def scalar_str(v) -> str:
    """Canonical condition-value spelling — shared by policy parsing and
    the claim-stamping path so both sides of an equality agree. JSON
    booleans round-trip as AWS's lowercase form, not str(True)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class NormalizedContext(dict):
    """Marker: a context already in evaluation form (lowercase keys,
    str-list values). normalize_values passes these through untouched,
    so a context built once per request isn't re-copied by every
    PolicyArgs constructed from it (bulk delete builds one per key)."""


def normalize_values(ctx: dict) -> "NormalizedContext":
    """Request context in evaluation form — idempotent and O(1) on an
    already-normalized context."""
    if isinstance(ctx, NormalizedContext):
        return ctx
    out = NormalizedContext()
    for k, vs in ctx.items():
        if vs is None:
            continue
        if not isinstance(vs, (list, tuple)):
            vs = [vs]
        out[str(k).lower()] = [scalar_str(v) for v in vs]
    return out


def _parse_number(s: str) -> float:
    return float(s)


def _parse_date(s: str) -> float:
    """ISO8601 (AWS's format) or epoch seconds -> POSIX timestamp."""
    try:
        return float(s)
    except ValueError:
        pass
    txt = s.strip()
    if txt.endswith("Z"):
        txt = txt[:-1] + "+00:00"
    dt = datetime.datetime.fromisoformat(txt)
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    return dt.timestamp()


# ---------------------------------------------------------------------------
# operator factories: validate policy values once, return evaluate(have)
# where `have` is the request's value list for the clause's key (possibly
# empty). Each factory raises ValueError on unparseable policy values.
# ---------------------------------------------------------------------------


def _f_string_equals(want):
    ws = set(want)
    return lambda have: bool(have) and all(h in ws for h in have)


def _f_string_equals_ignorecase(want):
    ws = {w.casefold() for w in want}
    return lambda have: bool(have) and all(h.casefold() in ws for h in have)


def _f_string_like(want):
    return lambda have: bool(have) and all(
        any(_match(w, h) for w in want) for h in have)


def _f_bool(want):
    ws = {w.lower() for w in want}
    if not ws <= {"true", "false"}:
        raise ValueError(f"Bool values must be true/false, got {want}")
    return lambda have: bool(have) and all(h.lower() in ws for h in have)


def _f_null(want):
    if len(want) != 1 or want[0].lower() not in ("true", "false"):
        raise ValueError(f"Null takes a single true/false, got {want}")
    absent = want[0].lower() == "true"
    return lambda have: (not have) if absent else bool(have)


def _f_binary_equals(want):
    decoded = {base64.b64decode(w, validate=True) for w in want}
    return lambda have: bool(have) and all(
        h.encode() in decoded for h in have)


def _numeric(cmp):
    def factory(want):
        wn = [_parse_number(w) for w in want]

        def evaluate(have):
            if not have:
                return False
            try:
                hn = [_parse_number(h) for h in have]
            except ValueError:
                return False
            return all(any(cmp(h, w) for w in wn) for h in hn)

        return evaluate
    return factory


def _date(cmp):
    def factory(want):
        wn = [_parse_date(w) for w in want]

        def evaluate(have):
            if not have:
                return False
            try:
                hn = [_parse_date(h) for h in have]
            except ValueError:
                return False
            return all(any(cmp(h, w) for w in wn) for h in hn)

        return evaluate
    return factory


def _f_ip_address(want):
    nets = [ipaddress.ip_network(w, strict=False) for w in want]

    def evaluate(have):
        if not have:
            return False
        for h in have:
            try:
                ip = ipaddress.ip_address(h)
            except ValueError:
                return False
            # Dual-stack listeners report IPv4 peers as ::ffff:a.b.c.d;
            # unwrap so an IPv4 CIDR Deny still fires (a version
            # mismatch silently not matching is exactly the inert-Deny
            # failure mode this subsystem exists to close).
            mapped = getattr(ip, "ipv4_mapped", None)
            if mapped is not None:
                ip = mapped
            if not any(ip.version == n.version and ip in n for n in nets):
                return False
        return True

    return evaluate


def _negate(factory):
    def neg(want):
        pos = factory(want)
        return lambda have: not pos(have)
    return neg


# The reference's ~13 operator families (pkg/bucket/policy/condition/
# *func.go, one file each). Negated forms are the complement, including
# the missing-key case.
_OPERATORS = {
    "StringEquals": _f_string_equals,
    "StringNotEquals": _negate(_f_string_equals),
    "StringEqualsIgnoreCase": _f_string_equals_ignorecase,
    "StringNotEqualsIgnoreCase": _negate(_f_string_equals_ignorecase),
    "StringLike": _f_string_like,
    "StringNotLike": _negate(_f_string_like),
    "Bool": _f_bool,
    "Null": _f_null,
    "BinaryEquals": _f_binary_equals,
    "NumericEquals": _numeric(lambda h, w: h == w),
    "NumericNotEquals": _negate(_numeric(lambda h, w: h == w)),
    "NumericLessThan": _numeric(lambda h, w: h < w),
    "NumericLessThanEquals": _numeric(lambda h, w: h <= w),
    "NumericGreaterThan": _numeric(lambda h, w: h > w),
    "NumericGreaterThanEquals": _numeric(lambda h, w: h >= w),
    "DateEquals": _date(lambda h, w: h == w),
    "DateNotEquals": _negate(_date(lambda h, w: h == w)),
    "DateLessThan": _date(lambda h, w: h < w),
    "DateLessThanEquals": _date(lambda h, w: h <= w),
    "DateGreaterThan": _date(lambda h, w: h > w),
    "DateGreaterThanEquals": _date(lambda h, w: h >= w),
    "IpAddress": _f_ip_address,
    "NotIpAddress": _negate(_f_ip_address),
}

SUPPORTED_OPERATORS = frozenset(_OPERATORS)


class Conditions:
    """A statement's compiled Condition block.

    `unevaluable` marks a block that failed lenient compilation (unknown
    operator/key or bad values in a pre-validation stored document):
    evaluation then lands on the deny side for either effect.
    """

    __slots__ = ("clauses", "unevaluable")

    def __init__(self, clauses, unevaluable: bool = False):
        self.clauses = clauses          # list of (key, evaluate)
        self.unevaluable = unevaluable

    def __bool__(self) -> bool:
        return bool(self.clauses) or self.unevaluable

    def evaluate(self, values: dict, deny: bool = False) -> bool:
        """Does this block hold for the request context `values`
        ({lowercase key: [str, ...]})? For an unevaluable block the
        answer is whatever makes the statement deny."""
        if self.unevaluable:
            return deny
        return all(fn(values.get(key, ())) for key, fn in self.clauses)


_EMPTY = Conditions([])


def parse_conditions(raw, strict: bool = False) -> Conditions:
    """Compile a statement's Condition dict.

    strict=True (policy put time) raises MalformedPolicy on anything the
    subsystem can't evaluate; strict=False (loading stored documents)
    returns an unevaluable marker instead, which `Conditions.evaluate`
    resolves fail-closed.
    """
    if not raw:
        return _EMPTY
    try:
        return _compile(raw)
    except se.MalformedPolicy:
        if strict:
            raise
        return Conditions([], unevaluable=True)


def _compile(raw) -> Conditions:
    if not isinstance(raw, dict):
        raise se.MalformedPolicy("Condition must be an object")
    clauses = []
    for op, kv in raw.items():
        factory = _OPERATORS.get(op)
        if factory is None:
            raise se.MalformedPolicy(
                f"unsupported condition operator {op!r}")
        if not isinstance(kv, dict) or not kv:
            raise se.MalformedPolicy(
                f"condition operator {op!r} needs {{key: values}}")
        for key, values in kv.items():
            lkey = str(key).lower()
            if not _valid_key(lkey):
                raise se.MalformedPolicy(
                    f"unsupported condition key {key!r}")
            want = _as_str_list(values)
            if not want:
                raise se.MalformedPolicy(
                    f"condition {op}/{key} has no values")
            try:
                fn = factory(want)
            except (ValueError, TypeError) as e:
                raise se.MalformedPolicy(
                    f"condition {op}/{key}: {e}") from None
            clauses.append((lkey, fn))
    return Conditions(clauses)
