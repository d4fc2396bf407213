"""AWS-style policy documents: parse + evaluate (the port's copy of
minio_tpu/iam/policy.py).

Role-equivalent of pkg/iam/policy (identity policies) and
pkg/bucket/policy (resource policies) — one model serves both: bucket
policies carry Principal, identity policies don't.

Evaluation semantics (AWS): explicit Deny wins; else any matching Allow
grants; else implicit deny. Actions and resources match with * and ?
wildcards; a practical subset of condition operators is supported.
"""

from __future__ import annotations

import fnmatch
import functools
import json
from dataclasses import dataclass, field

from minio_tpu_torch.iam.condition import (
    Conditions,
    normalize_values,
    parse_conditions,
)
from minio_tpu_torch.utils import errors as se

# Canned policies (pkg/iam/policy/*-canned-policy definitions).
CANNED_POLICIES: dict[str, str] = {
    "readonly": json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow",
                       "Action": ["s3:GetBucketLocation", "s3:GetObject"],
                       "Resource": ["arn:aws:s3:::*"]}]}),
    "writeonly": json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow",
                       "Action": ["s3:PutObject"],
                       "Resource": ["arn:aws:s3:::*"]}]}),
    "readwrite": json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Action": ["s3:*"],
                       "Resource": ["arn:aws:s3:::*"]}]}),
    "diagnostics": json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow",
                       "Action": ["admin:ServerInfo", "admin:ServerTrace",
                                  "admin:Profiling", "admin:Prometheus"],
                       "Resource": ["arn:aws:s3:::*"]}]}),
    "consoleAdmin": json.dumps({
        "Version": "2012-10-17",
        "Statement": [{"Effect": "Allow", "Action": ["s3:*", "admin:*"],
                       "Resource": ["arn:aws:s3:::*"]}]}),
}


@dataclass
class PolicyArgs:
    """One authorization question (pkg/iam/policy/args.go)."""

    action: str                      # e.g. "s3:GetObject"
    bucket: str = ""
    object: str = ""
    is_owner: bool = False
    account: str = ""                # requesting access key
    conditions: dict[str, list[str]] = field(default_factory=dict)

    def __post_init__(self):
        # Normalize the condition context once per authorization
        # question (lowercase keys, str-list values) — evaluation visits
        # many statements per request and must not re-copy the dict in
        # each.
        if self.conditions:
            self.conditions = normalize_values(self.conditions)

    @property
    def resource(self) -> str:
        return f"{self.bucket}/{self.object}" if self.object else self.bucket


def _as_list(v) -> list:
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def _match(pattern: str, value: str) -> bool:
    """AWS wildcard match: * and ? only — translate to fnmatch while
    escaping fnmatch's [] character-class syntax."""
    pattern = pattern.replace("[", "[[]")
    return fnmatch.fnmatchcase(value, pattern)


@dataclass
class Statement:
    effect: str                          # Allow | Deny
    actions: list[str]
    not_actions: list[str]
    resources: list[str]
    conditions: dict[str, dict[str, list[str]]]
    principals: list[str] | None         # None = identity policy (no field)
    # Compiled Condition block (iam/condition.py). Lenient compilation at
    # parse time: a stored document with a condition this build can't
    # evaluate gets an unevaluable marker, which evaluates fail-closed
    # (Deny applies, Allow doesn't). validate() re-parses strict.
    cond: Conditions | None = None

    def matches_principal(self, account: str) -> bool:
        if self.principals is None:
            return True
        return any(p == "*" or p == account for p in self.principals)

    def matches_action(self, action: str) -> bool:
        if self.not_actions:
            return not any(_match(p, action) for p in self.not_actions)
        return any(_match(p, action) for p in self.actions)

    # Read-only bucket actions a console-style object policy ("bkt/*")
    # implicitly needs. Mutating bucket actions (DeleteBucket,
    # PutBucketPolicy, ...) require the bucket ARN itself — an object-only
    # Allow must not escalate to them (AWS/reference semantics,
    # pkg/bucket/policy resource matching).
    _LIST_ONLY_ACTIONS = frozenset({
        "s3:ListBucket", "s3:ListBucketVersions",
        "s3:ListBucketMultipartUploads", "s3:GetBucketLocation",
    })

    def matches_resource(self, resource: str, action: str = "") -> bool:
        if not self.resources:
            return True
        for r in self.resources:
            pat = r[len("arn:aws:s3:::"):] if r.startswith("arn:aws:s3:::") else r
            if _match(pat, resource) or pat == "*":
                return True
            # An object pattern "bkt/*" also covers the bare bucket arn,
            # but only for read-only listing actions (ListBucket's resource
            # is the bucket arn) — never for mutating bucket-level actions.
            if (pat.endswith("/*") and _match(pat[:-2], resource)
                    and action in self._LIST_ONLY_ACTIONS):
                return True
        return False

    def matches_conditions(self, have: dict[str, list[str]]) -> bool:
        """`have` is a PolicyArgs-normalized context (lowercase keys,
        str-list values — see PolicyArgs.__post_init__)."""
        cond = self.cond
        if cond is None:  # hand-built Statement: compile on first use
            cond = self.cond = parse_conditions(self.conditions)
        if not cond:
            return True
        return cond.evaluate(have, deny=self.effect == "Deny")

    def applies(self, args: PolicyArgs) -> bool:
        return (self.matches_principal(args.account)
                and self.matches_action(args.action)
                and self.matches_resource(args.resource, args.action)
                and self.matches_conditions(args.conditions))


class Policy:
    def __init__(self, statements: list[Statement], version: str = ""):
        self.statements = statements
        self.version = version

    @classmethod
    def parse_cached(cls, raw: bytes | str) -> "Policy":
        """parse() behind a small LRU — bucket policies are evaluated per
        request (and per key on bulk delete); the parsed form is immutable
        so re-parsing identical JSON is pure waste."""
        return _parse_cached(bytes(raw) if isinstance(raw, (bytes, bytearray))
                             else raw.encode())

    @classmethod
    def parse(cls, raw: bytes | str) -> "Policy":
        try:
            doc = json.loads(raw)
        except (ValueError, TypeError) as e:
            raise se.MalformedPolicy(str(e)) from e
        stmts = []
        for s in _as_list(doc.get("Statement")):
            principals = None
            if "Principal" in s:
                p = s["Principal"]
                if p == "*":
                    principals = ["*"]
                elif isinstance(p, dict):
                    principals = [str(x) for x in _as_list(p.get("AWS"))]
                else:
                    principals = [str(p)]
            effect = s.get("Effect", "")
            if effect not in ("Allow", "Deny"):
                raise se.MalformedPolicy(f"bad Effect {effect!r}")
            raw_cond = s.get("Condition", {}) or {}
            stmts.append(Statement(
                effect=effect,
                actions=[str(a) for a in _as_list(s.get("Action"))],
                not_actions=[str(a) for a in _as_list(s.get("NotAction"))],
                resources=[str(r) for r in _as_list(s.get("Resource"))],
                conditions=raw_cond,
                principals=principals,
                cond=parse_conditions(raw_cond),
            ))
        return cls(stmts, version=doc.get("Version", ""))

    def is_allowed(self, args: PolicyArgs) -> bool:
        """Deny wins; any Allow grants; default deny
        (pkg/iam/policy/policy.go IsAllowed)."""
        allowed = False
        for s in self.statements:
            if not s.applies(args):
                continue
            if s.effect == "Deny":
                return False
            allowed = True
        return allowed

    def is_empty(self) -> bool:
        return not self.statements

    def validate(self) -> None:
        """Put-time validation (PutBucketPolicy / set_policy / session
        policies): beyond shape checks, conditions re-parse strict so an
        operator or key this build can't evaluate is rejected with
        MalformedPolicy instead of being stored and skipped — the
        reference's unmarshal-time rejection (pkg/bucket/policy/
        condition UnmarshalJSON)."""
        for s in self.statements:
            if not s.actions and not s.not_actions:
                raise se.MalformedPolicy("statement without Action")
            parse_conditions(s.conditions, strict=True)


@functools.lru_cache(maxsize=256)
def _parse_cached(raw: bytes) -> "Policy":
    return Policy.parse(raw)


def merge_is_allowed(policies: list[Policy], args: PolicyArgs) -> bool:
    """Union of Allows, any Deny wins — evaluation over a set of attached
    policies behaves like one concatenated document."""
    allowed = False
    for p in policies:
        for s in p.statements:
            if not s.applies(args):
                continue
            if s.effect == "Deny":
                return False
            allowed = True
    return allowed
