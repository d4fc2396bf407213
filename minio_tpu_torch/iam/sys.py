"""IAMSys — identities, credential lookup, and request authorization (the
port's copy of minio_tpu/iam/sys.py).

Role-equivalent of cmd/iam.go:204 (IAMSys) with the object-store
persistence backend (cmd/iam-object-store.go): users, groups, named
policies, service accounts and STS temp credentials live as documents in
the sys store under iam/ (one JSON document per entity, sealed under the
root secret by crypto/configcrypt.py, the JAX package's layout, so each
package loads the other's store), loaded into memory at boot.
"""

from __future__ import annotations

import base64
import hmac
import json
import logging
import secrets as pysecrets
import threading
import time
from dataclasses import dataclass, field

from minio_tpu_torch.crypto.configcrypt import ConfigCryptError
from minio_tpu_torch.iam.policy import (
    CANNED_POLICIES,
    Policy,
    PolicyArgs,
    merge_is_allowed,
)
from minio_tpu_torch.utils import errors as se

log = logging.getLogger("minio_tpu_torch.iam")

ACCOUNT_ON = "on"
ACCOUNT_OFF = "off"


@dataclass
class Identity:
    """Resolved requester identity, attached to every request after auth."""

    access_key: str
    kind: str              # root | user | svc | sts | anonymous
    parent: str = ""       # owning user for svc/sts
    policies: list[str] = field(default_factory=list)
    session_policy: Policy | None = None
    claims: dict = field(default_factory=dict)

    @property
    def is_owner(self) -> bool:
        return self.kind == "root"


ANONYMOUS = Identity(access_key="", kind="anonymous")


@dataclass
class UserInfo:
    secret_key: str
    status: str = ACCOUNT_ON
    policies: list[str] = field(default_factory=list)


@dataclass
class GroupInfo:
    members: list[str] = field(default_factory=list)
    policies: list[str] = field(default_factory=list)
    status: str = ACCOUNT_ON


@dataclass
class TempCredential:
    access_key: str
    secret_key: str
    session_token: str
    parent: str
    expiry: float
    session_policy_json: str = ""
    kind: str = "sts"         # sts | svc (service accounts don't expire)
    # Federated (OIDC) credentials have no parent account; their policies
    # come from the token's policy claim (cmd/sts-handlers.go WebIdentity).
    policies: list[str] = field(default_factory=list)
    subject: str = ""         # IdP subject, for audit
    # Namespaced token claims ("jwt:sub", "ldap:username", ...) — the
    # request-condition plane exposes these so session/identity policies
    # can scope by claim (cmd/iam.go GetClaimsForPolicy role).
    claims: dict = field(default_factory=dict)

    @property
    def expired(self) -> bool:
        return self.kind == "sts" and time.time() >= self.expiry


def _gen_access_key() -> str:
    return "MTPU" + pysecrets.token_hex(8).upper()


def _gen_secret_key() -> str:
    return base64.b64encode(pysecrets.token_bytes(30)).decode()[:40]


class IAMSys:
    """All identity state + the single authorization entry point."""

    def __init__(self, root_access_key: str, root_secret_key: str, store=None,
                 notify=None):
        """store: sys-config store (read/write/delete/list_sys_config) or
        None for memory-only; notify: callable() fanning a change out to
        the peers of a cluster, whose reload() re-reads the store."""
        self._notify = notify
        self.root_access_key = root_access_key
        self.root_secret_key = root_secret_key
        self._store = store
        self._mu = threading.RLock()
        self.users: dict[str, UserInfo] = {}
        self.groups: dict[str, GroupInfo] = {}
        self.policies: dict[str, str] = dict(CANNED_POLICIES)
        self.temp_creds: dict[str, TempCredential] = {}
        if store is not None:
            self.load()

    # ------------------------------------------------------------------
    # persistence (cmd/iam-object-store.go layout: one doc per entity)
    # ------------------------------------------------------------------

    def load(self) -> None:
        crypt_failures: list[Exception] = []
        sealed_ok = 0
        read2 = getattr(self._store, "read_sys_config2", None)
        with self._mu:
            for key in self._safe_list("iam/"):
                try:
                    if read2 is not None:
                        raw, was_sealed = read2(f"iam/{key}")
                    else:
                        raw = self._store.read_sys_config(f"iam/{key}")
                        was_sealed = False
                    # A sealed entry that decrypts proves the credential,
                    # even if its JSON is then found corrupt.
                    sealed_ok += 1 if was_sealed else 0
                    doc = json.loads(raw)
                except ConfigCryptError as e:
                    # Could be one bit-rotted entry (skip it, like any
                    # corrupt doc) or the wrong root credential (every
                    # sealed entry fails). Decide after the loop: booting
                    # with silently-empty IAM on a wrong credential is
                    # the disaster case.
                    log.warning("IAM entry %r failed to decrypt: %s",
                                key, e)
                    crypt_failures.append(e)
                    continue
                except Exception:  # noqa: BLE001 - skip corrupt entries
                    continue
                kind, _, name = key.partition("/")
                if kind == "users":
                    self.users[name] = UserInfo(**doc)
                elif kind == "groups":
                    self.groups[name] = GroupInfo(**doc)
                elif kind == "policies":
                    self.policies[name] = doc["policy"]
                elif kind == "creds":
                    tc = TempCredential(**doc)
                    if not tc.expired:
                        self.temp_creds[name] = tc
        if crypt_failures and sealed_ok == 0:
            # Every SEALED entry failed to decrypt (plaintext pre-migration
            # entries don't count as evidence the credential is right):
            # that's a wrong root credential, not bitrot — refuse to boot
            # with silently-partial IAM.
            raise crypt_failures[0]

    def _safe_list(self, prefix: str) -> list[str]:
        try:
            return [k[len(prefix):] for k in
                    self._store.list_sys_config(prefix.rstrip("/"))
                    if k.startswith(prefix)]
        except Exception:  # noqa: BLE001
            return []

    def _persist(self, key: str, doc: dict | None) -> None:
        if self._store is None:
            return
        if doc is None:
            try:
                self._store.delete_sys_config(f"iam/{key}")
            except se.FileNotFound:
                pass
        else:
            self._store.write_sys_config(
                f"iam/{key}", json.dumps(doc).encode())
        if self._notify is not None:
            self._notify()

    def reload(self) -> None:
        """Re-read every entry from the store (the peer plane's target,
        PeerHooks.on_iam_reload)."""
        if self._store is None:
            return
        with self._mu:
            self.users.clear()
            self.groups.clear()
            self.policies = dict(CANNED_POLICIES)
            self.temp_creds.clear()
            self.load()

    # ------------------------------------------------------------------
    # credential resolution (cmd/auth-handler.go checkKeyValid role)
    # ------------------------------------------------------------------

    def get_secret(self, access_key: str) -> str:
        """Secret for signature verification. Raises InvalidAccessKey."""
        with self._mu:
            if access_key == self.root_access_key:
                return self.root_secret_key
            u = self.users.get(access_key)
            if u is not None and u.status == ACCOUNT_ON:
                return u.secret_key
            tc = self.temp_creds.get(access_key)
            if tc is not None and not tc.expired:
                return tc.secret_key
        raise se.InvalidAccessKey(access_key)

    def identify(self, access_key: str) -> Identity:
        with self._mu:
            if access_key == self.root_access_key:
                return Identity(access_key, "root")
            u = self.users.get(access_key)
            if u is not None:
                pols = list(u.policies)
                for g in self.groups.values():
                    if access_key in g.members and g.status == ACCOUNT_ON:
                        pols.extend(g.policies)
                return Identity(access_key, "user", policies=pols)
            tc = self.temp_creds.get(access_key)
            if tc is not None and not tc.expired:
                sp = (Policy.parse(tc.session_policy_json)
                      if tc.session_policy_json else None)
                if not tc.parent:  # federated: claim-mapped policies
                    return Identity(access_key, tc.kind,
                                    policies=list(tc.policies),
                                    session_policy=sp,
                                    claims={"sub": tc.subject,
                                            **tc.claims})
                parent_id = (self.identify(tc.parent)
                             if tc.parent != access_key else None)
                return Identity(
                    access_key, tc.kind, parent=tc.parent,
                    policies=parent_id.policies if parent_id else [],
                    session_policy=sp, claims=dict(tc.claims))
        raise se.InvalidAccessKey(access_key)

    def verify_session_token(self, access_key: str, token: str) -> bool:
        with self._mu:
            tc = self.temp_creds.get(access_key)
        return tc is not None and not tc.expired and hmac.compare_digest(
            tc.session_token, token)

    # ------------------------------------------------------------------
    # authorization (cmd/iam.go IsAllowed)
    # ------------------------------------------------------------------

    def is_allowed(self, ident: Identity, args: PolicyArgs) -> bool:
        args.account = ident.access_key
        args.is_owner = ident.is_owner
        if ident.kind == "root":
            return True
        if ident.kind == "anonymous":
            return False  # anonymous is granted only by bucket policy
        if ident.kind in ("svc", "sts"):
            # Parent must allow it; session policy (if any) further
            # restricts (cmd/iam.go IsAllowedSTS).
            parent_ok = (ident.parent == self.root_access_key
                         or self._policies_allow(ident.policies, args))
            if not parent_ok:
                return False
            if ident.session_policy is not None:
                return ident.session_policy.is_allowed(args)
            return True
        return self._policies_allow(ident.policies, args)

    def _policies_allow(self, names: list[str], args: PolicyArgs) -> bool:
        with self._mu:
            docs = [self.policies[n] for n in dict.fromkeys(names)
                    if n in self.policies]
        return merge_is_allowed([Policy.parse_cached(d) for d in docs], args)

    # ------------------------------------------------------------------
    # admin CRUD (cmd/admin-handlers-users.go surface)
    # ------------------------------------------------------------------

    def set_user(self, access_key: str, secret_key: str,
                 status: str = ACCOUNT_ON) -> None:
        if access_key == self.root_access_key:
            raise se.IAMActionNotAllowed("cannot override root")
        with self._mu:
            existing = self.users.get(access_key)
            pols = existing.policies if existing else []
            self.users[access_key] = UserInfo(secret_key, status, pols)
            self._persist(f"users/{access_key}",
                          vars(self.users[access_key]))

    def delete_user(self, access_key: str) -> None:
        with self._mu:
            if self.users.pop(access_key, None) is None:
                raise se.NoSuchUser(access_key)
            self._persist(f"users/{access_key}", None)
            # Cascade: drop the user's temp/service credentials.
            for ak, tc in list(self.temp_creds.items()):
                if tc.parent == access_key:
                    del self.temp_creds[ak]
                    self._persist(f"creds/{ak}", None)

    def list_users(self) -> dict[str, UserInfo]:
        with self._mu:
            return dict(self.users)

    def set_user_status(self, access_key: str, status: str) -> None:
        with self._mu:
            u = self.users.get(access_key)
            if u is None:
                raise se.NoSuchUser(access_key)
            u.status = status
            self._persist(f"users/{access_key}", vars(u))

    def set_policy(self, name: str, policy_json: str) -> None:
        Policy.parse(policy_json).validate()
        with self._mu:
            self.policies[name] = policy_json
            self._persist(f"policies/{name}", {"policy": policy_json})

    def delete_policy(self, name: str) -> None:
        with self._mu:
            if name in CANNED_POLICIES:
                raise se.IAMActionNotAllowed(f"{name} is built-in")
            if self.policies.pop(name, None) is None:
                raise se.NoSuchPolicy(name)
            self._persist(f"policies/{name}", None)

    def attach_policy(self, user_or_group: str, names: list[str],
                      group: bool = False) -> None:
        with self._mu:
            for n in names:
                if n not in self.policies:
                    raise se.NoSuchPolicy(n)
            if group:
                g = self.groups.get(user_or_group)
                if g is None:
                    raise se.NoSuchGroup(user_or_group)
                g.policies = names
                self._persist(f"groups/{user_or_group}", vars(g))
            else:
                u = self.users.get(user_or_group)
                if u is None:
                    raise se.NoSuchUser(user_or_group)
                u.policies = names
                self._persist(f"users/{user_or_group}", vars(u))

    def add_group_members(self, group: str, members: list[str]) -> None:
        with self._mu:
            g = self.groups.setdefault(group, GroupInfo())
            for m in members:
                if m not in self.users:
                    raise se.NoSuchUser(m)
                if m not in g.members:
                    g.members.append(m)
            self._persist(f"groups/{group}", vars(g))

    def remove_group_members(self, group: str, members: list[str]) -> None:
        with self._mu:
            g = self.groups.get(group)
            if g is None:
                raise se.NoSuchGroup(group)
            if not members:  # empty removal deletes an empty group
                if g.members:
                    raise se.IAMActionNotAllowed("group not empty")
                del self.groups[group]
                self._persist(f"groups/{group}", None)
                return
            g.members = [m for m in g.members if m not in members]
            self._persist(f"groups/{group}", vars(g))

    # ------------------------------------------------------------------
    # STS + service accounts (cmd/sts-handlers.go AssumeRole)
    # ------------------------------------------------------------------

    def assume_role(self, parent_access_key: str, duration: int = 3600,
                    session_policy_json: str = "") -> TempCredential:
        if session_policy_json:
            # Full validation, not just parse: a session policy with an
            # unsupported condition must be rejected here, at issue time
            # (the request-condition plane's fail-closed contract).
            Policy.parse(session_policy_json).validate()
        duration = max(900, min(duration, 7 * 24 * 3600))
        tc = TempCredential(
            access_key=_gen_access_key(),
            secret_key=_gen_secret_key(),
            session_token=base64.b64encode(
                pysecrets.token_bytes(24)).decode(),
            parent=parent_access_key,
            expiry=time.time() + duration,
            session_policy_json=session_policy_json,
        )
        with self._mu:
            self.temp_creds[tc.access_key] = tc
            self._persist(f"creds/{tc.access_key}", vars(tc))
        return tc

    def assume_role_with_claims(self, subject: str, policies: list[str],
                                duration: int = 3600,
                                session_policy_json: str = "",
                                claims: dict | None = None) -> TempCredential:
        """Federated temp credentials from a validated IdP token
        (AssumeRoleWithWebIdentity/ClientGrants, cmd/sts-handlers.go:49-102):
        no parent account; authorization comes from the claim-mapped policy
        names, optionally narrowed by a session policy. `claims` carries
        namespaced token attributes ("jwt:sub", "ldap:username", ...) into
        the credential so condition contexts can expose them."""
        if session_policy_json:
            Policy.parse(session_policy_json).validate()
        # No 900 s floor here: the caller caps at the identity token's own
        # remaining lifetime, which may legitimately be shorter.
        duration = max(1, min(duration, 7 * 24 * 3600))
        tc = TempCredential(
            access_key=_gen_access_key(),
            secret_key=_gen_secret_key(),
            session_token=base64.b64encode(
                pysecrets.token_bytes(24)).decode(),
            parent="",
            expiry=time.time() + duration,
            session_policy_json=session_policy_json,
            policies=list(policies),
            subject=subject,
            claims=dict(claims or {}),
        )
        with self._mu:
            self.temp_creds[tc.access_key] = tc
            self._persist(f"creds/{tc.access_key}", vars(tc))
        return tc

    def add_service_account(self, parent_access_key: str,
                            session_policy_json: str = "",
                            access_key: str = "",
                            secret_key: str = "") -> TempCredential:
        if session_policy_json:
            Policy.parse(session_policy_json).validate()
        tc = TempCredential(
            access_key=access_key or _gen_access_key(),
            secret_key=secret_key or _gen_secret_key(),
            session_token="",
            parent=parent_access_key,
            expiry=0.0,
            session_policy_json=session_policy_json,
            kind="svc",
        )
        with self._mu:
            self.temp_creds[tc.access_key] = tc
            self._persist(f"creds/{tc.access_key}", vars(tc))
        return tc

    def delete_service_account(self, access_key: str) -> None:
        with self._mu:
            tc = self.temp_creds.get(access_key)
            if tc is None or tc.kind != "svc":
                raise se.NoSuchServiceAccount(access_key)
            del self.temp_creds[access_key]
            self._persist(f"creds/{access_key}", None)
