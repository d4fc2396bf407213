"""LDAP identity federation — AssumeRoleWithLDAPIdentity (the port's
copy of minio_tpu/iam/ldap.py).

Role-equivalent of cmd/sts-handlers.go AssumeRoleWithLDAPIdentity + the
pkg/iam/ldap validator: a client posts an LDAP username/password, the
server authenticates them against the directory, and temporary S3
credentials come back with the configured policies.

No LDAP library ships in this image, so this speaks LDAPv3 simple bind
directly (RFC 4511 BindRequest/BindResponse over BER) — authentication
only; group-search-based policy mapping is configured statically via the
identity_ldap subsystem (the reference's group queries need a full search
stack; the policy seam is the same).
"""

from __future__ import annotations

import socket


class LDAPError(Exception):
    pass


# -- minimal BER ---------------------------------------------------------


def _ber_len(n: int) -> bytes:
    if n < 0x80:
        return bytes([n])
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(raw)]) + raw


def _ber(tag: int, payload: bytes) -> bytes:
    return bytes([tag]) + _ber_len(len(payload)) + payload


def _ber_int(v: int) -> bytes:
    raw = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big", signed=True)
    return _ber(0x02, raw)


def _parse_tlv(buf: bytes, pos: int) -> tuple[int, bytes, int]:
    """-> (tag, payload, next_pos)"""
    tag = buf[pos]
    ln = buf[pos + 1]
    pos += 2
    if ln & 0x80:
        n = ln & 0x7F
        ln = int.from_bytes(buf[pos:pos + n], "big")
        pos += n
    return tag, buf[pos:pos + ln], pos + ln


# -- the bind ------------------------------------------------------------


def _recv_message(s: socket.socket) -> bytes:
    """Read one complete BER TLV (TCP may deliver it in pieces)."""
    buf = b""
    while True:
        chunk = s.recv(4096)
        if not chunk:
            raise LDAPError("connection closed mid-response")
        buf += chunk
        if len(buf) < 2:
            continue
        ln = buf[1]
        hdr = 2
        if ln & 0x80:
            n = ln & 0x7F
            if len(buf) < 2 + n:
                continue
            ln = int.from_bytes(buf[2:2 + n], "big")
            hdr = 2 + n
        if len(buf) >= hdr + ln:
            return buf


def simple_bind(address: str, dn: str, password: str,
                timeout: float = 10.0, use_tls: bool = True,
                tls_skip_verify: bool = False) -> None:
    """LDAPv3 simple bind; raises LDAPError on refusal/protocol trouble.

    An empty password is rejected client-side — RFC 4513 treats it as an
    UNAUTHENTICATED bind that servers may 'succeed', a classic auth bypass.
    TLS (LDAPS) is the default: simple bind sends the directory password
    on the wire, so plaintext must be an explicit opt-out (the reference
    requires TLS for LDAP likewise).
    """
    if not password:
        raise LDAPError("empty password (unauthenticated bind refused)")
    addr = address
    # A URL scheme governs the transport (as the reference treats ldap
    # addresses): ldaps:// forces TLS, ldap:// is explicit plaintext —
    # either overrides the config flag so 'ldaps://… + tls=off' can never
    # leak the directory password in cleartext.
    if addr.startswith("ldaps://"):
        addr, use_tls = addr[len("ldaps://"):], True
    elif addr.startswith("ldap://"):
        addr, use_tls = addr[len("ldap://"):], False
    if addr.startswith("["):          # IPv6 literal [::1]:636
        host, _, rest = addr[1:].partition("]")
        port = rest.lstrip(":")
    else:
        host, sep, port = addr.rpartition(":")
        if not sep:
            host, port = addr, ""
    try:
        port_n = int(port) if port else (636 if use_tls else 389)
    except ValueError:
        raise LDAPError(f"bad LDAP address {address!r}") from None
    bind_op = _ber(0x60,                       # [APPLICATION 0] BindRequest
                   _ber_int(3)                 # version
                   + _ber(0x04, dn.encode())   # name
                   + _ber(0x80, password.encode()))  # simple auth
    msg = _ber(0x30, _ber_int(1) + bind_op)
    try:
        with socket.create_connection((host or "127.0.0.1", port_n),
                                      timeout=timeout) as raw:
            if use_tls:
                import ssl

                ctx = ssl.create_default_context()
                if tls_skip_verify:
                    ctx.check_hostname = False
                    ctx.verify_mode = ssl.CERT_NONE
                s = ctx.wrap_socket(raw, server_hostname=host or "127.0.0.1")
            else:
                s = raw
            s.sendall(msg)
            resp = _recv_message(s)
    except OSError as e:
        raise LDAPError(f"ldap {address}: {e}") from e
    try:
        tag, body, _ = _parse_tlv(resp, 0)
        if tag != 0x30:
            raise ValueError("not an LDAPMessage")
        _t, _msgid, pos = _parse_tlv(body, 0)
        op_tag, op_body, _ = _parse_tlv(body, pos)
        if op_tag != 0x61:                     # BindResponse
            raise ValueError(f"unexpected op {op_tag:#x}")
        rc_tag, rc, _ = _parse_tlv(op_body, 0)
        if rc_tag != 0x0A:
            raise ValueError("missing resultCode")
        code = int.from_bytes(rc, "big")
    except (ValueError, IndexError) as e:
        raise LDAPError(f"malformed bind response: {e}") from None
    if code != 0:
        raise LDAPError(f"bind refused (resultCode {code})")


class LDAPValidator:
    """identity_ldap-config-driven authenticator."""

    def __init__(self, address: str, user_dn_format: str,
                 policies: list[str], use_tls: bool = True,
                 tls_skip_verify: bool = False):
        self.address = address
        self.user_dn_format = user_dn_format
        self.policies = policies
        self.use_tls = use_tls
        self.tls_skip_verify = tls_skip_verify

    @classmethod
    def from_config(cls, cfg) -> "LDAPValidator | None":
        if (cfg.get("identity_ldap", "enable") or "") not in ("on", "1", "true"):
            return None
        addr = cfg.get("identity_ldap", "server_addr") or ""
        fmt = cfg.get("identity_ldap", "user_dn_format") or ""
        if not addr:
            raise LDAPError("identity_ldap enabled but server_addr is empty")
        # Exactly one %s and no other % directives: the DN is built by
        # substitution, and a stray % must be a config error surfaced to
        # the operator, not a silent 'not configured'.
        if fmt.count("%") != 1 or "%s" not in fmt:
            raise LDAPError(
                "identity_ldap.user_dn_format must contain exactly one %s "
                f"(got {fmt!r})")
        pols = [p.strip() for p in
                (cfg.get("identity_ldap", "sts_policy") or "").split(",")
                if p.strip()]
        return cls(addr, fmt, pols,
                   use_tls=(cfg.get("identity_ldap", "tls") or "on")
                   not in ("off", "0", "false"),
                   tls_skip_verify=(cfg.get("identity_ldap",
                                            "tls_skip_verify") or "")
                   in ("on", "1", "true"))

    def authenticate(self, username: str, password: str) -> str:
        """-> the bound DN. Raises LDAPError on refusal."""
        if any(c in username for c in ",=+<>#;\\\"\r\n\0"):
            raise LDAPError("invalid characters in LDAP username")
        dn = self.user_dn_format.replace("%s", username)
        simple_bind(self.address, dn, password, use_tls=self.use_tls,
                    tls_skip_verify=self.tls_skip_verify)
        return dn
