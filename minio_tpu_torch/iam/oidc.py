"""OpenID Connect JWT validation for STS federation (the port's copy of
minio_tpu/iam/oidc.py).

Role-equivalent of cmd/sts-handlers.go AssumeRoleWithWebIdentity /
AssumeRoleWithClientGrants (:49-102) + the pkg/iam/validator JWKS
machinery: a client authenticates to an external IdP, presents the signed
JWT here, and receives temporary S3 credentials whose policies come from
the token's policy claim.

The JWKS comes from config (inline JSON or a local file path) rather than
being fetched from the IdP's URL — zero-egress deployments mount the JWKS;
the `identity_openid` config subsystem carries issuer/audience/claim name.

Supported algorithms: RS256/RS384/RS512 (via `cryptography`, imported
where a token is verified and only there: without the package an RS*
token is refused, never accepted) and HS256/HS384/HS512 (shared secret
in the JWKS as an `oct` key).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time


class OIDCError(Exception):
    pass


def _b64url(data: str | bytes) -> bytes:
    if isinstance(data, str):
        data = data.encode()
    return base64.urlsafe_b64decode(data + b"=" * (-len(data) % 4))


def _b64url_uint(s: str) -> int:
    return int.from_bytes(_b64url(s), "big")


_HASHES = {"256": hashlib.sha256, "384": hashlib.sha384, "512": hashlib.sha512}


class OpenIDValidator:
    """Validates JWTs against a configured JWKS + issuer/audience."""

    def __init__(self, jwks: dict, issuer: str = "", audience: str = "",
                 claim_name: str = "policy", leeway: float = 30.0):
        self.issuer = issuer
        self.audience = audience
        self.claim_name = claim_name or "policy"
        self.leeway = leeway
        self._keys: dict[str, dict] = {}
        for k in jwks.get("keys", []):
            self._keys[k.get("kid", "")] = k

    @classmethod
    def from_config(cls, cfg) -> "OpenIDValidator | None":
        """Build from the identity_openid config subsystem; None when the
        subsystem is disabled/unconfigured."""
        if (cfg.get("identity_openid", "enable") or "") not in ("on", "1", "true"):
            return None
        raw = cfg.get("identity_openid", "jwks") or ""
        if not raw:
            return None
        if raw.lstrip().startswith("{"):
            jwks = json.loads(raw)
        else:
            if not os.path.exists(raw):
                raise OIDCError(f"jwks file {raw!r} not found")
            jwks = json.loads(open(raw, encoding="utf-8").read())
        return cls(jwks,
                   issuer=cfg.get("identity_openid", "issuer") or "",
                   audience=cfg.get("identity_openid", "audience") or "",
                   claim_name=cfg.get("identity_openid", "claim_name")
                   or "policy")

    # -- verification --

    def _pick_key(self, kid: str) -> dict:
        if kid in self._keys:
            return self._keys[kid]
        if len(self._keys) == 1:
            return next(iter(self._keys.values()))
        raise OIDCError(f"no JWKS key for kid {kid!r}")

    def _verify_sig(self, header: dict, signing_input: bytes,
                    sig: bytes) -> None:
        alg = header.get("alg", "")
        key = self._pick_key(header.get("kid", ""))
        if alg.startswith("RS") and alg[2:] in _HASHES:
            try:
                from cryptography.hazmat.primitives import hashes as chashes
                from cryptography.hazmat.primitives.asymmetric import padding, rsa
            except ImportError:
                raise OIDCError(f"alg {alg} needs the cryptography package") from None

            if key.get("kty") != "RSA":
                raise OIDCError(f"alg {alg} needs an RSA key")
            pub = rsa.RSAPublicNumbers(
                _b64url_uint(key["e"]), _b64url_uint(key["n"])).public_key()
            h = {"256": chashes.SHA256, "384": chashes.SHA384,
                 "512": chashes.SHA512}[alg[2:]]()
            try:
                pub.verify(sig, signing_input, padding.PKCS1v15(), h)
            except Exception:  # noqa: BLE001
                raise OIDCError("signature verification failed") from None
            return
        if alg.startswith("HS") and alg[2:] in _HASHES:
            if key.get("kty") != "oct":
                raise OIDCError(f"alg {alg} needs an oct key")
            secret = _b64url(key["k"])
            want = hmac.new(secret, signing_input, _HASHES[alg[2:]]).digest()
            if not hmac.compare_digest(want, sig):
                raise OIDCError("signature verification failed")
            return
        raise OIDCError(f"unsupported alg {alg!r}")

    def validate(self, token: str) -> dict:
        """Verify signature + temporal + issuer/audience claims; returns
        the claim set."""
        try:
            h64, p64, s64 = token.split(".")
            header = json.loads(_b64url(h64))
            claims = json.loads(_b64url(p64))
            sig = _b64url(s64)
        except (ValueError, TypeError) as e:
            raise OIDCError(f"malformed JWT: {e}") from None
        self._verify_sig(header, f"{h64}.{p64}".encode(), sig)
        now = time.time()
        if "exp" not in claims:
            # An unexpiring token could mint fresh credentials forever if
            # it ever leaked — refuse it outright.
            raise OIDCError("token has no exp claim")
        if now > float(claims["exp"]) + self.leeway:
            raise OIDCError("token expired")
        if "nbf" in claims and now < float(claims["nbf"]) - self.leeway:
            raise OIDCError("token not yet valid")
        if self.issuer and claims.get("iss") != self.issuer:
            raise OIDCError(f"issuer {claims.get('iss')!r} not trusted")
        if self.audience:
            aud = claims.get("aud", "")
            auds = aud if isinstance(aud, list) else [aud]
            if self.audience not in auds:
                raise OIDCError("audience mismatch")
        return claims

    def policies_from(self, claims: dict) -> list[str]:
        """The policy claim, comma-separated or a list
        (reference GetPoliciesFromClaims)."""
        v = claims.get(self.claim_name, "")
        if isinstance(v, list):
            return [str(x) for x in v if x]
        return [p.strip() for p in str(v).split(",") if p.strip()]
