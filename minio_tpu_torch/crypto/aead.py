"""AEAD provider gate: real AES-GCM when `cryptography` is installed,
a stdlib fallback otherwise (a copy of minio_tpu/crypto/aead.py: the same
gate, so in one environment both packages pick the same provider, and the
same fallback format, so each opens what the other sealed).

Some deployment images (and this repo's CI container) ship without the
`cryptography` wheel; a module-level import would take down every plane
that transitively touches SSE/config sealing — which is the whole
server. The fallback is an honest encrypt-then-MAC AEAD built from
stdlib primitives:

    keystream = SHAKE-256(domain || key || nonce)   (XOR stream cipher)
    tag       = HMAC-SHA256(key, domain || nonce || aad || ct)[:16]

Same shape as AES-GCM (ciphertext = plaintext + 16-byte tag, 12-byte
nonces, nonce-reuse forbidden) so every size computation in sse.py holds
— but NOT wire-compatible with data sealed by real AES-GCM. A store
written under one provider must be read under the same provider; mixing
surfaces as the normal "unseal failed" typed errors, never silent
corruption.
"""

from __future__ import annotations

import hashlib
import hmac as _hmac

TAG = 16
_DOMAIN = b"mtpu-aead-v1"

try:
    from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: F401
        AESGCM,
    )

    HAVE_AESGCM = True
except ImportError:
    HAVE_AESGCM = False

    import logging
    import os as _os

    # Production guardrail: a store sealed by one provider is unreadable
    # under the other, so an image rebuild that drops/restores the wheel
    # must never switch providers unnoticed. Operators who require real
    # AES-GCM set MTPU_REQUIRE_AESGCM=1 to turn the downgrade into a
    # boot failure instead of a warning.
    if _os.environ.get("MTPU_REQUIRE_AESGCM", "") in ("1", "on", "true"):
        raise ImportError(
            "cryptography package not installed and MTPU_REQUIRE_AESGCM "
            "is set: refusing to boot with the stdlib AEAD fallback")

    # Loud, once, at import: an operator must KNOW the provider changed.
    logging.getLogger("minio_tpu_torch").warning(
        "cryptography package not installed: SSE/KMS/config sealing is "
        "using the stdlib AEAD fallback (SHAKE-256 stream + HMAC tag, not "
        "AES-GCM). Data sealed under one provider cannot be unsealed under "
        "the other — do not switch providers over an existing store; set "
        "MTPU_REQUIRE_AESGCM=1 to make this condition fatal.")

    class InvalidTag(Exception):  # noqa: N818 - the cryptography name
        pass

    class AESGCM:  # noqa: N801 - drop-in for the cryptography class
        """Stdlib AEAD with the AESGCM call shape (see module docstring)."""

        def __init__(self, key: bytes):
            if len(key) not in (16, 24, 32):
                raise ValueError("AEAD key must be 128/192/256 bits")
            self._key = bytes(key)

        def _keystream(self, nonce: bytes, n: int) -> bytes:
            return hashlib.shake_256(
                _DOMAIN + self._key + bytes(nonce)).digest(n)

        def _tag(self, nonce: bytes, aad: bytes, ct: bytes) -> bytes:
            mac = _hmac.new(self._key, digestmod=hashlib.sha256)
            mac.update(_DOMAIN)
            mac.update(len(nonce).to_bytes(2, "big") + bytes(nonce))
            aad = bytes(aad or b"")
            mac.update(len(aad).to_bytes(8, "big") + aad)
            mac.update(ct)
            return mac.digest()[:TAG]

        @staticmethod
        def _xor(data: bytes, ks: bytes) -> bytes:
            n = len(data)
            return (int.from_bytes(data, "big")
                    ^ int.from_bytes(ks, "big")).to_bytes(n, "big")

        def encrypt(self, nonce: bytes, data: bytes,
                    aad: bytes | None) -> bytes:
            data = bytes(data)
            ct = self._xor(data, self._keystream(nonce, len(data)))
            return ct + self._tag(nonce, aad or b"", ct)

        def decrypt(self, nonce: bytes, data: bytes,
                    aad: bytes | None) -> bytes:
            data = bytes(data)
            if len(data) < TAG:
                raise InvalidTag("ciphertext shorter than tag")
            ct, tag = data[:-TAG], data[-TAG:]
            if not _hmac.compare_digest(tag, self._tag(nonce, aad or b"",
                                                       ct)):
                raise InvalidTag("AEAD tag mismatch")
            return self._xor(ct, self._keystream(nonce, len(ct)))


# The provider in use, as phase 13 of chip_smoke.py prints it.
PROVIDER = ("AES-256-GCM (cryptography)" if HAVE_AESGCM
            else "stdlib fallback (SHAKE-256 stream + HMAC-SHA256 tag)")
