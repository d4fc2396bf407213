"""KMS: pluggable key-management for SSE-KMS / SSE-S3 envelope encryption
(a copy of minio_tpu/crypto/kms.py: the same key file, environment and
sealed-key format, so either package unseals the other's data keys).

Role-equivalent of cmd/crypto/{kes,vault}.go + cmd/kms-router: the object
layer never stores master keys — it asks the KMS for a fresh data key
(plaintext + sealed blob), stores only the sealed blob in object metadata,
and asks the KMS to unseal it on reads. The first backend is LocalKMS
(master keys from env/config — the role kes.go's local fallback plays);
the interface is the seam where a networked KES/Vault client would plug.

Sealing format: AES-256-GCM under the named master key with the object's
bucket/key path as AAD, serialized as  v1:<key_id>:<b64(nonce|ct|tag)>.
"""

from __future__ import annotations

import base64
import os
import secrets as pysecrets

from minio_tpu_torch.crypto.aead import AESGCM


class KMSError(Exception):
    pass


class LocalKMS:
    """Master keys held locally.

    Sources, in precedence order:
      - explicit `keys` dict {key_id: 32B key}
      - MTPU_KMS_KEY_FILE: lines of `<key_id>:<base64 32-byte key>`
      - MTPU_KMS_SECRET_KEY: one secret string -> key id `default`
        (hashed to 32 bytes)
    """

    def __init__(self, keys: dict[str, bytes] | None = None,
                 default_key_id: str = "", key_file: str = ""):
        import hashlib

        self._keys: dict[str, bytes] = dict(keys or {})
        # Persistence path: keys minted at runtime (create_key) must
        # survive restarts or every SSE-KMS object sealed under them is
        # lost. Master keys deliberately live OUTSIDE the object store
        # they protect.
        self._path = (key_file or os.environ.get("MTPU_KMS_KEY_FILE", "")
                      or os.path.expanduser("~/.mtpu/kms-keys"))
        if not self._keys:
            if os.path.exists(self._path):
                for line in open(self._path, encoding="utf-8"):
                    line = line.strip()
                    if not line or line.startswith("#"):
                        continue
                    kid, _, b64 = line.partition(":")
                    raw = base64.b64decode(b64)
                    if len(raw) != 32:
                        raise KMSError(f"key {kid!r} is not 32 bytes")
                    self._keys[kid] = raw
            if os.environ.get("MTPU_KMS_SECRET_KEY"):
                self._keys.setdefault("default", hashlib.sha256(
                    os.environ["MTPU_KMS_SECRET_KEY"].encode()).digest())
        self.default_key_id = (default_key_id
                               or os.environ.get("MTPU_KMS_DEFAULT_KEY", "")
                               or (next(iter(self._keys), "")))

    # -- admin surface (cmd/kms-router roles) --

    @property
    def configured(self) -> bool:
        return bool(self._keys)

    def key_ids(self) -> list[str]:
        return sorted(self._keys)

    def create_key(self, key_id: str) -> None:
        import re

        # Strict id charset: anything else (newlines, ':') would corrupt
        # the line-oriented key file and brick the next boot.
        if not re.fullmatch(r"[A-Za-z0-9._-]{1,64}", key_id):
            raise KMSError(f"invalid key id {key_id!r}")
        if key_id in self._keys:
            raise KMSError(f"key {key_id!r} exists")
        key = pysecrets.token_bytes(32)
        # Persist BEFORE registering: a key that can seal objects but
        # wouldn't survive a restart is data loss waiting to happen.
        os.makedirs(os.path.dirname(os.path.abspath(self._path)),
                    exist_ok=True)
        with open(self._path, "a", encoding="utf-8") as f:
            f.write(f"{key_id}:{base64.b64encode(key).decode()}\n")
        try:
            os.chmod(self._path, 0o600)
        except OSError:
            pass
        self._keys[key_id] = key
        if not self.default_key_id:
            self.default_key_id = key_id

    def status(self) -> dict:
        return {"configured": self.configured,
                "defaultKeyId": self.default_key_id,
                "keys": self.key_ids()}

    # -- the envelope operations --

    def _master(self, key_id: str) -> bytes:
        try:
            return self._keys[key_id]
        except KeyError:
            raise KMSError(f"unknown KMS key {key_id!r}") from None

    def generate_data_key(self, key_id: str = "",
                          context: str = "") -> tuple[str, bytes, str]:
        """-> (key_id used, plaintext 32B data key, sealed blob)."""
        kid = key_id or self.default_key_id
        if not kid:
            raise KMSError("KMS not configured (no master keys)")
        plaintext = pysecrets.token_bytes(32)
        nonce = pysecrets.token_bytes(12)
        ct = AESGCM(self._master(kid)).encrypt(
            nonce, plaintext, context.encode())
        sealed = f"v1:{kid}:{base64.b64encode(nonce + ct).decode()}"
        return kid, plaintext, sealed

    def decrypt_data_key(self, sealed: str, context: str = "") -> bytes:
        try:
            ver, kid, b64 = sealed.split(":", 2)
            if ver != "v1":
                raise ValueError(ver)
            raw = base64.b64decode(b64)
            nonce, ct = raw[:12], raw[12:]
        except (ValueError, TypeError) as e:
            raise KMSError(f"malformed sealed key: {e}") from None
        try:
            return AESGCM(self._master(kid)).decrypt(
                nonce, ct, context.encode())
        except Exception:  # noqa: BLE001 - wrong key / tampered blob
            raise KMSError("data key unseal failed "
                           "(wrong master key or corrupted blob)") from None
