"""Config-at-rest encryption under the root credential (counterpart of
minio_tpu/crypto/configcrypt.py; reference cmd/config-encrypted.go +
madmin EncryptData/DecryptData): durable server state stored inside the
cluster — the config KV — is sealed with a key derived from the root
secret, so drives alone never leak it.

Envelope format (all integers little-endian), the JAX package's:

    magic   "MTPC1"                       (5 bytes)
    kdf     1 = argon2id                  (1 byte)
            2 = scrypt
    t, m_kib, lanes                       (3 x u32; scrypt packs n/r/p)
    salt                                  (16 bytes)
    nonce                                 (12 bytes)
    AEAD ciphertext || tag                (crypto/aead.py)

The port writes argon2id, through its host library (csrc/host_codec.cc),
as the JAX package does wherever its own library builds; it reads both
KDFs, since a JAX deployment without its library sealed with scrypt.
Decryption with a wrong credential fails the tag — a clean error, not
garbage config.
"""

from __future__ import annotations

import hashlib
import os
import struct

from minio_tpu_torch.crypto.aead import AESGCM
from minio_tpu_torch.native import lib as hostlib

MAGIC = b"MTPC1"
KDF_ARGON2ID = 1
KDF_SCRYPT = 2

# Interactive-login-class cost (RFC 9106 §4 second recommendation): 64 MiB,
# t=1 (argon2id) / scrypt n=2^15,r=8,p=1.
ARGON_T, ARGON_M_KIB, ARGON_LANES = 1, 65536, 4
SCRYPT_LOG_N, SCRYPT_R, SCRYPT_P = 15, 8, 1
_HDR_LEN = len(MAGIC) + 13 + 16 + 12


class ConfigCryptError(Exception):
    pass


def _derive(kdf: int, secret: str, salt: bytes, p1: int, p2: int,
            p3: int) -> bytes:
    if kdf == KDF_ARGON2ID:
        return hostlib.argon2id(secret.encode(), salt, t=p1, m_kib=p2,
                                lanes=p3, outlen=32)
    if kdf == KDF_SCRYPT:
        return hashlib.scrypt(secret.encode(), salt=salt, n=1 << p1, r=p2,
                              p=p3, maxmem=256 << 20, dklen=32)
    raise ConfigCryptError(f"unknown KDF id {kdf}")


def is_encrypted(data: bytes) -> bool:
    return data.startswith(MAGIC)


def _derive_cached(kdf: int, secret: str, salt: bytes, p1: int, p2: int,
                   p3: int, key_cache: dict | None) -> bytes:
    if key_cache is None:
        return _derive(kdf, secret, salt, p1, p2, p3)
    ck = (kdf, p1, p2, p3, salt)
    key = key_cache.get(ck)
    if key is None:
        key = key_cache[ck] = _derive(kdf, secret, salt, p1, p2, p3)
    return key


def encrypt_data(secret: str, plaintext: bytes, *, salt: bytes | None = None,
                 key_cache: dict | None = None) -> bytes:
    """Seal `plaintext` under the credential string `secret` (argon2id).

    Pass a fixed `salt` + shared `key_cache` to amortize the memory-hard
    KDF over many payloads (one derivation per process; fresh random
    nonces keep key reuse safe far beyond realistic write counts).
    """
    salt = salt or os.urandom(16)
    nonce = os.urandom(12)
    params = (ARGON_T, ARGON_M_KIB, ARGON_LANES)
    key = _derive_cached(KDF_ARGON2ID, secret, salt, *params, key_cache)
    header = MAGIC + struct.pack("<BIII", KDF_ARGON2ID, *params) + salt + nonce
    # Header as AAD: tampering with the recorded KDF/cost parameters is
    # detected, not silently honored.
    return header + AESGCM(key).encrypt(nonce, plaintext, header)


def decrypt_data(secret: str, data: bytes, *, key_cache: dict | None = None) -> bytes:
    """Unseal an encrypt_data payload; raises ConfigCryptError on a wrong
    credential, tampering, or unreasonable cost parameters."""
    if not data.startswith(MAGIC):
        raise ConfigCryptError("not an encrypted config payload")
    if len(data) < _HDR_LEN + 16:
        raise ConfigCryptError("truncated encrypted config payload")
    kdf, p1, p2, p3 = struct.unpack_from("<BIII", data, len(MAGIC))
    salt = data[len(MAGIC) + 13:len(MAGIC) + 29]
    nonce = data[len(MAGIC) + 29:_HDR_LEN]
    # The header is read BEFORE the tag can authenticate it, so cost
    # parameters are attacker-controlled at this point: the JAX package's
    # caps (a small multiple of what is ever written) bound a tampered
    # blob to about a second and 256 MiB. The AAD check still rejects the
    # tampering afterwards.
    if kdf == KDF_ARGON2ID and not (
            1 <= p1 <= 4 and 8 <= p2 <= (1 << 18) and 1 <= p3 <= 16):
        raise ConfigCryptError("unreasonable argon2id cost parameters "
                               "(tampered header?)")
    if kdf == KDF_SCRYPT and not (
            10 <= p1 <= 17 and 1 <= p2 <= 8 and 1 <= p3 <= 4):
        raise ConfigCryptError("unreasonable scrypt cost parameters "
                               "(tampered header?)")
    try:
        key = _derive_cached(kdf, secret, salt, p1, p2, p3, key_cache)
    except (ValueError, MemoryError) as e:
        raise ConfigCryptError(f"KDF failed: {e}") from None
    try:
        return AESGCM(key).decrypt(nonce, data[_HDR_LEN:], data[:_HDR_LEN])
    except Exception:  # noqa: BLE001 - wrong credential or tampered blob
        raise ConfigCryptError(
            "config decryption failed (wrong credential or corrupted "
            "payload)") from None


class SealedSysStore:
    """Sys-store decorator sealing every payload under the root credential
    (cmd/config-encrypted.go role). Reads pass unencrypted payloads
    through so pre-encryption deployments migrate transparently: the next
    write of each entry seals it.

    One random salt per instance + a shared key cache: the memory-hard
    KDF runs once per process for writes, and once per distinct on-disk
    salt for reads.
    """

    def __init__(self, inner, secret: str):
        self._inner = inner
        self._secret = secret
        self._salt = os.urandom(16)
        self._keys: dict = {}

    def write_sys_config(self, path: str, data: bytes) -> None:
        self._inner.write_sys_config(
            path, encrypt_data(self._secret, data, salt=self._salt,
                               key_cache=self._keys))

    def read_sys_config(self, path: str) -> bytes:
        return self.read_sys_config2(path)[0]

    def read_sys_config2(self, path: str) -> tuple[bytes, bool]:
        """-> (payload, was_sealed). IAMSys.load counts the sealed entries
        that decrypt, to tell a wrong credential (every sealed entry
        fails) from one bit-rotted entry."""
        raw = self._inner.read_sys_config(path)
        if is_encrypted(raw):
            return decrypt_data(self._secret, raw, key_cache=self._keys), True
        return raw, False

    def delete_sys_config(self, path: str) -> None:
        self._inner.delete_sys_config(path)

    def list_sys_config(self, prefix: str = "") -> list[str]:
        return self._inner.list_sys_config(prefix)
