"""KES client: networked KMS backend for SSE-KMS envelope encryption (a
copy of minio_tpu/crypto/kes.py, stdlib urllib and ssl only).

Role-equivalent of cmd/crypto/kes.go — MinIO's client for the KES key
server (the stateless KMS front for Vault et al.). Speaks the KES HTTP
API with mutual-TLS client authentication:

    POST /v1/key/create/<name>              create a master key
    POST /v1/key/generate/<name>            -> {plaintext, ciphertext} (b64)
    POST /v1/key/decrypt/<name>             -> {plaintext} (b64)
    GET  /v1/key/list/<pattern>             enumerate keys
    GET  /version                           health/version probe

Presents the same surface as LocalKMS (generate_data_key /
decrypt_data_key / create_key / status), so the S3 server's SSE paths are
backend-agnostic. Sealed blobs are tagged `kes:v1:<key_id>:<b64 ct>` —
distinct from LocalKMS's `v1:` prefix, so an operator migrating between
backends gets a clean "wrong backend" error instead of a garbage unseal.

The derived-context binding matches the local backend: the object's
bucket/key path rides as the KES context so a sealed key copied onto a
different object cannot be unsealed.
"""

from __future__ import annotations

import base64
import json
import urllib.error
import urllib.request

from minio_tpu_torch.crypto.kms import KMSError

_TIMEOUT = 10.0


class KESClient:
    """Client for one KES endpoint.

    `endpoint` like https://kes.example:7373 (http allowed for tests/dev);
    `client_cert`/`client_key` are the mTLS identity PEM files; `ca_file`
    pins the server CA. Network errors surface as KMSError — the caller
    (SSE path) turns that into a 5xx, never a plaintext fallback.
    """

    def __init__(self, endpoint: str, default_key_id: str = "",
                 client_cert: str = "", client_key: str = "",
                 ca_file: str = "", timeout: float = _TIMEOUT):
        self.endpoint = endpoint.rstrip("/")
        self.default_key_id = default_key_id
        self._timeout = timeout
        import ssl

        scheme = self.endpoint.split("://", 1)[0].lower()
        if scheme == "https":
            ctx = ssl.create_default_context(cafile=ca_file or None)
            if client_cert:
                ctx.load_cert_chain(client_cert, client_key or None)
            self._opener = urllib.request.build_opener(
                urllib.request.HTTPSHandler(context=ctx))
        elif scheme == "http":
            self._opener = urllib.request.build_opener()
        else:
            # A typo'd scheme must not silently drop mTLS/CA pinning.
            raise KMSError(f"KES endpoint scheme must be http(s): "
                           f"{endpoint!r}")

    # -- transport --

    def _call(self, method: str, path: str, body: dict | None = None) -> dict:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(body).encode() if body is not None else None,
            method=method,
            headers={"Content-Type": "application/json"} if body is not None
            else {})
        try:
            with self._opener.open(req, timeout=self._timeout) as resp:
                raw = resp.read()
                return json.loads(raw) if raw.strip() else {}
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:200]
            except Exception:
                pass
            raise KMSError(
                f"KES {method} {path}: HTTP {e.code} {detail}") from None
        except (urllib.error.URLError, OSError, json.JSONDecodeError,
                TimeoutError) as e:
            raise KMSError(f"KES unreachable ({self.endpoint}): {e}") \
                from None

    # -- admin surface (LocalKMS parity) --

    @property
    def configured(self) -> bool:
        return bool(self.endpoint)

    def version(self) -> dict:
        return self._call("GET", "/version")

    def key_ids(self) -> list[str]:
        out = self._call("GET", "/v1/key/list/*")
        # KES returns either a JSON array of {name,...} or NDJSON-ish list.
        if isinstance(out, list):
            return sorted(k.get("name", "") for k in out if k.get("name"))
        return sorted(out.get("names", []))

    def create_key(self, key_id: str) -> None:
        _validate_key_id(key_id)
        self._call("POST", f"/v1/key/create/{key_id}")
        if not self.default_key_id:
            self.default_key_id = key_id

    def status(self) -> dict:
        st = {"configured": True, "backend": "kes",
              "endpoint": self.endpoint,
              "defaultKeyId": self.default_key_id}
        try:
            st["version"] = self.version().get("version", "")
            st["online"] = True
        except KMSError as e:
            st["online"] = False
            st["error"] = str(e)
        return st

    # -- envelope operations --

    def generate_data_key(self, key_id: str = "",
                          context: str = "") -> tuple[str, bytes, str]:
        """-> (key_id used, plaintext 32B data key, sealed blob)."""
        kid = key_id or self.default_key_id
        if not kid:
            raise KMSError("KES backend has no default key configured")
        _validate_key_id(kid)
        body = {}
        if context:
            body["context"] = base64.b64encode(context.encode()).decode()
        out = self._call("POST", f"/v1/key/generate/{kid}", body)
        try:
            plaintext = base64.b64decode(out["plaintext"])
            ciphertext = base64.b64decode(out["ciphertext"])
        except (KeyError, TypeError, ValueError) as e:
            raise KMSError(f"malformed KES generate response: {e}") from None
        if len(plaintext) != 32:
            raise KMSError("KES returned a non-32-byte data key")
        sealed = f"kes:v1:{kid}:{base64.b64encode(ciphertext).decode()}"
        return kid, plaintext, sealed

    def decrypt_data_key(self, sealed: str, context: str = "") -> bytes:
        try:
            tag, ver, kid, b64 = sealed.split(":", 3)
            if tag != "kes" or ver != "v1":
                raise ValueError(f"{tag}:{ver}")
            ciphertext = base64.b64decode(b64)
        except (ValueError, TypeError) as e:
            raise KMSError(f"malformed KES sealed key: {e}") from None
        _validate_key_id(kid)
        body = {"ciphertext": base64.b64encode(ciphertext).decode()}
        if context:
            body["context"] = base64.b64encode(context.encode()).decode()
        out = self._call("POST", f"/v1/key/decrypt/{kid}", body)
        try:
            plaintext = base64.b64decode(out["plaintext"])
        except (KeyError, TypeError, ValueError) as e:
            raise KMSError(f"malformed KES decrypt response: {e}") from None
        if len(plaintext) != 32:
            raise KMSError("KES returned a non-32-byte data key")
        return plaintext


def _validate_key_id(key_id: str) -> None:
    import re

    # Key ids are URL path segments — reject anything that could traverse
    # or smuggle (the KES server enforces the same charset).
    if not re.fullmatch(r"[A-Za-z0-9._-]{1,64}", key_id):
        raise KMSError(f"invalid KES key id {key_id!r}")


def kms_from_config(config) -> object:
    """Build the configured KMS backend (config subsystem `kms`):
    kes_endpoint set -> KESClient, else LocalKMS. The seam the reference
    keeps in cmd/crypto: GlobalKMS is whichever backend config selects."""
    from minio_tpu_torch.crypto.kms import LocalKMS

    endpoint = config.get("kms", "kes_endpoint") or ""
    if endpoint:
        return KESClient(
            endpoint,
            default_key_id=config.get("kms", "default_key") or "",
            client_cert=config.get("kms", "kes_client_cert") or "",
            client_key=config.get("kms", "kes_client_key") or "",
            ca_file=config.get("kms", "kes_ca_file") or "")
    return LocalKMS(
        key_file=config.get("kms", "key_file") or "",
        default_key_id=config.get("kms", "default_key") or "")
