"""Config KV subsystem (counterpart of minio_tpu/admin/configkv.py).

Role-equivalent of cmd/config/config.go:103-130: subsystem.key = value
configuration with registered defaults, env override
(MTPU_<SUBSYS>_<KEY> — env beats stored config, matching the reference's
precedence), persistence in the sys store (sealed by the server under the
root credential, crypto/configcrypt.py, at the JAX package's path and in
its JSON, so either package reads the other's), and `mc admin config
get/set` semantics over the admin API.

The port applies `storageclass` (the parity of the next PUT), `heal` (the
auto-healer's pacing), `compression` and `kms`. The subsystems of planes
the port does not have yet (notify_*, logger and audit, federation,
bandwidth, identity_*, api, region, scanner) are stored and round-trip
unchanged; nothing applies them (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import threading

from minio_tpu_torch.utils import errors as se

# Registered subsystems and their default keys (cmd/config/config.go:103).
DEFAULTS: dict[str, dict[str, str]] = {
    "api": {"requests_max": "0", "cors_allow_origin": "*",
            # Honor X-Forwarded-For / X-Real-IP in audit/trace records —
            # only enable behind a trusted reverse proxy (spoofable
            # otherwise; reference pkg/handlers GetSourceIP role).
            "trust_proxy_headers": "off"},
    "region": {"name": "us-east-1"},
    "storageclass": {"standard": "", "rrs": "EC:1"},
    "compression": {"enable": "off", "extensions": ".txt,.log,.csv,.json",
                    "mime_types": "text/*,application/json"},
    "scanner": {"delay": "10", "max_wait": "15s", "cycle": "1m"},
    "heal": {"bitrotscan": "off", "max_sleep": "1s", "max_io": "10"},
    "notify_webhook": {"enable": "off", "endpoint": "", "auth_token": "",
                       "queue_limit": "10000"},
    "notify_nats": {"enable": "off", "address": "", "subject": "minio"},
    "notify_redis": {"enable": "off", "address": "", "key": "minio_events",
                     "password": "", "format": "access"},
    "notify_mqtt": {"enable": "off", "address": "", "topic": "minio"},
    "notify_elasticsearch": {"enable": "off", "url": "", "index": "minio"},
    "notify_nsq": {"enable": "off", "address": "", "topic": "minio"},
    "notify_kafka": {"enable": "off", "brokers": "", "topic": "minio"},
    "notify_amqp": {"enable": "off", "url": "", "exchange": "",
                    "routing_key": "minio", "user": "guest",
                    "password": "guest", "vhost": "/"},
    "notify_postgres": {"enable": "off", "address": "", "table": "",
                        "user": "postgres", "password": "",
                        "database": "postgres"},
    "notify_mysql": {"enable": "off", "address": "", "table": "",
                     "user": "root", "password": "", "database": "minio"},
    # Bucket federation (etcd/DNS role): `directory` is the shared
    # registry file; `endpoint` this cluster's advertised URL.
    "federation": {"enable": "off", "directory": "", "endpoint": ""},
    # Per-bucket bandwidth limits, bytes/second (pkg/bandwidth role):
    # `default` covers every bucket; additional keys name buckets.
    "bandwidth": {"default": "0"},
    "logger_webhook": {"enable": "off", "endpoint": "", "auth_token": ""},
    "audit_webhook": {"enable": "off", "endpoint": "", "auth_token": ""},
    "audit_file": {"path": ""},
    # OIDC federation (cmd/config/identity/openid): jwks is inline JSON or
    # a local file path — zero-egress deployments mount the IdP's JWKS.
    "identity_openid": {"enable": "off", "jwks": "", "issuer": "",
                        "audience": "", "claim_name": "policy"},
    # LDAP federation (cmd/config/identity/ldap role): simple-bind auth;
    # policies for LDAP principals are configured, not group-searched.
    "identity_ldap": {"enable": "off", "server_addr": "",
                      "user_dn_format": "", "sts_policy": "",
                      "tls": "on", "tls_skip_verify": "off"},
    "kms": {"enable": "off", "key_file": "", "default_key": "",
            "kes_endpoint": "", "kes_client_cert": "", "kes_client_key": "",
            "kes_ca_file": ""},
}

# Subsystems that apply without restart (cmd/config/config.go:133).
DYNAMIC = {"api", "scanner", "heal", "storageclass", "bandwidth",
           "logger_webhook", "audit_webhook", "audit_file",
           "notify_webhook", "notify_nats", "notify_redis", "notify_mqtt",
           "notify_elasticsearch", "notify_nsq", "notify_kafka",
           "notify_amqp", "notify_postgres", "notify_mysql"}

PATH = "config/config.json"
ENV_PREFIX = "MTPU"


class ConfigError(ValueError):
    """An unknown subsystem or key, or a value its schema refuses."""


class ConfigSys:
    def __init__(self, store=None):
        self._store = store
        self._mu = threading.Lock()
        self._kv: dict[str, dict[str, str]] = {
            s: dict(kv) for s, kv in DEFAULTS.items()}
        # Bumped on every mutation: hot-path consumers (the bandwidth
        # throttle) cache parsed values against it instead of re-reading
        # the store per chunk.
        self.generation = 0
        if store is not None:
            self._load()

    def _load(self) -> None:
        try:
            doc = json.loads(self._store.read_sys_config(PATH))
        except (se.FileNotFound, ValueError):
            return
        for subsys, kv in doc.items():
            if subsys in self._kv:
                self._kv[subsys].update({str(k): str(v)
                                         for k, v in kv.items()})

    def _persist(self) -> None:
        if self._store is not None:
            self._store.write_sys_config(
                PATH, json.dumps(self._kv, indent=1).encode())

    def get(self, subsys: str, key: str) -> str:
        """env > stored > default (the reference's precedence)."""
        env = os.environ.get(f"{ENV_PREFIX}_{subsys.upper()}_{key.upper()}")
        if env is not None:
            return env
        with self._mu:
            try:
                return self._kv[subsys][key]
            except KeyError:
                raise ConfigError(f"unknown config {subsys}.{key}") from None

    def set_kv(self, subsys: str, updates: dict[str, str]) -> None:
        with self._mu:
            if subsys not in self._kv:
                raise ConfigError(f"unknown config subsystem {subsys!r}")
            # `bandwidth` takes free-form keys (each names a bucket) but
            # validates VALUES (bytes/sec) — a typo like "10MB" silently
            # becoming "unlimited" on the data path would be worse than an
            # error here. Other subsystems validate against their schema.
            if subsys == "storageclass":
                # "" (default) or "EC:<parity>" — a typo silently becoming
                # "keep default" would hide a misconfigured redundancy.
                for k, v in updates.items():
                    s = str(v).strip().upper()
                    ok = s == "" or (s.startswith("EC:")
                                     and s[3:].isdigit()
                                     and int(s[3:]) <= 16)
                    if not ok:
                        raise ConfigError(
                            f"storageclass.{k}: expected EC:<0-16>, "
                            f"got {v!r}")
            if subsys == "bandwidth":
                import math

                for k, v in updates.items():
                    try:
                        fv = float(v)
                        # Note the >= polarity: NaN fails it, so a typo
                        # like "nan" cannot silently disable the limit.
                        if not (math.isfinite(fv) and fv >= 0):
                            raise ValueError
                    except (TypeError, ValueError):
                        raise ConfigError(
                            f"bandwidth.{k}: rate must be a finite "
                            f"non-negative number of bytes/sec, got {v!r}"
                        ) from None
            else:
                unknown = set(updates) - set(DEFAULTS[subsys])
                if unknown:
                    raise ConfigError(
                        f"unknown keys for {subsys}: {sorted(unknown)}")
            self._kv[subsys].update(
                {str(k): str(v) for k, v in updates.items()})
            self.generation += 1
            self._persist()

    def reset(self, subsys: str) -> None:
        with self._mu:
            if subsys not in self._kv:
                raise ConfigError(f"unknown config subsystem {subsys!r}")
            self._kv[subsys] = dict(DEFAULTS[subsys])
            self.generation += 1
            self._persist()

    def dump(self, subsys: str = "") -> dict:
        with self._mu:
            if subsys:
                if subsys not in self._kv:
                    raise ConfigError(f"unknown config subsystem {subsys!r}")
                return {subsys: dict(self._kv[subsys])}
            return {s: dict(kv) for s, kv in self._kv.items()}

    def is_dynamic(self, subsys: str) -> bool:
        return subsys in DYNAMIC
