"""Logger core: targets, dedup, audit records, console pubsub
(counterpart of minio_tpu/logger/logger.py)."""

from __future__ import annotations

import json
import os
import queue
import socket
import sys
import threading
import time
import urllib.request
from dataclasses import dataclass, field

from minio_tpu_torch.admin.pubsub import PubSub

VERSION = "1"


# ---------------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------------


class ConsoleTarget:
    """JSON lines to a stream (default stderr) — the structured console
    logger (cmd/logger console/JSON mode)."""

    def __init__(self, stream=None, json_lines: bool = True):
        self.stream = stream or sys.stderr
        self.json_lines = json_lines

    def send(self, entry: dict) -> None:
        if self.json_lines:
            self.stream.write(json.dumps(entry, separators=(",", ":")) + "\n")
        else:
            t = entry.get("time", "")
            self.stream.write(
                f"{t} {entry.get('level', 'INFO')} {entry.get('message', '')}\n")
        try:
            self.stream.flush()
        except Exception:  # noqa: BLE001
            pass


class FileTarget:
    """Append JSON lines to a file (durable local log / audit trail)."""

    def __init__(self, path: str):
        self.path = path
        self._mu = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def send(self, entry: dict) -> None:
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        with self._mu:
            # mtpu: allow(MTPU002) - the lock exists to serialize appends:
            # the audit trail must be durable before send() returns
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(line)


class HTTPTarget:
    """POST entries to a webhook endpoint through a bounded queue drained by
    a background sender with retry — the at-least-once store-and-forward of
    cmd/logger/target/http (entries drop only when the queue overflows,
    mirroring its logChBuf semantics)."""

    def __init__(self, endpoint: str, auth_token: str = "",
                 queue_size: int = 10000, timeout: float = 5.0,
                 retries: int = 2):
        self.endpoint = endpoint
        self.auth_token = auth_token
        self.timeout = timeout
        self.retries = retries
        self._q: queue.Queue = queue.Queue(maxsize=queue_size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def send(self, entry: dict) -> None:
        try:
            self._q.put_nowait(entry)
        except queue.Full:
            pass  # never block the serving path on a slow log sink

    def _post(self, entry: dict) -> bool:
        body = json.dumps(entry).encode()
        req = urllib.request.Request(
            self.endpoint, data=body,
            headers={"Content-Type": "application/json",
                     **({"Authorization": f"Bearer {self.auth_token}"}
                        if self.auth_token else {})},
            method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return 200 <= resp.status < 300
        except Exception:  # noqa: BLE001
            return False

    def _drain(self) -> None:
        while not self._stop.is_set():
            try:
                entry = self._q.get(timeout=0.25)
            except queue.Empty:
                continue
            for attempt in range(self.retries + 1):
                if self._post(entry):
                    break
                if self._stop.is_set():
                    break
                time.sleep(min(0.2 * (2 ** attempt), 2.0))

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=3)


# ---------------------------------------------------------------------------
# audit records
# ---------------------------------------------------------------------------


@dataclass
class AuditEntry:
    """One per-request audit record (reference audit.Entry,
    cmd/logger/audit.go): who did what to which object, with status and
    timing. Serialized as a flat JSON object."""

    api: str
    bucket: str = ""
    object: str = ""
    status_code: int = 0
    access_key: str = ""
    remote_host: str = ""
    user_agent: str = ""
    request_id: str = ""
    rx_bytes: int = 0
    tx_bytes: int = 0
    duration_ms: float = 0.0
    time: str = ""
    deployment_id: str = ""
    query: dict = field(default_factory=dict)
    req_headers: dict = field(default_factory=dict)

    def to_doc(self) -> dict:
        return {
            "version": VERSION,
            "deploymentid": self.deployment_id,
            "time": self.time or _rfc3339(),
            "api": {
                "name": self.api, "bucket": self.bucket,
                "object": self.object, "statusCode": self.status_code,
                "rx": self.rx_bytes, "tx": self.tx_bytes,
                "timeToResponseMs": round(self.duration_ms, 3),
            },
            "remotehost": self.remote_host,
            "requestID": self.request_id,
            "userAgent": self.user_agent,
            "accessKey": self.access_key,
            "requestQuery": self.query,
            "requestHeader": self.req_headers,
        }


def _rfc3339(ts: float | None = None) -> str:
    t = time.gmtime(ts if ts is not None else time.time())
    frac = (ts if ts is not None else time.time()) % 1
    return time.strftime("%Y-%m-%dT%H:%M:%S", t) + f".{int(frac * 1e6):06d}Z"


def audit_entry(api: str, **kw) -> AuditEntry:
    return AuditEntry(api=api, time=_rfc3339(), **kw)


# ---------------------------------------------------------------------------
# the logger
# ---------------------------------------------------------------------------


class Logger:
    """Process logger with separate ops/audit target lists, dedup, and a
    console pubsub (admin console streaming, cmd/consolelogger.go)."""

    def __init__(self, node: str = ""):
        self.node = node or socket.gethostname()
        self.targets: list = [ConsoleTarget()]
        self.audit_targets: list = []
        self.console_bus = PubSub()
        self._once: dict[str, float] = {}
        self._mu = threading.Lock()
        self.min_level = "INFO"

    # -- ops log --

    _LEVELS = {"DEBUG": 0, "INFO": 1, "WARNING": 2, "ERROR": 3, "FATAL": 4}

    def log(self, level: str, message: str, **fields) -> None:
        if self._LEVELS.get(level, 1) < self._LEVELS.get(self.min_level, 1):
            return
        entry = {
            "level": level, "time": _rfc3339(), "node": self.node,
            "message": message, **fields,
        }
        self.console_bus.publish(entry)
        for t in self.targets:
            try:
                t.send(entry)
            except Exception:  # noqa: BLE001
                pass

    def debug(self, message: str, **kw) -> None:
        self.log("DEBUG", message, **kw)

    def info(self, message: str, **kw) -> None:
        self.log("INFO", message, **kw)

    def warning(self, message: str, **kw) -> None:
        self.log("WARNING", message, **kw)

    def error(self, message: str, **kw) -> None:
        self.log("ERROR", message, **kw)

    def log_once(self, level: str, message: str, interval: float = 30.0,
                 **fields) -> None:
        """Dedup repeated identical messages (reference logonce.go)."""
        now = time.monotonic()
        with self._mu:
            last = self._once.get(message, 0.0)
            if now - last < interval:
                return
            self._once[message] = now
        self.log(level, message, **fields)

    # -- audit log --

    def audit(self, entry: AuditEntry) -> None:
        doc = entry.to_doc()
        for t in self.audit_targets:
            try:
                t.send(doc)
            except Exception:  # noqa: BLE001
                pass


_global: Logger | None = None
_global_mu = threading.Lock()


def get_logger() -> Logger:
    global _global
    with _global_mu:
        if _global is None:
            _global = Logger()
        return _global
