"""Structured logging and audit (counterpart of minio_tpu/logger/;
reference cmd/logger/): a process-wide structured logger with pluggable
targets (JSON console, append-file, HTTP webhook with a retry queue),
per-message dedup (log_once), a console pubsub feeding the admin
`consolelog` stream, and the per-request audit log the S3 server writes
for every API call.

Two planes, separately targeted:
  - ops log   (Logger.info/warning/error)  -> log targets
  - audit log (Logger.audit / audit_entry) -> audit targets
"""

from minio_tpu_torch.logger.logger import (  # noqa: F401
    AuditEntry,
    ConsoleTarget,
    FileTarget,
    HTTPTarget,
    Logger,
    audit_entry,
    get_logger,
)
