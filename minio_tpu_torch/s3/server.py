"""S3 front door of the port: a stdlib threading HTTP server.

The JAX package serves S3 through aiohttp; the machine that runs the port
on the card has no aiohttp, so this server is built on
http.server.ThreadingHTTPServer (one daemon thread per connection). It
answers the operations of this slice with the JAX server's statuses,
headers and error documents:

    GET /                ListBuckets
    PUT /bucket          CreateBucket        HEAD /bucket        HeadBucket
    DELETE /bucket       DeleteBucket        POST /bucket?delete DeleteObjects
    GET /bucket          ListObjects (marker)
    GET /bucket?list-type=2                  ListObjectsV2 (continuation-token,
                                             start-after)
    GET /bucket?versions                     ListObjectVersions (key-marker,
                                             version-id-marker)
    PUT|GET /bucket?versioning               PutBucketVersioning,
                                             GetBucketVersioning
    PUT|GET|DELETE /bucket?encryption        the bucket's default SSE
    PUT|GET|DELETE /bucket?policy            the bucket policy (JSON)
    PUT|GET /bucket?object-lock              the object-lock configuration;
                                             x-amz-bucket-object-lock-enabled
                                             on CreateBucket
    PUT|GET|DELETE /bucket?lifecycle         the ILM rules the scanner applies
    PUT|GET /bucket?notification             the event rules (their ARNs must
                                             name a configured target)
    POST /bucket (multipart/form-data)       browser POST policy upload
    POST /  Action=AssumeRole...             STS: AssumeRole, AssumeRoleWith
                                             WebIdentity / ClientGrants /
                                             LDAPIdentity
    PUT /bucket/key      PutObject           GET /bucket/key     GetObject (Range)
    HEAD /bucket/key     HeadObject          DELETE /bucket/key  DeleteObject
    PUT /bucket/key + x-amz-copy-source      CopyObject (x-amz-metadata-directive)
    PUT|GET|DELETE /bucket/key?tagging       Put/Get/DeleteObjectTagging
    PUT|GET /bucket/key?retention            a version's retention; ?legal-hold
                                             its legal hold; x-amz-object-lock-*
                                             on PUT, else the bucket's default
    POST /bucket/key?restore                 RestoreObject: a transitioned
                                             version's data back from its tier
    POST /bucket/key?uploads                 CreateMultipartUpload
    PUT /bucket/key?partNumber=N&uploadId=U  UploadPart; with x-amz-copy-source
                                             (and -range), UploadPartCopy
    GET /bucket/key?uploadId=U               ListParts
    DELETE /bucket/key?uploadId=U            AbortMultipartUpload
    POST /bucket/key?uploadId=U              CompleteMultipartUpload
    GET /bucket?uploads                      ListMultipartUploads

    GET|HEAD /minio/health/{live,ready,cluster}[?maintenance=true]
                                             health probes, unsigned
    GET /minio/v2/metrics/{cluster,node}     Prometheus scrape (OpenMetrics
                                             on Accept), signed
    /minio/admin/v3/...                      the admin plane (admin/handlers.py:
                                             info, metrics, heal, top/api,
                                             trace, perf/timeline, profiling,
                                             config-kv, kms, datausageinfo, tier,
                                             consolelog)

Object calls take ?versionId (the literal "null" names the null version);
GET and HEAD take If-Match and If-None-Match (412, or 304). A bucket's
versioning lives in its metadata document (bucket/meta.py), the JAX
package's, so both servers on the same drives keep the same versions.

Objects are stored as the JAX server stores them at rest (s3/atrest.py):
SSE-C, SSE-S3 and SSE-KMS (x-amz-server-side-encryption*, or the bucket's
?encryption default; the KMS is LocalKMS or a KES server, from config
`kms`), or S2-compressed (config `compression`), and every object call
serves such a version's client bytes, whichever package stored it.

The server's config (admin/configkv.py) lives in the sys store sealed
under the root secret (crypto/configcrypt.py), as the JAX server keeps
it, and is read at start: `storageclass` sets the parity of the next PUT
on every set, `heal` paces the auto-healer.

A request proves who it is as the JAX server's do (minio_tpu/s3/server.py:
1082-1149): a presigned SigV4 URL (with a pinned X-Amz-Content-Sha256,
the body must match it), SigV4 header auth (a signed payload,
UNSIGNED-PAYLOAD, or an aws-chunked body whose every chunk's signature
is checked before a byte commits), SigV2 header or presigned auth, or
none (anonymous). Its access key is any identity of IAM (iam/sys.py: the
root, users, service accounts, temporary credentials, the last with their
session token); IAM lives in the sys store sealed under the root secret,
in the JAX package's layout. Every request is authorized as the JAX
server's _check_access decides: a bucket-policy Deny beats every
identity, the root included; then a bucket-policy Allow (anonymous
too); then the identity's policies, under the request's condition
context. A version under legal hold or an unexpired retention is not
destroyed, by DELETE ?versionId or by DeleteObjects (GOVERNANCE yields to
x-amz-bypass-governance-retention). Any other query string answers
NotImplemented. Any other /minio/ path answers as the JAX server answers
it, never as bucket "minio". The other bucket subresources (tagging,
replication, acl...), the web console and the admin plane's other ops
come in later slices (ROADMAP.md).

The background plane is the JAX server's (minio_tpu/s3/server.py:213-629):
start_scanner builds the data scanner (scanner/) over the object layer,
and main() starts it every --scan-interval seconds (default 60, 0 off);
PutObject, Complete, the POST upload and DeleteObject mark the update
tracker the scanner reads and send their S3 events to the bucket's
matching targets (event/, built from the notify_* config); every request
gets an audit entry on the audit targets (logger/, from audit_webhook and
audit_file), its request id the trace id; the ILM tiers live in a sealed
registry (scanner/tiers.py) that the object layer reads through.

Every request is in flight in HTTPStats (admin/stats.py) from its first
byte until just before the last byte of its answer is written, so a
client that has read an answer never sees it in flight. Once the answer
is written, its per-API counts, the minio_tpu_s3_requests_latency_seconds
and minio_tpu_s3_ttfb_seconds families (TTFB stamped when a streamed
answer's headers flush), its flight-recorder timeline and, while someone
traces, an `http` record take it, the body's send included.
The request id is the trace id of every record the request causes.

Each request's tenant (qos/: access key and bucket) is bound right after
authentication, in the same context as the trace id: every batch-plane
submit, WAL record, shm ring slot and admission shed downstream is
charged to it, the minio_tpu_tenant_* families count it, and admin
top/api and perf/timeline show it. The /minio/ planes stay on the
unattributed "-" lane.

A server binds its address in the constructor, or with listen=False binds
nothing: the front door's workers (frontdoor/worker.py) then hand it
connections the supervisor accepted (`adopt`) or a listening socket the
worker opened (`serve_socket`). Every answer passes the `on_response`
hooks, which may add headers (the front door's X-Mtpu-Worker).

The object layer is any of the port's: build_server assembles drives ->
ErasureSets (sets of --set-drive-count drives) -> ErasureServerPools, as
the JAX package's build_server does, with each set's MRF healer on
(enable_mrf=False turns it off). start_auto_heal starts one AutoHealer per
pool, which claims a wiped or replaced drive and rebuilds it; main() calls
it, as the JAX server's main does, paced by config `heal` (max_sleep,
max_io). The admin heal route (POST /minio/admin/v3/heal/<bucket>) heals
on demand.

Run: python -m minio_tpu_torch.s3.server --address 127.0.0.1:9000
[--set-drive-count N] [--scan-interval S] <drive dirs> (credentials from
MTPU_ROOT_USER / MTPU_ROOT_PASSWORD, default minioadmin).
"""

from __future__ import annotations

import argparse
import datetime
import email.utils
import hashlib
import io
import json
import mimetypes
import os
import signal
import tempfile
import threading
import time
import urllib.parse
import uuid
import xml.etree.ElementTree as ET
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from minio_tpu_torch import obs, qos
from minio_tpu_torch.admin.configkv import ConfigSys
from minio_tpu_torch.admin.handlers import ADMIN_PREFIX, AdminAPI
from minio_tpu_torch.admin.metrics import (OPENMETRICS_CONTENT_TYPE,
                                           PROM_CONTENT_TYPE,
                                           collect_cluster_metrics,
                                           collect_metrics,
                                           collect_node_metrics, maybe_gzip,
                                           wants_openmetrics)
from minio_tpu_torch.admin.profiling import Profiler
from minio_tpu_torch.admin.stats import HTTPStats
from minio_tpu_torch.bucket import objectlock as olock
from minio_tpu_torch.bucket.meta import BucketMetadataSys
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.crypto.configcrypt import SealedSysStore
from minio_tpu_torch.crypto.kes import kms_from_config
from minio_tpu_torch.erasure.autoheal import AutoHealer
from minio_tpu_torch.erasure.pools import ErasureServerPools
from minio_tpu_torch.erasure.sets import ErasureSets
from minio_tpu_torch.erasure.types import (CompletePart, DeletedObject,
                                           ObjectOptions, ObjectToDelete)
from minio_tpu_torch.event import event as evt
from minio_tpu_torch.event import new_object_event
from minio_tpu_torch.event.notifier import EventNotifier
from minio_tpu_torch.iam import reqctx
from minio_tpu_torch.iam.actions import action_for
from minio_tpu_torch.iam.condition import NormalizedContext, normalize_values, scalar_str
from minio_tpu_torch.iam.ldap import LDAPError, LDAPValidator
from minio_tpu_torch.iam.oidc import OIDCError, OpenIDValidator
from minio_tpu_torch.iam.policy import Policy, PolicyArgs
from minio_tpu_torch.iam.sys import ANONYMOUS, IAMSys
from minio_tpu_torch.logger import FileTarget, HTTPTarget, audit_entry, get_logger
from minio_tpu_torch.obs import calibration, flight, slo
from minio_tpu_torch.s3 import sigv2, sigv4, xmlutil
from minio_tpu_torch.s3.atrest import AtRest, copy_metadata
from minio_tpu_torch.s3.errors import S3Error, from_exception
from minio_tpu_torch.scanner import tiers as tiermod
from minio_tpu_torch.scanner.tracker import UpdateTracker
from minio_tpu_torch.storage.local import LocalDrive
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils.streams import IterReader

XML_TYPE = "application/xml"
MAX_OBJECT_SIZE = 5 * (1 << 40)
SPOOL_LIMIT = 32 << 20
_COPY = 1 << 20

# The query parameters of ListObjects v1 and v2. encoding-type and
# fetch-owner are accepted and ignored, as the JAX server does.
_LIST_PARAMS = frozenset({"prefix", "marker", "delimiter", "max-keys", "list-type",
                          "continuation-token", "start-after", "encoding-type",
                          "fetch-owner"})
_VERSIONS_PARAMS = frozenset({"versions", "prefix", "key-marker", "version-id-marker",
                              "delimiter", "max-keys", "encoding-type"})

_SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-XSS-Protection": "1; mode=block",
    "Content-Security-Policy": "block-all-mixed-content",
}


_DRAIN_LIMIT = 1 << 20   # unread request bytes read off before answering

# Request-path latency distributions (the JAX server's families, reference
# metrics-v2 minio_s3_requests_* / minio_s3_ttfb_seconds).
_REQ_LATENCY = obs.histogram(
    "minio_tpu_s3_requests_latency_seconds",
    "End-to-end request latency by API", ("api",))
_REQ_TTFB = obs.histogram(
    "minio_tpu_s3_ttfb_seconds",
    "Time to first response byte by API", ("api",))
# Per-tenant families (the QoS plane): tenant = the "access_key/bucket"
# key bound in dispatch, folded by qos.metric_key past its label cap.
_TENANT_LATENCY = obs.histogram(
    "minio_tpu_tenant_request_seconds",
    "End-to-end request latency by tenant", ("tenant",))
_TENANT_REQS = obs.counter(
    "minio_tpu_tenant_requests_total",
    "Requests by tenant and status class", ("tenant", "code"))

# /minio/ paths of the JAX server's web console, which the port lacks.
_WEB_PATHS = ("/minio/browser", "/minio/webrpc", "/minio/upload/",
              "/minio/download/")


# The request headers the condition context carries, under their keys
# (minio_tpu/s3/server.py:743-758).
_CONDITION_HEADERS = (
    ("x-amz-object-lock-mode", "s3:object-lock-mode"),
    ("x-amz-object-lock-retain-until-date", "s3:object-lock-retain-until-date"),
    ("x-amz-object-lock-legal-hold", "s3:object-lock-legal-hold"),
    ("x-amz-acl", "s3:x-amz-acl"),
    ("x-amz-copy-source", "s3:x-amz-copy-source"),
    ("x-amz-storage-class", "s3:x-amz-storage-class"),
    ("x-amz-metadata-directive", "s3:x-amz-metadata-directive"),
    ("x-amz-server-side-encryption", "s3:x-amz-server-side-encryption"),
    ("x-amz-server-side-encryption-aws-kms-key-id",
     "s3:x-amz-server-side-encryption-aws-kms-key-id"),
    ("x-amz-content-sha256", "s3:x-amz-content-sha256"),
)
_V2_PRESIGNED = ("REST-QUERY-STRING", "AWS")
_V2_QUERY_PARAMS = frozenset({"AWSAccessKeyId", "Expires", "Signature"})
_OBJECT_LOCK_ENABLED = (b'<ObjectLockConfiguration xmlns="http://s3.amazonaws.com/doc/'
                        b'2006-03-01/"><ObjectLockEnabled>Enabled</ObjectLockEnabled>'
                        b'</ObjectLockConfiguration>')


class _Auth:
    """How a request proved who it is: its identity, the payload hash its
    signature covers, its auth type (s3:authtype, s3:signatureversion;
    None when anonymous) and, for SigV4 header auth, the parsed header and
    the requester's credentials, which key an aws-chunked body's chain."""

    __slots__ = ("identity", "payload_hash", "type", "sig", "creds")

    def __init__(self, identity, payload_hash: str, auth_type, sig=None, creds=None):
        self.identity = identity
        self.payload_hash = payload_hash
        self.type = auth_type
        self.sig = sig
        self.creds = creds


class _Body:
    """The request body: at most `length` bytes of the connection."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self.remaining = length

    def read(self, n: int = -1) -> bytes:
        if n < 0 or n > self.remaining:
            n = self.remaining
        data = self._rfile.read(n) if n else b""
        self.remaining -= len(data)
        return data


class _Response:
    """An answer; `length` None with an iterator body sends it chunked
    (the trace stream)."""

    def __init__(self, status: int, headers: dict, body=b"", length: int | None = None):
        self.status = status
        self.headers = headers
        self.body = body                       # bytes, or an iterator of chunks
        self.length = (len(body) if length is None and isinstance(body, (bytes, bytearray))
                       else length)


class _Request:
    """One request's accounting: its API once dispatch has classified it,
    the moment its answer's headers flushed, whether it has left the
    in-flight count, and the end of its accounting, done at most once."""

    __slots__ = ("id", "method", "path", "remote", "api", "t0", "ttfb", "rx",
                 "left", "done", "tenant", "access_key", "query", "headers")

    def __init__(self, request_id: str, method: str, path: str, remote: str, rx: int):
        self.id = request_id
        self.method = method
        self.path = path
        self.remote = remote
        self.api = ""
        self.t0 = 0.0
        self.ttfb: float | None = None
        self.rx = rx
        self.left = False
        self.done = False
        self.tenant = ""
        self.access_key = ""     # the authenticated identity's (audit, events)
        self.query = ""          # the raw query string (audit)
        self.headers = None      # the request headers (audit)


def _int_q(q: dict, name: str, default: int, lo: int = 0, hi: int = 100_000) -> int:
    raw = q.get(name)
    if raw in (None, ""):
        return default
    try:
        v = int(raw)
    except ValueError:
        raise S3Error("InvalidArgument", f"invalid {name}") from None
    if not lo <= v <= hi:
        raise S3Error("InvalidArgument", f"{name} out of range")
    return v


class S3Server:
    """The S3 handlers over an object layer (ErasureServerPools,
    ErasureSets or one ErasureObjects), bound to an address unless
    `listen` is False (the front door's workers)."""

    def __init__(self, obj, creds: sigv4.Credentials,
                 address: str = "127.0.0.1:0", versioned_buckets: bool = False,
                 listen: bool = True, notification_sys=None):
        """notification_sys: a cluster node's peer fan-out (dist/peer.py
        NotificationSys): bucket-document and IAM writes tell the peers,
        and the cluster scrape, trace and perf/timeline federate."""
        self.obj = obj
        self.creds = creds
        # Every bucket versioned (a server-wide default), else each
        # bucket's own metadata document decides.
        self.versioned_buckets = versioned_buckets
        self.notification = notification_sys
        self.cluster_node = None   # set by attach_cluster
        self.local_locker = None   # the node's dsync locker (force-unlock)
        self.bucket_meta = BucketMetadataSys(
            obj, notify=(notification_sys.invalidate_bucket_metadata
                         if notification_sys is not None else None))
        # Config and IAM are sealed at rest under the root secret; bucket
        # metadata stays plain, as in the JAX server
        # (minio_tpu/s3/server.py:166-203). IAM refuses to load when every
        # sealed entry fails to decrypt (a wrong root secret).
        self.config = ConfigSys(SealedSysStore(obj, creds.secret_key))
        self.iam = IAMSys(creds.access_key, creds.secret_key,
                          store=SealedSysStore(obj, creds.secret_key),
                          notify=(notification_sys.reload_iam
                                  if notification_sys is not None else None))
        self.kms = kms_from_config(self.config)
        self.atrest = AtRest(obj, creds, self.config, self.kms, self.bucket_meta)
        self.apply_storage_class_config()
        # The background plane (minio_tpu/s3/server.py:213-298): event
        # targets with durable queues under MTPU_EVENT_QUEUE_DIR (else a
        # directory of this server's own under the temp dir), the update
        # tracker the scanner reads, the process logger with this
        # server's log and audit targets, and the ILM tiers, whose
        # documents carry remote credentials and are sealed like config.
        queue_dir = os.environ.get("MTPU_EVENT_QUEUE_DIR") or os.path.join(
            tempfile.gettempdir(), f"mtpu-torch-events-{os.getpid()}-{id(self):x}")
        self.notifier = EventNotifier(queue_dir=queue_dir)
        self._rules_loaded: set = set()
        self._event_targets_cfg = ""
        self.region = "us-east-1"
        self.scanner = None
        self.update_tracker = UpdateTracker(obj)
        self.logger = get_logger()
        self._log_targets: list = []    # the log targets this server installed
        self._audit_targets: list = []  # and the audit targets
        self.configure_logging()
        self.configure_event_targets()
        self.tiers = tiermod.TierRegistry(SealedSysStore(obj, creds.secret_key))
        tiermod.set_global(self.tiers)
        host, _, port = address.rpartition(":")
        self.httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), _Handler,
                                         bind_and_activate=listen)
        self.httpd.daemon_threads = True
        self.httpd.s3 = self
        # Callables fn(headers) run on every answer's headers before they
        # are sent (the front door stamps its worker id here).
        self.on_response: list = []
        self._thread: threading.Thread | None = None
        self.auto_healer: list = []
        self.stats = HTTPStats()
        self.admin = AdminAPI(self)
        self.profiler = Profiler()
        self.closing = threading.Event()   # ends the trace streams
        # The SLO plane (minio_tpu/s3/server.py:301-311): the build-info
        # gauge, the metric ring and burn-rate engine (none under
        # MTPU_SLO=0) with its coarse history persisted through the sys
        # store, and the per-API counters, which live in HTTPStats, fed to
        # the ring under a key a rebuilt server replaces.
        calibration.publish_build_info()
        engine = slo.ensure_started(
            store=obj if hasattr(obj, "read_sys_config") else None)
        if engine is not None:
            engine.db.add_source(self._slo_stats_source, key="s3-stats")

    @property
    def current_requests(self) -> int:
        """Requests being answered: the AutoHealer's foreground load."""
        return self.stats.current_requests

    def cluster_scrape(self, openmetrics: bool = False) -> bytes:
        """This node's cluster collectors, and on a cluster node every
        peer's node scrape under a `server` label."""
        if self.notification is None:
            return collect_metrics(self.obj, self.stats, openmetrics=openmetrics)
        node = self.cluster_node
        return collect_cluster_metrics(self.obj, self.stats,
                                       notification=self.notification,
                                       local_name=(node.node_name if node is not None
                                                   else obs.current_node()),
                                       openmetrics=openmetrics)

    def _slo_stats_source(self):
        """The ring's source of the per-API request, error and 5xx
        counters (obs/tsdb.py add_source)."""
        snap = self.stats.snapshot()
        for api, st in snap["apis"].items():
            lbl = {"api": api}
            yield "minio_tpu_s3_requests_total", lbl, st["count"]
            yield "minio_tpu_s3_requests_errors_total", lbl, st["errors"]
            yield "minio_tpu_s3_requests_5xx_errors_total", lbl, st["5xx"]

    def attach_cluster(self, node) -> None:
        """Wire a cluster node (dist/cluster.py ClusterNode) into this
        server, as the JAX server's attach_cluster does
        (minio_tpu/s3/server.py:448-482): the node's name on trace
        records, its dsync locker for force-unlock and top/locks, and the
        peer hooks through which the other nodes invalidate this node's
        bucket documents, reload its IAM and pull its scrape, trace,
        server info, profiles and perf timelines."""
        self.cluster_node = node
        self.notification = node.notification
        self.local_locker = node.locker
        obs.set_default_node(node.node_name)
        hooks = node.hooks
        hooks.on_bucket_metadata_invalidate = self.bucket_meta.invalidate
        hooks.on_iam_reload = self.iam.reload
        hooks.trace_bus = obs.trace_bus()
        hooks.console_bus = self.logger.console_bus
        hooks.server_info = self.admin._server_info
        hooks.profiler = self.profiler
        hooks.perf_timeline = self.admin._perf_timelines
        hooks.metrics = lambda: collect_node_metrics(self.stats)
        # The federated GET /minio/admin/v3/slo pulls this node's
        # worker-merged burn-rate state.
        hooks.slo = slo.collect_local

    def apply_storage_class_config(self) -> None:
        """Parse storageclass.standard / rrs ("EC:N") and stamp the parity
        map on every erasure set as sc_parity, which parity_for_class reads
        (the JAX server's, minio_tpu/s3/server.py:372-410; applied again
        by every config-kv PUT of `storageclass`)."""
        sc_map = {}
        for key, name in (("standard", "STANDARD"), ("rrs", "RRS")):
            value = (self.config.get("storageclass", key) or "").strip().upper()
            if value.startswith("EC:") and value[3:].isdigit():
                sc_map[name] = int(value[3:])
        stack = [self.obj]
        while stack:
            node = stack.pop()
            for attr in ("pools", "sets"):
                stack.extend(getattr(node, attr, None) or [])
            if hasattr(node, "parity_for_class"):
                node.sc_parity = dict(sc_map)

    def start_scanner(self, interval: float = 60.0, heal_objects: bool = True,
                      loop: bool = True) -> None:
        """Build the data scanner (minio_tpu/s3/server.py:411-424; reference
        initDataScanner, cmd/data-scanner.go:65) and, unless `loop` is
        False, start its cycle every `interval` seconds (the live
        scanner.cycle key overrides it once an operator sets it). With
        loop=False the caller drives scanner.scan_once() itself."""
        from minio_tpu_torch.scanner import DataScanner

        self.scanner = DataScanner(self.obj, self.bucket_meta, notifier=self.notifier,
                                   interval=interval, heal_objects=heal_objects,
                                   tracker=self.update_tracker, config=self.config)
        if loop:
            self.scanner.start()

    def configure_logging(self) -> None:
        """(Re)build the log and audit targets from config
        (minio_tpu/s3/server.py:483-510): logger_webhook, audit_webhook
        (enable, endpoint, auth_token) and audit_file (path). The targets
        this server installed before are closed and taken off the
        process logger; the console target stays first."""
        on = ("on", "1", "true")
        log_targets: list = []
        audit_targets: list = []
        if (self.config.get("logger_webhook", "enable") or "") in on:
            ep = self.config.get("logger_webhook", "endpoint") or ""
            if ep:
                log_targets.append(HTTPTarget(
                    ep, self.config.get("logger_webhook", "auth_token") or ""))
        if (self.config.get("audit_webhook", "enable") or "") in on:
            ep = self.config.get("audit_webhook", "endpoint") or ""
            if ep:
                audit_targets.append(HTTPTarget(
                    ep, self.config.get("audit_webhook", "auth_token") or ""))
        audit_path = self.config.get("audit_file", "path") or ""
        if audit_path:
            audit_targets.append(FileTarget(audit_path))
        self._drop_log_targets()
        self.logger.targets = self.logger.targets + log_targets
        self.logger.audit_targets = self.logger.audit_targets + audit_targets
        self._log_targets, self._audit_targets = log_targets, audit_targets

    def _drop_log_targets(self) -> None:
        """Close this server's log and audit targets (each webhook holds a
        drain thread) and take them off the process logger."""
        mine = self._log_targets + self._audit_targets
        for t in mine:
            close = getattr(t, "close", None)
            if close is not None:
                close()
        self.logger.targets = [t for t in self.logger.targets if t not in mine]
        self.logger.audit_targets = [t for t in self.logger.audit_targets
                                     if t not in mine]
        self._log_targets, self._audit_targets = [], []

    def configure_event_targets(self) -> None:
        """(Re)apply the notification targets of the notify_* config
        subsystems (minio_tpu/s3/server.py:512-629): enabled targets
        register, changed ones are replaced, disabled ones unregister. A
        target whose config cannot build one logs the error and is
        skipped; the server still starts."""
        from minio_tpu_torch.event import targets as tg

        subsys_keys = {
            "notify_webhook": ("enable", "endpoint", "auth_token"),
            "notify_nats": ("enable", "address", "subject"),
            "notify_redis": ("enable", "address", "key", "password", "format"),
            "notify_mqtt": ("enable", "address", "topic"),
            "notify_elasticsearch": ("enable", "url", "index"),
            "notify_nsq": ("enable", "address", "topic"),
            "notify_kafka": ("enable", "brokers", "topic"),
            "notify_amqp": ("enable", "url", "exchange", "routing_key",
                            "user", "password", "vhost"),
            "notify_postgres": ("enable", "address", "table", "user",
                                "password", "database"),
            "notify_mysql": ("enable", "address", "table", "user",
                             "password", "database"),
        }
        cfg = {sub: {k: self.config.get(sub, k) or "" for k in keys}
               for sub, keys in subsys_keys.items()}
        sig = json.dumps(cfg, sort_keys=True)
        if sig == self._event_targets_cfg:
            return
        self._event_targets_cfg = sig

        def on(sub):
            return cfg[sub]["enable"] in ("on", "1", "true")

        factories = []
        if on("notify_webhook") and cfg["notify_webhook"]["endpoint"]:
            c = cfg["notify_webhook"]
            factories.append(lambda c=c: tg.WebhookTarget(c["endpoint"],
                                                          auth_token=c["auth_token"]))
        if on("notify_nats") and cfg["notify_nats"]["address"]:
            c = cfg["notify_nats"]
            factories.append(lambda c=c: tg.NATSTarget(c["address"], c["subject"]))
        if on("notify_redis") and cfg["notify_redis"]["address"]:
            c = cfg["notify_redis"]
            factories.append(lambda c=c: tg.RedisTarget(
                c["address"], c["key"], password=c["password"],
                publish=c["format"] == "channel"))
        if on("notify_mqtt") and cfg["notify_mqtt"]["address"]:
            c = cfg["notify_mqtt"]
            factories.append(lambda c=c: tg.MQTTTarget(c["address"], c["topic"]))
        if on("notify_elasticsearch") and cfg["notify_elasticsearch"]["url"]:
            c = cfg["notify_elasticsearch"]
            factories.append(lambda c=c: tg.ElasticsearchTarget(c["url"], c["index"]))
        if on("notify_nsq") and cfg["notify_nsq"]["address"]:
            c = cfg["notify_nsq"]
            factories.append(lambda c=c: tg.NSQTarget(c["address"], c["topic"]))
        if on("notify_kafka") and cfg["notify_kafka"]["brokers"]:
            c = cfg["notify_kafka"]
            factories.append(lambda c=c: tg.KafkaTarget(c["brokers"], c["topic"]))
        if on("notify_amqp") and cfg["notify_amqp"]["url"]:
            c = cfg["notify_amqp"]
            factories.append(lambda c=c: tg.AMQPTarget(
                c["url"], c["exchange"], c["routing_key"], user=c["user"],
                password=c["password"], vhost=c["vhost"]))
        for sub, cls in (("notify_postgres", tg.PostgresTarget),
                         ("notify_mysql", tg.MySQLTarget)):
            c = cfg[sub]
            if on(sub) and c["address"] and c["table"]:
                factories.append(lambda c=c, cls=cls: cls(
                    c["address"], c["table"], user=c["user"], password=c["password"],
                    database=c["database"]))
        targets = []
        for factory in factories:
            try:
                targets.append(factory())
            except (ValueError, OSError, KeyError) as e:
                self.logger.error(f"event target config invalid: {e}")
        # Replace-or-remove over the config-managed ARN space.
        managed_kinds = ("webhook", "nats", "redis", "mqtt", "elasticsearch", "nsq",
                         "kafka", "amqp", "postgresql", "mysql")
        want = {t.arn: t for t in targets}
        for arn in list(self.notifier.target_arns):
            if arn.rsplit(":", 1)[-1] in managed_kinds and arn not in want:
                self.notifier.unregister_target(arn)
        for arn, t in want.items():
            if arn in self.notifier.target_arns:
                self.notifier.unregister_target(arn)   # config changed
            self.notifier.register_target(t)

    def _ensure_rules(self, bucket: str) -> None:
        """Load a bucket's stored notification rules once
        (minio_tpu/s3/server.py:2378-2387)."""
        if bucket in self._rules_loaded:
            return
        self._rules_loaded.add(bucket)
        xml_cfg = self.bucket_meta.get(bucket).notification_xml
        if xml_cfg:
            try:
                self.notifier.set_bucket_rules(bucket, xml_cfg)
            except ValueError:
                pass   # the stored rules name a target gone from config

    def _emit(self, req: "_Request", event_name: str, bucket: str, key: str,
              size: int = 0, etag: str = "", version_id: str = "") -> None:
        """Send one S3 event to the bucket's matching targets
        (minio_tpu/s3/server.py:2389-2399)."""
        self._ensure_rules(bucket)
        if not self.notifier.has_rules(bucket):
            return
        self.notifier.send(new_object_event(
            event_name, bucket, key, size=size, etag=etag, version_id=version_id,
            user=req.access_key or "anonymous", host=req.remote or "",
            region=self.region))

    def _client_ip(self, headers, remote: str) -> str:
        """The requester's address for the condition context and audit
        records (minio_tpu/s3/server.py:987-1000): X-Forwarded-For's
        leftmost hop, else X-Real-IP, only when api.trust_proxy_headers is
        on; they are client-spoofable otherwise."""
        if (self.config.get("api", "trust_proxy_headers") or "") in ("on", "1", "true"):
            fwd = headers.get("X-Forwarded-For", "")
            if fwd:
                return fwd.split(",")[0].strip()
            real = headers.get("X-Real-IP", "")
            if real:
                return real.strip()
        return remote or ""

    def start_auto_heal(self, interval: float = 10.0) -> None:
        """Start the background drive healer (reference initAutoHeal,
        cmd/background-newdisks-heal-ops.go:241): one AutoHealer per pool,
        each pass claiming blank drives live and rebuilding every drive that
        carries a healing tracker, paced by config heal.max_sleep and
        heal.max_io against the requests in flight."""
        pools = getattr(self.obj, "pools", None) or [self.obj]
        self.auto_healer = [AutoHealer(p, interval=interval, config=self.config,
                                       load_fn=lambda: self.current_requests)
                            for p in pools]
        for h in self.auto_healer:
            h.start()

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def adopt(self, conn, addr=None) -> None:
        """Serve one connection accepted elsewhere (the front door's
        router passes it over a Unix socket), on a thread of its own."""
        self.httpd.process_request(conn, addr or conn.getpeername())

    def serve_socket(self, sock) -> "S3Server":
        """Serve a listening socket opened elsewhere (the front door's
        SO_REUSEPORT listener) in a background daemon thread."""
        self.httpd.socket.close()
        self.httpd.socket = sock
        self.httpd.server_address = sock.getsockname()
        return self.start()

    def stop_accepting(self) -> None:
        """End the listener's serve loop (no new connection); the requests
        in flight go on in their threads."""
        if self._thread is not None:
            self.httpd.shutdown()

    def start(self) -> "S3Server":
        """Serve in a background daemon thread."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="s3-serve")
        self._thread.start()
        return self

    def close(self) -> None:
        """Stop serving, then the background plane (the scanner, the event
        delivery workers, this server's log targets) and the healers,
        before the object layer."""
        self.closing.set()
        if self.profiler.running:
            self.profiler.stop_collect()
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join()
        self.httpd.server_close()
        if self.scanner is not None:
            self.scanner.close()
        self.notifier.close()
        self._drop_log_targets()
        if tiermod.global_registry() is self.tiers:
            tiermod.set_global(None)
        engine = slo.engine()
        if engine is not None:
            engine.db.detach_store(self.obj)
        for h in self.auto_healer:
            h.close()
        if self.cluster_node is not None:
            self.cluster_node.close()   # its object layer, fabric and WALs
            return
        close = getattr(self.obj, "close", None)
        if close is not None:
            close()   # the metacache renderer and the MRF threads

    def _lookup(self, access_key: str):
        """The credentials of any identity IAM knows (the root, a user, a
        service account, a temporary credential), or None."""
        try:
            return sigv4.Credentials(access_key, self.iam.get_secret(access_key))
        except se.InvalidAccessKey:
            return None

    def _versioned(self, meta) -> bool:
        """Whether a bucket with metadata document `meta` is versioned: by
        the server-wide default, else by its own document."""
        return self.versioned_buckets or meta.versioning_enabled

    # ------------------------------------------------------------------

    def _authenticate(self, method, path, query_items, q, headers) -> "_Auth":
        """Classify and verify the request's signature in the JAX server's
        order (minio_tpu/s3/server.py:1082-1117; reference
        cmd/auth-handler.go:102): presigned SigV4, SigV4 header, SigV2
        header, presigned SigV2, else anonymous. Raises on a bad one."""
        if "X-Amz-Signature" in q:
            creds = sigv4.verify_presigned(method, path, query_items, headers,
                                           self._lookup)
            # A content binding the signer pinned in the signed query, else
            # anyone holding the URL could upload any bytes.
            return _Auth(self.iam.identify(creds.access_key),
                         q.get("X-Amz-Content-Sha256", sigv4.UNSIGNED_PAYLOAD),
                         ("REST-QUERY-STRING", "AWS4-HMAC-SHA256"))
        if headers.get("Authorization", "").startswith(sigv4.ALGORITHM):
            creds, payload_hash = sigv4.verify_header_auth(method, path, query_items,
                                                           headers, self._lookup)
            return _Auth(self.iam.identify(creds.access_key), payload_hash,
                         ("REST-HEADER", "AWS4-HMAC-SHA256"),
                         sigv4.parse_auth_header(headers["Authorization"]), creds)
        if sigv2.is_v2_header(headers):
            creds = sigv2.verify_header_auth(method, path, query_items, headers,
                                             self._lookup)
            return _Auth(self.iam.identify(creds.access_key), sigv4.UNSIGNED_PAYLOAD,
                         ("REST-HEADER", "AWS"))
        if sigv2.is_v2_presigned(q):
            creds = sigv2.verify_presigned(method, path, query_items, headers,
                                           self._lookup)
            return _Auth(self.iam.identify(creds.access_key), sigv4.UNSIGNED_PAYLOAD,
                         _V2_PRESIGNED)
        return _Auth(ANONYMOUS, sigv4.UNSIGNED_PAYLOAD, None)

    def _condition_context(self, identity, headers, q: dict | None, remote: str,
                           auth_type) -> dict:
        """The request's condition values (the JAX server's
        _condition_context, minio_tpu/s3/server.py:673-762; reference
        getConditionValues, cmd/bucket-policy.go:65-110): every authorized
        request carries a populated context, so a conditioned Deny
        evaluates against real values. Keys lowercase, values string
        lists. The port serves plain HTTP: aws:SecureTransport is true only
        behind a trusted proxy that says https."""
        now = time.time()
        secure = False
        if (self.config.get("api", "trust_proxy_headers") or "") in ("on", "1", "true"):
            fwd_proto = headers.get("X-Forwarded-Proto", "")
            if fwd_proto:
                secure = fwd_proto.split(",")[0].strip().lower() == "https"
        source_ip = self._client_ip(headers, remote)
        ctx: dict[str, list[str]] = {
            "aws:sourceip": [source_ip],
            "aws:securetransport": ["true" if secure else "false"],
            "aws:currenttime": [time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(now))],
            "aws:epochtime": [str(int(now))],
        }
        for hk, ck in (("User-Agent", "aws:useragent"), ("Referer", "aws:referer")):
            if headers.get(hk, ""):
                ctx[ck] = [headers[hk]]
        if identity.kind == "anonymous":
            ctx["aws:principaltype"] = ["Anonymous"]
        else:
            ctx["aws:principaltype"] = [{"root": "Account",
                                         "sts": "AssumedRole"}.get(identity.kind, "User")]
            # Usernames are access keys; temporary and service credentials
            # report their owning user (cmd/iam.go policy variables).
            ctx["aws:username"] = [identity.parent or identity.access_key]
            ctx["aws:userid"] = [identity.access_key]
        if auth_type:
            ctx["s3:authtype"] = [auth_type[0]]
            ctx["s3:signatureversion"] = [auth_type[1]]
        for ck, cv in identity.claims.items():
            lk = str(ck).lower()
            if lk.startswith(("jwt:", "ldap:")):
                ctx[lk] = [str(cv)]
        if q:
            if q.get("versionId"):
                ctx["s3:versionid"] = [q["versionId"]]
            # Listing scope keys only when the client sent them.
            for qk, ck in (("prefix", "s3:prefix"), ("delimiter", "s3:delimiter"),
                           ("max-keys", "s3:max-keys")):
                if qk in q:
                    ctx[ck] = [q[qk]]
        for hk, ck in _CONDITION_HEADERS:
            hv = headers.get(hk, "")
            if hv:
                ctx[ck] = [hv]
        return normalize_values(ctx)

    def _check_access(self, identity, action: str, bucket: str, key: str,
                      conditions: dict, policy_json: bytes) -> None:
        """Authorize (the JAX server's _check_access,
        minio_tpu/s3/server.py:764-790; reference cmd/auth-handler.go:274):
        a Deny of the bucket policy `policy_json` (the bucket's document,
        read once by the caller) beats every identity, the root included;
        then an Allow of the bucket policy (the anonymous principal too);
        then the identity's own policies."""
        if policy_json:
            bp = Policy.parse_cached(policy_json)
            bargs = PolicyArgs(action=action, bucket=bucket, object=key,
                               conditions=conditions,
                               account=identity.access_key or "*")
            for st in bp.statements:
                if st.effect == "Deny" and st.applies(bargs):
                    raise S3Error("AccessDenied", resource=f"/{bucket}/{key}")
            if bp.is_allowed(bargs):
                return
        if self.iam.is_allowed(identity, PolicyArgs(action=action, bucket=bucket,
                                                    object=key, conditions=conditions)):
            return
        raise S3Error("AccessDenied", resource=f"/{bucket}/{key}")

    def dispatch(self, method: str, path: str, query_items, headers,
                 body: _Body, req: _Request) -> _Response:
        hdr = {"x-amz-request-id": req.id, **_SECURITY_HEADERS}
        q = dict(query_items)
        if path.startswith("/minio/health/"):
            req.api = "healthcheck"
            return self._health(path, q)
        auth = self._authenticate(method, path, query_items, q, headers)
        identity = auth.identity
        req.access_key = identity.access_key or ""
        # The tenant, bound once here beside the trace id (the handler
        # resets it when the request ends). The /minio/ planes stay on the
        # unattributed lane: only the exact reserved segment, so a bucket
        # merely named "minio-..." is a tenant like any other.
        tpath = path.lstrip("/").split("/", 1)[0]
        if tpath != "minio":
            qos.bind(identity.access_key or "anonymous", tpath)
            req.tenant = qos.current_key()
            flight.set_tenant(req.tenant)
        flight.mark("auth")
        # Temporary credentials present their session token too
        # (cmd/auth-handler.go getSessionToken).
        if identity.kind == "sts" and not self.iam.verify_session_token(
                identity.access_key, headers.get("x-amz-security-token", "")
                or q.get("X-Amz-Security-Token", "")):
            raise S3Error("InvalidToken")
        # The auth parameters of a presigned URL are no subresource.
        q = {k: v for k, v in q.items() if not k.startswith("X-Amz-")
             and not (auth.type == _V2_PRESIGNED and k in _V2_QUERY_PARAMS)}
        if path.startswith("/minio/"):
            reqctx.set_condition_context(self._condition_context(
                identity, headers, None, req.remote, auth.type))
            return self._minio_plane(method, path, q, headers, body, auth, req)
        bucket, _, key = path.lstrip("/").partition("/")
        if not bucket:
            req.api = "ListAllMyBuckets"
            if method == "POST":   # STS rides the root path (sts-handlers.go)
                return self._sts(headers, body, auth, hdr)
            if method == "GET":
                if identity.kind == "anonymous":
                    raise S3Error("AccessDenied", resource=path)
                buckets = self.obj.list_buckets()
                if not identity.is_owner:
                    cond = self._condition_context(identity, headers, q, req.remote,
                                                   auth.type)
                    buckets = [b for b in buckets if self.iam.is_allowed(
                        identity, PolicyArgs(action="s3:ListBucket", bucket=b.name,
                                             conditions=cond))]
                return _xml(hdr, xmlutil.list_buckets_xml(buckets))
            raise S3Error("MethodNotAllowed", resource=path)
        post_form = (method == "POST" and not key and headers.get(
            "Content-Type", "").startswith("multipart/form-data"))
        action = action_for(method, set(q), bucket, key, headers)
        req.api = "PostPolicy" if post_form else action.split(":", 1)[-1]
        bulk_delete = method == "POST" and not key and "delete" in q
        cond = self._condition_context(identity, headers, q, req.remote, auth.type)
        meta = self.bucket_meta.get(bucket)
        if not post_form and not bulk_delete:
            # A browser POST authenticates by its signed policy document and
            # a bulk delete authorizes each key: both check in the handler.
            self._check_access(identity, action, bucket, key, cond, meta.policy_json)
        if not key:
            return self._bucket_call(method, path, bucket, q, headers, body, auth,
                                     hdr, cond, post_form, req, meta)
        # S3's literal versionId "null" names the null version; it goes
        # down verbatim, so it never means "latest".
        opts = ObjectOptions(version_id=q.get("versionId", ""),
                             versioned=self._versioned(meta))
        if "tagging" in q:
            return self._tagging(method, bucket, key, opts, headers, body, auth, hdr)
        if "retention" in q or "legal-hold" in q:
            return self._object_lock(method, bucket, key, q, opts, headers, body,
                                     auth, hdr)
        if method == "POST" and "restore" in q:
            # RestoreObject (minio_tpu/s3/server.py:1476-1490): the version's
            # data back from its tier through the PUT path (K1, K2).
            req.api = "RestoreObject"
            self._check_access(identity, "s3:RestoreObject", bucket, key, cond,
                               meta.policy_json)
            self.obj.restore_transitioned(bucket, key, opts.version_id)
            return _Response(202, hdr)
        if "versionId" in q and method in ("PUT", "POST"):
            # Versions are immutable: no write names the version it makes
            # (the JAX server would give the new version the client's id,
            # and so replace that version's data).
            raise S3Error("InvalidArgument", "a write takes no versionId")
        if "uploads" in q or "uploadId" in q:
            return self._multipart(method, bucket, key, q, headers, body,
                                   auth, hdr, opts, req)
        if q.keys() - {"versionId"}:
            raise S3Error("NotImplemented")
        if method == "PUT":
            src = headers.get("x-amz-copy-source")
            if src:
                return self._copy_object(bucket, key, src, opts, headers, hdr)
            return self._put_object(bucket, key, opts, headers, body, auth, hdr, req)
        if method == "GET":
            return self._get_object(bucket, key, opts, headers, hdr)
        if method == "HEAD":
            info = self.obj.get_object_info(bucket, key, opts)
            if info.delete_marker:
                raise S3Error("MethodNotAllowed", resource=path,
                              headers={"x-amz-delete-marker": "true",
                                       "x-amz-version-id": info.version_id})
            self.atrest.check_key(headers, bucket, key, info)
            if _check_conditional(method, headers, info):
                return _Response(304, {**hdr, "ETag": f'"{info.etag}"'}, b"", 0)
            return _Response(200, {**hdr, **_object_headers(info)}, b"",
                             AtRest.visible_size(info))
        if method == "DELETE":
            if opts.version_id:
                # Destroying a version: the WORM check first
                # (cmd/bucket-object-lock.go enforceRetentionForDeletion).
                self._check_worm(bucket, key, opts, headers)
            info = self.obj.delete_object(bucket, key, opts)
            extra = {}
            if info.delete_marker:
                extra["x-amz-delete-marker"] = "true"
            if info.version_id:
                extra["x-amz-version-id"] = info.version_id
            self.update_tracker.mark(bucket)
            self._emit(req, evt.OBJECT_REMOVED_DELETE_MARKER if info.delete_marker
                       else evt.OBJECT_REMOVED_DELETE, bucket, key,
                       version_id=info.version_id)
            return _Response(204, {**hdr, **extra})
        raise S3Error("MethodNotAllowed", resource=path)

    def _check_worm(self, bucket, key, opts, headers, missing_ok: bool = True) -> None:
        """AccessDenied when the version is under legal hold or an
        unexpired retention (GOVERNANCE yields to
        x-amz-bypass-governance-retention: true). With `missing_ok` a
        version that cannot be read passes: the delete that follows
        answers for it."""
        try:
            info = self.obj.get_object_info(bucket, key, opts)
        except Exception:  # noqa: BLE001 - the delete reports a missing version
            if not missing_ok:
                raise
            return
        try:
            olock.check_worm(info.user_defined, bypass_governance=headers.get(
                "x-amz-bypass-governance-retention", "").lower() == "true")
        except olock.WORMProtected as e:
            raise S3Error("AccessDenied", str(e)) from None

    def _bucket_call(self, method, path, bucket, q, headers, body: _Body, auth,
                     hdr, cond, post_form: bool, req: _Request, meta) -> _Response:
        """The calls on a bucket, its subresources and the browser POST
        (`meta`: the bucket's metadata document as dispatch read it)."""
        if "versioning" in q:
            return self._versioning(method, bucket, headers, body, auth, hdr)
        if "policy" in q:
            return self._bucket_policy(method, bucket, headers, body, auth, hdr)
        if "object-lock" in q:
            return self._bucket_object_lock(method, bucket, headers, body, auth, hdr)
        if "lifecycle" in q:
            return self._bucket_lifecycle(method, bucket, headers, body, auth, hdr)
        if "notification" in q:
            return self._bucket_notification(method, bucket, headers, body, auth, hdr)
        if method == "GET" and "versions" in q and q.keys() <= _VERSIONS_PARAMS:
            res = self.obj.list_object_versions(
                bucket, q.get("prefix", ""), q.get("key-marker", ""),
                q.get("version-id-marker", ""), q.get("delimiter", ""),
                _int_q(q, "max-keys", 1000))
            return _xml(hdr, xmlutil.list_versions_xml(bucket, q.get("prefix", ""), res))
        if method == "GET" and "uploads" in q:
            uploads = self.obj.list_multipart_uploads(
                bucket, q.get("prefix", ""), _int_q(q, "max-uploads", 1000))
            return _xml(hdr, xmlutil.list_uploads_xml(bucket, uploads))
        if method == "POST" and "delete" in q:
            return self._delete_objects(bucket, headers, body, auth, hdr, cond, meta)
        if post_form and not q:
            return self._post_policy_upload(bucket, headers, body, hdr, req)
        if method == "GET" and q.keys() <= _LIST_PARAMS:
            return self._list_objects(bucket, q, hdr)
        if "encryption" in q:
            return self._bucket_encryption(method, bucket, headers, body, auth, hdr)
        if q:
            raise S3Error("NotImplemented")
        if method == "PUT":
            self.obj.make_bucket(bucket)
            changes = {"created": time.time()}
            if headers.get("x-amz-bucket-object-lock-enabled", "").lower() == "true":
                # Object lock requires versioning (S3 semantics).
                changes.update(versioning_status="Enabled",
                               object_lock_xml=_OBJECT_LOCK_ENABLED)
            self.bucket_meta.update(bucket, **changes)
            return _Response(200, {**hdr, "Location": f"/{bucket}"})
        if method == "HEAD":
            self.obj.get_bucket_info(bucket)
            return _Response(200, hdr)
        if method == "DELETE":
            self.obj.delete_bucket(bucket)
            self.bucket_meta.drop_bucket(bucket)
            return _Response(204, hdr)
        raise S3Error("NotImplemented")

    def _health(self, path: str, q: dict) -> _Response:
        """The unsigned probes (the JAX server's, minio_tpu/s3/server.py:
        1012-1102): live answers while the process does; ready and cluster
        answer 200 while every set keeps write quorum, and with
        ?maintenance=true while every set would keep it with one more
        drive down; on a cluster node, 503 also while it reaches only a
        strict minority of the nodes."""
        kind = path.rsplit("/", 1)[-1]
        if kind == "live":
            return _Response(200, {})
        if kind not in ("ready", "cluster"):
            raise S3Error("MethodNotAllowed", resource=path)
        h = self.obj.health()
        sets = h.get("sets") or [s for p in h.get("pools", []) for s in p.get("sets", [])]
        healthy = bool(h.get("healthy"))
        if q.get("maintenance", "").lower() in ("true", "1", "yes") and sets:
            healthy = all(s.get("online", 0) >= s.get("write_quorum", 0) + 1
                          for s in sets)
        headers = {}
        node = self.cluster_node
        if node is not None and node.peer_nodes:
            # A node that reaches only a strict minority of the cluster
            # (open peer breakers) is on the minority side of a partition:
            # 503, so a balancer drains it. An even split stays up.
            fabric = node.peer_fabric_info()
            open_peers = sum(1 for p in fabric if p["state"] == "open")
            total = len(fabric) + 1
            reachable = total - open_peers
            if reachable * 2 < total:
                healthy = False
            headers["X-Minio-Peers-Online"] = str(reachable - 1)
            headers["X-Minio-Peers-Offline"] = str(open_peers)
        if sets:
            headers["X-Minio-Write-Quorum"] = str(max(s.get("write_quorum", 0)
                                                      for s in sets))
            headers["X-Minio-Server-Status"] = "online" if healthy else "degraded"
        return _Response(200 if healthy else 503, headers)

    def _minio_plane(self, method, path, q, headers, body: _Body, auth,
                     req: _Request) -> _Response:
        """The /minio/ namespace: the admin plane and the scrapes, each
        authorized by its admin:* action (admin/handlers.py); never a
        bucket named minio."""
        if path.startswith(ADMIN_PREFIX):
            rest = path[len(ADMIN_PREFIX):]
            req.api = "admin." + rest.split("/", 1)[0]
            status, hdr, out = self.admin.handle(
                method, rest, q, headers,
                lambda: _with_body(headers, body, auth, lambda data, size: data.read()),
                auth.identity)
            return _Response(status, {"x-amz-request-id": req.id, **hdr}, out)
        if path.startswith(_WEB_PATHS):
            raise S3Error("NotImplemented", "the web console is not served")
        if path in ("/minio/v2/metrics/cluster", "/minio/v2/metrics/node"):
            req.api = "metrics"
            self.admin.authorize(auth.identity, "admin:Prometheus")
            om = wants_openmetrics(headers.get("Accept"))
            out = (self.cluster_scrape(om) if path.endswith("/cluster")
                   else collect_node_metrics(self.stats, openmetrics=om))
            out, enc = maybe_gzip(out, headers.get("Accept-Encoding"))
            hdr = {"Content-Type": OPENMETRICS_CONTENT_TYPE if om else PROM_CONTENT_TYPE}
            if enc:
                hdr["Content-Encoding"] = enc
            return _Response(200, {"x-amz-request-id": req.id, **hdr}, out)
        raise S3Error("MethodNotAllowed", resource=path)

    def _bucket_policy(self, method, bucket, headers, body: _Body, auth,
                       hdr) -> _Response:
        """?policy PUT, GET and DELETE (minio_tpu/s3/server.py:1797-1815):
        the JSON document stored verbatim in the bucket's metadata once it
        validates and every statement names a Principal."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            if any(st.principals is None for st in Policy.parse(raw).statements):
                raise S3Error("MalformedPolicy", "bucket policy requires Principal")
            self.bucket_meta.update(bucket, policy_json=raw)   # validates
            return _Response(204, hdr)
        if method == "GET":
            raw = self.bucket_meta.get(bucket).policy_json
            if not raw:
                raise S3Error("NoSuchBucketPolicy", resource=f"/{bucket}")
            return _Response(200, {**hdr, "Content-Type": "application/json"}, raw)
        if method == "DELETE":
            self.bucket_meta.update(bucket, policy_json=b"")
            return _Response(204, hdr)
        raise S3Error("NotImplemented")

    def _bucket_lifecycle(self, method, bucket, headers, body: _Body, auth,
                          hdr) -> _Response:
        """?lifecycle PUT, GET and DELETE (minio_tpu/s3/server.py:1731-1893):
        the XML stored verbatim once it is well formed; the scanner parses
        it each cycle."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            try:
                ET.fromstring(raw)
            except ET.ParseError:
                raise S3Error("MalformedXML") from None
            self.bucket_meta.update(bucket, lifecycle_xml=raw)
            return _Response(200, hdr)
        if method in ("GET", "HEAD"):
            raw = self.bucket_meta.get(bucket).lifecycle_xml
            if not raw:
                raise S3Error("NoSuchLifecycleConfiguration", resource=f"/{bucket}")
            return _xml(hdr, raw)
        if method == "DELETE":
            self.bucket_meta.update(bucket, lifecycle_xml=b"")
            return _Response(204, hdr)
        raise S3Error("MethodNotAllowed", resource=f"/{bucket}")

    def _bucket_notification(self, method, bucket, headers, body: _Body, auth,
                             hdr) -> _Response:
        """?notification PUT and GET (minio_tpu/s3/server.py:1856-1873): a
        PUT whose rules name an ARN no target has answers InvalidArgument;
        a GET of a bucket without rules answers the empty document."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            try:
                self.notifier.set_bucket_rules(bucket, raw)
            except ValueError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            self._rules_loaded.add(bucket)
            self.bucket_meta.update(bucket, notification_xml=raw)
            return _Response(200, hdr)
        if method in ("GET", "HEAD"):
            raw = self.bucket_meta.get(bucket).notification_xml or (
                b'<?xml version="1.0" encoding="UTF-8"?><NotificationConfiguration '
                b'xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
                b'</NotificationConfiguration>')
            return _xml(hdr, raw)
        raise S3Error("MethodNotAllowed", resource=f"/{bucket}")

    def _bucket_object_lock(self, method, bucket, headers, body: _Body, auth,
                            hdr) -> _Response:
        """?object-lock PUT and GET (:1838-1852): the configuration stored
        verbatim; a PUT needs versioning enabled."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            if not self.bucket_meta.get(bucket).versioning_enabled:
                raise S3Error("InvalidBucketState", "object lock requires versioning")
            self.bucket_meta.update(bucket, object_lock_xml=raw)
            return _Response(200, hdr)
        if method == "GET":
            raw = self.bucket_meta.get(bucket).object_lock_xml
            if not raw:
                raise S3Error("ObjectLockConfigurationNotFoundError",
                              resource=f"/{bucket}")
            return _xml(hdr, raw)
        raise S3Error("NotImplemented")

    def _object_lock(self, method, bucket, key, q, opts, headers, body: _Body,
                     auth, hdr) -> _Response:
        """A version's ?retention and ?legal-hold (:1425-1472): kept in its
        metadata under the x-amz-object-lock-* keys. A retention PUT passes
        the WORM check of the retention it replaces."""
        if method not in ("PUT", "GET", "HEAD"):
            raise S3Error("NotImplemented")
        if "retention" in q:
            if method == "PUT":
                raw = _with_body(headers, body, auth, lambda data, size: data.read())
                try:
                    mode, until = olock.parse_retention_xml(raw)
                except ValueError:
                    raise S3Error("MalformedXML") from None
                self._check_worm(bucket, key, opts, headers, missing_ok=False)
                self.obj.put_object_metadata(bucket, key, {
                    olock.KEY_MODE: mode, olock.KEY_UNTIL: olock.to_iso(until)}, opts)
                return _Response(200, hdr)
            info = self.obj.get_object_info(bucket, key, opts)
            mode = info.user_defined.get(olock.KEY_MODE, "")
            if not mode:
                raise S3Error("ObjectLockConfigurationNotFoundError",
                              resource=f"/{bucket}/{key}")
            return _xml(hdr, olock.retention_xml(mode, olock.parse_iso(
                info.user_defined.get(olock.KEY_UNTIL, ""))))
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            try:
                status = olock.parse_legal_hold_xml(raw)
            except ValueError:
                raise S3Error("MalformedXML") from None
            self.obj.put_object_metadata(bucket, key, {olock.KEY_HOLD: status}, opts)
            return _Response(200, hdr)
        status = self.obj.get_object_info(bucket, key, opts).user_defined.get(
            olock.KEY_HOLD, "")
        if not status:
            raise S3Error("ObjectLockConfigurationNotFoundError",
                          resource=f"/{bucket}/{key}")
        return _xml(hdr, olock.legal_hold_xml(status))

    def _versioning(self, method, bucket, headers, body: _Body, auth,
                    hdr) -> _Response:
        """PutBucketVersioning and GetBucketVersioning (the JAX server's
        route, minio_tpu/s3/server.py:1817-1835)."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            try:
                status = xmlutil.parse_versioning_xml(raw)
            except ValueError:
                raise S3Error("MalformedXML") from None
            if self.bucket_meta.get(bucket).object_lock_xml and status == "Suspended":
                raise S3Error("InvalidBucketState", "object lock requires versioning")
            self.bucket_meta.update(bucket, versioning_status=status)
            return _Response(200, hdr)
        if method == "GET":
            status = self.bucket_meta.get(bucket).versioning_status
            if self.versioned_buckets and not status:
                status = "Enabled"
            return _xml(hdr, xmlutil.versioning_xml(status))
        raise S3Error("NotImplemented")

    def _tagging(self, method, bucket, key, opts, headers, body: _Body,
                 auth, hdr) -> _Response:
        """Get/Put/DeleteObjectTagging on a version (:1397-1408)."""
        if method in ("GET", "HEAD"):
            return _xml(hdr, xmlutil.tagging_xml(
                self.obj.get_object_tags(bucket, key, opts)))
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            self.obj.put_object_tags(bucket, key, xmlutil.parse_tagging_xml(raw), opts)
            return _Response(200, hdr)
        if method == "DELETE":
            self.obj.delete_object_tags(bucket, key, opts)
            return _Response(204, hdr)
        raise S3Error("NotImplemented")

    def _multipart(self, method, bucket, key, q, headers, body: _Body,
                   auth, hdr, opts: ObjectOptions, req: _Request) -> _Response:
        """The six object-level multipart calls (the JAX server's routes,
        minio_tpu/s3/server.py:1530-1611). An encrypted upload seals its
        object key at create; each part is encrypted on its own, ListParts
        reports plaintext sizes and Complete checks the 5 MiB minimum on
        them."""
        if method == "POST" and "uploads" in q:
            user_defined = _metadata_headers(headers)
            self.atrest.sse_setup(headers, bucket, key, user_defined)
            upload_id = self.obj.new_multipart_upload(
                bucket, key, ObjectOptions(user_defined=user_defined))
            self.atrest.remember_upload(upload_id, user_defined)
            return _xml(hdr, xmlutil.initiate_multipart_xml(bucket, key, upload_id))
        if "uploadId" not in q:
            raise S3Error("NotImplemented")
        upload_id = q["uploadId"]
        if method == "PUT":
            part_number = _int_q(q, "partNumber", 0, lo=1, hi=10000)
            src = headers.get("x-amz-copy-source")
            if src:
                return self._upload_part_copy(bucket, key, upload_id, part_number,
                                              src, headers, hdr)

            def put_part(data, size):
                reader, stored = self.atrest.encrypt_part(headers, bucket, key,
                                                          upload_id, data, size)
                return self.obj.put_object_part(bucket, key, upload_id, part_number,
                                                reader, stored)

            res = _with_body(headers, body, auth, put_part)
            return _Response(200, {**hdr, "ETag": f'"{res.etag}"'})
        if method == "GET":
            parts = self.obj.list_parts(bucket, key, upload_id,
                                        _int_q(q, "part-number-marker", 0),
                                        _int_q(q, "max-parts", 1000))
            parts = self.atrest.plain_parts(bucket, key, upload_id, parts)
            return _xml(hdr, xmlutil.list_parts_xml(bucket, key, upload_id, parts))
        if method == "DELETE":
            self.obj.abort_multipart_upload(bucket, key, upload_id)
            self.atrest.forget_upload(upload_id)
            return _Response(204, hdr)
        if method == "POST":
            raw = _with_body(headers, body, auth,
                             lambda data, size: data.read())
            pairs = xmlutil.parse_complete_multipart_xml(raw)
            if not pairs:
                raise S3Error("MalformedXML")
            self.atrest.check_part_sizes(bucket, key, upload_id, [n for n, _ in pairs])
            info = self.obj.complete_multipart_upload(
                bucket, key, upload_id, [CompletePart(n, e) for n, e in pairs], opts)
            self.atrest.forget_upload(upload_id)
            extra = {"x-amz-version-id": info.version_id} if info.version_id else {}
            self.update_tracker.mark(bucket)
            self._emit(req, evt.OBJECT_CREATED_COMPLETE_MULTIPART, bucket, key,
                       size=info.size, etag=info.etag, version_id=info.version_id)
            return _xml({**hdr, **extra}, xmlutil.complete_multipart_xml(
                f"/{bucket}/{key}", bucket, key, info.etag))
        raise S3Error("NotImplemented")

    def _list_objects(self, bucket, q, hdr) -> _Response:
        """ListObjects v1 (marker) and, with list-type=2, v2
        (continuation-token, else start-after, is the marker), as the JAX
        server routes them (minio_tpu/s3/server.py:1362-1384)."""
        prefix, delimiter = q.get("prefix", ""), q.get("delimiter", "")
        max_keys = _int_q(q, "max-keys", 1000)
        if q.get("list-type") == "2":
            token, start_after = q.get("continuation-token", ""), q.get("start-after", "")
            res = self.obj.list_objects(bucket, prefix, token or start_after,
                                        delimiter, max_keys)
            return _xml(hdr, xmlutil.list_objects_v2_xml(
                bucket, prefix, token, start_after, delimiter, max_keys, res))
        marker = q.get("marker", "")
        res = self.obj.list_objects(bucket, prefix, marker, delimiter, max_keys)
        return _xml(hdr, xmlutil.list_objects_v1_xml(bucket, prefix, marker,
                                                     delimiter, max_keys, res))

    def _delete_objects(self, bucket, headers, body: _Body, auth, hdr, cond,
                        meta) -> _Response:
        """DeleteObjects (the JAX server's _delete_objects,
        minio_tpu/s3/server.py:2696): each key authorized on its own
        (DeleteObjectVersion with its s3:versionid where it names one); a
        key naming a VersionId also passes the WORM check, which the JAX
        server skips, so a bulk delete cannot destroy a locked version. A
        refused key answers AccessDenied in the <Error> list; a missing one
        counts as deleted. A key without a VersionId gets a delete marker
        when the bucket is versioned, by the server-wide default or by its
        own document (the JAX server consults the default only)."""
        raw = _with_body(headers, body, auth, lambda data, size: data.read())
        objects, quiet = xmlutil.parse_delete_xml(raw)
        allowed, errors = [], []
        for k, v in objects:
            ctx = cond
            if v:   # the key's version scope (s3:versionid conditions)
                ctx = NormalizedContext(cond)
                ctx["s3:versionid"] = [v]
            try:
                self._check_access(auth.identity, "s3:DeleteObjectVersion" if v
                                   else "s3:DeleteObject", bucket, k, ctx,
                                   meta.policy_json)
                if v:
                    self._check_worm(bucket, k, ObjectOptions(version_id=v), headers)
                allowed.append((k, v))
            except S3Error:
                errors.append((k, "AccessDenied", "Access Denied."))
        results = self.obj.delete_objects(
            bucket, [ObjectToDelete(k, v) for k, v in allowed],
            ObjectOptions(versioned=self._versioned(meta)))
        deleted = []
        for (k, v), r in zip(allowed, results):
            if isinstance(r, Exception):
                err = from_exception(r, k)
                if err.api.code != "NoSuchKey":
                    errors.append((k, err.api.code, err.message))
                elif not quiet:
                    deleted.append(DeletedObject(object_name=k, version_id=v))
            elif not quiet:
                deleted.append(r)
        return _xml(hdr, xmlutil.delete_result_xml(deleted, errors))

    def _put_object(self, bucket, key, opts, headers, body: _Body, auth, hdr,
                    req: _Request):
        user_defined = _metadata_headers(headers)
        if "content-type" not in user_defined:
            guessed, _ = mimetypes.guess_type(key)
            user_defined["content-type"] = guessed or "application/octet-stream"
        self._apply_object_lock(headers, bucket, user_defined)
        opts.user_defined = user_defined

        def put(data, size):
            # Compressed or encrypted (s3/atrest.py), in the JAX server's
            # order (:2486-2489); the ETag is the stored stream's md5.
            reader, stored = self.atrest.put_stream(headers, bucket, key,
                                                    user_defined, data, size)
            return self.obj.put_object(bucket, key, reader, stored, opts)

        info = _with_body(headers, body, auth, put)
        extra = {"x-amz-version-id": info.version_id} if info.version_id else {}
        self.update_tracker.mark(bucket)
        self._emit(req, evt.OBJECT_CREATED_PUT, bucket, key, size=info.size,
                   etag=info.etag, version_id=info.version_id)
        return _Response(200, {**hdr, "ETag": f'"{info.etag}"', **extra})

    def _apply_object_lock(self, headers, bucket: str, user_defined: dict) -> None:
        """Retention and legal hold from the PUT's headers, else the
        bucket's default retention (:2351-2372; reference
        cmd/bucket-object-lock.go getObjectRetentionMeta)."""
        mode = headers.get("x-amz-object-lock-mode", "").upper()
        until = headers.get("x-amz-object-lock-retain-until-date", "")
        hold = headers.get("x-amz-object-lock-legal-hold", "").upper()
        if mode and until:
            user_defined[olock.KEY_MODE] = mode
            user_defined[olock.KEY_UNTIL] = until
        else:
            default = olock.parse_default_retention(
                self.bucket_meta.get(bucket).object_lock_xml)
            if default is not None:
                user_defined[olock.KEY_MODE] = default[0]
                user_defined[olock.KEY_UNTIL] = olock.to_iso(time.time() + default[1])
        if hold:
            user_defined[olock.KEY_HOLD] = hold

    def _sts(self, headers, body: _Body, auth, hdr) -> _Response:
        """STS on the root path (the JAX server's _sts_handler,
        minio_tpu/s3/server.py:1898-1990; reference cmd/sts-handlers.go):
        AssumeRole for a signed user, AssumeRoleWithWebIdentity and
        AssumeRoleWithClientGrants for an IdP's JWT (iam/oidc.py),
        AssumeRoleWithLDAPIdentity by a simple bind (iam/ldap.py)."""
        identity = auth.identity
        form = urllib.parse.parse_qs(_with_body(
            headers, body, auth, lambda data, size: data.read()).decode())
        action = form.get("Action", [""])[0]
        duration = int(form.get("DurationSeconds", ["3600"])[0])
        session_policy = form.get("Policy", [""])[0]
        subject = ""
        if action == "AssumeRole":
            if identity.kind == "anonymous":
                raise S3Error("AccessDenied", "STS requires signed credentials")
            if identity.kind in ("sts", "svc"):
                raise S3Error("AccessDenied", "temporary credentials cannot assume roles")
            tc = self.iam.assume_role(identity.access_key, duration, session_policy)
        elif action in ("AssumeRoleWithWebIdentity", "AssumeRoleWithClientGrants"):
            # The IdP-signed token is the credential (sts-handlers.go:49-102).
            token = form.get("WebIdentityToken" if action.endswith("WebIdentity")
                             else "Token", [""])[0]
            if not token:
                raise S3Error("InvalidRequest", "missing identity token")
            try:
                validator = OpenIDValidator.from_config(self.config)
                if validator is None:
                    raise S3Error("STSNotImplemented", "identity_openid is not configured")
                claims = validator.validate(token)
                policies = validator.policies_from(claims)
            except OIDCError as e:
                raise S3Error("AccessDenied", str(e)) from None
            if not policies:
                raise S3Error("AccessDenied",
                              f"token carries no {validator.claim_name!r} claim")
            subject = str(claims.get("sub", ""))
            # The credentials never outlive the identity token.
            remaining = int(float(claims["exp"]) - time.time())
            if remaining <= 0:
                raise S3Error("AccessDenied", "identity token expired")
            tc = self.iam.assume_role_with_claims(
                subject, policies, min(max(900, duration), remaining), session_policy,
                claims={f"jwt:{k}": scalar_str(v) for k, v in claims.items()
                        if isinstance(v, (str, int, float, bool))})
        elif action == "AssumeRoleWithLDAPIdentity":
            username = form.get("LDAPUsername", [""])[0]
            password = form.get("LDAPPassword", [""])[0]
            if not username or not password:
                raise S3Error("InvalidRequest", "LDAPUsername and LDAPPassword required")
            try:
                ldap = LDAPValidator.from_config(self.config)
            except LDAPError as e:   # enabled but misconfigured: say so
                raise S3Error("InvalidRequest", str(e)) from None
            if ldap is None:
                raise S3Error("STSNotImplemented", "identity_ldap is not configured")
            if not ldap.policies:
                # Before binding: a setup that always denies must not
                # hammer the directory with real authentications.
                raise S3Error("AccessDenied",
                              "no sts_policy configured for LDAP identities")
            try:
                subject = ldap.authenticate(username, password)
            except LDAPError as e:
                raise S3Error("AccessDenied", str(e)) from None
            tc = self.iam.assume_role_with_claims(
                subject, ldap.policies, max(900, duration), session_policy,
                claims={"ldap:username": username, "ldap:user": subject})
        else:
            raise S3Error("STSNotImplemented")
        expiry = datetime.datetime.fromtimestamp(
            tc.expiry, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")
        return _xml(hdr, xmlutil.sts_assume_role_xml(
            tc.access_key, tc.secret_key, tc.session_token, expiry,
            hdr["x-amz-request-id"], action=action, subject=subject))

    def _post_policy_upload(self, bucket, headers, body: _Body, hdr,
                            req: _Request) -> _Response:
        """A browser form upload (:1658-1720; reference
        PostPolicyBucketHandler, cmd/postpolicyform.go): the signed policy
        document is the auth, its conditions are checked against the
        submitted fields, then the object is PUT as the signer."""
        form, file_bytes, filename = _parse_form(headers.get("Content-Type", ""),
                                                 body.read())
        creds = sigv4.verify_post_policy(form, self._lookup)
        # The "bucket" condition matches the request's target, not a field.
        form.setdefault("bucket", bucket)
        sigv4.check_post_policy_conditions(form.get("policy", ""), form, len(file_bytes))
        key = form.get("key", "")
        if not key:
            raise S3Error("InvalidArgument", "POST form requires key")
        key = key.replace("${filename}", filename)
        identity = self.iam.identify(creds.access_key)
        req.access_key = identity.access_key or ""   # the signer (events, audit)
        meta = self.bucket_meta.get(bucket)
        self._check_access(identity, "s3:PutObject", bucket, key, self._condition_context(
            identity, headers, None, req.remote, ("POST", sigv4.ALGORITHM)),
            meta.policy_json)
        opts = ObjectOptions(versioned=self._versioned(meta))
        if "content-type" in form:
            opts.user_defined["content-type"] = form["content-type"]
        for k, v in form.items():
            if k.startswith("x-amz-meta-") and "mtpu" not in k:
                opts.user_defined[k] = v
        info = self.obj.put_object(bucket, key, io.BytesIO(file_bytes),
                                   len(file_bytes), opts)
        self.update_tracker.mark(bucket)
        self._emit(req, evt.OBJECT_CREATED_POST, bucket, key, size=info.size,
                   etag=info.etag, version_id=info.version_id)
        status = int(form.get("success_action_status", "204"))
        if status == 201:
            doc = (f'<?xml version="1.0" encoding="UTF-8"?>'
                   f'<PostResponse><Location>/{bucket}/{key}</Location>'
                   f'<Bucket>{bucket}</Bucket><Key>{key}</Key>'
                   f'<ETag>"{info.etag}"</ETag></PostResponse>').encode()
            return _Response(201, {**hdr, "Content-Type": XML_TYPE}, doc)
        return _Response(status if status in (200, 204) else 204,
                         {**hdr, "ETag": f'"{info.etag}"'})

    def _bucket_encryption(self, method, bucket, headers, body: _Body, auth,
                           hdr) -> _Response:
        """The bucket's default SSE document (?encryption), stored verbatim
        in its metadata as the JAX server stores it
        (minio_tpu/s3/server.py:1727-1740, 1877-1893): PUT validates the
        XML, GET answers it or 404, DELETE clears it."""
        self.obj.get_bucket_info(bucket)
        if method == "PUT":
            raw = _with_body(headers, body, auth, lambda data, size: data.read())
            try:
                ET.fromstring(raw)
            except ET.ParseError:
                raise S3Error("MalformedXML") from None
            self.bucket_meta.update(bucket, sse_xml=raw)
            return _Response(200, hdr)
        if method == "GET":
            raw = self.bucket_meta.get(bucket).sse_xml
            if not raw:
                raise S3Error("ServerSideEncryptionConfigurationNotFoundError",
                              resource=f"/{bucket}")
            return _xml(hdr, raw)
        if method == "DELETE":
            self.bucket_meta.update(bucket, sse_xml=b"")
            return _Response(204, hdr)
        raise S3Error("NotImplemented")

    def _copy_object(self, bucket, key, src, opts, headers, hdr) -> _Response:
        """CopyObject (:2558-2600): the source version's client bytes (the
        GET path: K2 verify, then its decryption, with the
        x-amz-copy-source-server-side-encryption-customer-* key for an
        SSE-C source, or decompression) streamed into a PUT (K1 and K2),
        encrypted under the request's SSE headers or the bucket default.
        The metadata directive COPY keeps the source's metadata less its
        transform's keys, REPLACE takes the request's x-amz-meta-* and
        Content-Type."""
        src_bucket, src_key, src_opts = _parse_copy_source(src)
        info, open_range = self.obj.get_object_reader(src_bucket, src_key, src_opts)
        size, open_plain = self.atrest.plan_read(headers, src_bucket, src_key, info,
                                                 open_range, copy_source=True)
        if headers.get("x-amz-metadata-directive", "COPY") == "REPLACE":
            user_defined = {k: v for k, v in _metadata_headers(headers).items()
                            if k.startswith("x-amz-meta-")}
            if headers.get("Content-Type"):
                user_defined["content-type"] = headers["Content-Type"]
        else:
            user_defined = copy_metadata(info.user_defined)
            user_defined["content-type"] = info.content_type
        opts.user_defined = user_defined
        stream = open_plain()
        try:
            reader, stored = self.atrest.encrypt_put(headers, bucket, key, user_defined,
                                                     IterReader(stream), size)
            new_info = self.obj.put_object(bucket, key, reader, stored, opts)
        finally:
            _close(stream)
        return _xml(hdr, xmlutil.copy_object_xml(new_info.etag, new_info.mod_time))

    def _upload_part_copy(self, bucket, key, upload_id, part_number, src, headers,
                          hdr) -> _Response:
        """UploadPartCopy (:2526-2556): the source range
        (x-amz-copy-source-range, else the whole version) of its client
        bytes, streamed into one part, encrypted when the upload is."""
        src_bucket, src_key, src_opts = _parse_copy_source(src)
        info, open_range = self.obj.get_object_reader(src_bucket, src_key, src_opts)
        offset, length = 0, AtRest.visible_size(info)
        rng = headers.get("x-amz-copy-source-range")
        if rng:
            offset, length = _parse_range(rng, length)
        _size, open_plain = self.atrest.plan_read(headers, src_bucket, src_key, info,
                                                  open_range, offset, length,
                                                  copy_source=True)
        stream = open_plain()
        try:
            reader, stored = self.atrest.encrypt_part(headers, bucket, key, upload_id,
                                                      IterReader(stream), length)
            res = self.obj.put_object_part(bucket, key, upload_id, part_number,
                                           reader, stored)
        finally:
            _close(stream)
        return _xml(hdr, xmlutil.copy_object_xml(res.etag, res.last_modified))

    def _get_object(self, bucket, key, opts, headers, hdr):
        """GetObject: Range on the client bytes (the plaintext of an
        encrypted or compressed version); the key is unsealed before the
        conditionals, as in the JAX server (:2291-2343)."""
        rng = headers.get("Range")
        info, open_range = self.obj.get_object_reader(bucket, key, opts)
        status, offset, length = 200, 0, AtRest.visible_size(info)
        if rng:
            offset, length = _parse_range(rng, length)
            status = 206
        size, open_plain = self.atrest.plan_read(headers, bucket, key, info, open_range,
                                                 offset, length)
        if _check_conditional("GET", headers, info):
            return _Response(304, {**hdr, "ETag": f'"{info.etag}"'}, b"", 0)
        stream = open_plain()
        out = {**hdr, **_object_headers(info), "Content-Length": str(length)}
        if status == 206:
            out["Content-Range"] = f"bytes {offset}-{offset + length - 1}/{size}"
        # Pull the first chunk before the headers go out, so a read that
        # fails (quorum lost) still answers with an error status.
        first = next(stream, None)
        chunks = iter(()) if first is None else _prepend(first, stream)
        return _Response(status, out, chunks, length)


def _xml(hdr: dict, doc: bytes) -> _Response:
    return _Response(200, {**hdr, "Content-Type": XML_TYPE}, doc)


def _with_body(headers, body: _Body, auth: _Auth, consume):
    """consume(reader, size) over the request body. An unsigned payload
    streams straight through; a signed one is spooled and its sha256
    checked, and an aws-chunked one (STREAMING-AWS4-HMAC-SHA256-PAYLOAD)
    spooled as each chunk's signature verifies, before consume sees a
    byte, so nothing commits unverified. The aws-chunked rules are the JAX
    server's _spool_body (minio_tpu/s3/server.py:2403-2460): the decoded
    length is x-amz-decoded-content-length, required; a presigned request
    may not stream; the chunk key derives from the requester's secret; a
    body that ends before its final chunk, or decodes to another length,
    answers IncompleteBody."""
    if headers.get("Content-Length") is None:
        raise S3Error("MissingContentLength")
    size = body.remaining
    streaming = auth.payload_hash == sigv4.STREAMING_PAYLOAD
    if streaming:
        if auth.sig is None:
            # The chunk chain starts at a header signature's seed; a
            # presigned URL has none.
            raise S3Error("InvalidArgument",
                          "streaming payload requires header authorization")
        decoded = headers.get("x-amz-decoded-content-length")
        if decoded is None:
            raise S3Error("MissingContentLength")
        try:
            size = int(decoded)
        except ValueError:
            raise S3Error("InvalidArgument",
                          "malformed x-amz-decoded-content-length") from None
    if size > MAX_OBJECT_SIZE:
        raise S3Error("EntityTooLarge")
    if auth.payload_hash == sigv4.UNSIGNED_PAYLOAD:
        return consume(body, size)
    with tempfile.SpooledTemporaryFile(max_size=SPOOL_LIMIT) as spool:
        if streaming:
            sig = auth.sig
            chunks = sigv4.ChunkedSigV4Reader(auth.creds, sig.signature,
                                              headers.get("x-amz-date", ""),
                                              sig.scope_date, sig.region, sig.service)
            while data := body.read(_COPY):
                for piece in chunks.feed(data):
                    spool.write(piece)
            if not chunks.done or spool.tell() != size:
                raise S3Error("IncompleteBody")
        else:
            sha = hashlib.sha256()
            while chunk := body.read(_COPY):
                sha.update(chunk)
                spool.write(chunk)
            if sha.hexdigest() != auth.payload_hash:
                raise S3Error("XAmzContentSHA256Mismatch")
        spool.seek(0)
        return consume(spool, size)


def _parse_form(content_type: str, raw: bytes) -> tuple[dict, bytes, str]:
    """A multipart/form-data body -> ({lowercase field: value}, the file's
    bytes, its filename). Fields after the file are ignored, as S3 does."""
    boundary = ""
    for param in content_type.split(";")[1:]:
        k, _, v = param.strip().partition("=")
        if k.lower() == "boundary":
            boundary = v.strip('"')
    if not boundary:
        raise S3Error("InvalidArgument",
                      "multipart/form-data without a boundary")
    form: dict[str, str] = {}
    for part in raw.split(b"--" + boundary.encode())[1:]:
        if part.startswith(b"--"):
            break
        head, _, data = part.removeprefix(b"\r\n").partition(b"\r\n\r\n")
        data = data.removesuffix(b"\r\n")
        disposition = ""
        for line in head.decode("utf-8", "replace").split("\r\n"):
            name, _, value = line.partition(":")
            if name.strip().lower() == "content-disposition":
                disposition = value
        params = dict((k.strip().lower(), v.strip().strip('"')) for k, _, v in
                      (p.partition("=") for p in disposition.split(";")[1:]))
        name = params.get("name", "").lower()
        if name == "file":
            return form, data, params.get("filename", "")
        form[name] = data.decode("utf-8", "replace")
    return form, b"", ""


def _prepend(first, rest):
    yield first
    yield from rest


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "minio-tpu"
    sys_version = ""

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def do_GET(self):
        self._handle("GET")

    def do_PUT(self):
        self._handle("PUT")

    def do_HEAD(self):
        self._handle("HEAD")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_POST(self):
        self._handle("POST")

    def _handle(self, method: str) -> None:
        request_id = uuid.uuid4().hex[:16].upper()
        raw_path, _, qs = self.path.partition("?")
        path = urllib.parse.unquote(raw_path)
        query_items = urllib.parse.parse_qsl(qs, keep_blank_values=True)
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        body = _Body(self.rfile, max(length, 0))
        req = _Request(request_id, method, path, self.client_address[0], max(length, 0))
        req.query = qs
        req.headers = self.headers
        # The request id is the trace id: bound to this handler thread's
        # context for the request, and carried by obs.ctx_wrap into every
        # thread that works on its behalf.
        tokens = obs.set_trace_context(request_id)
        # The connection's thread serves its requests in turn: each starts
        # unattributed and leaves no tenant behind.
        qtok = qos.bind_key(qos.UNATTRIBUTED)
        flight.begin(request_id)
        req.t0 = self.server.s3.stats.begin(request_id, api_hint=method.lower(),
                                            remote=req.remote,
                                            api_get=lambda: req.api,
                                            tenant_get=lambda: req.tenant)
        resp = None
        try:
            resp = self._answer(method, path, query_items, length, body, req)
        finally:
            self._account(req, resp.status if resp is not None else 500,
                          resp.length if resp is not None else 0)
            qos.reset(qtok)
            obs.reset_trace_context(tokens)

    def _leave(self, req: _Request) -> None:
        """Take the request out of the in-flight count, once: just before
        the last byte of its answer goes out."""
        if not req.left:
            req.left = True
            self.server.s3.stats.leave(req.id)

    def _account(self, req: _Request, status: int, tx: int) -> None:
        """End the request's accounting, once the answer is written (or
        has failed): HTTPStats, the latency and TTFB families, its
        timeline and, while someone traces, its `http` record."""
        if req.done:
            return
        req.done = True
        self._leave(req)
        s3 = self.server.s3
        api = req.api or req.method.lower()
        dt = time.perf_counter() - req.t0
        flight.set_api(api)
        flight.end(status=status)
        s3.stats.end(api, req.t0, status, rx=req.rx, tx=tx or 0, request_id=req.id,
                     left=True)
        _REQ_LATENCY.labels(api=api).observe(dt)
        _REQ_TTFB.labels(api=api).observe(dt if req.ttfb is None else req.ttfb)
        if req.tenant:
            mkey = qos.metric_key(req.tenant)
            _TENANT_LATENCY.labels(tenant=mkey).observe(dt)
            _TENANT_REQS.labels(tenant=mkey, code=f"{status // 100}xx").inc()
        if s3.logger.audit_targets:
            # The per-request audit record (minio_tpu/s3/server.py:939-960;
            # reference logger.AuditLog): its request id is the trace id.
            parts = req.path.lstrip("/").split("/", 1)
            s3.logger.audit(audit_entry(
                api=api,
                bucket=parts[0] if parts and not parts[0].startswith("minio") else "",
                object=parts[1] if len(parts) > 1 else "",
                status_code=status, access_key=req.access_key,
                remote_host=s3._client_ip(req.headers, req.remote),
                user_agent=req.headers.get("User-Agent", ""), request_id=req.id,
                rx_bytes=req.rx, tx_bytes=tx or 0, duration_ms=dt * 1000,
                query=dict(urllib.parse.parse_qsl(req.query))))
        if obs.has_subscribers():
            rec = {"type": "http", "time": time.time(), "api": api,
                   "method": req.method, "path": req.path, "status": status,
                   "requestId": req.id, "remote": req.remote,
                   "durationNs": int(dt * 1e9), "rx": req.rx, "tx": tx or 0}
            if req.ttfb is not None:
                rec["ttfbNs"] = int(req.ttfb * 1e9)
            obs.publish(rec)

    def _answer(self, method, path, query_items, length: int, body: _Body,
                req: _Request) -> _Response:
        try:
            if length < 0:
                raise S3Error("InvalidArgument", "malformed Content-Length")
            resp = self.server.s3.dispatch(method, path, query_items, self.headers,
                                           body, req)
        except Exception as e:  # noqa: BLE001 - every failure answers as S3 XML
            err = from_exception(e, path)
            doc = xmlutil.error_xml(err.api.code, err.message, path, req.id)
            resp = _Response(err.api.http_status,
                             {"x-amz-request-id": req.id,
                              "Content-Type": XML_TYPE, **_SECURITY_HEADERS,
                              **err.headers}, doc)
        if 0 < body.remaining <= _DRAIN_LIMIT:
            # A short body the answer did not need (an error raised before
            # reading it): read it off, or closing the connection with it
            # unread could reset the connection before the client reads
            # the answer.
            body.read()
        if body.remaining or self.headers.get("Transfer-Encoding"):
            # Unread request body left on the connection: it cannot carry
            # another request.
            self.close_connection = True
        for hook in self.server.s3.on_response:
            hook(resp.headers)
        chunked = resp.length is None
        self.send_response(resp.status)
        for k, v in resp.headers.items():
            if k != "Content-Length":
                self.send_header(k, v)
        if chunked:
            self.send_header("Transfer-Encoding", "chunked")
        elif resp.status not in (204, 304) and (method != "HEAD" or resp.length
                                                 or "Content-Length" in resp.headers):
            # No length on a 204 or 304, and a HEAD answer states one only
            # where there is one (an object's size, 0 included, an error
            # document's), as the JAX server does.
            self.send_header("Content-Length", str(resp.length))
        streamed = not isinstance(resp.body, (bytes, bytearray))
        if method == "HEAD" or not streamed:
            # Everything goes out with the headers: leave the in-flight
            # count now, so a client that has read the answer never sees
            # it in flight.
            self._leave(req)
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(resp.body)
            return resp
        self.end_headers()
        req.ttfb = time.perf_counter() - req.t0
        try:
            it = iter(resp.body)
            chunk = next(it, None)
            while chunk is not None:
                nxt = next(it, None)
                if nxt is None and not chunked:
                    self._leave(req)
                if chunked:
                    self.wfile.write(b"%x\r\n%s\r\n" % (len(chunk), chunk))
                else:
                    self.wfile.write(chunk)
                chunk = nxt
            if chunked:
                self._leave(req)
                self.wfile.write(b"0\r\n\r\n")
        except Exception:  # noqa: BLE001 - headers are out: only a cut
            # connection can tell the client the body is incomplete.
            self.close_connection = True
            if chunked:
                return resp   # the trace client went away: the stream ends
            raise
        finally:
            _close(resp.body)
        return resp


def _metadata_headers(headers) -> dict:
    """User-controlled object metadata from the request headers."""
    user_defined = {}
    ct = headers.get("Content-Type")
    if ct:
        user_defined["content-type"] = ct
    sc = headers.get("x-amz-storage-class")
    if sc:
        user_defined["x-amz-storage-class"] = sc
    tags = headers.get("x-amz-tagging")
    if tags:
        user_defined["x-amz-tagging"] = tags
    for hk, hv in headers.items():
        lk = hk.lower()
        if lk.startswith("x-amz-meta-") and "mtpu" not in lk:
            user_defined[lk] = hv
    return user_defined


def _object_headers(info) -> dict:
    h = {
        "ETag": f'"{info.etag}"',
        "Last-Modified": email.utils.formatdate(info.mod_time, usegmt=True),
        "Content-Type": info.content_type or "binary/octet-stream",
        "Accept-Ranges": "bytes",
        "Content-Length": str(AtRest.visible_size(info)),
    }
    h.update(sse.sse_headers_for(info.user_defined))
    if info.version_id:
        h["x-amz-version-id"] = info.version_id
    for k, v in info.user_defined.items():
        if k.startswith("x-amz-meta-"):
            h[k] = v
    tags = info.user_defined.get("x-amz-tagging")
    if tags:
        h["x-amz-tagging-count"] = str(len(urllib.parse.parse_qsl(tags)))
    return h


def _parse_copy_source(src: str):
    """x-amz-copy-source -> (bucket, key, ObjectOptions naming its
    versionId) (:2906-2916)."""
    src = urllib.parse.unquote(src)
    src_vid = ""
    if "?versionId=" in src:
        src, src_vid = src.split("?versionId=", 1)
    src = src.lstrip("/")
    if "/" not in src:
        raise S3Error("InvalidArgument", "bad x-amz-copy-source")
    src_bucket, src_key = src.split("/", 1)
    return src_bucket, src_key, ObjectOptions(version_id=src_vid)


def _check_conditional(method: str, headers, info) -> bool:
    """True for a 304 Not Modified answer; raises 412 PreconditionFailed
    (:2972-2983)."""
    im = headers.get("If-Match")
    if im and im != "*" and im.strip('"') != info.etag:
        raise S3Error("PreconditionFailed", "ETag does not match If-Match")
    inm = headers.get("If-None-Match")
    if inm and (inm == "*" or inm.strip('"') == info.etag):
        if method in ("GET", "HEAD"):
            return True
        raise S3Error("PreconditionFailed", "ETag matches If-None-Match")
    return False


def _close(stream) -> None:
    """Close a GET stream left unfinished (its shard readers)."""
    close = getattr(stream, "close", None)
    if close is not None:
        close()


def _parse_range(value: str, size: int) -> tuple[int, int]:
    """(offset, length) of a single `bytes=` range (first of a list)."""
    if not value.startswith("bytes="):
        raise S3Error("InvalidRange")
    spec = value[6:].split(",")[0].strip()
    try:
        if spec.startswith("-"):
            suffix = int(spec[1:])
            if suffix == 0:
                raise S3Error("InvalidRange")
            start, end = max(0, size - suffix), size - 1
        else:
            lo, _, hi = spec.partition("-")
            start = int(lo)
            end = int(hi) if hi else size - 1
    except ValueError:
        raise S3Error("InvalidRange") from None
    if start >= size or end < start:
        raise S3Error("InvalidRange")
    end = min(end, size - 1)
    return start, end - start + 1


def build_server(drive_paths: list[str], access_key: str, secret_key: str,
                 device="cuda", address: str = "127.0.0.1:0",
                 parity: int | None = None,
                 set_drive_count: int | None = None,
                 versioned: bool = False, enable_mrf: bool = True,
                 listen: bool = True, rpc_port: int | None = None) -> S3Server:
    """Format (or read the format of) the drives as sets of
    `set_drive_count` (default: one set of all), put them in one pool and
    bind its S3 server (`listen=False`: bind nothing, S3Server.adopt and
    serve_socket feed it); `versioned` versions every bucket, `enable_mrf`
    (the JAX default, on) gives each set its MRF healer. Call .start() to
    serve in the background, .start_auto_heal() for the drive healer,
    .close() to stop all of it.

    URL endpoints (http://host:port/path, with {a...b} ellipses) boot one
    node of a distributed deployment instead (build_cluster_server)."""
    if any("://" in p for p in drive_paths):
        return build_cluster_server(drive_paths, access_key, secret_key,
                                    device=device, address=address,
                                    parity=parity,
                                    set_drive_count=set_drive_count,
                                    versioned=versioned, enable_mrf=enable_mrf,
                                    rpc_port=rpc_port)
    # The calibration profile on drive 0 (minio_tpu/s3/server.py:3061-3067):
    # written at the first boot, compared at later ones; a host that
    # differs raises minio_tpu_calibration_stale.
    calibration.boot(drive_paths[0])
    sets = ErasureSets([LocalDrive(p) for p in drive_paths],
                       set_drive_count=set_drive_count, parity=parity,
                       enable_mrf=enable_mrf, device=device)
    return S3Server(ErasureServerPools([sets]),
                    sigv4.Credentials(access_key, secret_key), address,
                    versioned_buckets=versioned, listen=listen)


def build_cluster_server(endpoints: list[str], access_key: str, secret_key: str,
                         device="cuda", address: str = "127.0.0.1:9000",
                         parity: int | None = None,
                         set_drive_count: int | None = None,
                         versioned: bool = False, enable_mrf: bool = True,
                         rpc_port: int | None = None) -> S3Server:
    """One node of a distributed deployment, as the JAX build_server boots
    it (minio_tpu/s3/server.py:3007-3050): `address` is this node's
    advertised S3 host:port (endpoints naming it are its local drives);
    the node's RPC fabric listens on `rpc_port` (the S3 port + 1000 by
    default, as every node assumes of its peers). The boot retries
    bootstrap, format and the first quorum reads until MTPU_BOOT_TIMEOUT
    (600 s) while peers start, in any order."""
    from minio_tpu_torch.dist.cluster import ClusterNode

    host, _, port = address.rpartition(":")
    node = ClusterNode([endpoints], host=host or "127.0.0.1", port=int(port or 9000),
                       secret=secret_key, set_drive_count=set_drive_count or 0,
                       parity=parity, rpc_port=rpc_port, device=device)
    boot_deadline = time.monotonic() + float(os.environ.get("MTPU_BOOT_TIMEOUT", "600"))
    try:
        while True:
            layer = None
            try:
                node.wait_for_peers(timeout=max(1.0, boot_deadline - time.monotonic()))
                layer = node.build_object_layer(enable_mrf=enable_mrf)
                srv = S3Server(layer, sigv4.Credentials(access_key, secret_key),
                               address, versioned_buckets=versioned,
                               notification_sys=node.notification)
                break
            except (se.OperationTimedOut, se.InsufficientReadQuorum,
                    se.InsufficientWriteQuorum):
                if layer is not None:
                    layer.close()
                    node.object_layer = None
                if time.monotonic() > boot_deadline:
                    raise
                time.sleep(0.5)
    except BaseException:
        node.close()
        raise
    srv.attach_cluster(node)
    return srv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="minio_tpu_torch S3 server")
    ap.add_argument("drives", nargs="+",
                    help="drive directories, or URL endpoints with {a...b} "
                         "ellipses for a node of a distributed deployment")
    ap.add_argument("--address", default="0.0.0.0:9000")
    ap.add_argument("--versioned", action="store_true",
                    help="version every bucket (else each bucket's ?versioning)")
    ap.add_argument("--parity", type=int, default=None)
    ap.add_argument("--set-drive-count", type=int, default=None,
                    help="drives per erasure set (default: all in one set)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    ap.add_argument("--rpc-port", type=int, default=None,
                    help="a cluster node's RPC fabric port (default: S3 port "
                         "+ 1000, as its peers assume)")
    ap.add_argument("--scan-interval", type=float, default=60.0,
                    help="background scanner cycle pause (seconds; 0 disables)")
    args = ap.parse_args(argv)
    srv = build_server(args.drives, os.environ.get("MTPU_ROOT_USER", "minioadmin"),
                       os.environ.get("MTPU_ROOT_PASSWORD", "minioadmin"),
                       device=args.device, address=args.address,
                       parity=args.parity, set_drive_count=args.set_drive_count,
                       versioned=args.versioned, rpc_port=args.rpc_port)
    if args.scan_interval > 0:
        srv.start_scanner(interval=args.scan_interval)
    srv.start_auto_heal()
    sets = srv.obj.pools[0]
    es = sets.sets[0]
    n_drives = sum(len(p.drives) for p in srv.obj.pools)
    node = (f", node {srv.cluster_node.node_name} of "
            f"{len(srv.cluster_node.peer_nodes) + 1}" if srv.cluster_node else "")
    print(f"serving S3 on {srv.url} ({n_drives} drives, {sets.set_count} "
          f"set(s) of {es.n}, EC {es.n - es.parity}+{es.parity}, {es.device}"
          f"{node})", flush=True)
    # SIGTERM drains: the serve loop ends, close() stops the healers, the
    # sets, the node's fabric and the WALs, and the process exits 0 after
    # printing its exact kernel launch counts.
    signal.signal(signal.SIGTERM, lambda signum, frame: threading.Thread(
        target=srv.httpd.shutdown, daemon=True).start())
    try:
        srv.httpd.serve_forever()
    finally:
        srv.close()
        if srv.cluster_node is None:   # a cluster node closes its own
            from minio_tpu_torch.storage.healthcheck import unwrap

            for d in srv.obj.all_drives():
                close_wal = getattr(unwrap(d), "close_wal", None)
                if close_wal is not None:
                    close_wal()
    from minio_tpu_torch.ops import kernels

    print(f"drained; kernel launches {kernels.launches()}", flush=True)


if __name__ == "__main__":
    main()
