"""The /minio/admin/v3 API on the port's stdlib front door (counterpart of
minio_tpu/admin/handlers.py).

Routes served, under /minio/admin/v3/:

    GET  info                          server info (drives, health, stats)
    GET  metrics                       the cluster scrape (Prometheus text)
    POST heal/{bucket}[/{prefix}]      heal_bucket + heal_objects, the item
                                       JSON of each (body: madmin HealOpts,
                                       dryRun and scanMode)
    GET  top/api                       the requests in flight
    GET  top/locks                     this node's dsync lock table
    POST force-unlock?paths=a,b        drop stuck locks on this node's locker
    GET  trace                         the trace bus as JSON lines, chunked,
                                       until the client goes (?type=,
                                       ?traceid=, ?plane=), merged with every
                                       peer's on a cluster node (?all=false:
                                       this node's only)
    GET  consolelog                    the logger's console bus as JSON lines,
                                       merged with every peer's on a cluster
                                       node (?all=false: this node's only)
    GET  datausageinfo                 the scanner's last complete cycle
                                       (objects, versions, sizes per bucket)
    GET|PUT|DELETE tier                the ILM tiers: list (secrets
                                       redacted), add one (body: its
                                       document), remove ?name= (&force=true)
    GET  slo                           the SLO burn-rate state: this
                                       worker's merged with its front-door
                                       siblings' mailboxes, and on a cluster
                                       node every peer's (?all=false: this
                                       node's only); gzip when asked
    GET  slo/history                   this node's metric ring (?seconds=,
                                       ?prefix=); gzip when asked
    GET|POST faults                    the fault planes (admin:* and
                                       MTPU_FAULT_INJECTION=1): GET the
                                       network plane and the armed drives,
                                       POST one document to either plane
                                       ("drive..." ops to chaos/naughty.py,
                                       "clear_all" to both, the rest to
                                       dist/faultplane.py)
    GET  perf/timeline                 flight-recorder timelines (?traceid=,
                                       ?api=, ?worst=, ?tenant=), this
                                       worker's and its siblings', and the
                                       peers' under "peers" on a cluster node
    POST profiling/start               ?profilerType=cpu,device
    GET  profiling/download            the profiles, zipped (InternalError
                                       where the device capture lost
                                       events of kernels that ran)
    GET  config-kv[?subsys=]           the config (admin/configkv.py), as
                                       {subsys: {key: value}}
    PUT  config-kv                     set keys (body {subsys: {key: value}});
                                       answers {"restart": [subsystems that
                                       apply only at the next start]}
    GET  kms/status, kms/key-status    the KMS's status
    POST kms/key/create?key-id=        a new master key

    PUT  add-user?accessKey=           a user (body {secretKey, status})
    POST remove-user?accessKey=        and its service accounts
    GET  list-users                    {user: {status, policyName}}
    POST set-user-status?accessKey=&status=
    PUT  add-canned-policy?name=       body: the policy JSON
    POST remove-canned-policy?name=
    GET  list-canned-policies          {name: policy}
    POST set-user-or-group-policy?userOrGroup=&policyName=a,b[&isGroup=true]
    POST update-group-members          body {group, members, isRemove}
    PUT  add-service-account           body {parent, policy, accessKey,
                                       secretKey}
    POST delete-service-account?accessKey=

The IAM ops (iam/sys.py) answer InvalidRequest for an IAM error (no such
user, policy or group, a policy that does not validate, ...).
`config` is another name of `config-kv`, as in the JAX server. Every op
is authorized as the JAX server authorizes it (handlers.py:38-47): an
anonymous request answers AccessDenied, any other is allowed where IAM
allows its admin:* action under the request's condition context (the
root always; the IAM ops need admin:*). A config-kv PUT re-applies the
log and audit targets (logger_webhook, audit_webhook, audit_file) and the
event targets (notify_*) it touches. The JAX package's other admin ops
(obd, service, replication...) answer NotImplemented until their planes
land in the port (ROADMAP.md); so do force-unlock and top/locks on a
server that is not a cluster node (no dsync locker). An op neither
package has answers MethodNotAllowed, as the JAX server's does.
"""

from __future__ import annotations

import json
import threading
import time

from minio_tpu_torch import obs
from minio_tpu_torch.admin.configkv import ConfigError
from minio_tpu_torch.admin.metrics import PROM_CONTENT_TYPE, maybe_gzip
from minio_tpu_torch.admin.profiling import IncompleteDeviceTrace, zip_profiles
from minio_tpu_torch.crypto.kms import KMSError
from minio_tpu_torch.erasure.metadata import parallel_map
from minio_tpu_torch.iam import reqctx
from minio_tpu_torch.iam.policy import PolicyArgs
from minio_tpu_torch.obs import flight
from minio_tpu_torch.s3.errors import S3Error
from minio_tpu_torch.storage.healthcheck import fleet_deadlines
from minio_tpu_torch.utils import errors as se

VERSION = "minio_tpu/1.0"
ADMIN_PREFIX = "/minio/admin/v3/"

_SERVED = frozenset({"info", "metrics", "heal", "top", "trace", "perf", "profiling",
                     "config-kv", "config", "kms", "force-unlock", "datausageinfo",
                     "tier", "consolelog", "slo", "faults"})

# Admin ops of the JAX package whose planes the port does not have yet.
_NOT_YET = frozenset({
    "set-remote-target", "list-remote-targets",
    "remove-remote-target", "replication-status", "replication-resync",
    "cache", "bandwidth", "service", "update",
    "obdinfo", "healthinfo"})

# The action each served op is authorized as (the JAX handlers').
_ACTIONS = {"info": "admin:ServerInfo", "metrics": "admin:Prometheus",
            "heal": "admin:Heal", "top": "admin:ServerInfo",
            "force-unlock": "admin:ForceUnlock",
            "trace": "admin:ServerTrace", "perf": "admin:ServerInfo",
            "profiling": "admin:Profiling", "config-kv": "admin:ConfigUpdate",
            "config": "admin:ConfigUpdate", "datausageinfo": "admin:ServerInfo",
            "tier": "admin:SetTier", "consolelog": "admin:ConsoleLog",
            "slo": "admin:Prometheus", "faults": "admin:*"}

TRACE_HEARTBEAT_S = 0.5   # an idle trace stream writes a newline this often


class AdminAPI:
    def __init__(self, server):
        """server: the S3Server (obj, stats, profiler, closing)."""
        self.s = server
        self.started = time.time()

    def authorize(self, identity, action: str) -> None:
        """AccessDenied unless IAM allows `action` to `identity` under the
        request's condition context (iam/reqctx.py, set at dispatch)."""
        if identity.kind == "anonymous":
            raise S3Error("AccessDenied", "admin API requires credentials")
        if not self.s.iam.is_allowed(identity, PolicyArgs(
                action=action, conditions=reqctx.get_condition_context())):
            raise S3Error("AccessDenied", f"{action} not allowed")

    def handle(self, method: str, path: str, q: dict, headers,
               read_body, identity):
        """Dispatch /minio/admin/v3/<op>; `path` excludes the prefix,
        read_body() returns the (verified) request body. -> (status,
        headers, body), body bytes or, for the trace stream, an iterator
        of chunks."""
        op, _, rest = path.partition("/")
        if op not in _SERVED and op not in _NOT_YET and op not in _IAM_OPS:
            raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + path)
        if op == "kms":
            self.authorize(identity, "admin:KMSCreateKey" if method == "POST"
                           else "admin:KMSKeyStatus")
        elif op in _IAM_OPS:
            self.authorize(identity, "admin:*")
            try:
                return _IAM_OPS[op](self.s.iam, q, read_body)
            except se.IAMError as e:
                raise S3Error("InvalidRequest", str(e)) from None
            except (KeyError, ValueError) as e:
                raise S3Error("InvalidArgument", f"bad {op} request: {e}") from None
        elif op == "top" and rest == "locks":
            self.authorize(identity, "admin:TopLocksInfo")
        else:
            self.authorize(identity, _ACTIONS.get(op, "admin:*"))
        if op == "info" and method == "GET":
            return _json(self._server_info())
        if op == "metrics" and method == "GET":
            body, enc = maybe_gzip(self.s.cluster_scrape(),
                                   headers.get("Accept-Encoding"))
            hdr = {"Content-Type": PROM_CONTENT_TYPE}
            if enc:
                hdr["Content-Encoding"] = enc
            return 200, hdr, body
        if op == "heal":
            return self._heal(method, rest, read_body)
        if op == "top" and rest == "api" and method == "GET":
            return _json({"requests": self.s.stats.inflight()})
        locker = self.s.local_locker
        if op == "top" and rest == "locks" and method == "GET" and locker is not None:
            return _json({"locks": locker.dump()})
        if op == "force-unlock" and method == "POST":
            # Clears the resources on THIS node's locker (the reference
            # ForceUnlockHandler); the admin runs it on each node that
            # holds a stale entry (handlers.py:139-160).
            if locker is None:
                raise S3Error("NotImplemented", "no local locker (not a "
                              "distributed deployment)")
            from minio_tpu_torch.dist.dsync import LockArgs

            paths = [p for p in q.get("paths", "").split(",") if p]
            if not paths:
                raise S3Error("InvalidArgument", "paths required")
            locker.force_unlock(LockArgs(uid="", resources=paths, owner="admin"))
            return _json({"unlocked": paths})
        notif = self.s.notification if q.get("all", "true") != "false" else None
        if op == "trace" and method == "GET":
            return 200, {"Content-Type": "application/json"}, self._bus_stream(
                obs.trace_bus(), "trace_stream", notif, q.get("type", ""),
                q.get("traceid", ""), q.get("plane", ""))
        if op == "consolelog" and method == "GET":
            # The logger's console bus, merged with every peer's
            # (handlers.py:183-188).
            return 200, {"Content-Type": "application/json"}, self._bus_stream(
                self.s.logger.console_bus, "console_stream", notif)
        if op == "slo" and method == "GET":
            return self._slo(rest, q, headers, notif)
        if op == "faults":
            return self._faults(method, read_body)
        if op == "datausageinfo" and method == "GET":
            # The scanner's last complete cycle (handlers.py:81-86).
            scanner = self.s.scanner
            return _json(scanner.usage.to_info() if scanner is not None
                         else {"objectsCount": 0, "bucketsUsage": {}})
        if op == "tier":
            return self._tier(method, q, read_body)
        if op == "perf" and rest == "timeline" and method == "GET":
            out = self._perf_timelines(q)
            if notif is not None and notif.peers:
                out["peers"] = notif.perf_all(
                    {k: q.get(k, "") for k in ("traceid", "api", "worst", "tenant")})
            return _json(out)
        if op == "profiling" and rest == "start" and method == "POST":
            kinds = tuple(q.get("profilerType", q.get("kinds", "cpu")).split(","))
            if "tpu" in kinds:
                raise S3Error("InvalidArgument", "profilerType tpu has no "
                              "meaning on this device: ask for device")
            try:
                self.s.profiler.start(kinds)
            except ValueError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({"startResults": [{"success": True}]})
        if op == "profiling" and rest == "download" and method == "GET":
            try:
                files = self.s.profiler.stop_collect()
            except IncompleteDeviceTrace as e:
                raise S3Error("InternalError", str(e)) from None
            return 200, {"Content-Type": "application/zip"}, zip_profiles(
                {"local": files})
        if op in ("config-kv", "config"):
            return self._config_kv(method, path, q, read_body)
        if op == "kms" and method == "GET" and rest in ("status", "key-status"):
            return _json(self.s.kms.status())
        if op == "kms" and method == "POST" and rest == "key/create":
            try:
                self.s.kms.create_key(q.get("key-id", "") or "default")
            except KMSError as e:
                raise S3Error("InvalidRequest", str(e)) from None
            return _json({})
        if op in _NOT_YET or (op == "top" and rest == "locks"):
            # top/locks without a locker: not a cluster node.
            raise S3Error("NotImplemented",
                          f"admin {path} is not served by this server yet")
        raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + path)

    # ------------------------------------------------------------------

    def _server_info(self) -> dict:
        """The JAX package's _server_info (handlers.py:407) for one node:
        each drive with its health state and deadline hits (from its
        HealthChecker; absent on a bare drive), and on a cluster node each
        peer's breaker state (peerFabric, handlers.py:436-446)."""
        drives = []
        online = offline = 0
        all_drives = self.s.obj.all_drives()
        # Deadline'd: info answers while a drive hangs (as offline).
        infos = parallel_map([d.disk_info for d in all_drives],
                             deadline=fleet_deadlines(all_drives)[0])
        for d, di in zip(all_drives, infos):
            hs = getattr(d, "health_state", None)
            health_state = hs() if callable(hs) else None
            if not isinstance(di, Exception):
                online += 1
                entry = {"endpoint": di.endpoint or di.mount_path,
                         "state": "ok", "uuid": di.id,
                         "totalspace": di.total, "availspace": di.free,
                         "healing": di.healing}
            else:
                offline += 1
                entry = {"endpoint": d.endpoint(), "state": "offline"}
            if health_state is not None:
                entry["healthState"] = health_state
                entry["timeouts"] = int(getattr(d, "timeouts", 0) or 0)
            drives.append(entry)
        try:
            health = self.s.obj.health()
        except Exception:  # noqa: BLE001 - info must answer
            health = {}
        return {
            "mode": "online" if health.get("healthy") else "degraded",
            "version": VERSION,
            "uptime": round(time.time() - self.started, 3),
            "drives": drives,
            "drivesOnline": online,
            "drivesOffline": offline,
            "backend": {"backendType": "Erasure",
                        "pools": health.get("pools", health.get("sets", []))},
            "peerFabric": (self.s.cluster_node.peer_fabric_info()
                           if self.s.cluster_node is not None else []),
            "stats": self.s.stats.snapshot(),
        }

    def _node_name(self) -> str:
        node = self.s.cluster_node
        return node.node_name if node is not None else ""

    def _slo(self, rest: str, q: dict, headers, notif):
        """GET slo and slo/history (handlers.py:98-120): the burn-rate
        state federated over the front-door siblings and the peers, or
        this node's metric ring."""
        if rest == "history":
            from minio_tpu_torch.obs import tsdb

            doc = tsdb.get().history(float(q.get("seconds", "0") or 0),
                                     q.get("prefix", ""))
            return _gzjson({"node": self._node_name(), "history": doc}, headers)
        if rest:
            raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + "slo/" + rest)
        from minio_tpu_torch.admin.metrics import collect_cluster_slo

        return _gzjson(collect_cluster_slo(notif, self._node_name()), headers)

    def _faults(self, method: str, read_body):
        """GET and POST faults (handlers.py:280-320): the fault planes can
        sever a cluster, so beyond admin:* the process must have opted in
        (MTPU_FAULT_INJECTION=1)."""
        import os

        from minio_tpu_torch import chaos
        from minio_tpu_torch.chaos import naughty
        from minio_tpu_torch.dist import faultplane

        if os.environ.get("MTPU_FAULT_INJECTION", "") != "1":
            raise S3Error("NotImplemented",
                          "fault injection disabled (set MTPU_FAULT_INJECTION=1)")
        if method == "GET":
            return _json({**faultplane.describe(), "drives": naughty.describe()})
        if method != "POST":
            raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + "faults")
        try:
            doc = json.loads(read_body())
            if not isinstance(doc, dict):
                raise ValueError("fault document must be a JSON object")
            dop = doc.get("op", "")
            if not isinstance(dop, str):
                raise ValueError("fault op must be a string")
            if dop == "clear_all":
                return _json(chaos.clear_all())
            if dop.startswith("drive"):
                return _json(naughty.apply_admin(doc))
            return _json(faultplane.apply_admin(doc))
        except (ValueError, KeyError, TypeError) as e:
            raise S3Error("InvalidArgument", str(e)) from None

    def _heal(self, method: str, rest: str, read_body):
        """POST heal/{bucket}[/{prefix}]: runs the heal and returns the
        per-item results (handlers.py:536; synchronous, as there)."""
        if method != "POST":
            raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + "heal/" + rest)
        bucket, _, prefix = rest.partition("/")
        opts = {}
        body = read_body()
        if body:
            try:
                opts = json.loads(body)
            except ValueError:
                raise S3Error("InvalidArgument", "bad heal opts") from None
        dry = bool(opts.get("dryRun"))
        deep = _scan_deep(opts.get("scanMode", None))
        obj = self.s.obj
        items = []
        try:
            if not bucket:
                for b in obj.list_buckets():
                    items.append(obj.heal_bucket(b.name, dry_run=dry))
            else:
                items.append(obj.heal_bucket(bucket, dry_run=dry))
                items.extend(obj.heal_objects(bucket, prefix, dry_run=dry,
                                              scan_deep=deep))
        except se.BucketNotFound:
            raise S3Error("NoSuchBucket", resource=f"/{bucket}") from None
        return _json({"items": [heal_item(i) for i in items]})

    def _config_kv(self, method: str, path: str, q: dict, read_body):
        """config-kv GET and PUT (handlers.py:592-620). A PUT of
        `storageclass` re-stamps every set's parity at once, one of the log,
        audit or notify_* subsystems rebuilds those targets; the subsystems
        of planes the port lacks are stored and applied by nothing."""
        cfg = self.s.config
        if method == "GET":
            try:
                return _json(cfg.dump(q.get("subsys", "")))
            except ConfigError as e:
                raise S3Error("InvalidRequest", str(e)) from None
        if method == "PUT":
            try:
                doc = json.loads(read_body())
                if not isinstance(doc, dict):
                    raise ValueError(doc)
            except ValueError:
                raise S3Error("InvalidArgument",
                              "config body must be {subsys: {key: value}}") from None
            for subsys, kv in doc.items():
                try:
                    cfg.set_kv(subsys, kv)
                except (ConfigError, AttributeError) as e:
                    raise S3Error("InvalidArgument", str(e)) from None
            if any(s in ("logger_webhook", "audit_webhook", "audit_file") for s in doc):
                self.s.configure_logging()
            if any(s.startswith("notify_") for s in doc):
                self.s.configure_event_targets()
            if "storageclass" in doc:
                self.s.apply_storage_class_config()
            return _json({"restart": [s for s in doc if not cfg.is_dynamic(s)]})
        raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + path)

    def _perf_timelines(self, q: dict) -> dict:
        try:
            worst = int(q.get("worst") or 0)
        except (TypeError, ValueError):
            worst = 0
        # This worker's recorder and its front-door siblings' spools.
        return {"node": obs.current_node(),
                "timelines": flight.collect(q.get("traceid", ""), q.get("api", ""),
                                            worst, q.get("tenant", ""))}

    def _tier(self, method: str, q: dict, read_body):
        """The ILM tiers (handlers.py:352-373; madmin tier add/ls/rm): GET
        lists them (secrets redacted), PUT adds one from its document,
        DELETE removes one only with force=true (objects transitioned to
        it lose their only copy)."""
        from minio_tpu_torch.scanner.tiers import TierError, _from_doc

        reg = self.s.tiers
        if method == "GET":
            return _json({"tiers": reg.list_docs()})
        if method == "PUT":
            try:
                reg.add(_from_doc(json.loads(read_body())))
            except (TierError, ValueError, KeyError) as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({})
        if method == "DELETE":
            try:
                reg.remove(q.get("name", ""), force=q.get("force", "") in ("true", "1"))
            except TierError as e:
                raise S3Error("InvalidArgument", str(e)) from None
            return _json({})
        raise S3Error("MethodNotAllowed", resource=ADMIN_PREFIX + "tier")

    def _bus_stream(self, bus, peer_stream: str, notif=None, type_filter: str = "",
                    traceid: str = "", plane_filter: str = ""):
        """A pubsub (the process trace bus, the logger's console bus) as
        JSON lines (handlers.py:638): a newline every TRACE_HEARTBEAT_S
        while idle, so a client that went away is seen at the next write;
        the stream ends then, or when the server closes, and
        unsubscribes. With `notif` (a cluster node's peers), one puller
        thread per peer feeds the peer's `peer_stream` into the same
        stream; each ends with it."""
        import queue

        merged: queue.Queue = queue.Queue(maxsize=2000)
        stop = threading.Event()

        def pull(peer):
            try:
                # Heartbeats: the stop flag is re-checked on an idle peer.
                for item in getattr(peer, peer_stream)(heartbeats=True):
                    if stop.is_set():
                        return
                    if not item.get("hb"):
                        try:
                            merged.put_nowait(item)
                        except queue.Full:
                            pass
            except Exception:  # noqa: BLE001 - the peer went away
                pass

        for p in (notif.peers if notif is not None else ()):
            threading.Thread(target=pull, args=(p,), daemon=True,
                             name=f"{peer_stream}-peer-pull").start()
        sub = bus.subscribe()

        def next_item():
            try:
                return merged.get_nowait()
            except queue.Empty:
                return sub.get(timeout=TRACE_HEARTBEAT_S)

        try:
            while not self.s.closing.is_set():
                item = next_item()
                if item is None:
                    yield b"\n"
                    continue
                if type_filter and item.get("type", "") != type_filter:
                    continue
                if plane_filter and item.get("plane", "") != plane_filter:
                    continue
                if traceid and traceid not in (item.get("trace_id"),
                                               item.get("requestId")):
                    continue
                yield json.dumps(item).encode() + b"\n"
        finally:
            stop.set()
            sub.close()


# -- the IAM ops (handlers.py:721-777; reference
# cmd/admin-handlers-users.go): (iam, query, read_body) -> (status,
# headers, body) --


def _body_json(read_body) -> dict:
    return json.loads(read_body() or b"{}")


def _add_user(iam, q, read_body):
    body = _body_json(read_body)
    iam.set_user(q["accessKey"], body.get("secretKey", ""), body.get("status", "on"))
    return _json({})


def _list_users(iam, q, read_body):
    return _json({ak: {"status": u.status, "policyName": u.policies}
                  for ak, u in iam.list_users().items()})


def _set_policy_mapping(iam, q, read_body):
    iam.attach_policy(q["userOrGroup"], [p for p in q.get("policyName", "").split(",")
                                         if p], q.get("isGroup") == "true")
    return _json({})


def _update_group(iam, q, read_body):
    body = _body_json(read_body)
    change = iam.remove_group_members if body.get("isRemove") else iam.add_group_members
    change(body.get("group", ""), body.get("members", []))
    return _json({})


def _add_service_account(iam, q, read_body):
    body = _body_json(read_body)
    tc = iam.add_service_account(body.get("parent") or iam.root_access_key,
                                 body.get("policy", ""), body.get("accessKey", ""),
                                 body.get("secretKey", ""))
    return _json({"credentials": {"accessKey": tc.access_key, "secretKey": tc.secret_key}})


def _done(fn):
    """An op that answers {} once fn(iam, q, read_body) returns."""
    def op(iam, q, read_body):
        fn(iam, q, read_body)
        return _json({})
    return op


_IAM_OPS = {
    "add-user": _add_user,
    "remove-user": _done(lambda iam, q, rb: iam.delete_user(q["accessKey"])),
    "list-users": _list_users,
    "set-user-status": _done(lambda iam, q, rb: iam.set_user_status(q["accessKey"],
                                                                      q["status"])),
    "add-canned-policy": _done(lambda iam, q, rb: iam.set_policy(q["name"],
                                                                   rb().decode())),
    "remove-canned-policy": _done(lambda iam, q, rb: iam.delete_policy(q["name"])),
    "list-canned-policies": lambda iam, q, rb: _json(
        {name: json.loads(doc) for name, doc in iam.policies.items()}),
    "set-user-or-group-policy": _set_policy_mapping,
    "update-group-members": _update_group,
    "add-service-account": _add_service_account,
    "delete-service-account": _done(lambda iam, q, rb: iam.delete_service_account(
        q["accessKey"])),
}


def _scan_deep(sm) -> bool:
    """madmin HealOpts.ScanMode: 0/1 (or "normal") shallow, 2 (or "deep")
    verifies every shard's digests; anything else is refused, so a
    mistyped deep request never runs shallow (handlers.py:552-573)."""
    if sm in (None, ""):
        return False
    try:
        smi = int(sm)
    except (TypeError, ValueError):
        smi = {"normal": 1, "deep": 2}.get(str(sm).lower())
    if smi not in (0, 1, 2):
        raise S3Error("InvalidArgument", f"unrecognized scanMode {sm!r}")
    return smi == 2


def heal_item(i) -> dict:
    """One heal result as the JAX route's JSON (handlers.py:781)."""
    out = {"bucket": getattr(i, "bucket", ""),
           "object": getattr(i, "object", ""),
           "versionId": getattr(i, "version_id", ""),
           "objectSize": getattr(i, "object_size", 0),
           "diskCount": getattr(i, "disk_count", 0)}
    if isinstance(i, Exception):
        out["error"] = f"{type(i).__name__}: {i}"
    if getattr(i, "purged", False):
        out["purged"] = True
    before = getattr(i, "before", None)
    after = getattr(i, "after", None)
    if before is not None:
        out["before"] = [{"endpoint": s.endpoint, "state": s.state} for s in before]
    if after is not None:
        out["after"] = [{"endpoint": s.endpoint, "state": s.state} for s in after]
    return out


def _json(doc):
    return 200, {"Content-Type": "application/json"}, json.dumps(doc).encode()


def _gzjson(doc, headers):
    """JSON, gzipped when the request accepts it (the SLO answers carry
    whole metric rings and compress about tenfold)."""
    body, enc = maybe_gzip(json.dumps(doc).encode(), headers.get("Accept-Encoding"))
    hdr = {"Content-Type": "application/json"}
    if enc:
        hdr["Content-Encoding"] = enc
    return 200, hdr, body
