"""Generic inter-node REST client — the shared transport for all RPC planes
(counterpart of minio_tpu/dist/rpc.py, on the same wire).

Role-equivalent of cmd/rest/client.go: POST with URL-encoded args, streaming
request/response bodies, msgpack payloads, and a health-check-driven
online/offline state machine with background reconnect (rest.Client:75,
Call:120, MarkOffline:208).

Peer resilience (the peer-plane mirror of storage/healthcheck.py): every
client runs a per-peer circuit breaker —

    CLOSED --hard connect failure / N consecutive soft failures--> OPEN
    OPEN   --health probe success--> HALF_OPEN (one trial call)
    HALF_OPEN --trial success--> CLOSED   --trial failure--> OPEN

OPEN fails every call instantly with the per-drive DiskNotFound the
quorum reducers expect, with ZERO socket work (the drive plane's OFFLINE
state, applied to a peer). Idempotent metadata-class routes get bounded
retries with jittered exponential backoff drawn from a per-peer token
bucket, so a cluster of retrying clients cannot amplify an outage into a
retry storm; when the bucket is dry the call is shed instead of retried.

Auth: every call carries an HMAC token derived from the cluster secret
(the reference signs inter-node requests with a JWT from the root
credentials, cmd/jwt/). Tokens are cheap to mint per call and expire.

Payloads are msgpack through the port's own codec (utils/msgpack.py),
whose bytes are msgpack-python's: the machine with the card has no
msgpack package.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import http.client
import json
import os
import random
import socket
import threading
import time
import urllib.parse
import weakref
from typing import Iterable, Iterator

from minio_tpu_torch import obs
from minio_tpu_torch.dist import faultplane as _faults
from minio_tpu_torch.utils import errors as se
from minio_tpu_torch.utils import msgpack

DEFAULT_TIMEOUT = 30.0
HEALTH_INTERVAL = 1.0        # reconnect probe cadence during the grace runs
HEALTH_GRACE_PROBES = 3      # probes at base cadence before backing off
HEALTH_BACKOFF_CAP = 10.0    # max delay between reconnect probes
ERR_STATUS = 599  # carries a typed storage error in the body
# Idle keep-alive connections kept per peer (the JAX client keeps 8): a
# node's S3 requests fan out to every drive of a peer at once, and a
# connection set up per call costs a handshake on the metadata path.
POOL_CONNS = 64

# Circuit-breaker states (also the gauge encoding, mirroring the drive
# plane's 0=online/1=faulty/2=offline convention).
BREAKER_CLOSED = 0
BREAKER_HALF_OPEN = 1
BREAKER_OPEN = 2
_STATE_NAMES = {BREAKER_CLOSED: "closed", BREAKER_HALF_OPEN: "half-open",
                BREAKER_OPEN: "open"}

# Soft (mid-call) transport failures tolerated before the breaker opens;
# hard failures (connect refused/timeout — the partition signature) open
# it immediately, exactly as mark_offline always has.
BREAKER_FAILURES = int(os.environ.get("MTPU_PEER_BREAKER_FAILURES", "3"))
# Retry policy for idempotent metadata-class routes.
RETRY_MAX = int(os.environ.get("MTPU_PEER_RETRIES", "2"))
RETRY_BUDGET = float(os.environ.get("MTPU_PEER_RETRY_BUDGET", "8"))
RETRY_REFILL = float(os.environ.get("MTPU_PEER_RETRY_REFILL", "1.0"))

# Routes safe to replay: reads and pure checks. Mutating routes and the
# whole lock plane (dsync owns its own retry loop) NEVER retry — a
# replayed rename_data or lock() could double-apply.
IDEMPOTENT_ROUTES = frozenset({
    # storage plane reads / checks
    "disk_info", "get_disk_id", "read_format", "list_vols", "stat_vol",
    "read_all", "list_dir", "stat_file", "read_version", "read_xl",
    "read_file_stream", "walk_dir", "verify_file", "check_parts",
    # peer / bootstrap control reads
    "health", "server_info", "obd_info", "metrics", "verify",
})

# Fabric observability: the r5 TCP_NODELAY fix and the adaptive connect
# deadline are only provable with a live latency distribution + failure
# counters per peer (reference minio_inter_node_* metric families).
_RPC_LATENCY = obs.histogram(
    "minio_tpu_rpc_latency_seconds",
    "Inter-node RPC call latency by peer", ("peer",))
_RPC_ERRORS = obs.counter(
    "minio_tpu_rpc_errors_total",
    "RPC calls failed on network/timeout by peer", ("peer",))
_RPC_OFFLINE = obs.counter(
    "minio_tpu_rpc_offline_total",
    "Transitions of a peer to offline", ("peer",))
_RPC_RECONNECTS = obs.counter(
    "minio_tpu_rpc_reconnects_total",
    "Successful reconnects after a peer went offline", ("peer",))
# Breaker families carry a `lane` label: the fabric client and the
# dedicated metrics-pull client run INDEPENDENT breakers to the same
# peer (by design — an observability stall must not mark the data plane
# offline), so sharing one gauge child would let whichever client wrote
# last mask the other's OPEN state.
_BREAKER_STATE = obs.gauge(
    "minio_tpu_peer_breaker_state",
    "Per-peer circuit breaker: 0=closed, 1=half-open, 2=open",
    ("peer", "lane"))
_BREAKER_TRANSITIONS = obs.counter(
    "minio_tpu_peer_breaker_transitions_total",
    "Circuit breaker state entries by peer, lane, and state",
    ("peer", "lane", "state"))
_RPC_RETRIES = obs.counter(
    "minio_tpu_rpc_retries_total",
    "Idempotent RPC retries attempted by peer", ("peer",))
_RPC_SHED = obs.counter(
    "minio_tpu_rpc_retry_shed_total",
    "Retries shed because the per-peer retry budget was exhausted",
    ("peer",))

# Every live RestClient, weakly: the chaos plane's teardown
# (chaos.clear_all) re-closes breakers a storm opened, so an aborted storm
# cannot bleed OPEN peers into what runs next.
_CLIENTS: "weakref.WeakSet" = weakref.WeakSet()
_CLIENTS_MU = threading.Lock()


def _clients() -> list:
    with _CLIENTS_MU:
        return list(_CLIENTS)


def reset_breakers() -> int:
    """Force every OPEN or HALF_OPEN breaker in the process back to
    CLOSED (chaos teardown). Returns how many breakers were reset."""
    return sum(1 for c in _clients() if c.reset_breaker())


# --- auth tokens -------------------------------------------------------------

def sign_token(secret: str, ttl: float = 900.0, now: float | None = None) -> str:
    """Mint an expiring HMAC bearer token binding the cluster secret."""
    payload = json.dumps({"exp": (now or time.time()) + ttl}).encode()
    mac = hmac.new(secret.encode(), payload, hashlib.sha256).digest()
    return (base64.urlsafe_b64encode(payload).decode().rstrip("=")
            + "." + base64.urlsafe_b64encode(mac).decode().rstrip("="))


def verify_token(secret: str, token: str, now: float | None = None) -> bool:
    try:
        p64, m64 = token.split(".")
        pad = lambda s: s + "=" * (-len(s) % 4)  # noqa: E731
        payload = base64.urlsafe_b64decode(pad(p64))
        mac = base64.urlsafe_b64decode(pad(m64))
        want = hmac.new(secret.encode(), payload, hashlib.sha256).digest()
        if not hmac.compare_digest(mac, want):
            return False
        return json.loads(payload)["exp"] >= (now or time.time())
    except Exception:
        return False


# --- wire helpers ------------------------------------------------------------

def pack(obj) -> bytes:
    return msgpack.packb(obj)


def unpack(raw: bytes):
    return msgpack.unpackb(raw)


# ("plane", "method") from /rpc/{plane}/v1/{method} — ONE parser shared
# with fault matching, so retry-idempotence classification can never
# desynchronize from it.
_route_of = _faults.FaultPlane._route_of


class _RetryBudget:
    """Token bucket bounding retries per peer: capacity tokens, refilled
    at `refill`/s. One retry = one token; an empty bucket sheds instead
    of retrying (the SRE retry-budget discipline — retries must never
    multiply offered load during an outage)."""

    __slots__ = ("capacity", "tokens", "refill", "last", "_mu")

    def __init__(self, capacity: float, refill: float):
        self.capacity = float(capacity)
        self.tokens = float(capacity)
        self.refill = float(refill)
        self.last = time.monotonic()
        self._mu = threading.Lock()

    def take(self) -> bool:
        with self._mu:
            now = time.monotonic()
            self.tokens = min(self.capacity,
                              self.tokens + (now - self.last) * self.refill)
            self.last = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


class _ResponseStream:
    """File-like over an HTTP response that returns its connection to the
    pool on close (exactly-once) — and NEVER after a stream error: a
    connection whose body read failed mid-flight is out of protocol sync,
    and pooling it would surface the breakage as a confusing failure on
    the next unrelated call."""

    def __init__(self, resp: http.client.HTTPResponse, client: "RestClient",
                 conn: http.client.HTTPConnection, fault=None):
        self._resp = resp
        self._client = client
        self._conn = conn
        self._closed = False
        self._fault = fault          # claimed truncate/corrupt FaultRule
        self._fault_seen = 0

    def _fail(self, e: Exception) -> "se.StorageError":
        """Mid-stream network failure: degrade like any per-drive error
        (quorum layers expect StorageError subtypes, not raw socket
        exceptions) and stop pooling the broken connection."""
        self._closed = True
        try:
            self._conn.close()
        except Exception:  # noqa: BLE001
            pass
        self._client._note_failure()
        return self._client._transport_error(e)

    def _check_fault(self, data: bytes) -> bytes:
        rule = self._fault
        if rule is None:
            return data
        if rule.action == _faults.TRUNCATE:
            # Cut at EXACTLY after_bytes: deliver only the valid prefix
            # of the violating chunk, then reset on the next read — the
            # consumer really receives a stream cut mid-flight, not a
            # whole extra chunk.
            remaining = rule.after_bytes - self._fault_seen
            if remaining <= 0:
                raise self._fail(ConnectionResetError(
                    f"faultplane: stream truncated after "
                    f"{rule.after_bytes} bytes"))
            if len(data) > remaining:
                self._fault_seen = rule.after_bytes
                return data[:remaining]
            self._fault_seen += len(data)
            return data
        if data:  # corrupt: flip the first byte of every chunk
            return bytes([data[0] ^ rule.xor]) + data[1:]
        return data

    def read(self, n: int = -1) -> bytes:
        try:
            data = (self._resp.read() if n is None or n < 0
                    else self._resp.read(n))
        except (OSError, http.client.HTTPException) as e:
            raise self._fail(e) from e
        return self._check_fault(data)

    def read1(self, n: int = 65536) -> bytes:
        """Return whatever is available (at most n) without waiting for n
        bytes — read(n) on a chunked response blocks until it accumulates n,
        which would stall live streams (trace/console subscriptions) whose
        documents trickle in."""
        try:
            data = self._resp.read1(n)
        except (OSError, http.client.HTTPException) as e:
            raise self._fail(e) from e
        return self._check_fault(data)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Drain so the connection is reusable — but bounded in both bytes
        # (1 MiB) and time (250 ms): an endless subscription stream
        # (trace/console heartbeats) would otherwise block this close
        # forever. Undrainable connections are dropped, not pooled.
        try:
            if self._resp.isclosed():
                self._client._put_conn(self._conn)
                return
            sock = self._conn.sock
            prev_timeout = sock.gettimeout() if sock is not None else None
            if sock is not None:
                sock.settimeout(0.25)
            leftover = self._resp.read(1 << 20)
            if leftover and len(leftover) == (1 << 20):
                self._conn.close()
                return
            if sock is not None:
                sock.settimeout(prev_timeout)  # the client's configured timeout
            self._client._put_conn(self._conn)
        except Exception:
            try:
                self._conn.close()
            except Exception:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RestClient:
    """One per (node, plane-root). `call()` raises typed storage errors
    re-hydrated from the wire; network failures feed the per-peer circuit
    breaker and a daemon probe brings an OPEN peer back through HALF_OPEN
    (cmd/rest/client.go:135-168)."""

    def __init__(self, host: str, port: int, secret: str,
                 timeout: float = DEFAULT_TIMEOUT,
                 breaker_failures: int | None = None,
                 retries: int | None = None,
                 retry_budget: float | None = None,
                 retry_refill: float | None = None, name: str = "",
                 lane: str = "fabric"):
        """name: the peer's ADVERTISED identity (S3 host:port in a
        cluster) — the `peer` label on every fabric metric and the
        fault-injection destination; defaults to the transport address.
        lane: distinguishes independent breakers to the same peer on the
        breaker metric families (the metrics-pull client passes
        "metrics" so its breaker cannot mask the fabric one). Plain HTTP
        only: the fabric over TLS is not ported yet."""
        from minio_tpu_torch.utils.dyntimeout import DynamicTimeout

        self.host = host
        self.port = port
        self.secret = secret
        self.timeout = timeout
        # Self-tuning per-call deadline (reference dynamicTimeout,
        # cmd/dynamic-timeouts.go:35): a congested fabric inflates it,
        # a healthy one converges it down for faster failure detection.
        self.dyn_timeout = DynamicTimeout(timeout, minimum=min(1.0, timeout))
        self._lock = threading.Lock()
        self._pool: list[http.client.HTTPConnection] = []
        self._probing = False
        self._closed = False
        self._probe_stop = threading.Event()
        peer = name or f"{host}:{port}"
        # Fault-injection identity: src is OUR node ("" for standalone
        # clients, overridden by the cluster with its advertised name),
        # dst the peer's advertised identity — partitions are declared
        # in topology terms, not transport ports.
        self.fault_src = ""
        self.fault_dst = peer
        # -- circuit breaker + retry budget --
        self._state = BREAKER_CLOSED
        self._consec = 0
        self._half_open_busy = False
        self._opens = 0
        self._retries = 0
        self._shed = 0
        self._breaker_failures = (BREAKER_FAILURES if breaker_failures is None
                                  else int(breaker_failures))
        self._retry_max = RETRY_MAX if retries is None else int(retries)
        self._retry_budget = _RetryBudget(
            RETRY_BUDGET if retry_budget is None else retry_budget,
            RETRY_REFILL if retry_refill is None else retry_refill)
        self._retry_rng = random.Random()
        self._obs_peer = peer
        self._obs_lane = lane
        self._obs_lat = _RPC_LATENCY.labels(peer=peer)
        self._obs_err = _RPC_ERRORS.labels(peer=peer)
        self._obs_off = _RPC_OFFLINE.labels(peer=peer)
        self._obs_rec = _RPC_RECONNECTS.labels(peer=peer)
        self._obs_breaker = _BREAKER_STATE.labels(peer=peer, lane=lane)
        self._obs_retry = _RPC_RETRIES.labels(peer=peer)
        self._obs_shed = _RPC_SHED.labels(peer=peer)
        self._obs_breaker.set(BREAKER_CLOSED)
        with _CLIENTS_MU:
            _CLIENTS.add(self)

    def _transport_error(self, e: Exception) -> se.StorageError:
        """Typed per-drive error for a NETWORK failure, tagged so the
        retry loop can tell it from a DiskNotFound the peer sent over the
        wire (which must never be retried — the peer answered)."""
        err = se.DiskNotFound(f"{self.host}:{self.port}: {e}")
        err.transport = True
        return err

    # -- connection pool --

    def _new_conn(self, timeout: float | None = None, path: str = ""
                  ) -> http.client.HTTPConnection:
        # Connection ESTABLISHMENT is a metadata-class round trip: bound
        # it by the adaptive deadline (converged ~1 s on a healthy
        # fabric), not the static bulk timeout — a blackholed peer must
        # trip failure detection fast.
        deadline = (timeout if timeout is not None
                    else self.dyn_timeout.timeout())
        try:
            fp = _faults.get()
            if fp is not None:
                # Partition / refusal faults fire BEFORE any socket
                # exists — an OPEN breaker on a partitioned peer really
                # does zero socket work.
                fp.on_connect(self.fault_src, self.fault_dst, path)
            conn = http.client.HTTPConnection(self.host, self.port,
                                              timeout=deadline)
            # http.client sends headers and small bodies as separate
            # segments; without TCP_NODELAY, Nagle holds the second one for
            # the peer's delayed ACK (~40 ms) on EVERY metadata round trip.
            # Eager connect keeps failure semantics: a dead node surfaces as
            # the per-drive DiskNotFound the quorum reducers expect, exactly
            # as it would have at request time.
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError as e:
            if isinstance(e, TimeoutError):
                self.dyn_timeout.log_failure()
            # Connect-phase failure is the partition signature: the
            # breaker opens immediately (hard), as mark_offline always
            # did here.
            self.mark_offline()
            raise self._transport_error(e) from e
        return conn

    def _get_conn(self, path: str = "") -> http.client.HTTPConnection:
        with self._lock:
            if self._pool:
                return self._pool.pop()
        return self._new_conn(path=path)

    def _put_conn(self, conn: http.client.HTTPConnection) -> None:
        with self._lock:
            # A client closed while this call was in flight must not have
            # its socket resurrected into the pool (it would leak).
            if not self._closed and len(self._pool) < POOL_CONNS:
                self._pool.append(conn)
                return
        conn.close()

    # -- circuit breaker --

    def is_online(self) -> bool:
        return self._state != BREAKER_OPEN

    def breaker_state(self) -> int:
        return self._state

    def breaker_info(self) -> dict:
        """Admin server-info surface: one peer's fabric health."""
        return {"peer": self.fault_dst,
                "transport": f"{self.host}:{self.port}",
                "state": _STATE_NAMES[self._state],
                "consecutiveFailures": self._consec,
                "opens": self._opens,
                "retries": self._retries,
                "retriesShed": self._shed}

    def _enter_state(self, state: int) -> None:
        self._obs_breaker.set(state)
        _BREAKER_TRANSITIONS.labels(peer=self._obs_peer,
                                    lane=self._obs_lane,
                                    state=_STATE_NAMES[state]).inc()

    def _note_failure(self, hard: bool = False) -> None:
        """Account one transport failure. Soft (mid-call) failures open
        the breaker after `breaker_failures` consecutive strikes; hard
        ones (connect refusal, a failed HALF_OPEN trial) open it now."""
        with self._lock:
            self._consec += 1
            tripped = (hard or self._state == BREAKER_HALF_OPEN
                       or self._consec >= self._breaker_failures)
        if tripped:
            self.mark_offline()

    def _note_success(self) -> None:
        closed = False
        with self._lock:
            self._consec = 0
            if self._state == BREAKER_HALF_OPEN:
                self._state = BREAKER_CLOSED
                self._half_open_busy = False
                closed = True
        if closed:
            self._enter_state(BREAKER_CLOSED)

    def reset_breaker(self) -> bool:
        """Force the breaker back to CLOSED: chaos teardown only (a live
        breaker heals through the probe and HALF_OPEN). The probe loop
        sees the flip and retires; a closed client is left alone. True
        when a breaker that was not CLOSED was reset."""
        with self._lock:
            if self._closed or self._state == BREAKER_CLOSED:
                return False
            self._state = BREAKER_CLOSED
            self._half_open_busy = False
            self._consec = 0
        self._enter_state(BREAKER_CLOSED)
        return True

    def mark_offline(self) -> None:
        start_probe = False
        with self._lock:
            if self._state == BREAKER_OPEN:
                return
            self._state = BREAKER_OPEN
            self._half_open_busy = False
            self._consec = 0
            self._opens += 1
            self._obs_off.inc()
            if not self._probing and not self._closed:
                self._probing = True
                start_probe = True
        self._enter_state(BREAKER_OPEN)
        if start_probe:
            t = threading.Thread(target=self._probe_loop, daemon=True,
                                 name=f"rpc-health-{self.host}:{self.port}")
            t.start()

    def _probe_loop(self) -> None:
        """Reconnect probe: a short grace run at the base cadence (quick
        restarts — the common case — reconnect as fast as ever), then
        exponential backoff with jitter (capped) so a long-dead peer
        costs one cheap probe every ~HEALTH_BACKOFF_CAP seconds instead
        of one per second forever, with probes across many clients
        decorrelated instead of thundering in lockstep. A probe success
        enters HALF_OPEN — the next real call is the single trial that
        decides CLOSED vs back to OPEN. close() stops a running probe
        via the event (no leaked daemon)."""
        delay = HEALTH_INTERVAL
        failures = 0
        while not self._probe_stop.wait(delay * random.uniform(0.6, 1.0)):
            with self._lock:
                # A breaker forced CLOSED out of band (reset_breaker)
                # retires the probe.
                if self._state != BREAKER_OPEN:
                    self._probing = False
                    return
            try:
                conn = self._new_conn(timeout=2.0, path="/health")
                conn.request("GET", "/health")
                ok = conn.getresponse().status == 200
                conn.close()
            except Exception:
                ok = False
            if ok:
                with self._lock:
                    # A reset_breaker() that landed during this round trip
                    # has closed the breaker: keep it CLOSED.
                    if self._state != BREAKER_OPEN:
                        self._probing = False
                        return
                    self._state = BREAKER_HALF_OPEN
                    self._half_open_busy = False
                    self._probing = False
                self._obs_rec.inc()
                self._enter_state(BREAKER_HALF_OPEN)
                return
            failures += 1
            if failures >= HEALTH_GRACE_PROBES:
                delay = min(delay * 2.0, HEALTH_BACKOFF_CAP)
        with self._lock:
            self._probing = False

    def close(self) -> None:
        """Idempotent; safe against in-flight calls — their pooled
        connections are closed on return (_put_conn checks _closed) and
        the probe thread can neither survive nor respawn."""
        with self._lock:
            self._closed = True
            for c in self._pool:
                try:
                    c.close()
                except Exception:
                    pass
            self._pool.clear()
        self._probe_stop.set()

    # -- calls --

    def _obs_done(self, path: str, dt: float, status: int = 0,
                  err: Exception | None = None) -> None:
        """Record one fabric round trip: latency for completed round
        trips, the error counter for network failures, and a typed `rpc`
        trace record when watched. Failures stay OUT of the latency
        histogram — connect refusals (near-zero) and timeouts (deadline-
        length) would bend the very distribution the family exists to
        prove; they have their own counter."""
        if err is None:
            self._obs_lat.observe(dt)
        else:
            self._obs_err.inc()
        if obs.has_subscribers():
            rec = {"type": "rpc", "time": time.time(),
                   "peer": self._obs_peer, "path": path,
                   "durationNs": int(dt * 1e9)}
            if status:
                rec["status"] = status
            if err is not None:
                rec["error"] = f"{type(err).__name__}: {err}"
            obs.publish(rec)

    def call(self, path: str, params: dict | None = None,
             body: bytes | Iterable[bytes] | None = None,
             stream: bool = False) -> bytes | _ResponseStream:
        """POST {path}?{params} with optional (possibly chunked) body.

        Returns the full response body, or a file-like if stream=True.
        Raises DiskNotFound when the node is offline / unreachable
        (the per-drive error the quorum reducers expect).

        Idempotent metadata-class routes retry transport failures with
        jittered exponential backoff, bounded by `retries` and the
        per-peer retry budget; everything else is single-shot."""
        plane, route = _route_of(path)
        retryable = (route in IDEMPOTENT_ROUTES and plane != "lock"
                     and (body is None
                          or isinstance(body, (bytes, bytearray))))
        attempt = 0
        while True:
            try:
                return self._call_once(path, params, body, stream)
            except se.StorageError as e:
                if (not retryable or attempt >= self._retry_max
                        or not getattr(e, "transport", False)
                        or not self.is_online()):
                    raise
                if not self._retry_budget.take():
                    self._shed += 1
                    self._obs_shed.inc()
                    raise
                attempt += 1
                self._retries += 1
                self._obs_retry.inc()
                # Decorrelated exponential backoff, capped at 1 s.
                time.sleep(min(1.0, 0.05 * (1 << (attempt - 1)))
                           * self._retry_rng.uniform(0.5, 1.0))

    def _call_once(self, path: str, params: dict | None,
                   body, stream: bool) -> bytes | _ResponseStream:
        state = self._state
        if state == BREAKER_OPEN:
            # Fail-fast: zero socket work, exactly like a drive OFFLINE.
            raise se.DiskNotFound(
                f"{self.host}:{self.port} offline (breaker open)")
        trial = False
        if state == BREAKER_HALF_OPEN:
            with self._lock:
                if self._state == BREAKER_HALF_OPEN:
                    if self._half_open_busy:
                        raise se.DiskNotFound(
                            f"{self.host}:{self.port} half-open: trial "
                            f"call in flight")
                    self._half_open_busy = True
                    trial = True
        try:
            return self._do_call(path, params, body, stream, trial)
        finally:
            if trial:
                with self._lock:
                    self._half_open_busy = False

    def _do_call(self, path: str, params: dict | None, body, stream: bool,
                 trial: bool) -> bytes | _ResponseStream:
        qs = urllib.parse.urlencode(params or {})
        url = path + ("?" + qs if qs else "")
        headers = {"Authorization": "Bearer " + sign_token(self.secret)}
        # Distributed tracing: carry the originating request's trace id
        # across the fabric so the peer's storage/RPC records correlate
        # with ours (the reference forwards its amz request id on peer
        # REST the same way). One contextvar read — nil outside a traced
        # request.
        tid = obs.trace_id()
        if tid:
            headers["x-mtpu-trace-id"] = tid
        fp = _faults.get()
        t_conn = time.monotonic()
        try:
            conn = self._get_conn(path)
        except se.StorageError as e:
            self._obs_done(path, time.monotonic() - t_conn, err=e)
            raise
        # The adaptive deadline governs METADATA-class calls only (no
        # body / small body). Bulk transfers (chunked shard uploads) keep
        # the static timeout — a deadline converged on 10 ms metadata
        # round-trips must not declare a healthy node dead because one
        # multi-MB send waited out a congested TCP window. Convergence
        # likewise learns only from the metadata class.
        adaptive = body is None or (
            isinstance(body, (bytes, bytearray)) and len(body) <= (1 << 20))
        deadline = self.dyn_timeout.timeout() if adaptive else self.timeout
        if conn.sock is not None:
            conn.sock.settimeout(deadline)
        else:
            conn.timeout = deadline
        t0 = time.monotonic()
        try:
            if fp is not None:
                # Delay/reset faults degrade through this except block,
                # exactly like their real-network counterparts.
                fp.on_request(self.fault_src, self.fault_dst, path)
            if body is None:
                conn.request("POST", url, headers=headers)
            elif isinstance(body, (bytes, bytearray)):
                conn.request("POST", url, body=bytes(body), headers=headers)
            else:
                headers["Transfer-Encoding"] = "chunked"
                conn.request("POST", url, body=iter(body), headers=headers,
                             encode_chunked=True)
            resp = conn.getresponse()
        except (OSError, http.client.HTTPException) as e:
            try:
                conn.close()
            except Exception:
                pass
            if adaptive and isinstance(e, TimeoutError):
                self.dyn_timeout.log_failure()
            self._obs_done(path, time.monotonic() - t0, err=e)
            self._note_failure(hard=trial)
            raise self._transport_error(e) from e
        if adaptive:
            self.dyn_timeout.log_success(time.monotonic() - t0)
        fspec = (fp.response_fault(self.fault_src, self.fault_dst, path)
                 if fp is not None else None)

        try:
            if resp.status == ERR_STATUS:
                raw = resp.read()
                if fspec is not None:
                    raw = self._apply_body_fault(fspec, raw)
                self._put_conn(conn)
                # A typed storage error is a SUCCESSFUL fabric round trip
                # — latency counts, the error counter does not.
                self._obs_done(path, time.monotonic() - t0,
                               status=resp.status)
                self._note_success()
                try:
                    doc = unpack(raw)
                except Exception as e:  # noqa: BLE001 - corrupt payload
                    # The round trip completed (body fully read, conn
                    # already safely pooled) but the error document is
                    # garbage: surface typed, never a raw msgpack error.
                    raise se.FaultyDisk(
                        f"{self.host}:{self.port}{path}: corrupt error "
                        f"payload: {e}") from e
                raise se.by_name(doc.get("err", "StorageError"),
                                 doc.get("msg", ""))
            if resp.status != 200:
                msg = resp.read()[:512].decode(errors="replace")
                self._put_conn(conn)
                # Completed round trip (like the 599 path): real latency,
                # not a network failure — keep it out of the error counter.
                self._obs_done(path, time.monotonic() - t0,
                               status=resp.status)
                self._note_success()
                raise se.FaultyDisk(
                    f"{self.host}:{self.port}{path}: HTTP {resp.status} {msg}")
            if stream:
                # Long-lived body (walk streams, shard reads, trace subs):
                # restore the STATIC timeout — the adaptive deadline paces
                # request/first-byte only, and a converged ~1s deadline
                # must not kill a legitimately slow stream mid-read.
                if conn.sock is not None:
                    conn.sock.settimeout(self.timeout)
                # Stream latency = time to first byte; the body pays as
                # the caller drains.
                self._obs_done(path, time.monotonic() - t0, status=200)
                self._note_success()
                return _ResponseStream(resp, self, conn, fault=fspec)
            data = resp.read()
            if fspec is not None:
                data = self._apply_body_fault(fspec, data)
        except (OSError, http.client.HTTPException) as e:
            # Body-read failure (incl. a timeout on a converged deadline):
            # same per-drive degradation as a connect failure — quorum
            # layers expect StorageError subtypes, never raw TimeoutError.
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass
            if isinstance(e, TimeoutError):
                self.dyn_timeout.log_failure()
            self._obs_done(path, time.monotonic() - t0, err=e)
            self._note_failure(hard=trial)
            raise self._transport_error(e) from e
        self._put_conn(conn)
        self._obs_done(path, time.monotonic() - t0, status=200)
        self._note_success()
        return data

    @staticmethod
    def _apply_body_fault(rule, data: bytes) -> bytes:
        """Injected response faults on a buffered body: truncation is a
        transport failure (raises into the body-read except path, so the
        connection is dropped, never pooled); corruption is a payload
        fault on an intact transport (the conn stays reusable)."""
        if rule.action == _faults.TRUNCATE:
            raise ConnectionResetError(
                f"faultplane: body truncated after {rule.after_bytes} bytes")
        if data:
            return bytes([data[0] ^ rule.xor]) + data[1:]
        return data

    def call_msgpack(self, path: str, params: dict | None = None,
                     body: bytes | Iterable[bytes] | None = None):
        raw = self.call(path, params, body)
        return unpack(raw) if raw else None

    def iter_msgpack(self, path: str, params: dict | None = None) -> Iterator:
        """Stream a sequence of msgpack documents (walk_dir entries)."""
        st = self.call(path, params, stream=True)
        assert isinstance(st, _ResponseStream)
        try:
            unpacker = msgpack.Unpacker()
            while True:
                chunk = st.read1(1 << 16)
                if not chunk:
                    break
                unpacker.feed(chunk)
                yield from unpacker
        finally:
            st.close()
