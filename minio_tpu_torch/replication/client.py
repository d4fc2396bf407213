"""Fault-aware SigV4 S3 client (counterpart of
minio_tpu/replication/client.py: RemoteS3Error, RemoteS3Unreachable and
RemoteS3Client with its per-target breakers; the S3 tier of
scanner/tiers.py rides it). The replication pool and its rules come with
the rest of `replication/`.

The runtime-side S3 client (the reference uses minio-go for its remote
targets): stdlib http.client, signed by the port's s3/sigv4.py, carrying
the same fault contracts as the inter-node fabric (dist/rpc.py):

- **faultplane** — every request consults `dist/faultplane.py` at the
  three fabric points: connect (partitions/refusals fire before any
  socket exists), request (delay / mid-call reset), response
  (truncation / corruption of the body). Identities are
  (`fault_src` = this node's advertised name, `fault_dst` =
  "host:port" of the target).
- **per-target circuit breaker** — shared process-wide per target
  endpoint, mirroring RestClient semantics: hard failures (connect
  refusal — the partition signature) open immediately,
  `MTPU_PEER_BREAKER_FAILURES` soft strikes open, a background probe
  (same grace-then-backoff cadence) enters HALF_OPEN, the next call is
  the single trial. OPEN = `RemoteS3Unreachable` with zero socket work.
- **retry budget + backoff** — idempotent verbs retry transport
  failures with the fabric's decorrelated jittered backoff, funded by
  a per-target token bucket (`MTPU_PEER_RETRY_BUDGET`/`_REFILL`).

The signature covers the decoded path, the form the server
canonicalizes; the JAX client signs the already-quoted path, which
differs only for keys that need percent-encoding (where its signature
does not verify).
"""

from __future__ import annotations

import hashlib
import http.client
import random
import threading
import time
import urllib.parse

from minio_tpu_torch import obs
from minio_tpu_torch.dist import faultplane as _faults
from minio_tpu_torch.dist import rpc as _rpc
from minio_tpu_torch.s3 import sigv4

UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"


class RemoteS3Error(Exception):
    """The target answered with a non-2xx HTTP status (a SUCCESSFUL
    fabric round trip — it closes breaker strikes, not opens them)."""

    def __init__(self, status: int, detail: str = ""):
        self.status = status
        super().__init__(f"remote S3 error HTTP {status}: {detail[:200]}")


class RemoteS3Unreachable(OSError):
    """Transport-level failure (connect refusal, reset, timeout,
    truncation) or an OPEN breaker: the target could not be reached.
    Subclasses OSError so legacy `except OSError` call sites keep
    classifying it as a network failure."""


# -- per-target breaker registry --------------------------------------

_BREAKER_STATE = obs.gauge(
    "minio_tpu_replication_target_breaker_state",
    "Replication target breaker: 0=closed, 1=half-open, 2=open",
    ("target",))
_BREAKER_TRANSITIONS = obs.counter(
    "minio_tpu_replication_breaker_transitions_total",
    "Replication target breaker state transitions", ("target", "state"))
_RETRIES = obs.counter(
    "minio_tpu_replication_retries_total",
    "Replication request retries after transport failure", ("target",))
_RETRIES_SHED = obs.counter(
    "minio_tpu_replication_retries_shed_total",
    "Replication retries shed by an empty per-target retry budget",
    ("target",))


class TargetBreaker:
    """One breaker + retry budget per target endpoint, shared by every
    RemoteS3Client in the process (the reference's globalBucketTargetSys
    keeps one health state per ARN the same way). State machine and
    probe cadence mirror dist/rpc.py's RestClient."""

    def __init__(self, target: str, host: str, port: int, https: bool,
                 fault_src: str):
        self.target = target
        self.host = host
        self.port = port
        self.https = https
        self.fault_src = fault_src
        self._lock = threading.Lock()
        self._state = _rpc.BREAKER_CLOSED
        self._consec = 0
        self._half_open_busy = False
        self._probing = False
        self._probe_stop = threading.Event()
        self.opens = 0
        self.budget = _rpc._RetryBudget(_rpc.RETRY_BUDGET, _rpc.RETRY_REFILL)
        self.rng = random.Random(zlib_crc(target))
        self._obs_state = _BREAKER_STATE.labels(target=target)
        self._obs_state.set(_rpc.BREAKER_CLOSED)

    # -- state accounting ----------------------------------------------

    def state(self) -> int:
        return self._state

    def _enter(self, state: int) -> None:
        self._obs_state.set(state)
        _BREAKER_TRANSITIONS.labels(
            target=self.target, state=_rpc._STATE_NAMES[state]).inc()

    def note_failure(self, hard: bool = False) -> None:
        with self._lock:
            self._consec += 1
            tripped = (hard or self._state == _rpc.BREAKER_HALF_OPEN
                       or self._consec >= _rpc.BREAKER_FAILURES)
        if tripped:
            self.mark_offline()

    def note_success(self) -> None:
        closed = False
        with self._lock:
            self._consec = 0
            if self._state == _rpc.BREAKER_HALF_OPEN:
                self._state = _rpc.BREAKER_CLOSED
                self._half_open_busy = False
                closed = True
        if closed:
            self._enter(_rpc.BREAKER_CLOSED)

    def mark_offline(self) -> None:
        start_probe = False
        with self._lock:
            if self._state == _rpc.BREAKER_OPEN:
                return
            self._state = _rpc.BREAKER_OPEN
            self._half_open_busy = False
            self._consec = 0
            self.opens += 1
            if not self._probing:
                self._probing = True
                start_probe = True
        self._enter(_rpc.BREAKER_OPEN)
        if start_probe:
            threading.Thread(target=self._probe_loop, daemon=True,
                             name=f"repl-health-{self.target}").start()

    def reset(self) -> bool:
        """Force CLOSED (chaos teardown; a live breaker heals through
        the probe and HALF_OPEN). True when it was not CLOSED."""
        with self._lock:
            if self._state == _rpc.BREAKER_CLOSED:
                return False
            self._state = _rpc.BREAKER_CLOSED
            self._half_open_busy = False
            self._consec = 0
        self._enter(_rpc.BREAKER_CLOSED)
        return True

    def begin_trial(self) -> bool:
        """Claim the single HALF_OPEN trial slot."""
        with self._lock:
            if self._state != _rpc.BREAKER_HALF_OPEN or self._half_open_busy:
                return False
            self._half_open_busy = True
            return True

    def end_trial(self) -> None:
        with self._lock:
            self._half_open_busy = False

    # -- reconnect probe -----------------------------------------------

    def _probe_once(self) -> bool:
        """One liveness round trip: any HTTP response proves the link
        (a 403 from a foreign S3 is as alive as a 200 from ours). Rides
        the faultplane connect hook, so a partitioned target stays OPEN
        with zero request-path socket work until the partition heals."""
        try:
            fp = _faults.get()
            if fp is not None:
                fp.on_connect(self.fault_src, self.target,
                              "/minio/health/live")
            cls = (http.client.HTTPSConnection if self.https
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=2.0)
            try:
                conn.request("GET", "/minio/health/live")
                conn.getresponse().read()
            finally:
                conn.close()
            return True
        except (OSError, http.client.HTTPException, ValueError):
            return False   # any transport failure = still down

    def _probe_loop(self) -> None:
        delay = _rpc.HEALTH_INTERVAL
        failures = 0
        while not self._probe_stop.wait(delay * random.uniform(0.6, 1.0)):
            with self._lock:
                if self._state != _rpc.BREAKER_OPEN:
                    self._probing = False
                    return
            if self._probe_once():
                with self._lock:
                    if self._state != _rpc.BREAKER_OPEN:
                        self._probing = False
                        return
                    self._state = _rpc.BREAKER_HALF_OPEN
                    self._half_open_busy = False
                    self._probing = False
                self._enter(_rpc.BREAKER_HALF_OPEN)
                return
            failures += 1
            if failures >= _rpc.HEALTH_GRACE_PROBES:
                delay = min(delay * 2.0, _rpc.HEALTH_BACKOFF_CAP)
        with self._lock:
            self._probing = False


def zlib_crc(s: str) -> int:
    import zlib

    return zlib.crc32(s.encode()) & 0x7FFFFFFF


_TARGETS: dict[str, TargetBreaker] = {}
_TARGETS_MU = threading.Lock()


def breaker_for(target: str, host: str, port: int, https: bool,
                fault_src: str) -> TargetBreaker:
    with _TARGETS_MU:
        b = _TARGETS.get(target)
        if b is None:
            b = _TARGETS[target] = TargetBreaker(target, host, port,
                                                 https, fault_src)
        else:
            b.fault_src = fault_src or b.fault_src
        return b


def reset_breakers() -> int:
    """Chaos teardown, as rpc.reset_breakers: force every OPEN or
    HALF_OPEN target breaker back to CLOSED."""
    with _TARGETS_MU:
        targets = list(_TARGETS.values())
    return sum(1 for b in targets if b.reset())


# Verbs whose replay is safe: reads, checks, DELETE (S3 DELETE is
# idempotent) and whole-object PUT of an in-memory body (same bytes,
# same outcome). Streaming PUTs never retry here — the task-level
# requeue in pool.py re-reads the source and replays the whole object.
_IDEMPOTENT_METHODS = frozenset({"GET", "HEAD", "DELETE", "PUT"})


class RemoteS3Client:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", timeout: float = 30.0,
                 fault_src: str = "local"):
        u = urllib.parse.urlsplit(endpoint)
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or (443 if u.scheme == "https" else 80)
        self.https = u.scheme == "https"
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout
        self.fault_src = fault_src
        self.fault_dst = f"{self.host}:{self.port}"
        self.breaker = breaker_for(self.fault_dst, self.host, self.port,
                                   self.https, fault_src)

    # -- signing (independent SigV4 implementation) --

    def _sign(self, method: str, path: str, query: str, headers: dict,
              payload_hash: str) -> dict:
        return sigv4.sign_request(
            method, urllib.parse.unquote(path),
            dict(urllib.parse.parse_qsl(query, keep_blank_values=True)),
            headers, f"{self.host}:{self.port}",
            sigv4.Credentials(self.access_key, self.secret_key), payload_hash,
            region=self.region)

    # -- fabric (breaker + faultplane + retry) --

    def _request(self, method: str, path: str, body=b"",
                 headers: dict | None = None,
                 length: int | None = None) -> tuple[int, dict, bytes]:
        """One S3 round trip with fabric semantics. `body` may be bytes
        or an iterable of chunks (then `length` is required and the call
        is single-shot). Transport failures raise RemoteS3Unreachable;
        retryable ones replay with jittered backoff funded by the
        per-target budget."""
        streaming = not isinstance(body, (bytes, bytearray))
        retryable = method in _IDEMPOTENT_METHODS and not streaming
        attempt = 0
        while True:
            try:
                return self._request_once(method, path, body, headers,
                                          length)
            except RemoteS3Unreachable:
                if (not retryable or attempt >= _rpc.RETRY_MAX
                        or self.breaker.state() != _rpc.BREAKER_CLOSED):
                    raise
                if not self.breaker.budget.take():
                    _RETRIES_SHED.labels(target=self.fault_dst).inc()
                    raise
                attempt += 1
                _RETRIES.labels(target=self.fault_dst).inc()
                # Decorrelated exponential backoff, capped at 1 s
                # (mirrors dist/rpc.py's retry loop).
                time.sleep(min(1.0, 0.05 * (1 << (attempt - 1)))
                           * self.breaker.rng.uniform(0.5, 1.0))

    def _request_once(self, method: str, path: str, body, headers,
                      length: int | None) -> tuple[int, dict, bytes]:
        brk = self.breaker
        state = brk.state()
        if state == _rpc.BREAKER_OPEN:
            # Fail-fast: zero socket work, exactly like an OFFLINE peer.
            raise RemoteS3Unreachable(
                f"replication target {self.fault_dst} offline "
                "(breaker open)")
        trial = False
        if state == _rpc.BREAKER_HALF_OPEN:
            trial = brk.begin_trial()
            if not trial:
                raise RemoteS3Unreachable(
                    f"replication target {self.fault_dst} half-open: "
                    "trial call in flight")
        try:
            return self._do_request(method, path, body, headers, length,
                                    trial)
        finally:
            if trial:
                brk.end_trial()

    def _do_request(self, method: str, path: str, body, headers,
                    length: int | None, trial: bool
                    ) -> tuple[int, dict, bytes]:
        streaming = not isinstance(body, (bytes, bytearray))
        if streaming:
            if length is None:
                raise ValueError("streaming body requires length")
            payload_hash = UNSIGNED_PAYLOAD
        else:
            payload_hash = hashlib.sha256(body).hexdigest()
        raw_path, _, query = path.partition("?")
        hdrs = self._sign(method, raw_path, query, dict(headers or {}),
                          payload_hash)
        if streaming:
            hdrs["content-length"] = str(length)
        fp = _faults.get()
        brk = self.breaker
        conn = None
        try:
            if fp is not None:
                # Partition/refusal faults fire BEFORE any socket
                # exists — an OPEN breaker really does zero socket work.
                fp.on_connect(self.fault_src, self.fault_dst, raw_path)
            cls = (http.client.HTTPSConnection if self.https
                   else http.client.HTTPConnection)
            conn = cls(self.host, self.port, timeout=self.timeout)
            conn.connect()
        except OSError as e:
            # Connect-phase failure is the partition signature: the
            # breaker opens immediately (hard), probe loop takes over.
            if conn is not None:
                conn.close()
            brk.note_failure(hard=True)
            raise RemoteS3Unreachable(
                f"connect {self.fault_dst}: {e}") from e
        try:
            try:
                if fp is not None:
                    # Delay/reset faults degrade through this except
                    # block, exactly like their real counterparts; a
                    # live partition also resets established conns.
                    fp.on_request(self.fault_src, self.fault_dst,
                                  raw_path)
                if streaming:
                    conn.putrequest(method, path,
                                    skip_host=True,
                                    skip_accept_encoding=True)
                    for k, v in hdrs.items():
                        conn.putheader(k, v)
                    conn.endheaders()
                    for chunk in body:
                        if chunk:
                            conn.send(chunk)
                else:
                    conn.request(method, path, body=body or None,
                                 headers=hdrs)
                resp = conn.getresponse()
                data = resp.read()
            except (OSError, http.client.HTTPException) as e:
                brk.note_failure(hard=trial)
                raise RemoteS3Unreachable(
                    f"{method} {self.fault_dst}{raw_path}: {e}") from e
            fspec = (fp.response_fault(self.fault_src, self.fault_dst,
                                       raw_path)
                     if fp is not None else None)
            if fspec is not None:
                data = self._apply_body_fault(fspec, data)
            brk.note_success()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def _apply_body_fault(self, rule, data: bytes) -> bytes:
        if rule.action == _faults.TRUNCATE:
            if len(data) > rule.after_bytes:
                # The transport really cut the body: surface it as the
                # reset the consumer would have seen.
                self.breaker.note_failure()
                raise RemoteS3Unreachable(
                    f"faultplane: response truncated after "
                    f"{rule.after_bytes} bytes from {self.fault_dst}")
            return data
        if data:  # corrupt: flip the first byte
            # mtpu: allow(MTPU005) - fault-injection cold path: the
            # copy IS the corruption being injected (rpc.py idiom)
            return bytes([data[0] ^ rule.xor]) + data[1:]
        return data

    # -- the verbs (the S3 tier uses put, get and delete) --

    def put_object(self, bucket: str, key: str, data,
                   metadata: dict | None = None,
                   length: int | None = None) -> None:
        """PUT an object. `data` is bytes, or an iterable of chunks
        with `length` set — the streaming path never materializes the
        object (UNSIGNED-PAYLOAD signing, chunk-by-chunk send)."""
        headers = dict(metadata or {})
        st, _, body = self._request(
            "PUT", f"/{bucket}/{urllib.parse.quote(key)}", data, headers,
            length=length)
        if st // 100 != 2:
            raise RemoteS3Error(st, body.decode(errors="replace"))

    def delete_object(self, bucket: str, key: str) -> None:
        st, _, body = self._request(
            "DELETE", f"/{bucket}/{urllib.parse.quote(key)}")
        if st not in (200, 204, 404):
            raise RemoteS3Error(st, body.decode(errors="replace"))

    def get_object(self, bucket: str, key: str, offset: int = 0,
                   length: int = -1) -> tuple[dict, bytes]:
        """GET an object or a byte range of it: (headers, body)."""
        headers = {}
        if offset or length >= 0:
            end = "" if length < 0 else str(offset + length - 1)
            headers["Range"] = f"bytes={offset}-{end}"
        st, hdrs, body = self._request(
            "GET", f"/{bucket}/{urllib.parse.quote(key)}", b"", headers)
        if st == 404:
            raise RemoteS3Error(404, "NoSuchKey")
        if st // 100 != 2:
            raise RemoteS3Error(st, body.decode(errors="replace"))
        return hdrs, body
