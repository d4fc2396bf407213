"""Mixed-workload client fleet (counterpart of minio_tpu/chaos/workload.py:
the same op streams from the same seed) — concurrent PUT / GET / DELETE /
multipart / list traffic that records every acknowledged mutation in a
`WriteLedger` and checks every GET in flight for torn reads.

The fleet is transport-agnostic: `client_factory()` returns an object
with `put/get/delete/post(path, ...) -> response`, the response having
`status_code`, `content` and `headers`. `S3Client` below is such a
client on the standard library (http.client and the port's SigV4), so
the fleet runs on a machine with no third-party HTTP client. Workers
namespace their keys (`w{i}-k{j}`), so every key has a linear history and
the ledger's fold is exact.

Op streams are deterministic per worker — `random.Random(subseed(seed,
"worker-i"))` draws the op, the key and the payload bytes — though the
interleaving across workers is not. Storm-time failures (5xx, resets,
timeouts) are EXPECTED and counted as errors; correctness violations
(torn or mismatched reads) are recorded apart and must be zero.
"""

from __future__ import annotations

import http.client
import random
import threading
import time
import urllib.parse

from minio_tpu_torch.chaos import subseed
from minio_tpu_torch.chaos.ledger import WriteLedger, digest

# Transport-level failures a storm legitimately produces: broad but
# EXPLICIT, so programming errors (TypeError and kin) still raise.
_NET_ERRORS = (ConnectionError, TimeoutError, OSError,
               http.client.HTTPException)


class _Response:
    __slots__ = ("status_code", "content", "headers")

    def __init__(self, status_code: int, content: bytes, headers):
        self.status_code = status_code
        self.content = content
        self.headers = headers


class S3Client:
    """S3 over one persistent http.client connection, SigV4-signed with
    the port's code (UNSIGNED-PAYLOAD). `put/get/delete/post(path,
    data=b"", query=None, headers=None, timeout=None)` answer a response
    with `status_code`, `content` and `headers` (case-insensitive
    `get`). A transport failure drops the connection and raises; the
    next call opens a new one."""

    def __init__(self, url: str, access_key: str, secret_key: str,
                 timeout: float = 60.0):
        from minio_tpu_torch.s3.sigv4 import Credentials

        self.host = urllib.parse.urlsplit(url).netloc
        self.creds = Credentials(access_key, secret_key)
        self.timeout = timeout
        self._conn: http.client.HTTPConnection | None = None

    def request(self, method: str, path: str, data: bytes = b"",
                query: dict | None = None, headers: dict | None = None,
                timeout: float | None = None) -> _Response:
        from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, sign_request

        query = dict(query or {})
        signed = sign_request(method, path, query, dict(headers or {}),
                              self.host, self.creds, UNSIGNED_PAYLOAD)
        url = urllib.parse.quote(path)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        t = self.timeout if timeout is None else timeout
        if self._conn is None:
            self._conn = http.client.HTTPConnection(self.host, timeout=t)
        conn = self._conn
        try:
            if conn.sock is not None:
                conn.sock.settimeout(t)
            conn.timeout = t
            conn.request(method, url, body=data or None, headers=signed)
            r = conn.getresponse()
            body = r.read()
        except BaseException:
            self.close()
            raise
        if r.will_close:
            self.close()
        return _Response(r.status, body, r.headers)

    def put(self, path, data=b"", **kw):
        return self.request("PUT", path, data, **kw)

    def get(self, path, **kw):
        return self.request("GET", path, **kw)

    def delete(self, path, **kw):
        return self.request("DELETE", path, **kw)

    def post(self, path, data=b"", **kw):
        return self.request("POST", path, data, **kw)

    def close(self) -> None:
        conn, self._conn = self._conn, None
        if conn is not None:
            conn.close()


class FleetStats:
    def __init__(self):
        self.mu = threading.Lock()
        self.ops: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.latencies: dict[str, list[float]] = {}
        self.violations: list[str] = []
        # HTTP status histogram across every response the fleet saw
        # (including intermediate multipart calls) — the per-tenant QoS
        # gates count 5xx/503 from here without scraping the server.
        self.codes: dict[int, int] = {}

    def record(self, kind: str, dt: float, ok: bool) -> None:
        with self.mu:
            self.ops[kind] = self.ops.get(kind, 0) + 1
            self.latencies.setdefault(kind, []).append(dt)
            if not ok:
                self.errors[kind] = self.errors.get(kind, 0) + 1

    def status(self, code: int) -> None:
        with self.mu:
            self.codes[code] = self.codes.get(code, 0) + 1

    def count_code(self, lo: int, hi: int) -> int:
        """Responses with lo <= status < hi (e.g. 500, 600 for 5xx)."""
        with self.mu:
            return sum(n for c, n in self.codes.items() if lo <= c < hi)

    def violation(self, msg: str) -> None:
        with self.mu:
            self.violations.append(msg)

    def total_ops(self) -> int:
        with self.mu:
            return sum(self.ops.values())

    def total_errors(self) -> int:
        with self.mu:
            return sum(self.errors.values())

    def p99(self, kind: str | None = None) -> float:
        with self.mu:
            vals = (sorted(self.latencies.get(kind, [])) if kind
                    else sorted(v for vs in self.latencies.values()
                                for v in vs))
        if not vals:
            return 0.0
        return vals[min(len(vals) - 1, int(0.99 * len(vals)))]

    def describe(self) -> dict:
        # p99() takes self.mu itself (a non-reentrant Lock): compute it
        # BEFORE the snapshot lock.
        p99 = self.p99()
        with self.mu:
            return {"ops": dict(self.ops), "errors": dict(self.errors),
                    "violations": list(self.violations),
                    "codes": dict(self.codes),
                    "p99_s": round(p99, 3)}


class _StatusClient:
    """Transport wrapper: mirrors every response's status code into
    FleetStats (including intermediate multipart calls), so SLO gates
    can count 5xx without instrumenting each op implementation."""

    def __init__(self, inner, stats: FleetStats):
        self._inner = inner
        self._stats = stats

    def _call(self, name, *a, **kw):
        r = getattr(self._inner, name)(*a, **kw)
        self._stats.status(r.status_code)
        return r

    def put(self, *a, **kw):
        return self._call("put", *a, **kw)

    def get(self, *a, **kw):
        return self._call("get", *a, **kw)

    def delete(self, *a, **kw):
        return self._call("delete", *a, **kw)

    def post(self, *a, **kw):
        return self._call("post", *a, **kw)


class MixedWorkload:
    """`workers` client threads looping a weighted op mix until
    `stop()`. Sizes stay small-object by default (the chaos tier is a
    correctness storm, not a throughput bench); `mp_size` parts drive
    the multipart path through the same ledger."""

    def __init__(self, client_factory, ledger: WriteLedger, bucket: str,
                 seed: int = 0, workers: int = 6,
                 sizes: tuple[int, ...] = (4 << 10, 32 << 10, 128 << 10),
                 mp_size: int = 5 << 20, keyspace: int = 8,
                 weights: dict[str, int] | None = None,
                 op_timeout: float = 30.0):
        self.factory = client_factory
        self.ledger = ledger
        self.bucket = bucket
        self.seed = seed
        self.workers = workers
        self.sizes = sizes
        self.mp_size = mp_size
        self.keyspace = keyspace
        self.op_timeout = op_timeout
        self.weights = weights or {"put": 5, "get": 5, "delete": 1,
                                   "list": 1, "multipart": 1}
        self.stats = FleetStats()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "MixedWorkload":
        for i in range(self.workers):
            t = threading.Thread(target=self._worker, args=(i,),
                                 name=f"chaos-workload-{i}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self, timeout: float = 60.0) -> bool:
        self._stop.set()
        ok = True
        for t in self._threads:
            t.join(timeout)
            ok = ok and not t.is_alive()
        return ok

    def run_for(self, seconds: float) -> bool:
        self.start()
        self._stop.wait(seconds)
        return self.stop()

    # -- op implementations --------------------------------------------
    #
    # Each worker owns its keys and issues ops sequentially, so it can
    # torn-read-check in flight with a LOCAL candidate map: after an
    # acked mutation exactly one outcome is allowed; after a FAILED one
    # the new generation is added to the allowed set (the op may or may
    # not have committed server-side — both are legal, a third state is
    # a torn write). `None` in a candidate set means "absent is legal".

    def _settle(self, cand: dict, key: str, sha: str | None,
                acked: bool) -> None:
        if acked:
            cand[key] = {sha}
        else:
            cand.setdefault(key, {None}).add(sha)

    def _op_put(self, client, rng, cand, key: str) -> bool:
        body = rng.randbytes(rng.choice(self.sizes))
        sha = digest(body)
        e = self.ledger.intent("put", key, sha, len(body))
        acked = False
        try:
            r = client.put(f"/{self.bucket}/{key}", data=body,
                           timeout=self.op_timeout)
            acked = r.status_code == 200
        finally:
            # Transport failure == unacked attempt: both outcomes legal.
            self._settle(cand, key, sha, acked)
        if acked:
            self.ledger.ack(e, r.headers.get("ETag", ""))
        return acked

    def _op_delete(self, client, rng, cand, key: str) -> bool:
        e = self.ledger.intent("delete", key)
        acked = False
        try:
            r = client.delete(f"/{self.bucket}/{key}",
                              timeout=self.op_timeout)
            acked = r.status_code in (200, 204)
        finally:
            self._settle(cand, key, None, acked)
        if acked:
            self.ledger.ack(e)
        return acked

    def _op_multipart(self, client, rng, cand, key: str) -> bool:
        # One full-size part (S3 minimum 5 MiB) + a short tail part:
        # exercises the multipart commit without making every chaos
        # object deep-heal-expensive.
        bodies = [rng.randbytes(self.mp_size), rng.randbytes(64 << 10)]
        whole = b"".join(bodies)
        path = f"/{self.bucket}/{key}"
        r = client.post(path, query={"uploads": ""},
                        timeout=self.op_timeout)
        if r.status_code != 200:
            return False
        text = r.content.decode("utf-8", "replace")
        try:
            uid = text.split("<UploadId>")[1].split("</UploadId>")[0]
        except IndexError:
            return False
        etags = []
        for n, b in enumerate(bodies, 1):
            r = client.put(path, data=b,
                           query={"uploadId": uid, "partNumber": str(n)},
                           timeout=self.op_timeout)
            if r.status_code != 200:
                return False
            etags.append(r.headers.get("ETag", ""))
        # The COMPLETE is the acknowledged mutation: intent just before.
        sha = digest(whole)
        e = self.ledger.intent("multipart", key, sha, len(whole))
        done = ("<CompleteMultipartUpload>" + "".join(
            f"<Part><PartNumber>{n}</PartNumber><ETag>{t}</ETag></Part>"
            for n, t in enumerate(etags, 1))
            + "</CompleteMultipartUpload>").encode()
        acked = False
        try:
            r = client.post(path, data=done, query={"uploadId": uid},
                            timeout=self.op_timeout)
            acked = r.status_code == 200 and b"<Error>" not in r.content
        finally:
            self._settle(cand, key, sha, acked)
        if acked:
            self.ledger.ack(e)
        return acked

    def _op_get(self, client, rng, cand, key: str) -> bool:
        allowed = cand.get(key, {None})
        r = client.get(f"/{self.bucket}/{key}", timeout=self.op_timeout)
        if r.status_code == 200:
            got = digest(r.content)
            if got not in allowed:
                self.stats.violation(
                    f"torn read {key}: got {len(r.content)}B sha "
                    f"{got[:12]}, allowed "
                    f"{[a[:12] if a else None for a in allowed]}")
                return False
            return True
        if r.status_code == 404:
            if None not in allowed:
                self.stats.violation(
                    f"lost acknowledged write {key}: 404 but only "
                    f"{[a[:12] if a else None for a in allowed]} allowed")
                return False
            return True
        return False

    def _op_list(self, client, rng, wid: int) -> bool:
        r = client.get(f"/{self.bucket}", query={"list-type": "2",
                                                 "prefix": f"w{wid}-"},
                       timeout=self.op_timeout)
        return r.status_code == 200

    # -- the worker loop -----------------------------------------------

    def _worker(self, wid: int) -> None:
        rng = random.Random(subseed(self.seed, f"worker-{wid}"))
        client = _StatusClient(self.factory(), self.stats)
        # Worker-local candidate map (keys are worker-owned): key ->
        # set of legal read outcomes (digests / None for absent).
        cand: dict[str, set] = {}
        kinds = [k for k, w in self.weights.items() for _ in range(w)]
        while not self._stop.is_set():
            kind = rng.choice(kinds)
            key = f"w{wid}-k{rng.randrange(self.keyspace)}"
            if kind == "multipart":
                key = f"w{wid}-mp{rng.randrange(2)}"
            t0 = time.monotonic()
            ok = False
            try:
                if kind == "put":
                    ok = self._op_put(client, rng, cand, key)
                elif kind == "get":
                    ok = self._op_get(client, rng, cand, key)
                elif kind == "delete":
                    ok = self._op_delete(client, rng, cand, key)
                elif kind == "multipart":
                    ok = self._op_multipart(client, rng, cand, key)
                else:
                    ok = self._op_list(client, rng, wid)
            except _NET_ERRORS:
                # The storm eating a request is the expected failure
                # mode (counted via ok=False); the write-ahead intent
                # row keeps the op visible to the checker.
                ok = False
            self.stats.record(kind, time.monotonic() - t0, ok)
