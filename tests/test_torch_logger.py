"""The logger and audit plane of the port (minio_tpu_torch/logger/)
against the JAX package's (minio_tpu/logger/), on the CPU.

- the console, file and HTTP targets write the JAX package's lines and
  requests for the same entries (the clock pinned);
- the logger's level filter, log_once dedup and console bus behave as
  the JAX logger's;
- AuditEntry documents are the JAX ones field for field;
- a port server with an audit_file and an audit_webhook writes one audit
  entry per request, each equal to the JAX server's entry for the same
  request (time, duration and request id masked), whose request id is
  the answer's x-amz-request-id and the trace id of the request's
  records; logger_webhook carries the ops log; close() stops the
  webhooks' threads.

Tolerance: exact.
"""

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from minio_tpu.logger import logger as jlog
from minio_tpu_torch.logger import logger as tlog
from tests.torch_atrest import JaxServer, client, port_server

PINNED = "2026-03-04T05:06:07.891234Z"
PKGS = {"jax": jlog, "torch": tlog}


@pytest.fixture()
def pinned(monkeypatch):
    for mod in PKGS.values():
        monkeypatch.setattr(mod, "_rfc3339", lambda ts=None: PINNED)


def _entries(mod, json_lines=True):
    buf = io.StringIO()
    lg = mod.Logger(node="node-1")
    lg.targets = [mod.ConsoleTarget(stream=buf, json_lines=json_lines)]
    lg.info("hello", bucket="b", n=3)
    lg.debug("hidden")
    lg.warning("warn", detail={"a": [1, 2.5]})
    lg.min_level = "ERROR"
    lg.warning("filtered")
    for _ in range(4):
        lg.log_once("ERROR", "same failure", interval=60)
    lg.error("boom")
    return buf.getvalue()


@pytest.mark.parametrize("json_lines", [True, False])
def test_console_lines_match_jax(pinned, json_lines):
    assert _entries(tlog, json_lines) == _entries(jlog, json_lines)
    assert _entries(tlog).count("same failure") == 1


def test_file_target_and_console_bus_match_jax(pinned, tmp_path):
    lines = {}
    for pkg, mod in PKGS.items():
        path = tmp_path / pkg / "logs" / "ops.log"
        lg = mod.Logger(node="n")
        lg.targets = [mod.FileTarget(str(path))]
        got = []
        with lg.console_bus.subscribe() as sub:
            lg.info("one", k="v")
            lg.error("two")
            for _ in range(2):
                got.append(sub.get(timeout=1.0))
        lines[pkg] = (path.read_bytes(), got)
    assert lines["torch"] == lines["jax"]


def test_audit_documents_match_jax():
    kw = dict(bucket="b", object="o/k", status_code=206, access_key="ak",
              remote_host="10.1.2.3", user_agent="ua/1", request_id="REQ1",
              rx_bytes=10, tx_bytes=20, duration_ms=1.23456789, time=PINNED,
              deployment_id="dep", query={"versionId": "v"},
              req_headers={"Range": "bytes=0-1"})
    assert tlog.AuditEntry("GetObject", **kw).to_doc() == \
        jlog.AuditEntry("GetObject", **kw).to_doc()
    assert tlog.AuditEntry("x").to_doc().keys() == jlog.AuditEntry("x").to_doc().keys()
    for ts in (0.0, 1_760_000_000.5, 1_760_000_000.999999):
        assert tlog._rfc3339(ts) == jlog._rfc3339(ts)


class _Recorder(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.server.got.append((self.path, self.headers.get("Authorization"),
                                json.loads(self.rfile.read(n))))
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


class _Listener:
    def __init__(self):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
        self.httpd.got = []
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    @property
    def got(self):
        return self.httpd.got

    def wait(self, pred, timeout=20.0):
        end = time.monotonic() + timeout
        while not pred(self.got) and time.monotonic() < end:
            time.sleep(0.02)
        return list(self.got)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def test_http_target_posts_as_jax(pinned):
    lst = _Listener()
    try:
        for mod in PKGS.values():
            t = mod.HTTPTarget(lst.url + "/log", auth_token="tok")
            t.send({"message": "m", "n": 1})
            lst.wait(lambda g: len(g) >= 1 + (mod is tlog))
            t.close()
            assert not t._thread.is_alive()
        assert lst.got[0] == lst.got[1] == ("/log", "Bearer tok", {"message": "m", "n": 1})
    finally:
        lst.close()


def _script(url):
    cl = client(url)
    rids = []
    for method, path, query, data in (
            ("PUT", "/audb", None, b""),
            ("PUT", "/audb/k/one", None, b"x" * 3000),
            ("GET", "/audb/k/one", None, b""),
            ("GET", "/audb/k/one", {"versionId": "nope"}, b""),
            ("HEAD", "/audb/missing", None, b""),
            ("GET", "/audb", {"list-type": "2", "prefix": "k/"}, b""),
            ("DELETE", "/audb/k/one", None, b"")):
        r = cl.request(method, path, query=query, data=data,
                       headers={"User-Agent": "audit-test/1"})
        rids.append(r.headers["x-amz-request-id"])
    return rids


def _mask(doc):
    doc = dict(doc)
    doc["time"] = "T"
    doc["requestID"] = "R"
    doc["api"] = {**doc["api"], "timeToResponseMs": 0}
    return doc


def test_server_audit_entries_match_jax(tmp_path, monkeypatch):
    from minio_tpu_torch import obs

    got = {}
    for pkg in ("jax", "torch"):
        monkeypatch.setenv("MTPU_EVENT_QUEUE_DIR", str(tmp_path / f"q-{pkg}"))
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        srv = JaxServer(paths) if pkg == "jax" else port_server(paths)
        s3 = srv.srv if pkg == "jax" else srv
        lst = _Listener()
        path = tmp_path / f"audit-{pkg}.log"
        sub = obs.trace_bus().subscribe() if pkg == "torch" else None
        try:
            s3.config.set_kv("audit_file", {"path": str(path)})
            s3.config.set_kv("audit_webhook", {"enable": "on", "endpoint": lst.url})
            s3.config.set_kv("logger_webhook", {"enable": "on", "endpoint": lst.url + "/ops"})
            s3.configure_logging()
            rids = _script(srv.url)
            s3.logger.error("ops line")
            # A request's entry is written once its answer is out: poll.
            end = time.monotonic() + 20
            while (len(path.read_text().splitlines()) < len(rids)
                   and time.monotonic() < end):
                time.sleep(0.02)
            docs = [json.loads(line) for line in path.read_text().splitlines()]
            posted = lst.wait(lambda g: len(g) >= len(rids) + 1)
            hooks = [t for t in s3.logger.targets + s3.logger.audit_targets
                     if hasattr(t, "_thread")]
            traces = []
            while sub is not None:
                rec = sub.get(timeout=0.2)
                if rec is None:
                    break
                if rec.get("type") == "http":
                    traces.append((rec["requestId"], rec.get("trace_id")))
        finally:
            if sub is not None:
                sub.close()
            if pkg == "jax":
                # The JAX server's close leaves its targets on the process
                # logger: take them off (and stop the webhooks) here.
                for sub_, kv in (("audit_file", {"path": ""}),
                                 ("audit_webhook", {"enable": "off"}),
                                 ("logger_webhook", {"enable": "off"})):
                    s3.config.set_kv(sub_, kv)
                s3.configure_logging()
            srv.close()
            lst.close()
        assert [d["requestID"] for d in docs] == rids
        assert sorted(d["requestID"] for _p, _a, d in posted if "requestID" in d) == sorted(rids)
        assert [d["message"] for p, _a, d in posted if p == "/ops"] == ["ops line"]
        if pkg == "torch":
            assert [t for t in traces if t[0] in rids] == [(r, r) for r in rids]
            assert hooks and not any(t._thread.is_alive() for t in hooks)
        got[pkg] = [_mask(d) for d in docs]
    assert got["torch"] == got["jax"]
    assert [d["api"]["name"] for d in got["torch"]][:3] == ["CreateBucket", "PutObject",
                                                           "GetObject"]
