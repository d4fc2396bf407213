"""Bucket event notifications of the port (minio_tpu_torch/event/) against
the JAX package's (minio_tpu/event/), on the CPU.

- notification rules parsed and matched as in the JAX package, and the
  event record's JSON equal with the clock pinned;
- the durable queue store's files (names and bytes, clock and ids
  pinned) equal, and each package's store read by the other;
- a delivery worker keeps the order of its queue under retry;
- a webhook delivery to a local listener carries the JAX request;
- the S3 calls of a port server emit what a JAX server emits: the same
  events, in the same order, to a webhook target configured through
  notify_webhook; ?notification answers as the JAX server's;
- every broker target (NATS, Redis list and channel, MQTT, Elasticsearch,
  NSQ, Kafka, AMQP, PostgreSQL md5 and SCRAM-SHA-256, MySQL) sends the
  JAX target's bytes to a fake broker (the fakes follow
  tests/test_event_targets.py, copied here and recording every byte);
- configure_event_targets registers the ARNs the JAX server registers for
  the same notify_* config, and a config that cannot build a target
  logs the error and starts.

Tolerance: exact.
"""

import base64
import datetime as _dt
import hashlib
import hmac
import io
import json
import os
import socket
import struct
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from minio_tpu.event import event as jevent
from minio_tpu.event import rules as jrules
from minio_tpu.event import targets as jtargets
from minio_tpu_torch.event import event as tevent
from minio_tpu_torch.event import rules as trules
from minio_tpu_torch.event import targets as ttargets
from tests.conftest import S3_ACCESS, S3_SECRET
from tests.torch_atrest import JaxServer, client, port_server

EVENT = {"EventName": "s3:ObjectCreated:Put", "Key": "bkt/obj",
         "Records": [{"s3": {"object": {"key": "obj", "size": 3}}}]}
PKGS = {"jax": jtargets, "torch": ttargets}


# -- rules and records ---------------------------------------------------------

def _notification_xml(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    kinds = ("QueueConfiguration", "TopicConfiguration", "CloudFunctionConfiguration")
    arn_tag = {"QueueConfiguration": "Queue", "TopicConfiguration": "Topic",
               "CloudFunctionConfiguration": "CloudFunction"}
    names = ["s3:ObjectCreated:*", "s3:ObjectRemoved:*", "s3:ObjectAccessed:Get",
             "s3:ObjectCreated:Put", "s3:ObjectCreated:CompleteMultipartUpload",
             "s3:ObjectRemoved:DeleteMarkerCreated"]
    out = []
    for i in range(int(rng.integers(1, 5))):
        kind = kinds[rng.integers(3)]
        events = "".join(f"<Event>{names[j]}</Event>"
                         for j in rng.choice(len(names), int(rng.integers(1, 3)), False))
        flt = ""
        if rng.random() < 0.7:
            rules = []
            if rng.random() < 0.7:
                rules.append(f"<FilterRule><Name>{'prefix' if rng.random() < .5 else 'Prefix'}"
                             f"</Name><Value>{['', 'logs/', 'a'][rng.integers(3)]}</Value>"
                             "</FilterRule>")
            if rng.random() < 0.5:
                rules.append("<FilterRule><Name>suffix</Name><Value>.jpg</Value></FilterRule>")
            flt = f"<Filter><S3Key>{''.join(rules)}</S3Key></Filter>"
        arn = f"arn:minio_tpu:sqs::{['webhook', 'nats', 'kafka'][rng.integers(3)]}:x"
        out.append(f"<{kind}><Id>id{i}</Id>{flt}<{arn_tag[kind]}>{arn}</{arn_tag[kind]}>"
                   f"{events}</{kind}>")
    return ("<NotificationConfiguration>" + "".join(out)
            + "</NotificationConfiguration>").encode()


@pytest.mark.parametrize("seed", range(12))
def test_rules_match_jax(seed):
    import dataclasses

    raw = _notification_xml(seed)
    jc, tc = jrules.parse_notification_xml(raw), trules.parse_notification_xml(raw)
    assert [dataclasses.asdict(r) for r in tc.rules] == [dataclasses.asdict(r)
                                                          for r in jc.rules]
    assert tc.arns == jc.arns
    for name in jevent.ALL_EVENT_NAMES:
        for key in ("logs/a.jpg", "a.jpg", "b.txt", "logs/x", ""):
            assert tc.match(name, key) == jc.match(name, key)
    for pat in ("s3:ObjectCreated:*", "s3:ObjectRemoved:*", "s3:ObjectAccessed:*",
                "s3:ObjectCreated:Put", "s3:Bogus:*"):
        assert tevent.expand_event_pattern(pat) == jevent.expand_event_pattern(pat)


@pytest.mark.parametrize("raw", [
    b"<NotificationConfiguration><QueueConfiguration><Event>s3:ObjectCreated:*</Event>"
    b"</QueueConfiguration></NotificationConfiguration>",
    b"<NotificationConfiguration><QueueConfiguration><Queue>arn:x</Queue>"
    b"</QueueConfiguration></NotificationConfiguration>",
    b"<NotificationConfiguration><Queue", b""])
def test_bad_notification_refused_as_in_jax(raw):
    with pytest.raises(ValueError):
        jrules.parse_notification_xml(raw)
    with pytest.raises(ValueError):
        trules.parse_notification_xml(raw)


class _FixedDatetime(_dt.datetime):
    @classmethod
    def now(cls, tz=None):
        return _dt.datetime(2026, 3, 4, 5, 6, 7, 891234, tzinfo=_dt.timezone.utc)


class _DatetimeModule:
    datetime = _FixedDatetime
    timezone = _dt.timezone


def test_event_record_json_matches_jax(monkeypatch):
    monkeypatch.setattr(jevent, "datetime", _DatetimeModule)
    monkeypatch.setattr(tevent, "datetime", _DatetimeModule)
    for kw in ({}, {"size": 123, "etag": "abc", "version_id": "v1", "user": "alice",
                    "host": "10.0.0.1", "region": "us-east-1"}):
        for key in ("plain", "with space/and+plus?&=", "ünïcode/ключ"):
            je = jevent.new_object_event(jevent.OBJECT_CREATED_PUT, "bkt", key, **kw)
            te = tevent.new_object_event(tevent.OBJECT_CREATED_PUT, "bkt", key, **kw)
            assert json.dumps(te.to_record()) == json.dumps(je.to_record())
    assert te.sequencer == f"{int(_FixedDatetime.now().timestamp() * 1e6):016X}"
    assert tevent.ALL_EVENT_NAMES == jevent.ALL_EVENT_NAMES


# -- the queue store and delivery ---------------------------------------------

class _Clock:
    t = 1_760_000_000.0

    @classmethod
    def time(cls):
        cls.t += 0.000125
        return cls.t


class _Uuid:
    n = 0

    @classmethod
    def uuid4(cls):
        cls.n += 1
        return uuid.UUID(int=cls.n * 0x1234567)


def _fill(mod, d, monkeypatch):
    monkeypatch.setattr(_Clock, "t", 1_760_000_000.0)
    monkeypatch.setattr(_Uuid, "n", 0)
    monkeypatch.setattr(mod, "time", _Clock)
    monkeypatch.setattr(mod, "uuid", _Uuid)
    store = mod.QueueStore(str(d), limit=5)
    names = [store.put({**EVENT, "n": i, "f": i / 3}) for i in range(5)]
    with pytest.raises(OSError):   # full
        store.put(EVENT)
    return store, names


def test_queue_store_files_match_jax(tmp_path, monkeypatch):
    js, jn = _fill(jtargets, tmp_path / "j", monkeypatch)
    ts, tn = _fill(ttargets, tmp_path / "t", monkeypatch)
    assert tn == jn and ts.list() == js.list() == sorted(jn)
    for name in tn:
        assert open(os.path.join(ts.dir, name), "rb").read() == \
            open(os.path.join(js.dir, name), "rb").read()
    # Each package's store reads the other's files.
    assert [ttargets.QueueStore(js.dir).get(n) for n in jn] == [js.get(n) for n in jn]
    assert [jtargets.QueueStore(ts.dir).get(n) for n in tn] == [ts.get(n) for n in tn]
    ts.delete(tn[0])
    ts.delete(tn[0])   # twice: no error
    assert len(ts) == 4


class _Flaky:
    """Fails every third send; records what it delivered."""

    def __init__(self, arn):
        self.arn = arn
        self.calls = 0
        self.got = []
        self.done = threading.Event()

    def send(self, doc):
        self.calls += 1
        if self.calls % 3 == 0:
            raise OSError("down")
        self.got.append(doc["n"])
        if len(self.got) == 12:
            self.done.set()

    def close(self):
        pass


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_delivery_keeps_order_under_retry(tmp_path, pkg):
    mod = PKGS[pkg]
    target = _Flaky(f"arn:minio_tpu:sqs::{pkg}:flaky")
    w = mod.DeliveryWorker(target, mod.QueueStore(str(tmp_path / "q")), retry_interval=0.02)
    try:
        for i in range(12):
            w.enqueue({"n": i})
        assert target.done.wait(30)
    finally:
        w.close()
    assert target.got == list(range(12)) and target.calls == 17
    assert os.listdir(tmp_path / "q") == []


class _Recorder(BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.server.got.append((self.path, {k.lower(): v for k, v in self.headers.items()
                                            if k.lower() in ("content-type",
                                                             "authorization")},
                                self.rfile.read(n)))
        self.server.cond.set()
        self.send_response(self.server.status)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def log_message(self, *a):
        pass


class _Listener:
    def __init__(self, status=200):
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Recorder)
        self.httpd.got = []
        self.httpd.status = status
        self.httpd.cond = threading.Event()
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    @property
    def got(self):
        return self.httpd.got

    def wait(self, n, timeout=30.0):
        end = time.monotonic() + timeout
        while len(self.got) < n and time.monotonic() < end:
            time.sleep(0.02)
        return list(self.got)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def test_webhook_request_matches_jax():
    lst = _Listener()
    try:
        for mod in (jtargets, ttargets):
            t = mod.WebhookTarget(lst.url + "/hook/path", auth_token="tok")
            t.send(EVENT)
            assert t.arn == "arn:minio_tpu:sqs::webhook:webhook"
        assert lst.got[0] == lst.got[1]
        assert json.loads(lst.got[0][2]) == EVENT
    finally:
        lst.close()
    bad = _Listener(status=500)
    try:
        with pytest.raises(OSError):
            ttargets.WebhookTarget(bad.url).send(EVENT)
    finally:
        bad.close()


# -- the S3 calls' events --------------------------------------------------------

NOTIFY = (b"<NotificationConfiguration><QueueConfiguration><Id>all</Id>"
          b"<Queue>arn:minio_tpu:sqs::webhook:webhook</Queue>"
          b"<Event>s3:ObjectCreated:*</Event><Event>s3:ObjectRemoved:*</Event>"
          b"<Filter><S3Key><FilterRule><Name>prefix</Name><Value>ev/</Value></FilterRule>"
          b"</S3Key></Filter></QueueConfiguration></NotificationConfiguration>")


def _post_form(url, bucket, key, file_bytes):
    amz_date = _dt.datetime.now(_dt.timezone.utc).strftime("%Y%m%dT%H%M%SZ")
    cred = f"{S3_ACCESS}/{amz_date[:8]}/us-east-1/s3/aws4_request"
    exp = (_dt.datetime.now(_dt.timezone.utc) + _dt.timedelta(hours=1)).strftime(
        "%Y-%m-%dT%H:%M:%SZ")
    policy = base64.b64encode(json.dumps({"expiration": exp, "conditions": []})
                              .encode()).decode()
    k = ("AWS4" + S3_SECRET).encode()
    for part in (amz_date[:8], "us-east-1", "s3", "aws4_request"):
        k = hmac.new(k, part.encode(), hashlib.sha256).digest()
    form = {"key": key, "policy": policy, "x-amz-algorithm": "AWS4-HMAC-SHA256",
            "x-amz-credential": cred, "x-amz-date": amz_date,
            "x-amz-signature": hmac.new(k, policy.encode(), hashlib.sha256).hexdigest()}
    import requests

    return requests.post(f"{url}/{bucket}", data=form, timeout=30,
                         files={"file": ("f.bin", io.BytesIO(file_bytes))})


def _event_script(url):
    cl = client(url)
    out = [cl.put("/evb").status_code]
    r = cl.get("/evb", query={"notification": ""})
    out += [r.status_code, r.content]
    r = cl.put("/evb", query={"notification": ""},
               data=NOTIFY.replace(b"webhook:webhook", b"nope:webhook"))
    out += [r.status_code, b"InvalidArgument" in r.content]
    r = cl.put("/evb", query={"notification": ""}, data=NOTIFY)
    out.append(r.status_code)
    r = cl.get("/evb", query={"notification": ""})
    out += [r.status_code, r.content == NOTIFY]
    out.append(cl.request("DELETE", "/evb", query={"notification": ""}).status_code)
    data = np.random.default_rng(1).integers(0, 256, 70_000, dtype=np.uint8).tobytes()
    out.append(cl.put("/evb/ev/one", data=data).status_code)
    out.append(cl.put("/evb/other/skip", data=b"x").status_code)
    r = cl.request("POST", "/evb/ev/mp", query={"uploads": ""})
    upload = r.content.split(b"<UploadId>")[1].split(b"</UploadId>")[0].decode()
    r = cl.put("/evb/ev/mp", query={"partNumber": "1", "uploadId": upload}, data=data)
    etag = r.headers["ETag"]
    body = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber><ETag>{etag}"
            "</ETag></Part></CompleteMultipartUpload>").encode()
    out.append(cl.request("POST", "/evb/ev/mp", query={"uploadId": upload},
                          data=body).status_code)
    out.append(_post_form(url, "evb", "ev/form", b"form-bytes").status_code)
    out.append(cl.request("DELETE", "/evb/ev/one").status_code)
    out.append(cl.put("/evb", query={"versioning": ""},
                      data=b"<VersioningConfiguration><Status>Enabled</Status>"
                           b"</VersioningConfiguration>").status_code)
    out.append(cl.request("DELETE", "/evb/ev/mp").status_code)   # a delete marker
    return out


def _masked(doc):
    rec = doc["Records"][0]
    rec["eventTime"] = "T"
    rec["s3"]["object"]["sequencer"] = "S"
    if rec["s3"]["object"]["versionId"]:
        rec["s3"]["object"]["versionId"] = "V"
    return doc


def test_s3_calls_emit_what_jax_emits(tmp_path, monkeypatch):
    got = {}
    for pkg in ("jax", "torch"):
        lst = _Listener()
        monkeypatch.setenv("MTPU_EVENT_QUEUE_DIR", str(tmp_path / f"q-{pkg}"))
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        if pkg == "jax":
            srv = JaxServer(paths)
            s3 = srv.srv
        else:
            srv = s3 = port_server(paths)
        try:
            s3.config.set_kv("notify_webhook", {"enable": "on", "endpoint": lst.url})
            s3.configure_event_targets()
            assert s3.notifier.target_arns == ["arn:minio_tpu:sqs::webhook:webhook"]
            script = _event_script(srv.url)
            docs = [json.loads(b) for _p, _h, b in lst.wait(5)]
            time.sleep(0.3)   # nothing more arrives
            got[pkg] = (script, [_masked(d) for d in lst.got and docs],
                        len(lst.got))
        finally:
            s3.notifier.close()   # the JAX server's close leaves its workers
            srv.close()
            lst.close()
    assert got["torch"] == got["jax"]
    script, docs, n = got["torch"]
    assert n == 5
    assert [d["EventName"] for d in docs] == [
        "s3:ObjectCreated:Put", "s3:ObjectCreated:CompleteMultipartUpload",
        "s3:ObjectCreated:Post", "s3:ObjectRemoved:Delete",
        "s3:ObjectRemoved:DeleteMarkerCreated"]
    assert docs[0]["Records"][0]["userIdentity"]["principalId"] == S3_ACCESS


# -- the brokers -----------------------------------------------------------------

class _Rec:
    """A fake broker's view of one client connection: reads are recorded."""

    def __init__(self, conn):
        self.conn = conn
        self.buf = b""
        self.log = bytearray()

    def _fill(self, n):
        while len(self.buf) < n:
            chunk = self.conn.recv(65536)
            if not chunk:
                break
            self.buf += chunk

    def read(self, n):
        self._fill(n)
        out, self.buf = self.buf[:n], self.buf[n:]
        self.log += out
        return out

    def readline(self):
        while b"\n" not in self.buf:
            chunk = self.conn.recv(65536)
            if not chunk:
                break
            self.buf += chunk
        i = self.buf.find(b"\n")
        i = len(self.buf) if i < 0 else i + 1
        out, self.buf = self.buf[:i], self.buf[i:]
        self.log += out
        return out

    def drain(self):
        """The bytes the client sends until it closes."""
        self.conn.settimeout(5)
        try:
            while True:
                chunk = self.conn.recv(65536)
                if not chunk:
                    break
                self.log += chunk
        except OSError:
            pass


def _serve_once(script):
    """Serve one connection with script(rec, conn); -> (addr, result) where
    result() joins and returns the recorded client bytes."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    box = {}

    def run():
        conn, _ = srv.accept()
        rec = _Rec(conn)
        try:
            script(rec, conn)
            rec.drain()
        finally:
            box["log"] = bytes(rec.log)
            conn.close()
            srv.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result():
        t.join(10)
        return box["log"]

    host, port = srv.getsockname()
    return f"{host}:{port}", result


def _nats(rec, conn):
    conn.sendall(b'INFO {"server_id":"fake"}\r\n')
    rec.readline()
    _, _subj, ln = rec.readline().split()
    rec.read(int(ln) + 2)
    rec.readline()
    conn.sendall(b"PONG\r\n")


def _redis(n_cmds):
    def script(rec, conn):
        for _ in range(n_cmds):
            n_args = int(rec.readline()[1:])
            for _ in range(n_args):
                rec.read(int(rec.readline()[1:]) + 2)
            conn.sendall(b"+OK\r\n" if _ == 0 and n_cmds == 2 else b":1\r\n")
    return script


def _mqtt(rec, conn):
    def packet():
        h = rec.read(1)[0]
        mult, rl = 1, 0
        while True:
            b = rec.read(1)[0]
            rl += (b & 0x7F) * mult
            if not b & 0x80:
                break
            mult *= 128
        return h, rec.read(rl)

    packet()
    conn.sendall(b"\x20\x02\x00\x00")
    _h, body = packet()
    tlen = struct.unpack(">H", body[:2])[0]
    pid = struct.unpack(">H", body[2 + tlen:4 + tlen])[0]
    conn.sendall(b"\x40\x02" + struct.pack(">H", pid))


def _http(rec, conn):
    head = b""
    while not head.endswith(b"\r\n\r\n"):
        head += rec.readline()
    n = int([ln.split(b":", 1)[1] for ln in head.split(b"\r\n")
             if ln.lower().startswith(b"content-length")][0])
    rec.read(n)
    conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 2\r\nConnection: close\r\n\r\n{}")


def _kafka(rec, conn):
    size = struct.unpack(">i", rec.read(4))[0]
    req = rec.read(size)
    corr = struct.unpack_from(">i", req, 4)[0]
    topic = b"minio-events"
    resp = (struct.pack(">i", corr) + struct.pack(">i", 1) + struct.pack(">h", len(topic))
            + topic + struct.pack(">i", 1) + struct.pack(">ihq", 0, 0, 42))
    conn.sendall(struct.pack(">i", len(resp)) + resp)


def _amqp(rec, conn):
    def method(channel, cid, mid, args=b""):
        payload = struct.pack(">HH", cid, mid) + args
        conn.sendall(struct.pack(">BHI", 1, channel, len(payload)) + payload + b"\xce")

    def frame():
        _t, _c, size = struct.unpack(">BHI", rec.read(7))
        rec.read(size + 1)

    rec.read(8)
    method(0, 10, 10, struct.pack(">BB", 0, 9) + struct.pack(">I", 0)
           + struct.pack(">I", 5) + b"PLAIN" + struct.pack(">I", 5) + b"en_US")
    frame()
    method(0, 10, 30, struct.pack(">HIH", 1, 131072, 0))
    frame()
    frame()
    method(0, 10, 41, b"\x00")
    frame()
    method(1, 20, 11, struct.pack(">I", 0))
    frame()
    frame()
    frame()
    frame()
    method(0, 10, 51)


def _pg_msg(conn, tag, payload):
    conn.sendall(tag + struct.pack(">I", len(payload) + 4) + payload)


def _pg_query(rec, conn):
    _pg_msg(conn, b"R", struct.pack(">I", 0))
    _pg_msg(conn, b"Z", b"I")
    rec.read(1)
    rec.read(struct.unpack(">I", rec.read(4))[0] - 4)
    _pg_msg(conn, b"C", b"INSERT 0 1\x00")
    _pg_msg(conn, b"Z", b"I")


def _pg_md5(rec, conn):
    size = struct.unpack(">I", rec.read(4))[0]
    rec.read(size - 4)
    _pg_msg(conn, b"R", struct.pack(">I", 5) + b"SALT")
    rec.read(1)
    rec.read(struct.unpack(">I", rec.read(4))[0] - 4)
    _pg_query(rec, conn)


def _pg_scram(rec, conn):
    size = struct.unpack(">I", rec.read(4))[0]
    rec.read(size - 4)
    _pg_msg(conn, b"R", struct.pack(">I", 10) + b"SCRAM-SHA-256\x00\x00")
    rec.read(1)
    body = rec.read(struct.unpack(">I", rec.read(4))[0] - 4)
    flen = struct.unpack_from(">I", body, 14)[0]
    cfirst = body[18:18 + flen].decode()
    salt, iters = b"pg-salt-16bytes!", 4096
    sfirst = (f"r={cfirst.split('r=', 1)[1]}SRV,s={base64.b64encode(salt).decode()},"
              f"i={iters}")
    _pg_msg(conn, b"R", struct.pack(">I", 11) + sfirst.encode())
    rec.read(1)
    cfinal = rec.read(struct.unpack(">I", rec.read(4))[0] - 4).decode()
    bare = cfinal.rsplit(",p=", 1)[0]
    salted = hashlib.pbkdf2_hmac("sha256", b"scram-pass", salt, iters)
    skey = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
    authmsg = (cfirst[3:] + "," + sfirst + "," + bare).encode()
    v = base64.b64encode(hmac.new(skey, authmsg, hashlib.sha256).digest()).decode()
    _pg_msg(conn, b"R", struct.pack(">I", 12) + f"v={v}".encode())
    _pg_query(rec, conn)


def _mysql(rec, conn):
    salt = b"12345678" + b"abcdefghijkl"

    def packet(seq, payload):
        conn.sendall(len(payload).to_bytes(3, "little") + bytes((seq,)) + payload)

    packet(0, b"\x0a" + b"8.0-fake\x00" + struct.pack("<I", 7) + salt[:8] + b"\x00"
           + struct.pack("<HBHH", 0xFFFF, 33, 2, 0xFFFF) + bytes((21,)) + b"\x00" * 10
           + salt[8:] + b"\x00" + b"mysql_native_password\x00")
    for seq in (2, 1, 1):
        hdr = rec.read(4)
        rec.read(int.from_bytes(hdr[:3], "little"))
        packet(seq, b"\x00\x00\x00\x02\x00\x00\x00")


BROKERS = {
    "nats": (_nats, lambda m, a: m.NATSTarget(a, "minio.events")),
    "redis-list": (_redis(1), lambda m, a: m.RedisTarget(a, "minio_events")),
    "redis-channel-auth": (_redis(2), lambda m, a: m.RedisTarget(
        a, "minio_events", password="pw", publish=True)),
    "mqtt": (_mqtt, lambda m, a: m.MQTTTarget(a, "minio/events")),
    "elasticsearch": (_http, lambda m, a: m.ElasticsearchTarget(f"http://{a}/base",
                                                                 "minio-events")),
    "nsq": (_http, lambda m, a: m.NSQTarget(a, "minio topic")),
    "kafka": (_kafka, lambda m, a: m.KafkaTarget(f"{a}", "minio-events")),
    "amqp": (_amqp, lambda m, a: m.AMQPTarget(f"amqp://u:p@{a}/vh", "ex", "rk")),
    "postgres-md5": (_pg_md5, lambda m, a: m.PostgresTarget(
        a, "minio_events", user="pg_user", password="pg-pass")),
    "postgres-scram": (_pg_scram, lambda m, a: m.PostgresTarget(
        a, "minio_events", password="scram-pass")),
    "mysql": (_mysql, lambda m, a: m.MySQLTarget(a, "minio_events", user="my_user",
                                                 password="my-pass")),
}


@pytest.mark.parametrize("broker", list(BROKERS))
def test_broker_wire_bytes_match_jax(broker, monkeypatch):
    import secrets

    script, make = BROKERS[broker]
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=0xABCDEF))
    monkeypatch.setattr(secrets, "token_bytes", lambda n: bytes(range(n)))
    logs = {}
    for pkg, mod in PKGS.items():
        addr, result = _serve_once(script)
        target = make(mod, addr)
        target.send(EVENT)
        target.close()
        # The fake's port differs per run: it shows in an HTTP Host header.
        logs[pkg] = result().replace(addr.encode(), b"HOST:PORT")
        assert target.arn.startswith("arn:minio_tpu:sqs::")
    assert logs["torch"] == logs["jax"]
    if broker.startswith(("postgres", "mysql")):
        assert b"bkt/obj" in logs["torch"]
    else:
        assert json.dumps(EVENT).encode() in logs["torch"]


def test_refused_connection_raises_in_both():
    for mod in PKGS.values():
        for t in (mod.NATSTarget("127.0.0.1:1", "s", timeout=0.5),
                  mod.RedisTarget("127.0.0.1:1", "k", timeout=0.5),
                  mod.NSQTarget("127.0.0.1:1", "t", timeout=0.5)):
            with pytest.raises(OSError):
                t.send(EVENT)
    with pytest.raises(ValueError):
        ttargets.PostgresTarget("127.0.0.1:5432", "evil; DROP TABLE x")
    with pytest.raises(ValueError):
        ttargets.MySQLTarget("127.0.0.1:3306", "evil table")


ALL_NOTIFY = {
    "notify_webhook": {"enable": "on", "endpoint": "http://127.0.0.1:9/h"},
    "notify_nats": {"enable": "on", "address": "127.0.0.1:9", "subject": "s"},
    "notify_redis": {"enable": "on", "address": "127.0.0.1:9", "key": "k",
                     "format": "channel"},
    "notify_mqtt": {"enable": "on", "address": "127.0.0.1:9", "topic": "t"},
    "notify_elasticsearch": {"enable": "on", "url": "http://127.0.0.1:9", "index": "i"},
    "notify_nsq": {"enable": "on", "address": "127.0.0.1:9", "topic": "t"},
    "notify_kafka": {"enable": "on", "brokers": "127.0.0.1:9", "topic": "t"},
    "notify_amqp": {"enable": "on", "url": "amqp://127.0.0.1:9", "exchange": "e",
                    "routing_key": "r"},
    "notify_postgres": {"enable": "on", "address": "127.0.0.1:9", "table": "bad table"},
    "notify_mysql": {"enable": "on", "address": "127.0.0.1:9", "table": "events"},
}


def test_configured_targets_match_jax(tmp_path, monkeypatch):
    arns = {}
    for pkg in ("jax", "torch"):
        monkeypatch.setenv("MTPU_EVENT_QUEUE_DIR", str(tmp_path / f"q-{pkg}"))
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        srv = JaxServer(paths) if pkg == "jax" else port_server(paths)
        s3 = srv.srv if pkg == "jax" else srv
        errors = []
        monkeypatch.setattr(s3.logger, "error", lambda msg, **kw: errors.append(msg))
        try:
            for sub, kv in ALL_NOTIFY.items():
                s3.config.set_kv(sub, kv)
            s3.configure_event_targets()   # the bad postgres table: logged, skipped
            first = s3.notifier.target_arns
            s3.config.set_kv("notify_nats", {"enable": "off"})
            s3.configure_event_targets()
            arns[pkg] = (first, s3.notifier.target_arns, len(errors))
        finally:
            s3.notifier.close()
            srv.close()
    assert arns["torch"] == arns["jax"]
    # The bad postgres table is logged by each configure that rebuilds.
    assert len(arns["torch"][0]) == 9 and arns["torch"][2] == 2
