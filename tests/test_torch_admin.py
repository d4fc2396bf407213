"""The port's admin plane and front-door observability (minio_tpu_torch
admin/, s3/server.py) against the JAX server's, on the CPU.

One request script goes to both servers, each over its own 4 drives (the
JAX side pinned to mxsum256 with both planes off, as in
tests/test_torch_versioning.py). Tolerance: exact for the scrape's
(family, label names) pairs, the deterministic counters, the heal route's
item JSON and rebuilt bytes, the info keys, top/api, the health probes
and the trace record types."""

import importlib
import io
import json
import os
import shutil
import threading
import time
import urllib.parse
import zipfile

import numpy as np
import pytest
import requests

from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client
from tests.test_observability import parse_exposition
from tests.torch_atrest import JaxServer as _JaxServer

BUCKET = "adm"
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# A family is registered when its module is imported, in both packages:
# import every module that defines one on both sides, so the two
# registries hold the same families whatever ran before in this process.
FAMILY_MODULES = ("obs.kernel", "obs.flight", "hottier.tier", "dataplane.batcher",
                  "utils.admission", "erasure.healing", "erasure.objects",
                  "erasure.metadata", "storage.local", "storage.healthcheck",
                  "metaplane.groupcommit", "metaplane.setcache", "s3.server",
                  "frontdoor.laneserver", "frontdoor.worker",
                  "frontdoor.supervisor")
for _m in FAMILY_MODULES:
    importlib.import_module(f"minio_tpu.{_m}")
    importlib.import_module(f"minio_tpu_torch.{_m}")

# The JAX modules whose metric families the port does not have yet, each
# with the ROADMAP.md Queue 1 item that brings it. A family the JAX scrape
# shows and the port's does not must be defined in one of these.
JAX_ONLY_MODULES = {
    "minio_tpu/storage/local.py": 3,         # directory fsync errors
    "minio_tpu/dist/": 7,                    # peers, RPC fabric, dsync
    "minio_tpu/replication/": 7,
    "minio_tpu/scanner/": 7,
    "minio_tpu/cache/": 7,
    "minio_tpu/logger/": 7,
    "minio_tpu/event/": 7,
    "minio_tpu/admin/metrics.py": 7,         # the peer scrape
    "minio_tpu/obs/calibration.py": 2,       # obs/ left for a later slice
    "minio_tpu/obs/slo.py": 2,
    "minio_tpu/obs/tsdb.py": 2,
}


def _defining_module(family: str) -> str:
    root = os.path.join(os.path.dirname(__file__), os.pardir)
    for dirpath, _dirs, files in os.walk(os.path.join(root, "minio_tpu")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path, encoding="utf-8") as fh:
                    if f'"{family}"' in fh.read():
                        return os.path.relpath(path, root).replace(os.sep, "/")
    return ""


def _roadmap_item(family: str) -> int | None:
    mod = _defining_module(family)
    return next((item for prefix, item in JAX_ONLY_MODULES.items()
                 if mod.startswith(prefix)), None)


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def planes_off():
    mp = pytest.MonkeyPatch()
    mp.setenv("MTPU_METAPLANE", "0")
    mp.setenv("MTPU_BATCHED_DATAPLANE", "0")
    yield
    mp.undo()


def _servers(root, n, parity=None):
    from minio_tpu_torch.s3.server import build_server

    jp = [str(root / f"j{i:02d}") for i in range(n)]
    tp = [str(root / f"t{i:02d}") for i in range(n)]
    js = _JaxServer(jp, parity)
    ts = build_server(tp, S3_ACCESS, S3_SECRET, device="cpu", parity=parity,
                      enable_mrf=False).start()
    return js, ts, jp, tp


@pytest.fixture(scope="module")
def pair(tmp_path_factory, planes_off):
    js, ts, jp, tp = _servers(tmp_path_factory.mktemp("admin-pair"), 4)
    yield {"jax": js, "torch": ts, "paths": {"jax": jp, "torch": tp}}
    ts.close()
    js.close()


class _ChildServer:
    """One package's server in a child interpreter of its own (this module
    imported there, so its registries hold the same families), serving
    until its stdin closes. The scrape comparison runs on two of them:
    the kernel-launch families are process-global, and a pytest worker
    holds whatever layers the files it ran before left alive (one run of
    the whole suite under pytest-xdist counted a `bitrot_verify_sip256`
    launch of a JAX layer outside the pair in the script's window)."""

    CODE = ("import sys; from tests import test_torch_admin as t; "
            "srv = t._child_server(sys.argv[1], sys.argv[2]); "
            "print(srv.url, flush=True); sys.stdin.read(); srv.close()")

    def __init__(self, pkg: str, root):
        import subprocess
        import sys

        env = dict(os.environ, MTPU_METAPLANE="0", MTPU_BATCHED_DATAPLANE="0",
                   JAX_PLATFORMS="cpu")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", self.CODE, pkg, str(root)], cwd=_ROOT, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        self.url = ""

    def wait_url(self) -> "_ChildServer":
        self.url = self.proc.stdout.readline().strip()
        assert self.url.startswith("http://"), self.url
        return self

    def close(self) -> None:
        self.proc.stdin.close()
        assert self.proc.wait(60) == 0


def _child_server(pkg: str, root: str):
    """The server a _ChildServer runs: the pair's, over 4 drives in root."""
    from minio_tpu_torch.s3.server import build_server

    paths = [os.path.join(root, f"{pkg[0]}{i:02d}") for i in range(4)]
    if pkg == "jax":
        return _JaxServer(paths)
    return build_server(paths, S3_ACCESS, S3_SECRET, device="cpu",
                        enable_mrf=False).start()


@pytest.fixture
def isolated_pair(tmp_path):
    """The pair of servers, each in a process of its own."""
    kids = {k: _ChildServer(k, tmp_path) for k in ("jax", "torch")}
    try:
        yield {k: c.wait_url() for k, c in kids.items()}
    finally:
        for c in kids.values():
            c.close()


def _clients(pair):
    return {"jax": SigV4Client(pair["jax"].url, S3_ACCESS, S3_SECRET),
            "torch": SigV4Client(pair["torch"].url, S3_ACCESS, S3_SECRET)}


def _scrape(cl, path="/minio/v2/metrics/cluster"):
    r = cl.get(path)
    assert r.status_code == 200, r.text
    assert r.headers["Content-Type"].startswith("text/plain; version=0.0.4")
    return parse_exposition(r.text)


def _family_of(name, families):
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name[: -len(suffix)] in families:
            return name[: -len(suffix)]
    return name


def _label_sets(scrape):
    families, samples = scrape
    out = {(f, ()) for f in families}
    for name, labels, _v in samples:
        fam = _family_of(name, families)
        out.add((fam, tuple(sorted(k for k in labels if k != "le"))))
    return out


def _sum(scrape, name, **match):
    _f, samples = scrape
    return sum(v for n, lbl, v in samples
               if n == name and all(lbl.get(k) == w for k, w in match.items()))


def _by_label(scrape, name, key):
    out: dict = {}
    for n, lbl, v in scrape[1]:
        if n == name:
            out[lbl[key]] = out.get(lbl[key], 0) + v
    return out


def _script(bucket):
    small, big = _payload(1000, 1), _payload(300 << 10, 2)
    return [("PUT", f"/{bucket}", {}, b""),
            ("PUT", f"/{bucket}/small", {}, small),
            ("PUT", f"/{bucket}/big", {}, big),
            ("GET", f"/{bucket}/small", {}, b""),
            ("GET", f"/{bucket}/big", {}, b""),
            ("GET", f"/{bucket}/big", {"Range": "bytes=1000-70999"}, b""),
            ("HEAD", f"/{bucket}/big", {}, b""),
            ("GET", f"/{bucket}/missing", {}, b""),
            ("HEAD", f"/{bucket}/missing", {}, b""),
            ("GET", f"/{bucket}", {}, b""),
            ("DELETE", f"/{bucket}/small", {}, b"")]


def test_scrape_families_and_counters_match_jax(isolated_pair):
    pair = isolated_pair
    cls = _clients(pair)
    before = {k: _scrape(c) for k, c in cls.items()}
    for method, path, headers, body in _script(BUCKET):
        codes = {k: c.request(method, path, headers=headers, data=body).status_code
                 for k, c in cls.items()}
        assert codes["jax"] == codes["torch"], (method, path, codes)
    anon = {k: requests.get(s.url + "/minio/v2/metrics/cluster", timeout=30).status_code
            for k, s in (("jax", pair["jax"]), ("torch", pair["torch"]))}
    assert anon == {"jax": 403, "torch": 403}
    after = {k: _scrape(c) for k, c in cls.items()}

    # Families and their types: the port's are the JAX server's, less the
    # families of planes the port lacks. Label names: equal in every
    # family both samples (the registries are process-global, so which
    # families hold samples depends on what ran before in this process).
    jf, tf = after["jax"][0], after["torch"][0]
    assert {f: tf[f] for f in tf} == {f: jf[f] for f in tf if f in jf}
    unplaced = sorted(f for f in set(jf) - set(tf) if _roadmap_item(f) is None)
    assert not unplaced, unplaced
    jl, tl = _label_sets(after["jax"]), _label_sets(after["torch"])
    sampled = {f for f, lbl in jl if lbl} & {f for f, lbl in tl if lbl}
    assert sampled >= {"minio_tpu_s3_requests_total", "minio_tpu_drive_latency_seconds",
                       "minio_tpu_kernel_launches_total",
                       "minio_tpu_s3_requests_latency_seconds"}
    for f in sampled:
        assert {lbl for g, lbl in tl if g == f and lbl} == \
            {lbl for g, lbl in jl if g == f and lbl}, f

    # Deterministic counters: requests, 4xx, traffic, drives online. The
    # scrape's own bytes differ with the families, so traffic leaves the
    # `metrics` API out.
    for fam in ("minio_tpu_s3_requests_total", "minio_tpu_s3_requests_4xx_errors_total",
                "minio_tpu_s3_traffic_received_bytes", "minio_tpu_s3_traffic_sent_bytes"):
        got, want = (_by_label(after[k], fam, "api") for k in ("torch", "jax"))
        if "traffic" in fam:
            got.pop("metrics"), want.pop("metrics")
        assert got == want, fam
    for fam in ("minio_tpu_cluster_disk_online_total", "minio_tpu_cluster_health_status"):
        assert _sum(after["torch"], fam) == _sum(after["jax"], fam) > 0, fam

    # Kernel launches per label over the script (registries are
    # process-global: deltas; the backend label is each package's own).
    def launches(k):
        a = _by_label(after[k], "minio_tpu_kernel_launches_total", "kernel")
        b = _by_label(before[k], "minio_tpu_kernel_launches_total", "kernel")
        return {lbl: v - b.get(lbl, 0) for lbl, v in a.items() if v - b.get(lbl, 0)}

    assert launches("torch") == launches("jax") != {}
    assert {lbl["backend"] for n, lbl, _v in after["torch"][1]
            if n == "minio_tpu_kernel_launches_total"} >= {"cpu"}


def test_node_scrape_and_openmetrics(pair):
    cl = _clients(pair)["torch"]
    fams, _s = _scrape(cl, "/minio/v2/metrics/node")
    assert "minio_tpu_s3_requests_latency_seconds" in fams
    assert "minio_tpu_cluster_disk_online_total" not in fams
    r = cl.get("/minio/v2/metrics/cluster",
               headers={"Accept": "application/openmetrics-text; version=1.0.0"})
    assert r.headers["Content-Type"].startswith("application/openmetrics-text")
    assert r.text.endswith("# EOF\n")
    r = cl.get("/minio/admin/v3/metrics", headers={"Accept-Encoding": "gzip"})
    assert r.status_code == 200 and "minio_tpu_s3_requests_total" in r.text


def _norm_info(doc):
    return {k: (sorted(v) if isinstance(v, dict) else type(v).__name__)
            for k, v in doc.items()}


def test_info_top_health_and_refusals_match_jax(pair):
    cls = _clients(pair)
    infos = {k: c.get("/minio/admin/v3/info").json() for k, c in cls.items()}
    assert _norm_info(infos["torch"]) == _norm_info(infos["jax"])
    # healthState and timeouts come from each package's drive health
    # checker.
    assert [sorted(d) for d in infos["torch"]["drives"]] == \
        [sorted(d) for d in infos["jax"]["drives"]]
    assert [(d["healthState"], d["timeouts"]) for d in infos["torch"]["drives"]] == \
        [(d["healthState"], d["timeouts"]) for d in infos["jax"]["drives"]]
    assert infos["torch"]["drivesOnline"] == infos["jax"]["drivesOnline"] == 4
    assert infos["torch"]["backend"] == infos["jax"]["backend"]
    assert infos["torch"]["mode"] == infos["jax"]["mode"] == "online"
    tops = {k: c.get("/minio/admin/v3/top/api").json() for k, c in cls.items()}
    # The one request in flight is the top call itself.
    assert [(r["api"], sorted(r)) for r in tops["torch"]["requests"]] == \
        [(r["api"], sorted(r)) for r in tops["jax"]["requests"]] == \
        [("admin.top", ["ageMs", "api", "remote", "tenant", "trace_id"])]
    for path in ("/minio/health/live", "/minio/health/ready", "/minio/health/cluster",
                 "/minio/health/cluster?maintenance=true", "/minio/health/nope",
                 "/minio/admin/v3/info", "/minio/admin/v3/nosuchop"):
        got = {}
        for k, s in (("jax", pair["jax"]), ("torch", pair["torch"])):
            r = requests.get(s.url + path, timeout=30)
            got[k] = (r.status_code, r.headers.get("X-Minio-Write-Quorum"),
                      r.headers.get("X-Minio-Server-Status"))
        assert got["torch"] == got["jax"], (path, got)
    # Signed: a /minio/ path never reaches a bucket named minio.
    for path in ("/minio/v2/metrics/other", "/minio/admin/v3/nosuchop"):
        codes = {k: c.get(path).status_code for k, c in cls.items()}
        assert codes["torch"] == codes["jax"] == 405, (path, codes)


def test_health_probes_at_write_quorum(tmp_path, planes_off):
    """4 drives at EC 2+2: write quorum 3. With one drive gone the set
    still has quorum but maintenance mode needs one more (503), in both
    servers alike."""
    js, ts, jp, tp = _servers(tmp_path, 4)
    try:
        for p in (jp[0], tp[0]):
            shutil.rmtree(p)
        for path in ("/minio/health/cluster", "/minio/health/cluster?maintenance=true"):
            got = {}
            for k, s in (("jax", js), ("torch", ts)):
                r = requests.get(s.url + path, timeout=30)
                got[k] = (r.status_code, r.headers.get("X-Minio-Write-Quorum"),
                          r.headers.get("X-Minio-Server-Status"))
            assert got["torch"] == got["jax"], (path, got)
        assert got["torch"][0] == 503
    finally:
        ts.close()
        js.close()


def _tree(paths):
    out = {}
    for i, p in enumerate(paths):
        for dirpath, _dirs, files in os.walk(p):
            rel = os.path.relpath(dirpath, p)
            # The heal writes the buckets; the system volume holds staging
            # and the state of JAX planes the port lacks (replication
            # journal, SLO history), so only its format.json compares.
            if rel.startswith(".mtpu.sys") and rel != ".mtpu.sys":
                continue
            for f in files:
                if rel == ".mtpu.sys" and f != "format.json":
                    continue
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[(i, rel, f)] = fh.read()
    return out


def test_admin_heal_route_matches_jax(tmp_path, planes_off):
    """The port's server writes 12 drives at EC 8+4; the tree is copied,
    4 drives' bucket contents are wiped in both copies, and each package's
    server heals its copy through POST /minio/admin/v3/heal/<bucket> with
    scanMode 2: the same item JSON and byte-equal trees."""
    from minio_tpu_torch.s3.server import build_server

    src = [str(tmp_path / f"s{i:02d}") for i in range(12)]
    ts = build_server(src, S3_ACCESS, S3_SECRET, device="cpu", enable_mrf=False).start()
    try:
        cl = SigV4Client(ts.url, S3_ACCESS, S3_SECRET)
        assert cl.put("/heal").status_code == 200
        for key, size, seed in (("big", (2 << 20) + 777, 5), ("mid", 200_000, 6),
                                ("tiny", 500, 7), ("dir/obj", 70_000, 8)):
            assert cl.put(f"/heal/{key}", data=_payload(size, seed)).status_code == 200
    finally:
        ts.close()
    roots = {}
    for k in ("jax", "torch"):
        roots[k] = [str(tmp_path / f"{k}{i:02d}") for i in range(12)]
        for a, b in zip(src, roots[k]):
            shutil.copytree(a, b)
        for p in roots[k][:4]:
            shutil.rmtree(os.path.join(p, "heal"))
    js = _JaxServer(roots["jax"])
    ts = build_server(roots["torch"], S3_ACCESS, S3_SECRET, device="cpu",
                      enable_mrf=False).start()
    try:
        docs = {}
        for k, s in (("jax", js), ("torch", ts)):
            cl = SigV4Client(s.url, S3_ACCESS, S3_SECRET)
            r = cl.post("/minio/admin/v3/heal/heal", data=json.dumps({"scanMode": 2}).encode())
            assert r.status_code == 200, r.text
            text = r.text
            for i, p in enumerate(roots[k]):
                text = text.replace(json.dumps(p)[1:-1], f"<drive{i}>")
            docs[k] = json.loads(text)
            bad = cl.post("/minio/admin/v3/heal/heal", data=b'{"scanMode": "deeep"}')
            assert bad.status_code == 400
            assert cl.post("/minio/admin/v3/heal/nobucket",
                           data=b"{}").status_code == 404
        assert docs["torch"] == docs["jax"]
        assert [i["object"] for i in docs["torch"]["items"]] == ["", "big", "dir/obj",
                                                                  "mid", "tiny"]
        tree = _tree(roots["torch"])
        assert tree == _tree(roots["jax"])
        # The wiped drives hold their rebuilt shard files again.
        assert {i for i, _rel, f in tree if f == "part.1"} == set(range(12))
    finally:
        ts.close()
        js.close()


def _stream_trace(url, cl, out, stop):
    signed = cl._sign("GET", "/minio/admin/v3/trace", {}, {}, b"")
    with requests.get(url + "/minio/admin/v3/trace", headers=signed, stream=True,
                      timeout=30) as r:
        assert r.status_code == 200
        for line in r.iter_lines():
            if line:
                out.append(json.loads(line))
            if stop.is_set():
                return


def test_trace_stream_of_one_get_has_the_same_record_types(pair):
    cls = _clients(pair)
    types = {}
    for k, s in (("jax", pair["jax"]), ("torch", pair["torch"])):
        cls[k].put(f"/{BUCKET}")
        assert cls[k].put(f"/{BUCKET}/traced", data=_payload(300 << 10, 9)).status_code == 200
        recs, stop = [], threading.Event()
        t = threading.Thread(target=_stream_trace, args=(s.url, cls[k], recs, stop),
                             daemon=True)
        t.start()
        time.sleep(0.5)
        r = cls[k].get(f"/{BUCKET}/traced")
        assert r.status_code == 200
        rid = r.headers["x-amz-request-id"]
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not any(
                x.get("type") == "http" and x.get("requestId") == rid for x in recs):
            time.sleep(0.05)
        stop.set()
        t.join(10)
        mine = [x for x in recs if rid in (x.get("trace_id"), x.get("requestId"))]
        types[k] = {x["type"] for x in mine}
        assert all(x.get("trace_id") == rid for x in mine if x["type"] == "storage")
    assert types["torch"] == types["jax"]
    assert {"http", "storage", "kernel"} <= types["torch"]


def test_trace_stream_ends_when_the_client_goes(pair):
    from minio_tpu_torch import obs

    cl = _clients(pair)["torch"]
    recs, stop = [], threading.Event()
    stop.set()   # leave at the first line (a heartbeat or a record)
    _stream_trace(pair["torch"].url, cl, recs, stop)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and obs.has_subscribers():
        time.sleep(0.05)
    assert not obs.has_subscribers()


def test_perf_timeline_names_the_jax_stages(pair):
    cls = _clients(pair)
    stages = {}
    for k, c in cls.items():
        c.put(f"/{BUCKET}")
        r = c.put(f"/{BUCKET}/timed", data=_payload(300 << 10, 10))
        rid = r.headers["x-amz-request-id"]
        doc = c.get("/minio/admin/v3/perf/timeline", query={"traceid": rid}).json()
        (tl,) = doc["timelines"]
        assert tl["api"] == "PutObject" and tl["status"] == 200
        stages[k] = [(s["stage"], s["plane"]) for s in tl["stages"] if s["seq"]]
    assert stages["torch"] == stages["jax"]
    assert [s for s, _p in stages["torch"]] == ["auth", "rx_drain", "encode", "commit",
                                                "resp_drain"]


def test_profiling_kinds(pair, monkeypatch):
    cl = _clients(pair)["torch"]
    r = cl.post("/minio/admin/v3/profiling/start", query={"profilerType": "cpu"})
    assert r.status_code == 200, r.text
    assert cl.get(f"/{BUCKET}").status_code == 200
    r = cl.get("/minio/admin/v3/profiling/download")
    assert r.status_code == 200
    names = zipfile.ZipFile(io.BytesIO(r.content)).namelist()
    assert sorted(names) == ["local/cpu.pstats", "local/cpu.txt"]
    # tpu has no meaning on this device; device without a card raises at
    # start and leaves no session running.
    r = cl.post("/minio/admin/v3/profiling/start", query={"profilerType": "tpu"})
    assert r.status_code == 400 and b"device" in r.content
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    r = cl.post("/minio/admin/v3/profiling/start", query={"profilerType": "cpu,device"})
    assert r.status_code == 500 and b"CUDA device" in r.content
    assert not pair["torch"].profiler.running


class _FakeDeviceProfile:
    """A stopped torch.profiler capture whose trace holds `kernels`
    kernel events."""

    def __init__(self, kernels):
        self.kernels = kernels

    def stop(self):
        pass

    def export_chrome_trace(self, path):
        events = [{"cat": "cpu_op", "name": "aten::cat"}]
        events += [{"cat": "kernel", "name": "gf2_kernel"}] * self.kernels
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)


@pytest.mark.parametrize("captured", [0, 2, 3])
def test_device_capture_that_lost_the_kernels_is_refused(pair, monkeypatch, captured):
    """A device capture whose trace holds fewer events of a kernel than
    it launched while the capture was on: the download answers an error,
    never a trace that leaves them out."""
    import torch

    from minio_tpu_torch.ops import kernels

    cl = _clients(pair)["torch"]
    prof = pair["torch"].profiler
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(kernels, "launches", lambda: {"gf2_matmul": 5, "mxsum_digest": 9})
    prof._launches0 = {"gf2_matmul": 2, "mxsum_digest": 9}
    prof._device = _FakeDeviceProfile(captured)
    r = cl.get("/minio/admin/v3/profiling/download")
    assert not prof.running
    if captured == 3:
        assert r.status_code == 200
        assert zipfile.ZipFile(io.BytesIO(r.content)).namelist() == ["local/device_trace.zip"]
    else:
        assert r.status_code == 500
        assert f"(gf2_matmul: {captured} of 3)".encode() in r.content


def test_admin_ops_of_other_planes_answer_not_implemented(pair):
    cls = _clients(pair)
    # `slo` is served since the SLO plane landed; `faults` answers
    # NotImplemented until the process opts in (MTPU_FAULT_INJECTION=1),
    # as the JAX route does.
    for op in ("obdinfo", "faults", "top/locks"):
        assert cls["torch"].get(f"/minio/admin/v3/{op}").status_code == 501, op


def _usage_doc(doc):
    return {k: v for k, v in doc.items() if k != "lastUpdate"}


def test_datausageinfo_matches_jax(pair):
    from minio_tpu.scanner import DataScanner as JaxScanner

    cls = _clients(pair)
    before = {k: c.get("/minio/admin/v3/datausageinfo") for k, c in cls.items()}
    assert [r.status_code for r in before.values()] == [200, 200]
    assert before["torch"].json() == before["jax"].json() == \
        {"objectsCount": 0, "bucketsUsage": {}}
    for k, c in cls.items():
        c.put("/usage")
        for i, size in enumerate((0, 1000, 300 << 10)):
            assert c.put(f"/usage/o{i}", data=_payload(size, i)).status_code == 200
    js, ts = pair["jax"].srv, pair["torch"]
    js.scanner = JaxScanner(js.obj, js.bucket_meta, tracker=js.update_tracker,
                            config=js.config)
    ts.start_scanner(loop=False)
    try:
        js.scanner.scan_once()
        ts.scanner.scan_once()
        got = {k: c.get("/minio/admin/v3/datausageinfo").json() for k, c in cls.items()}
        assert _usage_doc(got["torch"]) == _usage_doc(got["jax"])
        assert got["torch"]["bucketsUsage"]["usage"]["objectsCount"] == 3
        assert got["torch"]["lastUpdate"] > 0
        anon = requests.get(ts.url + "/minio/admin/v3/datausageinfo", timeout=30)
        assert anon.status_code == 403
    finally:
        js.scanner = None
        ts.scanner = None


def test_tier_admin_matches_jax(pair, tmp_path):
    cls = _clients(pair)
    fs_doc = {"kind": "fs", "name": "COLD", "dir": str(tmp_path / "cold")}
    s3_doc = {"kind": "s3", "name": "WARM", "endpoint": "http://127.0.0.1:9",
              "accessKey": "ak", "secretKey": "very-secret", "bucket": "b",
              "prefix": "p", "region": "us-east-1"}
    script = [("GET", {}, b""), ("PUT", {}, json.dumps(fs_doc).encode()),
              ("PUT", {}, json.dumps(fs_doc).encode()),
              ("PUT", {}, json.dumps(s3_doc).encode()),
              ("PUT", {}, b'{"kind": "tape", "name": "T"}'), ("PUT", {}, b"not json"),
              ("GET", {}, b""), ("DELETE", {"name": "COLD"}, b""),
              ("DELETE", {"name": "COLD", "force": "true"}, b""),
              ("DELETE", {"name": "WARM", "force": "1"}, b""), ("GET", {}, b"")]
    got = {}
    for k, c in cls.items():
        out = []
        for method, query, body in script:
            r = c.request(method, "/minio/admin/v3/tier", query=query, data=body)
            out.append((r.status_code, r.json() if r.status_code == 200 else
                        r.content.split(b"<Code>")[1].split(b"</Code>")[0]))
        got[k] = out
    assert got["torch"] == got["jax"]
    listed = got["torch"][6][1]["tiers"]
    assert {t["name"]: t.get("secretKey") for t in listed} == {"COLD": None,
                                                               "WARM": "*REDACTED*"}
    assert got["torch"][-1] == (200, {"tiers": []})


def _stream_lines(url, cl, path, out, stop):
    signed = cl._sign("GET", path, {}, {}, b"")
    with requests.get(url + path, headers=signed, stream=True, timeout=30) as r:
        assert r.status_code == 200
        for line in r.iter_lines():
            if line:
                out.append(json.loads(line))
            if stop.is_set():
                return


def test_consolelog_matches_jax(pair):
    cls = _clients(pair)
    got = {}
    for k, s3 in (("jax", pair["jax"].srv), ("torch", pair["torch"])):
        url = pair[k].url
        lines, stop = [], threading.Event()
        t = threading.Thread(target=_stream_lines, daemon=True,
                             args=(url, cls[k], "/minio/admin/v3/consolelog", lines, stop))
        t.start()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and not s3.logger.console_bus.has_subscribers:
            time.sleep(0.02)
        s3.logger.warning(f"console line {k}", bucket="b", n=7)
        while time.monotonic() < deadline and not any(
                x.get("message") == f"console line {k}" for x in lines):
            time.sleep(0.02)
        stop.set()
        s3.logger.info("wake the stream")   # the client leaves at its next line
        t.join(10)
        # The server sees the client gone at its next write (a heartbeat):
        # the stream unsubscribes and leaves the in-flight count.
        while time.monotonic() < deadline + 10 and s3.logger.console_bus.has_subscribers:
            time.sleep(0.05)
        assert not s3.logger.console_bus.has_subscribers
        mine = [x for x in lines if x.get("message") == f"console line {k}"]
        assert len(mine) == 1, lines
        got[k] = {**mine[0], "time": "T", "message": "M"}
    assert got["torch"] == got["jax"]
    assert got["torch"]["level"] == "WARNING" and got["torch"]["n"] == 7
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and pair["torch"].current_requests:
        time.sleep(0.05)
    assert pair["torch"].current_requests == 0
    anon = requests.get(pair["torch"].url + "/minio/admin/v3/consolelog", timeout=30)
    assert anon.status_code == 403


def test_request_accounting_ends_before_the_answer_is_read(pair):
    """A client that has read an answer never finds it in flight."""
    cl = _clients(pair)["torch"]
    srv = pair["torch"]
    cl.put(f"/{BUCKET}")
    cl.put(f"/{BUCKET}/acct", data=_payload(200_000, 11))
    for _ in range(20):
        assert cl.get(f"/{BUCKET}/acct").status_code == 200
        assert srv.current_requests == 0
        assert cl.head(f"/{BUCKET}/acct").status_code == 200
        assert srv.current_requests == 0
    assert urllib.parse.urlparse(srv.url).port
