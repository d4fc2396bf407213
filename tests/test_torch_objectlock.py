"""Object lock in the port (minio_tpu_torch/bucket/objectlock.py and the
server's WORM checks, ?retention, ?legal-hold, ?object-lock and the lock
headers on PUT) against the JAX package, on the CPU.

- the module: XML documents, default retention and check_worm over a
  seeded grid of modes, dates, holds and the bypass, with an injected
  clock, equal to the JAX module's answers;
- F1: a version the JAX server stored under COMPLIANCE retention or legal
  hold survives the port's DELETE ?versionId and DeleteObjects (before
  the repair the port deleted it); GOVERNANCE yields to the bypass header
  in both;
- over HTTP, each package on its own drives: the lock routes, the bucket
  configuration and CreateBucket's x-amz-bucket-object-lock-enabled
  answer as the JAX server's, version ids renamed; the bucket's default
  retention and the request's lock headers stamp the PUT's metadata as
  the JAX server stamps it.

Tolerance: exact (bytes, statuses, error codes, metadata)."""

import datetime
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from minio_tpu.bucket import objectlock as jolock
from tests import torch_atrest as ta
from tests import torch_iam as ti
from tests.torch_iam import planes_off  # noqa: F401 - fixture

NOW = 1_800_000_000.0
FUTURE = datetime.datetime.fromtimestamp(NOW + 86400, datetime.timezone.utc).strftime(
    "%Y-%m-%dT%H:%M:%SZ")
FAR = (datetime.datetime.now(datetime.timezone.utc)
       + datetime.timedelta(days=3650)).strftime("%Y-%m-%dT%H:%M:%SZ")
PAST = "2001-01-01T00:00:00Z"


def _olock():
    from minio_tpu_torch.bucket import objectlock

    return objectlock


def _outcome(mod, meta, bypass, now):
    try:
        mod.check_worm(meta, bypass_governance=bypass, now=now)
        return None
    except mod.WORMProtected as e:
        return str(e)


@pytest.mark.parametrize("mode", ["", "GOVERNANCE", "COMPLIANCE", "governance"])
@pytest.mark.parametrize("hold", ["", "ON", "OFF", "on"])
def test_check_worm_equals_jax(mode, hold):
    olock = _olock()
    rng = np.random.default_rng(len(mode) * 7 + len(hold))
    untils = ["", PAST, FUTURE, "not-a-date", FUTURE.replace("Z", "+00:00")]
    for until in untils:
        for bypass in (False, True):
            meta = {k: v for k, v in ((olock.KEY_MODE, mode), (olock.KEY_UNTIL, until),
                                      (olock.KEY_HOLD, hold)) if v}
            now = NOW + float(rng.integers(-10, 10))
            assert _outcome(olock, meta, bypass, now) == _outcome(jolock, meta, bypass, now)


DOCS = [
    b'<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>2030-01-02T03:04:05Z'
    b'</RetainUntilDate></Retention>',
    b'<Retention xmlns="http://s3.amazonaws.com/doc/2006-03-01/"><Mode>compliance</Mode>'
    b'<RetainUntilDate>2031-05-06T07:08:09.000Z</RetainUntilDate></Retention>',
    b'<Retention><Mode>FOREVER</Mode><RetainUntilDate>2030-01-01T00:00:00Z'
    b'</RetainUntilDate></Retention>',
    b'<Retention><Mode>GOVERNANCE</Mode></Retention>',
    b'<Retention',
]


@pytest.mark.parametrize("doc", DOCS)
def test_retention_xml_equals_jax(doc):
    olock = _olock()
    results = []
    for mod in (olock, jolock):
        try:
            mode, until = mod.parse_retention_xml(doc)
            results.append((mode, until, mod.retention_xml(mode, until)))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("doc", [b"<LegalHold><Status>ON</Status></LegalHold>",
                                 b"<LegalHold><Status>off</Status></LegalHold>",
                                 b"<LegalHold><Status>MAYBE</Status></LegalHold>",
                                 b"<<"])
def test_legal_hold_xml_equals_jax(doc):
    olock = _olock()
    results = []
    for mod in (olock, jolock):
        try:
            status = mod.parse_legal_hold_xml(doc)
            results.append((status, mod.legal_hold_xml(status)))
        except ValueError as e:
            results.append(("error", str(e)))
    assert results[0] == results[1]


@pytest.mark.parametrize("doc", [
    b"", b"<x", b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled</ObjectLockEnabled>"
    b"</ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>COMPLIANCE</Mode><Days>3</Days>"
    b"</DefaultRetention></Rule></ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>governance</Mode><Years>1</Years>"
    b"</DefaultRetention></Rule></ObjectLockConfiguration>",
    b"<ObjectLockConfiguration><Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
    b"</DefaultRetention></Rule></ObjectLockConfiguration>"])
def test_default_retention_equals_jax(doc):
    assert _olock().parse_default_retention(doc) == jolock.parse_default_retention(doc)


# --- F1 ------------------------------------------------------------------------

LOCKS = {
    "compliance": {"x-amz-object-lock-mode": "COMPLIANCE",
                   "x-amz-object-lock-retain-until-date": FAR},
    "legal-hold": {"x-amz-object-lock-legal-hold": "ON"},
}


def _jax_locked_bucket(paths, lock):
    """The JAX server writes a lock-enabled bucket with two versions of
    `obj`, the first under `lock`; -> (the locked version's id and bytes,
    the newer version's id)."""
    js = ta.JaxServer(paths)
    try:
        cl = ti.root(js.url)
        assert cl.put("/lockb", headers={"x-amz-bucket-object-lock-enabled": "true"}
                      ).status_code == 200
        data = ta.payload(70_000, 14)
        r = cl.put("/lockb/obj", data=data, headers=LOCKS[lock])
        assert r.status_code == 200, r.text
        vid = r.headers["x-amz-version-id"]
        newer = cl.put("/lockb/obj", data=b"newer").headers["x-amz-version-id"]
        return vid, data, newer
    finally:
        js.close()


@pytest.mark.parametrize("lock", sorted(LOCKS))
def test_f1_locked_version_jax_wrote_survives_port_delete(planes_off, tmp_path, lock):
    """A version the JAX package stored under COMPLIANCE retention or legal
    hold is refused to DELETE ?versionId (as the JAX server refuses it,
    minio_tpu/s3/server.py:1624-1639) and to DeleteObjects by VersionId
    (which the JAX server lets through), and reads back byte-equal after
    each attempt; the unlocked newer version deletes."""
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    vid, data, newer = _jax_locked_bucket(paths, lock)
    ts = ta.port_server(paths)
    try:
        cl = ti.root(ts.url)
        for bypass in ({}, {"x-amz-bypass-governance-retention": "true"}):
            r = cl.delete("/lockb/obj", query={"versionId": vid}, headers=bypass)
            assert (r.status_code, ti.error_code(r)) == (403, "AccessDenied")
            assert cl.get("/lockb/obj", query={"versionId": vid}).content == data
        doc = (f'<Delete><Object><Key>obj</Key><VersionId>{vid}</VersionId></Object>'
               f'<Object><Key>obj</Key><VersionId>{newer}</VersionId></Object></Delete>')
        r = cl.post("/lockb", query={"delete": ""}, data=doc.encode())
        assert r.status_code == 200, r.text
        res = ET.fromstring(r.content)
        errors = [(e.findtext(ti.S3_NS + "Key"), e.findtext(ti.S3_NS + "Code"))
                  for e in res.iter(ti.S3_NS + "Error")]
        deleted = [d.findtext(ti.S3_NS + "VersionId") for d in res.iter(ti.S3_NS + "Deleted")]
        assert errors == [("obj", "AccessDenied")] and deleted == [newer]
        assert cl.get("/lockb/obj", query={"versionId": vid}).content == data
        assert cl.get("/lockb/obj").content == data
    finally:
        ts.close()


@pytest.mark.parametrize("pkg", ti.PKGS)
def test_governance_yields_to_the_bypass_header(planes_off, tmp_path, pkg):
    paths = [str(tmp_path / f"d{i}") for i in range(4)]
    srv = ti.server(pkg, paths)
    try:
        cl = ti.root(srv.url)
        cl.put("/govb", headers={"x-amz-bucket-object-lock-enabled": "true"})
        vid = cl.put("/govb/obj", data=b"kept a while", headers={
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": FAR}).headers["x-amz-version-id"]
        r = cl.delete("/govb/obj", query={"versionId": vid})
        assert (r.status_code, ti.error_code(r)) == (403, "AccessDenied")
        r = cl.delete("/govb/obj", query={"versionId": vid},
                      headers={"x-amz-bypass-governance-retention": "true"})
        assert r.status_code == 204
        assert cl.get("/govb/obj", query={"versionId": vid}).status_code == 404
    finally:
        srv.close()


# --- the routes, each package on its own drives ------------------------------------

_DEFAULT_RETENTION = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
                      b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
                      b"<Days>2</Days></DefaultRetention></Rule></ObjectLockConfiguration>")


def _lock_script(cl):
    """The lock calls of a client's session; -> [(status, code or body)],
    version ids renamed V1, V2, ... by first appearance."""
    out = []
    ids: dict[str, str] = {}

    def rec(r):
        body = r.content
        for vid, name in ids.items():
            body = body.replace(vid.encode(), name.encode())
        out.append((r.status_code, ti.error_code(r) if r.status_code >= 300 else body))
        return r

    def vid_of(r):
        v = r.headers.get("x-amz-version-id", "")
        ids.setdefault(v, f"V{len(ids) + 1}")
        return v

    rec(cl.put("/plainb"))
    rec(cl.put("/plainb", data=_DEFAULT_RETENTION, query={"object-lock": ""}))
    rec(cl.get("/plainb", query={"object-lock": ""}))
    rec(cl.put("/lockb", headers={"x-amz-bucket-object-lock-enabled": "true"}))
    rec(cl.get("/lockb", query={"object-lock": ""}))
    rec(cl.get("/lockb", query={"versioning": ""}))
    rec(cl.put("/lockb", data=b"<VersioningConfiguration><Status>Suspended</Status>"
               b"</VersioningConfiguration>", query={"versioning": ""}))
    v1 = vid_of(rec(cl.put("/lockb/a", data=b"first")))
    rec(cl.get("/lockb/a", query={"retention": ""}))
    rec(cl.get("/lockb/a", query={"legal-hold": ""}))
    rec(cl.put("/lockb/a", query={"retention": "", "versionId": v1}, data=(
        f"<Retention><Mode>GOVERNANCE</Mode><RetainUntilDate>{FAR}</RetainUntilDate>"
        f"</Retention>").encode()))
    rec(cl.get("/lockb/a", query={"retention": "", "versionId": v1}))
    rec(cl.put("/lockb/a", query={"retention": ""}, data=(
        f"<Retention><Mode>COMPLIANCE</Mode><RetainUntilDate>{FAR}</RetainUntilDate>"
        f"</Retention>").encode()))
    rec(cl.put("/lockb/a", query={"retention": ""}, data=b"<Retention>"))
    rec(cl.put("/lockb/a", query={"legal-hold": ""},
               data=b"<LegalHold><Status>ON</Status></LegalHold>"))
    rec(cl.get("/lockb/a", query={"legal-hold": ""}))
    rec(cl.delete("/lockb/a", query={"versionId": v1},
                  headers={"x-amz-bypass-governance-retention": "true"}))
    rec(cl.put("/lockb/a", query={"legal-hold": ""},
               data=b"<LegalHold><Status>OFF</Status></LegalHold>"))
    rec(cl.delete("/lockb/a", query={"versionId": v1},
                  headers={"x-amz-bypass-governance-retention": "true"}))
    rec(cl.get("/lockb/missing", query={"retention": ""}))
    rec(cl.put("/lockb", data=_DEFAULT_RETENTION, query={"object-lock": ""}))
    rec(cl.get("/lockb", query={"object-lock": ""}))
    v2 = vid_of(rec(cl.put("/lockb/b", data=b"defaulted")))
    rec(cl.delete("/lockb/b", query={"versionId": v2}))
    return out


def test_lock_routes_answer_as_jax(planes_off, tmp_path):
    results = {}
    for pkg in ti.PKGS:
        srv = ti.server(pkg, [str(tmp_path / pkg / f"d{i}") for i in range(4)])
        try:
            results[pkg] = _lock_script(ti.root(srv.url))
        finally:
            srv.close()
    assert results["torch"] == results["jax"]


@pytest.mark.parametrize("headers", [
    {},
    {"x-amz-object-lock-mode": "compliance", "x-amz-object-lock-retain-until-date": FAR,
     "x-amz-object-lock-legal-hold": "on"},
    {"x-amz-object-lock-legal-hold": "ON"},
    {"x-amz-object-lock-mode": "GOVERNANCE"},
])
def test_put_lock_metadata_equals_jax(planes_off, tmp_path, headers):
    """The lock keys a PUT stores (its headers, else the bucket's default
    retention, until = the PUT's clock + 2 days) are the JAX server's, in
    the same order."""
    metas = {}
    for pkg in ti.PKGS:
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        srv = ti.server(pkg, paths)
        try:
            cl = ti.root(srv.url)
            cl.put("/lockb", headers={"x-amz-bucket-object-lock-enabled": "true"})
            cl.put("/lockb", data=_DEFAULT_RETENTION, query={"object-lock": ""})
            t0 = datetime.datetime.now(datetime.timezone.utc).timestamp()
            assert cl.put("/lockb/k", data=b"x" * 100, headers=headers).status_code == 200
            t1 = datetime.datetime.now(datetime.timezone.utc).timestamp()
            es = (srv.srv if pkg == "jax" else srv).obj.pools[0].sets[0]
            meta = dict(es.latest_fileinfo("lockb", "k").metadata)
        finally:
            srv.close()
        until = meta.get(jolock.KEY_UNTIL, "")
        if until and "x-amz-object-lock-retain-until-date" not in headers:
            assert int(t0) + 2 * 86400 - 1 <= jolock.parse_iso(until) <= t1 + 2 * 86400
            meta[jolock.KEY_UNTIL] = "default"
        metas[pkg] = [(k, v) for k, v in meta.items() if k.startswith("x-amz-object-lock")]
    assert metas["torch"] == metas["jax"]
