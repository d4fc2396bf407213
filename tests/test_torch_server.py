"""The port's S3 server (minio_tpu_torch.s3.server, plain PyTorch on the
CPU) against the JAX package's: one request script, sent through the same
SigV4 client to both servers, must get equal statuses, bodies (error XML
compared without RequestId/HostId), ETag, Content-Length, Content-Range and
Content-Type."""

import time
import uuid
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client


@pytest.fixture(scope="module")
def torch_server(tmp_path_factory):
    from minio_tpu_torch.s3.server import build_server

    root = tmp_path_factory.mktemp("torch-drives")
    srv = build_server([str(root / f"d{i}") for i in range(4)], S3_ACCESS,
                       S3_SECRET, device="cpu").start()
    yield srv.url
    srv.close()


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _script(bucket):
    """(name, method, path, headers, body) steps; each sees the server
    state the earlier steps left."""
    objs = {"small.txt": _payload(1 << 10, 1), "mid.bin": _payload(300 << 10, 2),
            "big": _payload((1 << 20) + 12345, 3)}
    steps = [("create", "PUT", f"/{bucket}", {}, b""),
             ("create-again", "PUT", f"/{bucket}", {}, b""),
             ("head-bucket", "HEAD", f"/{bucket}", {}, b""),
             ("head-missing-bucket", "HEAD", f"/{bucket}-none", {}, b""),
             ("get-missing-bucket", "GET", f"/{bucket}-none/k", {}, b"")]
    for key, data in objs.items():
        steps += [(f"put-{key}", "PUT", f"/{bucket}/{key}",
                   {"Content-Type": "application/x-test"} if key == "big" else {}, data),
                  (f"get-{key}", "GET", f"/{bucket}/{key}", {}, b""),
                  (f"head-{key}", "HEAD", f"/{bucket}/{key}", {}, b""),
                  (f"range-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=100-1099"}, b""),
                  (f"suffix-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=-50"}, b""),
                  (f"open-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": "bytes=1000-"}, b""),
                  (f"badrange-{key}", "GET", f"/{bucket}/{key}",
                   {"Range": f"bytes={len(data)}-"}, b"")]
    steps += [("get-missing-key", "GET", f"/{bucket}/nope", {}, b""),
              ("head-missing-key", "HEAD", f"/{bucket}/nope", {}, b""),
              ("delete", "DELETE", f"/{bucket}/small.txt", {}, b""),
              ("get-deleted", "GET", f"/{bucket}/small.txt", {}, b"")]
    return steps


def _error_fields(body):
    root = ET.fromstring(body)
    return {c.tag: c.text for c in root if c.tag not in ("RequestId", "HostId")}


def _view(r):
    h = {k: r.headers.get(k) for k in ("ETag", "Content-Length", "Content-Range",
                                       "Content-Type", "Location")}
    body = r.content
    if r.status_code >= 300 and body:
        body = _error_fields(body)
    return r.status_code, h, body


def test_same_responses_as_jax_server(server, torch_server):
    bucket = f"cmp-{uuid.uuid4().hex[:12]}"
    jc = SigV4Client(server, S3_ACCESS, S3_SECRET)
    tc = SigV4Client(torch_server, S3_ACCESS, S3_SECRET)
    for name, method, path, headers, body in _script(bucket):
        want = _view(jc.request(method, path, headers=headers, data=body))
        got = _view(tc.request(method, path, headers=headers, data=body))
        assert got == want, name


def test_bad_signature_matches_jax(server, torch_server):
    for url in (server, torch_server):
        r = SigV4Client(url, S3_ACCESS, "wrong-secret").get("/any/key")
        assert r.status_code == 403
        assert _error_fields(r.content)["Code"] == "SignatureDoesNotMatch"


def test_port_signer_is_accepted(torch_server):
    """chip_smoke.py's client path: http.client + the port's own signer,
    with an unsigned payload."""
    import http.client
    import urllib.parse

    from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, Credentials, sign_request

    host = urllib.parse.urlparse(torch_server).netloc
    creds = Credentials(S3_ACCESS, S3_SECRET)
    bucket = f"signer-{uuid.uuid4().hex[:8]}"
    data = _payload(70000, 4)
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        for method, path, body in (("PUT", f"/{bucket}", b""),
                                   ("PUT", f"/{bucket}/o", data),
                                   ("GET", f"/{bucket}/o", b"")):
            conn.request(method, urllib.parse.quote(path), body=body,
                         headers=sign_request(method, path, {}, {}, host, creds,
                                              UNSIGNED_PAYLOAD))
            r = conn.getresponse()
            got = r.read()
            assert r.status == 200, got
        assert got == data
    finally:
        conn.close()


def test_refused_request_keeps_its_connection(torch_server):
    """A request refused before its body is read (NotImplemented for an
    unserved subresource, InvalidArgument for a versionId on a write) gets
    its answer, and the same connection then serves the next request: the
    server reads a short unread body off instead of closing on it."""
    import http.client
    import urllib.parse

    from minio_tpu_torch.s3.sigv4 import UNSIGNED_PAYLOAD, Credentials, sign_request

    host = urllib.parse.urlparse(torch_server).netloc
    creds = Credentials(S3_ACCESS, S3_SECRET)
    bucket = f"drain-{uuid.uuid4().hex[:8]}"
    data = _payload(512 << 10, 5)
    conn = http.client.HTTPConnection(host, timeout=30)
    try:
        for method, path, query, body, status in (
                ("PUT", f"/{bucket}", {}, b"", 200),
                ("PUT", f"/{bucket}/o", {"versionId": "v1"}, data, 400),
                ("PUT", f"/{bucket}/o", {"acl": ""}, data, 501),
                ("PUT", f"/{bucket}/o", {}, data, 200),
                ("GET", f"/{bucket}/o", {}, b"", 200)):
            url = urllib.parse.quote(path)
            if query:
                url += "?" + urllib.parse.urlencode(query)
            conn.request(method, url, body=body,
                         headers=sign_request(method, path, query, {}, host, creds,
                                              UNSIGNED_PAYLOAD))
            r = conn.getresponse()
            got = r.read()
            assert r.status == status, got
            assert not r.will_close
        assert got == data
    finally:
        conn.close()


def test_payload_hash_mismatch_matches_jax(server, torch_server):
    """A body that does not hash to its signed x-amz-content-sha256 is
    refused by both servers before anything commits."""
    import hashlib
    import http.client
    import urllib.parse

    from minio_tpu_torch.s3.sigv4 import Credentials, sign_request

    creds = Credentials(S3_ACCESS, S3_SECRET)
    bucket = f"sha-{uuid.uuid4().hex[:8]}"
    views = []
    for url in (server, torch_server):
        host = urllib.parse.urlparse(url).netloc
        conn = http.client.HTTPConnection(host, timeout=30)
        try:
            out = []
            for path, body, signed_body in ((f"/{bucket}", b"", b""),
                                            (f"/{bucket}/o", b"payload", b"other"),
                                            (f"/{bucket}/o", b"", b"")):
                method = "GET" if body == b"" and path.endswith("/o") else "PUT"
                conn.request(method, path, body=body, headers=sign_request(
                    method, path, {}, {}, host, creds,
                    hashlib.sha256(signed_body).hexdigest()))
                r = conn.getresponse()
                data = r.read()
                out.append((r.status, _error_fields(data) if r.status >= 300 else b""))
            views.append(out)
        finally:
            conn.close()
    assert views[0] == views[1]
    assert views[1][1][0] == 400
    assert views[1][1][1]["Code"] == "XAmzContentSHA256Mismatch"
    assert views[1][2][0] == 404


_MASKED = {"UploadId", "LastModified", "Initiated", "CreationDate"}


def _xml_fields(body):
    """An XML document as nested (tag, text, children), with the namespace
    kept and the upload id and the times masked (they differ per server)."""
    def walk(e):
        tag = e.tag.rsplit("}", 1)[-1]
        text = "<masked>" if tag in _MASKED else (e.text or "").strip()
        return (e.tag, text, [walk(c) for c in e])
    return walk(ET.fromstring(body))


def _mp_view(r):
    status, h, body = _view(r)
    if status < 300 and body and h.get("Content-Type") == "application/xml":
        body = _xml_fields(body)
    return status, h, body


def _upload_id(r):
    return ET.fromstring(r.content).find(
        "{http://s3.amazonaws.com/doc/2006-03-01/}UploadId").text


def _complete_doc(parts):
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def _multipart_script(cl, bucket):
    """The multipart calls in one order, each answer viewed as in _view
    (XML bodies parsed, upload ids and times masked)."""
    import hashlib

    big, small, tail = _payload(5 << 20, 11), _payload(1 << 20, 12), _payload(4321, 13)
    md5 = {k: hashlib.md5(v).hexdigest() for k, v in
           (("big", big), ("small", small), ("tail", tail))}
    out = []

    def step(name, method, path, query=None, body=b"", headers=None):
        r = cl.request(method, path, query=query, headers=headers, data=body)
        out.append((name, _mp_view(r)))
        return r

    key = f"/{bucket}/dir/obj.bin"
    step("create", "PUT", f"/{bucket}")
    uid = _upload_id(step("initiate", "POST", key, {"uploads": ""},
                          headers={"Content-Type": "application/x-test"}))
    step("part-1", "PUT", key, {"partNumber": "1", "uploadId": uid}, big)
    step("part-2", "PUT", key, {"partNumber": "2", "uploadId": uid}, tail)
    step("list-parts", "GET", key, {"uploadId": uid})
    step("list-parts-marker", "GET", key, {"uploadId": uid, "part-number-marker": "1"})
    step("list-uploads", "GET", f"/{bucket}", {"uploads": ""})
    step("list-uploads-prefix", "GET", f"/{bucket}", {"uploads": "", "prefix": "zz"})
    step("complete-wrong-etag", "POST", key, {"uploadId": uid},
         _complete_doc([(1, md5["tail"]), (2, md5["tail"])]))
    step("complete-unsorted", "POST", key, {"uploadId": uid},
         _complete_doc([(2, md5["tail"]), (1, md5["big"])]))
    step("complete-malformed", "POST", key, {"uploadId": uid}, b"<Complete")
    step("complete-empty", "POST", key, {"uploadId": uid},
         b"<CompleteMultipartUpload></CompleteMultipartUpload>")
    step("complete", "POST", key, {"uploadId": uid},
         _complete_doc([(1, md5["big"]), (2, md5["tail"])]))
    step("get", "GET", key)
    step("head", "HEAD", key)
    step("range-across-parts", "GET", key,
         headers={"Range": f"bytes={(5 << 20) - 10}-{(5 << 20) + 9}"})
    step("list-completed", "GET", key, {"uploadId": uid})
    small_key = f"/{bucket}/small"
    uid2 = _upload_id(step("initiate-small", "POST", small_key, {"uploads": ""}))
    step("small-1", "PUT", small_key, {"partNumber": "1", "uploadId": uid2}, small)
    step("small-2", "PUT", small_key, {"partNumber": "2", "uploadId": uid2}, tail)
    step("complete-too-small", "POST", small_key, {"uploadId": uid2},
         _complete_doc([(1, md5["small"]), (2, md5["tail"])]))
    step("abort", "DELETE", small_key, {"uploadId": uid2})
    step("list-aborted", "GET", small_key, {"uploadId": uid2})
    step("part-unknown-upload", "PUT", small_key,
         {"partNumber": "1", "uploadId": "nope"}, tail)
    step("abort-unknown", "DELETE", small_key, {"uploadId": "nope"})
    step("initiate-no-bucket", "POST", f"/{bucket}-none/k", {"uploads": ""})
    return out


def test_multipart_responses_match_jax(server, torch_server):
    bucket = f"mpu-{uuid.uuid4().hex[:12]}"
    want = _multipart_script(SigV4Client(server, S3_ACCESS, S3_SECRET), bucket)
    got = _multipart_script(SigV4Client(torch_server, S3_ACCESS, S3_SECRET), bucket)
    for (name, w), (_, g) in zip(want, got):
        assert g == w, name
    codes = {name: v[0] for name, v in got}
    assert codes["complete"] == 200 and codes["abort"] == 204
    assert got[[n for n, _ in got].index("complete-too-small")][1][2]["Code"] == \
        "EntityTooSmall"
    for name in ("complete-wrong-etag", "complete-unsorted"):
        assert dict(got)[name][2]["Code"] == "InvalidPart"
    for name in ("list-aborted", "part-unknown-upload", "abort-unknown"):
        assert dict(got)[name][2]["Code"] == "NoSuchUpload"


LIST_KEYS = ["a", "a.txt", "a/b", "a/c", "a-1", "b/x/y", "b.z", "docs/r1",
             "docs/r2/x", "docs/r2.y", "e\u00e9/k", "z"]


def _delete_doc(keys, quiet=False):
    return ("<Delete>" + ("<Quiet>true</Quiet>" if quiet else "") + "".join(
        f"<Object><Key>{k}</Key></Object>" for k in keys) + "</Delete>").encode()


def _list_buckets_view(r, names):
    """ListBuckets answer, kept to the buckets of one script (the servers
    hold other tests' buckets too)."""
    status, h, body = _view(r)
    root = ET.fromstring(body)
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    for bs in root.iter(ns + "Buckets"):
        for b in list(bs):
            if b.find(ns + "Name").text not in names:
                bs.remove(b)
    h = {k: v for k, v in h.items() if k != "Content-Length"}
    return status, h, _xml_fields(ET.tostring(root))


def _listing_script(cl, bucket):
    """ListObjects v1/v2, ListBuckets, DeleteObjects and DeleteBucket in
    one order, each answer viewed as in _mp_view (times masked)."""
    out = []
    empty = f"{bucket}-empty"

    def step(name, method, path, query=None, body=b""):
        r = cl.request(method, path, query=query, data=body)
        out.append((name, _mp_view(r)))
        return r

    def buckets(name):
        out.append((name, _list_buckets_view(cl.request("GET", "/"),
                                             {bucket, empty})))

    step("create", "PUT", f"/{bucket}")
    step("create-empty", "PUT", f"/{empty}")
    step("v1-empty", "GET", f"/{empty}")
    step("v2-empty", "GET", f"/{empty}", {"list-type": "2"})
    for i, key in enumerate(LIST_KEYS):
        size = 70 << 10 if key == "docs/r1" else 10 + i
        step(f"put-{key}", "PUT", f"/{bucket}/{key}", body=_payload(size, 40 + i))
    for q in ({}, {"max-keys": "3"}, {"marker": "a.txt"}, {"prefix": "docs/"},
              {"delimiter": "/"}, {"delimiter": "/", "max-keys": "2"},
              {"delimiter": "/", "marker": "a/"}, {"prefix": "docs/r2", "delimiter": "/"},
              {"max-keys": "0"}, {"max-keys": "x"}, {"encoding-type": "url"}):
        step(f"v1-{q}", "GET", f"/{bucket}", q)
    for q in ({}, {"max-keys": "4"}, {"continuation-token": "a/c", "max-keys": "4"},
              {"start-after": "b"}, {"start-after": "a", "continuation-token": "docs/"},
              {"delimiter": "/", "max-keys": "3"},
              {"delimiter": "/", "continuation-token": "b/"}, {"prefix": "a", "max-keys": "2"}):
        step(f"v2-{q}", "GET", f"/{bucket}", {"list-type": "2", **q})
    step("v2-missing-bucket", "GET", f"/{bucket}-none", {"list-type": "2"})
    step("v1-missing-bucket", "GET", f"/{bucket}-none")
    buckets("list-buckets")
    step("delete-verbose", "POST", f"/{bucket}", {"delete": ""},
         _delete_doc(["a", "a/b", "nope", "docs/r1"]))
    step("delete-quiet", "POST", f"/{bucket}", {"delete": ""},
         _delete_doc(["a.txt", "nope2"], quiet=True))
    step("delete-malformed", "POST", f"/{bucket}", {"delete": ""}, b"<Delete")
    step("delete-none", "POST", f"/{bucket}", {"delete": ""}, b"<Delete></Delete>")
    step("v2-after-delete", "GET", f"/{bucket}", {"list-type": "2"})
    step("delete-bucket-missing", "DELETE", f"/{bucket}-none")
    step("delete-bucket-not-empty", "DELETE", f"/{bucket}")
    step("delete-bucket-empty", "DELETE", f"/{empty}")
    buckets("list-buckets-after")
    step("delete-rest", "POST", f"/{bucket}", {"delete": ""}, _delete_doc(LIST_KEYS))
    step("v1-emptied", "GET", f"/{bucket}")
    step("delete-bucket", "DELETE", f"/{bucket}")
    step("head-deleted-bucket", "HEAD", f"/{bucket}")
    return out


def test_listing_and_bucket_responses_match_jax(server, torch_server):
    bucket = f"lst-{uuid.uuid4().hex[:12]}"
    want = _listing_script(SigV4Client(server, S3_ACCESS, S3_SECRET), bucket)
    got = _listing_script(SigV4Client(torch_server, S3_ACCESS, S3_SECRET), bucket)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, w), (_, g) in zip(want, got):
        assert g == w, name
    codes = {name: v[0] for name, v in got}
    assert codes["delete-bucket-empty"] == codes["delete-bucket"] == 204
    full = dict(got)["v1-{}"][2]
    assert [c[2][0][1] for c in full[2] if c[0].endswith("Contents")] == sorted(LIST_KEYS)
    for name, code in (("delete-bucket-missing", "NoSuchBucket"),
                       ("delete-bucket-not-empty", "BucketNotEmpty"),
                       ("delete-malformed", "MalformedXML"),
                       ("v2-missing-bucket", "NoSuchBucket")):
        assert dict(got)[name][2]["Code"] == code, name


def test_set_drive_count_spreads_keys_over_sets(tmp_path):
    """build_server(set_drive_count=4) over 8 drives serves two sets behind
    one pool; multipart uploads and plain PUTs land on the hashed set."""
    from minio_tpu_torch.s3.server import build_server

    srv = build_server([str(tmp_path / f"d{i}") for i in range(8)], S3_ACCESS,
                       S3_SECRET, device="cpu", set_drive_count=4).start()
    try:
        sets = srv.obj.pools[0]
        assert sets.set_count == 2 and [s.n for s in sets.sets] == [4, 4]
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        assert cl.request("PUT", "/spread").status_code == 200
        used = set()
        for i in range(8):
            key = f"k{i}"
            data = _payload(70000 + i, 20 + i)
            uid = _upload_id(cl.request("POST", f"/spread/{key}", {"uploads": ""}))
            r = cl.request("PUT", f"/spread/{key}", {"partNumber": "1", "uploadId": uid},
                           data=data)
            r = cl.request("POST", f"/spread/{key}", {"uploadId": uid},
                           data=_complete_doc([(1, r.headers["ETag"].strip('"'))]))
            assert r.status_code == 200, r.content
            assert cl.request("GET", f"/spread/{key}").content == data
            si = sets.sets.index(sets.get_hashed_set(key))
            assert sets.sets[si].get_object_info("spread", key).size == len(data)
            used.add(si)
        assert used == {0, 1}
    finally:
        srv.close()


def test_port_honours_versioning_that_jax_enabled(tmp_path, monkeypatch):
    """The probe that found the port losing data: on 12 drives at EC 8+4,
    the JAX layer PUTs object A as the null version, the JAX package turns
    the bucket's versioning on (its PutBucketVersioning: the bucket
    metadata document) and PUTs a versioned B. Then the port's server
    overwrites the key with C and deletes it without a version id: A and B
    must stay, C must be a version of its own, and a delete marker must
    answer a GET without a version id."""
    import io

    from minio_tpu.bucket.meta import BucketMetadataSys
    from minio_tpu.erasure.pools import ErasureServerPools
    from minio_tpu.erasure.sets import ErasureSets
    from minio_tpu.erasure.types import ObjectOptions
    from minio_tpu.storage.local import LocalDrive
    from minio_tpu_torch.s3.server import build_server

    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    paths = [str(tmp_path / f"d{i:02d}") for i in range(12)]
    jpools = ErasureServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                             set_drive_count=12, parity=4,
                                             bitrot_algorithm="mxsum256")])
    bucket = "probe"
    jpools.make_bucket(bucket)
    a, b, c = _payload(20 << 10, 1), _payload((1 << 20) + 5, 2), _payload(300 << 10, 3)
    jpools.put_object(bucket, "key", io.BytesIO(a), len(a))
    BucketMetadataSys(jpools).update(bucket, versioning_status="Enabled")
    ib = jpools.put_object(bucket, "key", io.BytesIO(b), len(b),
                           ObjectOptions(versioned=True))
    srv = build_server(paths, S3_ACCESS, S3_SECRET, device="cpu").start()
    try:
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        assert cl.put(f"/{bucket}/key", data=c).status_code == 200
        assert cl.delete(f"/{bucket}/key").status_code == 204
    finally:
        srv.close()

    def jget(vid):
        _i, it = jpools.get_object(bucket, "key", opts=ObjectOptions(version_id=vid))
        return b"".join(bytes(x) for x in it)

    assert jget("null") == a
    assert jget(ib.version_id) == b
    with pytest.raises(Exception) as ei:
        jget("")
    assert type(ei.value).__name__ == "ObjectNotFound"
    res = jpools.list_object_versions(bucket)
    assert [(o.delete_marker, o.size) for o in res.objects] == [
        (True, 0), (False, len(c)), (False, len(b)), (False, len(a))]
    assert jget(res.objects[1].version_id) == c
    jpools.close()


def test_port_sees_versioning_that_jax_enables_while_it_runs(tmp_path, monkeypatch):
    """The probe above with the port's server already serving the bucket:
    it PUTs the null version A before the JAX package turns versioning on
    (the port then holds the bucket's unversioned document), and its next
    PUT and DELETE must still keep A, add C as a version and write a
    marker; after the JAX package suspends versioning, the port's PUT
    replaces the null version only."""
    import io

    from minio_tpu.bucket.meta import BucketMetadataSys
    from minio_tpu.erasure.pools import ErasureServerPools
    from minio_tpu.erasure.sets import ErasureSets
    from minio_tpu.erasure.types import ObjectOptions
    from minio_tpu.storage.local import LocalDrive
    from minio_tpu_torch.bucket import meta as meta_mod
    from minio_tpu_torch.s3.server import build_server

    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    paths = [str(tmp_path / f"d{i:02d}") for i in range(12)]
    jpools = ErasureServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                             set_drive_count=12, parity=4,
                                             bitrot_algorithm="mxsum256")])
    bucket = "live"
    jpools.make_bucket(bucket)
    a, c, d = _payload(20 << 10, 1), _payload(300 << 10, 3), _payload(5000, 4)
    srv = build_server(paths, S3_ACCESS, S3_SECRET, device="cpu").start()
    try:
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        assert cl.put(f"/{bucket}/key", data=a).status_code == 200
        assert cl.get(f"/{bucket}/key").content == a
        # Past the racy-stat window, so the port caches what it read.
        time.sleep(2 * meta_mod.BucketMetadataSys._RACY_STAT_NS / 1e9)
        assert cl.get(f"/{bucket}/key").content == a
        BucketMetadataSys(jpools).update(bucket, versioning_status="Enabled")
        r = cl.put(f"/{bucket}/key", data=c)
        assert r.status_code == 200 and r.headers.get("x-amz-version-id")
        r = cl.delete(f"/{bucket}/key")
        assert r.status_code == 204 and r.headers.get("x-amz-delete-marker") == "true"
        BucketMetadataSys(jpools).update(bucket, versioning_status="Suspended")
        r = cl.put(f"/{bucket}/key", data=d)
        assert r.status_code == 200 and not r.headers.get("x-amz-version-id")
    finally:
        srv.close()

    def jget(vid):
        _i, it = jpools.get_object(bucket, "key", opts=ObjectOptions(version_id=vid))
        return b"".join(bytes(x) for x in it)

    res = jpools.list_object_versions(bucket)
    assert [(o.delete_marker, o.size) for o in res.objects] == [
        (False, len(d)), (True, 0), (False, len(c))]
    assert jget(res.objects[2].version_id) == c
    assert jget("null") == d
    jpools.close()
