"""Server-side copies of the port (minio_tpu_torch.s3.server, plain PyTorch
on the CPU) against the JAX package's: CopyObject with the metadata
directives COPY and REPLACE and a versioned source, and UploadPartCopy
with and without x-amz-copy-source-range. One request script goes through
the same SigV4 client to both servers (statuses, headers and documents
equal, times and version ids masked); then a port server copies, on the
JAX package's own drives, what the JAX layer wrote, and the JAX layer
reads the copies back. Tolerance: exact bytes."""

import hashlib
import io
import uuid
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from tests.conftest import S3_ACCESS, S3_SECRET
from tests.s3client import SigV4Client

S3 = "{http://s3.amazonaws.com/doc/2006-03-01/}"
PART = 5 << 20
_HEADERS = ("ETag", "Content-Length", "Content-Type", "x-amz-version-id",
            "x-amz-meta-tier", "x-amz-meta-new", "x-amz-tagging-count")


def _payload(size, seed):
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def torch_server(tmp_path_factory):
    from minio_tpu_torch.s3.server import build_server

    root = tmp_path_factory.mktemp("torch-copy-drives")
    srv = build_server([str(root / f"d{i}") for i in range(4)], S3_ACCESS,
                       S3_SECRET, device="cpu").start()
    yield srv.url
    srv.close()


def _view(r, ids):
    """(status, headers, body): XML parsed with times masked, version ids
    renamed in order of appearance (`ids`, one dict per server)."""
    def vid(v):
        return ids.setdefault(v, f"V{len(ids) + 1}") if v and v != "null" else v

    def walk(e):
        tag = e.tag.rsplit("}", 1)[-1]
        if tag in ("RequestId", "HostId"):
            return None
        text = (e.text or "").strip()
        if tag in ("LastModified", "UploadId"):
            text = "<masked>"
        elif tag == "VersionId":
            text = vid(text)
        return (e.tag, text, [c for c in map(walk, e) if c is not None])

    h = {k: r.headers.get(k) for k in _HEADERS}
    if h["x-amz-version-id"]:
        h["x-amz-version-id"] = vid(h["x-amz-version-id"])
    body = r.content
    if body and (r.status_code >= 300
                 or r.headers.get("Content-Type") == "application/xml"):
        body = walk(ET.fromstring(body))
    return r.status_code, h, body


def _complete_doc(parts):
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>\"{e}\"</ETag></Part>"
        for n, e in parts) + "</CompleteMultipartUpload>").encode()


def _copy_script(cl, bucket):
    """CopyObject and UploadPartCopy in one order: -> [(step, view)]."""
    ids, out = {}, []

    def step(name, method, path, query=None, body=b"", headers=None):
        r = cl.request(method, path, query=query, headers=headers, data=body)
        out.append((name, _view(r, ids)))
        return r

    src = _payload(PART + 100, 1)
    step("create", "PUT", f"/{bucket}")
    step("put-src", "PUT", f"/{bucket}/src.bin", body=src,
         headers={"x-amz-meta-tier": "hot", "Content-Type": "application/x-src",
                  "x-amz-tagging": "k=v"})
    step("copy", "PUT", f"/{bucket}/dst.bin",
         headers={"x-amz-copy-source": f"/{bucket}/src.bin"})
    step("get-copy", "GET", f"/{bucket}/dst.bin")
    step("copy-replace", "PUT", f"/{bucket}/dst2.bin",
         headers={"x-amz-copy-source": f"{bucket}/src.bin",
                  "x-amz-metadata-directive": "REPLACE",
                  "x-amz-meta-new": "yes", "Content-Type": "text/plain"})
    step("head-replace", "HEAD", f"/{bucket}/dst2.bin")
    step("copy-replace-no-type", "PUT", f"/{bucket}/dst3.bin",
         headers={"x-amz-copy-source": f"/{bucket}/src.bin",
                  "x-amz-metadata-directive": "REPLACE"})
    step("head-replace-no-type", "HEAD", f"/{bucket}/dst3.bin")
    step("copy-missing-source", "PUT", f"/{bucket}/dst4.bin",
         headers={"x-amz-copy-source": f"/{bucket}/nope"})
    step("copy-bad-source", "PUT", f"/{bucket}/dst4.bin",
         headers={"x-amz-copy-source": "justabucket"})
    step("copy-inline", "PUT", f"/{bucket}/small-copy",
         headers={"x-amz-copy-source": f"/{bucket}/src.bin"})
    step("enable-versioning", "PUT", f"/{bucket}", {"versioning": ""},
         b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>")
    v1 = step("put-v1", "PUT", f"/{bucket}/ver", body=_payload(70000, 2)
              ).headers["x-amz-version-id"]
    step("put-v2", "PUT", f"/{bucket}/ver", body=b"newest")
    step("copy-version", "PUT", f"/{bucket}/from-v1",
         headers={"x-amz-copy-source": f"/{bucket}/ver?versionId={v1}"})
    step("get-from-v1", "GET", f"/{bucket}/from-v1")
    step("copy-null-version", "PUT", f"/{bucket}/from-null",
         headers={"x-amz-copy-source": f"/{bucket}/src.bin?versionId=null"})
    step("copy-missing-version", "PUT", f"/{bucket}/from-none",
         headers={"x-amz-copy-source": f"/{bucket}/ver?versionId="
                                       "00000000-0000-0000-0000-000000000000"})

    # UploadPartCopy: tests/test_multipart.py:197.
    r = step("initiate", "POST", f"/{bucket}/mp", {"uploads": ""})
    uid = ET.fromstring(r.content).findtext(f"{S3}UploadId")
    r1 = step("part-copy-1", "PUT", f"/{bucket}/mp",
              {"uploadId": uid, "partNumber": "1"},
              headers={"x-amz-copy-source": f"/{bucket}/src.bin"})
    r2 = step("part-copy-2", "PUT", f"/{bucket}/mp",
              {"uploadId": uid, "partNumber": "2"},
              headers={"x-amz-copy-source": f"/{bucket}/src.bin",
                       "x-amz-copy-source-range": "bytes=0-99"})
    r3 = step("part-copy-version", "PUT", f"/{bucket}/mp",
              {"uploadId": uid, "partNumber": "3"},
              headers={"x-amz-copy-source": f"/{bucket}/ver?versionId={v1}",
                       "x-amz-copy-source-range": "bytes=1000-1999"})
    step("part-copy-bad-range", "PUT", f"/{bucket}/mp",
         {"uploadId": uid, "partNumber": "4"},
         headers={"x-amz-copy-source": f"/{bucket}/src.bin",
                  "x-amz-copy-source-range": f"bytes={PART + 100}-"})
    step("part-copy-no-upload", "PUT", f"/{bucket}/mp",
         {"uploadId": "nope", "partNumber": "1"},
         headers={"x-amz-copy-source": f"/{bucket}/src.bin"})
    step("list-parts", "GET", f"/{bucket}/mp", {"uploadId": uid})
    etags = [ET.fromstring(x.content).findtext(f"{S3}ETag").strip('"')
             for x in (r1, r2, r3)]
    step("complete-too-small", "POST", f"/{bucket}/mp", {"uploadId": uid},
         _complete_doc(list(enumerate(etags, 1))))
    # Part 2 (100 bytes) cannot precede another part: complete with 1 and 3.
    step("complete", "POST", f"/{bucket}/mp", {"uploadId": uid},
         _complete_doc([(1, etags[0]), (3, etags[2])]))
    step("get-mp", "GET", f"/{bucket}/mp")
    return out


def test_copy_responses_match_jax(server, torch_server):
    bucket = f"copy-{uuid.uuid4().hex[:12]}"
    want = _copy_script(SigV4Client(server, S3_ACCESS, S3_SECRET), bucket)
    got = _copy_script(SigV4Client(torch_server, S3_ACCESS, S3_SECRET), bucket)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, w), (_, g) in zip(want, got):
        assert g == w, name
    views = dict(got)
    src = _payload(PART + 100, 1)
    assert views["get-copy"][2] == src
    assert views["get-copy"][1]["x-amz-meta-tier"] == "hot"
    assert views["get-copy"][1]["Content-Type"] == "application/x-src"
    assert views["head-replace"][1]["x-amz-meta-tier"] is None
    assert views["head-replace"][1]["x-amz-meta-new"] == "yes"
    assert views["get-from-v1"][2] == _payload(70000, 2)
    assert views["get-mp"][2] == src + _payload(70000, 2)[1000:2000]
    assert views["complete-too-small"][2][2][0][1] == "EntityTooSmall"
    for name, want_md5 in (("part-copy-1", src), ("part-copy-2", src[:100]),
                           ("part-copy-version", _payload(70000, 2)[1000:2000])):
        etag = [c for c in views[name][2][2] if c[0].endswith("ETag")][0][1]
        assert etag == f'"{hashlib.md5(want_md5).hexdigest()}"', name
    assert views["copy-missing-source"][2][2][0][1] == "NoSuchKey"
    assert views["complete"][1]["x-amz-version-id"]


@pytest.mark.parametrize("versioned", [False, True])
def test_port_copies_what_jax_wrote(tmp_path, monkeypatch, versioned):
    """On drives the JAX layer wrote (12 at EC 8+4, mxsum256), the port's
    server copies a noncurrent version with CopyObject and, into a
    multipart upload, ranges of it with UploadPartCopy; the JAX layer reads
    the copies back byte-equal, with the ETags S3 defines (the md5, and
    the md5 of the part md5s with -N)."""
    from minio_tpu.bucket.meta import BucketMetadataSys
    from minio_tpu.erasure.pools import ErasureServerPools
    from minio_tpu.erasure.sets import ErasureSets
    from minio_tpu.erasure.types import ObjectOptions
    from minio_tpu.storage.local import LocalDrive
    from minio_tpu_torch.s3.server import build_server

    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    paths = [str(tmp_path / f"d{i:02d}") for i in range(12)]
    jp = ErasureServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                         set_drive_count=12, parity=4,
                                         bitrot_algorithm="mxsum256")])
    bucket = "copies"
    jp.make_bucket(bucket)
    if versioned:
        BucketMetadataSys(jp).update(bucket, versioning_status="Enabled")
    old, new = _payload(PART + (1 << 20) + 333, 5), _payload(1000, 6)
    i_old = jp.put_object(bucket, "src", io.BytesIO(old), len(old),
                          ObjectOptions(versioned=True,
                                        user_defined={"x-amz-meta-tier": "cold"}))
    jp.put_object(bucket, "src", io.BytesIO(new), len(new),
                  ObjectOptions(versioned=True))
    source = f"/{bucket}/src?versionId={i_old.version_id}"
    srv = build_server(paths, S3_ACCESS, S3_SECRET, device="cpu").start()
    try:
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        r = cl.put(f"/{bucket}/copy", headers={"x-amz-copy-source": source})
        assert r.status_code == 200, r.text
        uid = ET.fromstring(cl.post(f"/{bucket}/mp", query={"uploads": ""}).content
                            ).findtext(f"{S3}UploadId")
        ranges = [(0, PART - 1), (PART, len(old) - 1)]
        etags = []
        for n, (lo, hi) in enumerate(ranges, 1):
            r = cl.put(f"/{bucket}/mp", query={"uploadId": uid, "partNumber": str(n)},
                       headers={"x-amz-copy-source": source,
                                "x-amz-copy-source-range": f"bytes={lo}-{hi}"})
            assert r.status_code == 200, r.text
            etag = ET.fromstring(r.content).findtext(f"{S3}ETag").strip('"')
            assert etag == hashlib.md5(old[lo:hi + 1]).hexdigest()
            etags.append(etag)
        r = cl.post(f"/{bucket}/mp", data=_complete_doc(list(enumerate(etags, 1))),
                    query={"uploadId": uid})
        assert r.status_code == 200, r.text
        assert bool(r.headers.get("x-amz-version-id")) == versioned
    finally:
        srv.close()

    def jget(key):
        info, it = jp.get_object(bucket, key)
        return info, b"".join(bytes(x) for x in it)

    info, data = jget("copy")
    assert data == old and info.etag == hashlib.md5(old).hexdigest()
    assert info.user_defined["x-amz-meta-tier"] == "cold"
    info, data = jget("mp")
    assert data == b"".join(old[lo:hi + 1] for lo, hi in ranges)
    assert info.etag == hashlib.md5(b"".join(bytes.fromhex(e) for e in etags)
                                    ).hexdigest() + "-2"
    assert bool(info.version_id) == versioned
    jp.close()


def _jax_transformed_put(jp, bucket, key, plain, transform):
    """PUT `plain` through the JAX layer as the JAX server stores it under
    SSE-S3 (DARE stream, sealed object key; minio_tpu/s3/server.py
    _sse_setup and _maybe_encrypt_put) or compression (zlib stream;
    _maybe_compress)."""
    import base64

    from minio_tpu.crypto import compress as czip
    from minio_tpu.crypto import sse
    from minio_tpu.erasure.types import ObjectOptions

    rng = np.random.default_rng(7)
    if transform == "sse-s3":
        object_key, nonce = rng.bytes(32), rng.bytes(12)
        master = hashlib.sha256(b"mtpu-sse-s3:" + S3_SECRET.encode()).digest()
        ud = {sse.META_ALGO: "SSE-S3",
              sse.META_SEALED_KEY: sse.seal_key(object_key, master, f"{bucket}/{key}"),
              sse.META_NONCE: base64.b64encode(nonce).decode(),
              sse.META_ACTUAL_SIZE: str(len(plain))}
        reader = sse.EncryptReader(io.BytesIO(plain), object_key, nonce)
        size = sse.encrypted_size(len(plain))
    else:
        ud = {czip.META_COMPRESSION: czip.SCHEME_ZLIB,
              czip.META_ACTUAL_SIZE: str(len(plain))}
        reader, size = czip.CompressReader(io.BytesIO(plain), czip.SCHEME_ZLIB), -1
    return jp.put_object(bucket, key, reader, size, ObjectOptions(user_defined=ud))


@pytest.mark.parametrize("transform", ["sse-s3", "compressed"])
def test_port_refuses_what_it_cannot_decode(tmp_path, monkeypatch, transform):
    """An object the JAX server stored encrypted (SSE-S3) or compressed
    (zlib): the port decrypts or decompresses its stored bytes, so its
    GET, HEAD, CopyObject (COPY and REPLACE) and UploadPartCopy serve the
    object's plain bytes, and the source stays as it was. (Before the
    data-at-rest slice these answered 501 NotImplemented.)"""
    from minio_tpu.erasure.pools import ErasureServerPools
    from minio_tpu.erasure.sets import ErasureSets
    from minio_tpu.storage.local import LocalDrive
    from minio_tpu_torch.s3.server import build_server

    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    monkeypatch.delenv("MTPU_KMS_SECRET_KEY", raising=False)
    paths = [str(tmp_path / f"d{i:02d}") for i in range(12)]
    jp = ErasureServerPools([ErasureSets([LocalDrive(p) for p in paths],
                                         set_drive_count=12, parity=4,
                                         bitrot_algorithm="mxsum256")])
    bucket = "sealed"
    jp.make_bucket(bucket)
    plain = b"compressible " * 20000 + _payload(PART, 8)
    src = _jax_transformed_put(jp, bucket, "src", plain, transform)
    srv = build_server(paths, S3_ACCESS, S3_SECRET, device="cpu").start()
    try:
        cl = SigV4Client(srv.url, S3_ACCESS, S3_SECRET)
        r = cl.get(f"/{bucket}/src")
        assert r.status_code == 200 and r.content == plain
        assert r.headers["ETag"] == f'"{src.etag}"'
        r = cl.head(f"/{bucket}/src")
        assert r.status_code == 200 and r.headers["Content-Length"] == str(len(plain))
        for directive in ("COPY", "REPLACE"):
            r = cl.put(f"/{bucket}/dst-{directive}", headers={
                "x-amz-copy-source": f"/{bucket}/src",
                "x-amz-metadata-directive": directive})
            assert r.status_code == 200, r.text
            assert cl.get(f"/{bucket}/dst-{directive}").content == plain
        uid = ET.fromstring(cl.post(f"/{bucket}/mp", query={"uploads": ""}).content
                            ).findtext(f"{S3}UploadId")
        r = cl.put(f"/{bucket}/mp", query={"uploadId": uid, "partNumber": "1"},
                   headers={"x-amz-copy-source": f"/{bucket}/src",
                            "x-amz-copy-source-range": "bytes=0-99"})
        assert r.status_code == 200, r.text
        r = cl.get(f"/{bucket}/mp", query={"uploadId": uid})
        assert r.status_code == 200 and b"<Size>100</Size>" in r.content
    finally:
        srv.close()
    info = jp.get_object_info(bucket, "src")
    assert (info.etag, info.size, info.mod_time) == (src.etag, src.size, src.mod_time)
    # The copy is plain data: the source's transform keys stayed behind.
    assert not any(k.startswith("x-mtpu-internal")
                   for k in jp.get_object_info(bucket, "dst-COPY").user_defined)
    jp.close()
