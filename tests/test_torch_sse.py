"""Server-side encryption in the port (minio_tpu_torch/crypto/sse.py,
aead.py, s3/atrest.py) against the JAX package, on the CPU.

- DARE: the port's stream equals the JAX package's for the same key and
  nonce at every size around the 64 KiB chunk edges, each package
  decrypts the other's, tampering and truncation fail, ranged decrypts
  read only their chunks, and the part sizes invert at every edge;
- sealed object keys, part keys, the SSE-C header parser and the response
  headers, both ways;
- over HTTP, both ways: one package's server writes single and multipart
  objects under SSE-S3, SSE-C, SSE-KMS (the default key and a named one)
  and the bucket default (?encryption AES256 and aws:kms) on 4 drives,
  then the other package's server over the same drives answers GET,
  Range GETs (across DARE chunks and a part boundary), HEAD, ListParts of
  an upload the writer left open, Complete, CopyObject (SSE-C source to
  SSE-S3) and UploadPartCopy with the writer's bytes and headers;
- reads served by the HBM hot tier and verified on the data plane's lanes
  are decrypted (and decompressed) as the drive path's are;
- with the randomness of both packages pinned to one seeded source (and
  version ids, data dirs and clocks to counters), the port's shard files
  and journals (meta.mp) equal the JAX package's byte for byte;
- every case again in a child interpreter with `cryptography` hidden, so
  both AEAD providers are held to each other.

Tolerance: exact bytes."""

import io
import itertools
import os
import time
import types
import uuid
import xml.etree.ElementTree as ET

import pytest

from minio_tpu.crypto import aead as jaead
from minio_tpu.crypto import sse as jsse
from minio_tpu_torch.crypto import aead, sse
from tests import torch_atrest as ta

FALLBACK = os.environ.get(ta.FALLBACK_ENV) == "1"
C = sse.CHUNK_SIZE
EDGE_SIZES = sorted({max(0, k * C + d) for k in range(4) for d in (-2, -1, 0, 1, 2)})
KEY = bytes(range(100, 132))
NONCE = bytes(range(12))


def test_provider_is_the_jax_packages():
    """Both gates pick the same provider (else neither opens the other's
    data); in the child run, the stdlib fallback."""
    assert aead.HAVE_AESGCM == jaead.HAVE_AESGCM
    assert aead.HAVE_AESGCM is not FALLBACK


# --- DARE --------------------------------------------------------------------

@pytest.mark.parametrize("size", EDGE_SIZES)
def test_dare_stream_equals_jax_and_decrypts_both_ways(size):
    data = ta.payload(size, size)
    ours = sse.EncryptReader(io.BytesIO(data), KEY, NONCE).read()
    theirs = jsse.EncryptReader(io.BytesIO(data), KEY, NONCE).read()
    assert ours == theirs
    assert len(ours) == sse.encrypted_size(size) == jsse.encrypted_size(size)
    pieces = [ours[i:i + 7001] for i in range(0, len(ours), 7001)]
    assert b"".join(sse.DecryptReader(iter(pieces), KEY, NONCE)) == data
    assert b"".join(jsse.DecryptReader(iter(pieces), KEY, NONCE)) == data


def test_dare_reads_in_any_request_sizes():
    data = ta.payload(3 * C + 5, 1)
    r = sse.EncryptReader(io.BytesIO(data), KEY, NONCE)
    out = b""
    for n in itertools.cycle((1, 100, C + 3, 17)):
        piece = r.read(n)
        if not piece:
            break
        out += piece
    assert out == jsse.EncryptReader(io.BytesIO(data), KEY, NONCE).read()


@pytest.mark.parametrize("where", ["first", "middle", "tag", "last"])
def test_dare_tamper_fails(where):
    data = ta.payload(2 * C + 100, 2)
    ct = bytearray(sse.EncryptReader(io.BytesIO(data), KEY, NONCE).read())
    pos = {"first": 0, "middle": C + 50, "tag": sse.ENC_CHUNK - 1, "last": len(ct) - 1}
    ct[pos[where]] ^= 0x01
    with pytest.raises(sse.SSEError):
        b"".join(sse.DecryptReader(iter([bytes(ct)]), KEY, NONCE))


@pytest.mark.parametrize("cut", ["whole-chunk", "partial"])
def test_dare_truncation_fails(cut):
    """Dropping the final chunk leaves a stream whose last chunk was not
    sealed as final; cutting into a chunk fails its tag, whether or not
    the reader knows the chunk count (a ranged read knows it, and the
    caller's length check catches a stream that ends on a chunk edge)."""
    data = ta.payload(3 * C, 3)
    ct = sse.EncryptReader(io.BytesIO(data), KEY, NONCE).read()
    short = ct[:2 * sse.ENC_CHUNK] if cut == "whole-chunk" else ct[:-5]
    for reader in (sse.DecryptReader, jsse.DecryptReader):
        with pytest.raises((sse.SSEError, jsse.SSEError)):
            b"".join(reader(iter([short]), KEY, NONCE))
        if cut == "partial":
            with pytest.raises((sse.SSEError, jsse.SSEError)):
                b"".join(reader(iter([short]), KEY, NONCE, total_chunks=3))


@pytest.mark.parametrize("offset,length", [(0, 1), (C - 1, 2), (C, C), (5, 3 * C),
                                           (2 * C + 7, 93), (3 * C - 1, 1), (0, 3 * C + 100)])
def test_ranged_decrypt_reads_only_its_chunks(offset, length):
    actual = 3 * C + 100
    data = ta.payload(actual, 4)
    ct = jsse.EncryptReader(io.BytesIO(data), KEY, NONCE).read()
    got = sse.decrypted_range(offset, length, actual)
    assert got == jsse.decrypted_range(offset, length, actual)
    enc_off, enc_len, skip = got
    assert enc_off % sse.ENC_CHUNK == 0
    dec = sse.DecryptReader(iter([ct[enc_off:enc_off + enc_len]]), KEY, NONCE,
                            start_chunk=enc_off // sse.ENC_CHUNK,
                            total_chunks=sse.total_chunks(actual))
    assert b"".join(dec)[skip:skip + length] == data[offset:offset + length]


def test_part_sizes_at_every_chunk_edge():
    for plain in EDGE_SIZES + [5 << 20, (5 << 20) + 1]:
        stored = sse.encrypted_part_size(plain)
        assert stored == jsse.encrypted_part_size(plain)
        assert sse.part_plain_size(stored) == plain == jsse.part_plain_size(stored)
        assert sse.total_chunks(plain) == jsse.total_chunks(plain)


def test_keys_seal_both_ways_and_bind_the_object():
    object_key, sealing = os.urandom(32), os.urandom(32)
    for seal, unseal in ((sse.seal_key, jsse.unseal_key), (jsse.seal_key, sse.unseal_key)):
        sealed = seal(object_key, sealing, "b/k")
        assert unseal(sealed, sealing, "b/k") == object_key
        with pytest.raises((sse.SSEError, jsse.SSEError)):
            unseal(sealed, sealing, "b/other")
        with pytest.raises((sse.SSEError, jsse.SSEError)):
            unseal(sealed, os.urandom(32), "b/k")
    assert sse.derive_part_key(object_key, NONCE) == jsse.derive_part_key(object_key, NONCE)


@pytest.mark.parametrize("meta", [{}, {sse.META_ALGO: "SSE-S3"},
                                  {sse.META_ALGO: "SSE-C", sse.META_KEY_MD5: "bWQ1"},
                                  {sse.META_ALGO: "SSE-KMS", sse.META_KMS_KEY_ID: "k2"}])
def test_response_headers_equal_jax(meta):
    assert sse.sse_headers_for(meta) == jsse.sse_headers_for(meta)


@pytest.mark.parametrize("case", ["none", "ok", "copy", "bad-md5", "short-key", "algo",
                                  "no-md5"])
def test_ssec_header_parser_equals_jax(case):
    key = bytes(32)
    h = {"none": {}, "ok": ta.ssec_headers(key),
         "copy": ta.ssec_headers(key, copy_source=True)}.get(case, dict(ta.ssec_headers(key)))
    if case == "bad-md5":
        h["x-amz-server-side-encryption-customer-key-MD5"] = "AAAA"
    elif case == "short-key":
        h = ta.ssec_headers(bytes(16))
    elif case == "algo":
        h["x-amz-server-side-encryption-customer-algorithm"] = "AES128"
    elif case == "no-md5":
        del h["x-amz-server-side-encryption-customer-key-MD5"]
    for copy_source in (False, True):
        try:
            want = jsse.parse_ssec_headers(h, copy_source=copy_source)
        except jsse.SSEError:
            with pytest.raises(sse.SSEError):
                sse.parse_ssec_headers(h, copy_source=copy_source)
        else:
            assert sse.parse_ssec_headers(h, copy_source=copy_source) == want


# --- objects over HTTP, both ways ---------------------------------------------

SINGLE = 200 * 1024 + 7               # 4 DARE chunks, the last short
PART1, PART2 = 5 << 20, 100 * 1024 + 3
RANGES = ["bytes=65530-131100", "bytes=-1000", "bytes=0-0", f"bytes={C}-"]
MP_RANGES = [f"bytes={PART1 - 100}-{PART1 + 99}", f"bytes={PART1 - 1}-", "bytes=70000-70010"]
COMPARED = ("ETag", "Content-Length", "Content-Range", "Content-Type", "Last-Modified",
            "x-amz-server-side-encryption",
            "x-amz-server-side-encryption-aws-kms-key-id",
            "x-amz-server-side-encryption-customer-algorithm",
            "x-amz-server-side-encryption-customer-key-MD5")


@pytest.fixture
def sse_env(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    monkeypatch.setenv("MTPU_KMS_KEY_FILE", ta.write_key_file(tmp_path / "kms-keys"))
    monkeypatch.setenv("MTPU_KMS_DEFAULT_KEY", "k1")
    return [str(tmp_path / f"d{i}") for i in range(4)]


def _server(pkg, paths):
    return ta.JaxServer(paths) if pkg == "jax" else ta.port_server(paths)


def _key_headers(case):
    return ta.SSE_CASES[case] if case == "sse-c" else {}


def _objects():
    """(bucket, key, SSE case or "", payload) of every single-PUT object."""
    out = [("plain", f"s-{case}", case, ta.payload(SINGLE, i))
           for i, case in enumerate(ta.SSE_CASES)]
    out += [("dflt", "s-default", "", ta.payload(SINGLE, 10)),
            ("dkms", "s-default", "", ta.payload(SINGLE, 11)),
            ("plain", "s-empty", "sse-s3", b"")]
    return out


MP_CASES = [("plain", "mp-sse-s3", "sse-s3"), ("plain", "mp-sse-c", "sse-c"),
            ("plain", "mp-sse-kms", "sse-kms"), ("dflt", "mp-default", "")]


def _mp_payload(i):
    return ta.payload(PART1, 20 + i) + ta.payload(PART2, 30 + i)


def _upload(cl, bucket, key, case, parts, complete=True):
    h = ta.SSE_CASES.get(case, {})
    r = cl.post(f"/{bucket}/{key}", query={"uploads": ""}, headers=h)
    assert r.status_code == 200, r.text
    uid = ET.fromstring(r.content).find("{*}UploadId").text
    etags = []
    for n, data in enumerate(parts, 1):
        r = cl.put(f"/{bucket}/{key}", query={"partNumber": str(n), "uploadId": uid},
                   data=data, headers=_key_headers(case))
        assert r.status_code == 200, r.text
        etags.append(r.headers["ETag"])
    if complete:
        _complete(cl, bucket, key, uid, etags)
    return uid, etags


def _complete(cl, bucket, key, uid, etags):
    doc = "<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
        for n, e in enumerate(etags, 1)) + "</CompleteMultipartUpload>"
    r = cl.post(f"/{bucket}/{key}", query={"uploadId": uid}, data=doc.encode())
    assert r.status_code == 200, r.text
    return r


def _write(cl):
    for bucket in ("plain", "dflt", "dkms"):
        assert cl.put(f"/{bucket}").status_code == 200
    assert cl.put("/dflt", query={"encryption": ""},
                  data=ta.BUCKET_DEFAULT["AES256"]).status_code == 200
    assert cl.put("/dkms", query={"encryption": ""},
                  data=ta.BUCKET_DEFAULT["aws:kms"]).status_code == 200
    for bucket, key, case, data in _objects():
        r = cl.put(f"/{bucket}/{key}", data=data, headers=ta.SSE_CASES.get(case, {}))
        assert r.status_code == 200, r.text
    for i, (bucket, key, case) in enumerate(MP_CASES):
        data = _mp_payload(i)
        _upload(cl, bucket, key, case, [data[:PART1], data[PART1:]])
    return _upload(cl, "plain", "mp-open", "sse-kms",
                   [ta.payload(PART1, 40), ta.payload(PART2, 41)], complete=False)


def _answers(cl, uid):
    """Every read of the script: (request, status, body, compared headers)."""
    reqs = []
    for bucket, key, case, _data in _objects():
        for rng in [None] + (RANGES if _data else []):
            reqs.append(("GET", bucket, key, case, rng))
        reqs.append(("HEAD", bucket, key, case, None))
    for bucket, key, case in MP_CASES:
        for rng in [None] + MP_RANGES:
            reqs.append(("GET", bucket, key, case, rng))
        reqs.append(("HEAD", bucket, key, case, None))
    reqs.append(("GET", "plain", "s-sse-c", "", None))          # the key missing
    reqs.append(("HEAD", "plain", "s-sse-c", "", None))
    reqs.append(("GET", "plain", "s-sse-c", "wrong-key", None))
    out = []
    for method, bucket, key, case, rng in reqs:
        h = dict(ta.ssec_headers(bytes(32))) if case == "wrong-key" else dict(_key_headers(case))
        if rng:
            h["Range"] = rng
        r = cl.request(method, f"/{bucket}/{key}", headers=h)
        body = r.content if r.status_code < 300 else b""
        out.append(((method, bucket, key, case, rng), r.status_code, body,
                    {k: r.headers.get(k) for k in COMPARED if r.status_code < 300}))
    r = cl.get("/plain/mp-open", query={"uploadId": uid})
    assert r.status_code == 200, r.text
    parts = [(p.find("{*}PartNumber").text, p.find("{*}ETag").text, p.find("{*}Size").text)
             for p in ET.fromstring(r.content).findall("{*}Part")]
    out.append(("ListParts", parts))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_objects_across_packages_over_http(sse_env, writer, reader):
    paths = sse_env
    wsrv = _server(writer, paths)
    try:
        wcl = ta.client(wsrv.url)
        uid, etags = _write(wcl)
        want = _answers(wcl, uid)
    finally:
        wsrv.close()
    rsrv = _server(reader, paths)
    try:
        rcl = ta.client(rsrv.url)
        got = _answers(rcl, uid)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        for g, w in zip(got, want):
            assert g == w, g[0]
        bodies = {(b, k): d for b, k, _c, d in _objects()}
        bodies.update({(b, k): _mp_payload(i) for i, (b, k, _c) in enumerate(MP_CASES)})
        for (req, status, body, _h) in (g for g in got if g[0] != "ListParts"):
            if req[0] == "GET" and req[4] is None and status == 200:
                assert body == bodies[(req[1], req[2])], req
        assert [int(s) for _n, _e, s in got[-1][1]] == [PART1, PART2]
        # The reader completes the writer's upload, copies and part-copies.
        _complete(rcl, "plain", "mp-open", uid, etags)
        r = rcl.get("/plain/mp-open")
        assert r.content == ta.payload(PART1, 40) + ta.payload(PART2, 41)
        assert r.headers["x-amz-server-side-encryption"] == "aws:kms"
        r = rcl.put("/plain/copy", headers={
            "x-amz-copy-source": "/plain/s-sse-c",
            "x-amz-server-side-encryption": "AES256",
            **ta.ssec_headers(ta.SSEC_KEY, copy_source=True)})
        assert r.status_code == 200, r.text
        r = rcl.get("/plain/copy")
        assert r.content == bodies[("plain", "s-sse-c")]
        assert r.headers["x-amz-server-side-encryption"] == "AES256"
        r = rcl.post("/plain/upc", query={"uploads": ""},
                     headers=ta.SSE_CASES["sse-kms-k2"])
        upc = ET.fromstring(r.content).find("{*}UploadId").text
        copied = []
        for n, (src, rng, extra) in enumerate((
                ("/plain/mp-sse-s3", f"bytes=0-{PART1 - 1}", {}),
                ("/plain/s-sse-c", None, ta.ssec_headers(ta.SSEC_KEY, copy_source=True))), 1):
            h = {"x-amz-copy-source": src, **extra}
            if rng:
                h["x-amz-copy-source-range"] = rng
            r = rcl.put("/plain/upc", query={"partNumber": str(n), "uploadId": upc},
                        headers=h)
            assert r.status_code == 200, r.text
            copied.append(f'"{ET.fromstring(r.content).find("{*}ETag").text.strip(chr(34))}"')
        _complete(rcl, "plain", "upc", upc, copied)
        r = rcl.get("/plain/upc")
        assert r.content == bodies[("plain", "mp-sse-s3")][:PART1] + bodies[("plain", "s-sse-c")]
        assert r.headers["x-amz-server-side-encryption-aws-kms-key-id"] == "k2"
    finally:
        rsrv.close()


def test_sse_needs_a_content_length_and_bucket_encryption_routes(sse_env):
    srv = ta.port_server(sse_env)
    try:
        cl = ta.client(srv.url)
        assert cl.put("/plain").status_code == 200
        r = cl.get("/plain", query={"encryption": ""})
        assert r.status_code == 404
        assert b"ServerSideEncryptionConfigurationNotFoundError" in r.content
        assert cl.put("/plain", query={"encryption": ""}, data=b"<a").status_code == 400
        assert cl.put("/plain", query={"encryption": ""},
                      data=ta.BUCKET_DEFAULT["AES256"]).status_code == 200
        assert cl.get("/plain", query={"encryption": ""}).content == ta.BUCKET_DEFAULT["AES256"]
        assert cl.delete("/plain", query={"encryption": ""}).status_code == 204
        assert cl.get("/plain", query={"encryption": ""}).status_code == 404
        r = cl.put("/plain/k", data=b"x", headers={
            "x-amz-server-side-encryption": "aws:kms",
            "x-amz-server-side-encryption-aws-kms-key-id": "nope"})
        assert r.status_code == 400 and b"InvalidRequest" in r.content
    finally:
        srv.close()


# --- the other read paths: the hot tier and the data plane ---------------------

def test_hot_tier_and_plane_reads_are_decrypted(sse_env, monkeypatch):
    """With the HBM hot tier on (admission at once) and the batched data
    plane at its default (on), encrypted and compressed objects served
    from a resident copy, and small ones verified on the plane's lanes,
    come back as their plaintext, whole and ranged."""
    import json

    import torch

    from minio_tpu_torch import dataplane, hottier
    from minio_tpu_torch.dataplane import ring
    from minio_tpu_torch.erasure.pools import ErasureServerPools
    from minio_tpu_torch.erasure.sets import ErasureSets
    from minio_tpu_torch.s3.server import S3Server
    from minio_tpu_torch.s3.sigv4 import Credentials
    from minio_tpu_torch.storage.local import LocalDrive

    monkeypatch.setenv("MTPU_HOTTIER", "1")
    monkeypatch.setenv("MTPU_HOTTIER_ADMIT_COOLDOWN_S", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "1")
    hottier.reset_global()
    dataplane.reset_global()
    # 64 KiB blocks: 32 KiB chunks, within the lanes' width gate
    # (MTPU_DP_MAX_WIDTH), so GET verify rides the plane.
    sets = ErasureSets([LocalDrive(p) for p in sse_env], block_size=64 << 10,
                       device="cpu")
    srv = S3Server(ErasureServerPools([sets]),
                   Credentials(ta.S3_ACCESS, ta.S3_SECRET)).start()
    try:
        cl = ta.client(srv.url)
        assert cl.put("/hot").status_code == 200
        assert cl.put("/minio/admin/v3/config-kv", data=json.dumps(
            {"compression": {"enable": "on"}}).encode()).status_code == 200
        objects = {"big-s3": (ta.payload((1 << 20) + 999, 70), ta.SSE_CASES["sse-s3"]),
                   "big-c": (ta.payload((1 << 20) + 5, 71), ta.SSE_CASES["sse-c"]),
                   "big.log": (b"log line 12345\n" * 70_000, {}),
                   "small-kms": (ta.payload(90_000, 72), ta.SSE_CASES["sse-kms"])}
        for key, (data, h) in objects.items():
            assert cl.put(f"/hot/{key}", data=data, headers=h).status_code == 200
        tier = hottier.get_tier(torch.device("cpu"))
        for key in ("big-s3", "big-c", "big.log"):
            for _ in range(4):
                cl.get(f"/hot/{key}", headers=_key_headers("sse-c" if key == "big-c" else ""))
                assert tier.drain(30)
                if tier.resident("hot", key):
                    break
            assert tier.resident("hot", key), (key, tier.stats())
        hits = tier.stats()["hits"]
        verify = dataplane.get_plane(torch.device("cpu")).stats()["op_launches"][ring.OP_VERIFY]
        for key, (data, _h) in objects.items():
            kh = _key_headers("sse-c") if key == "big-c" else {}
            r = cl.get(f"/hot/{key}", headers=kh)
            assert r.status_code == 200 and r.content == data, key
            r = cl.get(f"/hot/{key}", headers={**kh, "Range": "bytes=65530-70000"})
            assert r.status_code == 206 and r.content == data[65530:70001], key
        assert tier.stats()["hits"] >= hits + 6
        assert dataplane.get_plane(torch.device("cpu")).stats()["op_launches"][
            ring.OP_VERIFY] > verify
    finally:
        srv.close()
        hottier.reset_global()
        dataplane.reset_global()


# --- pinned randomness: byte-equal files ----------------------------------------

def _pin_modules(monkeypatch, mods_os, mods_secrets, mods_clock, seed=7):
    """One seeded byte source for os.urandom / secrets.token_bytes in the
    given modules, and counters for uuid4 and the clock."""
    import numpy as np

    rng = np.random.default_rng(seed)
    counter = itertools.count(1)
    fake_os = types.SimpleNamespace(**{k: getattr(os, k) for k in dir(os)
                                       if not k.startswith("__")})
    fake_os.urandom = lambda n: rng.bytes(n)
    fake_secrets = types.SimpleNamespace(token_bytes=lambda n: rng.bytes(n))
    fake_uuid = types.SimpleNamespace(**{k: getattr(uuid, k) for k in dir(uuid)
                                         if not k.startswith("__")})
    fake_uuid.uuid4 = lambda: uuid.UUID(int=next(counter))
    fake_time = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                         if not k.startswith("__")})
    fake_time.time = lambda: 1_700_000_000.0
    for m in mods_os:
        monkeypatch.setattr(m, "os", fake_os)
    for m in mods_secrets:
        monkeypatch.setattr(m, "pysecrets", fake_secrets)
    for m in mods_clock:
        monkeypatch.setattr(m, "uuid", fake_uuid)
        monkeypatch.setattr(m, "time", fake_time)


def _bucket_files(paths):
    out = {}
    for i, p in enumerate(paths):
        for dirpath, _dirs, files in os.walk(os.path.join(p, "pin")):
            for f in files:
                full = os.path.join(dirpath, f)
                with open(full, "rb") as fh:
                    out[(i, os.path.relpath(full, p))] = fh.read()
    return out


def _pinned_writes(cl):
    assert cl.put("/pin").status_code == 200
    for i, case in enumerate(("sse-s3", "sse-c", "sse-kms")):
        r = cl.put(f"/pin/{case}", data=ta.payload(SINGLE, 50 + i),
                   headers=ta.SSE_CASES[case])
        assert r.status_code == 200, r.text
    _upload(cl, "pin", "mp", "sse-kms", [ta.payload(PART1, 60), ta.payload(PART2, 61)])


def test_pinned_randomness_gives_byte_equal_files(tmp_path, sse_env, monkeypatch):
    import minio_tpu.crypto.kms as jkms
    import minio_tpu.erasure.multipart as jmp
    import minio_tpu.erasure.objects as jobj
    import minio_tpu.s3.server as jserver
    import minio_tpu.storage.fileinfo as jfi
    import minio_tpu_torch.crypto.kms as tkms
    import minio_tpu_torch.erasure.multipart as tmp
    import minio_tpu_torch.erasure.objects as tobj
    import minio_tpu_torch.s3.atrest as tatrest
    import minio_tpu_torch.storage.fileinfo as tfi

    trees = {}
    for pkg, mods in (("jax", ((jserver, jsse), (jkms,), (jobj, jmp, jfi))),
                      ("torch", ((tatrest, sse), (tkms,), (tobj, tmp, tfi)))):
        paths = [str(tmp_path / pkg / f"d{i}") for i in range(4)]
        with monkeypatch.context() as m:
            _pin_modules(m, *mods)
            srv = _server(pkg, paths)
            try:
                _pinned_writes(ta.client(srv.url))
            finally:
                srv.close()
        trees[pkg] = _bucket_files(paths)
    assert any(k[1].endswith("meta.mp") for k in trees["jax"])
    assert any(k[1].endswith("part.1") for k in trees["jax"])
    assert sorted(trees["torch"]) == sorted(trees["jax"])
    for k in trees["jax"]:
        assert trees["torch"][k] == trees["jax"][k], k


# --- the other AEAD provider ------------------------------------------------------

def test_every_case_under_the_fallback_provider():
    """The cases above in a child interpreter where `cryptography` does
    not import: both packages take the stdlib fallback and still agree."""
    if FALLBACK:
        pytest.skip("this is the child run")
    out = ta.run_under_fallback("tests/test_torch_sse.py", "not fallback_provider")
    assert " failed" not in out
