"""Compression and the host codecs in the port (minio_tpu_torch/crypto/
compress.py, csrc/host_codec.cc, native/plain.py) against the JAX
package, on the CPU.

- the host library's snappy blocks, CRC-32C and Argon2id equal the JAX
  package's C++ library and the plain Python versions (snappy at lengths
  0-4097 and across 64 KiB fragments; Argon2id at 8-256 KiB, 1-4 lanes,
  1-2 passes, and the RFC 9106 test vector); corrupt blocks are refused;
- S2 streams: the port's equal the JAX package's for the same bytes, and
  each package decompresses (whole and ranged) the other's and the JAX
  package's zlib streams; a flipped frame or a cut stream is refused;
- the extension / MIME gate equals the JAX package's;
- over HTTP, both ways: with `compression enable=on` set through config-kv
  (sealed at rest), one package's server writes .log and .json objects
  (the JAX server with its S2 scheme, and with zlib, as a JAX deployment
  without its C++ library writes), an incompressible key and an SSE-S3
  one, and the other package's server answers GET, Range GET and HEAD
  with the writer's bytes and headers;
- CopyObject of a compressed object: the JAX server's copy keeps the
  source's compression keys over the plain bytes it stores, so it cannot
  be read back; the port strips them (ROADMAP.md Queue 3). And a
  compressible key in a bucket with a default SSE: the JAX server answers
  MissingContentLength, the port stores it encrypted;
- the HTTP cases again with `cryptography` hidden (the config is sealed).

Tolerance: exact bytes."""

import io
import json
import os

import numpy as np
import pytest

from minio_tpu.crypto import compress as jczip
from minio_tpu.native import lib as jlib
from minio_tpu_torch.crypto import compress as czip
from minio_tpu_torch.native import lib, plain
from minio_tpu_torch.utils.crc32c import crc32c as crc32c_plain
from tests import torch_atrest as ta
from tests.torch_native import jax_native_library

jax_native_library()
FALLBACK = os.environ.get(ta.FALLBACK_ENV) == "1"
FRAME = 1 << 16


def _text(size: int, seed: int) -> bytes:
    """Log-like bytes: compressible, with some entropy."""
    rng = np.random.default_rng(seed)
    words = [b"GET", b"PUT", b"/bucket/key", b"200", b"503", b"host=a", b"ms=", b"\n"]
    out = bytearray()
    while len(out) < size:
        out += words[int(rng.integers(0, len(words)))] + b" %d " % int(rng.integers(0, 999))
    return bytes(out[:size])


def test_jax_native_library_is_loaded():
    """The comparisons are against the JAX package's C++ library."""
    assert jlib.available() and jlib.snappy_available() and jlib.argon2id_available()


# --- the host codecs -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["text", "random", "runs"])
def test_snappy_equals_jax_at_every_short_length(kind):
    data = {"text": _text(4097, 1), "random": ta.payload(4097, 2),
            "runs": bytes(np.repeat(np.arange(64, dtype=np.uint8), 64))}[kind]
    for n in range(0, len(data) + 1, 7 if kind == "text" else 61):
        block = lib.snappy_compress(data[:n])
        assert block == jlib.snappy_compress(data[:n]), n
        assert lib.snappy_uncompress(block) == data[:n]


@pytest.mark.parametrize("size", [FRAME - 1, FRAME, FRAME + 1, 3 * FRAME + 17, 300_000])
def test_snappy_library_plain_and_jax_agree_across_fragments(size):
    data = _text(size, size)
    block = lib.snappy_compress(data)
    assert block == jlib.snappy_compress(data) == plain.snappy_compress_py(data)
    assert lib.snappy_uncompress(block) == plain.snappy_uncompress_py(block) == data
    assert jlib.snappy_uncompress(block) == data


@pytest.mark.parametrize("bad", [b"", b"\xff\xff\xff\xff\xff\xff", b"\x05\x00ab",
                                 b"\x04\x05\x01", b"\x10\x0cabcd\x0d\x09"])
def test_corrupt_snappy_blocks_are_refused(bad):
    for fn in (lib.snappy_uncompress, plain.snappy_uncompress_py):
        with pytest.raises(ValueError):
            fn(bad)


def test_snappy_length_header_is_bounded():
    block = lib.snappy_compress(bytes(FRAME + 1))
    for fn in (lib.snappy_uncompress, plain.snappy_uncompress_py):
        with pytest.raises(ValueError):
            fn(block, max_len=FRAME)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 256, 4096, 65537])
def test_crc32c_equals_jax_and_the_plain_version(n):
    data = ta.payload(n, n)
    assert lib.crc32c(data) == jlib.crc32c(data) == crc32c_plain(data)


def test_argon2id_rfc9106_vector():
    want = bytes.fromhex("0d640df58d78766c08c037a34a8b53c9"
                         "d01ef0452d75b65eb52520e96b01e659")
    args = dict(t=3, m_kib=32, lanes=4, outlen=32, secret=b"\x03" * 8, ad=b"\x04" * 12)
    assert lib.argon2id(b"\x01" * 32, b"\x02" * 16, **args) == want
    assert plain.argon2id_py(b"\x01" * 32, b"\x02" * 16, **args) == want


@pytest.mark.parametrize("m_kib,lanes,t", [(8, 1, 1), (32, 4, 2), (64, 2, 1), (256, 4, 1),
                                           (256, 1, 2), (100, 3, 1)])
def test_argon2id_equals_jax_and_the_plain_version(m_kib, lanes, t):
    pw, salt = b"root-secret", bytes(range(16))
    got = lib.argon2id(pw, salt, t=t, m_kib=m_kib, lanes=lanes)
    assert got == jlib.argon2id(pw, salt, t=t, m_kib=m_kib, lanes=lanes)
    assert got == plain.argon2id_py(pw, salt, t=t, m_kib=m_kib, lanes=lanes)


def test_argon2id_refuses_bad_parameters():
    for kw in (dict(lanes=0), dict(t=0), dict(outlen=3)):
        with pytest.raises(ValueError):
            lib.argon2id(b"p", b"s" * 16, **{"m_kib": 64, **kw})


# --- S2 and zlib streams --------------------------------------------------------

PAYLOADS = {"empty": b"", "text": _text(5 * FRAME + 123, 3),
            "random": ta.payload(2 * FRAME + 5, 4),
            "mixed": _text(FRAME, 5) + ta.payload(FRAME, 6) + _text(FRAME // 2, 7)}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_s2_stream_equals_jax_and_reads_both_ways(name):
    data = PAYLOADS[name]
    ours = czip.CompressReader(io.BytesIO(data)).read()
    theirs = jczip.CompressReader(io.BytesIO(data), jczip.SCHEME_S2).read()
    assert ours == theirs
    pieces = [ours[i:i + 5000] for i in range(0, len(ours), 5000)]
    for decompress in (czip.decompress_iter, jczip.decompress_iter):
        assert b"".join(decompress(iter(pieces), scheme=czip.SCHEME_S2)) == data


@pytest.mark.parametrize("name", ["text", "mixed"])
@pytest.mark.parametrize("scheme", [czip.SCHEME_S2, czip.SCHEME_ZLIB])
def test_ranged_decompress_equals_jax(name, scheme):
    data = PAYLOADS[name]
    stored = jczip.CompressReader(io.BytesIO(data), scheme).read()
    for off, ln in ((0, 1), (FRAME - 3, 10), (FRAME, FRAME), (7, -1), (len(data) - 1, 1)):
        got = b"".join(czip.decompress_iter(iter([stored]), off, ln, scheme))
        want = b"".join(jczip.decompress_iter(iter([stored]), off, ln, scheme))
        assert got == want == (data[off:] if ln < 0 else data[off:off + ln])


@pytest.mark.parametrize("damage", ["flip", "cut-header", "cut-chunk", "bad-type"])
def test_damaged_s2_streams_are_refused(damage):
    stored = bytearray(czip.CompressReader(io.BytesIO(PAYLOADS["text"])).read())
    if damage == "flip":
        stored[len(stored) // 2] ^= 0x40
    elif damage == "cut-header":
        stored = stored[:len(czip._STREAM_ID) + 2]
    elif damage == "cut-chunk":
        stored = stored[:-3]
    else:
        stored[len(czip._STREAM_ID)] = 0x02
    with pytest.raises(ValueError):
        b"".join(czip.decompress_iter(iter([bytes(stored)]), scheme=czip.SCHEME_S2))


@pytest.mark.parametrize("key,ct", [("a.log", ""), ("a.LOG", "x/y"), ("a.bin", "text/plain"),
                                    ("a.bin", "application/json"), ("a.bin", "image/png"),
                                    ("a", "")])
@pytest.mark.parametrize("exts,mimes", [([".txt", ".log"], ["text/*"]), ([], []),
                                        ([".log"], []), ([], ["application/*"])])
def test_compressible_gate_equals_jax(key, ct, exts, mimes):
    assert czip.is_compressible(key, ct, exts, mimes) == \
        jczip.is_compressible(key, ct, exts, mimes)


# --- objects over HTTP --------------------------------------------------------------

OBJECTS = {"app.log": _text((1 << 20) + 4321, 10), "doc.json": _text(300_000, 11),
           "blob.bin": ta.payload(200_000, 12), "small.log": _text(5000, 13),
           "sse.log": _text(100_000, 14)}
RANGES = [None, "bytes=70000-140000", "bytes=-10", "bytes=0-0"]
COMPARED = ("ETag", "Content-Length", "Content-Range", "Content-Type", "Last-Modified",
            "x-amz-server-side-encryption")


@pytest.fixture
def cenv(tmp_path, monkeypatch):
    monkeypatch.setenv("MTPU_METAPLANE", "0")
    monkeypatch.setenv("MTPU_BATCHED_DATAPLANE", "0")
    return [str(tmp_path / f"d{i}") for i in range(4)]


def _server(pkg, paths):
    return ta.JaxServer(paths) if pkg == "jax" else ta.port_server(paths)


def _write(cl):
    r = cl.put("/minio/admin/v3/config-kv",
               data=json.dumps({"compression": {"enable": "on"}}).encode())
    assert r.status_code == 200, r.text
    assert cl.put("/czip").status_code == 200
    for key, data in OBJECTS.items():
        h = {"x-amz-server-side-encryption": "AES256"} if key == "sse.log" else {}
        r = cl.put(f"/czip/{key}", data=data, headers=h)
        assert r.status_code == 200, r.text


def _answers(cl):
    out = []
    for key in OBJECTS:
        for rng in RANGES:
            r = cl.get(f"/czip/{key}", headers={"Range": rng} if rng else {})
            ok = r.status_code < 300   # an error document carries its request id
            out.append((key, rng, r.status_code, r.content if ok else b"",
                        {k: r.headers.get(k) for k in COMPARED if ok}))
        r = cl.head(f"/czip/{key}")
        out.append((key, "HEAD", r.status_code, b"", {k: r.headers.get(k) for k in COMPARED}))
    return out


def _stored(srv, pkg):
    obj = srv.srv.obj if pkg == "jax" else srv.obj
    return {k: (obj.get_object_info("czip", k).size,
                obj.get_object_info("czip", k).user_defined.get(czip.META_COMPRESSION))
            for k in OBJECTS}


@pytest.mark.parametrize("writer,reader,scheme", [
    ("jax", "torch", czip.SCHEME_S2), ("jax", "torch", czip.SCHEME_ZLIB),
    ("torch", "jax", czip.SCHEME_S2)])
def test_compressed_objects_across_packages_over_http(cenv, monkeypatch, writer, reader,
                                                      scheme):
    if scheme == czip.SCHEME_ZLIB:
        # What a JAX deployment without its C++ library writes.
        monkeypatch.setattr(jczip, "default_scheme", lambda: czip.SCHEME_ZLIB)
    wsrv = _server(writer, cenv)
    try:
        wcl = ta.client(wsrv.url)
        _write(wcl)
        want = _answers(wcl)
        stored = _stored(wsrv, writer)
    finally:
        wsrv.close()
    assert stored["app.log"][1] == scheme and stored["app.log"][0] < len(OBJECTS["app.log"])
    assert stored["blob.bin"][1] is None and stored["sse.log"][1] is None
    rsrv = _server(reader, cenv)
    try:
        got = _answers(ta.client(rsrv.url))
    finally:
        rsrv.close()
    for g, w in zip(got, want):
        assert g == w, (g[:3], g[4], w[:3], w[4])
    assert len(got) == len(want)
    for key, rng, status, body, _h in got:
        if rng is None:
            assert status == 200 and body == OBJECTS[key]


def test_copy_of_a_compressed_object(cenv):
    """The JAX server's CopyObject keeps the source's compression keys on
    the plain bytes it stores: the copy cannot be read back. The port
    strips them, and its copy reads back (and it reads the JAX copy's
    source the same)."""
    data = OBJECTS["app.log"]
    for pkg in ("jax", "torch"):
        paths = [p + pkg for p in cenv]
        srv = _server(pkg, paths)
        try:
            cl = ta.client(srv.url)
            _write(cl)
            r = cl.put("/czip/copy.log", headers={"x-amz-copy-source": "/czip/app.log"})
            assert r.status_code == 200, r.text
            try:
                r = cl.get("/czip/copy.log")
                ok = r.status_code == 200 and r.content == data
            except Exception:  # noqa: BLE001 - the JAX server cuts the body
                ok = False
            assert ok is (pkg == "torch"), pkg
        finally:
            srv.close()


def test_bucket_default_sse_and_compression(cenv):
    """A compressible key in a bucket with a default SSE: the JAX server
    compresses, then refuses to encrypt a stream of unknown length
    (MissingContentLength); the port, where the two never stack, stores it
    encrypted."""
    for pkg in ("jax", "torch"):
        paths = [p + pkg for p in cenv]
        srv = _server(pkg, paths)
        try:
            cl = ta.client(srv.url)
            _write(cl)
            assert cl.put("/czip", query={"encryption": ""},
                          data=ta.BUCKET_DEFAULT["AES256"]).status_code == 200
            r = cl.put("/czip/d.log", data=OBJECTS["small.log"])
            if pkg == "jax":
                assert r.status_code == 411 and b"MissingContentLength" in r.content
            else:
                assert r.status_code == 200, r.text
                r = cl.get("/czip/d.log")
                assert r.content == OBJECTS["small.log"]
                assert r.headers["x-amz-server-side-encryption"] == "AES256"
        finally:
            srv.close()


def test_http_cases_under_the_fallback_provider():
    """The HTTP cases with `cryptography` hidden: the config that turns
    compression on is sealed by the stdlib fallback."""
    if FALLBACK:
        pytest.skip("this is the child run")
    ta.run_under_fallback("tests/test_torch_compress.py", "across_packages or copy_of")
