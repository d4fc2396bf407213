"""S3 front door of the port: a stdlib threading HTTP server.

The JAX package serves S3 through aiohttp; the machine that runs the port
on the card has no aiohttp, so this server is built on
http.server.ThreadingHTTPServer (one daemon thread per connection). It
answers the operations of this slice with the JAX server's statuses,
headers and error documents:

    PUT /bucket          CreateBucket        HEAD /bucket        HeadBucket
    PUT /bucket/key      PutObject           GET /bucket/key     GetObject (Range)
    HEAD /bucket/key     HeadObject          DELETE /bucket/key  DeleteObject

Every request must carry SigV4 header auth (signed payload or
UNSIGNED-PAYLOAD); anything else answers NotImplemented or AccessDenied.
Multipart, listing, presigned URLs, aws-chunked bodies, IAM and the admin
plane come in later slices (ROADMAP.md).

Run: python -m minio_tpu_torch.s3.server --address 127.0.0.1:9000 <drive dirs>
(credentials from MTPU_ROOT_USER / MTPU_ROOT_PASSWORD, default minioadmin).
"""

from __future__ import annotations

import argparse
import email.utils
import hashlib
import mimetypes
import os
import tempfile
import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from minio_tpu_torch.erasure.format import init_format_erasure
from minio_tpu_torch.erasure.objects import ErasureObjects
from minio_tpu_torch.erasure.types import ObjectOptions
from minio_tpu_torch.s3 import sigv4, xmlutil
from minio_tpu_torch.s3.errors import S3Error, from_exception
from minio_tpu_torch.storage.local import LocalDrive

XML_TYPE = "application/xml"
MAX_OBJECT_SIZE = 5 * (1 << 40)
SPOOL_LIMIT = 32 << 20
_COPY = 1 << 20

_SECURITY_HEADERS = {
    "X-Content-Type-Options": "nosniff",
    "X-XSS-Protection": "1; mode=block",
    "Content-Security-Policy": "block-all-mixed-content",
}


class _Body:
    """The request body: at most `length` bytes of the connection."""

    def __init__(self, rfile, length: int):
        self._rfile = rfile
        self.remaining = length

    def read(self, n: int = -1) -> bytes:
        if n < 0 or n > self.remaining:
            n = self.remaining
        data = self._rfile.read(n) if n else b""
        self.remaining -= len(data)
        return data


class _Response:
    def __init__(self, status: int, headers: dict, body=b"", length: int | None = None):
        self.status = status
        self.headers = headers
        self.body = body                       # bytes, or an iterator of chunks
        self.length = len(body) if length is None else length


class S3Server:
    """The S3 handlers over one object layer, bound to an address."""

    def __init__(self, obj: ErasureObjects, creds: sigv4.Credentials,
                 address: str = "127.0.0.1:0"):
        self.obj = obj
        self.creds = creds
        host, _, port = address.rpartition(":")
        self.httpd = ThreadingHTTPServer((host or "0.0.0.0", int(port)), _Handler)
        self.httpd.daemon_threads = True
        self.httpd.s3 = self
        self._thread: threading.Thread | None = None

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "S3Server":
        """Serve in a background daemon thread."""
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="s3-serve")
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self.httpd.shutdown()
            self._thread.join()
        self.httpd.server_close()

    def _lookup(self, access_key: str):
        return self.creds if access_key == self.creds.access_key else None

    # ------------------------------------------------------------------

    def dispatch(self, method: str, path: str, query_items, headers,
                 body: _Body, request_id: str) -> _Response:
        hdr = {"x-amz-request-id": request_id, **_SECURITY_HEADERS}
        if "X-Amz-Signature" in dict(query_items):
            raise S3Error("NotImplemented", "presigned URLs are not served yet")
        if not headers.get("Authorization", "").startswith(sigv4.ALGORITHM):
            raise S3Error("AccessDenied")
        _, payload_hash = sigv4.verify_header_auth(method, path, query_items,
                                                   headers, self._lookup)
        if payload_hash == sigv4.STREAMING_PAYLOAD:
            raise S3Error("NotImplemented", "aws-chunked bodies are not served yet")
        bucket, _, key = path.lstrip("/").partition("/")
        if not bucket or query_items:
            raise S3Error("NotImplemented")
        if not key:
            if method == "PUT":
                self.obj.make_bucket(bucket)
                return _Response(200, {**hdr, "Location": f"/{bucket}"})
            if method == "HEAD":
                self.obj.get_bucket_info(bucket)
                return _Response(200, hdr)
            raise S3Error("NotImplemented")
        if method == "PUT":
            if headers.get("x-amz-copy-source"):
                raise S3Error("NotImplemented", "CopyObject is not served yet")
            return self._put_object(bucket, key, headers, body, payload_hash, hdr)
        if method == "GET":
            return self._get_object(bucket, key, headers, hdr)
        if method == "HEAD":
            info = self.obj.get_object_info(bucket, key)
            return _Response(200, {**hdr, **_object_headers(info)}, b"", info.size)
        if method == "DELETE":
            self.obj.delete_object(bucket, key)
            return _Response(204, hdr)
        raise S3Error("MethodNotAllowed", resource=path)

    def _put_object(self, bucket, key, headers, body: _Body, payload_hash, hdr):
        if headers.get("Content-Length") is None:
            raise S3Error("MissingContentLength")
        size = body.remaining
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        user_defined = _metadata_headers(headers)
        if "content-type" not in user_defined:
            guessed, _ = mimetypes.guess_type(key)
            user_defined["content-type"] = guessed or "application/octet-stream"
        opts = ObjectOptions(user_defined=user_defined)
        if payload_hash == sigv4.UNSIGNED_PAYLOAD:
            info = self.obj.put_object(bucket, key, body, size, opts)
        else:
            # A signed payload is verified in full before anything commits.
            with tempfile.SpooledTemporaryFile(max_size=SPOOL_LIMIT) as spool:
                sha = hashlib.sha256()
                while chunk := body.read(_COPY):
                    sha.update(chunk)
                    spool.write(chunk)
                if sha.hexdigest() != payload_hash:
                    raise S3Error("XAmzContentSHA256Mismatch")
                spool.seek(0)
                info = self.obj.put_object(bucket, key, spool, size, opts)
        return _Response(200, {**hdr, "ETag": f'"{info.etag}"'})

    def _get_object(self, bucket, key, headers, hdr):
        rng = headers.get("Range")
        info, open_range = self.obj.get_object_reader(bucket, key)
        status, offset, length = 200, 0, info.size
        if rng:
            offset, length = _parse_range(rng, info.size)
            status = 206
        stream = open_range(offset, length)
        out = {**hdr, **_object_headers(info), "Content-Length": str(length)}
        if status == 206:
            out["Content-Range"] = f"bytes {offset}-{offset + length - 1}/{info.size}"
        # Pull the first chunk before the headers go out, so a read that
        # fails (quorum lost) still answers with an error status.
        first = next(stream, None)
        chunks = iter(()) if first is None else _prepend(first, stream)
        return _Response(status, out, chunks, length)


def _prepend(first, rest):
    yield first
    yield from rest


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "minio-tpu"
    sys_version = ""

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def do_GET(self):
        self._handle("GET")

    def do_PUT(self):
        self._handle("PUT")

    def do_HEAD(self):
        self._handle("HEAD")

    def do_DELETE(self):
        self._handle("DELETE")

    def do_POST(self):
        self._handle("POST")

    def _handle(self, method: str) -> None:
        request_id = uuid.uuid4().hex[:16].upper()
        raw_path, _, qs = self.path.partition("?")
        path = urllib.parse.unquote(raw_path)
        query_items = urllib.parse.parse_qsl(qs, keep_blank_values=True)
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = -1
        body = _Body(self.rfile, max(length, 0))
        try:
            if length < 0:
                raise S3Error("InvalidArgument", "malformed Content-Length")
            resp = self.server.s3.dispatch(method, path, query_items, self.headers,
                                           body, request_id)
        except Exception as e:  # noqa: BLE001 - every failure answers as S3 XML
            err = from_exception(e, path)
            doc = xmlutil.error_xml(err.api.code, err.message, path, request_id)
            resp = _Response(err.api.http_status,
                             {"x-amz-request-id": request_id,
                              "Content-Type": XML_TYPE, **_SECURITY_HEADERS}, doc)
        if body.remaining or self.headers.get("Transfer-Encoding"):
            # Unread request body left on the connection: it cannot carry
            # another request.
            self.close_connection = True
        self.send_response(resp.status)
        for k, v in resp.headers.items():
            if k != "Content-Length":
                self.send_header(k, v)
        if resp.status != 204 and (method != "HEAD" or resp.length):
            # No length on a 204, and a HEAD answer states one only where
            # there is one (an object's size, an error document's), as the
            # JAX server does.
            self.send_header("Content-Length", str(resp.length))
        self.end_headers()
        if method == "HEAD":
            return
        if isinstance(resp.body, (bytes, bytearray)):
            self.wfile.write(resp.body)
            return
        try:
            for chunk in resp.body:
                self.wfile.write(chunk)
        except Exception:  # noqa: BLE001 - headers are out: only a cut
            # connection can tell the client the body is incomplete.
            self.close_connection = True
            raise


def _metadata_headers(headers) -> dict:
    """User-controlled object metadata from the request headers."""
    user_defined = {}
    ct = headers.get("Content-Type")
    if ct:
        user_defined["content-type"] = ct
    for hk, hv in headers.items():
        lk = hk.lower()
        if lk.startswith("x-amz-meta-") and "mtpu" not in lk:
            user_defined[lk] = hv
    return user_defined


def _object_headers(info) -> dict:
    h = {
        "ETag": f'"{info.etag}"',
        "Last-Modified": email.utils.formatdate(info.mod_time, usegmt=True),
        "Content-Type": info.content_type or "binary/octet-stream",
        "Accept-Ranges": "bytes",
        "Content-Length": str(info.size),
    }
    for k, v in info.user_defined.items():
        if k.startswith("x-amz-meta-"):
            h[k] = v
    return h


def _parse_range(value: str, size: int) -> tuple[int, int]:
    """(offset, length) of a single `bytes=` range (first of a list)."""
    if not value.startswith("bytes="):
        raise S3Error("InvalidRange")
    spec = value[6:].split(",")[0].strip()
    try:
        if spec.startswith("-"):
            suffix = int(spec[1:])
            if suffix == 0:
                raise S3Error("InvalidRange")
            start, end = max(0, size - suffix), size - 1
        else:
            lo, _, hi = spec.partition("-")
            start = int(lo)
            end = int(hi) if hi else size - 1
    except ValueError:
        raise S3Error("InvalidRange") from None
    if start >= size or end < start:
        raise S3Error("InvalidRange")
    end = min(end, size - 1)
    return start, end - start + 1


def build_server(drive_paths: list[str], access_key: str, secret_key: str,
                 device="cuda", address: str = "127.0.0.1:0",
                 parity: int | None = None) -> S3Server:
    """Format (or read the format of) one drive set and bind its S3 server.
    Call .start() to serve in the background, .close() to stop."""
    drives = [LocalDrive(p) for p in drive_paths]
    init_format_erasure(drives)
    layer = ErasureObjects(drives, parity=parity, device=device)
    return S3Server(layer, sigv4.Credentials(access_key, secret_key), address)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="minio_tpu_torch S3 server")
    ap.add_argument("drives", nargs="+", help="drive directories (one set)")
    ap.add_argument("--address", default="0.0.0.0:9000")
    ap.add_argument("--parity", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch kernels)")
    args = ap.parse_args(argv)
    srv = build_server(args.drives, os.environ.get("MTPU_ROOT_USER", "minioadmin"),
                       os.environ.get("MTPU_ROOT_PASSWORD", "minioadmin"),
                       device=args.device, address=args.address,
                       parity=args.parity)
    print(f"serving S3 on {srv.url} ({len(args.drives)} drives, "
          f"EC {srv.obj.n - srv.obj.parity}+{srv.obj.parity}, {srv.obj.device})",
          flush=True)
    try:
        srv.httpd.serve_forever()
    finally:
        srv.httpd.server_close()


if __name__ == "__main__":
    main()
