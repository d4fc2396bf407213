"""NodeServer — one HTTP mux hosting every inter-node RPC plane
(counterpart of minio_tpu/dist/server.py; plain HTTP only: the fabric
over TLS is not ported yet, ROADMAP.md).

Role-equivalent of the dist-erasure routers (cmd/routers.go:26-38): a single
listener serves storage REST, lock REST, peer REST and bootstrap REST under
distinct path roots. Handlers are plain callables registered per
(plane, method); bodies stream both ways.

Wire contract (shared with dist/rpc.py):
  POST /rpc/{plane}/v1/{method}?{urlencoded params}   body = raw bytes
  200  -> result bytes (msgpack for structured results, raw for file data)
  599  -> msgpack {"err": <error class name>, "msg": ...}  (typed error)
  GET  /health -> 200 (the reconnect probe target, cmd/rest/client.go:208)
"""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import BinaryIO, Callable, Iterator

from minio_tpu_torch import obs
from minio_tpu_torch.dist import rpc
from minio_tpu_torch.utils import errors as se

# A handler takes (params, body) and returns response bytes, an iterator of
# chunks (chunked streaming response), or None (empty 200).
Handler = Callable[[dict, BinaryIO], "bytes | Iterator[bytes] | None"]


class _BodyReader:
    """Bounded reader over the request body (Content-Length or chunked)."""

    def __init__(self, rfile: BinaryIO, length: int | None, chunked: bool):
        self._rfile = rfile
        self._remaining = length
        self._chunked = chunked
        self._chunk_left = 0
        self._done = False

    def read(self, n: int = -1) -> bytes:
        if self._chunked:
            return self._read_chunked(n)
        if self._remaining is None:
            return b""
        if n is None or n < 0:
            n = self._remaining
        n = min(n, self._remaining)
        if n <= 0:
            return b""
        data = self._rfile.read(n)
        self._remaining -= len(data)
        return data

    def _read_chunked(self, n: int) -> bytes:
        out = bytearray()
        want = None if n is None or n < 0 else n
        while not self._done and (want is None or len(out) < want):
            if self._chunk_left == 0:
                line = self._rfile.readline(32)
                if not line:
                    self._done = True
                    break
                self._chunk_left = int(line.strip().split(b";")[0], 16)
                if self._chunk_left == 0:
                    self._rfile.readline(32)  # trailing CRLF
                    self._done = True
                    break
            take = self._chunk_left if want is None else min(
                self._chunk_left, want - len(out))
            data = self._rfile.read(take)
            out += data
            self._chunk_left -= len(data)
            if self._chunk_left == 0:
                self._rfile.readline(32)  # CRLF after chunk
        return bytes(out)


class _Listener(ThreadingHTTPServer):
    """The fabric's listener, with a listen backlog for a cluster's fan-out
    (the stdlib default is 5): a burst of new connections from several
    nodes' clients would overflow it, and a dropped SYN is retried after
    1 s, the adaptive deadline's floor, so a busy peer's connect timed out
    and its breaker opened (the JAX NodeServer keeps the default)."""

    request_queue_size = 1024


class NodeServer:
    """Threaded HTTP server with pluggable RPC planes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 secret: str = "", node_name: str = ""):
        """node_name: this node's advertised identity, stamped as `node` on
        trace records emitted while serving an RPC (carried on the
        context, not a process global — two in-process test nodes must
        not share it)."""
        self.secret = secret
        self.node_name = node_name
        self._routes: dict[tuple[str, str], Handler] = {}
        outer = self

        class _Req(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # Metadata-class RPCs are small request/response pairs;
            # without this, Nagle + delayed ACK adds ~40 ms to every
            # round trip on the fabric.
            disable_nagle_algorithm = True
            daemon_threads = True

            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    self.send_response(200)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_error(404)

            def do_POST(self):
                outer._dispatch(self)

        self._server = _Listener((host, port), _Req)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: threading.Thread | None = None

    # -- plane registration --

    def register(self, plane: str, method: str, fn: Handler) -> None:
        self._routes[(plane, method)] = fn

    def register_plane(self, plane: str, table: dict[str, Handler]) -> None:
        for method, fn in table.items():
            self.register(plane, method, fn)

    # -- lifecycle --

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name=f"node-server-{self.port}")
        self._thread.start()

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def endpoint(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- dispatch --

    def _dispatch(self, req: BaseHTTPRequestHandler) -> None:
        parsed = urllib.parse.urlsplit(req.path)
        parts = parsed.path.strip("/").split("/")
        # /rpc/{plane}/v1/{method}
        if len(parts) != 4 or parts[0] != "rpc" or parts[2] != "v1":
            req.send_error(404)
            return
        plane, method = parts[1], parts[3]
        fn = self._routes.get((plane, method))
        if fn is None:
            req.send_error(404, f"no handler {plane}/{method}")
            return

        auth = req.headers.get("Authorization", "")
        if not (auth.startswith("Bearer ")
                and rpc.verify_token(self.secret, auth[7:])):
            req.send_error(403)
            return

        params = dict(urllib.parse.parse_qsl(parsed.query,
                                             keep_blank_values=True))
        chunked = req.headers.get("Transfer-Encoding", "").lower() == "chunked"
        length = req.headers.get("Content-Length")
        body = _BodyReader(req.rfile, int(length) if length else 0, chunked)

        # Restore the caller's trace context before dispatch — and hold
        # it through the RESPONSE write too: streaming handlers are lazy
        # generators whose bodies (and their storage records) execute
        # inside the chunked-write loop. Records the handler emits
        # correlate with the originating S3 request, stamped with THIS
        # node's identity.
        tokens = obs.set_trace_context(
            trace_id=req.headers.get("x-mtpu-trace-id") or None,
            node=self.node_name or None)
        try:
            self._invoke(req, fn, params, body)
        finally:
            obs.reset_trace_context(tokens)

    def _invoke(self, req, fn, params, body):
        try:
            result = fn(params, body)
        except (se.StorageError, se.ObjectError) as e:
            payload = rpc.pack({"err": type(e).__name__, "msg": str(e)})
            req.send_response(rpc.ERR_STATUS)
            req.send_header("Content-Length", str(len(payload)))
            req.end_headers()
            req.wfile.write(payload)
            return
        except Exception as e:  # unexpected → FaultyDisk on the client
            payload = rpc.pack({"err": "FaultyDisk",
                                "msg": f"{type(e).__name__}: {e}"})
            req.send_response(rpc.ERR_STATUS)
            req.send_header("Content-Length", str(len(payload)))
            req.end_headers()
            req.wfile.write(payload)
            return

        if result is None:
            req.send_response(200)
            req.send_header("Content-Length", "0")
            req.end_headers()
        elif isinstance(result, (bytes, bytearray)):
            req.send_response(200)
            req.send_header("Content-Length", str(len(result)))
            req.end_headers()
            req.wfile.write(result)
        else:  # chunked stream
            req.send_response(200)
            req.send_header("Transfer-Encoding", "chunked")
            req.end_headers()
            try:
                for chunk in result:
                    if not chunk:
                        continue
                    req.wfile.write(f"{len(chunk):x}\r\n".encode())
                    req.wfile.write(chunk)
                    req.wfile.write(b"\r\n")
                req.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                pass
