"""Accept-and-pass shard router (counterpart of
minio_tpu/frontdoor/router.py), the default shard policy.

The supervisor owns the one TCP listener and passes each accepted
connection (the fd itself, over a Unix control socket with SCM_RIGHTS)
to the workers in turn. A worker hands the fd to its stdlib server
(`S3Server.adopt`: a thread of its own, as for a connection it accepted
itself), so the router touches no payload byte, only connection setup;
with keep-alive clients it is out of the request path.

A worker that dies drops out of the rotation (the send fails and the
connection goes to the next worker); its respawn registers again over
the control socket and rejoins.
"""

from __future__ import annotations

import logging
import os
import socket
import threading
import time

_log = logging.getLogger("minio_tpu_torch.frontdoor")


class AcceptRouter:
    """Supervisor side: one TCP listener, fds passed to the workers."""

    def __init__(self, host: str, port: int, control_path: str):
        self.host = host or "0.0.0.0"
        self.port = port
        self.control_path = control_path
        self._workers: dict[int, socket.socket] = {}  # wid -> unix conn
        self._rr: list[int] = []
        self._rr_pos = 0
        self._mu = threading.Lock()
        self._stop = threading.Event()
        try:
            os.unlink(control_path)
        except FileNotFoundError:
            pass
        self._ctl = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._ctl.bind(control_path)
        self._ctl.listen(64)
        self._lsn = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsn.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsn.bind((self.host, port))
        self._lsn.listen(1024)
        self._threads = [
            threading.Thread(target=self._register_loop, daemon=True,
                             name="mtpu-frontdoor-ctl"),
            threading.Thread(target=self._accept_loop, daemon=True,
                             name="mtpu-frontdoor-accept"),
        ]
        for t in self._threads:
            t.start()

    # -- worker registration -------------------------------------------

    def _register_loop(self) -> None:
        self._ctl.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._ctl.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            try:
                wid = int(conn.recv(16).decode() or "-1")
            except (OSError, ValueError):
                conn.close()
                continue
            # Accepted conns inherit the listener's 0.5 s timeout; fd sends
            # are tiny but must not drop a worker on a scheduling hiccup.
            conn.settimeout(5.0)
            with self._mu:
                old = self._workers.pop(wid, None)
                self._workers[wid] = conn
                self._rr = sorted(self._workers)
            if old is not None:
                old.close()
            _log.info("frontdoor: worker %d joined the router", wid)

    def drop(self, wid: int) -> None:
        """Take a worker out of the rotation (its send failed, or the
        supervisor saw it die); its respawn registers again."""
        with self._mu:
            conn = self._workers.pop(wid, None)
            self._rr = sorted(self._workers)
        if conn is not None:
            conn.close()

    # -- accept + pass --------------------------------------------------

    def _accept_loop(self) -> None:
        self._lsn.settimeout(0.5)
        while not self._stop.is_set():
            try:
                conn, _ = self._lsn.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            self._pass(conn)

    def _pass(self, conn: socket.socket) -> None:
        """Round-robin the accepted fd to a live worker; if every worker
        fails (the pool is mid-respawn) drop the connection: clients
        retry, as with a dead single-process server."""
        for _ in range(max(1, len(self._rr))):
            with self._mu:
                if not self._rr:
                    break
                self._rr_pos = (self._rr_pos + 1) % len(self._rr)
                wid = self._rr[self._rr_pos]
                wconn = self._workers[wid]
            try:
                socket.send_fds(wconn, [b"c"], [conn.fileno()])
                conn.close()
                return
            except OSError:
                self.drop(wid)
        conn.close()

    def workers_connected(self) -> list[int]:
        with self._mu:
            return sorted(self._workers)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(2.0)
        self._lsn.close()
        self._ctl.close()
        with self._mu:
            conns, self._workers, self._rr = \
                list(self._workers.values()), {}, []
        for c in conns:
            c.close()
        try:
            os.unlink(self.control_path)
        except OSError:
            return


class WorkerReceiver:
    """Worker side: take the routed fds and hand each to `adopt(sock)`."""

    def __init__(self, control_path: str, wid: int, adopt, on_eof=None):
        """`on_eof` fires once when the supervisor's end closes (it
        drained, or died): with the router holding the only listener, no
        connection can reach this worker again, so it should drain."""
        self._adopt = adopt
        self._on_eof = on_eof
        self._stop = threading.Event()
        self._conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        # The supervisor's control thread may be mid-accept when a worker
        # starts: retry briefly rather than die into a respawn loop.
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self._conn.connect(control_path)
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        self._conn.sendall(str(wid).encode())
        self._thread = threading.Thread(
            target=self._recv_loop, daemon=True, name="mtpu-frontdoor-recv")
        self._thread.start()

    def _recv_loop(self) -> None:
        self._conn.settimeout(0.5)
        while not self._stop.is_set():
            try:
                _msg, fds, _flags, _addr = socket.recv_fds(self._conn, 16, 4)
            except socket.timeout:
                continue
            except OSError:
                self._notify_eof()
                return
            if not fds:
                self._notify_eof()   # the supervisor's end closed
                return
            for fd in fds:
                sock = socket.socket(fileno=fd)
                sock.setblocking(True)
                try:
                    self._adopt(sock)
                except OSError:
                    sock.close()   # the client left before it was served

    def _notify_eof(self) -> None:
        if self._on_eof is not None and not self._stop.is_set():
            self._on_eof()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._conn.close()
        except OSError:
            pass
        self._thread.join(2.0)
