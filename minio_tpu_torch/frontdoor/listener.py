"""Shared-port listeners for the worker plane (counterpart of
minio_tpu/frontdoor/listener.py).

`SO_REUSEPORT` lets every worker bind the same (host, port); the kernel
hashes each new connection's 4-tuple onto one of the bound sockets, so
accepts spread over the workers with no hand-off. Where the kernel does
not balance, the supervisor's accept-and-pass router (`router.py`) does
it instead; `MTPU_FRONTDOOR_SHARD` picks one.
"""

from __future__ import annotations

import socket


def supports_reuseport() -> bool:
    """Probe, don't guess: the constant existing does not prove setsockopt
    accepts it on this kernel."""
    if not hasattr(socket, "SO_REUSEPORT"):
        return False
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        return True
    except OSError:
        return False
    finally:
        s.close()


def make_listener(host: str, port: int, backlog: int = 1024,
                  reuse_port: bool = True) -> socket.socket:
    """A bound, listening TCP socket for `S3Server.serve_socket`. With
    `reuse_port`, N workers each call this with the same address and the
    kernel balances accepts across them."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if reuse_port:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.bind((host or "0.0.0.0", port))
        s.listen(backlog)
    except BaseException:
        s.close()
        raise
    return s
