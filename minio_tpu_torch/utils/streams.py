"""read(n) over an iterator of byte chunks (the port's copy of the
reader of minio_tpu/utils/streams.py): a GET stream as the body of a PUT
(CopyObject, UploadPartCopy) and a tier's stream as the body of a
restore."""

from __future__ import annotations


class IterReader:
    """read(n) over an iterator of byte chunks. Each chunk is copied as it
    arrives: a stream may yield views of buffers its next step reuses."""

    def __init__(self, chunks):
        self._it = iter(chunks)
        self._buf = b""

    def read(self, n: int = -1) -> bytes:
        buf = bytearray(self._buf)
        while n < 0 or len(buf) < n:
            chunk = next(self._it, None)
            if chunk is None:
                break
            buf += chunk
        self._buf = b""
        if 0 <= n < len(buf):
            self._buf = bytes(buf[n:])
            del buf[n:]
        return bytes(buf)
