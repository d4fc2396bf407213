"""Data at rest on the S3 path: SSE-C, SSE-S3 and SSE-KMS, and transparent
compression (the JAX server's, minio_tpu/s3/server.py:2000-2343, role of
cmd/encryption-v1.go EncryptRequest / DecryptObjectInfo and
cmd/object-api-utils.go newS2CompressReader).

A PUT's body is compressed (config `compression`, by key extension and
MIME type) or encrypted (request headers, else the bucket's ?encryption
default), never both, and the stored stream is what the erasure layer
encodes: the ETag is the md5 of the stored bytes, as in the JAX server.
Every version keeps its transform in its metadata (crypto/sse.py and
crypto/compress.py keys), so a GET, HEAD or copy undoes it after
whichever path served the stored bytes: the drives, the hot tier or the
data plane's lanes. Encrypted objects are read by DARE chunk: a Range asks
the layer only for the 64 KiB + 16 B chunks it touches, so the layer's
hedged reads and read-ahead start at chunk boundaries. A compressed
object is read from its start for every Range (neither S2 nor zlib can
seek), as in the JAX server.

Multipart uploads are encrypted part by part: every part is its own
[12-byte nonce | DARE stream] under a key derived from the upload's sealed
object key and that nonce; uploads are not compressed.
"""

from __future__ import annotations

import base64
import dataclasses
import hashlib
import os
import threading

from minio_tpu_torch.crypto import compress as czip
from minio_tpu_torch.crypto import sse
from minio_tpu_torch.crypto.kms import KMSError
from minio_tpu_torch.s3.errors import S3Error

MP_CACHE_LIMIT = 2048    # upload sessions whose metadata is kept in memory
MIN_PART_SIZE = 5 << 20  # the S3 minimum of every part but the last

# The metadata keys of a source's transform, which a copy's destination
# never inherits: it stores plain bytes, then applies its own transform.
TRANSFORM_KEYS = (sse.META_ALGO, sse.META_SEALED_KEY, sse.META_NONCE,
                  sse.META_KEY_MD5, sse.META_ACTUAL_SIZE, sse.META_KMS_KEY_ID,
                  czip.META_COMPRESSION, czip.META_ACTUAL_SIZE)


class AtRest:
    """The transforms of one S3Server: its object layer, root credential,
    config (ConfigSys), KMS and bucket metadata."""

    def __init__(self, obj, creds, config, kms, bucket_meta):
        self.obj = obj
        self.creds = creds
        self.config = config
        self.kms = kms
        self.bucket_meta = bucket_meta
        # upload id -> the session's metadata: immutable once created, so
        # UploadPart and ListParts skip a quorum read of it.
        self._mp_meta: dict[str, dict] = {}
        self._mp_mu = threading.Lock()

    # -- keys -------------------------------------------------------------

    def sse_master_key(self) -> bytes:
        """SSE-S3 master key: MTPU_KMS_SECRET_KEY, else derived from the
        root secret, as the JAX server derives it."""
        secret = os.environ.get("MTPU_KMS_SECRET_KEY",
                                "mtpu-sse-s3:" + self.creds.secret_key)
        return hashlib.sha256(secret.encode()).digest()

    def _bucket_default(self, bucket: str) -> str:
        """The bucket's ?encryption default: "SSE-KMS", "SSE-S3" or ""."""
        default = self.bucket_meta.get(bucket).sse_xml
        if b"aws:kms" in default:
            return "SSE-KMS"
        if b"AES256" in default:
            return "SSE-S3"
        return ""

    def sse_setup(self, headers, bucket: str, key: str, user_defined: dict) -> bytes | None:
        """Decide SSE (request headers, else the bucket default), mint the
        object key and seal it into `user_defined`; -> the object key, or
        None when SSE does not apply. Shared by PUT and
        CreateMultipartUpload, so their decisions never diverge."""
        try:
            ssec_key = sse.parse_ssec_headers(headers)
        except sse.SSEError as e:
            raise S3Error("InvalidArgument", str(e)) from None
        sse_hdr = headers.get("x-amz-server-side-encryption", "")
        sse_s3, sse_kms = sse_hdr == "AES256", sse_hdr == "aws:kms"
        kms_key_id = headers.get("x-amz-server-side-encryption-aws-kms-key-id", "")
        if not sse_s3 and not sse_kms and ssec_key is None:
            default = self._bucket_default(bucket)
            sse_kms, sse_s3 = default == "SSE-KMS", default == "SSE-S3"
        if ssec_key is None and not sse_s3 and not sse_kms:
            return None
        aad = f"{bucket}/{key}"
        if sse_kms:
            # Envelope encryption: the KMS mints the data key and only its
            # sealed blob is stored.
            try:
                kid, object_key, sealed = self.kms.generate_data_key(kms_key_id,
                                                                     context=aad)
            except KMSError as e:
                raise S3Error("InvalidRequest", f"KMS: {e}") from None
            user_defined[sse.META_ALGO] = "SSE-KMS"
            user_defined[sse.META_SEALED_KEY] = sealed
            user_defined[sse.META_KMS_KEY_ID] = kid
            return object_key
        object_key = os.urandom(32)
        if ssec_key is not None:
            user_defined[sse.META_ALGO] = "SSE-C"
            user_defined[sse.META_SEALED_KEY] = sse.seal_key(object_key, ssec_key, aad)
            user_defined[sse.META_KEY_MD5] = base64.b64encode(
                hashlib.md5(ssec_key).digest()).decode()
        else:
            user_defined[sse.META_ALGO] = "SSE-S3"
            user_defined[sse.META_SEALED_KEY] = sse.seal_key(
                object_key, self.sse_master_key(), aad)
        return object_key

    def object_key(self, headers, bucket: str, key: str, meta: dict,
                   copy_source: bool = False) -> bytes:
        """Unseal a version's (or an upload's) object key; an SSE-C object
        needs the client's key in the request (the copy-source headers for
        a copy's source). AccessDenied on a wrong key."""
        algo = meta.get(sse.META_ALGO, "")
        aad = f"{bucket}/{key}"
        try:
            if algo == "SSE-C":
                ssec_key = sse.parse_ssec_headers(headers, copy_source=copy_source)
                if ssec_key is None:
                    raise S3Error("InvalidRequest",
                                  "object is SSE-C encrypted: key required")
                return sse.unseal_key(meta[sse.META_SEALED_KEY], ssec_key, aad)
            if algo == "SSE-KMS":
                try:
                    return self.kms.decrypt_data_key(meta[sse.META_SEALED_KEY],
                                                     context=aad)
                except KMSError as e:
                    raise S3Error("AccessDenied", f"KMS: {e}") from None
            return sse.unseal_key(meta[sse.META_SEALED_KEY], self.sse_master_key(), aad)
        except sse.SSEError as e:
            raise S3Error("AccessDenied", str(e)) from None

    # -- PUT --------------------------------------------------------------

    def put_stream(self, headers, bucket: str, key: str, user_defined: dict,
                   reader, size: int):
        """A PUT's (stream, stored size): compressed, encrypted or as
        sent; the transform's keys go into `user_defined`."""
        reader, size = self._maybe_compress(headers, bucket, key, user_defined,
                                            reader, size)
        return self.encrypt_put(headers, bucket, key, user_defined, reader, size)

    def _maybe_compress(self, headers, bucket, key, user_defined, reader, size):
        if self.config.get("compression", "enable") != "on":
            return reader, size
        # SSE and compression do not stack. Unlike the JAX server, the
        # bucket's default counts too: there a compressible key in a
        # bucket with a default answers MissingContentLength (ROADMAP.md
        # Queue 3).
        if (headers.get("x-amz-server-side-encryption")
                or headers.get("x-amz-server-side-encryption-customer-algorithm")
                or self._bucket_default(bucket)):
            return reader, size
        exts = [e for e in self.config.get("compression", "extensions").split(",") if e]
        mimes = [m for m in self.config.get("compression", "mime_types").split(",") if m]
        if not czip.is_compressible(key, user_defined.get("content-type", ""), exts, mimes):
            return reader, size
        if size >= 0:
            user_defined[czip.META_ACTUAL_SIZE] = str(size)
        user_defined[czip.META_COMPRESSION] = czip.SCHEME_S2
        return czip.CompressReader(reader), -1

    def encrypt_put(self, headers, bucket: str, key: str, user_defined: dict,
                    reader, size: int):
        """(stream, stored size) under DARE when SSE applies, else as is."""
        staged: dict = {}
        object_key = self.sse_setup(headers, bucket, key, staged)
        if object_key is None:
            return reader, size
        if size < 0:
            raise S3Error("MissingContentLength", "SSE requires a known content length")
        user_defined.update(staged)
        nonce = os.urandom(sse.NONCE_SIZE)
        user_defined[sse.META_NONCE] = base64.b64encode(nonce).decode()
        user_defined[sse.META_ACTUAL_SIZE] = str(size)
        return sse.EncryptReader(reader, object_key, nonce), sse.encrypted_size(size)

    # -- multipart --------------------------------------------------------

    def remember_upload(self, upload_id: str, meta: dict) -> None:
        with self._mp_mu:
            if len(self._mp_meta) >= MP_CACHE_LIMIT:
                self._mp_meta.clear()
            self._mp_meta[upload_id] = dict(meta)

    def forget_upload(self, upload_id: str) -> None:
        with self._mp_mu:
            self._mp_meta.pop(upload_id, None)

    def upload_meta(self, bucket: str, key: str, upload_id: str) -> dict:
        with self._mp_mu:
            meta = self._mp_meta.get(upload_id)
        if meta is None:
            meta = self.obj.get_multipart_info(bucket, key, upload_id).user_defined
            self.remember_upload(upload_id, meta)
        return meta

    def encrypt_part(self, headers, bucket: str, key: str, upload_id: str,
                     reader, size: int):
        """One part's (stream, stored size): [nonce | DARE] under the
        part's derived key when the upload is encrypted."""
        meta = self.upload_meta(bucket, key, upload_id)
        if sse.META_ALGO not in meta:
            return reader, size
        if size < 0:
            raise S3Error("MissingContentLength", "SSE requires a known content length")
        object_key = self.object_key(headers, bucket, key, meta)
        nonce = os.urandom(sse.NONCE_SIZE)
        part_key = sse.derive_part_key(object_key, nonce)
        return (_PrefixReader(nonce, sse.EncryptReader(reader, part_key, nonce)),
                sse.encrypted_part_size(size))

    def plain_parts(self, bucket: str, key: str, upload_id: str, parts: list) -> list:
        """ListParts' entries with plaintext sizes for an encrypted upload
        (a client resuming by summing sizes lands on the right offset)."""
        if sse.META_ALGO not in self.upload_meta(bucket, key, upload_id):
            return parts
        return [dataclasses.replace(p, size=sse.part_plain_size(p.size),
                                    actual_size=sse.part_plain_size(p.size))
                for p in parts]

    def check_part_sizes(self, bucket: str, key: str, upload_id: str,
                         numbers: list[int]) -> None:
        """EntityTooSmall when a part but the last of an encrypted upload
        holds less than 5 MiB of plaintext (the layer checks stored sizes,
        which the framing inflates)."""
        if sse.META_ALGO not in self.upload_meta(bucket, key, upload_id):
            return
        listed = {p.part_number: p for p in self.obj.list_parts(bucket, key, upload_id,
                                                                0, 10000)}
        for n in numbers[:-1]:
            p = listed.get(n)
            if p is not None and sse.part_plain_size(p.size) < MIN_PART_SIZE:
                raise S3Error("EntityTooSmall")

    # -- GET, HEAD and copies ---------------------------------------------

    @staticmethod
    def visible_size(info) -> int:
        """The client's byte count of a version: info.size is the stored
        size, which SSE inflates and compression shrinks."""
        ud = info.user_defined
        if sse.META_ACTUAL_SIZE in ud:
            return int(ud[sse.META_ACTUAL_SIZE])
        if czip.META_ACTUAL_SIZE in ud:
            return int(ud[czip.META_ACTUAL_SIZE])
        if sse.META_ALGO in ud and info.parts:
            # Multipart SSE: from the fixed framing of each part.
            return sum(sse.part_plain_size(s) for _, s in info.parts)
        return info.size

    def check_key(self, headers, bucket: str, key: str, info) -> None:
        """HEAD of an encrypted version unseals its key, as the JAX server
        does: an SSE-C version answers only to its key."""
        if sse.META_ALGO in info.user_defined:
            self.object_key(headers, bucket, key, info.user_defined)

    def plan_read(self, headers, bucket: str, key: str, info, open_range,
                  offset: int = 0, length: int = -1, copy_source: bool = False):
        """-> (visible size, open), open() the iterator over [offset,
        offset + length) of the version's client bytes (length -1: to its
        end). The key is unsealed and the range checked here, before any
        byte is read; open_range(offset, length) reads the stored bytes."""
        ud = info.user_defined
        if czip.META_COMPRESSION in ud:
            actual = int(ud.get(czip.META_ACTUAL_SIZE, "-1"))
            if length < 0:
                length = (actual - offset) if actual >= 0 else -1
            scheme = ud[czip.META_COMPRESSION]

            def open_compressed():
                stored = open_range(0, -1)
                return _closing(czip.decompress_iter(stored, offset, length, scheme),
                                stored)

            return (actual if actual >= 0 else info.size), open_compressed
        if sse.META_ALGO not in ud:
            if length < 0:
                length = info.size - offset
            return info.size, lambda: open_range(offset, length)
        object_key = self.object_key(headers, bucket, key, ud, copy_source)
        if sse.META_NONCE not in ud and info.parts:
            return self._plan_multipart(bucket, key, info, open_range, object_key,
                                        offset, length)
        nonce = base64.b64decode(ud[sse.META_NONCE]) if sse.META_NONCE in ud else b""
        actual = int(ud.get(sse.META_ACTUAL_SIZE, "0"))
        if length < 0:
            length = actual - offset
        if offset < 0 or length < 0 or offset + length > actual:
            raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")
        if length == 0:
            return actual, lambda: iter(())
        enc_off, enc_len, skip = sse.decrypted_range(offset, length, actual)

        def open_encrypted():
            stored = open_range(enc_off, enc_len)
            dec = sse.DecryptReader(stored, object_key, nonce,
                                    start_chunk=enc_off // sse.ENC_CHUNK,
                                    total_chunks=sse.total_chunks(actual))
            return _trim(dec, skip, length, stored)

        return actual, open_encrypted

    def _plan_multipart(self, bucket, key, info, open_range, object_key, offset, length):
        """An encrypted multipart version: its parts are independent
        [nonce | DARE] streams back to back; only the chunks each part's
        share of the range touches are read and decrypted."""
        plains = [sse.part_plain_size(stored) for _, stored in info.parts]
        actual = sum(plains)
        if length < 0:
            length = actual - offset
        if offset < 0 or length < 0 or offset + length > actual:
            raise S3Error("InvalidRange", resource=f"/{bucket}/{key}")

        def gen():
            pos = enc_pos = 0   # plaintext and stored cursors at a part's start
            for (_, stored), plain in zip(info.parts, plains):
                lo = max(offset - pos, 0)
                hi = min(offset + length - pos, plain)
                if hi > lo:
                    enc_off, enc_len, skip = sse.decrypted_range(lo, hi - lo, plain)
                    if enc_off == 0:
                        # Nonce and data adjacent: one read, the nonce peeled.
                        raw = open_range(enc_pos, sse.NONCE_SIZE + enc_len)
                        estream, nonce = _peel_prefix(raw, sse.NONCE_SIZE)
                    else:
                        nonce = _read_exact(open_range(enc_pos, sse.NONCE_SIZE),
                                            sse.NONCE_SIZE)
                        raw = estream = open_range(enc_pos + sse.NONCE_SIZE + enc_off,
                                                   enc_len)
                    dec = sse.DecryptReader(estream, sse.derive_part_key(object_key, nonce),
                                            nonce, start_chunk=enc_off // sse.ENC_CHUNK,
                                            total_chunks=sse.total_chunks(plain))
                    yield from _trim(dec, skip, hi - lo, raw)
                pos += plain
                enc_pos += stored
                if pos >= offset + length:
                    return

        return actual, gen


def copy_metadata(user_defined: dict) -> dict:
    """A copy source's metadata less its transform's keys. The JAX server
    strips only the SSE keys and keeps a compressed source's, so its copy
    of a compressed object stores plain bytes marked compressed and
    cannot be read (ROADMAP.md Queue 3)."""
    return {k: v for k, v in user_defined.items() if k not in TRANSFORM_KEYS}


def _close(stream) -> None:
    close = getattr(stream, "close", None)
    if close is not None:
        close()


def _closing(it, source):
    """`it`, closing `source` when it ends or is closed."""
    try:
        yield from it
    finally:
        _close(source)


def _trim(it, skip: int, length: int, source):
    """`length` bytes of `it` after its first `skip` (a chunk-aligned
    decrypt overshoots a byte range at both ends); closes `source` when it
    ends or is closed."""
    remaining, drop = length, skip
    try:
        for chunk in it:
            cv = memoryview(chunk)
            if drop:
                if len(cv) <= drop:
                    drop -= len(cv)
                    continue
                cv = cv[drop:]
                drop = 0
            if len(cv) >= remaining:
                yield cv[:remaining]
                return
            remaining -= len(cv)
            yield cv
    finally:
        _close(source)


def _read_exact(stream, n: int) -> bytes:
    buf = bytearray()
    try:
        for piece in stream:
            buf += piece
    finally:
        _close(stream)
    if len(buf) != n:
        raise sse.SSEError(f"part nonce truncated: {len(buf)} of {n} bytes")
    return bytes(buf)


def _peel_prefix(stream, n: int):
    """(the rest of `stream`, its first n bytes)."""
    it = iter(stream)
    acc = bytearray()
    while len(acc) < n:
        piece = next(it, None)
        if piece is None:
            _close(stream)
            raise sse.SSEError(f"stream truncated: {len(acc)} of {n} prefix bytes")
        acc += piece
    prefix, rest = bytes(acc[:n]), bytes(acc[n:])

    def gen():
        if rest:
            yield rest
        yield from it

    return gen(), prefix


class _PrefixReader:
    """File-like serving a fixed prefix, then an inner reader: a part's
    random nonce at the head of its encrypted stream."""

    def __init__(self, prefix: bytes, inner):
        self._prefix = prefix
        self._inner = inner

    def read(self, n: int = -1) -> bytes:
        if self._prefix:
            if n < 0 or n >= len(self._prefix):
                out, self._prefix = self._prefix, b""
                return out + self._inner.read(n - len(out) if n >= 0 else -1)
            out, self._prefix = self._prefix[:n], self._prefix[n:]
            return out
        return self._inner.read(n)
