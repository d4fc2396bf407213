"""A small MessagePack encoder and decoder for the journal format.

The journal (storage/xlmeta.py) is msgpack. The machine that runs the port
on the card has no `msgpack` package, so the port carries this codec for
exactly the subset the journal writes: maps, arrays, str, bin, int, float,
bool and nil. `packb` emits the same bytes as msgpack-python's `packb` with
its defaults (use_bin_type=True, float64 floats, smallest integer width),
so drives written by either package read in the other; `unpackb` decodes
what `packb` here or there produces (arrays come back as lists, str as
str, bin as bytes).
"""

from __future__ import annotations

import struct

_PACK_D = struct.Struct(">d").pack
_UNPACK_D = struct.Struct(">d").unpack_from
_UNPACK_F = struct.Struct(">f").unpack_from


class UnpackError(ValueError):
    """Malformed or unsupported msgpack input."""


class _Truncated(UnpackError):
    """The input ends inside a document (a stream may bring the rest)."""


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    if fix_base is not None and n <= fix_max:
        out.append(fix_base | n)
    elif codes[0] is not None and n <= 0xFF:
        out += bytes((codes[0], n))
    elif n <= 0xFFFF:
        out.append(codes[1])
        out += n.to_bytes(2, "big")
    elif n <= 0xFFFFFFFF:
        out.append(codes[2])
        out += n.to_bytes(4, "big")
    else:
        raise ValueError(f"msgpack length {n} too large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out.append(v & 0xFF)
    elif 0x80 <= v <= 0xFF:
        out += bytes((0xCC, v))
    elif -0x80 <= v < 0:
        out.append(0xD0)
        out += v.to_bytes(1, "big", signed=True)
    elif 0xFF < v <= 0xFFFF:
        out.append(0xCD)
        out += v.to_bytes(2, "big")
    elif -0x8000 <= v < -0x80:
        out.append(0xD1)
        out += v.to_bytes(2, "big", signed=True)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out.append(0xCE)
        out += v.to_bytes(4, "big")
    elif -0x80000000 <= v < -0x8000:
        out.append(0xD2)
        out += v.to_bytes(4, "big", signed=True)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out.append(0xCF)
        out += v.to_bytes(8, "big")
    elif -0x8000000000000000 <= v < -0x80000000:
        out.append(0xD3)
        out += v.to_bytes(8, "big", signed=True)
    else:
        raise OverflowError(f"integer {v} does not fit msgpack")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += _PACK_D(obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = memoryview(obj).cast("B") if isinstance(obj, memoryview) else obj
        _pack_len(out, len(b), None, -1, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj) -> bytes:
    """Serialize `obj` (same bytes as msgpack.packb with its defaults)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def _unpack(buf, pos: int):
    try:
        c = buf[pos]
    except IndexError:
        raise _Truncated("truncated msgpack data") from None
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c <= 0xBF:
        n = c & 0x1F
        return _str(buf, pos, n)
    if 0x90 <= c <= 0x9F:
        return _array(buf, pos, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(buf, pos, c & 0x0F)
    if c == 0xC0:
        return None, pos
    if c == 0xC2:
        return False, pos
    if c == 0xC3:
        return True, pos
    if c in (0xC4, 0xC5, 0xC6):
        w = 1 << (c - 0xC4)
        n = _uint(buf, pos, w)
        pos += w
        end = pos + n
        if end > len(buf):
            raise _Truncated("truncated bin")
        return bytes(buf[pos:end]), end
    if c == 0xCA:
        _need(buf, pos, 4)
        return _UNPACK_F(buf, pos)[0], pos + 4
    if c == 0xCB:
        _need(buf, pos, 8)
        return _UNPACK_D(buf, pos)[0], pos + 8
    if 0xCC <= c <= 0xCF:
        w = 1 << (c - 0xCC)
        return _uint(buf, pos, w), pos + w
    if 0xD0 <= c <= 0xD3:
        w = 1 << (c - 0xD0)
        _need(buf, pos, w)
        return int.from_bytes(buf[pos:pos + w], "big", signed=True), pos + w
    if c in (0xD9, 0xDA, 0xDB):
        w = {0xD9: 1, 0xDA: 2, 0xDB: 4}[c]
        n = _uint(buf, pos, w)
        return _str(buf, pos + w, n)
    if c in (0xDC, 0xDD):
        w = 2 if c == 0xDC else 4
        return _array(buf, pos + w, _uint(buf, pos, w))
    if c in (0xDE, 0xDF):
        w = 2 if c == 0xDE else 4
        return _map(buf, pos + w, _uint(buf, pos, w))
    raise UnpackError(f"unsupported msgpack type byte 0x{c:02x}")


def _need(buf, pos: int, n: int) -> None:
    if pos + n > len(buf):
        raise _Truncated("truncated msgpack data")


def _uint(buf, pos: int, w: int) -> int:
    _need(buf, pos, w)
    return int.from_bytes(buf[pos:pos + w], "big")


def _str(buf, pos: int, n: int):
    end = pos + n
    if end > len(buf):
        raise _Truncated("truncated str")
    try:
        return bytes(buf[pos:end]).decode("utf-8"), end
    except UnicodeDecodeError as e:
        raise UnpackError(f"invalid utf-8 in str: {e}") from e


def _array(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        try:
            out[k] = v
        except TypeError:
            raise UnpackError("unhashable map key") from None
    return out, pos


def unpackb(data):
    """Deserialize one msgpack document; trailing bytes are an error."""
    buf = memoryview(data).cast("B") if not isinstance(data, bytes) else data
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise UnpackError("extra data after msgpack document")
    return obj


class Unpacker:
    """A streaming decoder (msgpack-python's `Unpacker` with `feed`):
    feed() bytes as they arrive, iterate for every document now whole; a
    document cut short stays buffered until the rest is fed."""

    def __init__(self):
        self._buf = b""
        self._pos = 0

    def feed(self, data) -> None:
        self._buf = self._buf[self._pos:] + bytes(data)
        self._pos = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._pos >= len(self._buf):
            raise StopIteration
        try:
            obj, pos = _unpack(self._buf, self._pos)
        except _Truncated:
            raise StopIteration from None
        self._pos = pos
        return obj
