"""Canonical msgpack encoding and decoding, in pure Python.

The port's copy of ``pack`` and ``unpack`` from
``crdt_enc_tpu/utils/codec.py``.  ``pack`` gives the same bytes for the
same object, so canonical state compares byte for byte across the two
packages: every map is emitted with its entries sorted by their packed
key bytes (type-stable ordering), bytes go out as the bin type, lists and
tuples as arrays, and every integer in its shortest msgpack form.
``unpack`` decodes as ``msgpack.unpackb(data, raw=False,
strict_map_key=False, use_list=False)`` does: arrays come back as tuples
(so composite map keys such as dots stay hashable), bin as ``bytes``, str
as ``str``; truncated or trailing input raises ``ValueError``.

Both are written out here rather than imported from the ``msgpack`` wheel
so the port runs where that wheel is absent.  The JAX package's native
``canon_pack`` fast path is not copied.
"""

from __future__ import annotations

import struct

_pack_u8 = struct.Struct(">B").pack
_pack_u16 = struct.Struct(">H").pack
_pack_u32 = struct.Struct(">I").pack
_pack_u64 = struct.Struct(">Q").pack
_pack_i8 = struct.Struct(">b").pack
_pack_i16 = struct.Struct(">h").pack
_pack_i32 = struct.Struct(">i").pack
_pack_i64 = struct.Struct(">q").pack
_pack_f64 = struct.Struct(">d").pack


def pack(obj) -> bytes:
    """Deterministic msgpack: sorted map keys, bin type for bytes."""
    out: list[bytes] = []
    _pack_into(obj, out)
    return b"".join(out)


def _int(n: int) -> bytes:
    if n >= 0:
        if n < 0x80:
            return _pack_u8(n)
        if n <= 0xFF:
            return b"\xcc" + _pack_u8(n)
        if n <= 0xFFFF:
            return b"\xcd" + _pack_u16(n)
        if n <= 0xFFFFFFFF:
            return b"\xce" + _pack_u32(n)
        if n <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + _pack_u64(n)
        raise OverflowError(f"integer {n} does not fit msgpack's uint64")
    if n >= -32:
        return _pack_i8(n)
    if n >= -0x80:
        return b"\xd0" + _pack_i8(n)
    if n >= -0x8000:
        return b"\xd1" + _pack_i16(n)
    if n >= -0x80000000:
        return b"\xd2" + _pack_i32(n)
    if n >= -0x8000000000000000:
        return b"\xd3" + _pack_i64(n)
    raise OverflowError(f"integer {n} does not fit msgpack's int64")


def _header(n: int, fix: int, fix_max: int, c8, c16: bytes, c32: bytes) -> bytes:
    if n <= fix_max:
        return _pack_u8(fix | n)
    if c8 is not None and n <= 0xFF:
        return c8 + _pack_u8(n)
    if n <= 0xFFFF:
        return c16 + _pack_u16(n)
    if n <= 0xFFFFFFFF:
        return c32 + _pack_u32(n)
    raise ValueError(f"length {n} exceeds msgpack's 32-bit limit")


def _bin(b: bytes) -> bytes:
    n = len(b)
    if n <= 0xFF:
        return b"\xc4" + _pack_u8(n) + b
    if n <= 0xFFFF:
        return b"\xc5" + _pack_u16(n) + b
    if n <= 0xFFFFFFFF:
        return b"\xc6" + _pack_u32(n) + b
    raise ValueError(f"bytes of length {n} exceed msgpack's 32-bit limit")


def _pack_into(obj, out: list) -> None:
    # scalar fast path first: most nodes of a state are ints and bytes
    t = obj.__class__
    if t is bytes:
        out.append(_bin(obj))
    elif t is int:
        out.append(_int(obj))
    elif obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif t is str:
        b = obj.encode("utf-8")
        out.append(_header(len(b), 0xA0, 31, b"\xd9", b"\xda", b"\xdb") + b)
    elif t is float:
        out.append(b"\xcb" + _pack_f64(obj))
    elif isinstance(obj, dict):
        items = []
        for k, v in obj.items():
            kb: list[bytes] = []
            _pack_into(k, kb)
            items.append((b"".join(kb), v))
        # sort by the packed key bytes so ordering is type-stable
        items.sort(key=lambda kv: kv[0])
        out.append(_header(len(items), 0x80, 15, None, b"\xde", b"\xdf"))
        for kb, v in items:
            out.append(kb)
            _pack_into(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 15, None, b"\xdc", b"\xdd"))
        for x in obj:
            _pack_into(x, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        out.append(_bin(bytes(obj)))
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(int(obj)))
    elif isinstance(obj, str):
        _pack_into(str(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + _pack_f64(float(obj)))
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


# ---- unpack -----------------------------------------------------------------

_f32 = struct.Struct(">f").unpack_from
_f64 = struct.Struct(">d").unpack_from
_from_bytes = int.from_bytes


def unpack(data):
    """Decode one msgpack object that fills ``data`` exactly."""
    buf = data if type(data) is bytes else bytes(data)
    try:
        obj, end = _dec(buf, 0)
    except IndexError:
        raise ValueError("msgpack: truncated input") from None
    if end != len(buf):
        raise ValueError(
            f"msgpack: {len(buf) - end} bytes of trailing data after the object"
        )
    return obj


def _take(b: bytes, p: int, n: int):
    """``b[p:p+n]`` and its end, raising on a short buffer."""
    e = p + n
    if e > len(b):
        raise ValueError("msgpack: truncated input")
    return b[p:e], e


def _seq(b: bytes, p: int, n: int):
    out = []
    append = out.append
    for _ in range(n):
        t = b[p]
        if t < 0x80:  # positive fixint, inline
            append(t)
            p += 1
        else:
            x, p = _dec(b, p)
            append(x)
    return tuple(out), p


def _map(b: bytes, p: int, n: int):
    out = {}
    for _ in range(n):
        if b[p] == 0xC4:  # bin 8 key (an actor id), inline
            e = p + 2 + b[p + 1]
            if e > len(b):
                raise ValueError("msgpack: truncated input")
            k = b[p + 2 : e]
            p = e
        else:
            k, p = _dec(b, p)
        t = b[p]
        if t < 0x80:  # positive fixint value, inline
            out[k] = t
            p += 1
        else:
            out[k], p = _dec(b, p)
    return out, p


def _dec(b: bytes, p: int):
    """The object starting at ``b[p]`` and the offset just past it.  The
    forms the canonical packer emits most are tested first."""
    t = b[p]
    p += 1
    if t < 0x80:  # positive fixint
        return t, p
    if t == 0xC4:  # bin 8
        n = b[p]
        return _take(b, p + 1, n)
    if 0x90 <= t < 0xA0:  # fixarray
        return _seq(b, p, t & 0x0F)
    if t < 0x90:  # fixmap
        return _map(b, p, t & 0x0F)
    if t < 0xC0:  # fixstr
        s, e = _take(b, p, t & 0x1F)
        return s.decode("utf-8"), e
    if t >= 0xE0:  # negative fixint
        return t - 0x100, p
    if t <= 0xC3:
        if t == 0xC0:
            return None, p
        if t == 0xC2:
            return False, p
        if t == 0xC3:
            return True, p
        raise ValueError("msgpack: 0xc1 is never used")
    if t <= 0xC6:  # bin 16 / 32
        w = 2 if t == 0xC5 else 4
        n, p = _uint(b, p, w)
        return _take(b, p, n)
    if t <= 0xC9 or 0xD4 <= t <= 0xD8:
        raise ValueError(f"msgpack: ext type 0x{t:02x} is not supported")
    if t == 0xCA:
        _take(b, p, 4)
        return _f32(b, p)[0], p + 4
    if t == 0xCB:
        _take(b, p, 8)
        return _f64(b, p)[0], p + 8
    if t <= 0xCF:  # uint 8 / 16 / 32 / 64
        return _uint(b, p, 1 << (t - 0xCC))
    if t <= 0xD3:  # int 8 / 16 / 32 / 64
        raw, e = _take(b, p, 1 << (t - 0xD0))
        return _from_bytes(raw, "big", signed=True), e
    if t <= 0xDB:  # str 8 / 16 / 32
        n, p = _uint(b, p, 1 << (t - 0xD9))
        s, e = _take(b, p, n)
        return s.decode("utf-8"), e
    if t <= 0xDD:  # array 16 / 32
        n, p = _uint(b, p, 2 if t == 0xDC else 4)
        return _seq(b, p, n)
    n, p = _uint(b, p, 2 if t == 0xDE else 4)  # map 16 / 32
    return _map(b, p, n)


def _uint(b: bytes, p: int, w: int):
    raw, e = _take(b, p, w)
    return _from_bytes(raw, "big"), e
