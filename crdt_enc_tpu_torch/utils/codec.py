"""Canonical msgpack encoding, in pure Python.

The port's copy of ``pack`` from ``crdt_enc_tpu/utils/codec.py``: the
same bytes for the same object, so canonical state compares byte for
byte across the two packages.  Every map is emitted with its entries
sorted by their packed key bytes (type-stable ordering), bytes go out
as the bin type, lists and tuples as arrays, and every integer in its
shortest msgpack form.

It is written out here rather than imported from the ``msgpack`` wheel
so the port runs where that wheel is absent.  The JAX package's native
``canon_pack`` fast path and ``unpack`` are not part of this slice.
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
