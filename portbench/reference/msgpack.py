"""A plain msgpack decoder (standard library only) for the reference.

Arrays decode as tuples, so composite map keys stay hashable; bin as
``bytes``; str as ``str``.  Truncated or trailing input raises
``ValueError``.  Extension types are refused: the program's snapshots
carry none.
"""

from __future__ import annotations

import struct

_U16 = struct.Struct(">H").unpack_from
_U32 = struct.Struct(">I").unpack_from
_U64 = struct.Struct(">Q").unpack_from
_I8 = struct.Struct(">b").unpack_from
_I16 = struct.Struct(">h").unpack_from
_I32 = struct.Struct(">i").unpack_from
_I64 = struct.Struct(">q").unpack_from
_F32 = struct.Struct(">f").unpack_from
_F64 = struct.Struct(">d").unpack_from


def unpack(data) -> object:
    data = bytes(data)
    obj, pos = _read(data, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes")
    return obj


def unpack_prefix(data, pos: int = 0):
    """Decode one object at ``pos``; returns (object, next position)."""
    return _read(bytes(data), pos)


def _need(data: bytes, pos: int, n: int) -> None:
    if pos + n > len(data):
        raise ValueError("truncated msgpack")


def _read(data: bytes, pos: int):
    _need(data, pos, 1)
    b = data[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        _need(data, pos, n)
        return data[pos:pos + n].decode(), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in (0xC4, 0xC5, 0xC6, 0xD9, 0xDA, 0xDB):
        width = {0xC4: 1, 0xC5: 2, 0xC6: 4, 0xD9: 1, 0xDA: 2, 0xDB: 4}[b]
        n, pos = _length(data, pos, width)
        _need(data, pos, n)
        raw = data[pos:pos + n]
        return (raw if b <= 0xC6 else raw.decode()), pos + n
    if b == 0xCA:
        _need(data, pos, 4)
        return _F32(data, pos)[0], pos + 4
    if b == 0xCB:
        _need(data, pos, 8)
        return _F64(data, pos)[0], pos + 8
    if b == 0xCC:
        _need(data, pos, 1)
        return data[pos], pos + 1
    if b == 0xCD:
        _need(data, pos, 2)
        return _U16(data, pos)[0], pos + 2
    if b == 0xCE:
        _need(data, pos, 4)
        return _U32(data, pos)[0], pos + 4
    if b == 0xCF:
        _need(data, pos, 8)
        return _U64(data, pos)[0], pos + 8
    if b == 0xD0:
        _need(data, pos, 1)
        return _I8(data, pos)[0], pos + 1
    if b == 0xD1:
        _need(data, pos, 2)
        return _I16(data, pos)[0], pos + 2
    if b == 0xD2:
        _need(data, pos, 4)
        return _I32(data, pos)[0], pos + 4
    if b == 0xD3:
        _need(data, pos, 8)
        return _I64(data, pos)[0], pos + 8
    if b in (0xDC, 0xDD):
        n, pos = _length(data, pos, 2 if b == 0xDC else 4)
        return _array(data, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _length(data, pos, 2 if b == 0xDE else 4)
        return _map(data, pos, n)
    raise ValueError(f"msgpack type 0x{b:02x} is not decoded here")


def _length(data: bytes, pos: int, width: int):
    _need(data, pos, width)
    if width == 1:
        return data[pos], pos + 1
    if width == 2:
        return _U16(data, pos)[0], pos + 2
    return _U32(data, pos)[0], pos + 4


def _array(data: bytes, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _read(data, pos)
        out.append(v)
    return tuple(out), pos


def _map(data: bytes, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _read(data, pos)
        v, pos = _read(data, pos)
        out[k] = v
    return out, pos
