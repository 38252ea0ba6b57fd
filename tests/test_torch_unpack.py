"""The port's pure-Python ``unpack`` against ``msgpack.unpackb``.

``crdt_enc_tpu_torch.utils.codec.unpack`` must decode exactly as the JAX
package's ``codec.unpack`` does (``msgpack.unpackb(data, raw=False,
strict_map_key=False, use_list=False)``): arrays as tuples, inside map
keys too; bin as bytes; str as str; every int, float, str, bin, array and
map form at each size-class boundary; and truncated or trailing input
raises.  The test imports msgpack; the port never does.
"""

from __future__ import annotations

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch.utils.codec import pack, unpack


def reference(data: bytes):
    return msgpack.unpackb(data, raw=False, strict_map_key=False, use_list=False)


def same(a, b) -> bool:
    """Equal values of equal types, all the way down (1 == True and
    1 == 1.0 in Python, so == alone would not catch a wrong type)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, tuple):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        if len(a) != len(b):
            return False
        bk = {repr(k): k for k in b}
        return all(
            repr(k) in bk and same(k, bk[repr(k)]) and same(v, b[bk[repr(k)]])
            for k, v in a.items()
        )
    if isinstance(a, float) and a != a:
        return b != b
    return a == b


INTS = [
    0, 1, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF, 0x100000000,
    2**64 - 1, -1, -32, -33, -0x80, -0x81, -0x8000, -0x8001, -(2**31),
    -(2**31) - 1, -(2**63),
]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]
BOUNDARY_OBJECTS = (
    [(f"int {n}", n) for n in INTS]
    + [(f"str {n}", "x" * n) for n in LENGTHS]
    + [(f"utf-8 str {n}", "é" * n) for n in (0, 15, 16, 128, 40000)]
    + [(f"bin {n}", b"\x01" * n) for n in LENGTHS]
    + [(f"array {n}", list(range(n))) for n in (0, 15, 16, 65535, 65536)]
    + [(f"map {n}", {i: -i for i in range(n)}) for n in (0, 15, 16, 65535, 65536)]
    + [
        ("nil", None), ("true", True), ("false", False), ("float64", 1.5),
        ("negative zero", -0.0), ("inf", float("inf")),
        ("dot keys", {(b"\x00" * 16, 3): {(1, (2, b"x")): "v"}}),
        ("orset state", {b"c": {b"a" * 16: 5}, b"e": {7: {b"a" * 16: 5}},
                         b"d": {}}),
        ("op file", [[0, 3, [b"a" * 16, 9]], [1, "m", {b"b" * 16: 2}]]),
    ]
)


@pytest.mark.parametrize(
    "label,obj", BOUNDARY_OBJECTS, ids=[label for label, _ in BOUNDARY_OBJECTS]
)
def test_each_size_class_decodes_like_msgpack(label, obj):
    for data in (pack(obj), msgpack.packb(obj, use_bin_type=True)):
        assert same(unpack(data), reference(data))
        assert same(unpack(data), jcodec.unpack(data))


@pytest.mark.parametrize("value", [0.0, 1.25, -3.5, float("inf")])
def test_float32_decodes_like_msgpack(value):
    data = msgpack.packb(value, use_single_float=True)
    assert data[0] == 0xCA
    assert same(unpack(data), reference(data))


@pytest.mark.parametrize("data", [
    b"", b"\x92\x01", b"\xc4\x05ab", b"\xcd\x01", b"\xda\x00\x05ab",
    b"\x81\xc4\x02a", b"\x81\x01", b"\xdc\x00\x02\x01", b"\xcb\x00",
])
def test_truncated_input_raises(data):
    with pytest.raises(ValueError):
        unpack(data)
    with pytest.raises(ValueError):
        reference(data)


@pytest.mark.parametrize("data", [b"\x01\x02", b"\x90\xc0", b"\xc4\x00\x00"])
def test_trailing_input_raises(data):
    with pytest.raises(ValueError):
        unpack(data)
    with pytest.raises(ValueError):
        reference(data)


def test_unused_type_byte_raises():
    with pytest.raises(ValueError):
        unpack(b"\xc1")


def test_memoryview_and_bytearray_inputs():
    data = pack({b"k": [1, 2, (3, b"x")]})
    assert same(unpack(memoryview(data)), reference(data))
    assert same(unpack(bytearray(data)), reference(data))


scalars = (
    st.none() | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300)
)
hashable = st.recursive(
    scalars, lambda inner: st.tuples(inner, inner) | st.tuples(inner), max_leaves=6
)
objects = st.recursive(
    scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(hashable, inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(objects)
def test_nested_objects_decode_like_msgpack(obj):
    for data in (pack(obj), msgpack.packb(obj, use_bin_type=True)):
        assert same(unpack(data), reference(data))


@settings(max_examples=300, deadline=None)
@given(objects)
def test_pack_then_unpack_round_trips_to_the_canonical_bytes(obj):
    """Port ``pack`` → port ``unpack`` → ``pack`` is the identity on the
    canonical bytes (lists come back as tuples, which pack the same)."""
    data = pack(obj)
    assert pack(unpack(data)) == data
    assert jcodec.pack(unpack(data)) == data
