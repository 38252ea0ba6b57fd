"""The port's pure-Python canonical ``pack`` must give the same bytes as
the JAX package's ``crdt_enc_tpu.utils.codec.pack``: on OR-Set states, on
nested maps with mixed key types, and at every msgpack length and integer
boundary."""

from __future__ import annotations

import uuid

import numpy as np
import pytest

from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.utils import codec as jcodec

from crdt_enc_tpu_torch import canonical_bytes, convert
from crdt_enc_tpu_torch.utils import codec

ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(6)]


def same(obj):
    assert codec.pack(obj) == jcodec.pack(obj)


INTS = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -31, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
    -2**63,
]


@pytest.mark.parametrize("n", INTS)
def test_int_boundaries(n):
    same(n)
    same({n: n})


@pytest.mark.parametrize("size", [0, 1, 31, 32, 255, 256, 65535, 65536])
def test_str_and_bytes_lengths(size):
    same("x" * size)
    same(b"\x01" * size)
    same(bytearray(b"\x02" * size))
    same("é" * (size // 2))


@pytest.mark.parametrize("size", [0, 15, 16, 65535, 65536])
def test_container_lengths(size):
    same(list(range(size)))
    same(tuple(range(size)))
    same({i: b"v" for i in range(size)})


@pytest.mark.parametrize("value", [None, True, False, 0.0, -1.5, 1e300, float("inf")])
def test_scalars(value):
    same(value)
    same([value, {b"k": value}])


def test_nested_maps_with_mixed_key_types_sort_by_packed_key():
    obj = {
        b"b": 1, "a": 2, 3: {(1, b"x"): [None, True], -4: 1.25},
        (2, "z"): {b"\x00" * 40: "s", 200: -70000}, -1: [[], {}],
        True: b"", None: 0,
    }
    same(obj)
    same([obj, {b"nest": obj}])


def test_ints_and_bools_never_alias():
    same([True, 1, False, 0])
    assert codec.pack(True) != codec.pack(1)


def test_out_of_range_and_unknown_types_raise():
    with pytest.raises(OverflowError):
        codec.pack(2**64)
    with pytest.raises(OverflowError):
        codec.pack(-2**63 - 1)
    with pytest.raises(TypeError):
        codec.pack(object())


@pytest.mark.parametrize("seed", range(4))
def test_orset_states_pack_identically(seed):
    rng = np.random.default_rng(seed)
    state = JORSet()
    members = [b"m", 7, "s", (1, 2), -3, b"\xff" * 20]
    for _ in range(300):
        m = members[int(rng.integers(len(members)))]
        if rng.random() < 0.25:
            op = state.rm_ctx(m)
            if op.ctx.is_empty():
                continue
        else:
            op = state.add_ctx(ACTORS[int(rng.integers(len(ACTORS)))], m)
        state.apply(op)
    obj = state.to_obj()
    same(obj)
    ported = convert.orset_from_reference_obj(obj)
    assert canonical_bytes(ported) == jcodec.pack(obj)
