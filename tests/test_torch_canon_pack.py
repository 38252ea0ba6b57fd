"""The port's native canonical packer (``canon_pack`` of
crdt_enc_tpu_torch/native/statebuild.cpp) against its plain Python packer
(``codec.pack_py``) and the JAX package's ``codec.pack``, on the CPU.

It must emit the same bytes on everything it accepts and decline (return
None) what it cannot: ``codec.pack`` then falls back to ``pack_py``, so a
silent divergence here would change every sealed state.  Mirrors
tests/test_canon_pack.py, plus the places where a canonical packer most
easily parts from another: negative ints, ``True`` beside integer keys,
and nested empty containers.
"""

from __future__ import annotations

import numpy as np
import pytest
from _hyp import given, settings, st  # hypothesis, or skip-stubs

from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import native
from crdt_enc_tpu_torch.utils import codec


def _native():
    return native.load_state()


EDGES = [
    None, True, False,
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**63 - 1, 2**63, 2**64 - 1,
    -1, -31, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
    -2**63,
    1.5, -0.0,
    b"", b"x" * 255, b"y" * 256, b"z" * 70000,
    "", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 100,
    [], [1, 2, 3], tuple(range(20)),
    {}, {b"b": 1, b"a": 2}, {1: "x", "1": "y", b"1": b"z"},
    {b"c": {b"k": [1, b"v", None]}, b"e": {5: {b"a": 2**40}}, b"d": {}},
    [{"k": (1, 2)}, {2: [3, {4: 5}]}],
    {True: b"t", 2: b"x", -5: [], (): {}, False: [[], {}, ()]},
    {-1: 1, -33: 2, -129: 3, 0: 4, 2**40: 5, -2**40: 6},
    [[[]], [{}], {b"": {b"": []}}],
    list(range(70000)),                # array32 header
    {i: i * 2 for i in range(70000)},  # map32 header and a big sort
]


@pytest.mark.parametrize("i", range(len(EDGES)))
def test_edge_cases_byte_identical(i):
    case = EDGES[i]
    want = jcodec.pack(case)
    assert _native().canon_pack(case) == want
    assert codec.pack_py(case) == want
    assert codec.pack(case) == want


DECLINED = [{1, 2}, object(), np.int32(5), 2**64, -2**63 - 1,
            bytearray(b"x"), [1, {b"k": frozenset()}]]


@pytest.mark.parametrize("i", range(len(DECLINED)))
def test_unsupported_types_decline(i):
    assert _native().canon_pack(DECLINED[i]) is None


def test_declines_fall_back_to_the_python_packer():
    # what the Python packer takes, it packs as the JAX package does
    assert codec.pack(bytearray(b"xy")) == jcodec.pack(b"xy")
    # and what it cannot take raises as the JAX package's packer does
    for bad, err in (({1, 2}, TypeError), (np.int32(5), TypeError),
                     (2**64, OverflowError), (-2**63 - 1, OverflowError)):
        with pytest.raises(err):
            codec.pack(bad)
        with pytest.raises(err):
            jcodec.pack(bad)


def test_codec_pack_routes_native(monkeypatch):
    """``pack`` goes through the native packer: with the Python packer
    disabled, a state-shaped object still packs, to the JAX bytes; a
    declined object reaches ``pack_py``."""
    obj = {b"c": {b"a%d" % i: i for i in range(100)},
           b"e": {i: {b"x": i} for i in range(50)}, b"d": {}}
    calls = []

    def spy(o):
        calls.append(o)
        raise AssertionError("the Python packer ran on a supported object")

    monkeypatch.setattr(codec, "pack_py", spy)
    assert codec.pack(obj) == jcodec.pack(obj)
    assert not calls
    with pytest.raises(AssertionError):
        codec.pack({1, 2})
    assert calls == [{1, 2}]


_scalar = st.one_of(
    st.none(),
    st.booleans(),
    st.integers(min_value=-(2**63), max_value=2**64 - 1),
    st.binary(max_size=40),
    st.text(max_size=20),
    st.floats(allow_nan=False),
)
_key = st.one_of(
    st.integers(min_value=-(2**40), max_value=2**40),
    st.booleans(),
    st.binary(min_size=0, max_size=16),
    st.text(min_size=0, max_size=8),
    # composite map keys are real here ((replica, counter) dots stay
    # hashable through codec.unpack's tuples)
    st.tuples(st.integers(min_value=-300, max_value=300),
              st.binary(max_size=8)),
)
_value = st.recursive(
    _scalar,
    lambda children: st.one_of(
        st.lists(children, max_size=5),
        st.lists(children, max_size=5).map(tuple),
        st.dictionaries(_key, children, max_size=5),
    ),
    max_leaves=30,
)


@settings(max_examples=200, deadline=None)
@given(obj=_value)
def test_hypothesis_byte_identical(obj):
    want = jcodec.pack(obj)
    assert _native().canon_pack(obj) == want
    assert codec.pack_py(obj) == want
