"""The library surface the port copies from the JAX package, held against
it on the CPU: ``models.REGISTRY`` and the ``Crdt`` protocol,
``VClock.concurrent`` and ``.actors``, ``reset_remove`` on ``GCounter``,
``PNCounter`` and ``MVReg`` (with tests/test_crdtmap.py's pinned MVReg
counterexample), ``RemoteMeta.is_empty``, ``VersionBytes.uuid``, ``.buf``
and ``VersionBytesBuf`` (tests/test_version_bytes.py's buffer cases, a
real ``os.writev`` included), ``LockBox.replace``, ``in_section`` and
``assert_outside_section`` (tests/test_lockbox.py), ``strictly_sorted``,
``Vocab.presorted_unique`` and ``Vocab.index``, and ``native.warm``.
Every comparison is exact.
"""

from __future__ import annotations

import asyncio
import os
import uuid

import numpy as np
import pytest

from crdt_enc_tpu import models as jmodels
from crdt_enc_tpu.core.core import RemoteMeta as JRemoteMeta
from crdt_enc_tpu.ops import columnar as JC
from crdt_enc_tpu.utils import version_bytes as jvb
from crdt_enc_tpu_torch import models, native
from crdt_enc_tpu_torch.core.core import RemoteMeta
from crdt_enc_tpu_torch.models import (
    REGISTRY,
    Crdt,
    GCounter,
    MVReg,
    PNCounter,
    VClock,
    canonical_bytes,
)
from crdt_enc_tpu_torch.models.crdtmap import CHILD_TYPES
from crdt_enc_tpu_torch.ops import columnar as C
from crdt_enc_tpu_torch.utils import codec
from crdt_enc_tpu_torch.utils.lockbox import (
    LockBox,
    LockBoxViolation,
    assert_outside_section,
    in_section,
)
from crdt_enc_tpu_torch.utils.version_bytes import (
    VERSION_LEN,
    VersionBytes,
    VersionBytesBuf,
)

A, B, D = (uuid.UUID(int=i).bytes for i in (1, 2, 3))
V1 = uuid.UUID("11111111-2222-3333-4444-555555555555").bytes
V2 = uuid.UUID("aaaaaaaa-bbbb-cccc-dddd-eeeeeeeeeeee").bytes


def jtwin(state):
    """The JAX package's state of the same wire bytes."""
    name = next(k for k, v in REGISTRY.items() if isinstance(state, v))
    return jmodels.REGISTRY[name].from_obj(
        codec.unpack(canonical_bytes(state)))


# ---- models ------------------------------------------------------------------


def test_registry_names_the_jax_types():
    assert set(REGISTRY) == set(jmodels.REGISTRY)
    for name, cls in REGISTRY.items():
        assert cls.__name__ == jmodels.REGISTRY[name].__name__
        empty = cls()
        assert isinstance(empty, Crdt), name
        assert canonical_bytes(empty) == jmodels.canonical_bytes(
            jmodels.REGISTRY[name]())
    assert not isinstance(object(), Crdt)
    assert list(CHILD_TYPES) == [b"orset"]  # the map's child stays ORSet


@pytest.mark.parametrize("seed", range(4))
def test_vclock_concurrent_and_actors(seed):
    rng = np.random.default_rng(seed)
    actors = [A, B, D]
    clocks = []
    for _ in range(6):
        c = {a: int(rng.integers(0, 4)) for a in actors}
        clocks.append({a: n for a, n in c.items() if n})
    for x in clocks:
        for y in clocks:
            ours = VClock(dict(x)).concurrent(VClock(dict(y)))
            theirs = jmodels.VClock(dict(x)).concurrent(jmodels.VClock(dict(y)))
            assert ours == theirs
        assert list(VClock(dict(x)).actors()) == list(
            jmodels.VClock(dict(x)).actors())
    v = VClock()
    v.apply(v.inc(A))
    v.merge(VClock({B: 3}))
    assert v.concurrent(VClock({D: 1}))
    assert not v.concurrent(VClock({A: 1}))


def counters_pair(seed):
    rng = np.random.default_rng(seed)
    g, pn = GCounter(), PNCounter()
    for _ in range(30):
        a = (A, B, D)[int(rng.integers(3))]
        g.apply(g.inc(a, int(rng.integers(1, 4))))
        op = pn.inc(a) if rng.random() < 0.6 else pn.dec(a)
        pn.apply(op)
    return g, pn


@pytest.mark.parametrize("seed", range(3))
def test_reset_remove_on_the_counters_matches_jax(seed):
    g, pn = counters_pair(seed)
    jg, jpn = jtwin(g), jtwin(pn)
    for ctx in ({A: 2}, {B: 100, D: 1}, {}):
        g.reset_remove(VClock(dict(ctx)))
        jg.reset_remove(jmodels.VClock(dict(ctx)))
        pn.reset_remove(VClock(dict(ctx)))
        jpn.reset_remove(jmodels.VClock(dict(ctx)))
        assert canonical_bytes(g) == jmodels.canonical_bytes(jg)
        assert canonical_bytes(pn) == jmodels.canonical_bytes(jpn)
        assert g.read() == jg.read() and pn.read() == jpn.read()


def test_reset_remove_on_mvreg_matches_jax():
    reg = MVReg()
    reg.vals = [(VClock({A: 1, B: 1}), "v2"), (VClock({D: 2}), "v3")]
    jreg = jtwin(reg)
    for ctx in ({A: 1}, {D: 2}, {B: 5}):
        reg.reset_remove(VClock(dict(ctx)))
        jreg.reset_remove(jmodels.VClock(dict(ctx)))
        assert canonical_bytes(reg) == jmodels.canonical_bytes(jreg)
    assert reg.vals == []


def test_mvreg_child_impossibility_pinned():
    """tests/test_crdtmap.py's counterexample on the port's MVReg: a
    snapshot merged before or after a key-remove's ``reset_remove``
    gives different bytes, which is why ``CHILD_TYPES`` excludes MVReg;
    each order equals the JAX package's."""
    def fresh(mod):
        reg = mod.MVReg()
        reg.vals = [(mod.VClock({A: 1, B: 1}), "v2")]
        return reg

    out = {}
    for name, mod, canon in (("port", models, canonical_bytes),
                             ("jax", jmodels, jmodels.canonical_bytes)):
        stale = fresh(mod)
        x = fresh(mod)
        x.reset_remove(mod.VClock({A: 1}))
        assert x.vals == [(mod.VClock({B: 1}), "v2")]
        x.merge(stale)
        y = fresh(mod)
        y.merge(stale)
        y.reset_remove(mod.VClock({A: 1}))
        assert canon(x) != canon(y)
        assert x.vals[0][0].get(A) == 1 and y.vals[0][0].get(A) == 0
        out[name] = (canon(x), canon(y))
    assert out["port"] == out["jax"]


def test_remote_meta_is_empty():
    meta, jmeta = RemoteMeta(), JRemoteMeta()
    assert meta.is_empty() and jmeta.is_empty()
    for slot in ("storage", "cryptor", "key_cryptor"):
        m = RemoteMeta()
        jm = JRemoteMeta()
        getattr(m, slot).vals = [(VClock({A: 1}), b"cfg")]
        getattr(jm, slot).vals = [(jmodels.VClock({A: 1}), b"cfg")]
        assert m.is_empty() is jm.is_empty() is False
        assert codec.pack(m.to_obj()) == codec.pack(jm.to_obj())


# ---- VersionBytes ------------------------------------------------------------


def test_version_bytes_uuid_and_buf():
    vb = VersionBytes(V2, b"roundtrip")
    jv = jvb.VersionBytes(V2, b"roundtrip")
    assert vb.uuid == jv.uuid == uuid.UUID(bytes=V2)
    assert vb.buf().read_all() == vb.serialize() == jv.buf().read_all()


def test_buf_simple_and_unaligned_advance():
    buf = VersionBytesBuf(V1, b"content!")
    assert len(buf) == buf.remaining() == VERSION_LEN + 8
    assert bytes(buf.chunk()) == V1
    buf.advance(VERSION_LEN)
    assert bytes(buf.chunk()) == b"content!"
    buf.advance(8)
    assert buf.remaining() == 0
    buf = VersionBytesBuf(uuid.UUID(bytes=V1), b"abcdef")
    buf.advance(10)
    assert bytes(buf.chunk()) == V1[10:]
    buf.advance(6)
    assert bytes(buf.chunk()) == b"abcdef"
    buf2 = VersionBytesBuf(V1, b"abcdef")
    buf2.advance(18)
    assert bytes(buf2.chunk()) == b"cdef" and buf2.remaining() == 4


@pytest.mark.parametrize("n", [-1, VERSION_LEN + 4])
def test_buf_bad_advance(n):
    for cls in (VersionBytesBuf, jvb.VersionBytesBuf):
        with pytest.raises(IndexError):
            cls(V1, b"abc").advance(n)


@pytest.mark.parametrize("content,steps,limit", [
    (b"xyz", [0, VERSION_LEN + 1, 2], 64),
    (b"", [0, 5, 11], 64),
    (b"payload", [3, 13, 2], 1),
    (b"q" * 100, [0], 0),
])
def test_buf_vectored_matches_jax(content, steps, limit):
    ours, theirs = VersionBytesBuf(V1, content), jvb.VersionBytesBuf(V1,
                                                                      content)
    for n in steps:
        ours.advance(n)
        theirs.advance(n)
        assert [bytes(c) for c in ours.chunks_vectored(limit)] == [
            bytes(c) for c in theirs.chunks_vectored(limit)]
        assert ours.remaining() == theirs.remaining()
    assert ours.read_all() == theirs.read_all()


def test_buf_vectored_through_real_writev(tmp_path):
    vb = VersionBytes(V1, b"payload-bytes")
    fd = os.open(str(tmp_path / "out"), os.O_WRONLY | os.O_CREAT, 0o644)
    try:
        written = os.writev(fd, vb.buf().chunks_vectored())
    finally:
        os.close(fd)
    assert written == VERSION_LEN + len(b"payload-bytes")
    assert (tmp_path / "out").read_bytes() == vb.serialize()


# ---- LockBox -----------------------------------------------------------------


class Box:
    def __init__(self):
        self.n = 0


def test_section_depth_and_guard():
    lb = LockBox(Box())
    assert not in_section()
    seen = []
    lb.with_(lambda b: seen.append(in_section()))
    lb.with_(lambda b: LockBox(Box()).with_(
        lambda c: seen.append(in_section())))
    assert seen == [True, True]
    assert not in_section()
    assert_outside_section("test await")

    def inner(_b):
        with pytest.raises(LockBoxViolation, match="awaiting storage"):
            assert_outside_section("awaiting storage")

    lb.with_(inner)
    assert not in_section()


def test_section_depth_is_per_task():
    """The depth is a context variable: a task started inside a section
    does not inherit a section it never entered once the section ends."""
    async def go():
        lb = LockBox(Box())
        flags = []

        async def probe():
            flags.append(in_section())

        lb.with_(lambda b: flags.append(in_section()))
        await asyncio.create_task(probe())
        return flags

    assert asyncio.run(go()) == [True, False]


def test_replace_swaps_the_guarded_value():
    lb = LockBox(Box())
    new = Box()
    new.n = 42
    lb.replace(new)
    assert lb.with_(lambda b: b.n) == 42


# ---- columnar helpers --------------------------------------------------------


@pytest.mark.parametrize("seq", [
    [], [1], [1, 2, 3], [1, 1, 2], [3, 2], [b"a", b"b", b"c"], [b"b", b"a"],
    sorted(np.random.default_rng(0).bytes(16) for _ in range(50)),
])
def test_strictly_sorted_matches_jax(seq):
    assert C.strictly_sorted(seq) == JC.strictly_sorted(seq)


def test_vocab_presorted_unique_and_index():
    items = sorted(bytes([i]) * 16 for i in range(1, 40))
    v, jv = C.Vocab.presorted_unique(items), JC.Vocab.presorted_unique(items)
    assert v.items == jv.items == items
    assert v.index == jv.index == {x: i for i, x in enumerate(items)}
    assert v.intern(b"\xff" * 16) == jv.intern(b"\xff" * 16) == len(items)
    dup = C.Vocab([b"x", b"y", b"x", b"z"])
    jdup = JC.Vocab([b"x", b"y", b"x", b"z"])
    assert dup.items == jdup.items == [b"x", b"y", b"z"]
    assert dup.index == jdup.index


# ---- native.warm -------------------------------------------------------------


def test_native_warm_loads_both_libraries():
    native.warm()
    assert native.load() is native.load()
    assert native.load_state() is native.load_state()
