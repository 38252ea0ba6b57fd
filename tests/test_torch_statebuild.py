"""The port's native state library (crdt_enc_tpu_torch/native/statebuild.cpp)
against the JAX package, on the CPU.

* The fresh-state sparse fold: the port's ``orset_fold_sparse_host`` with
  its native fold, the same function forced onto its numpy path, and the
  JAX ``orset_fold_sparse_host`` give equal canonical bytes over random
  batches, padding, an all-padding batch, an equal horizon killing an add,
  and the int64 clock and counter declines (a counter past 2^31 - 1
  declines the native fold, and the numpy path keeps it exact).  Mirrors
  tests/test_native_statebuild.py.
* ``grouped_rows_dicts`` against the JAX package's Python fill, and the
  error it raises on an index out of range.
* The build: a failing compiler raises on every call, and the library's
  name changes with the interpreter's header directory and ABI tag.
"""

from __future__ import annotations

import os
import shutil
import stat

import numpy as np
import pytest

from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.ops import columnar as JC
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import native
from crdt_enc_tpu_torch.models import ORSet
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.ops import columnar as C
from crdt_enc_tpu_torch.utils import codec, trace


def _gen(N, E, R, seed, rm=0.3, pad=0.05, maxc=500):
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < rm).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    actor = np.where(rng.random(N) < pad, R, actor).astype(np.int32)
    counter = rng.integers(1, maxc, N, dtype=np.int32)
    return kind, member, actor, counter


def _fold_three(clock, cols, E, actors, monkeypatch):
    """The port's native route, its numpy route and the JAX fold over the
    same batch into a state holding only ``clock``; returns their
    canonical bytes."""
    outs = []
    for force_numpy in (False, True):
        st = ORSet()
        st.clock = VClock(dict(clock))
        with monkeypatch.context() as m:
            if force_numpy:
                m.setattr(C, "_orset_fresh_fold_native", lambda *a, **k: None)
            r = C.orset_fold_sparse_host(st, *cols, C.Vocab(range(E)),
                                         C.Vocab(actors))
        outs.append(codec.pack(r.to_obj()))
    js = JORSet()
    js.clock = JVClock(dict(clock))
    j = JC.orset_fold_sparse_host(js, *cols, JC.Vocab(range(E)),
                                  JC.Vocab(actors))
    outs.append(jcodec.pack(j.to_obj()))
    return outs


@pytest.mark.parametrize("seed", range(12))
def test_differential_random(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    N = int(rng.integers(1, 3000))
    E = int(rng.integers(1, 200))
    R = int(rng.integers(1, 500))
    actors = [b"a%06d" % i for i in range(R)]
    cols = _gen(N, E, R, seed)
    # fresh entries but a pre-existing clock: the replay gate and the
    # deferred-horizon filter must use it the same way
    clock = {}
    if seed % 3 == 0:
        clock = {actors[int(i)]: int(c) for i, c in
                 zip(rng.integers(0, R, 20), rng.integers(1, 100, 20))}
    native_b, numpy_b, jax_b = _fold_three(clock, cols, E, actors, monkeypatch)
    assert native_b == numpy_b == jax_b


def test_all_padding_and_empty(monkeypatch):
    E, R = 8, 8
    actors = [b"a%d" % i for i in range(R)]
    pad = (np.zeros(64, np.int8), np.zeros(64, np.int32),
           np.full(64, R, np.int32), np.ones(64, np.int32))
    empty = (np.zeros(0, np.int8), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0, np.int32))
    for cols in (pad, empty):
        outs = _fold_three({}, cols, E, actors, monkeypatch)
        assert outs[0] == outs[1] == outs[2] == codec.pack(ORSet().to_obj())


def test_equal_horizon_kills_add(monkeypatch):
    # strict >: an add whose counter equals the remove horizon dies
    cols = (np.array([0, 1], np.int8), np.array([0, 0], np.int32),
            np.array([0, 0], np.int32), np.array([5, 5], np.int32))
    outs = _fold_three({}, cols, 2, [b"x", b"y"], monkeypatch)
    assert outs[0] == outs[1] == outs[2]
    r = C.orset_fold_sparse_host(ORSet(), *cols, C.Vocab(range(2)),
                                 C.Vocab([b"x", b"y"]))
    assert not r.entries and not r.deferred


def test_int64_clock_declines_the_native_fold(monkeypatch):
    # a clock past int32 must take the numpy path: narrowing it would
    # reopen the replay gate for stale ops
    cols = (np.array([0], np.int8), np.array([0], np.int32),
            np.array([0], np.int32), np.array([7], np.int32))
    trace.reset()
    st = ORSet()
    st.clock = VClock({b"x": 2**40})
    r = C.orset_fold_sparse_host(st, *cols, C.Vocab(range(2)),
                                 C.Vocab([b"x", b"y"]))
    assert "session.sparse_fold" not in trace.snapshot()["spans"]
    assert not r.entries  # the stale add must NOT replay
    assert r.clock.get(b"x") == 2**40
    outs = _fold_three({b"x": 2**40}, cols, 2, [b"x", b"y"], monkeypatch)
    assert outs[0] == outs[1] == outs[2]


def test_counter_past_int32_declines_the_native_fold():
    """A counter of 2^31 (one past int32) and one of 2^40: the native
    fold declines before it narrows, and the numpy path folds both
    exactly, the merged clock included; the JAX function agrees."""
    cols = (np.array([0, 0, 0], np.int8), np.array([1, 2, 3], np.int32),
            np.array([0, 1, 2], np.int32),
            np.array([2**40, 7, 2**31], np.int64))
    actors = [b"a%d" % i for i in range(4)]
    trace.reset()
    r = C.orset_fold_sparse_host(ORSet(), *cols, C.Vocab(range(4)),
                                 C.Vocab(actors))
    assert "session.sparse_fold" not in trace.snapshot()["spans"]
    assert r.entries[1][b"a0"] == 2**40
    assert r.entries[3][b"a2"] == 2**31
    assert r.clock.get(b"a0") == 2**40
    j = JC.orset_fold_sparse_host(JORSet(), *cols, JC.Vocab(range(4)),
                                  JC.Vocab(actors))
    assert codec.pack(r.to_obj()) == jcodec.pack(j.to_obj())


def test_fresh_fold_takes_the_native_route_and_bumps_the_epoch():
    cols = _gen(500, 20, 30, 5)
    trace.reset()
    st = ORSet()
    C.orset_fold_sparse_host(st, *cols, C.Vocab(range(20)),
                             C.Vocab([b"r%d" % i for i in range(30)]))
    spans = trace.snapshot()["spans"]
    assert spans["session.sparse_fold"]["count"] == 1
    assert spans["session.writeback"]["count"] == 1
    assert st._mut == 2  # the fold's bump and the native writeback's


@pytest.mark.parametrize("seed", range(4))
def test_grouped_rows_dicts_matches_the_python_fill(seed):
    rng = np.random.default_rng(seed)
    E, R, n = 50, 40, 700
    cells = np.unique(rng.integers(0, E * R, n))
    m_idx, a_idx = (cells // R).astype(np.int32), (cells % R).astype(np.int32)
    ctr = rng.integers(1, 2**40, len(cells)).astype(np.int64)
    members = [("m", i) for i in range(E)]
    actors = [b"%03d" % i for i in range(R)]
    got, want = {}, {}
    C._grouped_rows_dicts_native(m_idx, a_idx, ctr, members, actors, got)
    JC._fill_dicts_from_rows(m_idx, a_idx, ctr, JC.Vocab(members),
                             JC.Vocab(actors), want)
    assert got == want
    assert codec.pack(got) == codec.pack(want)
    # the plane writeback routes through the same pass
    plane = np.zeros((E, R), np.int32)
    plane[m_idx, a_idx] = (ctr % 1000 + 1).astype(np.int32)
    st = C.orset_planes_to_state(np.zeros(R, np.int32), plane,
                                 np.zeros((E, R), np.int32),
                                 C.Vocab(members), C.Vocab(actors))
    assert st.entries == {
        members[m]: {actors[a]: int(plane[m, a])
                     for a in np.flatnonzero(plane[m])}
        for m in np.unique(m_idx)}


def test_grouped_rows_dicts_declines_an_index_out_of_range():
    for m_idx, a_idx in (([0, 0, 1], [0, 5, 0]), ([0, 0, 2], [0, 1, 0]),
                         ([0, -1, -1], [0, 1, 0])):
        target = {}
        with pytest.raises(RuntimeError, match="refused 3 rows"):
            C._grouped_rows_dicts_native(
                np.array(m_idx, np.int32), np.array(a_idx, np.int32),
                np.array([1, 2, 3], np.int64), ["m0", "m1"], [b"a", b"b"],
                target)
        assert target == {}  # a partial fill is cleared
    with pytest.raises(ValueError, match="unequal lengths"):
        C._grouped_rows_dicts_native(
            np.array([0, 0], np.int32), np.array([0], np.int32),
            np.array([1, 2], np.int64), ["m0"], [b"a"], {})


# ---- the build ------------------------------------------------------------


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no loaded state library, so the next
    ``load_state`` compiles."""
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_state_lib", None)
    return tmp_path


def test_a_failed_build_raises_every_time(fresh_build, monkeypatch):
    real = shutil.which("c++")
    fake = fresh_build / "c++"
    # answers the macro query like the real compiler, fails every build
    fake.write_text(f'#!/bin/sh\ncase "$*" in *-dM*) exec {real} "$@";; esac\n'
                    'echo "fatal error: Python.h: No such file" >&2\nexit 1\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "_cxx", lambda: str(fake))
    monkeypatch.setattr(codec, "_native_pack", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="native build failed"):
            native.load_state()
    # nothing packs in Python behind a failed build
    with pytest.raises(RuntimeError, match="native build failed"):
        codec.pack({b"k": 1})
    assert not os.listdir(fresh_build / "build")


def test_the_library_name_covers_the_headers_and_the_abi(monkeypatch):
    import sysconfig

    base = native.state_lib_path()
    assert base.name.startswith("libcrdtstate-")
    assert base != native.lib_path()
    paths = sysconfig.get_paths()
    monkeypatch.setattr(sysconfig, "get_paths",
                        lambda *a, **k: {**paths, "include": "/elsewhere"})
    assert native.state_lib_path() != base
    monkeypatch.undo()
    real = sysconfig.get_config_var
    monkeypatch.setattr(sysconfig, "get_config_var", lambda name: (
        "cpython-399-other" if name == "SOABI" else real(name)))
    assert native.state_lib_path() != base


def test_the_state_library_builds_from_its_own_source(fresh_build):
    lib = native.load_state()
    assert native.state_lib_path().exists()
    assert lib.canon_pack([1, b"x"]) == codec.pack_py([1, b"x"])
