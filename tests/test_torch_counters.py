"""The port's counter folds (crdt_enc_tpu_torch/ops/counters.py) against
the JAX package's, on the CPU.

The JAX ``gcounter_fold`` / ``pncounter_fold`` take two routes: a scatter
segment-max below ``SORTED_MIN_ROWS`` rows and a sort route at or above
it.  The port has one plain route for both devices, so each case runs at
N on both sides of that threshold.  The same numpy inputs, made from a
seed, go through both packages; the planes are integer vectors, so the
tolerance is exact equality.  The device ``value`` scalar is advisory on
both sides; it is held against the numpy sum of the planes, not against
the JAX scalar (which is int32 without x64).
"""

from __future__ import annotations

import uuid

import numpy as np
import pytest
import torch

from crdt_enc_tpu.ops import columnar as JC
from crdt_enc_tpu.ops import counters as J
from crdt_enc_tpu.models import GCounter as JGCounter
from crdt_enc_tpu.models import PNCounter as JPNCounter

from crdt_enc_tpu_torch.models.counters import NEG, POS
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.ops import columnar as PC
from crdt_enc_tpu_torch.ops import counters as P

ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(9)]
SIZES = [1, 700, J.SORTED_MIN_ROWS - 1, J.SORTED_MIN_ROWS, 9000, 20000]


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def rows(N, R, seed, *, pad_frac=0.1, bad_sign_frac=0.05):
    """(sign, actor, counter): padding rows carry ``actor = R``; a few
    rows carry sign 2, outside {POS, NEG}."""
    rng = np.random.default_rng(seed)
    sign = (rng.random(N) < 0.4).astype(np.int8)
    sign = np.where(rng.random(N) < bad_sign_frac, 2, sign).astype(np.int8)
    actor = rng.integers(0, R, N).astype(np.int32)
    actor = np.where(rng.random(N) < pad_frac, R, actor).astype(np.int32)
    counter = rng.integers(0, 1 << 20, N).astype(np.int32)
    return sign, actor, counter


def clocks(R, seed):
    rng = np.random.default_rng(seed + 100)
    return (rng.integers(0, 1 << 19, R).astype(np.int32),
            rng.integers(0, 1 << 19, R).astype(np.int32))


@pytest.mark.parametrize("R", [1, 7, 1000])
@pytest.mark.parametrize("N", SIZES)
def test_gcounter_fold_matches_jax(N, R):
    _, actor, counter = rows(N, R, N + R)
    clock0, _ = clocks(R, N)
    ref, _ = J.gcounter_fold(clock0, actor, counter, num_replicas=R)
    got, value = P.gcounter_fold(*t(clock0, actor, counter), num_replicas=R)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())
    assert value.dtype == torch.int64
    assert int(value) == int(np.asarray(ref, np.int64).sum())


@pytest.mark.parametrize("R", [1, 7, 1000])
@pytest.mark.parametrize("N", SIZES)
def test_pncounter_fold_matches_jax(N, R):
    sign, actor, counter = rows(N, R, 3 * N + R)
    p0, n0 = clocks(R, N + 1)
    rp, rn, _ = J.pncounter_fold(p0, n0, sign, actor, counter, num_replicas=R)
    p, n, value = P.pncounter_fold(*t(p0, n0, sign, actor, counter),
                                   num_replicas=R)
    np.testing.assert_array_equal(np.asarray(rp), p.numpy())
    np.testing.assert_array_equal(np.asarray(rn), n.numpy())
    assert int(value) == (int(np.asarray(rp, np.int64).sum())
                          - int(np.asarray(rn, np.int64).sum()))


def test_bad_signs_and_padding_rows_drop_out():
    R = 3
    sign = np.array([POS, NEG, 2, POS, NEG, -1], np.int8)
    actor = np.array([0, 1, 2, R, R, 0], np.int32)
    counter = np.array([5, 6, 7, 8, 9, 10], np.int32)
    z = np.zeros(R, np.int32)
    p, n, value = P.pncounter_fold(*t(z, z, sign, actor, counter),
                                   num_replicas=R)
    assert p.tolist() == [5, 0, 0] and n.tolist() == [0, 6, 0]
    assert int(value) == -1
    clock, _ = P.gcounter_fold(*t(z, actor, counter), num_replicas=R)
    assert clock.tolist() == [10, 6, 7]


def test_wide_planes_fold_exactly():
    """int64 planes (a counter past int32) stay int64 and exact."""
    R = 2
    clock0 = np.array([2**40, 1], np.int64)
    actor = np.array([0, 1, 1], np.int32)
    counter = np.array([5, 2**33, 9], np.int64)
    clock, value = P.gcounter_fold(*t(clock0, actor, counter), num_replicas=R)
    assert clock.dtype == torch.int64
    assert clock.tolist() == [2**40, 2**33]
    assert int(value) == 2**40 + 2**33


def test_vclock_merge_matches_jax():
    a, b = clocks(50, 4)
    np.testing.assert_array_equal(np.asarray(J.vclock_merge(a, b)),
                                  P.vclock_merge(*t(a, b)).numpy())


def script(seed, n=300):
    """A PN-Counter op history applied by the JAX host model."""
    rng = np.random.default_rng(seed)
    state = JPNCounter()
    ops = []
    for _ in range(n):
        a = ACTORS[int(rng.integers(len(ACTORS)))]
        steps = int(rng.integers(1, 5))
        op = (state.dec if rng.random() < 0.3 else state.inc)(a, steps)
        state.apply(op)
        ops.append(op)
    return state, ops


def port_pn_ops(ops):
    return [(d, Dot.from_obj(dot.to_obj())) for d, dot in ops]


@pytest.mark.parametrize("seed", range(3))
def test_columns_match_jax(seed):
    _, ops = script(seed)
    ref = JC.counter_ops_to_columns(ops)
    got = PC.counter_ops_to_columns(port_pn_ops(ops))
    for name in ("sign", "actor", "counter"):
        r, g = getattr(ref, name), getattr(got, name)
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    assert list(ref.replicas.items) == list(got.replicas.items)
    # G-Counter ops are bare dots, always POS
    gops = [dot for _, dot in port_pn_ops(ops)]
    assert set(PC.counter_ops_to_columns(gops).sign.tolist()) == {POS}


def test_columns_refuse_a_bad_direction():
    with pytest.raises(ValueError, match="direction"):
        PC.counter_ops_to_columns([(3, Dot(ACTORS[0], 1))])


def test_dense_vclock_round_trip_matches_jax():
    state, _ = script(5)
    jc = state.p.clock
    pc = VClock.from_obj(jc.to_obj())
    jv, pv = JC.Vocab(ACTORS[::-1]), PC.Vocab(ACTORS[::-1])
    ref, got = JC.vclock_to_dense(jc, jv), PC.vclock_to_dense(pc, pv)
    assert ref.dtype == got.dtype == np.int32
    np.testing.assert_array_equal(ref, got)
    assert PC.dense_to_vclock(got, pv).to_obj() == JC.dense_to_vclock(ref, jv).to_obj()


def test_dense_vclock_widens_past_int32():
    c = VClock({ACTORS[0]: 2**31, ACTORS[1]: 4})
    v = PC.Vocab()
    dense = PC.vclock_to_dense(c, v)
    assert dense.dtype == np.int64
    assert PC.dense_to_vclock(dense, v).counters == c.counters


def test_counter_models_round_trip_the_jax_objects():
    state, _ = script(6)
    from crdt_enc_tpu_torch import convert

    p = convert.pncounter_from_reference_obj(state.to_obj())
    assert p.to_obj() == state.to_obj() and p.read() == state.read()
    g = JGCounter()
    g.apply(g.inc(ACTORS[2], 3))
    pg = convert.gcounter_from_reference_obj(g.to_obj())
    assert pg.to_obj() == g.to_obj() and pg.read() == 3
