"""The port's OR-Set ops (crdt_enc_tpu_torch/ops/orset.py) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
its port counterpart; every output is an int32 plane, so the tolerance is
exact equality.  The JAX Pallas kernels run in interpret mode, as
tests/test_pallas_fold.py and tests/test_pallas_merge.py run them; their
shapes stay small (E ≤ 24, R ≤ 300, N ≤ 2048) to keep this file fast.

On CPU tensors the kernel wrappers (``orset_scatter``, ``orset_fold_cuda``,
``orset_merge_many_cuda``) run their plain versions, so their shape
handling and composition are checked here too; the kernels themselves are
checked on the card by tests/test_torch_kernels.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crdt_enc_tpu.ops import orset as J
from crdt_enc_tpu.ops.pallas_fold import (
    ablk_key_space_fits,
    fold_cap,
    orset_fold_pallas,
    orset_scatter_pallas,
)
from crdt_enc_tpu.ops.pallas_merge import orset_merge_many_pallas

from crdt_enc_tpu_torch import convert
from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.ops.orset_fold_cuda import orset_fold_cuda, orset_scatter
from crdt_enc_tpu_torch.ops.orset_merge_cuda import orset_merge_many_cuda


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_planes_equal(ref, got, names=("clock", "add", "rm")):
    assert len(ref) == len(got)
    for r, g, name in zip(ref, got, names):
        r = np.asarray(r)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.int32, name
        np.testing.assert_array_equal(r, g, err_msg=name)


def gen_rows(N, E, R, seed, *, lo=1, hi=200, rm_frac=0.3, pad_frac=0.05):
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < rm_frac).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    actor = np.where(rng.random(N) < pad_frac, R, actor).astype(np.int32)
    counter = rng.integers(lo, hi, N, dtype=np.int32)
    return kind, member, actor, counter


def prior_state(E, R, seed, *, hi=200):
    """A canonical starting state: live dots above some horizons, horizons
    above the clock.  The clock sits mid-range, so batch adds below it are
    stale replays the cell-level gate must drop."""
    rng = np.random.default_rng(seed + 1000)
    clock0 = rng.integers(0, hi, R).astype(np.int32)
    add0 = np.where(rng.random((E, R)) < 0.2, rng.integers(1, hi, (E, R)), 0)
    add0 = np.minimum(add0, clock0[None, :]).astype(np.int32)
    rm0 = np.where(rng.random((E, R)) < 0.1, rng.integers(1, hi, (E, R)), 0)
    rm0 = rm0.astype(np.int32)
    add0 = np.where(add0 > rm0, add0, 0).astype(np.int32)
    rm0 = np.where(rm0 > clock0[None, :], rm0, 0).astype(np.int32)
    return clock0, add0, rm0


def empty_state(E, R):
    z = np.zeros((E, R), np.int32)
    return np.zeros(R, np.int32), z, z.copy()


# (N, E, R, counter range, prior state?, pad fraction)
FOLD_CASES = {
    "sentinel_rows": (600, 12, 40, (1, 200), False, 0.4),
    "prior_state_stale_adds": (800, 16, 50, (1, 200), True, 0.05),
    "counters_ge_2_14": (500, 10, 30, (1 << 14, 1 << 15), True, 0.05),
    "counters_ge_2_15": (500, 10, 30, (1 << 15, 1 << 24), False, 0.05),
    "counters_near_int32_max": (300, 8, 20, (2**31 - 500, 2**31 - 1), False, 0.1),
    "untouched_cells": (40, 24, 300, (1, 100), False, 0.0),
    "unaligned_tiny": (64, 3, 5, (1, 50), True, 0.2),
}


def fold_inputs(case, seed=0):
    N, E, R, (lo, hi), prior, pad = FOLD_CASES[case]
    rows = gen_rows(N, E, R, seed, lo=lo, hi=hi, pad_frac=pad)
    planes = prior_state(E, R, seed, hi=hi) if prior else empty_state(E, R)
    return planes, rows, E, R


@pytest.mark.parametrize("retire_rm", [True, False])
@pytest.mark.parametrize("case", sorted(FOLD_CASES))
def test_fold_matches_jax(case, retire_rm):
    planes, rows, E, R = fold_inputs(case)
    ref = J.orset_fold(*planes, *rows, num_members=E, num_replicas=R,
                       retire_rm=retire_rm)
    kw = dict(num_members=E, num_replicas=R, retire_rm=retire_rm)
    state = convert.planes_from_numpy(*planes, device="cpu")
    got = P.orset_fold(*state, *t(*rows), **kw)
    assert_planes_equal(ref, convert.planes_to_numpy(*got))
    # the kernel wrappers' composition (plain versions on CPU tensors)
    assert_planes_equal(ref, orset_fold_cuda(*state, *t(*rows), **kw))


def test_planes_round_trip_through_convert():
    planes = prior_state(7, 19, 5)
    state = convert.planes_from_numpy(*planes, device="cpu")
    assert all(x.dtype == torch.int32 for x in state)
    back = convert.planes_to_numpy(*state)
    assert_planes_equal(planes, back)


def test_fold_sentinel_rows_stay_out_of_the_last_column():
    """A twin that clamps ``actor`` without masking would fold padding
    rows into column R-1."""
    E, R, N = 6, 9, 200
    rng = np.random.default_rng(4)
    kind = (rng.random(N) < 0.5).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = np.full(N, R, np.int32)
    actor[: N // 4] = rng.integers(0, R - 1, N // 4)  # real rows miss R-1
    counter = rng.integers(1, 99, N, dtype=np.int32)
    planes = empty_state(E, R)
    clock, add, rm = P.orset_fold(*t(*planes, kind, member, actor, counter),
                                  num_members=E, num_replicas=R)
    assert int(clock[R - 1]) == 0
    assert not add[:, R - 1].any() and not rm[:, R - 1].any()
    ref = J.orset_fold(*planes, kind, member, actor, counter,
                       num_members=E, num_replicas=R)
    assert_planes_equal(ref, (clock, add, rm))


def test_fold_untouched_cells_read_zero():
    """Cells no row touches read 0, never the dtype minimum."""
    E, R = 5, 7
    kind = np.array([0, 1], np.int8)
    member = np.array([1, 3], np.int32)
    actor = np.array([2, 4], np.int32)
    counter = np.array([5, 9], np.int32)
    add_new, rm_new = orset_scatter(*t(kind, member, actor, counter),
                                    num_members=E, num_replicas=R)
    expect_add = np.zeros((E, R), np.int32)
    expect_add[1, 2] = 5
    expect_rm = np.zeros((E, R), np.int32)
    expect_rm[3, 4] = 9
    np.testing.assert_array_equal(add_new.numpy(), expect_add)
    np.testing.assert_array_equal(rm_new.numpy(), expect_rm)


@pytest.mark.parametrize("case", ["sentinel_rows", "prior_state_stale_adds", "unaligned_tiny"])
def test_fold_matches_pallas_interpret(case):
    planes, rows, E, R = fold_inputs(case, seed=1)
    member = rows[1]
    ref = orset_fold_pallas(*planes, *rows, num_members=E, num_replicas=R,
                            tile_cap=fold_cap(member, E), interpret=True)
    got = P.orset_fold(*t(*planes, *rows), num_members=E, num_replicas=R)
    assert_planes_equal(ref, got)


# K3: the wide layout (``_fold_wide``), which ``orset_fold_pallas`` takes
# when the ablk layout's int32 segment keys overflow.  Its contract is the
# fold's; the port computes it with the same scatter + tail (int64 cell
# indices), so the port's fold is held against ``layout="wide"`` here, as
# tests/test_pallas_fold.py holds both layouts against the XLA fold.
@pytest.mark.parametrize("retire_rm", [True, False])
@pytest.mark.parametrize("case", ["sentinel_rows", "prior_state_stale_adds",
                                  "unaligned_tiny", "untouched_cells"])
def test_fold_matches_pallas_wide_layout_interpret(case, retire_rm):
    planes, rows, E, R = fold_inputs(case, seed=2)
    kw = dict(num_members=E, num_replicas=R, retire_rm=retire_rm)
    ref = orset_fold_pallas(*planes, *rows, tile_cap=fold_cap(rows[1], E),
                            interpret=True, layout="wide", **kw)
    assert_planes_equal(ref, P.orset_fold(*t(*planes, *rows), **kw))
    assert_planes_equal(ref, orset_fold_cuda(*t(*planes, *rows), **kw))


def test_k3_shape_forces_the_wide_layout():
    """E = 4,096, R = 261,000 (the shape chip_smoke.py folds on the card):
    the ablk key space 2·Ep·Rp = 2^31 overflows int32, so the JAX front
    door reroutes to ``_fold_wide``, whose own guard still holds.  The
    port pads nothing and indexes cells in int64."""
    E, R = 4096, 261_000
    assert not ablk_key_space_fits(E, R)
    assert ablk_key_space_fits(E, R - 2048)  # one ablk actor block less fits
    assert (E // 8) * (2 * 8 * R) + 2 * 8 * R < 2**31


def test_scatter_matches_pallas_scatter_interpret():
    E, R = 16, 130
    rows = gen_rows(700, E, R, 3, pad_frac=0.1)
    ref = orset_scatter_pallas(*rows, num_members=E, num_replicas=R,
                               tile_cap=fold_cap(rows[1], E), interpret=True)
    got = orset_scatter(*t(*rows), num_members=E, num_replicas=R)
    assert_planes_equal(ref, got, names=("add_new", "rm_new"))


@pytest.mark.parametrize("retire_rm", [True, False])
def test_scatter_clock_and_tail_compose_to_the_fold(retire_rm):
    planes, rows, E, R = fold_inputs("prior_state_stale_adds", seed=2)
    clock0 = torch.from_numpy(planes[0])
    clock = clock0.clone()
    add_new, rm_new = orset_scatter(*t(*rows), num_members=E, num_replicas=R,
                                    clock=clock)
    # the clock is final after the scatter: max(clock0, max add counter)
    kind, _, actor, counter = rows
    live = (kind == 0) & (actor < R)
    expect = planes[0].copy()
    np.maximum.at(expect, actor[live], counter[live])
    np.testing.assert_array_equal(clock.numpy(), expect)
    add, rm = P.orset_fold_tail_plain(clock0, clock, *t(planes[1], planes[2]),
                                      add_new, rm_new, retire_rm=retire_rm)
    ref = J.orset_fold(*planes, *rows, num_members=E, num_replicas=R,
                       retire_rm=retire_rm)
    assert_planes_equal(ref, (clock, add, rm))


@pytest.mark.parametrize("seed", range(3))
def test_apply_batch_planes_matches_jax(seed):
    E, R = 11, 23
    planes = prior_state(E, R, seed)
    rng = np.random.default_rng(seed)
    add_b = np.where(rng.random((E, R)) < 0.3, rng.integers(1, 300, (E, R)), 0)
    rm_b = np.where(rng.random((E, R)) < 0.2, rng.integers(1, 300, (E, R)), 0)
    batch = (add_b.astype(np.int32), rm_b.astype(np.int32))
    ref = J.orset_apply_batch_planes(*planes, *batch)
    assert_planes_equal(ref, P.orset_apply_batch_planes(*t(*planes, *batch)))


def canonical_states(S, E, R, seed):
    """S canonical states, each the fold of its own batch into a shared
    prior state (so dots, horizons and clocks overlap across states)."""
    base = prior_state(E, R, seed)
    out = []
    for s in range(S):
        rows = gen_rows(120, E, R, seed * 100 + s, hi=300)
        out.append(tuple(np.asarray(x) for x in J.orset_fold(
            *base, *rows, num_members=E, num_replicas=R)))
    return [np.stack([st[i] for st in out]) for i in range(3)]


@pytest.mark.parametrize("seed", range(3))
def test_merge_and_merge_rule_match_jax(seed):
    clocks, adds, rms = canonical_states(2, 9, 17, seed)
    pair = (clocks[0], adds[0], rms[0], clocks[1], adds[1], rms[1])
    assert_planes_equal(J.orset_merge(*pair), P.orset_merge(*t(*pair)))
    cm = np.maximum(clocks[0], clocks[1])
    ref = J.merge_rule(clocks[0][None], adds[0], rms[0], clocks[1][None],
                       adds[1], rms[1], cm[None])
    got = P.merge_rule(*t(clocks[0][None], adds[0], rms[0], clocks[1][None],
                          adds[1], rms[1], cm[None]))
    assert_planes_equal(ref, got, names=("add", "rm"))


@pytest.mark.parametrize("S", [1, 2, 3, 5])
def test_merge_many_tree_matches_jax(S):
    stacks = canonical_states(S, 10, 21, seed=S)
    ref = J.orset_merge_many(*stacks, impl="tree")
    assert_planes_equal(ref, P.orset_merge_many(*t(*stacks)))
    assert_planes_equal(ref, orset_merge_many_cuda(*t(*stacks)))


@pytest.mark.parametrize("S", [1, 3, 5])
def test_merge_many_matches_pallas_interpret(S):
    stacks = canonical_states(S, 13, 37, seed=10 + S)
    ref = orset_merge_many_pallas(*stacks, interpret=True)
    assert_planes_equal(ref, P.orset_merge_many(*t(*stacks)))


def test_mixed_devices_never_reach_the_plain_path():
    """Tensors off the CPU (here the meta device) are refused, never run
    through the plain code."""
    planes, rows, E, R = fold_inputs("unaligned_tiny")
    ts = t(*planes, *rows)
    ts[1] = ts[1].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        P.orset_fold(*ts, num_members=E, num_replicas=R)
    meta = [x.to("meta") for x in t(*planes, *rows)]
    with pytest.raises(ValueError, match="plain path takes CPU"):
        P.orset_fold(*meta, num_members=E, num_replicas=R)
