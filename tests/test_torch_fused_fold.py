"""K2 on the CPU: the port's fold against ``orset_fold_pallas_fused``.

The JAX fused fold runs in interpret mode on the padded layout
(``orset_pad_state`` / ``orset_unpad_state``), chained as
tests/test_pallas_fold.py::test_fused_chain_parity chains it: eagerly
(two retiring folds) and deferred (two ``retire_rm=False`` folds, then one
``orset_retire``).  The port folds the unpadded planes through
``orset_fold`` and its wrapper ``orset_fold_cuda`` (plain versions on CPU
tensors) and finalizes the deferred chain with its own ``orset_retire``.
Every output is an int32 plane: the tolerance is exact equality.

Also here: the pure-Python range geometry of the bucketed CUDA fold
(``fold_geometry``), which the kernels themselves only meet on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crdt_enc_tpu.ops.pallas_fold import (
    orset_fold_pallas_fused,
    orset_pad_state,
    orset_unpad_state,
)
from crdt_enc_tpu.ops.pallas_fold import orset_retire as jax_orset_retire

from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.ops.orset_fold_cuda import (
    CLOCK_SMEM_MAX,
    DENSE_RANGES_MAX,
    RANGE_SHIFT,
    fold_geometry,
    orset_fold_cuda,
)

CAP = 1 << 13  # the JAX fold's tile_cap, as the JAX chain test sets it
SHAPES = [(16, 300, 4000), (40, 130, 2500)]


def gen_rows(N, E, R, seed, max_counter=250, rm_frac=0.3, pad_frac=0.05):
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < rm_frac).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    actor = np.where(rng.random(N) < pad_frac, R, actor).astype(np.int32)
    counter = rng.integers(1, max_counter, N, dtype=np.int32)
    return kind, member, actor, counter


def well_formed_state(E, R, seed):
    """A state every real fold output satisfies: add > rm or 0, rm
    retired against the clock."""
    rng = np.random.default_rng(seed)
    clock0 = rng.integers(0, 50, R).astype(np.int32)
    add0 = np.zeros((E, R), np.int32)
    rm0 = np.zeros((E, R), np.int32)
    add0[rng.random((E, R)) < 0.1] = 40
    rm0[rng.random((E, R)) < 0.05] = 60
    add0 = np.where(add0 > rm0, add0, 0).astype(np.int32)
    rm0 = np.where(rm0 > clock0[None, :], rm0, 0).astype(np.int32)
    return clock0, add0, rm0


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_planes_equal(ref, got, what):
    for r, g, name in zip(ref, got, ("clock", "add", "rm")):
        g = g.numpy()
        assert g.dtype == np.int32, f"{what}:{name}"
        np.testing.assert_array_equal(np.asarray(r), g, err_msg=f"{what}:{name}")


def chain_inputs(E, R, N):
    return (well_formed_state(E, R, 7), gen_rows(N, E, R, 1),
            gen_rows(N, E, R, 2))


@pytest.mark.parametrize("fold", [P.orset_fold, orset_fold_cuda],
                         ids=["orset_fold", "orset_fold_cuda"])
@pytest.mark.parametrize("E,R,N", SHAPES)
def test_eager_chain_matches_fused_pallas(E, R, N, fold):
    st, b1, b2 = chain_inputs(E, R, N)
    kw = dict(num_members=E, num_replicas=R)
    p = orset_pad_state(*st, **kw)
    f1 = orset_fold_pallas_fused(*p, *b1, **kw, tile_cap=CAP, interpret=True)
    f2 = orset_fold_pallas_fused(*f1, *b2, **kw, tile_cap=CAP, interpret=True)
    ref = orset_unpad_state(*f2, **kw)
    g1 = fold(*t(*st), *t(*b1), **kw)
    got = fold(*g1, *t(*b2), **kw)
    assert_planes_equal(ref, got, "eager")


@pytest.mark.parametrize("fold", [P.orset_fold, orset_fold_cuda],
                         ids=["orset_fold", "orset_fold_cuda"])
@pytest.mark.parametrize("E,R,N", SHAPES)
def test_deferred_chain_and_retire_match_fused_pallas(E, R, N, fold):
    """``retire_rm=False`` twice, then ``orset_retire``: the JAX chain
    under its skip/8-bit route (counters < 256) against the port's."""
    st, b1, b2 = chain_inputs(E, R, N)
    kw = dict(num_members=E, num_replicas=R)
    jkw = dict(kw, tile_cap=CAP, interpret=True, retire_rm=False,
               hi_mode="skip", limb_bits=8)
    p = orset_pad_state(*st, **kw)
    d1 = orset_fold_pallas_fused(*p, *b1, **jkw)
    dc, da, dr = orset_fold_pallas_fused(*d1, *b2, **jkw)
    ref = orset_unpad_state(dc, da, jax_orset_retire(dc, dr), **kw)
    g1 = fold(*t(*st), *t(*b1), **kw, retire_rm=False)
    gc, ga, gr = fold(*g1, *t(*b2), **kw, retire_rm=False)
    assert_planes_equal(ref, (gc, ga, P.orset_retire(gc, gr)), "deferred")
    # and the deferred chain finalizes to the eager one
    e1 = fold(*t(*st), *t(*b1), **kw)
    assert_planes_equal(ref, fold(*e1, *t(*b2), **kw), "eager vs deferred")


def test_retire_matches_jax():
    rng = np.random.default_rng(3)
    clock = rng.integers(0, 100, 37).astype(np.int32)
    rm = np.where(rng.random((9, 37)) < 0.4,
                  rng.integers(1, 200, (9, 37)), 0).astype(np.int32)
    got = P.orset_retire(*t(clock, rm))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jax_orset_retire(clock, rm)),
                                  got.numpy())


# ---- the range geometry of the bucketed CUDA fold --------------------------

K3_E, K3_R = 4096, 261_000
SMEM_PER_BLOCK_MAX = 232_448  # 227 KB: what one block may opt in to on Hopper


@pytest.mark.parametrize("E,R", [(4096, 10_000), (K3_E, K3_R), (7, 9000),
                                 (13, 1001), (1, 20_000), (20_000, 1),
                                 (3, 5), (1, 1), (0, 9), (9, 0)])
def test_ranges_cover_the_cells_exactly(E, R):
    C, n_ranges, smem = fold_geometry(E, R)
    assert C == 1 << RANGE_SHIFT
    assert (n_ranges - 1) * C < E * R <= n_ranges * C or E * R == n_ranges == 0
    # the last range is the only ragged one
    assert 0 < E * R - (n_ranges - 1) * C <= C or E * R == 0
    assert smem == 2 * C * 4 <= SMEM_PER_BLOCK_MAX


def test_small_planes_take_one_range():
    """E·R < C: one block, whose walk stops at E·R."""
    for E, R in ((3, 5), (1, 1), (1, (1 << RANGE_SHIFT) - 1),
                 ((1 << RANGE_SHIFT) - 1, 1)):
        assert fold_geometry(E, R).n_ranges == 1


def test_k3_shape_needs_int64_offsets():
    """At K3's shape each plane is 1.07G cells (4.28 GB): the byte offset
    of the last range passes 2^31, so the kernels index cells in int64;
    the grid still fits."""
    C, n_ranges, _ = fold_geometry(K3_E, K3_R)
    assert n_ranges == 130_500
    last_base = (n_ranges - 1) * C
    assert last_base < K3_E * K3_R <= last_base + C
    assert last_base * 4 >= 2**31
    # a plane past 2^31 cells: the range index still fits int32
    E, R = 70_000, 40_000
    C, n_ranges, _ = fold_geometry(E, R)
    assert E * R > 2**31 and (n_ranges - 1) * C > 2**31 and n_ranges < 2**31
    with pytest.raises(ValueError, match="int32 grid"):
        fold_geometry(1 << 22, 1 << 22)


def test_config_3_counts_rows_in_shared_memory_and_k3_does_not():
    """The row passes count in shared memory up to DENSE_RANGES_MAX ranges
    (config 3: 5,000) and fall back to one global atomic per row past it
    (K3's shape: 130,500); a bin block keeps the clock in shared memory up
    to CLOCK_SMEM_MAX replicas (config 3's 10,000, not K3's 261,000)."""
    assert fold_geometry(4096, 10_000).n_ranges <= DENSE_RANGES_MAX
    assert fold_geometry(K3_E, K3_R).n_ranges > DENSE_RANGES_MAX
    assert 10_000 <= CLOCK_SMEM_MAX < K3_R
    assert 4 * (DENSE_RANGES_MAX + CLOCK_SMEM_MAX) * 2 <= 227 * 1024
