"""The port's LWW-map ops (crdt_enc_tpu_torch/ops/lww.py) against the JAX
package's, on the CPU.

The same numpy inputs, made from a seed, go through the JAX ``lww_fold``
(both modes: the packed (actor, value) rank with ``num_values``, and the
4-cascade without), the Pallas ``lww_fold_pallas`` in interpret mode
(packed mode, as tests/test_pallas_lww.py runs it), and the port's
``lww_fold``.  Every output is an int32 or bool table, so the tolerance is
exact equality.  Interpret shapes stay small (N ≤ 4,096, K ≤ 20,000).

On CPU tensors the kernel wrapper ``lww_fold_cuda`` runs the plain
cascade, so its shape handling is checked here too; the kernel itself is
checked on the card by tests/test_torch_kernels.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crdt_enc_tpu.ops import lww as J
from crdt_enc_tpu.ops.pallas_lww import lww_fold_pallas, lww_tile_cap

from crdt_enc_tpu_torch.ops import lww as P
from crdt_enc_tpu_torch.ops.lww_fold_cuda import lww_fold_cuda

from _hyp import given, settings, st  # hypothesis, or skip-stubs

NAMES = ("hi", "lo", "actor", "value", "present")
HI31 = (1 << 31) - 1


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def assert_tables_equal(ref, got):
    assert len(ref) == len(got) == 5
    for r, g, name in zip(ref, got, NAMES):
        r = np.asarray(r)
        g = g.numpy()
        assert g.dtype == (bool if name == "present" else np.int32), name
        np.testing.assert_array_equal(r, g, err_msg=name)


def gen(N, K, R, V, seed, ts_max=10 ** 12, pad_frac=0.05):
    rng = np.random.default_rng(seed)
    key = rng.integers(0, K, N, dtype=np.int32)
    key = np.where(rng.random(N) < pad_frac, K, key).astype(np.int32)
    hi, lo = P.ts_split(rng.integers(0, ts_max, N))
    actor = rng.integers(0, R, N, dtype=np.int32)
    value = rng.integers(0, V, N, dtype=np.int32)
    return key, hi, lo, actor, value


def heavy_ties():
    rng = np.random.default_rng(9)
    N, K, R, V = 600, 64, 6, 4
    key = rng.integers(0, K, N, dtype=np.int32)
    hi = np.zeros(N, np.int32)
    lo = rng.integers(0, 3, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    value = rng.integers(0, V, N, dtype=np.int32)
    return (key, hi, lo, actor, value), K, V


def zero_ts():
    key = np.array([0, 3, 10, 10], np.int32)  # two pad rows
    z = np.zeros(4, np.int32)
    return (key, z, z, np.array([1, 0, 0, 0], np.int32),
            np.array([2, 1, 0, 0], np.int32)), 10, 3


def all_pad():
    z = np.zeros(8, np.int32)
    return (np.full(8, 10, np.int32), z, z, z, z), 10, 3


def ts_lo_saturated():
    key = np.array([0, 0, 5], np.int32)
    hi = np.array([0, 7, HI31], np.int32)
    lo = np.array([HI31, HI31, HI31], np.int32)
    return (key, hi, lo, np.array([1, 0, 0], np.int32),
            np.array([2, 1, 0], np.int32)), 8, 3


def large_ts_hi():
    rng = np.random.default_rng(11)
    N, K, R, V = 400, 128, 5, 7
    key = rng.integers(0, K, N, dtype=np.int32)
    hi, lo = P.ts_split(rng.integers(2 ** 55, 2 ** 61, N))
    actor = rng.integers(0, R, N, dtype=np.int32)
    value = rng.integers(0, V, N, dtype=np.int32)
    return (key, hi, lo, actor, value), K, V


def random_case(N, K, R, V, seed):
    return lambda: (gen(N, K, R, V, seed), K, V)


CASES = {
    "random_small_k": random_case(500, 300, 20, 10, 0),
    "random_one_tile": random_case(800, 16384, 8, 5, 1),
    "random_two_tiles": random_case(1200, 20000, 30, 50, 2),
    "random_dense": random_case(4096, 700, 40, 30, 3),
    "heavy_ties": heavy_ties,
    "zero_ts": zero_ts,
    "all_pad": all_pad,
    "ts_lo_saturated": ts_lo_saturated,
    "large_ts_hi": large_ts_hi,
}


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_matches_jax(case, packed):
    cols, K, V = CASES[case]()
    nv = V if packed else None
    ref = J.lww_fold(*cols, num_keys=K, num_values=nv)
    assert_tables_equal(ref, P.lww_fold(*t(*cols), num_keys=K, num_values=nv))
    # the kernel wrapper on CPU tensors: the plain cascade
    assert_tables_equal(ref, lww_fold_cuda(*t(*cols), num_keys=K,
                                           num_values=nv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_matches_pallas_interpret(case):
    cols, K, V = CASES[case]()
    ref = lww_fold_pallas(*cols, num_keys=K, num_values=V,
                          tile_cap=lww_tile_cap(cols[0], K), interpret=True)
    assert_tables_equal(ref, P.lww_fold(*t(*cols), num_keys=K, num_values=V))


@settings(max_examples=25, deadline=None)
@given(
    seed=st.integers(0, 2 ** 16),
    n=st.integers(1, 400),
    k=st.integers(1, 20000),
    r=st.integers(1, 40),
    v=st.integers(1, 40),
)
def test_fold_hypothesis(seed, n, k, r, v):
    cols = gen(n, k, r, v, seed)
    ref = lww_fold_pallas(*cols, num_keys=k, num_values=v,
                          tile_cap=lww_tile_cap(cols[0], k), interpret=True)
    for nv in (v, None):
        assert_tables_equal(ref, P.lww_fold(*t(*cols), num_keys=k,
                                            num_values=nv))


def test_packed_and_unpacked_modes_pick_the_same_winner():
    cols = gen(3000, 900, 25, 13, 5)
    packed = P.lww_fold(*t(*cols), num_keys=900, num_values=13)
    full = P.lww_fold(*t(*cols), num_keys=900)
    assert_tables_equal([x.numpy() for x in full], packed)


def test_negative_keys_drop_out():
    key = np.array([-1, 2, -5], np.int32)
    ones = np.ones(3, np.int32)
    got = P.lww_fold(*t(key, ones, ones, ones, ones), num_keys=4)
    assert got[4].tolist() == [False, False, True, False]
    assert got[0].tolist() == [-1, -1, 1, -1]


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_fold_into_matches_jax_and_the_whole_fold(seed, packed):
    """fold(A ++ B) == fold_into(fold(A), B), on both packages."""
    rng = np.random.default_rng(11 + seed)
    Kn, n = 8, 64
    key = rng.integers(0, Kn, n).astype(np.int32)
    ts_hi = rng.integers(0, 4, n).astype(np.int32)
    ts_lo = rng.integers(0, 100, n).astype(np.int32)
    actor = rng.integers(0, 5, n).astype(np.int32)
    value = rng.integers(0, 20, n).astype(np.int32)
    kw = dict(num_keys=Kn, num_values=20 if packed else None)
    cols = (key, ts_hi, ts_lo, actor, value)
    h = n // 2
    first, second = [c[:h] for c in cols], [c[h:] for c in cols]
    ref = J.lww_fold_into(J.lww_fold(*first, **kw), *second, **kw)
    got = P.lww_fold_into(P.lww_fold(*t(*first), **kw), *t(*second), **kw)
    assert_tables_equal(ref, got)
    assert_tables_equal([x.numpy() for x in P.lww_fold(*t(*cols), **kw)], got)


def winner_table(seed, K):
    rng = np.random.default_rng(seed)
    present = rng.random(K) < 0.7
    cols = [np.where(present, rng.integers(0, 4, K), -1).astype(np.int32)
            for _ in range(4)]
    return (*cols, present)


@pytest.mark.parametrize("seed", range(4))
def test_table_merge_and_wins_match_jax(seed):
    a, b = winner_table(seed, 200), winner_table(100 + seed, 200)
    assert_tables_equal(J.lww_table_merge(a, b),
                        P.lww_table_merge(tuple(t(*a)), tuple(t(*b))))
    np.testing.assert_array_equal(
        np.asarray(J.lww_table_wins(a, b)),
        P.lww_table_wins(tuple(t(*a)), tuple(t(*b))).numpy())


def test_ts_split_matches_jax():
    ts = np.array([0, 1, HI31, HI31 + 1, (1 << 62) - 1], np.int64)
    for r, g in zip(J.ts_split(ts), P.ts_split(ts)):
        np.testing.assert_array_equal(r, g)
        assert g.dtype == np.int32
    with pytest.raises(ValueError, match="2\\^62"):
        P.ts_split([1 << 62])
    with pytest.raises(ValueError, match="2\\^62"):
        P.ts_split([-1])


def test_mixed_devices_never_reach_the_plain_path():
    cols, K, V = CASES["zero_ts"]()
    ts = t(*cols)
    ts[2] = ts[2].to("meta")
    with pytest.raises(ValueError, match="different devices"):
        P.lww_fold(*ts, num_keys=K)
    with pytest.raises(ValueError, match="plain path takes CPU"):
        P.lww_fold(*(x.to("meta") for x in t(*cols)), num_keys=K)
