"""Each CUDA kernel of the port against its plain PyTorch version.

Tests marked ``cuda`` need the card: they skip, with the reason, where
``torch.cuda.is_available()`` is False, and run on a machine with an
H100 via ``python -m pytest tests/test_torch_kernels.py``.  The build
and dispatch checks above them run anywhere.  This file imports nothing
of JAX: the machine with the card has none.

All outputs are int32 planes or tables (and a bool ``present``), so the
tolerance is exact equality.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from crdt_enc_tpu_torch.ops import cuda_build
from crdt_enc_tpu_torch.ops import lww as L
from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
from crdt_enc_tpu_torch.ops import orset_merge_cuda as M


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def rows(N, E, R, seed, *, hi=1 << 20, pad_frac=0.1, device="cpu"):
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < 0.3).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    actor = np.where(rng.random(N) < pad_frac, R, actor).astype(np.int32)
    counter = rng.integers(1, hi, N, dtype=np.int32)
    return [torch.from_numpy(x).to(device) for x in (kind, member, actor, counter)]


def state(E, R, seed, *, hi=1 << 20, device="cpu"):
    rng = np.random.default_rng(seed + 7)
    clock0 = rng.integers(0, hi, R).astype(np.int32)
    add0 = np.where(rng.random((E, R)) < 0.2, rng.integers(1, hi, (E, R)), 0)
    add0 = np.minimum(add0, clock0[None, :])
    rm0 = np.where(rng.random((E, R)) < 0.1, rng.integers(1, hi, (E, R)), 0)
    add0 = np.where(add0 > rm0, add0, 0)
    rm0 = np.where(rm0 > clock0[None, :], rm0, 0)
    return [torch.from_numpy(x.astype(np.int32)).to(device)
            for x in (clock0, add0, rm0)]


def assert_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == torch.int32
        assert torch.equal(x.cpu(), y.cpu())


# ---- anywhere: build and dispatch ------------------------------------------


def test_library_name_tracks_source_and_flags():
    p = cuda_build.lib_path("orset_fold")
    assert p.parent == cuda_build.BUILD and p.name.startswith("liborset_fold-")
    assert p != cuda_build.lib_path("orset_merge")


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails (here ``false``) raises with its output."""
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="CUDA kernel build failed"):
        cuda_build.build(["orset_fold"])
    assert not list(tmp_path.iterdir())


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc()


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = (dict(F.launches), dict(M.launches), set(cuda_build._libs))
    E, R = 6, 11
    clock0, add0, rm0 = state(E, R, 1)
    got = F.orset_fold_cuda(clock0, add0, rm0, *rows(90, E, R, 1),
                            num_members=E, num_replicas=R)
    ref = P.orset_fold_plain(clock0, add0, rm0, *rows(90, E, R, 1),
                             num_members=E, num_replicas=R)
    assert_equal(ref, got)
    assert (F.launches, M.launches, set(cuda_build._libs)) == before


def test_lww_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = (dict(LC.launches), set(cuda_build._libs))
    cols, K, V = lww_batch("random", device="cpu")
    for nv in (V, None):
        got = LC.lww_fold_cuda(*cols, num_keys=K, num_values=nv)
        assert_tables_equal(L.lww_fold_plain(*cols, num_keys=K, num_values=nv),
                            got)
    assert (LC.launches, set(cuda_build._libs)) == before


# ---- on the card ---------------------------------------------------------


# name -> (N, E, R, how the rows are bent).  C = 8,192 cells per range.
CASES = {
    "small": (5000, 40, 300, None),
    "wide": (20000, 257, 1000, None),
    "tiny": (7, 3, 5, None),
    "R_past_one_range": (30000, 7, 9000, None),
    "ragged_last_range": (20000, 13, 1001, None),
    "E_is_1": (3000, 1, 20000, None),
    "R_is_1": (3000, 20000, 1, None),
    "no_rows": (0, 9, 700, None),
    "all_padding": (4000, 9, 700, "all_padding"),
    "counters_near_int32_max": (20000, 50, 600, "near_max"),
    "counters_le_0": (20000, 50, 600, "nonpositive"),
    "other_kinds": (20000, 50, 600, "other_kinds"),
    "negative_member_and_actor": (20000, 50, 600, "negative"),
    "hot_member": (40000, 64, 9000, "hot_member"),
    "hot_cell": (40000, 64, 900, "hot_cell"),
}


def case_rows(case, device):
    """The rows of a CASES entry, on ``device``."""
    N, E, R, bend = CASES[case]
    kind, member, actor, counter = (x.numpy() for x in rows(N, E, R, N + E))
    rng = np.random.default_rng(N + R)
    half = rng.random(N) < 0.5
    if bend == "all_padding":
        actor = np.full(N, R, np.int32)
    elif bend == "near_max":
        counter = rng.integers((1 << 31) - 100, (1 << 31) - 1, N,
                               endpoint=True).astype(np.int32)
    elif bend == "nonpositive":
        counter = np.where(half, counter, rng.integers(-5, 1, N)).astype(np.int32)
    elif bend == "other_kinds":
        kind = np.where(half, kind, rng.integers(-3, 6, N)).astype(np.int8)
    elif bend == "negative":
        member = np.where(rng.random(N) < 0.2, -1 - member, member).astype(np.int32)
        actor = np.where(rng.random(N) < 0.2, -1 - actor, actor).astype(np.int32)
    elif bend == "hot_member":
        member = np.where(half, 3, member).astype(np.int32)
    elif bend == "hot_cell":
        member = np.where(half, 5, member).astype(np.int32)
        actor = np.where(half, 7, actor).astype(np.int32)
    cols = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in (kind, member, actor, counter)]
    return cols, E, R


@pytest.fixture(params=["shared", "global"])
def row_path(request, monkeypatch):
    """The row passes' two routes: counts and clock in shared memory (every
    shape here has few ranges and replicas), or forced to one global
    atomic per row, the route of shapes past DENSE_RANGES_MAX ranges and
    CLOCK_SMEM_MAX replicas."""
    if request.param == "global":
        monkeypatch.setattr(F, "DENSE_RANGES_MAX", 0)
        monkeypatch.setattr(F, "CLOCK_SMEM_MAX", 0)
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("with_clock", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_scatter_matches_plain(dev, row_path, case, with_clock):
    cols, E, R = case_rows(case, dev)
    clock0 = state(E, R, 1, device=dev)[0]
    clock = clock0.clone() if with_clock else None
    n0 = F.launches["orset_scatter"]
    got = F.orset_scatter(*cols, num_members=E, num_replicas=R, clock=clock)
    assert F.launches["orset_scatter"] == n0 + 1
    ref = P.orset_scatter_plain(*cols, num_members=E, num_replicas=R)
    assert_equal(ref, got)
    if with_clock:
        # the clock the bin pass finished: max(clock0, max add counter)
        ref_clock = P.orset_fold_clock_plain(clock0, ref[0])
        torch.cuda.synchronize()
        assert torch.equal(clock, ref_clock)


@pytest.mark.cuda
@pytest.mark.parametrize("retire_rm", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tail_matches_plain(dev, row_path, case, retire_rm):
    """The fold entry, whose range kernel applies the tail formula in its
    epilogue, against the plain fold over a prior state."""
    cols, E, R = case_rows(case, dev)
    planes = state(E, R, 2, device=dev)
    kw = dict(num_members=E, num_replicas=R, retire_rm=retire_rm)
    n0 = F.launches["orset_fold"]
    got = F.orset_fold_cuda(*planes, *cols, **kw)
    assert F.launches["orset_fold"] == n0 + 1
    assert_equal(P.orset_fold_plain(*planes, *cols, **kw), got)


@pytest.mark.cuda
def test_fold_of_misaligned_planes_takes_the_scalar_walk(dev):
    """Prior planes that start 4 bytes past a 16-byte boundary (contiguous
    views at an odd offset) leave the int4 walk for the scalar one."""
    cols, E, R = case_rows("ragged_last_range", dev)
    clock0, add0, rm0 = state(E, R, 3, device=dev)
    shifted = []
    for x in (add0, rm0):
        buf = torch.empty(E * R + 1, dtype=torch.int32, device=dev)
        buf[1:] = x.reshape(-1)
        shifted.append(buf[1:].view(E, R))
    assert shifted[0].data_ptr() % 16
    kw = dict(num_members=E, num_replicas=R)
    assert_equal(P.orset_fold_plain(clock0, add0, rm0, *cols, **kw),
                 F.orset_fold_cuda(clock0, *shifted, *cols, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("retire_rm", [True, False])
def test_fold_matches_plain(dev, retire_rm):
    E, R = 300, 1200
    planes = state(E, R, 3, device=dev)
    cols = rows(100000, E, R, 3, device=dev)
    kw = dict(num_members=E, num_replicas=R, retire_rm=retire_rm)
    assert_equal(P.orset_fold_plain(*planes, *cols, **kw),
                 P.orset_fold(*planes, *cols, **kw))


def canonical_stack(S, E, R, dev):
    base = state(E, R, 4, hi=5000, device=dev)
    outs = [P.orset_fold_plain(*base, *rows(3000, E, R, 40 + s, hi=9000,
                                            device=dev),
                               num_members=E, num_replicas=R)
            for s in range(S)]
    return [torch.stack([o[i] for o in outs]) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_merge_matches_plain_tree(dev, S):
    stacks = canonical_stack(S, 70, 513, dev)
    n0 = M.launches["orset_merge_many"]
    got = P.orset_merge_many(*stacks)
    assert M.launches["orset_merge_many"] == n0 + 1
    assert_equal(P.orset_merge_many_tree(*stacks), got)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain path reached with CUDA tensors")

    for name in ("orset_scatter_plain", "orset_fold_plain"):
        monkeypatch.setattr(F, name, refuse)
    for name in ("orset_fold_plain", "orset_merge_many_tree"):
        monkeypatch.setattr(P, name, refuse)
    monkeypatch.setattr(M, "orset_merge_many_tree", refuse)
    E, R = 20, 50
    planes = state(E, R, 5, device=dev)
    P.orset_fold(*planes, *rows(500, E, R, 5, device=dev),
                 num_members=E, num_replicas=R)
    P.orset_merge_many(*(x.unsqueeze(0).expand(3, *x.shape).contiguous()
                         for x in planes))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_refuse_bad_inputs(dev):
    E, R = 4, 9
    kind, member, actor, counter = rows(50, E, R, 6, device=dev)
    with pytest.raises(TypeError, match="kind"):
        F.orset_scatter(kind.to(torch.int32), member, actor, counter,
                        num_members=E, num_replicas=R)
    with pytest.raises(ValueError, match="member"):
        F.orset_scatter(kind, member[:10], actor, counter,
                        num_members=E, num_replicas=R)
    clock0, add0, rm0 = state(E, R, 6, device=dev)
    kw = dict(num_members=E, num_replicas=R)
    with pytest.raises(ValueError, match="contiguous"):
        F.orset_fold_cuda(clock0, add0.t().contiguous().t(), rm0, kind,
                          member, actor, counter, **kw)
    with pytest.raises(ValueError, match="rm0"):
        F.orset_fold_cuda(clock0, add0, rm0[:2], kind, member, actor,
                          counter, **kw)
    with pytest.raises(ValueError, match="different devices"):
        F.orset_fold_cuda(clock0.cpu(), add0, rm0, kind, member, actor,
                          counter, **kw)
    with pytest.raises(ValueError, match="clocks"):
        M.orset_merge_many_cuda(clock0[None, :4], add0[None], rm0[None])


# ---- the LWW winner fold ---------------------------------------------------

HI31 = (1 << 31) - 1


def lww_batch(name, *, device, N=20000):
    """The smoke run's batches at small size: config-4-like random writes,
    heavy ties with 5% padding rows, and saturated timestamps."""
    rng = np.random.default_rng({"random": 4, "ties": 5, "saturated": 6}[name])
    if name == "random":
        K, R, V = 15000, 300, 100
        key = rng.integers(0, K, N, dtype=np.int32)
        hi, lo = L.ts_split(rng.integers(1, 1 << 40, N))
    elif name == "ties":
        K, R, V = 50, 16, 4
        key = rng.integers(0, K, N, dtype=np.int32)
        key = np.where(rng.random(N) < 0.05, K, key).astype(np.int32)
        hi, lo = L.ts_split(rng.integers(0, 4, N))
    else:
        K, R, V = 3000, 40, 9
        key = rng.integers(0, K, N, dtype=np.int32)
        hi = rng.integers(HI31 - 3, HI31, N, endpoint=True).astype(np.int32)
        lo = np.full(N, HI31, np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    value = rng.integers(0, V, N, dtype=np.int32)
    cols = [torch.from_numpy(x).to(device) for x in (key, hi, lo, actor, value)]
    return cols, K, V


def assert_tables_equal(ref, got):
    assert len(ref) == len(got) == 5
    for i, (x, y) in enumerate(zip(ref, got)):
        assert x.dtype == y.dtype == (torch.bool if i == 4 else torch.int32)
        assert torch.equal(x.cpu(), y.cpu())


@pytest.fixture(params=["shared", "global"])
def lww_route(request, monkeypatch):
    """The LWW fold's two routes, forced: each block folds its rows in
    shared memory first (the first TILE_KEYS_MAX keys where K is larger,
    the rest straight to the global table), or every row goes straight to
    the global table."""
    shared = request.param == "shared"
    monkeypatch.setattr(LC, "SHARED_KEYS_MAX", 2**31 - 1 if shared else 0)
    return request.param


@pytest.fixture(params=["one word", "two words"])
def lww_mode(request, monkeypatch):
    """The LWW fold's two modes: one packed (t, actor, value) word a key
    where the batch's widths fit 64 bits, or forced to two words a key
    (max t, then max (actor, value) among its rows)."""
    if request.param == "two words":
        monkeypatch.setattr(LC, "PACK_BITS", 0)
    return request.param


def fold_on_route(cols, K, nv, route):
    """The dispatch's fold, checked to take ``route`` and launch once."""
    assert (LC.plan(cols[0].shape[0], K, cols[0].device).tile_keys > 0) == (
        route == "shared")
    n0 = LC.launches["lww_fold"]
    got = L.lww_fold(*cols, num_keys=K, num_values=nv)
    assert LC.launches["lww_fold"] == n0 + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("name", ["random", "ties", "saturated"])
def test_lww_fold_matches_plain(dev, lww_route, lww_mode, name, packed):
    cols, K, V = lww_batch(name, device=dev)
    nv = V if packed else None
    got = fold_on_route(cols, K, nv, lww_route)
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=K, num_values=nv), got)


@pytest.mark.cuda
def test_lww_fold_past_register_residency(dev, lww_route, lww_mode):
    """More rows than the grid keeps in registers: phases 1 and 2 loop
    over chunks, and phase 2 re-reads all but the last."""
    cols, K, V = lww_batch("random", device=dev, N=3_000_000)
    geo = LC.plan(cols[0].shape[0], K, dev)
    assert geo.chunks > 1 and geo.rows_per_thread == LC.ROWS_MAX
    got = fold_on_route(cols, K, V, lww_route)
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=K, num_values=V), got)


@pytest.mark.cuda
def test_lww_fold_one_key(dev, lww_route, lww_mode):
    rng = np.random.default_rng(13)
    N = 5000
    key = rng.integers(-2, 3, N).astype(np.int32)  # K = 1: keys 0 only
    cols = [torch.from_numpy(x).to(dev) for x in (
        key, rng.integers(0, 3, N).astype(np.int32),
        rng.integers(0, 3, N).astype(np.int32),
        rng.integers(0, 5, N).astype(np.int32),
        rng.integers(0, 5, N).astype(np.int32))]
    got = fold_on_route(cols, 1, None, lww_route)
    assert got[4].cpu().tolist() == [True]
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=1), got)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_lww_fold_every_row_on_one_key(dev, lww_route, lww_mode, packed):
    """The LWW register's bulk fold: config 4's 1,000,000 writes (10,000
    actors, timestamps below 2^40, 100 values) all on key 0, so every row
    contends for one slot (one-key tile on the shared route)."""
    rng = np.random.default_rng(4)
    N, R, V = 1_000_000, 10_000, 100
    hi, lo = L.ts_split(rng.integers(1, 1 << 40, N))
    cols = [torch.from_numpy(x).to(dev) for x in (
        np.zeros(N, np.int32), hi, lo,
        rng.integers(0, R, N, dtype=np.int32),
        rng.integers(0, V, N, dtype=np.int32))]
    nv = V if packed else None
    got = fold_on_route(cols, 1, nv, lww_route)
    assert got[4].cpu().tolist() == [True]
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=1, num_values=nv), got)


@pytest.mark.cuda
def test_lwwreg_fold_payloads_launches_the_kernel_once(dev):
    """``TorchAccelerator().fold_payloads`` folds an LWW register's op
    files with one ``lww_fold`` launch at one key, equal to the host
    loop."""
    import uuid

    from crdt_enc_tpu_torch import TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.models import LWWReg
    from crdt_enc_tpu_torch.utils import codec

    rng = np.random.default_rng(5)
    actors = [uuid.UUID(int=i + 1).bytes for i in range(50)]
    ops = [[int(t), actors[int(a)], int(v)] for t, a, v in zip(
        rng.integers(0, 1 << 40, 5000), rng.integers(0, 50, 5000),
        rng.integers(0, 100, 5000))]
    payloads = [codec.pack(ops[i : i + 48]) for i in range(0, len(ops), 48)]
    host = LWWReg()
    for o in ops:
        host.apply(o)
    got = LWWReg()
    n0 = LC.launches["lww_fold"]
    assert TorchAccelerator(device=dev).fold_payloads(got, payloads)
    assert LC.launches["lww_fold"] == n0 + 1
    assert canonical_bytes(got) == canonical_bytes(host)


@pytest.mark.cuda
@pytest.mark.parametrize("above", [0, 1])
def test_lww_fold_at_the_shared_threshold(dev, lww_mode, above):
    """K at SHARED_KEYS_MAX takes the shared route, one key more the
    global one, with the module's own threshold."""
    K = LC.SHARED_KEYS_MAX + above
    cols, _, V = lww_batch("random", device=dev, N=60000)
    cols[0] = cols[0] % K
    got = fold_on_route(cols, K, V, "global" if above else "shared")
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=K, num_values=V), got)


@pytest.mark.cuda
def test_lww_fold_of_unaligned_columns(dev, lww_route, lww_mode):
    """Column views that start 4 bytes past an allocation's start."""
    cols, K, V = lww_batch("ties", device=dev, N=20001)
    cols = [c[1:] for c in cols]
    assert cols[0].data_ptr() % 16
    got = fold_on_route(cols, K, V, lww_route)
    assert_tables_equal(L.lww_fold_plain(*cols, num_keys=K, num_values=V), got)


@pytest.mark.cuda
def test_lww_fold_launches_once_per_call(dev):
    cols, K, V = lww_batch("random", device=dev, N=1000)
    n0 = LC.launches["lww_fold"]
    for nv in (V, None, V):
        L.lww_fold(*cols, num_keys=K, num_values=nv)
    assert LC.launches["lww_fold"] == n0 + 3
    got = L.lww_fold(*cols, num_keys=0)  # no key: nothing to launch
    assert LC.launches["lww_fold"] == n0 + 3
    assert [tuple(x.shape) for x in got] == [(0,)] * 5


@pytest.mark.cuda
def test_lww_fold_into_halves_equals_the_whole(dev):
    cols, K, V = lww_batch("ties", device=dev)
    h = cols[0].shape[0] // 2
    first, second = [c[:h] for c in cols], [c[h:] for c in cols]
    got = L.lww_fold_into(L.lww_fold(*first, num_keys=K, num_values=V),
                          *second, num_keys=K, num_values=V)
    assert_tables_equal(L.lww_fold(*cols, num_keys=K, num_values=V), got)


@pytest.mark.cuda
def test_lww_zero_ts_and_all_padding(dev):
    z = torch.zeros(4, dtype=torch.int32, device=dev)
    key = torch.tensor([0, 3, 10, 10], dtype=torch.int32, device=dev)
    got = L.lww_fold(key, z, z, z, z, num_keys=10)
    assert got[4].cpu().tolist() == [True, False, False, True] + [False] * 6
    assert_tables_equal(L.lww_fold_plain(key, z, z, z, z, num_keys=10), got)
    pad = torch.full((4,), 10, dtype=torch.int32, device=dev)
    assert not L.lww_fold(pad, z, z, z, z, num_keys=10)[4].any()
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    assert_tables_equal(L.lww_fold_plain(*[empty] * 5, num_keys=7),
                        L.lww_fold(*[empty] * 5, num_keys=7))


@pytest.mark.cuda
def test_lww_cuda_tensors_never_take_the_plain_path(dev, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("plain path reached with CUDA tensors")

    monkeypatch.setattr(L, "lww_fold_plain", refuse)
    monkeypatch.setattr(LC, "lww_fold_plain", refuse)
    cols, K, V = lww_batch("random", device=dev, N=500)
    L.lww_fold(*cols, num_keys=K, num_values=V)
    L.lww_fold(*cols, num_keys=K)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_lww_wrapper_refuses_bad_inputs(dev):
    cols, K, V = lww_batch("random", device=dev, N=64)
    with pytest.raises(TypeError, match="ts_hi"):
        LC.lww_fold_cuda(cols[0], cols[1].long(), *cols[2:], num_keys=K)
    with pytest.raises(ValueError, match="value"):
        LC.lww_fold_cuda(*cols[:4], cols[4][:10], num_keys=K)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([cols[1], cols[1]], dim=1)[:, 0]
        LC.lww_fold_cuda(cols[0], strided, *cols[2:], num_keys=K)
    with pytest.raises(ValueError, match="different devices"):
        LC.lww_fold_cuda(cols[0].cpu(), *cols[1:], num_keys=K)


@pytest.mark.cuda
def test_core_compaction_on_the_card_matches_the_host_loop(dev, tmp_path):
    """``Core.compact()`` over a small encrypted fs remote (three
    snapshots, 24 op files past them) with ``TorchAccelerator()`` gives
    the host loop's bytes, through one fold launch and one merge launch."""
    import asyncio
    import shutil

    import crdt_enc_tpu_torch as T
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    def opts(local, remote, accel):
        return T.OpenOptions(
            storage=T.FsStorage(str(tmp_path / local), str(remote)),
            cryptor=T.XChaChaCryptor(), key_cryptor=T.PlainKeyCryptor(),
            adapter=T.orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=True,
            accelerator=accel)

    async def go():
        remote = tmp_path / "remote"
        writers = [await T.Core.open(opts(f"w{i}", remote, T.HostAccelerator()))
                   for i in range(3)]
        for rnd in range(3):
            for i in range(24):
                w = writers[i % 3]
                m = (rnd * 5 + i) % 11
                await w.update(lambda s, m=m, w=w, i=i: s.rm_ctx(m)
                               if i % 4 == 3 and s.entries.get(m)
                               else s.add_ctx(w.actor_id, m))
            if rnd == 1:
                for w in writers:
                    await w._compact_seal()
        shutil.copytree(remote, tmp_path / "host_remote")
        card = await T.Core.open(opts("card", remote, T.TorchAccelerator()))
        host = await T.Core.open(opts("host", tmp_path / "host_remote",
                                      T.HostAccelerator()))
        before = F.launches["orset_fold"], M.launches["orset_merge_many"]
        await card.compact()
        after = F.launches["orset_fold"], M.launches["orset_merge_many"]
        await host.compact()
        assert card.with_state(T.canonical_bytes) == host.with_state(T.canonical_bytes)
        assert (after[0] - before[0], after[1] - before[1]) == (1, 1)
        fresh = await T.Core.open(opts("fresh", remote, T.HostAccelerator()))
        await fresh.read_remote()
        assert fresh.with_state(T.canonical_bytes) == card.with_state(T.canonical_bytes)

    asyncio.run(go())


# ---- the blockwise stream and the fold sessions ---------------------------


def ordered_rows(N, E, R, seed):
    """An op history in per-actor version order (the contract of the
    chunked folds): adds take each actor's next dot, removes the horizon
    seen so far, removes before an actor's first add become sentinel rows
    (``actor == R``); numpy columns."""
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < 0.1).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    is_add = (kind == 0).astype(np.int64)
    counter = np.zeros(N, np.int64)
    for a in range(R):  # running add count per actor, in row order
        idx = np.flatnonzero(actor == a)
        counter[idx] = np.cumsum(is_add[idx])
    actor = np.where(counter == 0, R, actor).astype(np.int32)
    return kind, member, actor, counter.astype(np.int32)


def test_out_planes_on_the_cpu():
    """``orset_fold_cuda(out=...)`` writes the plain fold into the given
    triple on the CPU too, and returns it."""
    E, R = 6, 11
    planes = state(E, R, 2)
    cols = rows(90, E, R, 2)
    out = tuple(torch.empty_like(p) for p in planes)
    got = F.orset_fold_cuda(*planes, *cols, num_members=E, num_replicas=R,
                            out=out)
    assert all(g is o for g, o in zip(got, out))
    assert_equal(P.orset_fold_plain(*planes, *cols, num_members=E,
                                    num_replicas=R), got)


@pytest.mark.cuda
def test_out_planes_on_the_card(dev):
    E, R = 257, 1000
    planes = state(E, R, 3, device=dev)
    cols = rows(20000, E, R, 3, device=dev)
    ref = F.orset_fold_cuda(*planes, *cols, num_members=E, num_replicas=R)
    out = tuple(torch.full_like(p, -7) for p in planes)
    got = F.orset_fold_cuda(*planes, *cols, num_members=E, num_replicas=R,
                            out=out)
    torch.cuda.synchronize()
    assert all(g is o for g, o in zip(got, out))
    assert_equal(ref, got)
    with pytest.raises(ValueError, match="shares memory"):
        F.orset_fold_cuda(*planes, *cols, num_members=E, num_replicas=R,
                          out=planes)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_rows", [4096, 1 << 16])
def test_stream_fold_pool_reuse_under_a_side_stream(dev, chunk_rows):
    """Many pinned-pool chunks through the overlapped loop (uploads on a
    side stream, buffers recycled on the copy's event): equal to the
    plain fold of each chunk in turn on the CPU, one launch per chunk,
    repeated so a buffer recycled too early would show."""
    from crdt_enc_tpu_torch.ops import stream as S

    E, R, N = 300, 700, 200_000
    cols = ordered_rows(N, E, R, 5)
    z = [np.zeros(R, np.int32), np.zeros((E, R), np.int32),
         np.zeros((E, R), np.int32)]
    ref = S.planes_to_host(S.orset_fold_stream(
        *z, S.iter_orset_chunks(*cols, chunk_rows, R), num_members=E,
        num_replicas=R, device="cpu"))
    n_chunks = -(-N // chunk_rows)
    for _ in range(3):
        pool = S.ChunkPool(chunk_rows, depth=2, pin=True)
        before = F.launches["orset_fold"]
        got = S.planes_to_host(S.orset_fold_stream(
            *z, S.iter_orset_chunks(*cols, chunk_rows, R, pool=pool),
            num_members=E, num_replicas=R, device=dev, pool=pool))
        assert F.launches["orset_fold"] - before == n_chunks
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


@pytest.mark.cuda
def test_stream_upload_rides_under_the_previous_fold(dev):
    """Chunk k+1's upload is issued before chunk k's fold is enqueued."""
    from crdt_enc_tpu_torch.ops import stream as S
    from crdt_enc_tpu_torch.utils import trace

    E, R, rows_ = 64, 300, 8192
    cols = ordered_rows(5 * rows_, E, R, 6)
    pool = S.ChunkPool(rows_, depth=2, pin=True)
    trace.reset()
    trace.enable_events()
    try:
        S.planes_to_host(S.orset_fold_stream(
            np.zeros(R, np.int32), np.zeros((E, R), np.int32),
            np.zeros((E, R), np.int32),
            S.iter_orset_chunks(*cols, rows_, R, pool=pool), num_members=E,
            num_replicas=R, device=dev, pool=pool))
    finally:
        trace.enable_events(False)
    ev = trace.events()
    h2d = sorted((e for e in ev if e["name"] == "stream.h2d"), key=lambda e: e["meta"])
    folds = sorted((e for e in ev if e["name"] == "stream.fold"), key=lambda e: e["meta"])
    assert len(h2d) == len(folds) == 5
    for k in range(4):
        assert h2d[k + 1]["t1"] <= folds[k]["t0"]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fold_ops", "fold_payloads"])
def test_accelerator_past_the_stream_bound_on_the_card(dev, route):
    """``TorchAccelerator()`` past ``STREAM_CHUNK_ROWS`` folds blockwise on
    the card, one launch per chunk, equal to the host loop."""
    import crdt_enc_tpu_torch as T
    from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
    from crdt_enc_tpu_torch.models.vclock import Dot, VClock
    from crdt_enc_tpu_torch.utils import codec

    E, R, N = 50, 40, 6000
    kind, member, actor, counter = ordered_rows(N, E, R, 7)
    actors = sorted(bytes([a + 1]) * 16 for a in range(R))
    ops = [AddOp(int(m), Dot(actors[a], int(c))) if k == 0
           else RmOp(int(m), VClock({actors[a]: int(c)}))
           for k, m, a, c in zip(kind, member, actor, counter) if a < R]
    accel = T.TorchAccelerator(min_device_batch=1)
    accel.STREAM_CHUNK_ROWS = 1000
    host = T.HostAccelerator().fold_ops(T.ORSet(), list(ops))
    before = F.launches["orset_fold"]
    if route == "fold_ops":
        got = accel.fold_ops(T.ORSet(), list(ops))
    else:
        got = T.ORSet()
        payloads = [codec.pack([op.to_obj() for op in ops[lo : lo + 50]])
                    for lo in range(0, len(ops), 50)]
        assert accel.fold_payloads(got, payloads, actors_hint=actors)
    assert F.launches["orset_fold"] - before == -(-len(ops) // 1000)
    assert T.canonical_bytes(got) == T.canonical_bytes(host)


@pytest.mark.cuda
def test_device_stream_session_on_the_card(dev, monkeypatch):
    """A DEVICE_STREAM session on the card equals the same session on the
    CPU and the host loop; its launches equal its chunk count."""
    import crdt_enc_tpu_torch as T
    from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
    from crdt_enc_tpu_torch.models.vclock import Dot, VClock
    from crdt_enc_tpu_torch.parallel import session as PS
    from crdt_enc_tpu_torch.utils import codec

    monkeypatch.setattr(PS, "BUFFER_BYTES", 0)
    monkeypatch.setattr(PS, "HOST_PLANE_CELLS", -1)
    E, R, N = 70, 30, 8000
    kind, member, actor, counter = ordered_rows(N, E, R, 8)
    actors = sorted(bytes([a + 1]) * 16 for a in range(R))
    ops = [AddOp(int(m), Dot(actors[a], int(c))) if k == 0
           else RmOp(int(m), VClock({actors[a]: int(c)}))
           for k, m, a, c in zip(kind, member, actor, counter) if a < R]
    payloads = [codec.pack([op.to_obj() for op in ops[lo : lo + 40]])
                for lo in range(0, len(ops), 40)]
    host = T.HostAccelerator().fold_ops(T.ORSet(), list(ops))
    out = {}
    for device in ("cpu", "cuda"):
        s = PS.OrsetFoldSession(T.TorchAccelerator(device=device), T.ORSet(),
                                actors_hint=actors)
        before = F.launches["orset_fold"]
        for lo in range(0, len(payloads), 7):
            s.feed(payloads[lo : lo + 7])
        assert s.mode == "device_stream"
        out[device] = T.canonical_bytes(s.finish())
        if device == "cuda":
            assert F.launches["orset_fold"] - before == s.device_chunks > 0
    assert out["cpu"] == out["cuda"] == T.canonical_bytes(host)


# ---- the device plane cache ------------------------------------------------


def _cache_ops(N, E, R, seed, actors, base=0):
    from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
    from crdt_enc_tpu_torch.models.vclock import Dot, VClock

    kind, member, actor, counter = ordered_rows(N, E, R, seed)
    return [AddOp(int(m), Dot(actors[a], base + int(c))) if k == 0
            else RmOp(int(m), VClock({actors[a]: base + int(c)}))
            for k, m, a, c in zip(kind, member, actor, counter) if a < R]


@pytest.mark.cuda
def test_plane_cache_hit_uploads_only_the_op_columns(dev):
    """Round 2 on an unmutated state starts from the planes the card kept:
    ``h2d_bytes`` counts the op columns alone (13 bytes a row), and the
    state equals the host loop's."""
    import crdt_enc_tpu_torch as T
    from crdt_enc_tpu_torch.utils import trace

    E, R = 60, 40
    actors = sorted(bytes([a + 1]) * 16 for a in range(R))
    accel = T.TorchAccelerator(min_device_batch=1)
    state, host = T.ORSet(), T.ORSet()
    r1 = _cache_ops(3000, E, R, 21, actors)
    accel.fold_ops(state, r1)
    T.HostAccelerator().fold_ops(host, list(r1))
    assert accel._plane_cache is not None
    assert accel._plane_cache.planes[1].device.type == "cuda"
    r2 = _cache_ops(3000, E, R, 22, actors, base=1 << 21)
    trace.reset()
    before = F.launches["orset_fold"]
    accel.fold_ops(state, r2)
    T.HostAccelerator().fold_ops(host, list(r2))
    snap = trace.snapshot()
    assert "fold.planes" not in snap["spans"]
    assert "fold.vocab" not in snap["spans"]
    assert snap["counters"]["h2d_bytes"] == 13 * len(r2)
    assert F.launches["orset_fold"] - before == 1
    assert T.canonical_bytes(state) == T.canonical_bytes(host)


@pytest.mark.cuda
def test_cached_plane_launch_equals_a_cold_launch(dev):
    """The fold launched on cached (and padded) planes gives the bytes of
    a fold launched on planes built from the state."""
    import crdt_enc_tpu_torch as T

    E, R = 50, 30
    actors = sorted(bytes([a + 1]) * 16 for a in range(R + 4))
    r1 = _cache_ops(2500, E, R, 23, actors)
    r2 = _cache_ops(2500, E + 6, R + 4, 24, actors, base=1 << 21)
    warm = T.TorchAccelerator(min_device_batch=1)
    s_warm, s_cold = T.ORSet(), T.ORSet()
    for r in (r1, r2):
        warm.fold_ops(s_warm, r)
        # a fresh accelerator holds no planes: this fold builds them
        T.TorchAccelerator(min_device_batch=1).fold_ops(s_cold, r)
    clock, add, rm = warm._plane_cache.planes
    assert tuple(add.shape) == (E + 6, R + 4)
    assert T.canonical_bytes(s_warm) == T.canonical_bytes(s_cold)


@pytest.mark.cuda
def test_plane_cache_finalizer_frees_the_card(dev):
    import gc

    import crdt_enc_tpu_torch as T

    E, R = 400, 300
    actors = sorted(bytes([a % 250 + 1, a // 250]) * 8 for a in range(R))
    accel = T.TorchAccelerator(min_device_batch=1)
    state = T.ORSet()
    accel.fold_ops(state, _cache_ops(20000, E, R, 25, actors))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    plane_bytes = 2 * accel._plane_cache.planes[1].numel() * 4
    del state
    gc.collect()
    assert accel._plane_cache is None
    assert held - torch.cuda.memory_allocated() >= plane_bytes


# ---- the fold service's tenant layout: one K2 launch per bucket -------------


def tenant_batch(T, E, R, N, seed, *, device="cpu"):
    """T tenants' canonical planes and op rows.  Every tenant but the last
    carries padding rows (``actor == R``) whose counters exceed the next
    tenant's clock, so a padding row mapped into tenant t+1's column 0
    would show; the last two slots of T ≥ 4 are dummy slots (zero
    planes, all padding)."""
    rng = np.random.default_rng(seed)
    hi = 1 << 20
    clock0 = rng.integers(0, hi, (T, R)).astype(np.int32)
    add0 = np.where(rng.random((T, E, R)) < 0.2,
                    rng.integers(1, hi, (T, E, R)), 0)
    add0 = np.minimum(add0, clock0[:, None, :])
    rm0 = np.where(rng.random((T, E, R)) < 0.1,
                   rng.integers(1, 2 * hi, (T, E, R)), 0)
    add0 = np.where(add0 > rm0, add0, 0)
    rm0 = np.where(rm0 > clock0[:, None, :], rm0, 0)
    kind = (rng.random((T, N)) < 0.3).astype(np.int8)
    member = rng.integers(0, E, (T, N)).astype(np.int32)
    actor = rng.integers(0, R, (T, N)).astype(np.int32)
    counter = rng.integers(1, 2 * hi, (T, N)).astype(np.int32)
    pad = rng.random((T, N)) < 0.2
    pad[-1] = False
    actor[pad] = R
    counter[pad] = 4 * hi
    if T >= 4:
        clock0[-2:] = 0
        add0[-2:] = 0
        rm0[-2:] = 0
        actor[-2:] = R
    return [torch.from_numpy(x.astype(d)).to(device) for x, d in (
        (clock0, np.int32), (add0, np.int32), (rm0, np.int32), (kind, np.int8),
        (member, np.int32), (actor, np.int32), (counter, np.int32))]


def test_tenant_layout_on_cpu_tensors_launches_nothing():
    before = dict(F.launches)
    args = tenant_batch(5, 6, 4, 40, 1)
    got = P.orset_fold_tenants(*args, num_members=6, num_replicas=4)
    assert_equal(got, P.orset_fold_tenants_plain(*args, num_members=6,
                                                 num_replicas=4))
    assert F.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("T,E,R,N", [
    (1, 64, 8, 384),  # a bucket of one
    (7, 64, 8, 384),
    (1024, 64, 8, 384),  # the tenants cap at the serving shape
    (16, 1024, 1024, 32768),  # the cells cap: E·R = 2^20 per tenant
])
def test_tenant_layout_fold_matches_plain(dev, row_path, T, E, R, N):
    """The bucket fold (``orset_fold_tenants``: the tenants' planes side by
    side as ``(E, T·R)``, padding at the layout's sentinel ``T·R``) is ONE
    ``orset_fold`` launch and equals the per-tenant plain folds."""
    cpu = tenant_batch(T, E, R, N, T + E)
    want = P.orset_fold_tenants_plain(*cpu, num_members=E, num_replicas=R)
    before = F.launches["orset_fold"]
    got = P.orset_fold_tenants(*(x.to(dev) for x in cpu), num_members=E,
                               num_replicas=R)
    torch.cuda.synchronize()
    assert F.launches["orset_fold"] == before + 1
    assert_equal(got, want)


@pytest.mark.cuda
def test_gcounter_tenant_fold_on_the_card_matches_the_cpu(dev):
    from crdt_enc_tpu_torch.ops.counters import gcounter_fold_tenants

    rng = np.random.default_rng(4)
    T, R, N = 256, 8, 384
    clock0 = torch.from_numpy(rng.integers(0, 99, (T, R)).astype(np.int32))
    actor = torch.from_numpy(rng.integers(0, R + 1, (T, N)).astype(np.int32))
    counter = torch.from_numpy(rng.integers(1, 200, (T, N)).astype(np.int32))
    want = gcounter_fold_tenants(clock0, actor, counter, num_replicas=R)
    got = gcounter_fold_tenants(clock0.to(dev), actor.to(dev),
                                counter.to(dev), num_replicas=R)
    assert torch.equal(got.cpu(), want)


# ---- the fleet daemon ------------------------------------------------------


@pytest.mark.cuda
def test_fleet_daemon_cycle_launches_one_fold_per_bucket(dev, monkeypatch):
    """One ``FleetDaemon`` cycle over 64 small OR-Set tenants on the card
    launches ``orset_fold`` exactly once per OR-Set bucket the planner
    made (none spills at this size), and every tenant's bytes equal a
    copy of the fleet run by a daemon over ``HostAccelerator`` tenants."""
    import asyncio

    import crdt_enc_tpu_torch as T
    from crdt_enc_tpu_torch.serve import service as service_mod
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    plans = []
    real_plan = service_mod.plan_buckets

    def recording_plan(*args, **kw):
        plans.append(real_plan(*args, **kw))
        return plans[-1]

    monkeypatch.setattr(service_mod, "plan_buckets", recording_plan)

    def opts(storage, accel, create=True):
        return T.OpenOptions(
            storage=storage, cryptor=T.IdentityCryptor(),
            key_cryptor=T.PlainKeyCryptor(), adapter=T.orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=create,
            accelerator=accel)

    async def go():
        fleets = {"card": [], "host": []}
        for t in range(64):
            remote = T.MemoryRemote()
            w = await T.Core.open(opts(T.MemoryStorage(remote),
                                       T.HostAccelerator()))
            for i in range(12 + t % 9):
                m = b"t%d-%d" % (t, i % 7)
                await w.update(lambda s, m=m, w=w, i=i: s.rm_ctx(m)
                               if i % 5 == 4 and m in s.entries
                               else s.add_ctx(w.actor_id, m))
            ident = T.MemoryStorage(remote)
            await T.Core.open(opts(ident, T.HostAccelerator()))
            for arm, accel in (("card", T.TorchAccelerator()),
                               ("host", T.HostAccelerator())):
                copy = T.MemoryRemote(
                    metas=dict(remote.metas), states=dict(remote.states),
                    ops={a: dict(d) for a, d in remote.ops.items()})
                st = T.MemoryStorage(copy)
                st._local_meta = ident._local_meta
                fleets[arm].append(await T.Core.open(opts(st, accel,
                                                          create=False)))
        card = T.FleetDaemon(fleets["card"])
        host = T.FleetDaemon(fleets["host"])
        before = F.launches["orset_fold"]
        plans.clear()
        report = await card.run_cycle()
        launched = F.launches["orset_fold"] - before
        (buckets, solo), = plans
        host_report = await host.run_cycle()
        assert F.launches["orset_fold"] - before == launched
        assert solo == []
        assert launched == sum(b.kind == "orset" for b in buckets) >= 1
        assert len(report["selected"]) == 64
        assert all(r["outcome"] == "sealed" for r in report["results"].values())
        assert report["selected"] == host_report["selected"]
        for a, b in zip(fleets["card"], fleets["host"]):
            assert a.with_state(T.canonical_bytes) == b.with_state(
                T.canonical_bytes)
        await card.drain()
        await host.drain()

    asyncio.run(go())


# ---- the mesh on one card ------------------------------------------------------


def card_mesh(dev, dp, mp):
    from crdt_enc_tpu_torch.parallel import make_mesh

    return make_mesh((dp, mp), devices=[dev] * (dp * mp))


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(4, 1), (2, 2), (1, 4)])
def test_sharded_folds_launch_per_shard_on_the_card(dev, dp, mp):
    """On shards of one card each per-shard body launches its kernel: the
    whole-batch fold K1 dp·mp times, the streaming step K2 dp·mp times,
    the tenant fold K2 dp·mp times, the LWW fold K5 dp times; every
    result equals the plain version on the CPU."""
    from crdt_enc_tpu_torch.parallel import mesh as pmesh

    mesh = card_mesh(dev, dp, mp)
    E, R, N = 64, 96, 4000
    cpu_in = state(E, R, 3) + rows(N, E, R, 4)
    card_in = [x.to(dev) for x in cpu_in]
    for retire_rm in (True, False):
        plain = P.orset_fold_plain(*cpu_in, num_members=E, num_replicas=R,
                                   retire_rm=retire_rm)
        for impl, entry in (("scatter", "orset_scatter"),
                            ("fold", "orset_fold")):
            before = dict(F.launches)
            got = pmesh.orset_fold_sharded(mesh, *card_in, impl=impl,
                                           retire_rm=retire_rm)
            assert F.launches[entry] - before[entry] == dp * mp
            assert_equal(got, plain)
    clock0, add0, rm0, kind, member, actor, counter = tenant_batch(
        8, 16, 8, 40, 5)
    plain = P.orset_fold_tenants_plain(clock0, add0, rm0, kind, member,
                                       actor, counter, num_members=16,
                                       num_replicas=8)
    # as the service passes them: (T, E, R) views of (E, T·R) layouts
    views = [P.tenant_planes(x.to(dev).permute(1, 0, 2).reshape(16, -1), 8)
             for x in (add0, rm0)]
    before = F.launches["orset_fold"]
    got = pmesh.orset_fold_tenants_sharded(
        mesh, clock0.to(dev), *views,
        *(x.to(dev) for x in (kind, member, actor, counter)))
    assert F.launches["orset_fold"] - before == dp * mp
    assert_equal(got, plain)
    for name in ("random", "ties"):
        lww, K, _ = lww_batch(name, device="cpu")
        before = LC.launches["lww_fold"]
        got = pmesh.lww_fold_sharded(mesh, *(c.to(dev) for c in lww),
                                     num_keys=K)
        assert LC.launches["lww_fold"] - before == dp
        assert_tables_equal(L.lww_fold_plain(*lww, num_keys=K), got)


@pytest.mark.cuda
def test_a_one_card_mesh_refuses_a_second_card(dev, capsys):
    """``tools.daemon selftest --mesh dp=2 --device cuda`` exits 2 and
    names the one card it found, as the JAX CLI does on one chip."""
    from crdt_enc_tpu_torch.tools import daemon as daemon_cli

    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one CUDA device")
    assert daemon_cli.main(["selftest", "--device", "cuda", "--mesh",
                            "dp=2"]) == 2
    assert "found 1" in capsys.readouterr().err
