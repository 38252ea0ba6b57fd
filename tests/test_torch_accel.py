"""The port's accelerator slice against the JAX package, on the CPU.

``TorchAccelerator(device="cpu")`` runs the dense fold and the S-way merge
through the plain PyTorch versions of the kernels; the JAX
``TpuAccelerator`` (CPU backend) and the port's ``HostAccelerator`` loop
run the same ops and states.  All three must give equal canonical bytes.
State crosses between the packages as plain objects
(``convert.orset_from_reference_obj``); ops cross as their ``to_obj()``
form.

Mirrors tests/test_accelerator.py (the ORSet merge, and the LWW-map,
G-Counter and PN-Counter folds) and the OR-Set cases of
tests/test_ops_kernels.py.  LWW-map, G-Counter and PN-Counter states cross
through ``convert.lwwmap_from_reference_obj``,
``gcounter_from_reference_obj`` and ``pncounter_from_reference_obj``.
"""

from __future__ import annotations

import copy
import uuid

import numpy as np
import pytest
import torch

from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.core.adapters import HostAccelerator as JHostAccelerator
from crdt_enc_tpu.models import GCounter as JGCounter
from crdt_enc_tpu.models import LWWMap as JLWWMap
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import PNCounter as JPNCounter
from crdt_enc_tpu.models.orset import AddOp as JAddOp
from crdt_enc_tpu.models.orset import RmOp as JRmOp
from crdt_enc_tpu.models.vclock import Dot as JDot
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel.accel import TpuAccelerator

from crdt_enc_tpu_torch import (
    Dot,
    GCounter,
    HostAccelerator,
    LWWMap,
    LWWOp,
    ORSet,
    PNCounter,
    TorchAccelerator,
    canonical_bytes,
    convert,
)
from crdt_enc_tpu_torch import ops as PK
from crdt_enc_tpu_torch.core.adapters import (
    gcounter_adapter,
    lwwmap_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.models.orset import RmOp, op_from_obj
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.ops.columnar import (
    orset_scan_vocab,
    orset_state_to_planes,
    orset_states_to_cells,
)
from crdt_enc_tpu_torch.ops.orset import orset_stack_cells
from crdt_enc_tpu_torch.utils import trace

ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(7)]
MEMBERS = [b"a", b"b", b"c", b"d"]


def cpu_accel(**kw):
    # min_device_batch=1 forces the device route even for small test batches
    return TorchAccelerator(device="cpu", min_device_batch=1, **kw)


def jax_script(n_ops, n_members, seed, state=None, actors=ACTORS):
    """A host-applied JAX-package op history with interleaved adds and
    removes; returns (final JAX state, ops)."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else JORSet()
    ops = []
    for _ in range(n_ops):
        if rng.random() < 0.3:
            op = state.rm_ctx(int(rng.integers(n_members)))
            if op.ctx.is_empty():
                continue
        else:
            op = state.add_ctx(actors[int(rng.integers(len(actors)))],
                               int(rng.integers(n_members)))
        state.apply(op)
        ops.append(op)
    return state, ops


def port_ops(ops):
    return [op_from_obj(op.to_obj()) for op in ops]


def port_state(jstate):
    return convert.orset_from_reference_obj(jstate.to_obj())


def three_way_fold(jinit, jops):
    """Fold the same ops into the same state with TpuAccelerator (JAX),
    TorchAccelerator (port, CPU) and the port's host loop."""
    j = TpuAccelerator(min_device_batch=1).fold_ops(
        JORSet.from_obj(jinit.to_obj()), list(jops))
    t = cpu_accel().fold_ops(port_state(jinit), port_ops(jops))
    h = HostAccelerator().fold_ops(port_state(jinit), port_ops(jops))
    return j, t, h


@pytest.mark.parametrize("seed", range(4))
def test_fold_ops_matches_tpu_accelerator_and_host(seed):
    final, ops = jax_script(400, 30, seed)
    j, t, h = three_way_fold(JORSet(), ops)
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
    assert canonical_bytes(t) == j_canonical_bytes(final)


@pytest.mark.parametrize("seed", range(3))
def test_fold_ops_into_nonempty_state(seed):
    """A carried-across prior state: batch adds below its clock are stale
    replays."""
    base, _ = jax_script(300, 20, 50 + seed)
    history = JORSet.from_obj(base.to_obj())
    _, ops = jax_script(300, 20, 60 + seed, state=history)
    replay = ops[: len(ops) // 3]  # the first third again: all stale
    j, t, h = three_way_fold(base, ops + replay)
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)


def sparse_states(S):
    """S replicas of one 10-member history, each with 30 adds and observed
    removes of its own: a few cells of each state's planes filled."""
    rng = np.random.default_rng(3 + S)
    base = JORSet()
    for i in range(10):
        base.apply(base.add_ctx(ACTORS[0], i))
    states = []
    for r in range(S):
        s = copy.deepcopy(base)
        for _ in range(30):
            if rng.random() < 0.3:
                op = s.rm_ctx(int(rng.integers(15)))
                if op.ctx.is_empty():
                    continue
            else:
                op = s.add_ctx(ACTORS[r + 1], int(rng.integers(15)))
            s.apply(op)
        states.append(s)
    return states


def full_states(S, E=6):
    """S states whose every (member, actor) cell holds a dot or a remove
    horizon (the two are exclusive in a state): each actor adds each
    member, replica r re-adds some members as actor r, then remove
    horizons past the clock replace some dots."""
    rng = np.random.default_rng(11 + S)
    states = []
    for r in range(S):
        s = JORSet()
        for a in ACTORS[:S]:
            for m in range(E):
                s.apply(s.add_ctx(a, m))
        for m in rng.choice(E, E // 2, replace=False).tolist():
            s.apply(s.add_ctx(ACTORS[r], m))
        for m in range(E):
            for a in ACTORS[:S]:
                if rng.random() < 0.3:
                    ahead = s.clock.get(a) + int(rng.integers(1, 4))
                    s.apply(JRmOp(m, JVClock({a: ahead})))
        states.append(s)
    return states


def cell_count(state) -> int:
    return sum(len(c) for plane in (state.entries, state.deferred)
               for c in plane.values())


@pytest.mark.parametrize("S,full", [
    pytest.param(3, False, id="3"), pytest.param(5, False, id="5"),
    pytest.param(3, True, id="dense-3"), pytest.param(5, True, id="dense-5"),
])
def test_merge_many_orsets_matches_host(S, full):
    """Sparse states and states whose cells fill their planes upload their
    cells; each merge equals the JAX device and host merges and the
    port's host loop."""
    states = full_states(S) if full else sparse_states(S)
    j = TpuAccelerator(min_device_batch=1).merge_states(
        copy.deepcopy(states[0]), [copy.deepcopy(s) for s in states[1:]])
    jh = JHostAccelerator().merge_states(
        copy.deepcopy(states[0]), [copy.deepcopy(s) for s in states[1:]])
    ported = [port_state(s) for s in states]
    cells = sum(map(cell_count, ported))
    trace.reset()
    t = cpu_accel().merge_states(ported[0], ported[1:])
    counters = trace.snapshot()["counters"]
    h = HostAccelerator().merge_states(
        port_state(states[0]), [port_state(s) for s in states[1:]])
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
    assert canonical_bytes(t) == j_canonical_bytes(jh)
    assert counters["merge_coo_cells"] == cells
    if full:  # one cell a member and actor: the dense stacks' count
        assert any(c.deferred for c in ported)
        assert cells == S * 6 * S


STACK_CASES = ("deferred", "empty", "clock_only")


def stack_case(case, S):
    """Port states for the cells-to-stacks check: random adds and observed
    removes, plus remove horizons past the clock (``deferred``), an empty
    replica (``empty``) or actors known only from a clock
    (``clock_only``)."""
    rng = np.random.default_rng(STACK_CASES.index(case) * 10 + S)
    actors = [uuid.UUID(int=100 + i).bytes for i in range(9)]
    states = []
    for r in range(S):
        s = ORSet()
        for _ in range(40):
            m = int(rng.integers(12))
            if rng.random() < 0.25:
                op = s.rm_ctx(m)
                if op.ctx.is_empty():
                    continue
            else:
                op = s.add_ctx(actors[int(rng.integers(len(actors)))], m)
            s.apply(op)
        if case == "deferred":
            for m in rng.choice(12, 4, replace=False).tolist():
                a = actors[int(rng.integers(len(actors)))]
                s.apply(RmOp(m, VClock({a: s.clock.get(a) + 2})))
            assert s.deferred
        states.append(s)
    if case == "empty":
        states[0] = ORSet()
    if case == "clock_only":
        for r, s in enumerate(states):
            s.clock.counters[uuid.UUID(int=200 + r).bytes] = 7 + r
    return states


@pytest.mark.parametrize("S", [3, 9])
@pytest.mark.parametrize("case", STACK_CASES)
def test_stacks_from_cells_equal_host_planes(case, S):
    states = stack_case(case, S)
    members, replicas = PK.Vocab(), PK.Vocab()
    for s in states:
        orset_scan_vocab(s, members, replicas)
    E, R = len(members), len(replicas)
    planes = [orset_state_to_planes(s, members, replicas, scanned=True)
              for s in states]
    want = [np.stack([p[i] for p in planes]) for i in range(3)]
    clocks, cells, offsets = orset_states_to_cells(states, members, replicas)
    assert len(cells) == sum(map(cell_count, states))
    assert offsets[0] == 0 and offsets[-1] == len(cells)
    adds, rms = orset_stack_cells(torch.from_numpy(cells),
                                  torch.from_numpy(offsets), S, E, R)
    for got, ref in zip((clocks, adds.numpy(), rms.numpy()), want):
        assert got.dtype == ref.dtype == np.int32
        assert np.array_equal(got, ref)
    if case == "clock_only":
        assert R > len({a for s in states for p in (s.entries, s.deferred)
                        for c in p.values() for a in c})


def test_merge_of_two_states_takes_the_host_loop():
    a, _ = jax_script(60, 8, 1)
    b, _ = jax_script(60, 8, 2)
    trace.reset()
    t = cpu_accel().merge_states(port_state(a), [port_state(b)])
    assert "merge.device" not in trace.snapshot()["spans"]
    h = HostAccelerator().merge_states(port_state(a), [port_state(b)])
    assert canonical_bytes(t) == canonical_bytes(h)


def test_merge_of_clock_only_states_merges_clocks():
    """States with clocks but no entries or horizons have no plane cells
    to merge; their clocks must still merge."""
    states = []
    for i in range(3):
        s = ORSet()
        s.clock.counters[ACTORS[i]] = i + 1
        states.append(s)
    t = cpu_accel().merge_states(states[0], states[1:])
    assert t.clock.counters == {ACTORS[0]: 1, ACTORS[1]: 2, ACTORS[2]: 3}


def test_dense_fold_records_spans_and_bumps_the_epoch():
    _, ops = jax_script(200, 10, 7)
    state = ORSet()
    trace.reset()
    cpu_accel().fold_ops(state, port_ops(ops))
    spans = trace.snapshot()["spans"]
    for name in ("fold.columns", "fold.vocab", "fold.planes", "fold.device",
                 "fold.writeback"):
        assert spans[name]["count"] == 1, name
    assert state._mut == 1
    # nothing crossed to a device, so nothing is counted as uploaded
    assert "h2d_bytes" not in trace.snapshot()["counters"]


def test_small_batch_takes_the_host_loop():
    _, ops = jax_script(40, 6, 8)
    assert len(ops) < 256
    trace.reset()
    t = TorchAccelerator(device="cpu").fold_ops(ORSet(), port_ops(ops))
    assert "fold.device" not in trace.snapshot()["spans"]
    h = HostAccelerator().fold_ops(ORSet(), port_ops(ops))
    assert canonical_bytes(t) == canonical_bytes(h)


def test_sparse_regime_takes_the_host_loop():
    """The sparse regime stays on the host, through the vectorized sparse
    fold (natively into an empty state), not the device and not the
    per-op loop; equal to the host loop and to ``TpuAccelerator`` in the
    same regime."""
    accel = cpu_accel()
    accel.SPARSE_MIN_CELLS = 0
    accel.SPARSE_CELLS_PER_ROW = 0
    _, ops = jax_script(200, 10, 9)
    trace.reset()
    t = accel.fold_ops(ORSet(), port_ops(ops))
    spans = trace.snapshot()["spans"]
    assert "fold.device" not in spans
    assert spans["session.sparse_fold"]["count"] == 1
    h = HostAccelerator().fold_ops(ORSet(), port_ops(ops))
    jacc = TpuAccelerator(min_device_batch=1)
    jacc.SPARSE_MIN_CELLS = 0
    jacc.SPARSE_CELLS_PER_ROW = 0
    j = jacc.fold_ops(JORSet(), list(ops))
    assert canonical_bytes(t) == canonical_bytes(h) == j_canonical_bytes(j)


def test_batches_past_the_stream_bound_raise():
    """Batches past ``STREAM_CHUNK_ROWS`` (16 here) once raised; they now
    fold blockwise, through ``fold_ops`` and through ``fold_payloads``,
    into a fresh state and onto a prior history, each byte-equal to the
    host loop and to the JAX accelerator's stream route (its
    ``orset_fold_stream``, at the same chunk size)."""
    from crdt_enc_tpu.utils import codec as jcodec

    base, _ = jax_script(60, 10, 3)
    _, ops = jax_script(100, 10, 10, state=JORSet.from_obj(base.to_obj()))
    payloads = [jcodec.pack([op.to_obj() for op in ops[lo : lo + 7]])
                for lo in range(0, len(ops), 7)]
    hint = sorted(ACTORS)
    for prior in (JORSet(), base):
        jaccel = TpuAccelerator(min_device_batch=1)
        jaccel.STREAM_CHUNK_ROWS = 16
        j_ops = jaccel.fold_ops(JORSet.from_obj(prior.to_obj()), list(ops))
        j_pay = JORSet.from_obj(prior.to_obj())
        assert jaccel.fold_payloads(j_pay, payloads, actors_hint=hint)
        h = HostAccelerator().fold_ops(port_state(prior), port_ops(ops))
        accel = cpu_accel()
        accel.STREAM_CHUNK_ROWS = 16
        trace.reset()
        t_ops = accel.fold_ops(port_state(prior), port_ops(ops))
        assert trace.snapshot()["spans"]["stream.fold"]["count"] > 1
        t_pay = port_state(prior)
        mut = t_pay._mut
        assert accel.fold_payloads(t_pay, payloads, actors_hint=hint)
        assert t_pay._mut == mut + 1
        assert (canonical_bytes(t_ops) == canonical_bytes(t_pay)
                == canonical_bytes(h) == j_canonical_bytes(j_ops)
                == j_canonical_bytes(j_pay))


def test_other_state_types_take_the_host_loop():
    class Counter:
        def __init__(self):
            self.n = 0

        def apply(self, op):
            self.n += op

        def merge(self, other):
            self.n = max(self.n, other.n)

    c = cpu_accel().fold_ops(Counter(), [1, 2, 3])
    assert c.n == 6
    others = [Counter(), Counter()]
    others[1].n = 9
    assert cpu_accel().merge_states(Counter(), others).n == 9


def test_default_device_is_cuda_and_refuses_the_cpu():
    """``TorchAccelerator()`` means the card; without one it raises rather
    than carry on silently on the CPU."""
    if torch.cuda.is_available():
        assert TorchAccelerator().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchAccelerator()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TorchAccelerator(device="cuda")
    with pytest.raises(ValueError, match="unsupported device"):
        TorchAccelerator(device="meta")


def test_adapter_round_trips_state_and_ops():
    final, ops = jax_script(80, 6, 11)
    ad = orset_adapter()
    assert ad.name == b"orset"
    state = ad.state_from_obj(final.to_obj())
    assert canonical_bytes(state) == j_canonical_bytes(final)
    folded = HostAccelerator().fold_ops(
        ad.new(), [ad.op_from_obj(op.to_obj()) for op in ops])
    assert canonical_bytes(folded) == j_canonical_bytes(final)


# ---- the OR-Set cases of tests/test_ops_kernels.py, on both packages ----


def fixed_vocabs(pkg):
    return pkg.Vocab(MEMBERS), pkg.Vocab(ACTORS[:5])


def script_ops(seed, n=30, state=None):
    """A test_ops_kernels-style script: 5 actors, 4 members."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else JORSet()
    ops = []
    for _ in range(n):
        a, m = ACTORS[int(rng.integers(5))], MEMBERS[int(rng.integers(4))]
        op = state.add_ctx(a, m) if rng.random() < 0.6 else state.rm_ctx(m)
        if not isinstance(op, JAddOp) and op.ctx.is_empty():
            continue
        state.apply(op)
        ops.append(op)
    return state, ops


def fold_both(jinit, ops, pad_to=0):
    """Kernel-level fold of ``ops`` into ``jinit`` on fixed vocabularies,
    through the JAX ``orset_fold`` and the port's; returns both states."""
    out = []
    for pkg, init, batch in (
        (JK, JORSet.from_obj(jinit.to_obj()), ops),
        (PK, port_state(jinit), port_ops(ops)),
    ):
        members, replicas = fixed_vocabs(pkg)
        planes = pkg.orset_state_to_planes(init, members, replicas)
        cols = pkg.orset_ops_to_columns(batch, members, replicas)
        pkg.pad_orset_rows(cols, max(pad_to, len(cols.kind)), len(replicas))
        args = (*planes, cols.kind, cols.member, cols.actor, cols.counter)
        if pkg is PK:
            args = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
        res = pkg.orset_fold(*args, num_members=len(members),
                             num_replicas=len(replicas))
        res = [np.asarray(x) for x in res]
        out.append(pkg.orset_planes_to_state(*res, members, replicas))
    return out


@pytest.mark.parametrize("seed", range(5))
def test_kernel_fold_matches_host(seed):
    host, ops = script_ops(seed)
    j, p = fold_both(JORSet(), ops)
    assert canonical_bytes(p) == j_canonical_bytes(j) == j_canonical_bytes(host)


@pytest.mark.parametrize("seed", range(5))
def test_kernel_fold_from_nonempty_state(seed):
    base, _ = script_ops(100 + seed)
    host, ops = script_ops(200 + seed, state=JORSet.from_obj(base.to_obj()))
    j, p = fold_both(base, ops)
    assert canonical_bytes(p) == j_canonical_bytes(j) == j_canonical_bytes(host)


def test_kernel_fold_with_padding():
    host, ops = script_ops(300, n=8)
    j, p = fold_both(JORSet(), ops, pad_to=64)
    assert canonical_bytes(p) == j_canonical_bytes(j) == j_canonical_bytes(host)


@pytest.mark.parametrize("seed", range(5))
def test_kernel_merge_matches_host(seed):
    sa, _ = script_ops(400 + seed)
    sb, _ = script_ops(500 + seed)
    host = JORSet.from_obj(sa.to_obj())
    host.merge(sb)
    members, replicas = fixed_vocabs(PK)
    pa = PK.orset_state_to_planes(port_state(sa), members, replicas)
    pb = PK.orset_state_to_planes(port_state(sb), members, replicas)
    planes = PK.orset_merge(*(torch.from_numpy(x) for x in (*pa, *pb)))
    merged = PK.orset_planes_to_state(*(x.numpy() for x in planes),
                                      members, replicas)
    assert canonical_bytes(merged) == j_canonical_bytes(host)


def test_kernel_merge_many_tree():
    states = []
    for i in range(5):
        s = JORSet()
        for a, m in ((i % 5, i % 4), ((i + 1) % 5, (i + 2) % 4)):
            s.apply(s.add_ctx(ACTORS[a], MEMBERS[m]))
        states.append(s)
    host = JORSet()
    for s in states:
        host.merge(s)
    members, replicas = fixed_vocabs(PK)
    planes = [PK.orset_state_to_planes(port_state(s), members, replicas)
              for s in states]
    stacks = [torch.from_numpy(np.stack([p[i] for p in planes]))
              for i in range(3)]
    clock, add, rm = PK.orset_merge_many(*stacks)
    merged = PK.orset_planes_to_state(clock.numpy(), add.numpy(), rm.numpy(),
                                      members, replicas)
    assert canonical_bytes(merged) == j_canonical_bytes(host)


# ---- LWW-map, G-Counter and PN-Counter folds, on both packages ----------


def lww_script(n_ops, n_keys, seed, state=None, actors=ACTORS, n_values=100):
    """A host-applied JAX-package LWW history; coarse timestamps force
    plenty of (ts, actor, value) ties, a quarter of the writes delete.
    Values mix ints and strings, so the value rank crosses types."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else JLWWMap()
    ops = []
    for _ in range(n_ops):
        a = actors[int(rng.integers(len(actors)))]
        k = f"k{int(rng.integers(n_keys))}"
        ts = int(rng.integers(0, 8)) * (1 << 33) + int(rng.integers(0, 4))
        if rng.random() < 0.25:
            op = state.delete(k, ts, a)
        else:
            v = int(rng.integers(n_values))
            op = state.put(k, ts, a, v if v % 3 else f"v{v}")
        state.apply(op)
        ops.append(op)
    return state, ops


def port_lww_ops(ops):
    return [LWWOp.from_obj(op.to_obj()) for op in ops]


def three_way_lww(jinit, jops):
    j = TpuAccelerator(min_device_batch=1).fold_ops(
        JLWWMap.from_obj(jinit.to_obj()), list(jops))
    t = cpu_accel().fold_ops(convert.lwwmap_from_reference_obj(jinit.to_obj()),
                             port_lww_ops(jops))
    h = HostAccelerator().fold_ops(
        convert.lwwmap_from_reference_obj(jinit.to_obj()), port_lww_ops(jops))
    return j, t, h


@pytest.mark.parametrize("seed", range(4))
def test_lww_fold_matches_tpu_accelerator_and_host(seed):
    final, ops = lww_script(400, 40, seed)
    j, t, h = three_way_lww(JLWWMap(), ops)
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
    assert canonical_bytes(t) == j_canonical_bytes(final)


@pytest.mark.parametrize("seed", range(3))
def test_lww_fold_into_populated_state(seed):
    """A carried-across state: batch writes collide with its entries, so
    the writeback's host tie-break (``_wins``) runs."""
    base, _ = lww_script(300, 30, 20 + seed)
    _, ops = lww_script(300, 45, 30 + seed,
                        state=JLWWMap.from_obj(base.to_obj()))
    replay = ops[: len(ops) // 4]  # duplicates of writes in the batch
    j, t, h = three_way_lww(base, ops + replay)
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)


def test_lww_full_tie_tombstone_wins():
    """An exact duplicate (ts, actor, value) where one write is a delete:
    the delete wins (tests/test_accelerator.py's tombstone tie)."""
    a = ACTORS[0]
    ops = [JLWWMap().put("k", 5, a, 1), JLWWMap().delete("k", 5, a),
           JLWWMap().put("j", 0, a, None), JLWWMap().delete("j", 0, a)]
    for jops in (ops, ops[::-1]):
        j, t, h = three_way_lww(JLWWMap(), jops)
        assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
        assert t.get("k") is None and t.entries["k"][3]
        assert t.entries["j"][3]


def test_lww_tombstone_tie_against_a_state_entry():
    """The batch winner ties a state entry exactly; the delete wins from
    either side."""
    a = ACTORS[1]
    for state_op, batch_op in (
        (JLWWMap().put("k", 9, a, 2), JLWWMap().delete("k", 9, a)),
        (JLWWMap().delete("k", 9, a), JLWWMap().put("k", 9, a, None)),
    ):
        base = JLWWMap()
        base.apply(state_op)
        j, t, h = three_way_lww(base, [batch_op])
        assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
        assert t.entries["k"][3]


def test_lww_unpacked_route_through_the_accelerator(monkeypatch):
    """``num_values=None`` (taken when |actors|·V ≥ 2^31) gives the host
    loop's bytes.  Such a batch is too large for a test, so the route is
    forced: the accelerator's fold is called with ``num_values=None``."""
    from crdt_enc_tpu_torch.parallel import accel as A

    seen = []
    real = A.lww_fold

    def unpacked(*args, num_keys, num_values=None):
        seen.append(num_values)
        return real(*args, num_keys=num_keys, num_values=None)

    monkeypatch.setattr(A, "lww_fold", unpacked)
    base, _ = lww_script(200, 20, 40)
    _, ops = lww_script(300, 30, 41, state=JLWWMap.from_obj(base.to_obj()))
    _, t, h = three_way_lww(base, ops)
    assert canonical_bytes(t) == canonical_bytes(h)
    assert seen and seen[0] is not None  # the packed rank fits here


def test_lww_unpacked_fold_matches_jax_on_accelerator_columns():
    """The ``num_values=None`` cascade on the columns the accelerator
    builds, against the JAX ``lww_fold`` in the same mode."""
    _, ops = lww_script(500, 60, 42)
    jc = JK.lww_ops_to_columns(ops)
    pc = PK.lww_ops_to_columns(port_lww_ops(ops))
    cols = (pc.key, pc.ts_hi, pc.ts_lo, pc.actor, pc.value)
    Kn = len(pc.keys)
    ref = JK.lww_fold(jc.key, jc.ts_hi, jc.ts_lo, jc.actor, jc.value,
                      num_keys=Kn)
    got = PK.lww_fold(*(torch.from_numpy(c) for c in cols), num_keys=Kn)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(r), g.numpy())


def test_lww_columns_match_jax():
    _, ops = lww_script(300, 25, 43)
    jc = JK.lww_ops_to_columns(ops)
    pc = PK.lww_ops_to_columns(port_lww_ops(ops))
    for name in ("key", "ts_hi", "ts_lo", "actor", "value", "tombstone"):
        r, g = getattr(jc, name), getattr(pc, name)
        assert r.dtype == g.dtype, name
        np.testing.assert_array_equal(r, g, err_msg=name)
    assert list(jc.keys.items) == list(pc.keys.items)
    assert jc.actors_sorted == pc.actors_sorted
    assert jc.values_sorted == pc.values_sorted


def test_lww_fold_bumps_the_epoch_and_records_spans():
    """The JAX writeback leaves ``_mut`` where it was; the port bumps it
    after a device fold, as the OR-Set writeback does."""
    _, ops = lww_script(120, 10, 44)
    state = LWWMap()
    trace.reset()
    cpu_accel().fold_ops(state, port_lww_ops(ops))
    assert state._mut == 1
    spans = trace.snapshot()["spans"]
    for name in ("fold.columns", "fold.device", "fold.writeback"):
        assert spans[name]["count"] == 1, name
    jstate = JLWWMap()
    TpuAccelerator(min_device_batch=1).fold_ops(jstate, list(ops))
    assert jstate._mut == 0


def test_lww_small_batch_takes_the_host_loop():
    _, ops = lww_script(40, 6, 45)
    trace.reset()
    t = TorchAccelerator(device="cpu").fold_ops(LWWMap(), port_lww_ops(ops))
    assert "fold.device" not in trace.snapshot()["spans"]
    h = HostAccelerator().fold_ops(LWWMap(), port_lww_ops(ops))
    assert canonical_bytes(t) == canonical_bytes(h)
    assert t._mut == h._mut == len(ops)


def counter_script(kind, n_ops, seed, state=None, actors=ACTORS):
    """A host-applied JAX G- or PN-Counter history (30% decrements)."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else (
        JGCounter() if kind == "g" else JPNCounter())
    ops = []
    for _ in range(n_ops):
        a = actors[int(rng.integers(len(actors)))]
        steps = int(rng.integers(1, 5))
        if kind == "pn" and rng.random() < 0.3:
            op = state.dec(a, steps)
        else:
            op = state.inc(a, steps)
        state.apply(op)
        ops.append(op)
    return state, ops


def port_counter_ops(ops):
    return [Dot.from_obj(op.to_obj()) if isinstance(op, JDot)
            else (op[0], Dot.from_obj(op[1].to_obj())) for op in ops]


def three_way_counter(kind, jinit, jops):
    jcls = JGCounter if kind == "g" else JPNCounter
    conv = (convert.gcounter_from_reference_obj if kind == "g"
            else convert.pncounter_from_reference_obj)
    j = TpuAccelerator(min_device_batch=1).fold_ops(
        jcls.from_obj(jinit.to_obj()), list(jops))
    t = cpu_accel().fold_ops(conv(jinit.to_obj()), port_counter_ops(jops))
    h = HostAccelerator().fold_ops(conv(jinit.to_obj()), port_counter_ops(jops))
    return j, t, h


@pytest.mark.parametrize("kind", ["g", "pn"])
@pytest.mark.parametrize("seed", range(3))
def test_counter_fold_matches_tpu_accelerator_and_host(kind, seed):
    final, ops = counter_script(kind, 500, seed)
    j, t, h = three_way_counter(kind, final.__class__(), ops)
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
    assert canonical_bytes(t) == j_canonical_bytes(final)
    assert t.read() == final.read()


@pytest.mark.parametrize("kind", ["g", "pn"])
def test_counter_fold_into_populated_state(kind):
    """Prior clocks with actors the batch never names; a replayed third of
    the batch changes nothing."""
    base, _ = counter_script(kind, 200, 7)
    _, ops = counter_script(kind, 300, 8, state=base.__class__.from_obj(
        base.to_obj()), actors=ACTORS[2:])
    j, t, h = three_way_counter(kind, base, ops + ops[: len(ops) // 3])
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)


@pytest.mark.parametrize("kind", ["g", "pn"])
def test_counter_fold_records_spans(kind):
    _, ops = counter_script(kind, 100, 9)
    trace.reset()
    cpu_accel().fold_ops((GCounter if kind == "g" else PNCounter)(),
                         port_counter_ops(ops))
    spans = trace.snapshot()["spans"]
    for name in ("fold.columns", "fold.device", "fold.writeback"):
        assert spans[name]["count"] == 1, name


def test_counters_past_int32_match_the_host_loop():
    """A prior clock past 2^31 − 1, and a dot past it in the batch.  The
    port widens to int64 and gives the host loop's bytes.  The JAX device
    route does not: it narrows the prior clock to int32 (the G-Counter's
    2^31 + 5 entry is lost, the PN-Counter's 2^32 + 1 reads 1) and raises
    OverflowError on the wide dot."""
    a = ACTORS
    g = JGCounter()
    g.clock.counters.update({a[0]: 2**31 + 5, a[1]: 3})
    pn = JPNCounter()
    pn.p.clock.counters[a[0]] = 2**32 + 1
    cases = (
        ("g", g, [JDot(a[1], 7), JDot(a[2], 9)]),
        ("pn", pn, [(0, JDot(a[1], 7)), (1, JDot(a[2], 9))]),
    )
    for kind, base, ops in cases:
        j, t, h = three_way_counter(kind, base, ops)
        assert canonical_bytes(t) == canonical_bytes(h)
        assert j_canonical_bytes(j) != canonical_bytes(h)
    wide = [JDot(a[1], 2**31 + 7)]
    t = cpu_accel().fold_ops(GCounter(), port_counter_ops(wide))
    assert t.clock.counters == {a[1]: 2**31 + 7}
    with pytest.raises(OverflowError):
        TpuAccelerator(min_device_batch=1).fold_ops(JGCounter(), list(wide))


@pytest.mark.parametrize("name,cls", [("gcounter", GCounter),
                                      ("pncounter", PNCounter),
                                      ("lwwmap", LWWMap)])
def test_adapters_round_trip_state_and_ops(name, cls):
    if name == "lwwmap":
        final, ops = lww_script(80, 6, 46)
        ad = lwwmap_adapter()
    else:
        final, ops = counter_script("g" if name == "gcounter" else "pn", 80, 47)
        ad = gcounter_adapter() if name == "gcounter" else pncounter_adapter()
    assert ad.name == name.encode()
    state = ad.state_from_obj(final.to_obj())
    assert isinstance(state, cls)
    assert canonical_bytes(state) == j_canonical_bytes(final)
    folded = HostAccelerator().fold_ops(
        ad.new(), [ad.op_from_obj(ad.op_to_obj(op)) for op in
                   (port_lww_ops(ops) if name == "lwwmap"
                    else port_counter_ops(ops))])
    assert canonical_bytes(folded) == j_canonical_bytes(final)
