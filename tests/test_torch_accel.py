"""The port's accelerator slice against the JAX package, on the CPU.

``TorchAccelerator(device="cpu")`` runs the dense fold and the S-way merge
through the plain PyTorch versions of the kernels; the JAX
``TpuAccelerator`` (CPU backend) and the port's ``HostAccelerator`` loop
run the same ops and states.  All three must give equal canonical bytes.
State crosses between the packages as plain objects
(``convert.orset_from_reference_obj``); ops cross as their ``to_obj()``
form.

Mirrors tests/test_accelerator.py::test_merge_many_orsets_matches_host and
the OR-Set cases of tests/test_ops_kernels.py.
"""

from __future__ import annotations

import copy
import uuid

import numpy as np
import pytest
import torch

from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.core.adapters import HostAccelerator as JHostAccelerator
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models.orset import AddOp as JAddOp
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel.accel import TpuAccelerator

from crdt_enc_tpu_torch import (
    HostAccelerator,
    ORSet,
    TorchAccelerator,
    canonical_bytes,
    convert,
)
from crdt_enc_tpu_torch import ops as PK
from crdt_enc_tpu_torch.core.adapters import orset_adapter
from crdt_enc_tpu_torch.models.orset import op_from_obj
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


@pytest.mark.parametrize("S", [3, 5])
def test_merge_many_orsets_matches_host(S):
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
    j = TpuAccelerator(min_device_batch=1).merge_states(
        copy.deepcopy(states[0]), [copy.deepcopy(s) for s in states[1:]])
    jh = JHostAccelerator().merge_states(
        copy.deepcopy(states[0]), [copy.deepcopy(s) for s in states[1:]])
    ported = [port_state(s) for s in states]
    t = cpu_accel().merge_states(ported[0], ported[1:])
    h = HostAccelerator().merge_states(
        port_state(states[0]), [port_state(s) for s in states[1:]])
    assert canonical_bytes(t) == j_canonical_bytes(j) == canonical_bytes(h)
    assert canonical_bytes(t) == j_canonical_bytes(jh)


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
    accel = cpu_accel()
    accel.SPARSE_MIN_CELLS = 0
    accel.SPARSE_CELLS_PER_ROW = 0
    _, ops = jax_script(200, 10, 9)
    trace.reset()
    t = accel.fold_ops(ORSet(), port_ops(ops))
    assert "fold.device" not in trace.snapshot()["spans"]
    h = HostAccelerator().fold_ops(ORSet(), port_ops(ops))
    assert canonical_bytes(t) == canonical_bytes(h)


def test_batches_past_the_stream_bound_raise():
    accel = cpu_accel()
    accel.STREAM_CHUNK_ROWS = 16
    _, ops = jax_script(100, 10, 10)
    state = ORSet()
    with pytest.raises(NotImplementedError, match="later slice"):
        accel.fold_ops(state, port_ops(ops))
    assert canonical_bytes(state) == canonical_bytes(ORSet())


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
