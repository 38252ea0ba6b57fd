"""The sparse regime of the port against the JAX package, on the CPU.

* ``orset_fold_sparse_host`` into fresh and into populated states, against
  the JAX function (canonical bytes, exact).
* ``orset_apply_coo`` against the JAX apply, both fed the run ends of
  the JAX ``orset_fold_coo`` (XLA on the CPU backend).
* ``TorchAccelerator`` forced into the sparse regime (``SPARSE_MIN_CELLS``
  and ``SPARSE_CELLS_PER_ROW`` set to 0) through ``fold_ops``,
  ``fold_payloads`` (which no longer declines there), a BUFFER fold
  session and ``fold_encrypted_stream``: each equal to the JAX
  ``TpuAccelerator`` in the same regime and to the host loop, with no
  ``fold.device`` span, also where a clock needs more than int32.
* The checkpoint stash: a fresh fold of at least ``CKPT_STASH_MIN_ROWS``
  surviving rows stashes them under the fold's epoch, and the rows pack
  unpacks to the same state as the dict walk's.
"""

from __future__ import annotations

import secrets

import numpy as np
import pytest

from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.ops import columnar as JC
from crdt_enc_tpu.ops import orset as JO
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu_torch import HostAccelerator, ORSet, TorchAccelerator
from crdt_enc_tpu_torch import canonical_bytes
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.ops import columnar as C
from crdt_enc_tpu_torch.parallel import accel as A
from crdt_enc_tpu_torch.parallel import session as S
from crdt_enc_tpu_torch.utils import codec, trace

ACTORS = sorted(bytes([a]) * 16 for a in range(1, 8))


def history(n_ops, n_members, seed, state=None):
    """A causally valid op history on the port's host OR-Set; returns
    (final state, ops)."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else ORSet()
    ops = []
    for _ in range(n_ops):
        m = int(rng.integers(n_members))
        if rng.random() < 0.3 and state.entries.get(m):
            op = state.rm_ctx(m)
        else:
            op = state.add_ctx(ACTORS[int(rng.integers(len(ACTORS)))], m)
        state.apply(op)
        ops.append(op)
    return state, ops


def rows(N, E, R, seed):
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < 0.3).astype(np.int8)
    member = rng.integers(0, E, N).astype(np.int32)
    actor = np.where(rng.random(N) < 0.05, R,
                     rng.integers(0, R, N)).astype(np.int32)
    counter = rng.integers(1, 60, N).astype(np.int32)
    return kind, member, actor, counter


def prior_state(seed):
    state, _ = history(150, 30, seed)
    return state


# ---- the sparse folds ------------------------------------------------------


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_sparse_host_fold_matches_jax(prior, seed):
    E, R = 40, len(ACTORS)
    cols = rows(2000, E, R, seed)
    obj = prior_state(seed + 10).to_obj() if prior else ORSet().to_obj()
    state, jstate = ORSet.from_obj(obj), JORSet.from_obj(obj)
    members = list(range(E))
    got = C.orset_fold_sparse_host(state, *cols, C.Vocab(members),
                                   C.Vocab(ACTORS))
    ref = JC.orset_fold_sparse_host(jstate, *cols, JC.Vocab(members),
                                    JC.Vocab(ACTORS))
    assert canonical_bytes(got) == j_canonical_bytes(ref)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_apply_coo_matches_jax(prior, seed):
    """The sparse writeback, fed the JAX program's sorted run ends, gives
    the JAX apply's bytes and the host fold's."""
    E, R = 40, len(ACTORS)
    kind, member, actor, counter = rows(1500, E, R, seed)
    obj = prior_state(seed + 20).to_obj() if prior else ORSet().to_obj()
    members = list(range(E))
    state, jstate = ORSet.from_obj(obj), JORSet.from_obj(obj)
    reps, jreps = C.Vocab(ACTORS), JC.Vocab(ACTORS)
    jclock0 = JC.vclock_to_dense(jstate.clock, jreps)
    jout = [np.asarray(j) for j in JO.orset_fold_coo(
        jclock0, kind, member, actor, counter, num_members=E, num_replicas=R)]
    got = C.orset_apply_coo(state, *jout, C.Vocab(members), reps)
    ref = JC.orset_apply_coo(jstate, *jout, JC.Vocab(members), jreps)
    host = C.orset_fold_sparse_host(ORSet.from_obj(obj), kind, member, actor,
                                    counter, C.Vocab(members), C.Vocab(ACTORS))
    assert canonical_bytes(got) == j_canonical_bytes(ref) == canonical_bytes(host)


# ---- the accelerator's sparse regime ---------------------------------------


def sparse(acc):
    acc.SPARSE_MIN_CELLS = 0
    acc.SPARSE_CELLS_PER_ROW = 0
    return acc


def cpu_accel():
    return sparse(TorchAccelerator(device="cpu", min_device_batch=1))


def jax_accel():
    return sparse(TpuAccelerator(min_device_batch=1))


def payloads_of(ops, per_file=7):
    return [codec.pack([op.to_obj() for op in ops[lo : lo + per_file]])
            for lo in range(0, len(ops), per_file)]


@pytest.mark.parametrize("prior", [False, True])
def test_fold_ops_takes_the_sparse_host_fold(prior):
    base = prior_state(3) if prior else ORSet()
    _, ops = history(300, 25, 4, state=ORSet.from_obj(base.to_obj()))
    trace.reset()
    got = cpu_accel().fold_ops(ORSet.from_obj(base.to_obj()), list(ops))
    spans = trace.snapshot()["spans"]
    assert "fold.device" not in spans and "fold.planes" not in spans
    assert ("session.sparse_fold" in spans) is not prior  # native iff fresh
    ref = jax_accel().fold_ops(JORSet.from_obj(base.to_obj()), _jax_ops(ops))
    host = HostAccelerator().fold_ops(ORSet.from_obj(base.to_obj()), list(ops))
    assert canonical_bytes(got) == canonical_bytes(host) == j_canonical_bytes(ref)


def _jax_ops(ops):
    from crdt_enc_tpu.models.orset import op_from_obj

    return [op_from_obj(codec.unpack(codec.pack(op.to_obj()))) for op in ops]


@pytest.mark.parametrize("prior", [False, True])
def test_fold_payloads_folds_the_sparse_regime(prior):
    base = prior_state(5) if prior else ORSet()
    _, ops = history(300, 25, 6, state=ORSet.from_obj(base.to_obj()))
    payloads = payloads_of(ops)
    state = ORSet.from_obj(base.to_obj())
    trace.reset()
    assert cpu_accel().fold_payloads(state, payloads, actors_hint=ACTORS) is True
    assert "fold.device" not in trace.snapshot()["spans"]
    ref = JORSet.from_obj(base.to_obj())
    assert jax_accel().fold_payloads(ref, payloads, actors_hint=ACTORS)
    host = HostAccelerator().fold_ops(ORSet.from_obj(base.to_obj()), list(ops))
    assert canonical_bytes(state) == canonical_bytes(host) == j_canonical_bytes(ref)


def test_buffer_session_finishes_through_the_sparse_fold():
    _, ops = history(400, 30, 7)
    payloads = payloads_of(ops)
    acc = cpu_accel()
    trace.reset()
    sess = S.OrsetFoldSession(acc, ORSet(), actors_hint=ACTORS)
    for lo in range(0, len(payloads), 9):
        sess.feed(payloads[lo : lo + 9])
    assert sess.mode == "buffer"
    got = sess.finish()
    spans = trace.snapshot()["spans"]
    assert "fold.device" not in spans
    assert spans["session.sparse_fold"]["count"] == 1
    from crdt_enc_tpu.parallel import session as JS

    jsess = JS.OrsetFoldSession(jax_accel(), JORSet(), actors_hint=ACTORS)
    for lo in range(0, len(payloads), 9):
        jsess.feed(payloads[lo : lo + 9])
    ref = jsess.finish()
    host = HostAccelerator().fold_ops(ORSet(), list(ops))
    assert canonical_bytes(got) == canonical_bytes(host) == j_canonical_bytes(ref)


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_encrypted_stream_folds_the_sparse_regime(n_chunks, monkeypatch):
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", n_chunks)
    _, ops = history(400, 30, 8)
    key = secrets.token_bytes(32)
    blobs = [px.encrypt_blob(key, p) for p in payloads_of(ops)]
    state = ORSet()
    trace.reset()
    assert cpu_accel().fold_encrypted_stream(state, key, blobs,
                                             actors_hint=ACTORS)
    assert "fold.device" not in trace.snapshot()["spans"]
    ref = JORSet()
    assert jax_accel().fold_encrypted_stream(ref, key, blobs,
                                             actors_hint=ACTORS,
                                             n_chunks=n_chunks)
    host = HostAccelerator().fold_ops(ORSet(), list(ops))
    assert canonical_bytes(state) == canonical_bytes(host) == j_canonical_bytes(ref)


@pytest.mark.parametrize("prior", [False, True])
def test_fold_ops_past_int32_takes_the_numpy_fold(prior):
    """A clock past int32 (the native fresh fold declines it) folds
    through the int64 numpy path, equal to the host loop and to the JAX
    accelerator."""
    def widened(cls, vc):
        s = (prior_state(9) if prior else ORSet()).to_obj()
        s = cls.from_obj(s)
        s.clock = vc({**s.clock.counters, ACTORS[0]: 2**40})
        return s

    ops = [AddOp("w1", Dot(ACTORS[0], 5)), AddOp("w2", Dot(ACTORS[1], 3)),
           RmOp("w2", VClock({ACTORS[1]: 1}))]
    trace.reset()
    got = cpu_accel().fold_ops(widened(ORSet, VClock), list(ops))
    spans = trace.snapshot()["spans"]
    assert "fold.device" not in spans and "session.sparse_fold" not in spans
    host = HostAccelerator().fold_ops(widened(ORSet, VClock), list(ops))
    from crdt_enc_tpu.models.vclock import VClock as JVClock

    ref = jax_accel().fold_ops(widened(JORSet, JVClock), _jax_ops(ops))
    assert canonical_bytes(got) == canonical_bytes(host) == j_canonical_bytes(ref)
    assert got.clock.get(ACTORS[0]) == 2**40 and "w1" not in got.entries


# ---- the checkpoint stash --------------------------------------------------


def stash_rows(N, E, R, seed):
    """Per-actor monotone dots, removes at or past the clock (some ahead of
    it, so the deferred table is covered)."""
    rng = np.random.default_rng(seed)
    counters = np.zeros(R, np.int64)
    kind = np.zeros(N, np.int8)
    member = rng.integers(0, E, N).astype(np.int32)
    actor = rng.integers(0, R, N).astype(np.int32)
    ctr = np.zeros(N, np.int32)
    for i in range(N):
        a = int(actor[i])
        roll = rng.random()
        if roll < 0.05:
            kind[i] = 1
            ctr[i] = counters[a] + 3
        elif roll < 0.18 and counters[a]:
            kind[i] = 1
            ctr[i] = counters[a]
        else:
            counters[a] += 1
            ctr[i] = counters[a]
    return kind, member, actor, ctr


def test_fresh_fold_stashes_rows_above_the_bound():
    R, E, N = 64, 200, 9000
    actors = sorted(secrets.token_bytes(16) for _ in range(R))
    cols = stash_rows(N, E, R, 4)
    state = ORSet()
    C.orset_fold_sparse_host(state, *cols, C.Vocab(range(E)), C.Vocab(actors))
    stash = state._ckpt_rows
    n_rows = len(stash[1][1]) + len(stash[1][4])
    assert n_rows >= C.CKPT_STASH_MIN_ROWS and len(stash[1][4])
    assert stash[0] == state._mut
    from_rows = C.orset_unpack_checkpoint(C.orset_pack_checkpoint_rows(*stash[1]))
    from_dicts = C.orset_unpack_checkpoint(C.orset_pack_checkpoint(state))
    assert canonical_bytes(from_rows) == canonical_bytes(state)
    assert canonical_bytes(from_dicts) == canonical_bytes(state)
    # the JAX fold stashes the same rows
    jstate = JORSet()
    JC.orset_fold_sparse_host(jstate, *cols, JC.Vocab(range(E)),
                              JC.Vocab(actors))
    for mine, theirs in zip(stash[1][:7], jstate._ckpt_rows[1][:7]):
        np.testing.assert_array_equal(mine, theirs)
    # the rows pack unpacks in the JAX package to the same state
    wire = codec.unpack(codec.pack(C.orset_pack_checkpoint_rows(*stash[1])))
    assert j_canonical_bytes(JC.orset_unpack_checkpoint(wire)) == canonical_bytes(state)
    # a later mutation leaves the stash behind its epoch
    state.apply(AddOp(0, Dot(actors[0], 10**6)))
    assert stash[0] != state._mut


def test_small_folds_and_populated_states_stash_nothing():
    R, E = 8, 20
    actors = [b"a%d" % i for i in range(R)]
    small = ORSet()
    C.orset_fold_sparse_host(small, *stash_rows(300, E, R, 5),
                             C.Vocab(range(E)), C.Vocab(actors))
    assert getattr(small, "_ckpt_rows", None) is None
    populated, _ = history(50, 10, 6)
    C.orset_fold_sparse_host(populated, *stash_rows(9000, E, R, 7),
                             C.Vocab(range(E)), C.Vocab(actors))
    assert getattr(populated, "_ckpt_rows", None) is None
