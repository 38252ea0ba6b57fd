"""The rest of the CRDT catalogue in the port, against the JAX package.

* The law and convergence scripts of tests/test_new_models.py and
  tests/test_crdtmap.py (SeqList, G-Set, LWW register, Merkle register,
  the causal map over OR-Sets, and the no-op type), each run from one
  seed through both packages' models: every checkpoint's canonical bytes
  agree across the packages — the G-Set's member order and the Merkle
  register's node hashes included — and each package keeps its own laws
  (commutative, idempotent, associative merges; CmRDT ≡ CvRDT).
* The cases of tests/test_catalogue_bulk.py: the port's
  ``TorchAccelerator(device="cpu").fold_payloads`` against the JAX
  ``TpuAccelerator`` on the same payloads and against the host loop, at
  ``min_device_batch`` 1 (the device routes: the LWW kernel's plain
  version at one key, the dominance filter) and 10**6 (the per-op host
  routes).
* ``merge_states`` over MVReg snapshots (``_merge_mvregs``) against the
  JAX accelerator and the host loop, and ``mvreg_dominance_keep`` blocked
  at several block sizes against the JAX filter.
* The reference fault: an MVReg clock entry past 2^31 − 1 merges in the
  port as the host loop merges it; the JAX route stores clocks in int32
  and raises.

Inputs come from seeds; equality is exact (canonical bytes, booleans).
"""

from __future__ import annotations

import copy
import random
import uuid

import numpy as np
import pytest
import torch

import crdt_enc_tpu.models as J
from crdt_enc_tpu.models import canonical_bytes as jcb
from crdt_enc_tpu.models.merkle_reg import node_hash as j_node_hash
from crdt_enc_tpu.ops.mvreg import mvreg_dominance_keep as j_dominance_keep
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu.utils import codec as jcodec

import crdt_enc_tpu_torch.models as P
from crdt_enc_tpu_torch import convert
from crdt_enc_tpu_torch.core.adapters import HostAccelerator
from crdt_enc_tpu_torch.models import canonical_bytes as pcb
from crdt_enc_tpu_torch.models.merkle_reg import node_hash as p_node_hash
from crdt_enc_tpu_torch.ops.mvreg import dominance_block, mvreg_dominance_keep
from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
from crdt_enc_tpu_torch.utils import codec as pcodec

ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(4)]
SEEDS = range(6)
PKGS = {"jax": (J, jcb), "port": (P, pcb)}


def interleave(streams, rng):
    streams = [list(s) for s in streams if s]
    out = []
    while streams:
        i = rng.randrange(len(streams))
        out.append(streams[i].pop(0))
        if not streams[i]:
            streams.pop(i)
    return out


def merge_laws(states, cb) -> list:
    """Commutativity, idempotence and associativity over ``states``;
    returns the merged states' bytes for the cross-package comparison."""
    a, b = copy.deepcopy(states[0]), copy.deepcopy(states[-1])
    ab, ba = copy.deepcopy(a), copy.deepcopy(b)
    ab.merge(b)
    ba.merge(a)
    assert cb(ab) == cb(ba)
    ab2 = copy.deepcopy(ab)
    ab2.merge(b)
    assert cb(ab2) == cb(ab)
    out = [cb(ab)]
    if len(states) >= 3:
        x, y, z = (copy.deepcopy(s) for s in states[:3])
        left = copy.deepcopy(x)
        left.merge(y)
        left.merge(z)
        yz = copy.deepcopy(y)
        yz.merge(z)
        right = copy.deepcopy(x)
        right.merge(yz)
        assert cb(left) == cb(right)
        out.append(cb(left))
    return out


def replay(M, cb, cls, streams, rng, **kw):
    """Checkpoints of a history: an interleaved replica, the wire round
    trip and the per-stream replicas merged (plus their laws)."""
    replica = cls(**kw)
    for op in interleave(streams, rng):
        replica.apply(op)
    out = [cb(replica), cb(cls.from_obj(replica.to_obj()))]
    replicas = []
    for s in streams:
        r = cls(**kw)
        for op in s:
            r.apply(op)
        replicas.append(r)
    if replicas:
        out += merge_laws(replicas, cb)
        merged = cls(**kw)
        for r in replicas:
            merged.merge(r)
        out.append(cb(merged))
    return out


# ---- law and convergence scripts, run through both packages -----------------


def list_script(M, cb, seed):
    rng = random.Random(seed)
    oracle = M.SeqList()
    streams = {a: [] for a in ACTORS}
    for _ in range(rng.randrange(4, 30)):
        actor = ACTORS[rng.randrange(4)]
        if rng.random() < 0.3 and len(oracle):
            op = oracle.delete_ctx(rng.randrange(len(oracle)))
        else:
            op = oracle.insert_ctx(actor, rng.randrange(len(oracle) + 1),
                                   rng.randrange(100))
        oracle.apply(op)
        streams[actor].append(op)
    streams = [s for s in streams.values() if s]
    out = replay(M, cb, M.SeqList, streams, rng)
    assert out[0] == cb(oracle) and out[-1] == cb(oracle)
    return out + [cb(oracle), oracle.read()]


def gset_script(M, cb, seed):
    rng = random.Random(seed)
    pool = [-(2**40), -33, -1, 0, 1, 127, 128, 2**16, 2**33, b"", b"a",
            b"ab", "", "a", "b", "é", (1, 2), (1, b"x"), 1.5]
    oracle = M.GSet()
    streams = {a: [] for a in ACTORS}
    for _ in range(rng.randrange(0, 25)):
        op = oracle.insert_ctx(pool[rng.randrange(len(pool))])
        oracle.apply(op)
        streams[ACTORS[rng.randrange(4)]].append(op)
    streams = list(streams.values())
    out = replay(M, cb, M.GSet, streams, rng)
    assert out[0] == cb(oracle)
    return out + [cb(oracle), oracle.read()]


def lwwreg_script(M, cb, seed):
    rng = random.Random(seed)
    oracle = M.LWWReg()
    ops = []
    for _ in range(rng.randrange(0, 25)):
        op = oracle.write(rng.randrange(6), ACTORS[rng.randrange(4)],
                          rng.choice([rng.randrange(100), "v", b"w", None]))
        oracle.apply(op)
        ops.append(op)
    streams = [ops[::3], ops[1::3], ops[2::3]]
    out = replay(M, cb, M.LWWReg, streams, rng)
    assert out[0] == cb(oracle)
    return out + [cb(oracle)]


def merklereg_script(M, cb, seed):
    rng = random.Random(seed)
    views = [M.MerkleReg() for _ in range(3)]
    streams = [[] for _ in views]
    for _ in range(rng.randrange(1, 16)):
        i = rng.randrange(3)
        op = views[i].write_ctx(rng.choice([rng.randrange(50), "s", (1, b"t")]))
        views[i].apply(op)
        streams[i].append(op)
        if rng.random() < 0.3:
            views[rng.randrange(3)].merge(views[i])
    out = replay(M, cb, M.MerkleReg, streams, rng)
    merged = M.MerkleReg()
    for v in views:
        merged.merge(v)
    return out + [sorted(merged.nodes), merged.heads(), merged.read()]


def map_history(M, script):
    """Map<orset> oracle + per-actor streams (tests/test_crdtmap.py's
    ``orset_child_history`` over the models of ``M``)."""
    keys, members = ["k0", "k1", "k2"], [10, 11, 12]
    oracle = M.CrdtMap(child=b"orset")
    streams = {a: [] for a in ACTORS}
    for actor_i, kind, key_i, member_i in script:
        actor, key, member = ACTORS[actor_i], keys[key_i], members[member_i]
        if kind == "rm_key":
            op = oracle.rm_ctx(key)
            if op.ctx.is_empty():
                continue
        elif kind == "add":
            op = oracle.update_ctx(actor, key,
                                   lambda c, d: M.AddOp(member, d))
        elif kind == "rm_member":
            child = oracle.get(key)
            if child is None or not child.contains(member):
                continue
            op = oracle.update_ctx(actor, key, lambda c, d: c.rm_ctx(member))
        else:  # write → an add of a different member
            op = oracle.update_ctx(actor, key,
                                   lambda c, d: M.AddOp(member + 100, d))
        oracle.apply(op)
        streams[actor].append(op)
    return oracle, [s for s in streams.values() if s]


def map_script_from(rng, lo=0, hi=24):
    return [(rng.randrange(4),
             rng.choice(["add", "rm_member", "rm_key", "write"]),
             rng.randrange(3), rng.randrange(3))
            for _ in range(rng.randrange(lo, hi + 1))]


def crdtmap_script(M, cb, seed):
    rng = random.Random(seed)
    oracle, streams = map_history(M, map_script_from(rng))
    out = replay(M, cb, M.CrdtMap, streams, rng, child=b"orset")
    assert out[0] == cb(oracle)
    if streams:
        assert out[-1] == cb(oracle)
    wire = [oracle.op_to_obj(op) for s in streams for op in s]
    return out + [cb(oracle), pack_of(M)(wire)]


def crdtmap_true_concurrency(M, cb, seed):
    """Ops derived from divergent replicas, delivered per-actor FIFO but
    not causally (tests/test_crdtmap.py::test_true_concurrency_convergence):
    every replica converges at full delivery."""
    rng = random.Random(seed)
    n_rep = 3
    reps = [M.CrdtMap(child=b"orset") for _ in range(n_rep)]
    logs = {a: [] for a in ACTORS[:n_rep]}
    delivered = [{a: 0 for a in ACTORS[:n_rep]} for _ in range(n_rep)]
    for _ in range(rng.randrange(4, 22)):
        i = rng.randrange(n_rep)
        actor, s = ACTORS[i], reps[i]
        kind = rng.choice(["add", "rm_member", "rm_key", "deliver", "deliver"])
        if kind == "deliver":
            src = ACTORS[rng.randrange(n_rep)]
            pos = delivered[i][src]
            if pos < len(logs[src]):
                s.apply(logs[src][pos])
                delivered[i][src] = pos + 1
            continue
        key = rng.choice(["k0", "k1", "k2"])
        if kind == "add":
            op = s.update_ctx(actor, key,
                              lambda c, d: M.AddOp(rng.choice([10, 11, 12]), d))
        elif kind == "rm_member":
            child = s.get(key)
            ms = sorted(child.entries, key=pack_of(M)) if child else []
            if not ms:
                continue
            op = s.update_ctx(actor, key,
                              lambda c, d, m=rng.choice(ms): c.rm_ctx(m))
        else:
            op = s.rm_ctx(key)
            if op.ctx.is_empty():
                continue
        s.apply(op)
        logs[actor].append(op)
        delivered[i][actor] = len(logs[actor])
    finals = []
    for i in range(n_rep):
        pending = dict(delivered[i])
        while any(pending[a] < len(logs[a]) for a in logs):
            a = rng.choice([a for a in logs if pending[a] < len(logs[a])])
            reps[i].apply(logs[a][pending[a]])
            pending[a] += 1
        finals.append(cb(reps[i]))
    assert len(set(finals)) == 1
    return finals


def empty_script(M, cb, seed):
    a, b = M.EmptyCrdt(), M.EmptyCrdt.from_obj(None)
    a.apply(None)
    a.merge(b)
    assert a == b
    return [cb(a), cb(M.EmptyCrdt.from_obj(a.to_obj()))]


def pack_of(M):
    return jcodec.pack if M is J else pcodec.pack


SCRIPTS = {
    "seqlist": list_script,
    "gset": gset_script,
    "lwwreg": lwwreg_script,
    "merklereg": merklereg_script,
    "crdtmap": crdtmap_script,
    "crdtmap true concurrency": crdtmap_true_concurrency,
    "empty": empty_script,
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(SCRIPTS))
def test_model_scripts_agree_across_packages(name, seed):
    script = SCRIPTS[name]
    assert script(*PKGS["port"], seed) == script(*PKGS["jax"], seed)


def test_merkle_hashes_and_gset_order_agree():
    """``node_hash`` packs ``[sorted parents, value]``: one differing byte
    would change every node's identity.  The G-Set orders members by their
    packed bytes, so both packers must order them alike."""
    vals = [0, -1, 2**31, 2**63 - 1, -(2**63), 1.5, "", "x" * 40, b"\x00" * 300,
            (1, (2, b"3")), {b"k": 1, "k": [2, 3]}, None, True, False]
    parents = [[], [b"\x01" * 32], [b"\x02" * 32, b"\x01" * 32]]
    for v in vals:
        for ps in parents:
            assert p_node_hash(ps, v) == j_node_hash(ps, v)
    members = [v for v in vals if not isinstance(v, dict)]
    pg, jg = P.GSet(), J.GSet()
    for m in members:
        pg.apply(m)
        jg.apply(m)
    assert pg.read() == jg.read()
    assert pcb(pg) == jcb(jg)


# ---- fold_payloads against the JAX accelerator (test_catalogue_bulk.py) -----


def seal(objs, per_file=5):
    return [pcodec.pack(objs[i : i + per_file]) for i in range(0, len(objs), per_file)]


def gset_ops(rng):
    return [rng.randrange(20) for _ in range(rng.randrange(0, 60))]


def lwwreg_ops(rng):
    return [P.LWWReg().write(rng.randrange(100), rng.choice(ACTORS),
                             rng.randrange(5))
            for _ in range(rng.randrange(1, 50))]


def mvreg_ops(rng):
    # concurrent writers with partially-ordered clocks: each actor writes
    # from its own (occasionally synced) view
    views = [P.MVReg() for _ in ACTORS]
    ops = []
    for _ in range(rng.randrange(1, 40)):
        i = rng.randrange(len(ACTORS))
        op = views[i].write_ctx(ACTORS[i], rng.randrange(10))
        ops.append(op)
        views[i].apply(op)
        if rng.random() < 0.3:
            views[rng.randrange(len(ACTORS))].merge(views[i])
    return ops


def seqlist_ops(rng):
    view = P.SeqList()
    ops = []
    for _ in range(rng.randrange(1, 40)):
        if view.read() and rng.random() < 0.3:
            op = view.delete_ctx(rng.randrange(len(view.read())))
        else:
            op = view.insert_ctx(rng.choice(ACTORS),
                                 rng.randrange(len(view.read()) + 1),
                                 rng.randrange(100))
        ops.append(op)
        view.apply(op)
    return ops


def merklereg_ops(rng):
    view = P.MerkleReg()
    ops = []
    for _ in range(rng.randrange(1, 30)):
        op = view.write_ctx(rng.randrange(50))
        ops.append(op)
        view.apply(op)
    return ops


BULK = {
    # name -> (port class, JAX class, op maker, op wire form)
    "gset": (P.GSet, J.GSet, gset_ops, lambda op: op),
    "lwwreg": (P.LWWReg, J.LWWReg, lwwreg_ops, lambda op: op.to_obj()),
    "mvreg": (P.MVReg, J.MVReg, mvreg_ops,
              lambda op: [op.clock.to_obj(), op.value]),
    "seqlist": (P.SeqList, J.SeqList, seqlist_ops, lambda op: op.to_obj()),
    "merklereg": (P.MerkleReg, J.MerkleReg, merklereg_ops,
                  lambda op: op.to_obj()),
}
PORT_OPS = {
    "gset": lambda o: o,
    "lwwreg": P.LWWRegOp.from_obj,
    "mvreg": lambda o: P.MVRegOp(P.VClock.from_obj(o[0]), o[1]),
    "seqlist": lambda o: o,
    "merklereg": P.MerkleNode.from_obj,
}


@pytest.mark.parametrize("min_batch", [1, 10**6], ids=["device", "host"])
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", list(BULK))
def test_fold_payloads_matches_the_jax_accelerator(name, seed, min_batch):
    pcls, jcls, make, wire = BULK[name]
    ops = make(random.Random(seed))
    payloads = seal([wire(op) for op in ops])
    host = pcls()
    for op in ops:
        host.apply(op)
    got = pcls()
    acc = TorchAccelerator(device="cpu", min_device_batch=min_batch)
    assert acc.fold_payloads(got, payloads) is True
    ref = jcls()
    assert TpuAccelerator(min_device_batch=min_batch).fold_payloads(ref, payloads)
    assert pcb(got) == pcb(host) == jcb(ref)


def test_lwwreg_bulk_into_populated_state():
    acc = TorchAccelerator(device="cpu", min_device_batch=1)
    jacc = TpuAccelerator(min_device_batch=1)
    first = P.LWWReg().write(50, ACTORS[0], "existing")
    for batch in ([(10, 1), (60, 1), (40, 1)], [(5, 2)], [(50, 0), (50, 3)]):
        ops = [P.LWWReg().write(ts, ACTORS[a], f"v{ts}") for ts, a in batch]
        host, got, ref = P.LWWReg(), P.LWWReg(), J.LWWReg()
        for s in (host, got, ref):
            s.apply(first.to_obj())
        for op in ops:
            host.apply(op)
        payloads = seal([o.to_obj() for o in ops])
        assert acc.fold_payloads(got, payloads)
        assert jacc.fold_payloads(ref, payloads)
        assert pcb(got) == pcb(host) == jcb(ref)


def test_mvreg_bulk_into_populated_state():
    acc = TorchAccelerator(device="cpu", min_device_batch=1)
    w = P.MVReg().write_ctx(ACTORS[0], "a")
    host, got, ref = P.MVReg(), P.MVReg(), J.MVReg()
    host.apply(w)
    got.apply(w)
    ref.apply(J.MVRegOp(J.VClock(dict(w.clock.counters)), w.value))
    op2 = host.write_ctx(ACTORS[1], "b")  # dominates the first write
    op3 = P.MVReg().write_ctx(ACTORS[2], "c")  # concurrent with both
    for op in (op2, op3):
        host.apply(op)
    payloads = seal([[op.clock.to_obj(), op.value] for op in (op2, op3)])
    assert acc.fold_payloads(got, payloads)
    assert TpuAccelerator(min_device_batch=1).fold_payloads(ref, payloads)
    assert pcb(got) == pcb(host) == jcb(ref)


def test_lwwreg_bulk_launches_one_fold_at_one_key(monkeypatch):
    """The device route folds every write in one ``lww_fold`` call with
    ``num_keys=1``."""
    import crdt_enc_tpu_torch.parallel.accel as A

    calls = []
    real = A.lww_fold

    def spy(*args, **kw):
        calls.append(kw["num_keys"])
        return real(*args, **kw)

    monkeypatch.setattr(A, "lww_fold", spy)
    ops = lwwreg_ops(random.Random(3))
    got = P.LWWReg()
    acc = TorchAccelerator(device="cpu", min_device_batch=1)
    assert acc.fold_payloads(got, seal([o.to_obj() for o in ops]))
    assert calls == [1]


def test_lwwreg_timestamp_past_the_split_declines():
    """A timestamp that does not split into two int32 halves declines
    before anything mutates; the host loop then takes it."""
    big = P.LWWReg().write(2**62, ACTORS[0], "far")
    got = P.LWWReg()
    acc = TorchAccelerator(device="cpu", min_device_batch=1)
    assert acc.fold_payloads(got, seal([big.to_obj()])) is False
    assert got.slot is None
    host = HostAccelerator().fold_ops(P.LWWReg(), [big])
    assert host.read() == "far"


# ---- merge_states over MVReg snapshots ---------------------------------------


def mvreg_snapshots(seed: int, n_snaps: int = 4):
    """Register states of concurrent writers that sync now and then, so
    later snapshots dominate parts of earlier ones."""
    rng = random.Random(seed)
    views = [P.MVReg() for _ in ACTORS]
    snaps = []
    for _ in range(n_snaps):
        for _ in range(rng.randrange(1, 12)):
            i = rng.randrange(len(ACTORS))
            views[i].apply(views[i].write_ctx(ACTORS[i], rng.randrange(6)))
            if rng.random() < 0.3:
                views[rng.randrange(len(ACTORS))].merge(views[i])
        snaps.append(P.MVReg.from_obj(views[rng.randrange(len(ACTORS))].to_obj()))
    return snaps


@pytest.mark.parametrize("min_batch", [1, 10**6], ids=["device", "host"])
@pytest.mark.parametrize("seed", range(6))
def test_merge_mvregs_matches_the_jax_accelerator(seed, min_batch):
    snaps = mvreg_snapshots(seed)
    host = HostAccelerator().merge_states(
        P.MVReg.from_obj(snaps[0].to_obj()), snaps[1:])
    got = TorchAccelerator(device="cpu", min_device_batch=min_batch).merge_states(
        P.MVReg.from_obj(snaps[0].to_obj()), snaps[1:])
    jsnaps = [J.MVReg.from_obj(jcodec.unpack(pcb(s))) for s in snaps]
    jacc = TpuAccelerator(min_device_batch=min_batch)
    ref = jacc.merge_states(jsnaps[0], jsnaps[1:])
    assert pcb(got) == pcb(host) == jcb(ref)
    if min_batch == 1:
        direct = jacc._merge_mvregs(
            J.MVReg.from_obj(jcodec.unpack(pcb(snaps[0]))), jsnaps[1:])
        assert jcb(direct) == pcb(got)


def test_mvreg_clock_past_int32_merges_as_the_host_loop():
    """A clock entry past 2^31 − 1: the port's int64 clocks merge as the
    host loop merges; the JAX route's int32 clock matrix cannot hold it
    and raises (crdt_enc_tpu/parallel/accel.py:1312)."""
    a, b = ACTORS[:2]
    big = 2**31 + 5
    states = [P.MVReg.from_obj([[{a: big}, "wide"]]),
              P.MVReg.from_obj([[{a: big - 2**31}, "narrow"]]),
              P.MVReg.from_obj([[{b: 1}, "other"]])]
    host = HostAccelerator().merge_states(
        P.MVReg.from_obj(states[0].to_obj()), states[1:])
    got = TorchAccelerator(device="cpu", min_device_batch=1).merge_states(
        P.MVReg.from_obj(states[0].to_obj()), states[1:])
    assert pcb(got) == pcb(host)
    assert sorted(v for _, v in got.vals) == ["other", "wide"]
    js = [J.MVReg.from_obj(jcodec.unpack(pcb(s))) for s in states]
    with pytest.raises(OverflowError):
        TpuAccelerator(min_device_batch=1).merge_states(js[0], js[1:])


# ---- the dominance filter ----------------------------------------------------


def clock_cases():
    rng = np.random.default_rng(21)
    out = {}
    c = rng.integers(0, 4, (40, 6)).astype(np.int32)
    out["random"] = (c, np.ones(40, bool))
    c = np.repeat(rng.integers(0, 3, (5, 4)), 3, axis=0).astype(np.int32)
    out["identical clocks, distinct values"] = (c, np.ones(15, bool))
    c = rng.integers(0, 3, (12, 5)).astype(np.int32)
    c = np.concatenate([c, c[:4]])  # duplicate pairs
    valid = np.ones(len(c), bool)
    valid[-2:] = False  # padding rows masked out
    out["duplicates and padding"] = (c, valid)
    c = np.zeros((7, 3), np.int32)
    c[np.arange(7), np.arange(7) % 3] = np.arange(1, 8)
    out["chains"] = (c, np.ones(7, bool))
    return out


@pytest.mark.parametrize("block", [1, 3, 7, None])
@pytest.mark.parametrize("case", list(clock_cases()))
def test_dominance_keep_blocked_matches_the_jax_filter(case, block):
    clocks, valid = clock_cases()[case]
    ref = np.asarray(j_dominance_keep(clocks, valid))
    got = mvreg_dominance_keep(torch.from_numpy(clocks.astype(np.int64)),
                               torch.from_numpy(valid), block=block)
    assert np.array_equal(got.numpy(), ref)


def test_dominance_block_bounds_the_comparison():
    """The default block keeps block·V·R within BLOCK_CELLS (the phase-15
    shape: V = 2,048, R = 10,000 would be 42 GB unblocked)."""
    from crdt_enc_tpu_torch.ops import mvreg as M

    b = dominance_block(2048, 10_000)
    assert 1 <= b and b * 2048 * 10_000 <= M.BLOCK_CELLS
    assert dominance_block(4, 3) == 4
    assert dominance_block(10**6, 10**6) == 1


@pytest.mark.parametrize("name", ["mvreg", "gset", "lwwreg", "merklereg",
                                  "seqlist", "crdtmap", "empty"])
def test_convert_carries_reference_states(name):
    """``convert.*_from_reference_obj`` builds the port's state from a JAX
    state's ``to_obj()``; the bytes agree."""
    rng = random.Random(4)
    if name == "crdtmap":
        ref, _ = map_history(J, map_script_from(rng, 8, 24))
    elif name == "empty":
        ref = J.EmptyCrdt()
    elif name == "mvreg":
        ref = J.MVReg.from_obj(jcodec.unpack(pcb(mvreg_snapshots(4)[-1])))
    else:
        _, jcls, make, wire = BULK[name]
        ref = jcls()
        for op in make(rng):
            ref.apply(jcodec.unpack(pcodec.pack(wire(op))))
    got = getattr(convert, f"{name}_from_reference_obj")(ref.to_obj())
    assert pcb(got) == jcb(ref)
