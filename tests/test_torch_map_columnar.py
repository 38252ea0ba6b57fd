"""The port's columnar CrdtMap<orset> fold against the JAX package.

* The cases of tests/test_map_columnar.py: random causally consistent
  histories sealed into payloads, decoded natively and folded columnar by
  ``TorchAccelerator(device="cpu").fold_payloads`` — its scatter phase in
  PyTorch (``min_device_batch`` 1) and in numpy (``min_device_batch``
  large) — into an empty and into a populated state, each equal to the
  per-op oracle and to the JAX ``TpuAccelerator`` (host and device
  routes); the foreign-dot decline; the chunked ``MapFoldSession``,
  into a populated state and with an actor joining mid-flight.
* The native map decoder's four row families equal the JAX decoder's on
  the same payloads.
* ``crdtmap_scatter_phase`` in PyTorch equal to the JAX program on the
  same planes and rows, sentinel padding rows included.
* The reference faults: a payload counter of 2^31 declines in the port
  where the JAX decoder wraps it; a state counter of 2^31 + 5 folds by
  the port's device route as by the host phase, where the JAX device
  route narrows it.

Inputs come from seeds; equality is exact (canonical bytes, integers).
"""

from __future__ import annotations

import random
import uuid

import numpy as np
import pytest
import torch

import crdt_enc_tpu.models as J
from crdt_enc_tpu.models import canonical_bytes as jcb
from crdt_enc_tpu.ops import map_columnar as JMC
from crdt_enc_tpu.ops.map_device import crdtmap_scatter_phase as j_scatter_phase
from crdt_enc_tpu.parallel import session as JS
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu.utils import codec as jcodec

import crdt_enc_tpu_torch.models as P
from crdt_enc_tpu_torch.core.adapters import HostAccelerator, map_adapter
from crdt_enc_tpu_torch.models import canonical_bytes as pcb
from crdt_enc_tpu_torch.ops import map_columnar as PMC
from crdt_enc_tpu_torch.ops.map_device import crdtmap_scatter_phase
from crdt_enc_tpu_torch.parallel import session as PS
from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
from crdt_enc_tpu_torch.utils import codec as pcodec
from crdt_enc_tpu_torch.utils import trace

from tests.test_torch_catalogue import ACTORS, map_history, map_script_from

ROUTES = {"device": 1, "host": 10**9}  # min_device_batch per route


def payloads_from_streams(streams, per_file=3):
    """Per-actor op streams sealed into op-file payloads, one actor's files
    after another (per-actor order is the only order the fold needs)."""
    proto = P.CrdtMap(child=b"orset")
    files = []
    for s in streams:
        for i in range(0, len(s), per_file):
            files.append([proto.op_to_obj(op) for op in s[i : i + per_file]])
    return [pcodec.pack(f) for f in files]


def jstate(state):
    return J.CrdtMap.from_obj(jcodec.unpack(pcb(state)))


def accel(route):
    return TorchAccelerator(device="cpu", min_device_batch=ROUTES[route])


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed", range(4))
def test_fold_payloads_matches_the_oracle_and_the_jax_accelerator(seed, route):
    rng = random.Random(100 + seed)
    for trial in range(20):
        oracle, streams = map_history(P, map_script_from(rng, 0, 30))
        payloads = payloads_from_streams(streams)
        got = P.CrdtMap(child=b"orset")
        trace.reset()
        assert accel(route).fold_payloads(got, payloads, actors_hint=ACTORS)
        if payloads:
            spans = trace.snapshot()["spans"]
            assert f"map.scatter_{route}" in spans
        ref = J.CrdtMap(child=b"orset")
        jacc = TpuAccelerator(min_device_batch=1, map_fold_impl=route)
        assert jacc.fold_payloads(ref, payloads, actors_hint=ACTORS)
        assert pcb(got) == pcb(oracle) == jcb(ref), (trial, streams)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed", range(3))
def test_fold_into_a_populated_state(seed, route):
    """The second half of each actor's stream folds in bulk into the
    state built per op from the first halves."""
    rng = random.Random(200 + seed)
    for trial in range(15):
        oracle, streams = map_history(P, map_script_from(rng, 4, 30))
        base = P.CrdtMap(child=b"orset")
        tails = []
        for s in streams:
            half = len(s) // 2
            for op in s[:half]:
                base.apply(op)
            tails.append(s[half:])
        payloads = payloads_from_streams(tails)
        ref = jstate(base)
        mut = base._mut
        assert accel(route).fold_payloads(base, payloads, actors_hint=ACTORS)
        assert base._mut == mut + 1 or not payloads
        jacc = TpuAccelerator(min_device_batch=1, map_fold_impl=route)
        assert jacc.fold_payloads(ref, payloads, actors_hint=ACTORS)
        assert pcb(base) == pcb(oracle) == jcb(ref), (trial, streams)


def test_foreign_dot_declines_and_leaves_the_state_untouched():
    """A child add whose dot differs from the map dot breaks the shared-dot
    discipline the fold relies on: the bulk route declines before any
    mutation, as the JAX one does, and the per-op path takes it."""
    m = P.CrdtMap(child=b"orset")
    up = m.update_ctx(ACTORS[0], "k",
                      lambda c, d: P.AddOp(1, P.Dot(ACTORS[1], 1)))
    payload = pcodec.pack([m.op_to_obj(up)])
    state = P.CrdtMap(child=b"orset")
    before, mut = pcb(state), state._mut
    assert accel("device").fold_payloads(state, [payload],
                                         actors_hint=ACTORS) is False
    assert pcb(state) == before and state._mut == mut
    assert TpuAccelerator(min_device_batch=1).fold_payloads(
        J.CrdtMap(child=b"orset"), [payload], actors_hint=ACTORS) is False
    host = HostAccelerator().fold_ops(P.CrdtMap(child=b"orset"), [up])
    assert host.contains("k")


@pytest.mark.parametrize("case", ["wide context", "key collision"])
def test_other_declines_leave_the_state_untouched(case):
    """A key remove over more than 64 actors, and two keys that intern to
    one Python value (1 and True), decline before any mutation."""
    state = P.CrdtMap(child=b"orset")
    for a in ACTORS:
        state.apply(state.update_ctx(a, 1, lambda c, d: P.AddOp(0, d)))
    if case == "wide context":
        actors = [uuid.UUID(int=i + 1).bytes for i in range(65)]
        rm = P.MapRmOp(P.VClock({a: 1 for a in actors}), (1,))
        payloads = [pcodec.pack([rm.to_obj()])]
    else:
        actors = ACTORS
        ups = [state.update_ctx(ACTORS[0], k, lambda c, d: P.AddOp(0, d))
               for k in (1, True)]
        ups[1] = P.MapUpOp(P.Dot(ACTORS[0], ups[0].dot.counter + 1), True,
                           P.AddOp(0, P.Dot(ACTORS[0], ups[0].dot.counter + 1)))
        payloads = [pcodec.pack([state.op_to_obj(u) for u in ups])]
    before, mut = pcb(state), state._mut
    assert accel("device").fold_payloads(state, payloads,
                                         actors_hint=actors) is False
    assert pcb(state) == before and state._mut == mut


def session_fold(acc, state, payloads, chunk_steps=True):
    session = acc.open_fold_session(state, actors_hint=ACTORS)
    assert isinstance(session, PS.MapFoldSession)
    i = 0
    while i < len(payloads):
        step = 1 + (i % 3) if chunk_steps else 1
        session.feed(payloads[i : i + step])
        i += step
    session.finish()
    return session


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("seed", range(3))
def test_map_fold_session_chunked(seed, route):
    """Chunked decode and intern, one fold at finish: equal to the oracle,
    to the whole-batch route and to the JAX session."""
    rng = random.Random(300 + seed)
    for trial in range(12):
        oracle, streams = map_history(P, map_script_from(rng, 4, 40))
        payloads = payloads_from_streams(streams)
        state = P.CrdtMap(child=b"orset")
        session_fold(accel(route), state, payloads)
        ref = J.CrdtMap(child=b"orset")
        js = JS.open_fold_session(TpuAccelerator(min_device_batch=1,
                                                 map_fold_impl=route),
                                  ref, actors_hint=ACTORS)
        i = 0
        while i < len(payloads):
            step = 1 + (i % 3)
            js.feed(payloads[i : i + step])
            i += step
        js.finish()
        assert pcb(state) == pcb(oracle) == jcb(ref), (trial, streams)


def test_map_fold_session_into_a_populated_state():
    rng = random.Random(29)
    for trial in range(12):
        oracle, streams = map_history(P, map_script_from(rng, 6, 36))
        base = P.CrdtMap(child=b"orset")
        tails = []
        for s in streams:
            half = len(s) // 2
            for op in s[:half]:
                base.apply(op)
            tails.append(s[half:])
        session_fold(accel("device"), base, payloads_from_streams(tails),
                     chunk_steps=False)
        assert pcb(base) == pcb(oracle), (trial, streams)


def test_map_fold_session_actor_joins_mid_flight():
    """An actor absent at session open applies an op while chunks are in
    flight: finish honors it (the fed rows index the sorted prefix, new
    actors intern after it)."""
    late = uuid.UUID(int=99).bytes
    oracle, streams = map_history(P, [(0, "add", 0, 0), (1, "add", 1, 1),
                                      (2, "add", 2, 2)])
    payloads = payloads_from_streams(streams)
    state = P.CrdtMap(child=b"orset")
    session = accel("device").open_fold_session(state, actors_hint=ACTORS)
    session.feed(payloads[:1])
    up = state.update_ctx(late, "late", lambda c, d: P.AddOp(7, d))
    state.apply(up)
    oracle.apply(up)
    session.feed(payloads[1:])
    session.finish()
    assert pcb(state) == pcb(oracle)


def test_session_supported_for_orset_maps_only():
    acc = accel("device")
    assert acc.can_open_fold_session(P.CrdtMap(child=b"orset"))
    for s in (P.GSet(), P.MVReg(), P.LWWReg(), P.SeqList(), P.MerkleReg(),
              P.EmptyCrdt()):
        assert not acc.can_open_fold_session(s)
        assert acc.open_fold_session(s) is None
    assert map_adapter().name == b"map+orset"


# ---- the native decoder ------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_native_map_decoder_rows_equal_the_jax_decoder(seed):
    rng = random.Random(400 + seed)
    _, streams = map_history(P, map_script_from(rng, 10, 40))
    payloads = payloads_from_streams(streams, per_file=rng.randrange(1, 6))
    got = PMC.decode_map_payload_batch(payloads, sorted(ACTORS))
    ref = JMC.decode_map_payload_batch(payloads, sorted(ACTORS))
    assert got is not None and ref is not None
    for fam_got, fam_ref in zip(got[:4], ref[:4]):
        assert sorted(fam_got) == sorted(fam_ref)
        for k in fam_ref:
            assert np.array_equal(fam_got[k], fam_ref[k]), k
    assert got[4] == ref[4] and got[5] == ref[5]


def test_map_payload_counter_past_int32_declines():
    """A map dot of 2^31: the port's decoder declines the payload (the
    caller folds per op, as the host loop does); the JAX decoder narrows it
    to int32 and hands the fold a negative counter
    (crdt_enc_tpu/native/codec.cpp:675-734)."""
    m = P.CrdtMap(child=b"orset")
    big = 2**31
    up = P.MapUpOp(P.Dot(ACTORS[0], big), "k", P.AddOp(5, P.Dot(ACTORS[0], big)))
    payloads = [pcodec.pack([m.op_to_obj(up)])]
    assert PMC.decode_map_payload_batch(payloads, sorted(ACTORS)) is None
    state = P.CrdtMap(child=b"orset")
    assert accel("device").fold_payloads(state, payloads,
                                         actors_hint=ACTORS) is False
    assert state._mut == 0 and pcb(state) == pcb(P.CrdtMap(child=b"orset"))
    host = HostAccelerator().fold_ops(P.CrdtMap(child=b"orset"), [up])
    assert host.clock.get(ACTORS[0]) == big
    B, A = JMC.decode_map_payload_batch(payloads, sorted(ACTORS))[:2]
    assert int(B["ctr"][0]) < 0 and int(A["ctr"][0]) < 0
    ref = J.CrdtMap(child=b"orset")
    assert TpuAccelerator(min_device_batch=1).fold_payloads(ref, payloads,
                                                            actors_hint=ACTORS)
    assert jcb(ref) != pcb(host)


@pytest.mark.parametrize("route", list(ROUTES))
def test_map_state_counter_past_int32_folds_as_the_host_phase(route):
    """A state counter of 2^31 + 5 folds by the port's device route (int64
    planes) as by the host phase and the per-op loop; the JAX device route
    narrows the state's planes to int32 (crdt_enc_tpu/ops/map_device.py:
    175-188) and loses the entry."""
    big = 2**31 + 5
    a, b = ACTORS[:2]
    up = P.MapUpOp(P.Dot(a, big), "k", P.AddOp(1, P.Dot(a, big)))
    base = HostAccelerator().fold_ops(P.CrdtMap(child=b"orset"), [up])
    batch = P.CrdtMap(child=b"orset")
    ops = [batch.update_ctx(b, "j", lambda c, d: P.AddOp(2, d))]
    batch.apply(ops[0])
    ops.append(batch.update_ctx(b, "k", lambda c, d: P.AddOp(3, d)))
    payloads = [pcodec.pack([base.op_to_obj(op) for op in ops])]
    host = HostAccelerator().fold_ops(P.CrdtMap.from_obj(base.to_obj()), ops)
    got = P.CrdtMap.from_obj(base.to_obj())
    assert accel(route).fold_payloads(got, payloads, actors_hint=ACTORS)
    assert pcb(got) == pcb(host)
    assert got.clock.get(a) == big and got.births["k"][a] == big
    ref = jstate(base)
    assert TpuAccelerator(min_device_batch=1, map_fold_impl="device"
                          ).fold_payloads(ref, payloads, actors_hint=ACTORS)
    assert jcb(ref) != pcb(host)


# ---- the scatter phase -------------------------------------------------------


def scatter_inputs(seed: int):
    """Random planes and rows in the JAX program's int32 layout, with
    sentinel padding rows (actor == R) in every family."""
    rng = np.random.default_rng(seed)
    NK, NP, R, G = 5, 9, 6, 4
    i32 = np.int32

    def rows(n, cols):
        out = {}
        for name, hi in cols:
            out[name] = rng.integers(0, hi, n).astype(i32)
        return out

    def pad(fam, n, actor_cols):
        for c in actor_cols:
            fam[c][-n:] = R
        return fam

    clock0 = rng.integers(0, 6, R).astype(i32)
    planes = [rng.integers(0, 8, (NK, R)).astype(i32) * (rng.random((NK, R)) < .4)
              for _ in range(2)]
    pair_planes = [rng.integers(0, 8, (NP, R)).astype(i32) * (rng.random((NP, R)) < .3)
                   for _ in range(2)]
    kop = np.sort(rng.integers(0, NK, NP)).astype(i32)
    B = pad(rows(30, [("key", NK), ("actor", R), ("ctr", 12)]), 3, ["actor"])
    K = pad(rows(20, [("key", NK), ("actor", R), ("ctr", 12), ("group", G)]),
            2, ["actor"])
    A = pad(rows(25, [("key", NK), ("pair", NP), ("actor", R), ("ctr", 12)]),
            2, ["actor"])
    Rm = pad(rows(15, [("pair", NP), ("actor", R), ("ctr", 12),
                       ("mactor", R), ("mctr", 12)]), 2, ["actor", "mactor"])
    args = (clock0, *planes, *pair_planes, kop,
            B["key"], B["actor"], B["ctr"],
            K["key"], K["actor"], K["ctr"], K["group"],
            A["key"], A["pair"], A["actor"], A["ctr"],
            Rm["pair"], Rm["actor"], Rm["ctr"], Rm["mactor"], Rm["mctr"])
    return args, dict(num_keys=NK, num_pairs=NP, num_replicas=R, num_groups=G)


@pytest.mark.parametrize("seed", range(8))
def test_scatter_phase_matches_the_jax_program(seed):
    args, static = scatter_inputs(seed)
    ref = [np.asarray(x) for x in j_scatter_phase(*args, **static)]
    got = crdtmap_scatter_phase(
        *(torch.from_numpy(np.asarray(x, np.int64)) for x in args),
        num_groups=static["num_groups"])
    for r, g in zip(ref, got):
        assert np.array_equal(g.numpy(), r.astype(g.numpy().dtype))
    assert got[0].dtype == torch.int64 and got[5].dtype == torch.bool
