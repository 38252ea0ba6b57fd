"""The accelerator's and the AEAD's settings, held against the JAX package
on the CPU.

* ``orset_fold_coo`` (the twin of tests/test_ops_kernels.py::
  test_orset_fold_coo_matches_dense): its four outputs equal the JAX
  function's element for element, and written back they give the dense
  fold's bytes; past the int32 key space, where the JAX function refuses,
  it still equals a plain Python fold;
* ``TorchAccelerator(sparse_device=True)`` (the twin of
  tests/test_accelerator.py::test_sparse_device_coo_route_matches_host):
  the sparse regime folds through ``orset_fold_coo`` from every entry
  point, byte-equal to the host loop, the host-sort route and the JAX
  accelerator with ``sparse_device=True``;
* ``plane_reuse`` and ``CRDT_PLANE_REUSE`` (the twin of
  tests/test_plane_reuse.py::test_plane_reuse_off_switch): off, the cache
  is never consulted or filled, and the bytes do not change;
* ``CRDT_SHARDED_STREAM``: the JAX package's three-way resolution, a
  mistyped value warning;
* ``stream_producers``: the width of ``fold_encrypted_stream`` and of the
  core's pipelined ingest, as the JAX accelerator's;
* ``decrypt_blobs(n_threads=)``, ``decrypt_blobs_chunked(n_threads=)`` and
  ``fold_encrypted_stream(chunk_blobs=, depth=, n_threads=)``: the same
  bytes at every width, equal to the JAX package's.

Every comparison is exact.
"""

from __future__ import annotations

import asyncio
import secrets
import warnings

import numpy as np
import pytest
import torch
from test_torch_plane_reuse import gen_ops
from test_torch_sparse_fold import (
    ACTORS,
    _jax_ops,
    history,
    payloads_of,
    prior_state,
    sparse,
)

from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.backends import xchacha as jx
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel import TpuAccelerator
from crdt_enc_tpu.parallel import mesh as jmesh
from crdt_enc_tpu_torch import (
    HostAccelerator,
    ORSet,
    TorchAccelerator,
    canonical_bytes,
)
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.ops import columnar as C
from crdt_enc_tpu_torch.ops.orset import orset_fold_coo, orset_fold_plain
from crdt_enc_tpu_torch.parallel import accel as A
from crdt_enc_tpu_torch.parallel import make_mesh
from crdt_enc_tpu_torch.parallel import session as PS
from crdt_enc_tpu_torch.utils import trace

ENV = ("CRDT_PLANE_REUSE", "CRDT_SHARDED_STREAM", "CRDT_STREAM_PRODUCERS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    trace.reset()
    yield
    trace.reset()


def t64(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


# ---- orset_fold_coo ---------------------------------------------------------


def coo_inputs(seed, E=16, R=8, n=256, clocked=True):
    rng = np.random.default_rng(seed)
    kind = (rng.random(n) < 0.3).astype(np.int8)
    member = rng.integers(0, E, n).astype(np.int32)
    actor = rng.integers(0, R + 1, n).astype(np.int32)  # R: padding rows
    counter = rng.integers(1, 12, n).astype(np.int32)
    clock0 = (rng.integers(0, 4, R) if clocked else np.zeros(R)).astype(
        np.int32)
    return clock0, kind, member, actor, counter


@pytest.mark.parametrize("clocked", [True, False])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_orset_fold_coo_matches_dense(seed, clocked):
    E, R = 16, 8
    clock0, kind, member, actor, counter = coo_inputs(seed, E, R,
                                                      clocked=clocked)
    jout = JK.orset_fold_coo(clock0, kind, member, actor, counter,
                             num_members=E, num_replicas=R)
    out = orset_fold_coo(*t64(clock0, kind, member, actor, counter),
                         num_members=E, num_replicas=R)
    for j, p in zip(jout, out):
        assert np.array_equal(np.asarray(j), p.numpy())
    members = C.Vocab(range(E))
    replicas = C.Vocab([bytes([i + 1]) * 16 for i in range(R)])
    zero = torch.zeros((E, R), dtype=torch.int32)
    dense = orset_fold_plain(*t64(clock0), zero, zero.clone(),
                             *t64(kind, member, actor, counter),
                             num_members=E, num_replicas=R)
    dense_state = C.orset_planes_to_state(*(x.numpy() for x in dense),
                                          members, replicas)
    coo_state = ORSet()
    coo_state.clock = C.dense_to_vclock(clock0, replicas)
    C.orset_apply_coo(coo_state, *(x.numpy() for x in out), members,
                      replicas)
    assert canonical_bytes(coo_state) == canonical_bytes(dense_state)


def test_orset_fold_coo_past_the_int32_key_space():
    """2·E·R = 2^33 keys and counters past 2^31: the JAX function refuses
    the key space; the port's int64 fold equals a plain Python fold."""
    E = R = 1 << 16
    rng = np.random.default_rng(5)
    n = 300
    kind = (rng.random(n) < 0.3).astype(np.int8)
    member = rng.integers(0, E, n).astype(np.int64)
    actor = rng.integers(0, 6, n).astype(np.int64) * 9_000 + 7
    counter = rng.integers(1, 40, n).astype(np.int64) + (1 << 33)
    clock0 = np.zeros(R, np.int64)
    clock0[7] = (1 << 33) + 20
    with pytest.raises(ValueError):
        JK.orset_fold_coo(clock0.astype(np.int32), kind,
                          member.astype(np.int32), actor.astype(np.int32),
                          counter.astype(np.int32), num_members=E,
                          num_replicas=R)
    clock, skey, smax, is_max = (x.numpy() for x in orset_fold_coo(
        *t64(clock0, kind, member, actor, counter),
        num_members=E, num_replicas=R))
    want: dict = {}
    want_clock = clock0.copy()
    for k, m, a, c in zip(kind, member, actor, counter):
        if k == C.KIND_ADD and c > clock0[a]:
            key = int(m) * R + int(a)
            want_clock[a] = max(want_clock[a], c)
        elif k == C.KIND_RM:
            key = E * R + int(m) * R + int(a)
        else:
            continue
        want[key] = max(want.get(key, 0), int(c))
    assert dict(zip(skey[is_max].tolist(), smax[is_max].tolist())) == want
    assert np.array_equal(clock, want_clock)
    assert list(skey[is_max]) == sorted(want)


# ---- sparse_device ----------------------------------------------------------


def jax_history_ops():
    """The JAX test's op stream: 400 ops over 500 members, six actors."""
    rng = np.random.default_rng(31)
    actors = [bytes([i + 1]) * 16 for i in range(6)]
    host, ops = ORSet(), []
    for i in range(400):
        a = actors[int(rng.integers(len(actors)))]
        m = int(rng.integers(500))
        op = host.rm_ctx(m) if i % 6 == 5 and host.contains(m) else \
            host.add_ctx(a, m)
        host.apply(op)
        ops.append(op)
    return host, ops


def forced(acc):
    acc.SPARSE_MIN_CELLS = 1
    acc.SPARSE_CELLS_PER_ROW = 0
    acc.min_device_batch = 1
    return acc


def test_sparse_device_coo_route_matches_host():
    host, ops = jax_history_ops()

    def port(**kw):
        trace.reset()
        s = forced(TorchAccelerator(device="cpu", **kw)).fold_ops(
            ORSet(), list(ops))
        return canonical_bytes(s), trace.snapshot()["spans"]

    via_host_sort, host_spans = port()
    via_coo, coo_spans = port(sparse_device=True)
    jref = forced(TpuAccelerator(sparse_device=True)).fold_ops(
        JORSet(), _jax_ops(ops))
    assert via_host_sort == via_coo == canonical_bytes(host) == \
        j_canonical_bytes(jref)
    assert "fold.coo" in coo_spans and "fold.coo" not in host_spans
    assert "fold.device" not in coo_spans and "fold.planes" not in coo_spans


def cpu_coo():
    return sparse(TorchAccelerator(device="cpu", min_device_batch=1,
                                   sparse_device=True))


def jax_coo():
    return sparse(TpuAccelerator(min_device_batch=1, sparse_device=True))


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("entry", ["fold_ops", "fold_payloads", "session",
                                   "stream"])
def test_sparse_device_every_entry_point(prior, entry):
    base = prior_state(13) if prior else ORSet()
    _, ops = history(350, 30, 14, state=ORSet.from_obj(base.to_obj()))
    payloads = payloads_of(ops)
    key = secrets.token_bytes(32)
    blobs = [px.encrypt_blob(key, p) for p in payloads]
    state, jstate = ORSet.from_obj(base.to_obj()), JORSet.from_obj(
        base.to_obj())
    acc, jacc = cpu_coo(), jax_coo()
    trace.reset()
    if entry == "fold_ops":
        state = acc.fold_ops(state, list(ops))
        jstate = jacc.fold_ops(jstate, _jax_ops(ops))
    elif entry == "fold_payloads":
        assert acc.fold_payloads(state, payloads, actors_hint=ACTORS)
        assert jacc.fold_payloads(jstate, payloads, actors_hint=ACTORS)
    elif entry == "session":
        from crdt_enc_tpu.parallel import session as JS

        sess = PS.OrsetFoldSession(acc, state, actors_hint=ACTORS)
        jsess = JS.OrsetFoldSession(jacc, jstate, actors_hint=ACTORS)
        for lo in range(0, len(payloads), 9):
            sess.feed(payloads[lo:lo + 9])
            jsess.feed(payloads[lo:lo + 9])
        assert sess.mode == "buffer"
        state, jstate = sess.finish(), jsess.finish()
    else:
        assert acc.fold_encrypted_stream(state, key, blobs,
                                         actors_hint=ACTORS, n_chunks=3)
        assert jacc.fold_encrypted_stream(jstate, key, blobs,
                                          actors_hint=ACTORS, n_chunks=3)
    spans = trace.snapshot()["spans"]
    assert spans["fold.coo"]["count"] == 1
    assert "fold.device" not in spans and "session.sparse_fold" not in spans
    host = HostAccelerator().fold_ops(ORSet.from_obj(base.to_obj()),
                                      list(ops))
    assert canonical_bytes(state) == canonical_bytes(host) == \
        j_canonical_bytes(jstate)


# ---- plane_reuse / CRDT_PLANE_REUSE -----------------------------------------


@pytest.mark.parametrize("env,arg", [
    ("0", None), ("false", None), ("OFF", None), ("disabled", None),
    ("1", None), ("", None), ("banana", None), ("0", True), (None, False),
])
def test_plane_reuse_off_switch(monkeypatch, env, arg):
    if env is not None:
        monkeypatch.setenv("CRDT_PLANE_REUSE", env)
    accel = TorchAccelerator(device="cpu", min_device_batch=1,
                             plane_reuse=arg)
    jaccel = TpuAccelerator(min_device_batch=1, plane_reuse=arg)
    assert accel.plane_reuse == jaccel.plane_reuse
    on = accel.plane_reuse
    ref = TorchAccelerator(device="cpu", min_device_batch=1,
                           plane_reuse=True)
    s, r, clock = ORSet(), ORSet(), {}
    for seed in (8, 9, 10):
        batch = gen_ops(800, seed, clock)
        trace.reset()
        accel.fold_ops(s, list(batch))
        built = "fold.planes" in trace.snapshot()["spans"]
        ref.fold_ops(r, list(batch))
        assert canonical_bytes(s) == canonical_bytes(r)
        assert (accel._plane_cache is not None) == on
        assert built == (seed == 8 or not on)


# ---- CRDT_SHARDED_STREAM ----------------------------------------------------


@pytest.mark.parametrize("env,want,warns", [
    (None, True, False), ("0", False, False), ("off", False, False),
    ("No", False, False), ("1", True, False), ("enabled", True, False),
    ("bogus", True, True),
])
def test_sharded_stream_resolution(monkeypatch, env, want, warns):
    if env is not None:
        monkeypatch.setenv("CRDT_SHARDED_STREAM", env)
    mesh = make_mesh((2, 1), devices=[torch.device("cpu")] * 2)
    jm = jmesh.make_mesh((2, 1))
    got = {}
    for name, make in (
        ("port", lambda: TorchAccelerator(min_device_batch=1, mesh=mesh)),
        ("jax", lambda: TpuAccelerator(min_device_batch=1, mesh=jm)),
    ):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            acc = make()
        got[name] = (acc.sharded_stream, [
            str(w.message) for w in caught
            if "CRDT_SHARDED_STREAM" in str(w.message)])
    assert got["port"] == got["jax"]
    assert got["port"][0] == want and bool(got["port"][1]) == warns
    # an explicit argument wins; no mesh, no sharded stream
    assert TorchAccelerator(min_device_batch=1, mesh=mesh,
                            sharded_stream=False).sharded_stream is False
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert TorchAccelerator(device="cpu").sharded_stream is False


# ---- stream_producers -------------------------------------------------------


def orset_blobs(seed, n_files=30, per_file=6):
    _, ops = history(n_files * per_file, 20, seed)
    key = secrets.token_bytes(32)
    payloads = payloads_of(ops, per_file)
    return key, [px.encrypt_blob(key, p) for p in payloads], ops


@pytest.mark.parametrize("env,accel_width,call_width,want", [
    (None, 2, 0, 2), ("3", 0, 0, 3), ("3", 2, 0, 2), (None, 2, 4, 4),
])
def test_stream_producers_width(monkeypatch, env, accel_width, call_width,
                                want):
    if env is not None:
        monkeypatch.setenv("CRDT_STREAM_PRODUCERS", env)
    key, blobs, ops = orset_blobs(3)
    from crdt_enc_tpu.utils import trace as jtrace

    state, jstate = ORSet(), JORSet()
    trace.reset()
    jtrace.reset()
    assert TorchAccelerator(
        device="cpu", min_device_batch=1, stream_producers=accel_width,
    ).fold_encrypted_stream(state, key, blobs, actors_hint=ACTORS,
                            n_producers=call_width)
    assert TpuAccelerator(
        min_device_batch=1, stream_producers=accel_width,
    ).fold_encrypted_stream(jstate, key, blobs, actors_hint=ACTORS,
                            n_producers=call_width)
    assert trace.snapshot()["gauges"]["stream_producers"] == want == \
        jtrace.snapshot()["gauges"]["stream_producers"]
    assert canonical_bytes(state) == j_canonical_bytes(jstate)


def test_stream_producers_set_the_core_ingest_width():
    """The core's pipelined ingest takes its width from the accelerator,
    as the JAX core does."""
    from test_torch_daemon import SIDES, Twins

    from crdt_enc_tpu.utils import trace as jtrace

    async def scenario():
        tw = Twins()
        r = await tw.remote(40, b"sp")
        ident = await tw.identity(r)
        tw.freeze()
        gauges = {}
        for side, acc, tr in (
            (SIDES[0], TorchAccelerator(device="cpu", min_device_batch=1,
                                        stream_producers=3), trace),
            (SIDES[1], TpuAccelerator(min_device_batch=1,
                                      stream_producers=3), jtrace),
        ):
            tr.reset()
            core = await side.Core.open(side.opts(
                tw.storage(side, r, ident), create=False, accelerator=acc))
            await core.compact()
            gauges[side.name] = tr.snapshot()["gauges"]["stream_producers"]
        assert gauges == {"port": 3, "jax": 3}

    asyncio.run(scenario())


# ---- n_threads, chunk_blobs, depth ------------------------------------------


@pytest.mark.parametrize("n_threads", [0, 1, 2, 5])
def test_decrypt_blobs_n_threads(n_threads):
    key, blobs, _ = orset_blobs(4)
    want = [bytes(v) for v in jx.decrypt_blobs(key, blobs, n_threads)]
    assert [bytes(v) for v in px.decrypt_blobs(key, blobs, n_threads)] == want
    assert [bytes(v) for v in px.decrypt_blobs(key, blobs)] == want


def flat(chunk) -> list:
    if isinstance(chunk, tuple):
        out, offs = chunk
        lo_hi = [int(x) for x in offs]
        return [bytes(out[lo_hi[i]:lo_hi[i + 1]])
                for i in range(len(lo_hi) - 1)]
    return [bytes(v) for v in chunk]


@pytest.mark.parametrize("n_threads,chunk_blobs,n_chunks", [
    (0, 0, 8), (1, 7, 8), (3, 0, 3), (2, 40, 8),
])
def test_decrypt_blobs_chunked_n_threads(n_threads, chunk_blobs, n_chunks):
    key, blobs, _ = orset_blobs(5)
    kw = dict(chunk_blobs=chunk_blobs, n_chunks=n_chunks, n_threads=n_threads)
    got = [flat(c) for c in px.decrypt_blobs_chunked(key, blobs, **kw)]
    want = [flat(c) for c in jx.decrypt_blobs_chunked(key, blobs, **kw)]
    assert got == want
    assert sum(got, []) == [bytes(v) for v in px.decrypt_blobs(key, blobs)]


@pytest.mark.parametrize("chunk_blobs,depth,n_threads,n_producers", [
    (0, 0, 0, 1), (5, 2, 1, 2), (13, 5, 3, 3), (4, 0, 2, 1), (30, 3, 0, 4),
])
def test_fold_encrypted_stream_knobs(chunk_blobs, depth, n_threads,
                                     n_producers):
    key, blobs, ops = orset_blobs(6, n_files=36)
    kw = dict(chunk_blobs=chunk_blobs, depth=depth, n_threads=n_threads,
              n_producers=n_producers)
    trace.reset()
    state = ORSet()
    assert TorchAccelerator(device="cpu", min_device_batch=1) \
        .fold_encrypted_stream(state, key, blobs, actors_hint=ACTORS, **kw)
    chunks = trace.snapshot()["spans"]["stream.reduce"]["count"]
    jstate = JORSet()
    assert TpuAccelerator(min_device_batch=1).fold_encrypted_stream(
        jstate, key, blobs, actors_hint=ACTORS, **kw)
    host = HostAccelerator().fold_ops(ORSet(), list(ops))
    assert canonical_bytes(state) == canonical_bytes(host) == \
        j_canonical_bytes(jstate)
    assert chunks == (-(-len(blobs) // chunk_blobs) if chunk_blobs else
                      min(A.ENCRYPTED_STREAM_CHUNKS, len(blobs)))
