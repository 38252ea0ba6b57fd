"""The port's fold sessions (crdt_enc_tpu_torch/parallel/session.py) and
its pipelined ``read_remote`` (``Core._read_remote_ops_pipelined``)
against the JAX package's and the per-op host loop, on the CPU.

Mirrors tests/test_fold_session.py: every session mode (BUFFER,
HOST_REDUCE, DEVICE_STREAM — the last two forced through the module
constants, as the JAX tests force them) lands byte-equal to the host loop
and to the JAX session in the same mode at several chunkings; the numpy
combine never diverges from the torch one; declines leave the state and
its epoch untouched; and the pipelined core ingest — chunk boundaries,
counters, a write landing mid-ingest, a mid-stream decline, a failing
scanner — matches a host-loop reader and the JAX ``Core`` on the same
remote.  Every test that drives the pipeline runs under a time bound.

The port's accelerator is ``TorchAccelerator(device="cpu",
min_device_batch=1)``: DEVICE_STREAM's planes and folds run through the
plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import asyncio
import os
import secrets
import unittest.mock as mock

import numpy as np
import pytest
import torch

import crdt_enc_tpu.parallel.session as JS
from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import PNCounter as JPNCounter
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel import TpuAccelerator

import crdt_enc_tpu_torch.parallel.accel as A
import crdt_enc_tpu_torch.parallel.session as S
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    HostAccelerator,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    PNCounter,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    lwwmap_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.backends import fs as fsmod
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.models.orset import AddOp
from crdt_enc_tpu_torch.models.vclock import Dot
from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.utils import codec, trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

ACTORS = [bytes([i + 1]) * 16 for i in range(5)]
TIMEOUT_S = 60
MODES = [None, "host_reduce", "device_stream"]


def run(coro, seconds: float = TIMEOUT_S):
    async def bounded():
        return await asyncio.wait_for(coro, timeout=seconds)

    return asyncio.run(bounded())


def cpu_accel():
    return TorchAccelerator(device="cpu", min_device_batch=1)


@pytest.fixture(autouse=True)
def _restore_thresholds():
    cells, jcells = S.HOST_PLANE_CELLS, JS.HOST_PLANE_CELLS
    yield
    S.HOST_PLANE_CELLS, JS.HOST_PLANE_CELLS = cells, jcells


# ---- session unit level -----------------------------------------------------


def history(n_ops, n_members, seed=0, rm_every=7, state=None):
    """A well-formed multi-actor op history on the port's host OR-Set,
    and the host-folded state."""
    rng = np.random.default_rng(seed)
    state = state if state is not None else ORSet()
    ops = []
    for i in range(n_ops):
        a = ACTORS[int(rng.integers(len(ACTORS)))]
        m = int(rng.integers(n_members))
        if i % rm_every == rm_every - 1 and state.contains(m):
            op = state.rm_ctx(m)
        else:
            op = state.add_ctx(a, m)
        state.apply(op)
        ops.append(op)
    return state, ops


def payloads_of(ops, per_file=10):
    """Op files as the wire carries them (msgpack op arrays)."""
    return [codec.pack([op.to_obj() for op in ops[lo : lo + per_file]])
            for lo in range(0, len(ops), per_file)]


def force(mode):
    """Force the promotion target in both packages (the first feed then
    promotes because ``_buffered_bytes`` is pushed past the bound)."""
    if mode == "device_stream":
        S.HOST_PLANE_CELLS = -1
        JS.HOST_PLANE_CELLS = -1


def run_both(ops, *, chunk_files, mode=None, state_obj=None):
    """The same payload chunks through the port's session and the JAX
    session in the same mode.  Returns (port state, JAX state, port
    session)."""
    force(mode)
    state = ORSet.from_obj(state_obj) if state_obj else ORSet()
    jstate = JORSet.from_obj(state_obj) if state_obj else JORSet()
    sess = S.OrsetFoldSession(cpu_accel(), state, actors_hint=ACTORS)
    jsess = JS.OrsetFoldSession(TpuAccelerator(min_device_batch=1), jstate,
                                actors_hint=ACTORS)
    if mode is not None:
        sess._buffered_bytes = jsess._buffered_bytes = 10**9
    payloads = payloads_of(ops)
    for lo in range(0, len(payloads), chunk_files):
        sess.feed(payloads[lo : lo + chunk_files])
        jsess.feed(payloads[lo : lo + chunk_files])
    assert sess.mode == jsess.mode == (mode or "buffer")
    return sess.finish(), jsess.finish(), sess


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("chunk_files", [1, 3, 50])
def test_session_modes_match_host(mode, chunk_files):
    host, ops = history(400, 23, seed=3)
    folded, ref, sess = run_both(ops, chunk_files=chunk_files, mode=mode)
    assert canonical_bytes(folded) == canonical_bytes(host) == j_canonical_bytes(ref)
    assert folded._mut == 1
    if mode == "device_stream":
        assert sess.device_chunks >= -(-40 // chunk_files)
    else:
        assert sess.device_chunks == 0


@pytest.mark.parametrize("mode", ["host_reduce", "device_stream"])
def test_session_into_existing_state_matches_host(mode):
    """A tail folded into a state that holds a prefix (the snapshot-resume
    shape), removes whose targets live only in the prefix included."""
    host, ops = history(300, 17, seed=5, rm_every=5)
    prefix = ORSet()
    for op in ops[:120]:
        prefix.apply(op)
    folded, ref, _ = run_both(ops[120:], chunk_files=2, mode=mode,
                              state_obj=prefix.to_obj())
    assert canonical_bytes(folded) == canonical_bytes(host) == j_canonical_bytes(ref)


@pytest.mark.parametrize("mode", ["host_reduce", "device_stream"])
def test_session_keeps_untouched_preexisting_members(mode):
    """A pre-existing member whose dot is OLDER than the batch's dots for
    the same actor, and which the batch never mentions, survives: the
    combine is op-apply, not the CvRDT merge."""
    actor = ACTORS[0]
    base = ORSet()
    base.apply(base.add_ctx(actor, "old-untouched"))
    host = ORSet.from_obj(base.to_obj())
    ops = []
    for i in range(40):
        op = host.add_ctx(actor, f"new-{i}")
        host.apply(op)
        ops.append(op)
    folded, ref, _ = run_both(ops, chunk_files=2, mode=mode,
                              state_obj=base.to_obj())
    assert folded.contains("old-untouched")
    assert canonical_bytes(folded) == canonical_bytes(host) == j_canonical_bytes(ref)


def test_host_and_device_combine_never_diverge():
    rng = np.random.default_rng(7)
    for _ in range(20):
        E, R = int(rng.integers(1, 12)), int(rng.integers(1, 6))
        clock0 = rng.integers(0, 9, R).astype(np.int32)
        add0 = rng.integers(0, 9, (E, R)).astype(np.int32)
        rm0 = rng.integers(0, 9, (E, R)).astype(np.int32)
        add_b = rng.integers(0, 12, (E, R)).astype(np.int32)
        rm_b = rng.integers(0, 12, (E, R)).astype(np.int32)
        h = S.apply_batch_planes_host(clock0, add0, rm0, add_b, rm_b)
        d = P.orset_apply_batch_planes(*(torch.from_numpy(x) for x in
                                         (clock0, add0, rm0, add_b, rm_b)))
        j = JS.apply_batch_planes_host(clock0, add0, rm0, add_b, rm_b)
        jd = JK.orset_apply_batch_planes(clock0, add0, rm0, add_b, rm_b)
        for a, b, c, e in zip(h, d, j, jd):
            assert np.array_equal(a, b.numpy())
            assert np.array_equal(a, c)
            assert np.array_equal(a, np.asarray(e))


def test_counter_session_matches_host():
    host = PNCounter()
    ops = []
    for i in range(200):
        a = ACTORS[i % 3]
        op = host.inc(a, i + 1) if i % 4 else host.dec(a, 2)
        host.apply(op)
        ops.append([op[0], op[1].to_obj()])
    payloads = [codec.pack(ops[lo : lo + 9]) for lo in range(0, len(ops), 9)]
    state, jstate = PNCounter(), JPNCounter()
    sess = S.open_fold_session(cpu_accel(), state, actors_hint=ACTORS)
    jsess = JS.open_fold_session(TpuAccelerator(min_device_batch=1), jstate,
                                 actors_hint=ACTORS)
    assert isinstance(sess, S.CounterFoldSession)
    for p in payloads:
        sess.feed([p])
        jsess.feed([p])
    sess.finish()
    jsess.finish()
    assert canonical_bytes(state) == canonical_bytes(host) == j_canonical_bytes(jstate)
    assert state.read() == host.read()


@pytest.mark.parametrize("mode", MODES)
def test_session_decline_leaves_chunk_unconsumed(mode):
    """A chunk the decoder declines raises with nothing of it consumed,
    the state and its epoch stay untouched until finish, and the good
    chunks still land."""
    force(mode)
    state = ORSet()
    sess = S.OrsetFoldSession(cpu_accel(), state, actors_hint=ACTORS)
    if mode is not None:
        sess._buffered_bytes = 10**9
    host, ops = history(40, 7, seed=2)
    sess.feed(payloads_of(ops))
    rows = sess.rows_fed
    for bad in ([b"\xc1 definitely not msgpack ops"],
                [codec.pack([[0, 5, [b"\x99" * 16, 1]]])]):  # unknown actor
        with pytest.raises(S.SessionDeclined):
            sess.feed(bad)
    assert sess.rows_fed == rows
    assert state._mut == 0 and not state.entries
    folded = sess.finish()
    assert canonical_bytes(folded) == canonical_bytes(host)
    assert folded._mut == 1
    with pytest.raises(RuntimeError):
        sess.finish()


def test_member_collision_declines_before_mutation():
    sess = S.OrsetFoldSession(cpu_accel(), ORSet(), actors_hint=ACTORS)
    sess.feed([codec.pack([[0, 1, [ACTORS[0], 1]]])])
    with pytest.raises(S.SessionDeclined):
        sess.feed([codec.pack([[0, True, [ACTORS[0], 2]]])])
    assert sess.state._mut == 0


def test_concurrent_new_actor_before_finish():
    """An apply from an actor unknown at session start, landing before
    finish(), is neither lost nor a crash."""
    host, ops = history(200, 11, seed=8)
    state = ORSet()
    sess = S.OrsetFoldSession(cpu_accel(), state, actors_hint=ACTORS)
    sess._buffered_bytes = 10**9
    payloads = payloads_of(ops)
    for lo in range(0, len(payloads), 4):
        sess.feed(payloads[lo : lo + 4])
    newcomer = b"\xaa" * 16
    late = state.add_ctx(newcomer, b"late-member")
    state.apply(late)
    host.apply(AddOp(b"late-member", late.dot))
    folded = sess.finish()
    assert folded.contains(b"late-member")
    assert canonical_bytes(folded) == canonical_bytes(host)


def test_session_supported_types():
    acc = cpu_accel()
    assert acc.can_open_fold_session(ORSet())
    assert acc.can_open_fold_session(PNCounter())
    assert not acc.can_open_fold_session(lwwmap_adapter().new())
    assert acc.open_fold_session(lwwmap_adapter().new()) is None
    assert isinstance(acc.open_fold_session(PNCounter()), S.CounterFoldSession)


@pytest.mark.parametrize("mode", ["host_reduce", "device_stream"])
def test_encrypted_stream_forced_mode_matches_host(mode, monkeypatch):
    """The overlapped pipeline (threaded decrypt and decode → session)
    forced into each reduce mode lands on the host loop's bytes and on
    the JAX pipeline's in the same mode."""
    monkeypatch.setattr(S, "BUFFER_BYTES", 0)
    monkeypatch.setattr(JS, "BUFFER_BYTES", 0)
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 5)
    force(mode)
    host, ops = history(300, 17, seed=6)
    key = secrets.token_bytes(32)
    blobs = [px.encrypt_blob(key, p) for p in payloads_of(ops)]
    streamed = ORSet()
    assert cpu_accel().fold_encrypted_stream(streamed, key, blobs,
                                             actors_hint=ACTORS)
    ref = JORSet()
    assert TpuAccelerator(min_device_batch=1).fold_encrypted_stream(
        ref, key, blobs, actors_hint=ACTORS, n_chunks=5)
    assert canonical_bytes(streamed) == canonical_bytes(host) == j_canonical_bytes(ref)


# ---- through the live core --------------------------------------------------


def popts(storage, adapter=None, accel=None):
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(), key_cryptor=PlainKeyCryptor(),
        adapter=adapter or orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel if accel is not None else cpu_accel(),
    )


def jopts(storage, adapter):
    return JOpenOptions(
        storage=storage, cryptor=JXChaChaCryptor(), key_cryptor=JPlainKeyCryptor(),
        adapter=adapter, supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=TpuAccelerator(min_device_batch=1),
    )


def chunked(base_cls, files_per_chunk):
    """A storage class whose op chunks hold a few files each, to exercise
    the pipeline's chunk boundaries."""

    class Chunked(base_cls):
        async def iter_op_chunks(self, wanted, max_bytes=1 << 30):
            files = await self.load_ops(wanted)
            for lo in range(0, len(files), files_per_chunk):
                yield files[lo : lo + files_per_chunk]

    return Chunked


async def jax_read(tmp_path, remote, adapter):
    jr = await JCore.open(jopts(JFsStorage(str(tmp_path / "jax"), remote),
                                adapter()))
    await jr.read_remote()
    return jr.with_state(j_canonical_bytes)


@pytest.mark.parametrize("files_per_chunk", [1, 5, 64])
def test_pipelined_ingest_matches_host_core(files_per_chunk, tmp_path):
    remote = str(tmp_path / "remote")

    async def go():
        producer = await Core.open(popts(FsStorage(str(tmp_path / "w"), remote)))
        for w in range(40):
            await producer.update(lambda s, w=w: s.add_ctx(producer.actor_id, w % 19))
        for m in (3, 8):
            await producer.update(lambda s, m=m: s.rm_ctx(m))
        host = await Core.open(popts(FsStorage(str(tmp_path / "h"), remote),
                                     accel=HostAccelerator()))
        await host.read_remote()
        reader = await Core.open(popts(
            chunked(FsStorage, files_per_chunk)(str(tmp_path / "r"), remote)))
        trace.reset()
        await reader.read_remote()
        snap = trace.snapshot()
        assert snap["spans"]["ops.chunk_decrypt"]["count"] == -(-42 // files_per_chunk)
        assert snap["counters"]["op_files_bulk_folded"] == 42
        assert snap["counters"]["op_files_loaded"] == 42
        got = reader.with_state(canonical_bytes)
        assert got == host.with_state(canonical_bytes)
        assert got == await jax_read(tmp_path, remote, jadapters.orset_adapter)
        # re-entrant: a second read is a no-op
        await reader.read_remote()
        assert reader.with_state(canonical_bytes) == got

    run(go())


def test_pipelined_ingest_counters(tmp_path):
    remote = str(tmp_path / "remote")

    async def go():
        producer = await Core.open(popts(FsStorage(str(tmp_path / "w"), remote),
                                         pncounter_adapter()))
        for i in range(30):
            await producer.update(
                lambda s, i=i: s.inc(producer.actor_id, i + 1) if i % 3
                else s.dec(producer.actor_id, 1))
        host = await Core.open(popts(FsStorage(str(tmp_path / "h"), remote),
                                     pncounter_adapter(), HostAccelerator()))
        await host.read_remote()
        reader = await Core.open(popts(
            chunked(FsStorage, 4)(str(tmp_path / "r"), remote), pncounter_adapter()))
        await reader.read_remote()
        got = reader.with_state(canonical_bytes)
        assert got == host.with_state(canonical_bytes)
        assert got == await jax_read(tmp_path, remote, jadapters.pncounter_adapter)
        assert reader.with_state(lambda s: s.read()) == host.with_state(
            lambda s: s.read())

    run(go())


def test_sessionless_state_takes_the_whole_batch_flow():
    """No session for the LWW map: the pipeline bows out before reading,
    and the whole-batch flow folds everything."""

    async def go():
        remote = MemoryRemote()
        producer = await Core.open(popts(MemoryStorage(remote), lwwmap_adapter()))
        for i in range(20):
            await producer.update(lambda s, i=i: s.put(f"k{i % 4}", 10 + i,
                                                       producer.actor_id, i))
        host = await Core.open(popts(MemoryStorage(remote), lwwmap_adapter(),
                                     HostAccelerator()))
        await host.read_remote()
        reader = await Core.open(popts(MemoryStorage(remote), lwwmap_adapter()))
        trace.reset()
        await reader.read_remote()
        spans = trace.snapshot()["spans"]
        assert "ops.chunk_decrypt" not in spans and "ops.bulk_decrypt" in spans
        assert reader.with_state(canonical_bytes) == host.with_state(canonical_bytes)

    run(go())


def test_concurrent_apply_during_pipelined_ingest_survives():
    """A local write landing BETWEEN pipeline chunks is not clobbered by
    the session's finish."""

    async def go():
        remote = MemoryRemote()
        producer = await Core.open(popts(MemoryStorage(remote)))
        for w in range(30):
            await producer.update(lambda s, w=w: s.add_ctx(producer.actor_id, w))
        holder = {}

        class Racing(chunked(MemoryStorage, 5)):
            async def iter_op_chunks(self, wanted, max_bytes=1 << 30):
                n = 0
                async for chunk in super().iter_op_chunks(wanted, max_bytes):
                    yield chunk
                    n += 1
                    if n == 2 and "core" in holder:
                        core = holder["core"]
                        await core.update(
                            lambda s: s.add_ctx(core.actor_id, b"local-mid"))

        reader = await Core.open(popts(Racing(remote)))
        holder["core"] = reader
        await reader.read_remote()
        assert reader.with_state(lambda s: s.contains(b"local-mid"))
        for w in range(30):
            assert reader.with_state(lambda s, w=w: s.contains(w)), w

    run(go())


def test_mid_stream_decline_keeps_version_order(tmp_path):
    """A chunk the decoder declines (an op whose dot actor appears in no op
    directory) flips the pipeline to per-op folds; chunks in flight fold
    IN ORDER first, or the version-gap check would trip."""
    remote = str(tmp_path / "remote")

    async def go():
        producer = await Core.open(popts(FsStorage(str(tmp_path / "w"), remote)))
        fake = b"\xbb" * 16
        for w in range(30):
            if w == 12:
                await producer.apply_ops([AddOp(999, Dot(fake, 1))])
            else:
                await producer.update(lambda s, w=w: s.add_ctx(producer.actor_id, w))
        host = await Core.open(popts(FsStorage(str(tmp_path / "h"), remote),
                                     accel=HostAccelerator()))
        await host.read_remote()
        reader = await Core.open(popts(chunked(FsStorage, 3)(str(tmp_path / "r"),
                                                             remote)))
        trace.reset()
        await reader.read_remote()
        assert "ops.fold" in trace.snapshot()["spans"]  # the per-op tail
        got = reader.with_state(canonical_bytes)
        assert got == host.with_state(canonical_bytes)
        assert got == await jax_read(tmp_path, remote, jadapters.orset_adapter)
        assert reader.with_state(lambda s: s.contains(999))
        assert (reader.info().next_op_versions.get(producer.actor_id)
                == host.info().next_op_versions.get(producer.actor_id) == 30)

    run(go())


def test_fs_chunks_concatenate_to_load_ops_in_both_packages(tmp_path):
    """FsStorage's bounded chunks, joined, are ``load_ops`` — per-actor
    version order across chunk ends — and equal the JAX backend's."""

    async def go():
        s = FsStorage(str(tmp_path / "l"), str(tmp_path / "remote"))
        js = JFsStorage(str(tmp_path / "jl"), str(tmp_path / "remote"))
        wanted = []
        for a in range(3):
            actor = bytes([a + 1]) * 16
            for v in range(1, 12):
                await s.store_ops(actor, v, bytes([v]) * (10 + 7 * v))
            wanted.append((actor, 1 + a))
        whole = await s.load_ops(wanted)
        for max_bytes in (1, 100, 1000, 1 << 20):
            chunks = [c async for c in s.iter_op_chunks(wanted, max_bytes)]
            jchunks = [c async for c in js.iter_op_chunks(wanted, max_bytes)]
            assert [f for c in chunks for f in c] == whole
            assert chunks == jchunks, max_bytes

    run(go())


def test_scan_error_propagates_not_hangs(tmp_path):
    """A scanner that dies delivers its failure to the chunk emitter
    instead of leaving it waiting for a sentinel that never comes."""
    from crdt_enc_tpu_torch import native

    async def go():
        s = FsStorage(str(tmp_path / "l"), str(tmp_path / "remote"))
        actor = b"\x07" * 16
        for v in range(1, 8):
            await s.store_ops(actor, v, bytes([v]) * 30)
        lib = native.load()
        real_rf = fsmod._read_file

        def failing_rf(path):
            if path.endswith(os.sep + "4"):
                raise PermissionError(path)
            return real_rf(path)

        # a native read that races forces the per-file re-read of the round
        with mock.patch.object(lib, "read_op_files", lambda *a: -1), \
                mock.patch.object(fsmod, "_read_file", failing_rf):
            with pytest.raises(PermissionError):
                async for _ in s.iter_op_chunks([(actor, 1)]):
                    pass

    run(go(), seconds=30)
