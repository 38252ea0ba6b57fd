"""The port's payload-stream front end on the CPU, against the JAX package.

``TorchAccelerator.fold_payload_stream`` / ``open_payload_stream`` over
``xchacha.decrypt_blobs_chunked`` (a per-chunk native span decode, one
combined fold at ``finish``), and the chunked-decrypt branch of
``Core._read_remote_ops_bulk`` that feeds it, each held byte for byte
against the port's ``fold_payloads``, its host loop and the JAX
package's ``TpuAccelerator.fold_payload_stream`` and ``Core`` on the same
numpy-seeded op files.  After tests/test_bulk_ingest.py:244-310: every
chunking, the dense and the sparse route, an empty iterator, a decline in
mid-stream (the state and its epoch untouched), a decrypt failure raised
at its chunk, and the core's branch taken only where no fold session
opens.

Port accelerators are ``TorchAccelerator(device="cpu",
min_device_batch=1)``: the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import secrets
import uuid

import numpy as np
import pytest

import crdt_enc_tpu.core.core as jcore_mod
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.backends.xchacha import (
    decrypt_blobs_chunked as j_decrypt_blobs_chunked,
)
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import orset_adapter as j_orset_adapter
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu_torch import (
    Core,
    HostAccelerator,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.backends import xchacha
from crdt_enc_tpu_torch.core import core as core_mod
from crdt_enc_tpu_torch.utils import codec, trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

SEED = 16
N_FILES, OPS_PER_FILE, N_ACTORS, N_MEMBERS = 60, 7, 6, 13


def run(coro):
    return asyncio.run(coro)


def cpu_accel(**kw):
    accel = TorchAccelerator(device="cpu", min_device_batch=1)
    for k, v in kw.items():
        setattr(accel, k, v)
    return accel


def op_files(seed: int = SEED, n_files: int = N_FILES, actors=None):
    """``n_files`` op-file payloads of up to OPS_PER_FILE OR-Set ops each
    (about one remove in six, each over the dots seen so far), made from a
    numpy seed; returns ``(actors, payloads, ops)``."""
    rng = np.random.default_rng(seed)
    if actors is None:
        actors = sorted(uuid.UUID(int=i + 1).bytes for i in range(N_ACTORS))
    state = ORSet()
    payloads, all_ops = [], []
    for _ in range(n_files):
        ops = []
        for _ in range(OPS_PER_FILE):
            member = int(rng.integers(N_MEMBERS))
            if rng.random() < 1 / 6:
                op = state.rm_ctx(member)
                if op.ctx.is_empty():
                    continue
            else:
                op = state.add_ctx(actors[int(rng.integers(len(actors)))],
                                   member)
            state.apply(op)
            ops.append(op)
        payloads.append(codec.pack([op.to_obj() for op in ops]))
        all_ops.extend(ops)
    return actors, payloads, all_ops


def host_fold(ops) -> bytes:
    s = ORSet()
    for op in ops:
        s.apply(op)
    return canonical_bytes(s)


CHUNKINGS = [{"n_chunks": 4}, {"n_chunks": 8}, {"n_chunks": 64},
             {"chunk_blobs": 1}]


@pytest.mark.parametrize("route", ["dense", "sparse"])
@pytest.mark.parametrize("chunking", CHUNKINGS, ids=lambda k: "-".join(
    f"{a}{b}" for a, b in k.items()))
def test_stream_equals_fold_payloads_the_host_loop_and_jax(chunking, route):
    actors, payloads, ops = op_files()
    key = secrets.token_bytes(32)
    blobs = [xchacha.encrypt_blob(key, p) for p in payloads]
    sparse = {"SPARSE_MIN_CELLS": 0, "SPARSE_CELLS_PER_ROW": 0}
    accel = cpu_accel(**(sparse if route == "sparse" else {}))
    trace.reset()
    streamed = ORSet()
    assert accel.fold_payload_stream(
        streamed, xchacha.decrypt_blobs_chunked(key, blobs, **chunking),
        actors_hint=actors)
    spans = trace.snapshot()["spans"]
    batch = ORSet()
    assert accel.fold_payloads(batch, xchacha.decrypt_blobs(key, blobs),
                               actors_hint=actors)
    jax_state = JORSet()
    assert TpuAccelerator(min_device_batch=1).fold_payload_stream(
        jax_state, j_decrypt_blobs_chunked(key, blobs, **chunking),
        actors_hint=actors)
    want = host_fold(ops)
    assert canonical_bytes(streamed) == canonical_bytes(batch) == want
    assert j_canonical_bytes(jax_state) == want
    # one span decode per chunk plus the combine at finish
    n_chunks = len(list(range(0, len(blobs), chunking.get(
        "chunk_blobs", -(-len(blobs) // chunking.get("n_chunks", 8))))))
    assert spans["fold.decode"]["count"] == n_chunks + 1
    # the dense route folds through the kernel's entry (its plain version
    # here), the sparse regime through the host sort
    assert ("fold.device" in spans) == (route == "dense")


@pytest.mark.parametrize("n_producers", [1, 4])
@pytest.mark.parametrize("n_chunks", [1, 3, 8])
def test_encrypted_stream_chunks_and_producers_equal_the_jax_call(
        n_chunks, n_producers):
    """``fold_encrypted_stream(..., n_chunks=, n_producers=)`` as the JAX
    accelerator takes them: the same state bytes at every chunk count and
    producer width, the chunk count visible as ``stream.decrypt`` work."""
    actors, payloads, ops = op_files()
    key = secrets.token_bytes(32)
    blobs = [xchacha.encrypt_blob(key, p) for p in payloads]
    trace.reset()
    streamed = ORSet()
    assert cpu_accel().fold_encrypted_stream(
        streamed, key, blobs, actors_hint=actors, n_chunks=n_chunks,
        n_producers=n_producers)
    spans = trace.snapshot()["spans"]
    assert spans["stream.decode"]["count"] == n_chunks
    assert spans["stream.decrypt"]["count"] >= n_chunks
    jax_state = JORSet()
    assert TpuAccelerator(min_device_batch=1).fold_encrypted_stream(
        jax_state, key, blobs, actors_hint=actors, n_chunks=n_chunks,
        n_producers=n_producers)
    assert canonical_bytes(streamed) == j_canonical_bytes(jax_state) == \
        host_fold(ops)


def test_stream_folds_onto_a_state_with_history():
    """A second stream on top of a folded state equals the host loop over
    both batches, and the JAX stream on the same inputs."""
    actors, first, ops1 = op_files(seed=SEED)
    # the second history's dots restart per actor, so the replay gate
    # drops those the first already covers
    _, second, ops2 = op_files(seed=SEED + 1, actors=actors)
    accel = cpu_accel()
    state, jstate = ORSet(), JORSet()
    jaccel = TpuAccelerator(min_device_batch=1)
    for payloads in (first, second):
        chunks = [payloads[i : i + 9] for i in range(0, len(payloads), 9)]
        assert accel.fold_payload_stream(state, iter(chunks),
                                         actors_hint=actors)
        assert jaccel.fold_payload_stream(jstate, iter(chunks),
                                          actors_hint=actors)
    assert canonical_bytes(state) == host_fold(ops1 + ops2) == \
        j_canonical_bytes(jstate)


def test_an_empty_iterator_folds_nothing():
    accel = cpu_accel()
    untouched = ORSet()
    epoch = getattr(untouched, "_mut", None)
    assert accel.fold_payload_stream(untouched, iter([]))
    assert canonical_bytes(untouched) == canonical_bytes(ORSet())
    assert getattr(untouched, "_mut", None) == epoch
    stream = accel.open_payload_stream(ORSet())
    assert stream.feed([]) and stream.finish()
    with pytest.raises(RuntimeError):
        stream.finish()
    assert TpuAccelerator(min_device_batch=1).fold_payload_stream(
        JORSet(), iter([]))


def test_an_unknown_actor_mid_stream_declines_and_leaves_the_state():
    """A chunk the native decoder declines (an actor outside the table)
    ends the stream with False; the state, folded before, keeps its bytes
    and its mutation epoch, and a closable iterator is closed."""
    actors, payloads, ops = op_files()
    stranger = uuid.UUID(int=99).bytes
    s = ORSet()
    bad = codec.pack([s.add_ctx(stranger, "n").to_obj()])
    key = secrets.token_bytes(32)
    blobs = [xchacha.encrypt_blob(key, p) for p in payloads[:20] + [bad]
             + payloads[20:]]
    accel = cpu_accel()
    state = ORSet()
    assert accel.fold_payloads(state, payloads[:5], actors_hint=actors)
    before, epoch = canonical_bytes(state), state._mut
    chunks = xchacha.decrypt_blobs_chunked(key, blobs, chunk_blobs=7)
    assert accel.fold_payload_stream(state, chunks, actors_hint=actors) is False
    assert canonical_bytes(state) == before and state._mut == epoch
    assert chunks.gi_frame is None  # closed, its lookahead cancelled
    jstate = JORSet()
    assert TpuAccelerator(min_device_batch=1).fold_payload_stream(
        jstate, j_decrypt_blobs_chunked(key, blobs, chunk_blobs=7),
        actors_hint=actors) is False
    assert j_canonical_bytes(jstate) == canonical_bytes(ORSet())
    # a declined stream refuses to finish, and keeps declining
    stream = accel.open_payload_stream(ORSet(), actors_hint=actors)
    assert stream.feed([bad]) is False and stream.feed(payloads[:2]) is False
    with pytest.raises(RuntimeError):
        stream.finish()


def test_open_payload_stream_declines_what_has_no_columnar_path():
    from crdt_enc_tpu_torch.models.counters import GCounter

    accel = cpu_accel()
    assert accel.open_payload_stream(GCounter()) is None
    big = ORSet()
    big.clock.counters[b"a" * 16] = 2**40  # past the decoder's int32
    assert accel.open_payload_stream(big) is None
    assert accel.fold_payload_stream(GCounter(), iter([[b"x"]])) is False


@pytest.mark.parametrize("cores", [1, 8])
def test_decrypt_blobs_chunked_equals_the_one_shot_open(cores, monkeypatch):
    """Each yielded chunk is the packed open of its span, on the lookahead
    thread and on the one-core synchronous route; a bad blob raises at its
    chunk, after the chunks before it."""
    import os

    monkeypatch.setattr(os, "cpu_count", lambda: cores)
    _, payloads, _ = op_files()
    key = secrets.token_bytes(32)
    blobs = [xchacha.encrypt_blob(key, p) for p in payloads]
    got = []
    trace.reset()
    for out, offs in xchacha.decrypt_blobs_chunked(key, blobs, n_chunks=7):
        got.extend(bytes(out[offs[i] : offs[i + 1]])
                   for i in range(len(offs) - 1))
    assert got == payloads
    # one stream.decrypt span a chunk, on the lookahead thread or inline
    assert trace.snapshot()["spans"]["stream.decrypt"]["count"] == 7
    assert list(xchacha.decrypt_blobs_chunked(key, [])) == []
    bad = bytearray(blobs[25])
    bad[-1] ^= 1
    chunks = xchacha.decrypt_blobs_chunked(
        key, blobs[:25] + [bytes(bad)] + blobs[26:], chunk_blobs=10)
    assert len(next(chunks)[1]) == 11 and len(next(chunks)[1]) == 11
    with pytest.raises(xchacha.AeadError):
        next(chunks)


# ---- the core's bulk branch -------------------------------------------------


class NoSessionAccel(TorchAccelerator):
    """The port accelerator without fold sessions: the core reads op files
    through the whole-batch bulk path, which takes the payload stream."""

    def can_open_fold_session(self, state) -> bool:
        return False


class JNoSessionAccel(TpuAccelerator):
    def can_open_fold_session(self, state) -> bool:
        return False


def port_opts(storage, accel):
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel,
    )


def jax_opts(storage, accel):
    return JOpenOptions(
        storage=storage, cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(), adapter=j_orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel,
    )


async def written_remote(n_files: int, rotate_at: int | None = None,
                         stranger_at: int | None = None):
    """An encrypted remote of ``n_files`` op files from two writers (the
    numpy-seeded ops of :func:`op_files`, re-made under the writers'
    actors); optionally a key rotation and a remove whose context names an
    actor no op file is listed under (the decoder declines it)."""
    remote = MemoryRemote()
    writers = [await Core.open(port_opts(MemoryStorage(remote),
                                         HostAccelerator()))
               for _ in range(2)]
    rng = np.random.default_rng(SEED)
    for i in range(n_files):
        w = writers[i % 2]
        if rotate_at is not None and i == rotate_at:
            await w.rotate_key()
        if stranger_at is not None and i == stranger_at:
            from crdt_enc_tpu_torch.models.orset import RmOp
            from crdt_enc_tpu_torch.models.vclock import VClock

            await w.apply_ops([RmOp(0, VClock({uuid.UUID(int=77).bytes: 3}))])
            continue
        ops = []
        for _ in range(int(rng.integers(1, OPS_PER_FILE + 1))):
            member = int(rng.integers(N_MEMBERS))
            if rng.random() < 1 / 6:
                op = w.with_state(lambda s, m=member: s.rm_ctx(m))
                if op.ctx.is_empty():
                    continue
            else:
                op = w.with_state(
                    lambda s, m=member: s.add_ctx(w.actor_id, m))
            await w.apply_ops([op])
            ops.append(op)
    return remote


def jax_copy(remote):
    return JMemoryRemote(metas=dict(remote.metas), states=dict(remote.states),
                         ops={a: dict(v) for a, v in remote.ops.items()},
                         deltas={a: dict(v) for a, v in remote.deltas.items()})


@pytest.mark.parametrize("case", ["streamed", "declined", "two_keys"])
def test_core_bulk_stream_branch_equals_the_jax_core(case, monkeypatch):
    """A reader whose accelerator opens no fold session takes the bulk
    path; with one sealing key it decrypts ``BULK_STREAM_CHUNK`` files at
    a time through the payload stream (``stream.decrypt`` spans tagged with
    the chunk index).  A decline replays the batch per op and two keys
    take the whole-batch open.  Each gives the JAX core's bytes and
    cursors, and the host loop's."""
    monkeypatch.setattr(core_mod, "BULK_STREAM_CHUNK", 16)
    monkeypatch.setattr(jcore_mod, "BULK_STREAM_CHUNK", 16)
    kw = {"streamed": {}, "declined": {"stranger_at": 40},
          "two_keys": {"rotate_at": 30}}[case]

    async def go():
        remote = await written_remote(90, **kw)
        n_files = sum(len(v) for v in remote.ops.values())
        jr = jax_copy(remote)
        trace.reset()
        trace.enable_events()
        try:
            port = await Core.open(port_opts(MemoryStorage(remote),
                                             NoSessionAccel("cpu", 1)))
            await port.read_remote()
            snap = trace.snapshot()
            events = trace.events()
        finally:
            trace.enable_events(False)
        host = await Core.open(port_opts(MemoryStorage(remote),
                                         HostAccelerator()))
        await host.read_remote()
        jax = await JCore.open(jax_opts(JMemoryStorage(jr),
                                        JNoSessionAccel(min_device_batch=1)))
        await jax.read_remote()
        pb = port.with_state(canonical_bytes)
        assert pb == host.with_state(canonical_bytes)
        assert pb == jax.with_state(j_canonical_bytes)
        assert port.info().next_op_versions.to_obj() == \
            jax.info().next_op_versions.to_obj()
        decrypts = [e for e in events if e.get("name") == "stream.decrypt"]
        counters = snap["counters"]
        if case == "two_keys":
            assert not decrypts
            assert counters["op_files_bulk_folded"] == n_files
        else:
            assert sorted(e["meta"] for e in decrypts) == \
                list(range(-(-n_files // 16)))
            if case == "streamed":
                assert counters["op_files_bulk_folded"] == n_files
                assert "ops_folded" not in counters
            else:
                assert counters.get("op_files_bulk_folded", 0) == 0
                assert counters["ops_folded"] > 0

    run(go())


def test_core_with_fold_sessions_does_not_take_the_stream(monkeypatch):
    """With fold sessions the core reads through the pipelined route and
    never opens a payload stream, as in the JAX package."""
    opened = []

    class Probe(TorchAccelerator):
        def open_payload_stream(self, state, actors_hint=()):
            opened.append(state)
            return super().open_payload_stream(state, actors_hint)

    async def go():
        remote = await written_remote(40)
        reader = await Core.open(port_opts(MemoryStorage(remote),
                                           Probe("cpu", 1)))
        await reader.read_remote()
        host = await Core.open(port_opts(MemoryStorage(remote),
                                         HostAccelerator()))
        await host.read_remote()
        assert reader.with_state(canonical_bytes) == \
            host.with_state(canonical_bytes)

    run(go())
    assert opened == []
