"""The port's device-decode experiment (``CRDT_DEVICE_DECODE=1``,
``crdt_enc_tpu_torch/ops/device_decode.py``) against the JAX package's.

On qualifying (all fixed-stride add) corpora the device arm (here on
``device="cpu"``), the host control arm, the port's native decoder and
both JAX arms give the same columns, array for array; anything outside
the fixed-stride subset, or an unknown actor, declines (None) in both
packages; a device the machine lacks raises instead of declining; and a
fold session gives the same state bytes with the gate on and off.

The JAX package is imported by the ``jdd`` fixture, so the card-marked
case also runs on a machine with the card and without JAX.
"""

from __future__ import annotations

import secrets

import numpy as np
import pytest
import torch

from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
from crdt_enc_tpu_torch.backends.xchacha import decrypt_blobs_packed, encrypt_blob
from crdt_enc_tpu_torch.ops import device_decode as dd
from crdt_enc_tpu_torch.ops import stream as S
from crdt_enc_tpu_torch.ops.native_decode import decode_orset_payload_batch
from crdt_enc_tpu_torch.utils import codec, trace


@pytest.fixture
def jdd():
    """The JAX package's device_decode module."""
    return pytest.importorskip("crdt_enc_tpu.ops.device_decode")


def adds_corpus(n_payloads=40, opf=9, R=17, seed=3, high_actors=0):
    """Payloads of fixed-stride add ops (member and counter < 128) over R
    random actors, ``high_actors`` of them with a first byte >= 0x80; the
    packed ``(buffer, offsets)`` pair; the sorted actor table."""
    rng = np.random.default_rng(seed)
    actors = [rng.bytes(16) for _ in range(R)]
    for i in range(high_actors):
        actors[i] = bytes([0x80 + i * 0x3F % 0x80]) + actors[i][1:]
    if high_actors:
        actors[0] = b"\xff" * 16
    actors = sorted(actors)
    payloads = [codec.pack([
        [0, int(rng.integers(0, 128)),
         [actors[int(rng.integers(0, R))], int(rng.integers(1, 128))]]
        for _ in range(opf)]) for _ in range(n_payloads)]
    return payloads, pack(payloads), actors


def pack(payloads):
    offs = np.zeros(len(payloads) + 1, np.uint64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    return np.frombuffer(b"".join(payloads), np.uint8), offs


def rows(decoded):
    """(kind, member objects, actor indices, counters) as lists."""
    kind, m_idx, a_idx, ctr, members = decoded[:5]
    return (np.asarray(kind).tolist(),
            [members[int(i)] for i in np.asarray(m_idx).tolist()],
            np.asarray(a_idx).tolist(), np.asarray(ctr).tolist())


@pytest.mark.parametrize("seed,high", [(3, 0), (4, 3), (5, 17)])
def test_arms_give_the_jax_columns(jdd, seed, high):
    """Device (cpu), host, native and both JAX arms: equal rows; the
    device and host arms equal the JAX arms array for array (dtypes
    included), member tables and member bytes too."""
    payloads, packed, actors = adds_corpus(seed=seed, high_actors=high)
    got = dd.decode_adds_device(packed, actors, "cpu")
    host = dd.decode_adds_host(packed, actors)
    jdev = jdd.decode_adds_device(packed, actors)
    jhost = jdd.decode_adds_host(packed, actors)
    native = decode_orset_payload_batch(list(payloads), actors)
    assert None not in (got, host, jdev, jhost, native)
    for arm in (got, host):
        for a, b in zip(arm[:4], jhost[:4]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert arm[4:] == jdev[4:] == jhost[4:]
    assert rows(got) == rows(native) == rows(jdev)
    assert got[5] == [codec.pack(m) for m in got[4]]


def test_actors_with_the_top_bit_set_resolve():
    """A lane whose top bit is set is negative in int64 on the device;
    the host reinterprets it as uint64, so 0x80.. and 0xff.. actors
    resolve to their own rows."""
    actors = sorted([b"\xff" * 16, b"\x80" + b"\x00" * 15, b"\x7f" * 16,
                     b"\x80" + b"\x00" * 14 + b"\x01"])
    payloads = [codec.pack([[0, m, [a, c]] for m, a, c in (
        (1, actors[0], 5), (2, actors[1], 6), (3, actors[2], 7),
        (4, actors[3], 8))])]
    got = dd.decode_adds_device(pack(payloads), actors, "cpu")
    assert got is not None
    assert got[2].tolist() == [0, 1, 2, 3]
    assert got[3].tolist() == [5, 6, 7, 8]


def test_h2d_counts_the_uploads_only_where_they_cross():
    """On the CPU nothing crosses to a card: ``h2d_bytes`` stays 0 (the
    card-marked case holds the exact upload)."""
    _, packed, actors = adds_corpus(n_payloads=10)
    trace.reset()
    assert dd.decode_adds_device(packed, actors, "cpu") is not None
    snap = trace.snapshot()
    assert snap["counters"].get("h2d_bytes", 0) == 0
    assert snap["spans"]["device.decode"]["count"] == 1
    trace.reset()


@pytest.mark.cuda
def test_h2d_equals_the_upload_on_the_card():
    """The cleartext buffer and the int64 base column, 8 bytes an op:
    what the JAX package counts (buf + the host base column) and what
    the card receives."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    payloads, packed, actors = adds_corpus(n_payloads=10)
    trace.reset()
    got = dd.decode_adds_device(packed, actors)
    assert got is not None
    assert trace.snapshot()["counters"]["h2d_bytes"] == \
        packed[0].nbytes + 10 * 9 * 8
    assert rows(got) == rows(decode_orset_payload_batch(payloads, actors))
    trace.reset()


def poisoned(poison, payloads, a0):
    if poison == "rm":
        bad = codec.pack([[1, 3, {a0: 2}]])
    elif poison == "wide_counter":
        bad = codec.pack([[0, 3, [a0, 1000]]])
    elif poison == "wide_member":
        bad = codec.pack([[0, 70000, [a0, 2]]])
    elif poison == "truncated":
        bad = codec.pack([[0, 3, [a0, 2]]])[:-4]
    elif poison == "empty_payload":
        bad = b""
    else:
        bad = b"\xc4\x03abc"
    return pack(payloads + [bad])


@pytest.mark.parametrize("poison", ["rm", "wide_counter", "wide_member",
                                    "truncated", "bad_header",
                                    "empty_payload"])
def test_non_qualifying_chunks_decline_in_both_packages(jdd, poison):
    payloads, _, actors = adds_corpus(n_payloads=6)
    packed = poisoned(poison, payloads, actors[0])
    assert dd.decode_adds_device(packed, actors, "cpu") is None
    assert dd.decode_adds_host(packed, actors) is None
    assert jdd.decode_adds_host(packed, actors) is None


def test_an_unknown_actor_declines(jdd):
    _, packed, actors = adds_corpus(n_payloads=4)
    used = dd.decode_adds_host(packed, actors)
    drop = actors[int(used[2][0])]
    table = [a for a in actors if a != drop]
    assert dd.decode_adds_device(packed, table, "cpu") is None
    assert dd.decode_adds_host(packed, table) is None
    assert jdd.decode_adds_host(packed, table) is None
    assert dd.decode_adds_device(packed, [], "cpu") is None
    assert dd.decode_adds_device(packed, [b"short"], "cpu") is None


def test_a_missing_device_raises_rather_than_declines():
    """No ``try`` turns a device failure into a decline: asking for a
    card this machine lacks raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, packed, actors = adds_corpus(n_payloads=4)
    with pytest.raises((RuntimeError, AssertionError)):
        dd.decode_adds_device(packed, actors, "cuda")


def test_the_gate_is_off_by_default(jdd, monkeypatch):
    monkeypatch.delenv("CRDT_DEVICE_DECODE", raising=False)
    assert not dd.device_decode_enabled()
    assert dd.device_decode_enabled() == jdd.device_decode_enabled()
    for value, on in (("1", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("CRDT_DEVICE_DECODE", value)
        assert dd.device_decode_enabled() is on
        assert jdd.device_decode_enabled() is on


def session_fold(monkeypatch, blobs, key, actors, gate: bool):
    if gate:
        monkeypatch.setenv("CRDT_DEVICE_DECODE", "1")
    else:
        monkeypatch.delenv("CRDT_DEVICE_DECODE", raising=False)
    state = ORSet()
    trace.reset()
    assert TorchAccelerator(device="cpu", min_device_batch=1) \
        .fold_encrypted_stream(state, key, blobs, actors_hint=list(actors))
    return canonical_bytes(state), trace.snapshot()["spans"]


def test_session_gate_gives_the_same_bytes(monkeypatch):
    """``fold_encrypted_stream`` (one producer, so each chunk is one
    packed part) with the gate on decodes every chunk on the device and
    folds the same bytes as with the gate off; the JAX stream agrees."""
    JORSet = pytest.importorskip("crdt_enc_tpu.models").ORSet
    from crdt_enc_tpu.models import canonical_bytes as jcanonical_bytes
    from crdt_enc_tpu.parallel import TpuAccelerator

    monkeypatch.setattr(S, "stream_producer_count", lambda: 1)
    key = secrets.token_bytes(32)
    payloads, _, actors = adds_corpus(n_payloads=24, opf=7, seed=8)
    blobs = [encrypt_blob(key, p) for p in payloads]
    off, off_spans = session_fold(monkeypatch, blobs, key, actors, False)
    on, on_spans = session_fold(monkeypatch, blobs, key, actors, True)
    assert on == off
    assert "device.decode" not in off_spans and "session.decode" in off_spans
    assert on_spans["device.decode"]["count"] >= 1
    assert "session.decode" not in on_spans
    ref = JORSet()
    assert TpuAccelerator().fold_encrypted_stream(
        ref, key, blobs, actors_hint=list(actors), n_chunks=3)
    assert on == jcanonical_bytes(ref)
    trace.reset()


def test_a_mixed_chunk_takes_the_native_decoder(monkeypatch):
    """A chunk with a remove declines the device arm; the session decodes
    it natively and the bytes stay those of the gate-off fold."""
    monkeypatch.setattr(S, "stream_producer_count", lambda: 1)
    key = secrets.token_bytes(32)
    payloads, _, actors = adds_corpus(n_payloads=12, opf=5, seed=9)
    payloads.append(codec.pack([[1, 3, {actors[0]: 2}]]))
    blobs = [encrypt_blob(key, p) for p in payloads]
    off, _ = session_fold(monkeypatch, blobs, key, actors, False)
    on, spans = session_fold(monkeypatch, blobs, key, actors, True)
    assert on == off
    assert "session.decode" in spans
    trace.reset()


def test_a_session_fed_packed_chunks_folds_alike(monkeypatch):
    """The gate inside ``decode_chunk_parts`` on a session fed directly,
    one packed chunk at a time, as the core's pipeline feeds it."""
    key = secrets.token_bytes(32)
    payloads, _, actors = adds_corpus(n_payloads=30, opf=8, seed=10)
    blobs = [encrypt_blob(key, p) for p in payloads]
    out = {}
    for gate in (False, True):
        if gate:
            monkeypatch.setenv("CRDT_DEVICE_DECODE", "1")
        else:
            monkeypatch.delenv("CRDT_DEVICE_DECODE", raising=False)
        accel = TorchAccelerator(device="cpu", min_device_batch=1)
        session = accel.open_fold_session(ORSet(), actors_hint=actors)
        for lo in range(0, len(blobs), 10):
            packed = decrypt_blobs_packed(key, blobs[lo:lo + 10])
            session.reduce_chunk(session.decode_chunk_parts([packed]))
        out[gate] = canonical_bytes(session.finish())
    assert out[True] == out[False]
