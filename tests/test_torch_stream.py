"""The port's blockwise stream fold and ingest pipelines
(crdt_enc_tpu_torch/ops/stream.py) against the JAX package's, on the CPU.

Mirrors tests/test_streaming_pipeline.py without its mesh cases:

* **overlap and backpressure** of the producer pools, proved from span
  timestamps of the port's trace event log (stage durations pinned by
  sleeps), with one and several producers and on the striped queue;
* **errors** reach the consumer and every worker thread is joined;
* **exactness**: pooled chunks equal the JAX package's chunks, the
  blockwise fold equals the JAX ``orset_fold_stream`` and the whole-batch
  fold plane for plane, and ``fold_encrypted_stream`` gives the bytes of
  the per-op host loop and of the JAX accelerator, at every chunking and
  producer count (``ENCRYPTED_STREAM_CHUNKS`` and
  ``stream_producer_count`` monkeypatched).

Every pipeline call that could block runs under a time bound of its own.
"""

from __future__ import annotations

import secrets
import threading
import time

import numpy as np
import pytest

from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.backends import xchacha as jx
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import PNCounter as JPNCounter
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel import TpuAccelerator

from crdt_enc_tpu_torch import ORSet, PNCounter, TorchAccelerator, canonical_bytes
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.ops import stream as S
from crdt_enc_tpu_torch.parallel import accel as A
from crdt_enc_tpu_torch.utils import codec, trace

TIMEOUT_S = 60


def bounded(fn, seconds: float = TIMEOUT_S):
    """Run ``fn`` on a thread and fail if it has not returned within
    ``seconds``; re-raise what it raised."""
    box: dict = {}

    def run():
        try:
            box["ok"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(seconds)
    assert not t.is_alive(), f"did not finish within {seconds}s"
    if "err" in box:
        raise box["err"]
    return box.get("ok")


def cpu_accel(**kw):
    return TorchAccelerator(device="cpu", min_device_batch=1, **kw)


def events_by_name(name):
    return sorted((e for e in trace.events() if e["name"] == name),
                  key=lambda e: e["meta"])


def traced(fn):
    trace.reset()
    trace.enable_events()
    try:
        return bounded(fn)
    finally:
        trace.enable_events(False)


def assert_no_producer_threads():
    deadline = time.time() + 5.0
    while time.time() < deadline and any(
        t.name.startswith("crdt-ingest-producer") and t.is_alive()
        for t in threading.enumerate()
    ):
        time.sleep(0.01)
    leaked = [t.name for t in threading.enumerate()
              if t.name.startswith("crdt-ingest-producer") and t.is_alive()]
    assert not leaked, f"leaked producer threads: {leaked}"


def run_chunks(spans, ingest, reduce, producers=1):
    """The striped pipeline with one stripe per chunk: ``ingest`` runs as
    the chunk's stripe (span ``stream.stripe``) and its result is the
    chunk's item."""
    return S.run_striped_ingest_pipeline(
        spans, lambda span, k: [span], lambda st, k, s: ingest(st, k),
        lambda parts, span, k: parts[0], reduce, producers=producers)


# ---- seams: overlap and backpressure ----------------------------------------


@pytest.mark.parametrize("producers", [1, 2])
def test_ingest_overlaps_reduce_seam(producers):
    """Chunk k+1's ingest starts BEFORE chunk k's reduce completes."""
    traced(lambda: run_chunks(
        list(range(6)), lambda span, k: time.sleep(0.02) or span,
        lambda item, k: time.sleep(0.05), producers=producers))
    ingests = events_by_name("stream.stripe")
    reduces = events_by_name("stream.reduce")
    assert [e["meta"] for e in ingests] == list(range(6))
    assert [e["meta"] for e in reduces] == list(range(6))
    assert any(ingests[k + 1]["t0"] < reduces[k]["t1"] for k in range(5))


@pytest.mark.parametrize("producers,depth", [(1, 2), (2, 3)])
def test_backpressure_bounds_live_chunks(producers, depth):
    """Chunk k+depth's ingest cannot start before chunk k's reduce has
    released its slot: at most ``producers + 1`` (at least 2) chunks are
    live."""
    traced(lambda: run_chunks(
        list(range(8)), lambda span, k: span,
        lambda item, k: time.sleep(0.02), producers=producers))
    ingests = events_by_name("stream.stripe")
    reduces = events_by_name("stream.reduce")
    for k in range(len(ingests) - depth):
        assert ingests[k + depth]["t0"] >= reduces[k]["t1"], k


def test_producer_error_propagates():
    def ingest(span, k):
        if k == 1:
            raise ValueError("boom")
        return span

    with pytest.raises(S.PipelineError) as ei:
        bounded(lambda: run_chunks(list(range(3)), ingest,
                                   lambda item, k: None))
    assert isinstance(ei.value.__cause__, ValueError)
    assert_no_producer_threads()


@pytest.mark.parametrize("producers,bound", [(1, 4), (3, 8)])
def test_consumer_error_stops_producers(producers, bound):
    ingested = []

    def ingest(span, k):
        ingested.append(k)
        return span

    def reduce(item, k):
        raise RuntimeError("reduce failed")

    with pytest.raises(RuntimeError, match="reduce failed"):
        bounded(lambda: run_chunks(list(range(50)), ingest, reduce,
                                   producers=producers))
    assert len(ingested) <= bound
    assert_no_producer_threads()


def test_producer_count_resolution(monkeypatch):
    """One producer per core but one, at least 1, as the JAX package
    resolves it without its environment override."""
    import os

    monkeypatch.delenv("CRDT_STREAM_PRODUCERS", raising=False)
    auto = S.stream_producer_count()
    assert auto == max(1, (os.cpu_count() or 1) - 1)
    assert auto == JK.stream_producer_count()
    for cores, want in ((None, 1), (1, 1), (2, 1), (8, 7)):
        monkeypatch.setattr(S.os, "cpu_count", lambda c=cores: c)
        assert S.stream_producer_count() == want, cores


def test_multi_producer_order_deterministic():
    delays = np.random.default_rng(17).random(24) * 0.01
    for producers in (1, 2, 4):
        order = []
        bounded(lambda: run_chunks(
            list(range(24)),
            lambda span, k: time.sleep(delays[k]) or span * 10,
            lambda item, k: order.append((k, item)), producers=producers))
        assert order == [(k, 10 * k) for k in range(24)], producers


def test_multi_producer_lanes_and_gauge():
    traced(lambda: run_chunks(
        list(range(8)), lambda span, k: time.sleep(0.005) or span,
        lambda item, k: time.sleep(0.002), producers=2))
    snap = trace.snapshot()
    assert snap["gauges"]["stream_producers"] == 2
    events = trace.events()
    assert {"stream.producer.wait", "stream.sequence", "stream.ingest"} <= {
        e["name"] for e in events}
    lanes = {e["thread"] for e in events if e["name"] == "stream.stripe"}
    assert lanes == {"crdt-ingest-producer-0", "crdt-ingest-producer-1"}
    trace.reset()


def test_multi_producer_fault_injection():
    """The first failing producer cancels its peers and the pipeline
    raises PipelineError without draining: what was reduced is an
    in-order prefix of the chunks before the failed index; no thread
    leaks, and a fresh run afterwards completes."""
    delays = np.random.default_rng(3).random(30) * 0.008
    reduced = []

    def ingest(span, k):
        time.sleep(delays[k])
        if k == 7:
            raise ValueError("producer boom")
        return span

    with pytest.raises(S.PipelineError) as ei:
        bounded(lambda: run_chunks(
            list(range(30)), ingest, lambda item, k: reduced.append(k),
            producers=3))
    assert isinstance(ei.value.__cause__, ValueError)
    assert reduced == list(range(len(reduced))) and len(reduced) <= 7
    assert_no_producer_threads()
    order = []
    bounded(lambda: run_chunks(
        list(range(10)), lambda s, k: s, lambda i, k: order.append(k),
        producers=3))
    assert order == list(range(10))


# ---- the striped queue ------------------------------------------------------


def test_striped_order_deterministic_with_random_delays():
    delays = np.random.default_rng(3).random(40) * 0.004
    for producers in (1, 2, 4):
        order = []

        def stripe(item, k, s):
            time.sleep(delays[(k * 3 + s) % len(delays)])
            assert item == (k, s)
            return ("part", k, s)

        def assemble(parts, span, k):
            assert parts == [("part", k, s) for s in range(1 + k % 3)]
            return ("chunk", k)

        def reduce(item, k):
            assert item == ("chunk", k)
            order.append(k)

        bounded(lambda: S.run_striped_ingest_pipeline(
            list(range(18)), lambda span, k: [(k, s) for s in range(1 + k % 3)],
            stripe, assemble, reduce, producers=producers))
        assert order == list(range(18)), producers


def test_striped_giant_stripe_does_not_block_peers():
    started, done = [], []
    release = threading.Event()

    def stripe(item, k, s):
        started.append((k, s))
        if (k, s) == (0, 0):
            assert release.wait(10.0)
        return (k, s)

    t = threading.Thread(target=lambda: S.run_striped_ingest_pipeline(
        list(range(4)), lambda span, k: [0, 1] if k == 0 else [0], stripe,
        lambda parts, span, k: k, lambda item, k: done.append(k),
        producers=2))
    t.start()
    deadline = time.monotonic() + 10.0
    while len(started) < 4 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert len(started) >= 4, started
    assert not done
    release.set()
    t.join(10.0)
    assert not t.is_alive()
    assert done == [0, 1, 2, 3]


@pytest.mark.parametrize("where", ["stripe", "reduce"])
def test_striped_errors_join_workers(where):
    before = threading.active_count()

    def stripe(item, k, s):
        if where == "stripe" and (k, s) == (2, 1):
            raise ValueError("boom at (2,1)")
        return 0

    def reduce(item, k):
        if where == "reduce" and k == 1:
            raise RuntimeError("consumer dies")

    expected = S.PipelineError if where == "stripe" else RuntimeError
    with pytest.raises(expected) as ei:
        bounded(lambda: S.run_striped_ingest_pipeline(
            list(range(8)), lambda sp, k: [0, 1], stripe,
            lambda p, sp, k: 0, reduce, producers=3))
    if where == "stripe":
        assert isinstance(ei.value.__cause__, ValueError)
    deadline = time.monotonic() + 5.0
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() <= before


def test_striped_empty_chunks_and_empty_split():
    bounded(lambda: S.run_striped_ingest_pipeline(
        [], lambda sp, k: [0], lambda it, k, s: 0, lambda p, sp, k: 0,
        lambda i, k: None, producers=2))
    order = []
    bounded(lambda: S.run_striped_ingest_pipeline(
        list(range(5)), lambda sp, k: [] if k % 2 else [0],
        lambda it, k, s: "p", lambda parts, sp, k: (k, parts),
        lambda item, k: order.append(item), producers=2))
    assert order == [(k, ["p"] if k % 2 == 0 else []) for k in range(5)]


def test_striped_single_producer_runs_on_one_worker(monkeypatch):
    """On a one-core host the width resolves to one producer, and with
    ``inline=False`` (the auto default runs inline there) the pipeline
    runs on exactly one worker thread, joined on return, with the chunks
    reduced in order on the calling thread."""
    monkeypatch.setattr(S.os, "cpu_count", lambda: 1)
    spawned = []
    real_thread = threading.Thread

    class SpyThread(real_thread):
        def __init__(self, *a, **kw):
            spawned.append(kw.get("name"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(S.threading, "Thread", SpyThread)
    order, reducers = [], set()

    def reduce(item, k):
        order.append(item)
        reducers.add(threading.current_thread().name)

    bounded(lambda: S.run_striped_ingest_pipeline(
        list(range(6)), lambda sp, k: [0, 1], lambda it, k, s: (k, s),
        lambda parts, sp, k: (k, parts), reduce,
        producers=S.stream_producer_count(), inline=False))
    assert order == [(k, [(k, 0), (k, 1)]) for k in range(6)]
    assert [n for n in spawned if n and n.startswith("crdt-ingest")] == [
        "crdt-ingest-producer-0"]
    assert not any(n.startswith("crdt-ingest-producer") for n in reducers)
    assert_no_producer_threads()


# ---- chunk staging and the blockwise fold -----------------------------------


def ordered_columns(n, R, E, seed):
    """An op history in per-actor version order (the contract the chunked
    fold assumes): adds are each actor's next dot, removes carry the
    horizon seen so far; some sentinel rows."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 2, n).astype(np.int8)
    member = rng.integers(0, E, n).astype(np.int32)
    actor = rng.integers(0, R, n).astype(np.int32)
    counter = np.zeros(n, np.int32)
    seen = np.zeros(R, np.int64)
    for i in range(n):
        a = actor[i]
        if kind[i] == 0 or seen[a] == 0:
            kind[i] = 0
            seen[a] += 1
        counter[i] = seen[a]
    actor = np.where(rng.random(n) < 0.05, R, actor).astype(np.int32)
    return kind, member, actor, counter


def test_pooled_chunks_equal_plain_and_jax_chunks():
    kind, member, actor, counter = ordered_columns(37, 5, 6, 3)
    rows, R = 8, 5
    plain = list(S.iter_orset_chunks(kind, member, actor, counter, rows, R))
    jax_chunks = list(JK.iter_orset_chunks(kind, member, actor, counter,
                                           rows, R))
    pool = S.ChunkPool(rows, depth=2)
    pooled = 0
    for i, bufs in enumerate(S.iter_orset_chunks(kind, member, actor, counter,
                                                 rows, R, pool=pool)):
        for got, want, ref in zip(bufs, plain[i], jax_chunks[i]):
            np.testing.assert_array_equal(got.numpy(), want)
            np.testing.assert_array_equal(want, np.asarray(ref))
            assert got.numpy().dtype == np.asarray(ref).dtype
        pool.release(bufs)
        pooled += 1
    assert pooled == len(plain) == len(jax_chunks) == 5


def test_chunk_pool_refuses_depth_one_and_a_shape_mismatch():
    with pytest.raises(ValueError):
        S.ChunkPool(8, depth=1)
    pool = S.ChunkPool(8)
    with pytest.raises(ValueError):
        next(S.iter_orset_chunks(np.zeros(3, np.int8), *(np.zeros(3, np.int32),) * 3,
                                 4, 1, pool=pool))


@pytest.mark.parametrize("rows", [1, 16, 64, 512])
@pytest.mark.parametrize("prior", [False, True])
def test_stream_fold_matches_jax_stream_and_whole_batch(rows, prior):
    """The port's blockwise fold (retiring per chunk) ≡ the JAX
    ``orset_fold_stream`` ≡ one whole-batch fold, plane for plane, into
    empty planes and onto a prior fold."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P

    n, R, E = 301, 7, 9
    kind, member, actor, counter = ordered_columns(n, R, E, 11)
    z = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    planes0 = (z(R), z(E, R), z(E, R))
    if prior:
        # the first 100 rows folded whole; the stream continues the history
        t = [torch.from_numpy(x) for x in (kind, member, actor, counter)]
        planes0 = tuple(x.numpy() for x in P.orset_fold_plain(
            *(torch.from_numpy(p) for p in planes0), *(c[:100] for c in t),
            num_members=E, num_replicas=R))
        kind, member, actor, counter = (c[100:] for c in
                                        (kind, member, actor, counter))
    pool = S.ChunkPool(rows, depth=2)
    trace.reset()
    got = S.planes_to_host(S.orset_fold_stream(
        *planes0,
        S.iter_orset_chunks(kind, member, actor, counter, rows, R, pool=pool),
        num_members=E, num_replicas=R, device="cpu", pool=pool))
    assert trace.snapshot()["spans"]["stream.fold"]["count"] == -(-len(kind) // rows)
    jpool = JK.ChunkPool(rows, depth=2)
    ref = JK.planes_to_host(JK.orset_fold_stream(
        *planes0,
        JK.iter_orset_chunks(kind, member, actor, counter, rows, R, pool=jpool),
        num_members=E, num_replicas=R, pool=jpool))
    whole = JK.orset_fold(*planes0, kind, member, actor, counter,
                          num_members=E, num_replicas=R)
    for g, r, w in zip(got, ref, whole):
        np.testing.assert_array_equal(g, np.asarray(r))
        np.testing.assert_array_equal(g, np.asarray(w))


def test_stream_fold_without_a_pool_and_with_partial_folds():
    """Fresh chunks (no pool) fold the same, and a chain of
    ``retire_rm=False`` chunks ends equal after ``orset_retire``."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P

    n, R, E = 200, 5, 6
    cols = ordered_columns(n, R, E, 4)
    z = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    eager = S.planes_to_host(S.orset_fold_stream(
        z(R), z(E, R), z(E, R), S.iter_orset_chunks(*cols, 32, R),
        num_members=E, num_replicas=R, device="cpu"))
    partial = S.orset_fold_stream(
        z(R), z(E, R), z(E, R), S.iter_orset_chunks(*cols, 32, R),
        num_members=E, num_replicas=R, device="cpu", retire_rm=False)
    retired = P.orset_retire(partial[0], partial[2])
    np.testing.assert_array_equal(eager[0], partial[0].numpy())
    np.testing.assert_array_equal(eager[1], partial[1].numpy())
    assert torch.equal(retired, torch.from_numpy(eager[2]))


# ---- end to end: encrypted blobs through the pipeline ----------------------


def encrypted_orset_workload(n_files=40, ops_per_file=6, R=5, E=12, seed=2):
    """Per-actor op files sealed with the port's AEAD, and the per-op host
    truth (apply order = file order = per-actor version order)."""
    rng = np.random.default_rng(seed)
    key = secrets.token_bytes(32)
    actors = [bytes([a]) * 16 for a in range(1, R + 1)]
    counters = {a: 0 for a in range(R)}
    host = ORSet()
    blobs = []
    for f in range(n_files):
        a = f % R
        ops = []
        for _ in range(ops_per_file):
            m = int(rng.integers(0, E))
            if rng.random() < 0.75 or counters[a] == 0:
                counters[a] += 1
                ops.append([0, m, [actors[a], counters[a]]])
                host.apply(AddOp(m, Dot(actors[a], counters[a])))
            else:
                ops.append([1, m, {actors[a]: counters[a]}])
                host.apply(RmOp(m, VClock({actors[a]: counters[a]})))
        blobs.append(px.encrypt_blob(key, codec.pack(ops)))
    return key, blobs, sorted(actors), host


def jax_stream(key, blobs, hint, **kw):
    ref = JORSet()
    assert TpuAccelerator().fold_encrypted_stream(ref, key, blobs,
                                                  actors_hint=hint, **kw)
    return j_canonical_bytes(ref)


def test_packed_decrypt_equals_the_jax_package():
    key, blobs, _, _ = encrypted_orset_workload(n_files=12)
    out, offs = px.decrypt_blobs_packed(key, blobs)
    jout, joffs = jx.decrypt_blobs_packed(key, blobs)
    assert bytes(out) == bytes(jout)
    np.testing.assert_array_equal(offs, np.asarray(joffs))
    assert [bytes(v) for v in px.decrypt_blobs(key, blobs)] == [
        bytes(v) for v in jx.decrypt_blobs(key, blobs)]
    with pytest.raises(px.AeadError):
        px.decrypt_blobs_packed(secrets.token_bytes(32), blobs)


@pytest.mark.parametrize("n_chunks", [1, 3, 8, 40])
def test_encrypted_stream_byte_identical_to_host_and_jax(n_chunks, monkeypatch):
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", n_chunks)
    key, blobs, hint, host = encrypted_orset_workload()
    whole = ORSet()
    assert cpu_accel().fold_payloads(whole, px.decrypt_blobs(key, blobs),
                                     actors_hint=hint)
    streamed = ORSet()
    assert bounded(lambda: cpu_accel().fold_encrypted_stream(
        streamed, key, blobs, actors_hint=hint))
    assert streamed._mut == 1
    assert (canonical_bytes(streamed) == canonical_bytes(whole)
            == canonical_bytes(host)
            == jax_stream(key, blobs, hint, n_chunks=n_chunks))


def test_encrypted_stream_into_existing_state(monkeypatch):
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 4)
    key, blobs, hint, _ = encrypted_orset_workload(seed=9)
    pre = [(b"\x77" * 16, 1, 99), (b"\x78" * 16, 2, 5)]
    streamed, host = ORSet(), ORSet()
    for a, c, m in pre:
        streamed.apply(AddOp(m, Dot(a, c)))
        host.apply(AddOp(m, Dot(a, c)))
    for raw in px.decrypt_blobs(key, blobs):
        for o in codec.unpack(raw):
            host.apply(AddOp(o[1], Dot.from_obj(o[2])) if o[0] == 0
                       else RmOp(o[1], VClock.from_obj(o[2])))
    assert bounded(lambda: cpu_accel().fold_encrypted_stream(
        streamed, key, blobs, actors_hint=hint))
    assert canonical_bytes(streamed) == canonical_bytes(host)


def test_encrypted_stream_counter_session(monkeypatch):
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 3)
    key = secrets.token_bytes(32)
    actors = [bytes([a]) * 16 for a in range(1, 4)]
    host = PNCounter()
    blobs = []
    rng = np.random.default_rng(4)
    for f in range(12):
        a = f % 3
        ops = []
        for _ in range(5):
            sign, dot = (host.inc(actors[a]) if rng.random() < 0.7
                         else host.dec(actors[a]))
            ops.append([int(sign), [dot.actor, dot.counter]])
            host.apply((sign, dot))
        blobs.append(px.encrypt_blob(key, codec.pack(ops)))
    streamed = PNCounter()
    assert bounded(lambda: cpu_accel().fold_encrypted_stream(
        streamed, key, blobs, actors_hint=sorted(actors)))
    ref = JPNCounter()
    assert TpuAccelerator().fold_encrypted_stream(
        ref, key, blobs, actors_hint=sorted(actors), n_chunks=3)
    assert canonical_bytes(streamed) == canonical_bytes(host) == j_canonical_bytes(ref)
    assert streamed.read() == host.read()


def test_encrypted_stream_seam_and_counters(monkeypatch):
    """The stage spans the pipeline promises; ``bytes_decrypted`` equals
    the blobs' byte sum, the CPU accelerator uploads nothing, and a wrong
    key raises and counts nothing."""
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 6)
    key, blobs, hint, host = encrypted_orset_workload(n_files=60, ops_per_file=8)
    streamed = ORSet()
    assert traced(lambda: cpu_accel().fold_encrypted_stream(
        streamed, key, blobs, actors_hint=hint))
    names = {e["name"] for e in trace.events()}
    for required in ("stream.decrypt", "stream.decode", "stream.ingest",
                     "stream.reduce", "stream.finish", "session.decode"):
        assert required in names, required
    snap = trace.snapshot()
    assert snap["counters"]["bytes_decrypted"] == sum(len(b) for b in blobs)
    assert "h2d_bytes" not in snap["counters"]
    assert canonical_bytes(streamed) == canonical_bytes(host)
    trace.reset()
    with pytest.raises(px.AeadError):
        bounded(lambda: cpu_accel().fold_encrypted_stream(
            ORSet(), secrets.token_bytes(32), blobs, actors_hint=hint))
    assert trace.snapshot()["counters"].get("bytes_decrypted", 0) == 0


def test_multi_producer_byte_identical_to_single(monkeypatch):
    """The same blobs folded with 1, 2 and 4 producers, with random delays
    ahead of each stripe's decrypt, give the host loop's bytes."""
    key, blobs, hint, host = encrypted_orset_workload(n_files=48,
                                                      ops_per_file=7, seed=21)
    delays = np.random.default_rng(9).random(12) * 0.01
    real = S.run_striped_ingest_pipeline

    def jittered(spans, split_fn, stripe_fn, assemble_fn, reduce_fn, **kw):
        def slow(stripe, k, s):
            time.sleep(delays[(k + s) % len(delays)])
            return stripe_fn(stripe, k, s)

        return real(spans, split_fn, slow, assemble_fn, reduce_fn, **kw)

    monkeypatch.setattr(S, "run_striped_ingest_pipeline", jittered)
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 8)
    for n_producers in (1, 2, 4):
        monkeypatch.setattr(S, "stream_producer_count",
                            lambda n=n_producers: n)
        streamed = ORSet()
        trace.reset()
        assert bounded(lambda: cpu_accel().fold_encrypted_stream(
            streamed, key, blobs, actors_hint=hint))
        assert trace.snapshot()["gauges"]["stream_producers"] == n_producers
        assert canonical_bytes(streamed) == canonical_bytes(host), n_producers


def test_hint_order_does_not_change_the_bytes(monkeypatch):
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 4)
    key, blobs, hint, host = encrypted_orset_workload(seed=11)
    results = set()
    for h in (hint, list(reversed(hint))):
        state = ORSet()
        assert bounded(lambda: cpu_accel().fold_encrypted_stream(
            state, key, blobs, actors_hint=h))
        results.add(canonical_bytes(state))
    assert results == {canonical_bytes(host)}


def test_member_collision_declines_with_the_state_untouched(monkeypatch):
    """1 == True as members: the stream declines before any mutation."""
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 1)
    key = secrets.token_bytes(32)
    actor = b"\x01" * 16
    blobs = [px.encrypt_blob(key, codec.pack([[0, 1, [actor, 1]]])),
             px.encrypt_blob(key, codec.pack([[0, True, [actor, 2]]]))]
    state = ORSet()
    assert not bounded(lambda: cpu_accel().fold_encrypted_stream(
        state, key, blobs, actors_hint=[actor]))
    assert not state.entries and state._mut == 0


@pytest.mark.parametrize("n_chunks", [1, 4])
def test_unknown_actor_declines_with_the_state_untouched(n_chunks, monkeypatch):
    """A chunk from an actor outside the decoder's table declines the
    whole stream, in whichever chunk it lands, before any mutation; the
    JAX accelerator declines the same blobs."""
    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", n_chunks)
    key, blobs, hint, _ = encrypted_orset_workload(seed=13)
    stranger = [px.encrypt_blob(key, codec.pack([[0, 5, [b"\x99" * 16, 1]]]))]
    mixed = blobs[:4] + stranger + blobs[4:8]
    fresh = ORSet()
    assert not bounded(lambda: cpu_accel().fold_encrypted_stream(
        fresh, key, mixed, actors_hint=hint))
    assert not fresh.entries and fresh._mut == 0
    ref = JORSet()
    assert not TpuAccelerator().fold_encrypted_stream(
        ref, key, mixed, actors_hint=hint, n_chunks=n_chunks)
    assert not ref.entries
