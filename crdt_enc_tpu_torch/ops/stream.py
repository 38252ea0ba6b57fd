"""Chunked (bounded-memory) folds and the overlapped ingest pipelines.

The port's copy of ``crdt_enc_tpu/ops/stream.py``.  The op log folds
blockwise because the fold is associative: fixed-shape chunks of op rows
stream through one fold entry (``orset_fold_cuda``: the K2 kernels on the
card, their plain version on the CPU) into state planes that stay on the
device, so device memory does not grow with the stream's length.

* :class:`ChunkPool` holds the host staging buffers — pinned when the
  fold runs on the card, so each chunk's upload is a true asynchronous
  copy;
* :func:`iter_orset_chunks` cuts flat op columns into chunks of one row
  count, the last one padded with ``actor == num_replicas`` sentinel
  rows, which the kernels mask;
* :func:`fold_chunks_overlapped` issues chunk k+1's upload on a side
  ``torch.cuda.Stream`` while chunk k's fold runs on the current stream:
  the fold waits on an event of the copy, the copy into a device slot
  waits on an event of the fold that last read that slot, and a pool
  buffer goes back to the pool only once its own copy's event has
  completed — events, never a device-wide synchronize per chunk.  The
  planes ping-pong between two triples, so the device holds two chunk
  slots, the fold's scratch and two plane triples whatever the chunk
  count;
* :func:`run_ingest_pipeline` (one producer a chunk) and
  :func:`run_striped_ingest_pipeline` (producers share a chunk's file
  stripes) are the host-side producer pools that decrypt and decode
  chunks ahead of the fold (native calls that release the interpreter
  lock), with a sequencer that hands them to the consumer in strict
  chunk order, so the folded bytes do not depend on the pool's width.
  They are copied as they are: host threading, nothing of JAX.  Their
  width is :func:`stream_producer_count` (an explicit request, else
  ``CRDT_STREAM_PRODUCERS``, else one per core but one);

Exactness: chunked ≡ whole batch under the causal-delivery contract the
core keeps (per-actor op files apply in version order): each chunk's
replay gate reads the clock carried from the chunks before it, which then
rejects only true replays.  The per-op host loop is the chunk-size-1
instance of this fold.

Stage spans: ``stream.columnarize``, ``stream.h2d``, ``stream.fold``,
``stream.d2h``, ``stream.ingest``, ``stream.reduce``, ``stream.stripe``,
``stream.producer.wait``, ``stream.sequence``, each with the chunk (or
producer) index as ``meta``, and the ``stream_producers`` gauge.
"""

from __future__ import annotations

import contextvars
import os
import queue as _queue
import threading

import numpy as np
import torch

from ..utils import trace
from .orset_fold_cuda import orset_fold_cuda


def stream_producer_count(requested: int = 0) -> int:
    """Resolve the ingest fan-out width (the N in the N-producer
    pipeline): an explicit positive ``requested`` wins, then the
    ``CRDT_STREAM_PRODUCERS`` environment override (an unparsable or
    non-positive value is ignored), then one producer per core but one,
    which the consumer keeps, at least 1."""
    if requested > 0:
        return int(requested)
    env = os.environ.get("CRDT_STREAM_PRODUCERS", "")
    if env.strip():
        try:
            n = int(env)
        except ValueError:
            n = 0
        if n > 0:
            return n
    cpus = os.cpu_count() or 1
    return max(1, cpus - 1)


class ChunkPool:
    """Pre-allocated fixed-shape op-column staging buffers: ``depth``
    sets of ``(kind int8, member/actor/counter int32) × chunk_rows`` CPU
    tensors, pinned when ``pin`` (the card's uploads), pageable otherwise
    (the CPU path, where there is no card to pin for).

    ``acquire()`` blocks while every set is out, which bounds the live
    staging memory to ``depth`` chunks however long the stream runs.
    Release a set only once nothing reads it any more:
    ``fold_chunks_overlapped`` releases after the set's upload event
    completes (on the CPU, after the fold that reads it)."""

    def __init__(self, chunk_rows: int, depth: int = 2, *, pin: bool = False):
        if depth < 2:
            # the overlapped consumer holds one set while the chunk
            # iterator acquires the next: one set would deadlock
            raise ValueError(f"ChunkPool needs depth >= 2, got {depth}")
        self.chunk_rows = chunk_rows
        self.depth = depth
        self.pin = pin
        self._free: _queue.Queue = _queue.Queue()
        dtypes = (torch.int8, torch.int32, torch.int32, torch.int32)
        for _ in range(depth):
            self._free.put(tuple(
                torch.zeros(chunk_rows, dtype=dt, pin_memory=pin)
                for dt in dtypes
            ))

    def acquire(self) -> tuple:
        return self._free.get()

    def release(self, bufs: tuple) -> None:
        self._free.put(bufs)


def columnarize_into(bufs, kind, member, actor, counter, lo: int, hi: int,
                     num_replicas: int):
    """Copy rows ``[lo:hi)`` of the flat columns into a pool buffer set,
    sentinel-padding the tail (``actor == num_replicas`` rows, which every
    kernel masks out).  Returns ``bufs``."""
    k, m, a, c = (t.numpy() for t in bufs)
    n = hi - lo
    np.copyto(k[:n], kind[lo:hi], casting="unsafe")
    np.copyto(m[:n], member[lo:hi], casting="unsafe")
    np.copyto(a[:n], actor[lo:hi], casting="unsafe")
    np.copyto(c[:n], counter[lo:hi], casting="unsafe")
    if n < len(k):
        k[n:] = 0
        m[n:] = 0
        a[n:] = num_replicas
        c[n:] = 0
    return bufs


def iter_orset_chunks(kind, member, actor, counter, chunk_rows: int,
                      num_replicas: int, pool: ChunkPool | None = None):
    """Slice flat op columns into fixed-shape chunks, the tail padded with
    ``actor == num_replicas`` sentinel rows.

    With a ``pool`` the chunks are the pool's tensors; the consumer must
    release each set back (``fold_chunks_overlapped(..., pool=pool)``
    does) and ``pool.chunk_rows`` must equal ``chunk_rows``.  Without
    one, each chunk is four fresh numpy arrays."""
    n = len(kind)
    if pool is not None:
        if pool.chunk_rows != chunk_rows:
            raise ValueError(f"pool rows {pool.chunk_rows} != chunk rows "
                             f"{chunk_rows}")
        kind, member, actor, counter = (
            np.asarray(x) for x in (kind, member, actor, counter))
        for lo in range(0, n, chunk_rows):
            hi = min(lo + chunk_rows, n)
            with trace.span("stream.columnarize", meta=lo // chunk_rows):
                bufs = columnarize_into(pool.acquire(), kind, member, actor,
                                        counter, lo, hi, num_replicas)
            yield bufs
        return
    for lo in range(0, n, chunk_rows):
        hi = min(lo + chunk_rows, n)
        pad = chunk_rows - (hi - lo)
        k = np.asarray(kind[lo:hi], np.int8)
        m = np.asarray(member[lo:hi], np.int32)
        a = np.asarray(actor[lo:hi], np.int32)
        c = np.asarray(counter[lo:hi], np.int32)
        if pad:
            k = np.concatenate([k, np.zeros(pad, np.int8)])
            m = np.concatenate([m, np.zeros(pad, np.int32)])
            a = np.concatenate([a, np.full(pad, num_replicas, np.int32)])
            c = np.concatenate([c, np.zeros(pad, np.int32)])
        yield k, m, a, c


def _host_tensors(chunk) -> tuple:
    return tuple(x if isinstance(x, torch.Tensor) else torch.from_numpy(x)
                 for x in chunk)


def fold_chunks_overlapped(planes, chunks, fold_step, *, pool=None,
                           put=None):
    """The overlapped consumer loop: fold an iterable of host column
    chunks into the ``planes`` triple with one chunk of upload lookahead.

    On the card, per cycle: chunk k+1's copy into a device slot is issued
    on a side stream FIRST (after waiting on the event of the fold that
    last read that slot), then ``fold_step(planes, chunk k)`` is enqueued
    on the current stream behind an event of chunk k's copy, then the
    host waits on chunk k+1's copy event alone — the copy ran under fold
    k — and recycles its pool buffer.  With CPU planes the chunks are
    folded as they come and a pool buffer is recycled after its fold.

    ``put(tensor, non_blocking)`` overrides the per-column transfer (the
    sharded stream passes its mesh's row placement,
    ``parallel.mesh.stream_sharding``): on the card it is issued on the
    side stream in place of the slot copy, so chunk k+1's upload still
    rides under chunk k's fold.  This loop counts ``h2d_bytes`` (and
    ``h2d_pageable_bytes`` unless the chunks come from a pinned ``pool``);
    ``put`` must not.

    Returns the final planes without waiting for the card (callers block
    and pull under ``stream.d2h`` with :func:`planes_to_host`)."""
    device = planes[0].device
    if device.type != "cuda":
        for k, host_chunk in enumerate(chunks):
            chunk = _host_tensors(host_chunk)
            if put is not None:
                chunk = tuple(put(x, False) for x in chunk)
            with trace.span("stream.fold", meta=k):
                planes = fold_step(planes, chunk)
            if pool is not None:
                pool.release(host_chunk)
        return planes

    main = torch.cuda.current_stream(device)
    copy = torch.cuda.Stream(device)
    slots: list = [None, None]  # device chunk buffers, allocated lazily
    freed: list = [None, None]  # event: the last fold reading each slot
    pending = None  # (slot, copy-done event) of the chunk awaiting its fold
    k = 0
    for host_chunk in chunks:
        host = _host_tensors(host_chunk)
        s = k % 2
        with trace.span("stream.h2d", meta=k):
            n = sum(x.nbytes for x in host)
            trace.add("h2d_bytes", n)
            if pool is None or not pool.pin:
                trace.add("h2d_pageable_bytes", n)
            fresh = put is None and (slots[s] is None or any(
                d.shape != h.shape for d, h in zip(slots[s], host)))
            if fresh:
                # allocated on the fold's stream, which alone reads them;
                # the memory may come back from work still queued there
                slots[s] = tuple(torch.empty(h.shape, dtype=h.dtype,
                                             device=device) for h in host)
            with torch.cuda.stream(copy):
                if put is not None:
                    # the placement allocates on the side stream; the
                    # fold on the main stream reads what it returns
                    slots[s] = tuple(put(h, True) for h in host)
                    for d in slots[s]:
                        d.record_stream(main)
                else:
                    if fresh:
                        copy.wait_stream(main)
                    elif freed[s] is not None:
                        copy.wait_event(freed[s])
                    for d, h in zip(slots[s], host):
                        d.copy_(h, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(copy)
        if pending is not None:
            ps, pevent = pending
            main.wait_event(pevent)
            with trace.span("stream.fold", meta=k - 1):
                planes = fold_step(planes, slots[ps])
            freed[ps] = torch.cuda.Event()
            freed[ps].record(main)
        if pool is not None:
            # this chunk's copy rode under the fold just enqueued; once
            # it has landed the pinned buffer may be refilled
            landed.synchronize()
            pool.release(host_chunk)
        pending = (s, landed)
        k += 1
    if pending is not None:
        ps, pevent = pending
        main.wait_event(pevent)
        with trace.span("stream.fold", meta=k - 1):
            planes = fold_step(planes, slots[ps])
    return planes


def planes_to_host(planes):
    """Wait for the folds in flight and pull the planes to the host as
    numpy arrays, under the ``stream.d2h`` span."""
    with trace.span("stream.d2h"):
        return tuple(x.cpu().numpy() for x in planes)


def orset_fold_stream(clock0, add0, rm0, chunks, *, num_members: int,
                      num_replicas: int, device, retire_rm: bool = True,
                      pool: ChunkPool | None = None):
    """Fold an iterable of fixed-shape op chunks into the state planes.

    ``clock0``/``add0``/``rm0`` are host (numpy) planes, uploaded to
    ``device`` once, or int32 tensors already there (a plane-cache hit),
    taken as they are; the stream may recycle their memory.  ``chunks`` yields ``(kind, member, actor,
    counter)`` of one common row count (:func:`iter_orset_chunks`), and
    each chunk is one ``orset_fold_cuda`` launch with ``retire_rm`` (on
    by default, as the JAX stream's chunks retire).  The planes ping-pong
    between two triples on the device.  Returns the folded ``(clock, add,
    rm)`` tensors on ``device`` without waiting for them.

    Pass ``pool`` when the chunk iterator stages into a
    :class:`ChunkPool`, so its buffers recycle."""
    device = torch.device(device)
    if isinstance(clock0, torch.Tensor):
        planes = (clock0, add0, rm0)
    else:
        host = [np.ascontiguousarray(x, np.int32) for x in (clock0, add0, rm0)]
        if device.type == "cuda":
            n = sum(x.nbytes for x in host)
            trace.add("h2d_bytes", n)
            trace.add("h2d_pageable_bytes", n)
        planes = tuple(torch.from_numpy(x).to(device) for x in host)
    spare: list = [None]

    def fold_step(planes, chunk):
        out, spare[0] = spare[0], planes
        return orset_fold_cuda(
            *planes, *chunk, num_members=num_members,
            num_replicas=num_replicas, retire_rm=retire_rm, out=out,
        )

    return fold_chunks_overlapped(planes, chunks, fold_step, pool=pool)


class PipelineError(Exception):
    """A producer-stage failure, re-raised in the consumer with the
    original exception as ``__cause__``."""


def run_ingest_pipeline(
    spans, ingest_fn, reduce_fn, *, depth: int = 0, producers: int = 1,
    thread_prefix: str = "crdt-ingest-producer",
):
    """Ordered fan-out pipeline over ``spans`` (any sequence of work
    items — encrypted-blob slices for one remote's chunked ingest, or
    whole tenants for the multi-tenant serving layer's cross-tenant
    decode fan-out, ``serve/service.py``).

    ``producers`` worker threads pull span indices from a shared cursor
    and run ``ingest_fn(span, k)`` — decrypt + decode; host work whose
    native calls release the GIL — concurrently, while the calling
    thread runs ``reduce_fn(ingested, k)`` — columnarize + fold.  A
    sequencer on the calling thread re-emits completed chunks in STRICT
    chunk-index order, so the reduction order — and therefore the
    donated-fold planes and the resulting state bytes — is identical to
    the single-producer pipeline whatever the workers' finish order.

    Backpressure: a ``BoundedSemaphore(depth)`` is acquired BEFORE a
    chunk is claimed and released only after its reduce completes, so at
    most ``depth`` chunks are ever live host-side — including chunks the
    sequencer is holding back.  ``depth=0`` auto-sizes to
    ``max(2, producers + 1)``: one chunk per worker in flight plus one
    being reduced (the N-producer generalization of the double buffer).
    No deadlock is possible: indices are claimed in increasing order
    immediately after a slot acquire, so the chunk the sequencer waits
    for is always either unclaimed with a free slot on its way, or
    already being ingested by a live worker.

    Stage timing: each ingest runs under a ``stream.ingest`` span and
    each reduce under ``stream.reduce``, both with ``meta=k``; workers
    are named ``<thread_prefix>-<i>`` (default ``crdt-ingest-producer``;
    the serving layer passes ``crdt-serve-producer`` so its lanes stay
    distinguishable in a timeline export) so the timeline export gives
    each its own lane.  ``stream.producer.wait`` (meta = producer index)
    times a worker's backpressure stall, ``stream.sequence`` (meta = k)
    times the sequencer's wait for the next in-order chunk, and the
    ``stream_producers`` gauge records the pool width of the run.

    Errors: the first failing producer sets the shared stop flag — its
    peers cancel at their next claim or slot poll, never claiming new
    chunks — and the failure surfaces here as :class:`PipelineError`
    (original as ``__cause__``) once every chunk BEFORE the failed index
    has been reduced (chunks after it are discarded, releasing their
    pending sequencer slots).  A consumer exception stops all producers
    at their next poll and re-raises unchanged.  Either way the worker
    threads are joined before this function returns.
    """
    spans = list(spans)
    n_spans = len(spans)
    producers = max(1, int(producers))
    if depth <= 0:
        depth = max(2, producers + 1)
    trace.gauge("stream_producers", producers)
    if n_spans == 0:
        return
    slots = threading.BoundedSemaphore(depth)
    out_q: _queue.Queue = _queue.Queue()
    stop = threading.Event()
    cursor_lock = threading.Lock()
    next_index = [0]

    def produce(pid: int):
        k = None
        try:
            while True:
                # backpressure BEFORE claiming an index: a worker must
                # never sit on a claimed chunk while waiting for memory,
                # or the sequencer could stall behind an unstarted chunk
                # (poll so a dead consumer can't strand this thread)
                with trace.span("stream.producer.wait", meta=pid):
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                if stop.is_set():
                    slots.release()
                    return
                with cursor_lock:
                    k = next_index[0]
                    next_index[0] += 1
                if k >= n_spans:
                    slots.release()
                    return
                with trace.span("stream.ingest", meta=k):
                    item = ingest_fn(spans[k], k)
                out_q.put(("chunk", k, item))
                k = None
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            stop.set()  # first failure cancels the peers
            out_q.put(("error", k if k is not None else -1, e))

    # each producer runs in a copy of the caller's context, so its spans
    # sit in the caller's span tree
    workers = [
        threading.Thread(
            target=contextvars.copy_context().run, args=(produce, i),
            name=f"{thread_prefix}-{i}", daemon=True,
        )
        for i in range(producers)
    ]
    for w in workers:
        w.start()
    stash: dict[int, object] = {}
    failures: dict[int, BaseException] = {}
    expected = 0
    try:
        while expected < n_spans:
            if failures and expected >= min(failures):
                k = min(failures)
                raise PipelineError(
                    f"ingest producer failed at chunk {k}"
                ) from failures[k]
            if expected in stash:
                item = stash.pop(expected)
            else:
                with trace.span("stream.sequence", meta=expected):
                    while True:
                        tag, k, item = out_q.get()
                        if tag == "error":
                            failures[k] = item
                            break
                        if k == expected:
                            break
                        stash[k] = item  # holds its slot until reduced
                if tag == "error":
                    continue  # drain the pre-failure prefix, then raise
            try:
                with trace.span("stream.reduce", meta=expected):
                    reduce_fn(item, expected)
            finally:
                slots.release()
            expected += 1
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30.0)


class _ChunkWork:
    """One claimed chunk on the unified work queue: its stripe list, the
    claim cursor, the landed parts, and the remaining-stripe count."""

    __slots__ = ("span", "stripes", "next_stripe", "remaining", "parts")

    def __init__(self, span, stripes):
        self.span = span
        self.stripes = stripes
        self.next_stripe = 0
        self.remaining = len(stripes)
        self.parts = [None] * len(stripes)


def run_striped_ingest_pipeline(
    spans, split_fn, stripe_fn, assemble_fn, reduce_fn, *,
    depth: int = 0, producers: int = 1, inline: bool | None = None,
    thread_prefix: str = "crdt-ingest-producer",
):
    """File-granular fan-out over ``spans``: the unified work queue.

    The work unit is a **stripe** (a file subrange of one chunk,
    ``split_fn(span, k) -> [stripe, ...]``): producers claim stripes from
    one shared queue, preferring the OLDEST in-flight chunk's unclaimed
    stripes and opening a new chunk (in index order, after a backpressure
    slot acquire) only when none are left, so one giant file occupies one
    worker while the rest of the pool keeps the pipeline full.

    ``stripe_fn(stripe, k, s) -> part`` runs concurrently (decrypt).  The
    worker that lands a chunk's LAST stripe runs ``assemble_fn(parts,
    span, k) -> item`` (decode) and emits it; the calling thread reduces
    items in STRICT chunk order through a sequencer that stashes chunks
    finishing early, so the folded bytes are the same at any producer
    count and any stripe split.  Backpressure: a
    ``BoundedSemaphore(depth)`` (``depth=0``: ``producers + 1``, at least
    2) is acquired before a chunk is opened and released only after its
    reduce completes, so at most that many chunks are ever live, stashed
    ones included.

    ``inline`` (None = auto): with one producer on a single-core host
    the worker thread cannot overlap anything, so the whole pipeline
    runs on the calling thread, byte-identically; ``inline=False``
    forces the threaded path.

    Spans: ``stream.stripe``, ``stream.ingest`` and ``stream.reduce``
    (``meta=k``), ``stream.producer.wait`` (meta = producer index) and
    ``stream.sequence`` (meta = k); workers are named
    ``<thread_prefix>-<i>``; the ``stream_producers`` gauge records the
    pool width.

    Errors: the first stripe or assemble failure stops the pool and
    raises :class:`PipelineError` (original as ``__cause__``) WITHOUT
    draining earlier chunks; the caller feeds a fold session, which
    mutates nothing until ``finish``, so a raise discards cleanly.  A
    reduce exception re-raises unchanged; the workers are always joined
    before returning."""
    spans = list(spans)
    n_spans = len(spans)
    producers = max(1, int(producers))
    if depth <= 0:
        depth = max(2, producers + 1)
    trace.gauge("stream_producers", producers)
    if n_spans == 0:
        return
    if inline is None:
        inline = producers == 1 and (os.cpu_count() or 1) <= 1
    if inline:
        for k, span in enumerate(spans):
            stripes = split_fn(span, k)
            with trace.span("stream.ingest", meta=k):
                parts = [
                    stripe_fn(stripe, k, s)
                    for s, stripe in enumerate(stripes)
                ]
                item = assemble_fn(parts, span, k)
            with trace.span("stream.reduce", meta=k):
                reduce_fn(item, k)
        return

    slots = threading.BoundedSemaphore(depth)
    out_q: _queue.Queue = _queue.Queue()
    stop = threading.Event()
    lock = threading.Lock()
    next_chunk = [0]
    active: dict[int, _ChunkWork] = {}  # insertion order = chunk order

    def claim():
        """The next (work, k, s) stripe claim from the oldest in-flight
        chunk, ``"new"`` when a fresh chunk must be opened (the slot is
        acquired OUTSIDE the lock), or ``None`` when no work remains."""
        with lock:
            for k, work in active.items():
                if work.next_stripe < len(work.stripes):
                    s = work.next_stripe
                    work.next_stripe += 1
                    return work, k, s
            if next_chunk[0] < n_spans:
                return "new"
        return None

    def open_chunk():
        """Claim the next chunk index and register its stripes: a stripe
        claim from it, ``"empty"`` for a chunk with no stripes (emitted
        at once), or ``None`` when exhausted.  The caller holds a slot."""
        with lock:
            k = next_chunk[0]
            if k >= n_spans:
                return None
            next_chunk[0] += 1
        stripes = split_fn(spans[k], k)
        if stripes:
            with lock:
                work = _ChunkWork(spans[k], stripes)
                work.next_stripe = 1
                active[k] = work
            return work, k, 0
        out_q.put(("chunk", k, assemble_fn([], spans[k], k)))
        return "empty"

    def finish_stripe(work, k, s, part):
        with lock:
            work.parts[s] = part
            work.remaining -= 1
            done = work.remaining == 0
            if done:
                active.pop(k, None)
        if done:
            with trace.span("stream.ingest", meta=k):
                item = assemble_fn(work.parts, work.span, k)
            out_q.put(("chunk", k, item))

    def produce(pid: int):
        k = None
        try:
            while True:
                if stop.is_set():
                    return
                got = claim()
                if got is None:
                    return
                if got == "new":
                    # backpressure BEFORE opening a chunk; stripes of open
                    # chunks need no slot, their chunk holds one
                    with trace.span("stream.producer.wait", meta=pid):
                        while not slots.acquire(timeout=0.1):
                            if stop.is_set():
                                return
                    if stop.is_set():
                        slots.release()
                        return
                    got = open_chunk()
                    if got is None:
                        slots.release()
                        return
                    if got == "empty":
                        continue  # the slot rides with the emitted chunk
                work, k, s = got
                with trace.span("stream.stripe", meta=k):
                    part = stripe_fn(work.stripes[s], k, s)
                finish_stripe(work, k, s, part)
                k = None
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            stop.set()
            out_q.put(("error", k if k is not None else -1, e))

    workers = [
        threading.Thread(target=contextvars.copy_context().run,
                         args=(produce, i), name=f"{thread_prefix}-{i}",
                         daemon=True)
        for i in range(producers)
    ]
    for w in workers:
        w.start()
    stash: dict[int, object] = {}
    expected = 0
    try:
        while expected < n_spans:
            if expected in stash:
                item = stash.pop(expected)
            else:
                with trace.span("stream.sequence", meta=expected):
                    while True:
                        tag, k, item = out_q.get()
                        if tag == "error":
                            raise PipelineError(
                                f"striped ingest failed at chunk {k}"
                            ) from item
                        if k == expected:
                            break
                        stash[k] = item  # holds its slot until reduced
            try:
                with trace.span("stream.reduce", meta=expected):
                    reduce_fn(item, expected)
            finally:
                slots.release()
            expected += 1
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=30.0)
