"""Chunked fold sessions: bounded-memory bulk ingestion.

The port's copy of ``crdt_enc_tpu/parallel/session.py``.  A session takes
decrypted op-file payloads chunk by chunk (fed by the core's pipelined
reader, ``Core._read_remote_ops_pipelined``) and folds them into one CRDT
state with memory bounded by the chunk size.  Only ``finish()`` mutates
the state, and it bumps the state's epoch.

Three modes for the OR-Set, chosen by regime:

* **BUFFER** — small ingests accumulate columns and fold once at finish
  through the accelerator's regime-picking tail (the vectorized sparse
  fold in the sparse regime — natively, stashing its rows for the
  checkpoint, into an empty state — else the dense or blockwise device
  fold); the fold bumps the state's epoch itself and nothing after it
  does, so the stash stays valid.  The session
  leaves BUFFER as soon as the buffered column bytes pass
  ``BUFFER_BYTES``.
* **HOST_REDUCE** — while the dense planes are small against the row
  stream (``E·R ≤ HOST_PLANE_CELLS``), each chunk reduces into host
  planes (a masked scatter-max, ``np.maximum.at``), and finish combines
  them with the state once.
* **DEVICE_STREAM** — past that, the batch planes live on the device,
  start from zero, and fixed-shape row chunks stream through the fold
  kernel with ``retire_rm=False`` (ops/stream.py), one launch per chunk;
  finish pulls them back and combines them with the state.  Under an
  ACTIVE MESH (and the accelerator's ``sharded_stream``, on by default)
  promotion always streams, sharded (``_device_feed_sharded``): chunks
  over ``dp``, planes over ``mp``, each chunk one
  ``mesh.orset_fold_sharded`` in partial-reduction mode (one K2 launch
  per shard).  A mesh without the sharded stream, or one that spans
  processes, stays buffered and folds once at finish through the
  whole-batch sharded fold.

Both reduce modes combine at finish with op-APPLY semantics
(:func:`apply_batch_planes_host`) against the state re-read there, never
with the CvRDT merge: the batch planes are a fold of ops from a zero
clock, and the merge's survivor rule would read their clock as state
history and delete untouched members (JAX session.py:673-685).

Exactness: every mode reproduces the one-big-fold semantics.
HOST_REDUCE masks stale adds against the state clock captured at session
start; DEVICE_STREAM's carried clock rejects only true replays under the
core's per-actor version order.

The planes hold exactly the members seen so far and grow by
concatenation when a chunk brings new ones: eager PyTorch compiles
nothing per shape, so the JAX package's power-of-two capacities and
member overshoot (a bound on XLA recompiles) have no counterpart here.

``MapFoldSession`` folds CrdtMap<orset> chunks: each decodes natively to
the map's four row families, and finish runs the columnar map fold once
against the state read there (its scatter phase on the device from
``min_device_batch`` rows).

Left out of the copy: the device-memory sampling at fold boundaries.
The device-decode experiment
(``CRDT_DEVICE_DECODE=1``, off by default) gates the OR-Set session's
decode as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import CrdtMap, GCounter, ORSet, PNCounter
from ..models.counters import POS
from ..ops.columnar import (
    KIND_ADD,
    KIND_RM,
    Vocab,
    dense_to_vclock,
    orset_planes_to_state,
    orset_scan_vocab,
    orset_state_to_planes,
    vclock_to_dense,
)
from ..ops.device_decode import decode_adds_device, device_decode_enabled
from ..ops.native_decode import (
    combine_orset_spans,
    decode_counter_payload_batch,
    decode_orset_payload_spans,
)
from ..ops.orset_fold_cuda import orset_fold_cuda
from ..ops.stream import fold_chunks_overlapped, iter_orset_chunks
from ..utils import codec, trace

BUFFER_BYTES = 4 << 20  # leave BUFFER beyond this many column bytes
# host-reduce planes up to E·R = 128M cells (~1.5 GB for three int32
# planes); past that the planes, not the rows, dominate, and they stay on
# the device
HOST_PLANE_CELLS = 1 << 27
DEVICE_CHUNK_ROWS = 1 << 20  # device-stream row chunk


class SessionDeclined(Exception):
    """The native decoder cannot represent this chunk (non-canonical
    encoding, unknown actor, vocabulary collision); the caller must fold
    it another way."""


def apply_batch_planes_host(clock0, add0, rm0, add_b, rm_b, clock_b=None):
    """numpy twin of :func:`crdt_enc_tpu_torch.ops.orset.
    orset_apply_batch_planes`: batch planes (reductions of OPS) applied to
    the state planes — the replay gate against the current clock, the
    add/rm max, the kill and the retire.  The two never diverge
    (tests/test_torch_session.py).

    ``clock_b``: the batch's own clock (the max add counter per actor
    over every row), where ``add_b`` has been through the kill: a dot the
    batch added and then removed is gone from ``add_b`` but still
    advances the clock, as in the one-big-fold."""
    add_b = np.where(add_b > clock0[None, :], add_b, 0)
    clock = np.maximum(clock0, add_b.max(axis=0, initial=0))
    if clock_b is not None:
        clock = np.maximum(clock, clock_b)
    add = np.maximum(add0, add_b)
    rm = np.maximum(rm0, rm_b)
    add = np.where(add > rm, add, 0)
    rm = np.where(rm > clock[None, :], rm, 0)
    return clock, add, rm


class OrsetFoldSession:
    """Fold ORSet op-file payloads chunk by chunk into ``state``.

    Protocol: ``feed(payloads)`` per chunk — or ``decode_chunk`` (thread
    safe, mutates nothing) then ``reduce_chunk`` (serialized by the
    caller) — raising :class:`SessionDeclined` with the chunk unconsumed
    when the decoder declines, then ``finish()`` exactly once: only
    finish mutates ``state``.  ``mode`` names the regime, and
    ``device_chunks`` counts the fold launches DEVICE_STREAM made."""

    # decode_chunk_parts takes the packed ``(buffer, offsets)`` cleartext
    # of decrypt_blobs_packed as it is
    accepts_packed = True

    def __init__(self, accel, state: ORSet, actors_hint=()):
        self.accel = accel
        self.state = state
        clock_counters = state.clock.counters
        # one pass over the state builds both vocabularies: actors by
        # set.update per entry dict, members in first-appearance order
        actor_set = set(actors_hint)
        actor_set.update(clock_counters)
        member_list = []
        for m, entry in state.entries.items():
            member_list.append(m)
            actor_set.update(entry)
        for m, dfr in state.deferred.items():
            member_list.append(m)
            actor_set.update(dfr)
        self.actors_sorted = sorted(actor_set)
        self.replicas = Vocab(self.actors_sorted)
        self.members = Vocab(member_list)
        self.R = len(self.replicas)
        # the stale-add mask reads the clock as of session start for
        # EVERY chunk: one-big-batch semantics
        self._clock0 = np.zeros(max(self.R, 1), np.int32)
        index = self.replicas.index
        for a, c in clock_counters.items():
            self._clock0[index[a]] = c
        self.mode = "buffer"
        self._buffered: list[tuple] = []
        self._buffered_bytes = 0
        self._member_canon: dict[int, bytes] = {}
        self._member_ids: dict[bytes, int] = {}  # wire bytes → member id
        # the actor table's native hash index, built once per session and
        # shared by concurrent decodes (its entries never change)
        self._decode_cache: dict = {}
        self.rows_fed = 0
        self.device_chunks = 0
        # HOST_REDUCE accumulators (allocated at promotion)
        self._h_add = self._h_rm = None
        # DEVICE_STREAM planes and their ping-pong spare
        self._d_planes = None
        self._d_spare = None
        self._d_E = 0
        self._finished = False

    # ------------------------------------------------------------------ feed
    def decode_chunk(self, payloads: list):
        """Stage 1, thread-safe (no session mutation): native columnar
        decode of one chunk's payloads.  The native call releases the
        interpreter lock, so the core decodes chunk i+1 while chunk i
        reduces."""
        return self.decode_chunk_parts([payloads])

    def decode_chunk_parts(self, parts: list):
        """Multi-part twin of :meth:`decode_chunk`: each element of
        ``parts`` is one stripe's cleartext — a packed ``(buffer,
        offsets)`` pair or a payload list — decoded in place and combined.
        Thread-safe like ``decode_chunk``.

        With ``CRDT_DEVICE_DECODE=1`` a chunk of one packed part first
        tries the device-decode experiment on the session's device
        (ops/device_decode.py); a chunk it declines (anything but
        fixed-stride adds, or an unknown actor) takes the native decoder
        below."""
        if len(parts) == 1 and isinstance(parts[0], tuple) \
                and device_decode_enabled():
            decoded = decode_adds_device(parts[0], self.actors_sorted,
                                         self.accel.device)
            if decoded is not None:
                return decoded
        with trace.span("session.decode"):
            decoded_parts = []
            for payloads in parts:
                part = decode_orset_payload_spans(
                    payloads, self.actors_sorted, cache=self._decode_cache
                )
                if part is None:
                    raise SessionDeclined("native decoder declined the chunk")
                decoded_parts.append(part)
            return combine_orset_spans(decoded_parts, with_bytes=True)

    def reduce_chunk(self, decoded) -> None:
        """Stage 2, serialized by the caller (mutates the vocabulary and
        the batch planes, never the state)."""
        if self._finished:
            raise RuntimeError("session already finished")
        kind, member_idx, actor_idx, counter, member_objs, member_bytes = decoded
        if len(kind) == 0:
            return
        with trace.span("session.remap"):
            member_global = self._remap_members(member_idx, member_objs,
                                                member_bytes)
        self.rows_fed += len(kind)
        cols = (kind, member_global, actor_idx, counter)
        if self.mode == "buffer":
            self._buffered.append(cols)
            self._buffered_bytes += len(kind) * 13
            if self._buffered_bytes > BUFFER_BYTES:
                self._promote()
        elif self.mode == "host_reduce":
            self._host_reduce(*cols)
        else:
            self._device_feed(*cols)

    def feed(self, payloads: list) -> None:
        """Decode and reduce in one call."""
        self.reduce_chunk(self.decode_chunk(payloads))

    def _remap_members(self, member_idx, member_objs, member_bytes):
        """Chunk-local member interning → the session-wide vocabulary.  A
        member seen before (by its wire bytes) is one dict hit; a new one
        is interned once and its canonical bytes remembered.

        Collision guard: distinct canonical bytes can collide as Python
        values (1 == True, 0.0 == -0.0), across chunks or against members
        already in the state.  The dense planes cannot hold that, so a
        mismatch declines the chunk (the per-op path then matches the host
        dict semantics).  A NON-canonical wire alias of the same value is
        accepted and cached per wire span."""
        canon = self._member_canon
        ids = self._member_ids
        table = np.empty(len(member_bytes), np.int32)
        for i, pk in enumerate(member_bytes):
            gid = ids.get(pk)
            if gid is None:
                obj = member_objs[i]
                gid = self.members.intern(obj)
                prev = canon.get(gid)
                if prev is None:
                    prev = codec.pack(self.members.items[gid])
                    canon[gid] = prev
                if prev != pk and codec.pack(obj) != prev:
                    raise SessionDeclined("member vocab collision")
                ids[pk] = gid
            table[i] = gid
        return table[member_idx]

    # ------------------------------------------------------------- promotion
    def _promote(self) -> None:
        """Leave BUFFER: pick the representation for this regime and
        replay the buffered chunks through it."""
        mesh_on = self.accel._mesh_active()
        if mesh_on and (not self.accel.sharded_stream
                        or self.accel.mesh.spans_processes):
            # the whole-batch sharded fold at finish: the sharded stream
            # is off, or the mesh spans processes, whose ranks would have
            # to stream their chunks in lockstep
            return
        E_est = max(len(self.members), 1)
        if not mesh_on and E_est * self.R <= HOST_PLANE_CELLS:
            self.mode = "host_reduce"
            self._h_add = np.zeros((E_est, self.R), np.int32)
            self._h_rm = np.zeros((E_est, self.R), np.int32)
            for cols in self._buffered:
                self._host_reduce(*cols)
        else:
            self.mode = "device_stream"
            self._d_E = E_est
            # the batch planes start from ZERO on the device, not from the
            # state: the stream is a pure reduction of the op batch,
            # combined with the live state at finish by op-APPLY semantics,
            # and never reading the state here keeps it safe against
            # concurrent applies (this runs off the event loop)
            if mesh_on:
                from . import mesh as pmesh

                # member axis over mp: each shard owns E_pad/mp rows
                mp = self.accel.mesh.shape["mp"]
                self._d_E = -(-E_est // mp) * mp
                self._d_planes = pmesh.sharded_stream_planes(
                    self.accel.mesh, self._d_E, self.R)
            else:
                dev = self.accel.device
                self._d_planes = (
                    torch.zeros(max(self.R, 1), dtype=torch.int32,
                                device=dev),
                    torch.zeros((self._d_E, self.R), dtype=torch.int32,
                                device=dev),
                    torch.zeros((self._d_E, self.R), dtype=torch.int32,
                                device=dev),
                )
            for cols in self._buffered:
                self._device_feed(*cols)
        self._buffered = []
        self._buffered_bytes = 0

    def _state_planes(self, E_pad: int):
        clock0, add0, rm0 = orset_state_to_planes(
            self.state, self.members, self.replicas, scanned=True
        )
        E = add0.shape[0]
        if E_pad > E:
            # columns follow the CURRENT replica vocabulary, which a
            # concurrent apply may have grown past self.R
            z = np.zeros((E_pad - E, len(self.replicas)), np.int32)
            add0 = np.concatenate([add0, z])
            rm0 = np.concatenate([rm0, z])
        return clock0, add0, rm0

    # ------------------------------------------------- host-reduce internals
    def _grow_host_planes(self) -> None:
        E_new = len(self.members)
        if E_new * self.R > 2 * HOST_PLANE_CELLS:
            # a member-skewed stream outgrew the promotion's estimate:
            # declining (before any state mutation) keeps memory bounded,
            # and the core folds the rest per op, chunk by chunk
            raise SessionDeclined(
                "member vocabulary outgrew the host reduction planes"
            )
        z = np.zeros((E_new - self._h_add.shape[0], self.R), np.int32)
        self._h_add = np.concatenate([self._h_add, z])
        self._h_rm = np.concatenate([self._h_rm, z])

    def _host_reduce(self, kind, member, actor, counter) -> None:
        """The leaf-level fold on the host: orset_fold's masked
        scatter-max (adds gated against the session-start clock)."""
        if len(self.members) > self._h_add.shape[0]:
            self._grow_host_planes()
        with trace.span("session.host_reduce"):
            R = self.R
            valid = actor < R
            seen = counter <= self._clock0[np.minimum(actor, R - 1)]
            live_add = (kind == KIND_ADD) & valid & ~seen
            is_rm = (kind == KIND_RM) & valid
            flat = member.astype(np.int64) * R + actor
            np.maximum.at(self._h_add.reshape(-1), flat[live_add],
                          counter[live_add])
            np.maximum.at(self._h_rm.reshape(-1), flat[is_rm], counter[is_rm])

    # ------------------------------------------------ device-stream internals
    def _grow_device_planes(self) -> None:
        E_new = len(self.members)
        if self.accel._mesh_active():
            mp = self.accel.mesh.shape["mp"]
            E_new = -(-E_new // mp) * mp
        clock, add, rm = self._d_planes
        z = torch.zeros((E_new - self._d_E, self.R), dtype=torch.int32,
                        device=add.device)
        self._d_planes = (clock, torch.cat([add, z]), torch.cat([rm, z]))
        self._d_spare = None
        self._d_E = E_new

    def _device_feed_sharded(self, kind, member, actor, counter) -> None:
        """DEVICE_STREAM over the accelerator's mesh: the rows pad to the
        dp axis and stream as fixed-shape chunks through
        ``mesh.sharded_stream_fold_step`` (``retire_rm=False``, one K2
        launch per shard), the accumulator planes assembled on the mesh
        between chunks; chunk k+1's upload through the mesh's row
        placement is still issued under chunk k's fold
        (``fold_chunks_overlapped`` with ``put``)."""
        from . import mesh as pmesh

        mesh = self.accel.mesh
        dp = mesh.shape["dp"]
        if len(self.members) > self._d_E:
            self._grow_device_planes()
        step = pmesh.sharded_stream_fold_step(mesh)
        put, _, _ = pmesh.stream_sharding(mesh)

        def fold_step(planes, chunk):
            self.device_chunks += 1
            return step(*planes, *chunk)

        with trace.span("session.device_fold"):
            rows = min(DEVICE_CHUNK_ROWS, len(kind))
            rows = -(-rows // dp) * dp  # the chunk shape must divide dp
            self._d_planes = fold_chunks_overlapped(
                self._d_planes,
                iter_orset_chunks(kind, member, actor, counter, rows, self.R),
                fold_step,
                put=put,
            )

    def _device_feed(self, kind, member, actor, counter) -> None:
        if self.accel._mesh_active():
            return self._device_feed_sharded(kind, member, actor, counter)
        if len(self.members) > self._d_E:
            self._grow_device_planes()

        # retire_rm=False: a horizon retired against the batch's own clock
        # would lose its kill on entries of the state; finish retires once
        # against the combined clock
        def fold_step(planes, chunk):
            out, self._d_spare = self._d_spare, planes
            self.device_chunks += 1
            return orset_fold_cuda(
                *planes, *chunk, num_members=self._d_E, num_replicas=self.R,
                retire_rm=False, out=out,
            )

        with trace.span("session.device_fold"):
            rows = min(DEVICE_CHUNK_ROWS, len(kind))
            self._d_planes = fold_chunks_overlapped(
                self._d_planes,
                iter_orset_chunks(kind, member, actor, counter, rows, self.R),
                fold_step,
            )

    # ---------------------------------------------------------------- finish
    def finish(self) -> ORSet:
        """Fold everything fed into ``state`` (the only state mutation).

        The state is re-read HERE, in one synchronous section, so applies
        or merges that landed while chunks were in flight are honoured:
        both reduce modes re-evaluate the stale mask against the current
        clock inside the op-apply combine."""
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        state = self.state
        if self.mode == "buffer":
            if not self._buffered:
                return state
            kind, member, actor, counter = (
                np.concatenate([c[i] for c in self._buffered])
                for i in range(4))
            self._buffered = []
            # the accelerator's shared tail: a live plane-cache entry
            # serves the state planes, and the dense result is cached
            return self.accel._fold_orset_columns(
                state, kind, member, actor, counter, self.members,
                self.replicas,
            )
        # concurrent applies may have introduced members (never actors of
        # the fed rows: those index the fixed actors_sorted columns)
        orset_scan_vocab(state, self.members, self.replicas)
        E = len(self.members)
        R_final = len(self.replicas)
        if self.mode == "host_reduce":
            with trace.span("session.combine"):
                E_pad = max(self._h_add.shape[0], E)
                clock0, add0, rm0 = self._state_planes(E_pad)
                add_b = self._pad_batch(self._h_add, E_pad, R_final)
                rm_b = self._pad_batch(self._h_rm, E_pad, R_final)
                clock, add, rm = apply_batch_planes_host(
                    clock0, add0, rm0, add_b, rm_b
                )
        else:
            with trace.span("session.device_finish"):
                d_clock, d_add, d_rm = (x.cpu().numpy()
                                        for x in self._d_planes)
                self._d_planes = self._d_spare = None
                E_pad = max(self._d_E, E)
                clock0, add0, rm0 = self._state_planes(E_pad)
                d_add = self._pad_batch(d_add, E_pad, R_final)
                d_rm = self._pad_batch(d_rm, E_pad, R_final)
                # the streamed planes went through the kill, so the
                # stream's clock carries the dots the batch removed (the
                # JAX session drops it, ROADMAP queue 3)
                d_clock = self._pad_batch(d_clock[None, : self.R], 1,
                                          R_final)[0]
                clock, add, rm = apply_batch_planes_host(
                    clock0, add0, rm0, d_add, d_rm, d_clock
                )
        with trace.span("session.writeback"):
            folded = orset_planes_to_state(
                clock, add[:E], rm[:E], self.members, self.replicas
            )
        state.clock = folded.clock
        state.entries = folded.entries
        state.deferred = folded.deferred
        # bump the epoch and drop the accelerator's device planes if it
        # holds this state: the combine ran on the host
        self.accel._note_orset_writeback(state)
        return state

    @staticmethod
    def _pad_batch(plane, E_pad: int, R_final: int):
        e, r = plane.shape
        if e == E_pad and r == R_final:
            return plane
        out = np.zeros((E_pad, R_final), np.int32)
        out[:e, :r] = plane
        return out


class CounterFoldSession:
    """Chunked G/PN-Counter ingestion: per-actor maxima reduce on the host
    per chunk (the planes are O(R)), one combine at finish."""

    accepts_packed = False

    def __init__(self, accel, state, actors_hint=()):
        self.accel = accel
        self.state = state
        self.is_pn = isinstance(state, PNCounter)
        clocks = (state.p.clock, state.n.clock) if self.is_pn else (state.clock,)
        actor_set = set(actors_hint)
        for c in clocks:
            actor_set.update(c.counters)
        self.actors_sorted = sorted(actor_set)
        self.replicas = Vocab(self.actors_sorted)
        self.R = len(self.replicas)
        self._p = np.zeros(max(self.R, 1), np.int64)
        self._n = np.zeros(max(self.R, 1), np.int64)
        self.rows_fed = 0
        self._finished = False

    def decode_chunk(self, payloads: list):
        with trace.span("session.decode"):
            decoded = decode_counter_payload_batch(payloads, self.actors_sorted)
        if decoded is None:
            raise SessionDeclined("native decoder declined the chunk")
        sign = decoded[0]
        if len(sign) and isinstance(self.state, GCounter) and np.any(sign != POS):
            raise SessionDeclined("PN-shaped rows in a G-Counter state")
        return decoded

    def reduce_chunk(self, decoded) -> None:
        if self._finished:
            raise RuntimeError("session already finished")
        sign, actor_idx, counter = decoded
        if len(sign) == 0:
            return
        self.rows_fed += len(sign)
        pos = sign == POS
        np.maximum.at(self._p, actor_idx[pos], counter[pos])
        np.maximum.at(self._n, actor_idx[~pos], counter[~pos])

    def feed(self, payloads: list) -> None:
        self.reduce_chunk(self.decode_chunk(payloads))

    def finish(self):
        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        state = self.state
        if self.R == 0 or self.rows_fed == 0:
            return state
        # concurrent applies may have introduced actors since the session
        # opened: rescan the state clocks (fed rows index the first R)
        clocks = (state.p.clock, state.n.clock) if self.is_pn else (state.clock,)
        for c in clocks:
            for a in c.counters:
                self.replicas.intern(a)
        R_final = len(self.replicas)
        p = self._pad(self._p, R_final)
        n = self._pad(self._n, R_final)
        if self.is_pn:
            p0 = vclock_to_dense(state.p.clock, self.replicas)
            n0 = vclock_to_dense(state.n.clock, self.replicas)
            state.p.clock = dense_to_vclock(np.maximum(p0, p), self.replicas)
            state.n.clock = dense_to_vclock(np.maximum(n0, n), self.replicas)
        else:
            c0 = vclock_to_dense(state.clock, self.replicas)
            state.clock = dense_to_vclock(np.maximum(c0, p), self.replicas)
        return state

    @staticmethod
    def _pad(arr, R_final: int):
        if len(arr) == R_final:
            return arr
        out = np.zeros(R_final, np.int64)
        out[: len(arr)] = arr
        return out


class MapFoldSession:
    """Chunked CrdtMap<orset> ingestion: each chunk decodes to the four
    row families natively (validation up front — ``SessionDeclined``
    fires while chunks are fed, never at finish) and interns its key and member
    spans into running vocabularies; finish concatenates the remapped
    families and runs the columnar map fold once against the state read
    AT FINISH (``crdtmap_fold_host``), so applies that landed while
    chunks were in flight are honored exactly like the whole-batch
    path."""

    accepts_packed = False

    def __init__(self, accel, state: CrdtMap, actors_hint=()):
        self.accel = accel
        self.state = state
        self.actors_sorted = accel._map_actor_table(state, actors_hint)
        self.keys = Vocab()
        self.members = Vocab()
        self._fams: list = []  # (B, A, Rm, K) with vocab-global indices
        self._n_groups = 0
        self.rows_fed = 0
        self._finished = False

    def decode_chunk(self, payloads: list):
        from ..ops.map_columnar import decode_map_payload_batch

        with trace.span("session.decode"):
            decoded = decode_map_payload_batch(payloads, self.actors_sorted)
        if decoded is None:
            raise SessionDeclined("native map decoder declined the chunk")
        return decoded

    @staticmethod
    def _remap(vocab: Vocab, objs):
        """Chunk-local object table → running-vocab indices; declines on
        a value collision (1 == True etc. — distinct canonical spans
        interning to one slot would scatter rows onto the wrong row)."""
        idx = np.fromiter((vocab.intern(o) for o in objs), np.int32,
                          count=len(objs))
        if len(objs) and len(np.unique(idx)) != len(objs):
            raise SessionDeclined("vocab value collision in map chunk")
        return idx

    def reduce_chunk(self, decoded) -> None:
        if self._finished:
            raise RuntimeError("session already finished")
        B, A, Rm, Kk, key_objs, member_objs = decoded
        kmap = self._remap(self.keys, key_objs)
        mmap = self._remap(self.members, member_objs)

        def rekey(fam, with_member):
            out = dict(fam)
            if len(fam["key"]):
                out["key"] = kmap[fam["key"]]
            if with_member and len(fam["member"]):
                out["member"] = mmap[fam["member"]]
            return out

        B2, A2, Rm2, K2 = (rekey(B, False), rekey(A, True), rekey(Rm, True),
                           rekey(Kk, False))
        if len(K2["group"]):
            K2["group"] = K2["group"] + self._n_groups
            self._n_groups += int(Kk["group"].max()) + 1
        self._fams.append((B2, A2, Rm2, K2))
        self.rows_fed += sum(len(f["actor"]) for f in (B2, A2, Rm2, K2))

    def feed(self, payloads: list) -> None:
        self.reduce_chunk(self.decode_chunk(payloads))

    def finish(self) -> CrdtMap:
        from ..ops.map_columnar import crdtmap_fold_host

        if self._finished:
            raise RuntimeError("session already finished")
        self._finished = True
        state = self.state
        if not self._fams:
            return state

        def cat(ix, names):
            return {n: np.concatenate([f[ix][n] for f in self._fams])
                    for n in names}

        B = cat(0, ("key", "actor", "ctr"))
        A = cat(1, ("key", "member", "actor", "ctr"))
        Rm = cat(2, ("key", "member", "actor", "ctr", "mactor", "mctr"))
        Kk = cat(3, ("key", "actor", "ctr", "group"))
        self._fams = []
        trace.add("map_rows_birth", len(B["actor"]))
        trace.add("map_rows_child_add", len(A["actor"]))
        trace.add("map_rows_child_rm", len(Rm["actor"]))
        trace.add("map_rows_key_rm", len(Kk["actor"]))
        # concurrent applies may have introduced actors since open: the
        # fed rows only ever index the original sorted prefix, so new
        # actors intern AFTER it and the row indices stay valid
        replicas = Vocab(self.actors_sorted)
        for a in self.accel._map_actor_table(state):
            replicas.intern(a)
        with trace.span("session.map_fold"):
            crdtmap_fold_host(state, B, A, Rm, Kk, self.keys, self.members,
                              replicas,
                              **self.accel._map_fold_route(self.rows_fed))
        return state


def session_supported(state) -> bool:
    """True iff a chunked columnar session exists for ``state``'s type
    (one isinstance chain, no session construction)."""
    if isinstance(state, (ORSet, GCounter, PNCounter)):
        return True
    return isinstance(state, CrdtMap) and state.child == b"orset"


def open_fold_session(accel, state, actors_hint=()):
    """A fold session for ``state``, or None when no chunked columnar
    path exists for its type (the caller folds chunks through the per-op
    path)."""
    if not session_supported(state):
        return None
    if isinstance(state, ORSet):
        return OrsetFoldSession(accel, state, actors_hint)
    if isinstance(state, (GCounter, PNCounter)):
        return CounterFoldSession(accel, state, actors_hint)
    return MapFoldSession(accel, state, actors_hint)
