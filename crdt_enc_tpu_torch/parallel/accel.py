"""Torch accelerator: the drop-in replacement for the core's host fold and
merge.

The port's counterpart of ``TpuAccelerator`` (crdt_enc_tpu/parallel/
accel.py).  It plugs in where the core takes an accelerator (the duck-typed
``fold_ops`` / ``merge_states`` interface of ``HostAccelerator``).  Each
call converts sparse host state ↔ dense tensors around the device fold or
merge; the conversion cost is amortized over whole op batches, which is
exactly the compaction shape.  ``fold_ops`` sends ORSet, PNCounter,
GCounter and LWWMap batches to the device, as the JAX accelerator does;
small batches and every other type take the host loop.  ``fold_payloads``
is the core's whole-batch bulk route: decrypted OR-Set and counter
op-file payloads decode natively into columns and fold on the device
without per-op Python objects.  OR-Set batches past ``STREAM_CHUNK_ROWS``
rows fold blockwise (ops/stream.py), and OR-Set batches in the sparse
regime (few rows over a huge vocabulary) fold by one sort on the host
(``orset_fold_sparse_host``), or with ``sparse_device`` by one sort on
the device (``ops.orset.orset_fold_coo``), whichever entry point they
come through.
``merge_states`` merges three or more ORSets on the device.
``open_fold_session`` (parallel/session.py) feeds the core's pipelined
ingest chunk by chunk; ``fold_encrypted_stream`` runs decrypt, decode and
fold as one overlapped pipeline.

A dense OR-Set fold keeps the planes it computed on the device
(``_OrsetPlaneCache``): the next fold of the same, unmutated state remaps
its batch onto the cached vocabularies and starts from those planes, so
it walks no state and uploads only the op columns.  Every host writeback bumps the state's
``_mut`` epoch, and a bumped epoch expires the entry.

With a ``mesh`` (``parallel.mesh.make_mesh``) of two or more shards,
every fold and merge the accelerator takes routes through the sharded
functions of ``parallel/mesh.py``, op rows over ``dp`` and planes over
``mp``, as the JAX accelerator's do; the plane cache stays off there.

Eager PyTorch compiles nothing per shape, so the JAX package's bucket
padding of rows and vocabularies (a bound on XLA recompiles) has no
counterpart here.
"""

from __future__ import annotations

import operator
import os
import warnings
import weakref
from itertools import islice

import numpy as np
import torch

from ..core.adapters import HostAccelerator
from ..models import (
    CrdtMap,
    GSet,
    LWWReg,
    MerkleNode,
    MerkleReg,
    MVReg,
    MVRegOp,
    SeqList,
    VClock,
)
from ..models.counters import POS, GCounter, PNCounter
from ..models.lwwmap import LWWMap, LWWOp, _wins
from ..models.orset import ORSet
from ..models.seqlist import op_from_obj as seqlist_op_from_obj
from ..ops.columnar import (
    CounterColumns,
    OrsetColumns,
    Vocab,
    counter_ops_to_columns,
    dense_to_vclock,
    lww_ops_to_columns,
    orset_apply_coo,
    orset_fits_int32,
    orset_fold_sparse_host,
    orset_ops_to_columns,
    orset_planes_to_state,
    orset_scan_vocab,
    orset_state_to_planes,
    orset_states_to_cells,
    vclock_to_dense,
)
from ..ops.counters import gcounter_fold, pncounter_fold
from ..ops.lww import TS_SPLIT_BITS, lww_fold
from ..ops.mvreg import mvreg_dominance_keep
from ..ops.native_decode import (
    combine_orset_spans,
    decode_counter_payload_batch,
    decode_orset_payload_batch,
    decode_orset_payload_spans,
)
from ..ops.orset import (orset_fold, orset_fold_coo, orset_merge_many,
                         orset_stack_cells)
from ..ops.stream import ChunkPool, iter_orset_chunks, orset_fold_stream
from ..utils import codec, trace

MIN_DEVICE_BATCH = 256  # below this the host loop wins
ENCRYPTED_STREAM_CHUNKS = 8  # fold_encrypted_stream's pipeline chunks


class _OrsetPlaneCache:
    """Device-resident ORSet state planes carried between folds (the JAX
    package's ``_OrsetPlaneCache``).

    After a dense fold writes its result back to the sparse host state,
    the planes it computed — on the device, normalized, equal to the
    state — are kept here, so the NEXT fold of the same, unmutated state
    skips the state→planes walk and the full-state upload.  Validity is
    (object identity via weakref) × (the state's ``_mut`` epoch recorded
    after the writeback): any host mutation bumps the epoch and the entry
    expires.  The vocabularies are the caching fold's; later batches
    remap onto them (value-collision-guarded, as the fold sessions
    are)."""

    __slots__ = ("ref", "token", "members", "replicas", "planes", "canon")

    def __init__(self, ref, token, members, replicas, planes, canon):
        self.ref = ref
        self.token = token
        self.members = members
        self.replicas = replicas
        self.planes = planes  # (clock, add, rm) tensors on the device
        self.canon = canon  # member slot -> canonical packed bytes


class TorchAccelerator(HostAccelerator):
    """Folds ORSet, PNCounter, GCounter and LWWMap op batches and merges
    three or more ORSet states on the device; other state types and
    batches below ``min_device_batch`` take the host loops.  Sparse
    OR-Set batches over huge vocabularies fold with the vectorized host
    fold, or the device COO fold under ``sparse_device``, as in the JAX
    package.

    ``device``: ``None`` means ``"cuda"``, and then CUDA must be
    available: the accelerator raises rather than carry on silently on
    the CPU.  ``device="cpu"`` runs the same route through the plain
    PyTorch versions of the kernels, as the tests do.

    ``mesh``: a ``parallel.mesh.Mesh``.  With two or more shards every
    fold and merge routes through the sharded functions — op rows over
    ``dp``, state planes over ``mp`` — so ``Core.compact`` runs on every
    shard; the device is the mesh's home.  ``sharded_stream`` lets the
    fold session stream through the sharded fold (parallel/session.py
    ``_device_feed_sharded``) instead of buffering the whole batch for
    one sharded fold at finish: None = ``CRDT_SHARDED_STREAM`` (``0``
    off, ``1`` or unset on, anything else warns and keeps on), and only
    ever with an active mesh.

    ``sparse_device``: sparse-regime OR-Set folds with ``2·E·R < 2^31``
    take the COO fold on the accelerator's device (``ops.orset.
    orset_fold_coo``: sort the batch by ``(member, actor)`` key, one max
    per key) instead of the host sort; the writeback is the host route's
    ``orset_apply_coo``.  Off by default, as in the JAX package.

    ``plane_reuse``: keep a dense fold's planes on the device for the
    next fold of the same state (None = ``CRDT_PLANE_REUSE``; ``0``,
    ``false``, ``off``, ``no`` or ``disabled`` turn it off, so the cache
    is never consulted or filled).

    ``stream_producers``: the ingest fan-out of ``fold_encrypted_stream``
    and the core's pipelined ingest (0 = ``ops.stream.
    stream_producer_count``: ``CRDT_STREAM_PRODUCERS``, else one per
    core but one)."""

    # Above this many plane cells per batch row the dense planes' init and
    # sweep dominate the fold; below SPARSE_MIN_CELLS they are cheap.
    SPARSE_CELLS_PER_ROW = 64
    SPARSE_MIN_CELLS = 1 << 22
    # Dense batches beyond this many rows fold blockwise, one chunk of
    # this many rows per launch (ops/stream.py), as in the JAX package
    STREAM_CHUNK_ROWS = 1 << 22

    def __init__(self, device=None, min_device_batch: int = MIN_DEVICE_BATCH,
                 mesh=None, sharded_stream: bool | None = None,
                 sparse_device: bool = False,
                 plane_reuse: bool | None = None,
                 stream_producers: int = 0):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.home:
                raise ValueError(f"TorchAccelerator: device {device} is not "
                                 f"the mesh's home {mesh.home}")
            device = mesh.home
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchAccelerator: CUDA is not available; pass "
                    "device='cpu' to run the plain PyTorch path on the host"
                )
        elif device.type != "cpu":
            raise ValueError(f"TorchAccelerator: unsupported device {device}")
        self.device = device
        self.min_device_batch = min_device_batch
        self.mesh = mesh
        # an unrecognized CRDT_SHARDED_STREAM keeps the auto default:
        # never a silent opt-in from a mistyped opt-out
        if sharded_stream is None:
            env = os.environ.get("CRDT_SHARDED_STREAM", "").strip().lower()
            if env in ("0", "false", "off", "no", "disabled"):
                sharded_stream = False
            elif env in ("1", "true", "on", "yes", "enabled") or not env:
                sharded_stream = True
            else:
                warnings.warn(
                    f"CRDT_SHARDED_STREAM={env!r} not recognized; "
                    "keeping the auto default (on with an active mesh)",
                    stacklevel=2,
                )
                sharded_stream = True
        self.sharded_stream = bool(sharded_stream) and self._mesh_active()
        self.sparse_device = sparse_device
        # device-resident plane reuse across fold rounds (one device
        # only: the sharded fold never fills it)
        if plane_reuse is None:
            plane_reuse = os.environ.get(
                "CRDT_PLANE_REUSE", ""
            ).strip().lower() not in ("0", "false", "off", "no", "disabled")
        self.plane_reuse = bool(plane_reuse)
        self._plane_cache: _OrsetPlaneCache | None = None
        self.stream_producers = stream_producers

    def _mesh_active(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1

    def _dp(self) -> int:
        return self.mesh.shape["dp"] if self._mesh_active() else 1

    def _upload(self, arrays) -> list:
        """numpy arrays → tensors on ``self.device``; counts the bytes
        that cross to a CUDA device in ``h2d_bytes`` and, since a numpy
        source is pageable, in ``h2d_pageable_bytes``."""
        if self.device.type == "cuda":
            n = sum(a.nbytes for a in arrays)
            trace.add("h2d_bytes", n)
            trace.add("h2d_pageable_bytes", n)
        return [
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in arrays
        ]

    # ------------------------------------------------------------- fold_ops
    def fold_ops(self, state, ops: list):
        if len(ops) < self.min_device_batch:
            return super().fold_ops(state, ops)
        if isinstance(state, ORSet):
            return self._fold_orset(state, ops)
        if isinstance(state, (PNCounter, GCounter)):
            return self._fold_counter(state, ops)
        if isinstance(state, LWWMap):
            return self._fold_lww(state, ops)
        return super().fold_ops(state, ops)

    def _use_sparse(self, E: int, R: int, n_rows: int) -> bool:
        cells = E * R
        return cells >= self.SPARSE_MIN_CELLS and cells > (
            self.SPARSE_CELLS_PER_ROW * max(n_rows, 1)
        )

    def _fold_orset(self, state: ORSet, ops: list) -> ORSet:
        members, replicas = Vocab(), Vocab()
        try:
            if not orset_fits_int32(state):
                raise OverflowError("state counters past int32")
            with trace.span("fold.columns"):
                cols = orset_ops_to_columns(ops, members, replicas)
        except OverflowError:
            # a counter past 2^31 − 1, in the batch or the state, which
            # the int32 columns and planes cannot hold (fold_payloads
            # declines the same): the host loop folds; nothing was mutated
            trace.add("fold_host_past_int32", 1)
            return super().fold_ops(state, ops)
        return self._fold_orset_columns(
            state, cols.kind, cols.member, cols.actor, cols.counter,
            members, replicas,
        )

    # ---------------------------------------------------------- plane cache
    def _plane_cache_for(self, state: ORSet) -> _OrsetPlaneCache | None:
        """The live cache entry for ``state``, or None (no entry, an entry
        for another object, or the state mutated since it was filled;
        always None with ``plane_reuse`` off)."""
        if not self.plane_reuse:
            return None
        c = self._plane_cache
        if c is None or c.ref() is not state:
            return None
        if c.token != getattr(state, "_mut", None):
            self._plane_cache = None  # stale: free the device planes
            return None
        return c

    @staticmethod
    def _remap_to_cache(cache: _OrsetPlaneCache, member, actor,
                        members: Vocab, replicas: Vocab):
        """Remap batch columns from their batch vocabularies onto the
        cache's (growing them), or None where the dense planes cannot
        take the batch — a member value collision (1 == True, 0.0 ==
        -0.0) or a padded/sentinel index — and the caller then takes the
        uncached path."""
        if (len(member) and int(np.max(member)) >= len(members.items)) or (
            len(actor) and int(np.max(actor)) >= len(replicas.items)
        ):
            return None  # sentinel/padded columns: not plain vocab indices
        mt = np.empty(len(members.items), np.int32)
        canon = cache.canon
        for i, obj in enumerate(members.items):
            gid = cache.members.intern(obj)
            pk = codec.pack(obj)
            prev = canon.get(gid)
            if prev is None:
                stored = cache.members.items[gid]
                prev = pk if stored is obj else codec.pack(stored)
                canon[gid] = prev
            if prev != pk:
                return None
            mt[i] = gid
        rt = np.empty(len(replicas.items), np.int32)
        for i, a in enumerate(replicas.items):
            rt[i] = cache.replicas.intern(a)
        member = mt[member] if len(member) else np.asarray(member, np.int32)
        actor = rt[actor] if len(actor) else np.asarray(actor, np.int32)
        return member, actor

    @staticmethod
    def _cached_planes_padded(cache: _OrsetPlaneCache, E: int, R: int):
        """The cached planes grown to the post-remap vocabulary sizes by
        zero padding on the device (no host round trip)."""
        clock, add, rm = cache.planes
        E0, R0 = add.shape
        if (E, R) == (E0, R0):
            return clock, add, rm
        clock2 = clock.new_zeros(R)
        clock2[:R0] = clock
        add2 = add.new_zeros((E, R))
        add2[:E0, :R0] = add
        rm2 = rm.new_zeros((E, R))
        rm2[:E0, :R0] = rm
        return clock2, add2, rm2

    def _install_plane_cache(self, state: ORSet, members: Vocab,
                             replicas: Vocab, planes, canon) -> None:
        """Record the fold's device planes as the state's resume planes.
        The writeback bump happens HERE, so the recorded token is the
        post-writeback epoch.  The weakref finalizer drops the entry when
        the state dies — plane-sized device buffers must not outlive the
        replica they cache (the accelerator is held weakly in the
        callback, so nothing keeps anything alive).  With ``plane_reuse``
        off only the epoch moves."""
        state._mut += 1
        if not self.plane_reuse:
            return
        accel_ref = weakref.ref(self)

        def _drop(dead_ref):
            accel = accel_ref()
            if accel is not None:
                c = accel._plane_cache
                if c is not None and c.ref is dead_ref:
                    accel._plane_cache = None

        self._plane_cache = _OrsetPlaneCache(
            weakref.ref(state, _drop), state._mut, members, replicas,
            tuple(planes), canon if canon is not None else {},
        )

    def _drop_plane_cache(self, state: ORSet) -> None:
        c = self._plane_cache
        if c is not None and c.ref() is state:
            self._plane_cache = None

    def _note_orset_writeback(self, state: ORSet) -> None:
        """A non-caching path rewrote ``state``: bump its epoch and drop
        any device planes held for it."""
        state._mut += 1
        self._drop_plane_cache(state)

    def _fold_orset_columns(self, state: ORSet, kind, member, actor, counter,
                            members: Vocab, replicas: Vocab) -> ORSet:
        """The shared OR-Set tail over batch columns whose indices point
        into the batch vocabularies ``members`` and ``replicas``.

        A live plane-cache entry for ``state`` remaps the batch onto the
        cached vocabularies and starts the fold from the cached device
        planes: no vocabulary scan of the state, no state→planes walk,
        and only the op columns cross to the device.  Otherwise the
        state's vocabulary is scanned in and the planes built.  Sparse
        batches over huge vocabularies take the vectorized host fold;
        dense ones fold on the device — past ``STREAM_CHUNK_ROWS`` rows
        blockwise (fixed-shape chunks staged in a depth-2 pool, each one
        fold launch into planes that stay on the device, the JAX
        package's branch) — and the result's planes stay cached."""
        n_rows = len(kind)
        cache = self._plane_cache_for(state)
        if cache is not None:
            remapped = self._remap_to_cache(cache, member, actor, members,
                                            replicas)
            if remapped is None:
                cache = None
            else:
                member, actor = remapped
                members, replicas = cache.members, cache.replicas
        if cache is None:
            with trace.span("fold.vocab"):
                orset_scan_vocab(state, members, replicas)
        E, R = len(members), len(replicas)
        if E == 0 or R == 0:
            return state
        if self._mesh_active():
            # rows over dp, planes over mp: the mp axis is what makes
            # huge planes tractable, so the sparse route does not apply
            return self._fold_orset_sharded(state, kind, member, actor,
                                            counter, members, replicas)
        if self._use_sparse(E, R, n_rows):
            # the sparse writeback bumps the epoch itself (and stashes
            # its rows for the checkpoint under that epoch): only the
            # planes go
            self._drop_plane_cache(state)
            if self.sparse_device and 2 * E * R < 2**31:
                return self._fold_orset_coo_device(
                    state, kind, member, actor, counter, members, replicas)
            return orset_fold_sparse_host(state, kind, member, actor,
                                          counter, members, replicas)
        if cache is not None:
            # a hit consumes the entry: the fold's output replaces it, and
            # planes a failed fold may have recycled are never served
            self._plane_cache = None
            planes = self._cached_planes_padded(cache, E, R)
        else:
            with trace.span("fold.planes"):
                planes = orset_state_to_planes(state, members, replicas,
                                               scanned=True)
        with trace.span("fold.device"):
            if n_rows > self.STREAM_CHUNK_ROWS:
                rows = self.STREAM_CHUNK_ROWS
                pool = ChunkPool(rows, depth=2,
                                 pin=self.device.type == "cuda")
                out = orset_fold_stream(
                    *planes,
                    iter_orset_chunks(kind, member, actor, counter, rows, R,
                                      pool=pool),
                    num_members=E, num_replicas=R, device=self.device,
                    pool=pool,
                )
                del planes
            else:
                if cache is None:
                    planes = self._upload(planes)
                dev = self._upload((kind, member, actor, counter))
                out = orset_fold(*planes, *dev, num_members=E, num_replicas=R)
                del planes, dev
            clock, add, rm = (x.cpu().numpy() for x in out)
        with trace.span("fold.writeback"):
            folded = orset_planes_to_state(clock, add, rm, members, replicas)
        state.clock = folded.clock
        state.entries = folded.entries
        state.deferred = folded.deferred
        # the planes just computed ARE the new state, on the device: keep
        # them for the next round (epoch recorded after the writeback)
        self._install_plane_cache(
            state, members, replicas, out,
            cache.canon if cache is not None else None,
        )
        return state

    def _fold_orset_coo_device(self, state: ORSet, kind, member, actor,
                               counter, members: Vocab,
                               replicas: Vocab) -> ORSet:
        """The sparse regime on the device: ``orset_fold_coo`` sorts the
        batch by segment key and takes one max per key without dense
        planes; the writeback is ``orset_apply_coo``, shared with the
        host route, so the two cannot drift."""
        # the dense clock first: it may intern clock actors into
        # `replicas`, and the segment keys are taken modulo the final R
        clock0 = vclock_to_dense(state.clock, replicas)
        E, R = len(members), len(replicas)
        with trace.span("fold.coo"):
            dev = self._upload((
                clock0, np.asarray(kind, np.int8), np.asarray(member),
                np.asarray(actor), np.asarray(counter),
            ))
            clock, skey, smax, is_max = (
                x.cpu().numpy() for x in orset_fold_coo(
                    *dev, num_members=E, num_replicas=R)
            )
            del dev
        with trace.span("fold.writeback"):
            return orset_apply_coo(state, clock, skey, smax, is_max,
                                   members, replicas)

    def _fold_orset_sharded(self, state: ORSet, kind, member, actor, counter,
                            members: Vocab, replicas: Vocab) -> ORSet:
        """The mesh tail: pad the rows to the dp axis and the planes' member
        axis to the mp axis (zero rows, sliced off at writeback), fold
        through ``mesh.orset_fold_sharded`` (one K1 launch per shard on
        the card), write the planes back."""
        from . import mesh as pmesh

        mesh = self.mesh
        dp, mp = mesh.shape["dp"], mesh.shape["mp"]
        E, R = len(members), len(replicas)
        with trace.span("fold.planes"):
            clock0, add0, rm0 = orset_state_to_planes(state, members, replicas,
                                                      scanned=True)
            E_pad = -(-E // mp) * mp
            if E_pad != E:
                z = np.zeros((E_pad - E, R), np.int32)
                add0 = np.concatenate([add0, z])
                rm0 = np.concatenate([rm0, z])
            cols = OrsetColumns(
                np.asarray(kind, np.int8), np.asarray(member, np.int32),
                np.asarray(actor, np.int32), np.asarray(counter, np.int32),
            )
            pmesh.pad_rows_for_mesh(cols, dp, R)
            rows = pmesh.process_rows(mesh, cols.kind, cols.member, cols.actor,
                                      cols.counter)
        with trace.span("fold.device"):
            dev = self._upload((clock0, add0, rm0, *rows))
            out = pmesh.orset_fold_sharded(mesh, *dev)
            del dev
            clock, add, rm = (x.cpu().numpy() for x in out)
        with trace.span("fold.writeback"):
            folded = orset_planes_to_state(clock, add[:E], rm[:E], members,
                                           replicas)
        state.clock = folded.clock
        state.entries = folded.entries
        state.deferred = folded.deferred
        self._note_orset_writeback(state)
        return state

    # -------------------------------------------------------- fold_payloads
    def fold_payloads(self, state, payloads: list, actors_hint=()) -> bool:
        """Bulk front end: decrypted op-file payloads → native columnar
        decode → one device fold, with no per-op Python objects.  Handles
        the OR-Set, the two counters and the causal map; OR-Set batches
        past ``STREAM_CHUNK_ROWS`` rows fold blockwise.  The rest of the
        catalogue unpacks each file whole: the LWW register folds through
        the LWW kernel at one key, the MVReg through the dominance filter,
        and the G-Set, sequence list and Merkle register on the host (no
        arithmetic to put on the device: hashing, ordering, DAG
        bookkeeping).  Returns False — with ``state`` untouched — where the
        caller must decode per op and call ``fold_ops`` instead: any other
        state type, an OR-Set whose counters pass int32, a payload the
        native decoder declines (unknown actor,
        counter past int32, a map remove over 64 actors, a child dot that
        is not its map dot), a key or member vocabulary that collapses as
        Python values, and an LWW timestamp outside [0, 2^62).  OR-Set
        batches in the sparse regime fold through the sparse route."""
        if isinstance(state, (GCounter, PNCounter)):
            return self._fold_counter_payloads(state, payloads, actors_hint)
        if isinstance(state, CrdtMap):
            return self._fold_map_payloads(state, payloads, actors_hint)
        if isinstance(state, GSet):
            return self._fold_gset_payloads(state, payloads)
        if isinstance(state, LWWReg):
            return self._fold_lwwreg_payloads(state, payloads)
        if isinstance(state, MVReg):
            return self._fold_mvreg_payloads(state, payloads)
        if isinstance(state, SeqList):
            return self._fold_seqlist_payloads(state, payloads)
        if isinstance(state, MerkleReg):
            return self._fold_merklereg_payloads(state, payloads)
        if not isinstance(state, ORSet) or not orset_fits_int32(state):
            return False
        actors_sorted = self._orset_actor_table(
            state, actors_hint, self._plane_cache_for(state))
        with trace.span("fold.decode"):
            decoded = decode_orset_payload_batch(payloads, actors_sorted)
        if decoded is None:
            return False
        return self._fold_orset_decoded(state, decoded, actors_sorted)

    @staticmethod
    def _orset_actor_table(state: ORSet, actors_hint, cache=None) -> list:
        """Sorted, unique actor table for the native decoder: the caller's
        hint plus every actor the state mentions — read off a live plane
        cache's replica vocabulary where there is one, which covers the
        unmutated state, instead of walking the state.  A strictly sorted
        hint that already covers the state is used as it is (storage
        listings come sorted; re-sorting 100k byte strings costs more
        than the decrypt)."""
        hint = list(actors_hint)
        actor_set = set(hint)
        if cache is not None:
            actor_set.update(cache.replicas.items)
        else:
            actor_set.update(state.clock.counters)
            for entry in state.entries.values():
                actor_set.update(entry)
            for dfr in state.deferred.values():
                actor_set.update(dfr)
        if len(actor_set) == len(hint) and all(
            map(operator.lt, hint, islice(hint, 1, None))
        ):
            return hint
        return sorted(actor_set)

    def _fold_orset_decoded(self, state: ORSet, decoded, actors_sorted) -> bool:
        kind, member_idx, actor_idx, counter, member_objs = decoded
        if len(kind) == 0:
            return True
        # members in the decoder's intern order (the state's are appended
        # by the vocabulary scan); replicas in the decoder's sorted order
        members = Vocab(member_objs)
        # Vocab interning hashes member *objects*; distinct canonical bytes
        # can still collide as Python values (1 == True, 0.0 == -0.0).  A
        # collapsed vocab would scatter rows onto the wrong member — decline
        if len(members) != len(member_objs):
            return False
        replicas = Vocab(actors_sorted)
        self._fold_orset_columns(state, kind, member_idx, actor_idx, counter,
                                 members, replicas)
        return True

    # ------------------------------------------------------------ causal map
    @staticmethod
    def _map_actor_table(state: CrdtMap, actors_hint=()) -> list:
        """Sorted, unique actor table for the native map decoder: the
        caller's hint plus every actor the state mentions."""
        actor_set = set(actors_hint)
        actor_set.update(state.clock.counters)
        for birth in state.births.values():
            actor_set.update(birth)
        for ctx, _rm_keys in state.deferred.values():
            actor_set.update(ctx.counters)
        for child in state.vals.values():
            actor_set.update(child.clock.counters)
            for entry in child.entries.values():
                actor_set.update(entry)
            for dfr in child.deferred.values():
                actor_set.update(dfr)
        return sorted(actor_set)

    def _map_fold_route(self, n_rows: int) -> dict:
        """The scatter phase's route for a batch of ``n_rows`` decoded
        rows, as ``crdtmap_fold_host`` keywords: under an active mesh the
        sharded phase on the mesh, else this accelerator's device from
        ``min_device_batch`` rows, else the numpy phase (no device)."""
        if self._mesh_active():
            return {"device": self.device, "mesh": self.mesh}
        return {"device": self.device if n_rows >= self.min_device_batch
                else None}

    def _fold_map_payloads(self, state: CrdtMap, payloads: list,
                           actors_hint=()) -> bool:
        """CrdtMap<orset> bulk path: native four-family decode → the
        vectorized columnar fold (ops/map_columnar.py), its scatter phase
        on the device from ``min_device_batch`` rows.  Declines (per-op
        fallback) for other child types, payloads the decoder declines,
        and key or member vocabularies that collapse as Python values."""
        if state.child != b"orset":
            return False
        from ..ops.map_columnar import crdtmap_fold_host, decode_map_payload_batch

        actors_sorted = self._map_actor_table(state, actors_hint)
        with trace.span("fold.map_decode"):
            decoded = decode_map_payload_batch(payloads, actors_sorted)
        if decoded is None:
            return False
        B, A, Rm, Kk, key_objs, member_objs = decoded
        keys = Vocab(key_objs)
        members = Vocab(member_objs)
        # vocab value-collision guard (1 == True etc.), as in the ORSet path
        if len(keys) != len(key_objs) or len(members) != len(member_objs):
            return False
        n_rows = sum(len(f["actor"]) for f in (B, A, Rm, Kk))
        with trace.span("fold.map"):
            crdtmap_fold_host(state, B, A, Rm, Kk, keys, members,
                              Vocab(actors_sorted),
                              **self._map_fold_route(n_rows))
        return True

    # -------------------------------------------- catalogue bulk front ends
    @staticmethod
    def _unpack_all(payloads: list) -> list:
        """Every op of every payload, unpacked before anything mutates."""
        return [op for p in payloads for op in codec.unpack(p)]

    def _fold_gset_payloads(self, state: GSet, payloads: list) -> bool:
        """G-Set bulk: one unpack per file, one set update.  No device
        path: the fold is deduplication of opaque values, which hashing
        them into the host set is."""
        frozen = state._freeze
        state.members.update(frozen(op) for op in self._unpack_all(payloads))
        return True

    def _fold_lwwreg_payloads(self, state: LWWReg, payloads: list) -> bool:
        """LWW-Register bulk: the LWW-map cascade at one key — one
        ``lww_fold`` launch over every write on the device, its winner
        resolved against the slot with the host tie-break (the columns
        are rank-interned, so integer compare ≡ bytes compare)."""
        rows = self._unpack_all(payloads)
        if not rows:
            return True
        if any(not 0 <= int(o[0]) < 1 << 2 * TS_SPLIT_BITS for o in rows):
            return False  # the timestamp does not split into two int32s
        if len(rows) < self.min_device_batch:
            for o in rows:
                state.apply(o)
            return True
        ops = [LWWOp(None, int(o[0]), bytes(o[1]), o[2], False) for o in rows]
        with trace.span("fold.columns"):
            cols = lww_ops_to_columns(ops)
        V = len(cols.values_sorted)
        num_values = V if len(cols.actors_sorted) * V < 2**31 else None
        with trace.span("fold.device"):
            dev = self._upload(
                (cols.key, cols.ts_hi, cols.ts_lo, cols.actor, cols.value))
            m_hi, m_lo, m_actor, m_value, present = (
                int(x[0]) for x in lww_fold(*dev, num_keys=1,
                                            num_values=num_values))
        if present:
            state._take((m_hi << TS_SPLIT_BITS) | m_lo,
                        cols.actors_sorted[m_actor],
                        cols.values_sorted[m_value])
        return True

    def _fold_mvreg_payloads(self, state: MVReg, payloads: list) -> bool:
        """MVReg bulk fold: ops are (clock, value) candidates; iterated
        strict-dominance apply equals the global anti-chain (dominance is
        transitive), so one dominance filter replaces the per-op loop —
        the argument ``_merge_mvregs`` makes."""
        new = [(VClock.from_obj(obj[0]), obj[1])
               for obj in self._unpack_all(payloads)]
        if not new:
            return True
        if len(new) + len(state.vals) < self.min_device_batch:
            for c, v in new:
                state.apply(MVRegOp(c, v))
            return True
        self._mvreg_antichain(state, list(state.vals) + new)
        return True

    def _fold_seqlist_payloads(self, state: SeqList, payloads: list) -> bool:
        """SeqList bulk: whole-file unpack, host apply.  No device path:
        the state is an order-keyed tree of variable-length Logoot paths
        with no dense tensor shape."""
        for op in [seqlist_op_from_obj(o) for o in self._unpack_all(payloads)]:
            state.apply(op)
        return True

    def _fold_merklereg_payloads(self, state: MerkleReg, payloads: list) -> bool:
        """MerkleReg bulk: whole-file unpack + apply.  No device path: the
        fold is hash-DAG bookkeeping (parent links, head set)."""
        for node in [MerkleNode.from_obj(o) for o in self._unpack_all(payloads)]:
            state.apply(node)
        return True

    # ------------------------------------------------------- fold sessions
    def can_open_fold_session(self, state) -> bool:
        """Cheap predicate twin of :meth:`open_fold_session`: the core
        checks it before it starts any pipeline machinery."""
        from .session import session_supported

        if isinstance(state, ORSet) and not orset_fits_int32(state):
            return False  # the session's int32 planes cannot hold it
        return session_supported(state)

    def open_fold_session(self, state, actors_hint=()):
        """A chunked fold session for the core's pipelined ingest
        (parallel/session.py), or None for state types without one — the
        core then takes its whole-batch flow."""
        from .session import open_fold_session

        if not self.can_open_fold_session(state):
            return None
        return open_fold_session(self, state, actors_hint)

    def fold_encrypted_stream(self, state, key: bytes, blobs: list, *,
                              actors_hint=(), chunk_blobs: int = 0,
                              n_chunks: int | None = None, depth: int = 0,
                              n_threads: int = 0,
                              n_producers: int = 0) -> bool:
        """Encrypted op-file blobs in, folded ``state`` out, with decrypt,
        decode and fold overlapped (the JAX accelerator's config-5 entry).

        The blobs split into chunks of ``chunk_blobs`` blobs (0: into
        ``n_chunks`` chunks; None: ``ENCRYPTED_STREAM_CHUNKS``, 8 as in
        the JAX package).  ``n_producers`` worker threads (0: the
        accelerator's ``stream_producers``, itself 0 = ops/stream.py
        ``stream_producer_count``) claim file-granular stripes of each
        chunk off one work queue (``run_striped_ingest_pipeline``, at
        most ``depth`` chunks live, 0 = producers + 1) and decrypt them
        natively with ``n_threads`` threads a call (0: the native pool's
        own width for one producer, one thread each for several); the
        worker landing a chunk's last stripe decodes it, and this thread
        reduces the chunks in order through a fold session (BUFFER,
        HOST_REDUCE or DEVICE_STREAM by regime), so the bytes do not
        depend on the producer count, the thread count or the stripe
        split.

        Returns False — with ``state`` untouched, since sessions mutate
        only at finish — when no session exists for this state type or
        the native decoder declines; the caller replays its own copy of
        the blobs down another path.  Crypto failures (``AeadError``) and
        pipeline faults raise."""
        from ..backends.xchacha import decrypt_blobs_packed
        from ..ops.stream import (
            PipelineError,
            run_striped_ingest_pipeline,
            stream_producer_count,
        )
        from .session import SessionDeclined

        session = self.open_fold_session(state, actors_hint=actors_hint)
        if session is None:
            return False
        n = len(blobs)
        if n == 0:
            return True
        if chunk_blobs <= 0:
            if n_chunks is None:
                n_chunks = ENCRYPTED_STREAM_CHUNKS
            chunk_blobs = -(-n // max(n_chunks, 1))
        spans = [blobs[i : i + chunk_blobs] for i in range(0, n, chunk_blobs)]
        producers = n_producers if n_producers > 0 else self.stream_producers
        if producers <= 0:
            producers = stream_producer_count()
        # several producers: each stripe decrypts single-threaded and the
        # pool is the parallelism; one producer keeps the native call's
        # own threads (0 = from the core count)
        stripe_threads = n_threads if n_threads else (
            0 if producers == 1 else 1
        )

        def split(span, k):
            """Byte-bounded stripes, so one giant op file forms its own
            stripe while the other workers decrypt the rest."""
            if producers == 1 or len(span) <= 1:
                return [span] if span else []
            budget = max(1, sum(len(b) for b in span) // producers)
            stripes, cur, cur_bytes = [], [], 0
            for b in span:
                cur.append(b)
                cur_bytes += len(b)
                if cur_bytes >= budget:
                    stripes.append(cur)
                    cur, cur_bytes = [], 0
            if cur:
                stripes.append(cur)
            return stripes

        def stripe(files, k, s):
            with trace.span("stream.decrypt", meta=k):
                packed = decrypt_blobs_packed(key, files, stripe_threads)
                # counted only once the stripe's decrypt succeeded
                trace.add("bytes_decrypted", sum(len(b) for b in files))
                return packed

        def assemble(parts, span, k):
            with trace.span("stream.decode", meta=k):
                if session.accepts_packed:
                    # decode never mutates the session: thread-safe
                    return session.decode_chunk_parts(parts)
                # sessions without span decoders (counters) take per-blob
                # views of the shared cleartext buffers
                payloads: list = []
                for out, offs in parts:
                    view = memoryview(out)
                    lo_hi = offs.tolist()
                    payloads.extend(view[lo_hi[i] : lo_hi[i + 1]]
                                    for i in range(len(lo_hi) - 1))
                return session.decode_chunk(payloads)

        def reduce(decoded, k):
            session.reduce_chunk(decoded)

        try:
            run_striped_ingest_pipeline(
                spans, split, stripe, assemble, reduce,
                depth=depth, producers=producers,
            )
            with trace.span("stream.finish"):
                session.finish()
        except SessionDeclined:
            return False
        except PipelineError as e:
            if isinstance(e.__cause__, SessionDeclined):
                return False
            raise e.__cause__ from None
        return True

    def fold_payload_stream(self, state, chunks, actors_hint=()) -> bool:
        """OR-Set bulk front end over an *iterator* of decrypted-payload
        chunks (e.g. ``xchacha.decrypt_blobs_chunked``): each chunk
        decodes while the producer decrypts the next, then all rows fold
        once.  On False the stream is closed (a generator's pending
        lookahead is cancelled at its next yield), ``state`` is untouched
        and the caller replays its own copy of the payloads down the
        per-op path."""
        stream = self.open_payload_stream(state, actors_hint=actors_hint)
        if stream is None:
            return False
        try:
            for chunk in chunks:
                if not stream.feed(chunk):
                    return False
        finally:
            close = getattr(chunks, "close", None)
            if close is not None:
                close()
        return stream.finish()

    def open_payload_stream(self, state, actors_hint=()):
        """Incremental bulk front end: a stream with ``feed(payloads) ->
        bool`` (decodes one chunk — a payload list or a packed ``(buffer,
        offsets)`` pair; False = declined, nothing folded) and ``finish()
        -> bool`` (one combined fold into ``state``), or None where
        ``state`` has no columnar bulk path (not an OR-Set, or counters
        past int32).  ``feed`` only decodes, so callers overlap it with
        their own decrypt of the next chunk; ``state`` mutates only
        inside ``finish``.  Caller-serialized, like the fold sessions."""
        if not isinstance(state, ORSet) or not orset_fits_int32(state):
            return None
        return _OrsetPayloadStream(self, state, actors_hint)

    def _fold_counter_payloads(self, state, payloads: list, actors_hint=()) -> bool:
        """Counter bulk path: native decode straight to (sign, actor,
        counter) columns, one fold.  Dots are monotone per actor, so
        max-folding whole files at once equals per-op apply."""
        pn = isinstance(state, PNCounter)
        clocks = (state.p.clock, state.n.clock) if pn else (state.clock,)
        actor_set = set(actors_hint)
        for c in clocks:
            actor_set.update(c.counters)
        actors_sorted = sorted(actor_set)
        with trace.span("fold.decode"):
            decoded = decode_counter_payload_batch(payloads, actors_sorted)
        if decoded is None:
            return False
        sign, actor_idx, counter = decoded
        if len(sign) == 0:
            return True
        if not pn and np.any(sign != POS):
            return False  # PN-shaped rows in a G-Counter state
        self._fold_counter_columns(
            state, CounterColumns(sign, actor_idx, counter, Vocab(actors_sorted))
        )
        return True

    # ------------------------------------------------------------- counters
    def _fold_counter(self, state, ops: list):
        """The G- and PN-Counter fold of op objects: their columns, then
        :meth:`_fold_counter_columns`."""
        with trace.span("fold.columns"):
            cols = counter_ops_to_columns(ops)
        return self._fold_counter_columns(state, cols)

    def _fold_counter_columns(self, state, cols):
        """The replica vocabulary (state actors included), the fold on the
        device, the dense clocks written back to the sparse state.  The
        planes are int64 on the device, so any counter the host loop takes
        folds exactly (the JAX route narrows a prior clock to int32
        there)."""
        replicas = cols.replicas
        pn = isinstance(state, PNCounter)
        clocks = (state.p.clock, state.n.clock) if pn else (state.clock,)
        for c in clocks:
            for a in c.counters:
                replicas.intern(a)
        R = len(replicas)
        if R == 0:
            return state
        with trace.span("fold.planes"):
            dense = [vclock_to_dense(c, replicas).astype(np.int64) for c in clocks]
        sign, actor, counter = cols.sign, cols.actor, cols.counter.astype(np.int64)
        sharded = self._mesh_active()
        if sharded:
            from . import mesh as pmesh

            # rows over dp: pad with actor == R sentinels
            padn = -(-len(sign) // self._dp()) * self._dp() - len(sign)
            sign = np.concatenate([sign, np.zeros(padn, np.int8)])
            actor = np.concatenate([actor, np.full(padn, R, actor.dtype)])
            counter = np.concatenate([counter, np.zeros(padn, np.int64)])
            sign, actor, counter = pmesh.process_rows(self.mesh, sign, actor,
                                                      counter)
        with trace.span("fold.device"):
            if pn:
                p0, n0, sign, actor, counter = self._upload(
                    (*dense, sign, actor, counter))
                if sharded:
                    p, n, _ = pmesh.pncounter_fold_sharded(
                        self.mesh, p0, n0, sign, actor, counter)
                else:
                    p, n, _ = pncounter_fold(p0, n0, sign, actor, counter,
                                             num_replicas=R)
                out = [p.cpu().numpy(), n.cpu().numpy()]
            else:
                clock0, actor, counter = self._upload((*dense, actor, counter))
                if sharded:
                    clock, _ = pmesh.gcounter_fold_sharded(
                        self.mesh, clock0, actor, counter)
                else:
                    clock, _ = gcounter_fold(clock0, actor, counter,
                                             num_replicas=R)
                out = [clock.cpu().numpy()]
        with trace.span("fold.writeback"):
            if pn:
                state.p.clock = dense_to_vclock(out[0], replicas)
                state.n.clock = dense_to_vclock(out[1], replicas)
            else:
                state.clock = dense_to_vclock(out[0], replicas)
        return state

    # ------------------------------------------------------------------ LWW
    def _fold_lww(self, state: LWWMap, ops: list) -> LWWMap:
        with trace.span("fold.columns"):
            cols = lww_ops_to_columns(ops)
        Kn = len(cols.keys)
        if Kn == 0:
            return state
        # the packed (actor, value) rank of the plain cascade, when it
        # fits int32; the kernel orders the pair without it either way
        V = len(cols.values_sorted)
        num_values = V if len(cols.actors_sorted) * V < 2**31 else None
        rows = (cols.key, cols.ts_hi, cols.ts_lo, cols.actor, cols.value)
        if self._mesh_active():
            from . import mesh as pmesh

            # rows over dp: pad with key == K sentinels
            padn = -(-len(cols.key) // self._dp()) * self._dp() - len(cols.key)
            rows = tuple(np.concatenate([x, np.full(padn, fill, np.int32)])
                         for x, fill in zip(rows, (Kn, 0, 0, 0, 0)))
            rows = pmesh.process_rows(self.mesh, *rows)
        with trace.span("fold.device"):
            dev = self._upload(rows)
            if self._mesh_active():
                out = pmesh.lww_fold_sharded(self.mesh, *dev, num_keys=Kn,
                                             num_values=num_values)
            else:
                out = lww_fold(*dev, num_keys=Kn, num_values=num_values)
            m_hi, m_lo, m_actor, m_value, present = (x.cpu().numpy() for x in out)
        with trace.span("fold.writeback"):
            self._lww_writeback(state, cols, m_hi, m_lo, m_actor, m_value,
                                present)
        state._mut += 1
        return state

    @staticmethod
    def _lww_writeback(state: LWWMap, cols, m_hi, m_lo, m_actor, m_value,
                       present) -> None:
        """Winner table → state entries.  A key's winner is a tombstone
        when any of its rows that equal the winner is one (the host's
        "delete wins a full tie").  The entries materialize in bulk; the
        host tie-break runs only where a key already holds an entry."""
        ki = cols.key
        win = (
            (cols.ts_hi == m_hi[ki])
            & (cols.ts_lo == m_lo[ki])
            & (cols.actor == m_actor[ki])
            & (cols.value == m_value[ki])
        )
        tomb_by_key = np.zeros(len(cols.keys), bool)
        np.maximum.at(tomb_by_key, ki[win], cols.tombstone[win])

        idx = np.flatnonzero(present)
        ts64 = (m_hi[idx].astype(np.int64) << 31) | m_lo[idx]
        items = cols.keys.items
        actors, values = cols.actors_sorted, cols.values_sorted
        new_entries = {
            items[k]: [t, actors[a], None if tomb else values[v], tomb]
            for k, t, a, v, tomb in zip(
                idx.tolist(),
                ts64.tolist(),
                m_actor[idx].tolist(),
                m_value[idx].tolist(),
                tomb_by_key[idx].tolist(),
            )
        }
        entries = state.entries
        if not entries:
            state.entries = new_entries
            return
        for key_obj, new in new_entries.items():
            cur = entries.get(key_obj)
            if cur is None or _wins(*new, *cur):
                entries[key_obj] = new

    # --------------------------------------------------------- merge_states
    def merge_states(self, state, others: list):
        if not others:
            return state
        if isinstance(state, ORSet) and all(
                map(orset_fits_int32, (state, *others))):
            # (a counter past int32, which the planes cannot hold, takes
            # the host merge)
            if self._mesh_active():
                return self._merge_orsets_sharded(state, others)
            if len(others) + 1 >= 3:
                return self._merge_orsets(state, others)
        if isinstance(state, MVReg):
            total = len(state.vals) + sum(len(o.vals) for o in others)
            if total >= self.min_device_batch:
                return self._merge_mvregs(state, others)
        return super().merge_states(state, others)

    def _merge_mvregs(self, state: MVReg, others: list) -> MVReg:
        """Batched MVReg snapshot merge: the global anti-chain of every
        candidate (clock, value) pair through one dominance filter,
        instead of S sequential pairwise merges.  Equivalent because each
        input register is already an anti-chain and domination is
        transitive, so iterated pairwise merging and the global filter
        both keep exactly the pairs no other pair strictly dominates;
        identical duplicates never dominate each other (strict filter) and
        collapse in canonicalization."""
        pairs = list(state.vals)
        for o in others:
            pairs.extend(o.vals)
        return self._mvreg_antichain(state, pairs)

    def _mvreg_antichain(self, state: MVReg, pairs: list) -> MVReg:
        """Write the global strict-dominance anti-chain of ``pairs`` into
        ``state`` through one ``mvreg_dominance_keep`` call on the device.
        The dense clocks are int64, so every counter the host loop takes
        compares exactly (the JAX route stores them in int32)."""
        replicas = Vocab()
        rows, cols, vals = [], [], []
        for i, (c, _) in enumerate(pairs):
            for a, n in c.counters.items():
                rows.append(i)
                cols.append(replicas.intern(a))
                vals.append(n)
        R, V = len(replicas), len(pairs)
        if R == 0 or V <= 1:  # empty clocks: dedup is all there is
            state.vals = pairs
            state._canonicalize()
            return state
        with trace.span("merge.planes"):
            clocks = np.zeros((V, R), np.int64)
            clocks[rows, cols] = vals
        with trace.span("merge.device"):
            if self._mesh_active():
                from . import mesh as pmesh

                # candidates over dp: pad V with invalid rows
                Vp = -(-V // self._dp()) * self._dp()
                clocks = np.concatenate(
                    [clocks, np.zeros((Vp - V, R), np.int64)])
                valid = np.arange(Vp) < V
                dev = self._upload(pmesh.process_rows(self.mesh, clocks,
                                                      valid))
                keep = pmesh.mvreg_keep_sharded(self.mesh, *dev)
                keep = pmesh.gather_rows(self.mesh, keep).cpu().numpy()[:V]
            else:
                (dev,) = self._upload((clocks,))
                keep = mvreg_dominance_keep(dev).cpu().numpy()
        state.vals = [pairs[i] for i in np.flatnonzero(keep)]
        state._canonicalize()
        return state

    def _merge_orsets_sharded(self, state: ORSet, others: list) -> ORSet:
        """Pairwise merges with the planes over mp (``mesh.
        orset_merge_sharded``): elementwise, no collective.  An empty
        vocabulary merges on the host, clocks included, as the host loop
        does (the JAX route does the same here; its one-device merge
        returns the state unmerged, ROADMAP queue 3)."""
        from . import mesh as pmesh

        mp = self.mesh.shape["mp"]
        members, replicas = Vocab(), Vocab()
        for s in [state, *others]:
            orset_scan_vocab(s, members, replicas)
        E, R = len(members), len(replicas)
        if E == 0 or R == 0:
            return super().merge_states(state, others)
        E_pad = -(-E // mp) * mp

        def planes(s):
            clock, add, rm = orset_state_to_planes(s, members, replicas,
                                                   scanned=True)
            if E_pad != E:
                z = np.zeros((E_pad - E, R), np.int32)
                add = np.concatenate([add, z])
                rm = np.concatenate([rm, z])
            return self._upload((clock, add, rm))

        with trace.span("merge.device"):
            acc = planes(state)
            for other in others:
                acc = pmesh.orset_merge_sharded(self.mesh, *acc,
                                                *planes(other))
            clock, add, rm = (x.cpu().numpy() for x in acc)
        with trace.span("merge.writeback"):
            merged = orset_planes_to_state(clock, add[:E], rm[:E], members,
                                           replicas)
        state.clock = merged.clock
        state.entries = merged.entries
        state.deferred = merged.deferred
        self._note_orset_writeback(state)
        return state

    def _merge_orsets(self, state: ORSet, others: list) -> ORSet:
        """Stack every state's planes over one shared vocabulary and merge
        them in one device call.

        The host uploads the states' cells (8 bytes each; a state holds at
        most one cell a member and actor, so never more than the dense
        stacks' ``S * 2 * E * R * 4`` bytes) and the device builds the
        stacks from them (``orset_stack_cells``)."""
        members, replicas = Vocab(), Vocab()
        all_states = [state] + list(others)
        with trace.span("merge.vocab"):
            for s in all_states:
                orset_scan_vocab(s, members, replicas)  # vocab-only pass
        E, R = len(members), len(replicas)
        if E == 0 or R == 0 or E * R >= 2**31:
            # nothing to densify, or planes past the cells' int32 key:
            # the host merge
            return super().merge_states(state, others)
        S = len(all_states)
        with trace.span("merge.planes"):
            clocks, cells, offsets = orset_states_to_cells(
                all_states, members, replicas)
            trace.add("merge_coo_cells", len(cells))
        with trace.span("merge.device"):
            clocks, cells, offsets = self._upload((clocks, cells, offsets))
            adds, rms = orset_stack_cells(cells, offsets, S, E, R)
            del cells, offsets
            clock, add, rm = (x.cpu().numpy()
                              for x in orset_merge_many(clocks, adds, rms))
            del clocks, adds, rms
        with trace.span("merge.writeback"):
            merged = orset_planes_to_state(clock, add, rm, members, replicas)
        state.clock = merged.clock
        state.entries = merged.entries
        state.deferred = merged.deferred
        self._note_orset_writeback(state)
        return state


class _OrsetPayloadStream:
    """Incremental OR-Set bulk front end (``TorchAccelerator.
    open_payload_stream``): a native span decode per chunk, one combined
    intern and fold at ``finish`` through the accelerator's OR-Set fold
    (K2 on the dense route, the native host fold in the sparse regime).
    The core's bulk ingest feeds chunks as its decrypt lookahead lands
    (``Core._read_remote_ops_bulk``); the state is untouched until
    ``finish`` returns True, so a declined or abandoned stream leaves the
    replica exactly as it was."""

    def __init__(self, accel: TorchAccelerator, state: ORSet, actors_hint=()):
        self.accel = accel
        self.state = state
        self.actors_sorted = accel._orset_actor_table(
            state, actors_hint, accel._plane_cache_for(state))
        self.parts: list = []
        self.declined = False
        self._finished = False
        # the actor table's native hash index, built once per stream (the
        # table is fixed for the stream's life) and reused across feeds
        self._decode_cache: dict = {}

    def feed(self, payloads) -> bool:
        """Decode one chunk of decrypted payloads.  False = the native
        decoder declined (unknown actor, non-canonical encoding, a counter
        past int32); the stream is dead and the caller replays through
        the per-op path."""
        if self._finished:
            raise RuntimeError("payload stream already finished")
        if self.declined:
            return False
        n = len(payloads[1]) - 1 if isinstance(payloads, tuple) else len(
            payloads)
        if n <= 0:
            return True
        with trace.span("fold.decode"):
            part = decode_orset_payload_spans(
                payloads, self.actors_sorted, cache=self._decode_cache
            )
        if part is None:
            self.declined = True
            return False
        self.parts.append(part)
        return True

    def finish(self) -> bool:
        """Combine every fed chunk and fold into the state (the only
        mutation).  False = a member vocabulary that collapses as Python
        values; the state is untouched."""
        if self._finished:
            raise RuntimeError("payload stream already finished")
        if self.declined:
            raise RuntimeError("payload stream was declined")
        self._finished = True
        if not self.parts:
            return True
        with trace.span("fold.decode"):
            decoded = combine_orset_spans(self.parts)
        self.parts = []
        return self.accel._fold_orset_decoded(
            self.state, decoded, self.actors_sorted
        )
