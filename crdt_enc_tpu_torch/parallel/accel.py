"""Torch accelerator: the drop-in replacement for the core's host fold and
merge.

The port's counterpart of ``TpuAccelerator`` (crdt_enc_tpu/parallel/
accel.py).  It plugs in where the core takes an accelerator (the duck-typed
``fold_ops`` / ``merge_states`` interface of ``HostAccelerator``).  Each
call converts sparse host state ↔ dense tensors around the device fold or
merge; the conversion cost is amortized over whole op batches, which is
exactly the compaction shape.  ``fold_ops`` sends ORSet, PNCounter,
GCounter and LWWMap batches to the device, as the JAX accelerator does;
small batches and every other type take the host loop.  ``merge_states``
merges three or more ORSets on the device.

Eager PyTorch compiles nothing per shape, so the JAX package's bucket
padding of rows and vocabularies (a bound on XLA recompiles) has no
counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.adapters import HostAccelerator
from ..models.counters import GCounter, PNCounter
from ..models.lwwmap import LWWMap, _wins
from ..models.orset import ORSet
from ..ops.columnar import (
    Vocab,
    counter_ops_to_columns,
    dense_to_vclock,
    lww_ops_to_columns,
    orset_ops_to_columns,
    orset_planes_to_state,
    orset_scan_vocab,
    orset_state_to_planes,
    vclock_to_dense,
)
from ..ops.counters import gcounter_fold, pncounter_fold
from ..ops.lww import lww_fold
from ..ops.orset import orset_fold, orset_merge_many
from ..utils import trace

MIN_DEVICE_BATCH = 256  # below this the host loop wins


class TorchAccelerator(HostAccelerator):
    """Folds ORSet, PNCounter, GCounter and LWWMap op batches and merges
    three or more ORSet states on the device; anything else — other state
    types, batches below ``min_device_batch``, sparse OR-Set batches over
    huge vocabularies — takes the host loops.

    ``device``: ``None`` means ``"cuda"``, and then CUDA must be
    available: the accelerator raises rather than carry on silently on
    the CPU.  ``device="cpu"`` runs the same route through the plain
    PyTorch versions of the kernels, as the tests do."""

    # Above this many plane cells per batch row the dense planes' init and
    # sweep dominate the fold; below SPARSE_MIN_CELLS they are cheap.
    SPARSE_CELLS_PER_ROW = 64
    SPARSE_MIN_CELLS = 1 << 22
    # Dense batches beyond this many rows fold blockwise in the JAX
    # package (ops/stream.py); that route is not ported yet.
    STREAM_CHUNK_ROWS = 1 << 22

    def __init__(self, device=None, min_device_batch: int = MIN_DEVICE_BATCH):
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

    def _upload(self, arrays) -> list:
        """numpy arrays → tensors on ``self.device``; counts the bytes
        that cross to a CUDA device in ``h2d_bytes``."""
        if self.device.type == "cuda":
            trace.add("h2d_bytes", sum(a.nbytes for a in arrays))
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
        with trace.span("fold.columns"):
            cols = orset_ops_to_columns(ops, members, replicas)
        with trace.span("fold.vocab"):
            orset_scan_vocab(state, members, replicas)
        E, R = len(members), len(replicas)
        if E == 0 or R == 0:
            return state
        n_rows = len(cols.kind)
        if self._use_sparse(E, R, n_rows):
            # N ≪ E·R: dense planes would be mostly zeros to ship.  The
            # JAX package runs this regime on the host too (its
            # vectorized orset_fold_sparse_host, not yet copied here).
            return super().fold_ops(state, ops)
        if n_rows > self.STREAM_CHUNK_ROWS:
            raise NotImplementedError(
                f"a batch of {n_rows} rows exceeds STREAM_CHUNK_ROWS="
                f"{self.STREAM_CHUNK_ROWS}; the blockwise stream fold comes "
                "in a later slice of the port"
            )
        return self._fold_orset_columns(state, cols, members, replicas)

    def _fold_orset_columns(self, state: ORSet, cols, members: Vocab,
                            replicas: Vocab) -> ORSet:
        """The dense route: state → planes, upload, fold, download,
        planes → state.  The vocabularies already hold every member and
        actor of the state and the batch."""
        E, R = len(members), len(replicas)
        with trace.span("fold.planes"):
            planes = orset_state_to_planes(state, members, replicas, scanned=True)
        with trace.span("fold.device"):
            dev = self._upload(
                (*planes, cols.kind, cols.member, cols.actor, cols.counter)
            )
            out = orset_fold(*dev, num_members=E, num_replicas=R)
            clock, add, rm = (x.cpu().numpy() for x in out)
        with trace.span("fold.writeback"):
            folded = orset_planes_to_state(clock, add, rm, members, replicas)
        state.clock = folded.clock
        state.entries = folded.entries
        state.deferred = folded.deferred
        state._mut += 1
        return state

    # ------------------------------------------------------------- counters
    def _fold_counter(self, state, ops: list):
        """The G- and PN-Counter fold: op columns, the replica vocabulary
        (state actors included), the fold on the device, the dense clocks
        written back to the sparse state.  The planes are int64 on the
        device, so any counter the host loop takes folds exactly (the JAX
        route narrows a prior clock to int32 there)."""
        with trace.span("fold.columns"):
            cols = counter_ops_to_columns(ops)
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
        rows = (cols.actor, cols.counter.astype(np.int64))
        with trace.span("fold.device"):
            if pn:
                p0, n0, sign, actor, counter = self._upload(
                    (*dense, cols.sign, *rows))
                p, n, _ = pncounter_fold(p0, n0, sign, actor, counter,
                                         num_replicas=R)
                out = [p.cpu().numpy(), n.cpu().numpy()]
            else:
                clock0, actor, counter = self._upload((*dense, *rows))
                clock, _ = gcounter_fold(clock0, actor, counter, num_replicas=R)
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
        with trace.span("fold.device"):
            dev = self._upload(
                (cols.key, cols.ts_hi, cols.ts_lo, cols.actor, cols.value))
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
        if isinstance(state, ORSet) and len(others) + 1 >= 3:
            return self._merge_orsets(state, others)
        return super().merge_states(state, others)

    def _merge_orsets(self, state: ORSet, others: list) -> ORSet:
        """Stack every state's planes over one shared vocabulary and merge
        them in one device call."""
        members, replicas = Vocab(), Vocab()
        all_states = [state] + list(others)
        for s in all_states:
            orset_scan_vocab(s, members, replicas)  # cheap vocab-only pass
        E, R = len(members), len(replicas)
        if E == 0 or R == 0:
            # nothing to densify; clocks alone still merge on the host
            return super().merge_states(state, others)
        with trace.span("merge.planes"):
            planes = [
                orset_state_to_planes(s, members, replicas, scanned=True)
                for s in all_states
            ]
            stacks = [np.stack([p[i] for p in planes]) for i in range(3)]
            del planes
        with trace.span("merge.device"):
            dev = self._upload(stacks)
            del stacks
            clock, add, rm = (x.cpu().numpy() for x in orset_merge_many(*dev))
        with trace.span("merge.writeback"):
            merged = orset_planes_to_state(clock, add, rm, members, replicas)
        state.clock = merged.clock
        state.entries = merged.entries
        state.deferred = merged.deferred
        state._mut += 1
        return state
