"""Columnar encodings bridging host OR-Sets and the device kernels.

The OR-Set part of ``crdt_enc_tpu/ops/columnar.py``.  The kernels consume
dense tensors; OR-Set states and op logs are sparse, dict-shaped host
objects.  This module owns the conversion:

* **interning**: replica UUIDs and set members become dense indices via a
  ``Vocab`` (order of first appearance; canonical output never depends on
  intern order because serialization re-sorts),
* **op columns**: a batch of OR-Set ops flattens to parallel int arrays —
  one row per add-dot or per (remove × context-actor),
* **state planes**: an ORSet becomes ``(clock[R], add[E,R], rm[E,R])``
  int32 matrices and back, losslessly.

The writeback fills the state dicts in Python: the JAX package's own
byte-identical fallback for its native ``grouped_rows_dicts`` pass, which
this slice does not copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.orset import AddOp, ORSet, RmOp, op_from_obj
from ..models.vclock import VClock
from ..utils import codec

KIND_ADD = 0
KIND_RM = 1


def pad_orset_rows(cols: "OrsetColumns", target: int, num_replicas: int):
    """Pad flattened op columns to ``target`` rows with sentinel no-ops
    (``actor == num_replicas`` marks padding — the single invariant every
    fold kernel keys on)."""
    n = len(cols.kind)
    padn = target - n
    if padn > 0:
        cols.kind = np.concatenate([cols.kind, np.zeros(padn, np.int8)])
        cols.member = np.concatenate([cols.member, np.zeros(padn, np.int32)])
        cols.actor = np.concatenate(
            [cols.actor, np.full(padn, num_replicas, np.int32)]
        )
        cols.counter = np.concatenate([cols.counter, np.zeros(padn, np.int32)])
    return cols


class Vocab:
    """Interning table: object → dense index (first-appearance order)."""

    __slots__ = ("items", "index")

    def __init__(self, items=()):
        self.items: list = []
        self.index: dict = {}
        for it in items:
            self.intern(it)

    def intern(self, item) -> int:
        idx = self.index.get(item)
        if idx is None:
            idx = len(self.items)
            self.index[item] = idx
            self.items.append(item)
        return idx

    def __len__(self) -> int:
        return len(self.items)


@dataclass
class OrsetColumns:
    """Flattened ORSet op batch (one row per dot / per rm-context entry)."""

    kind: np.ndarray  # int8  — KIND_ADD | KIND_RM
    member: np.ndarray  # int32 — index into members vocab
    actor: np.ndarray  # int32 — index into replicas vocab
    counter: np.ndarray  # int32 — dot counter / remove horizon
    members: Vocab = field(default_factory=Vocab)
    replicas: Vocab = field(default_factory=Vocab)


def orset_ops_to_columns(
    ops, members: Vocab | None = None, replicas: Vocab | None = None
) -> OrsetColumns:
    members = members if members is not None else Vocab()
    replicas = replicas if replicas is not None else Vocab()
    kind, member, actor, counter = [], [], [], []
    for op in ops:
        if isinstance(op, (list, tuple)):
            op = op_from_obj(op)
        if isinstance(op, AddOp):
            kind.append(KIND_ADD)
            member.append(members.intern(op.member))
            actor.append(replicas.intern(op.dot.actor))
            counter.append(op.dot.counter)
        elif isinstance(op, RmOp):
            m = members.intern(op.member)
            # sorted-actor order matches the canonical packed form
            for r, c in sorted(op.ctx.counters.items()):
                kind.append(KIND_RM)
                member.append(m)
                actor.append(replicas.intern(r))
                counter.append(c)
        else:
            raise TypeError(f"bad ORSet op {op!r}")
    return OrsetColumns(
        np.asarray(kind, np.int8),
        np.asarray(member, np.int32),
        np.asarray(actor, np.int32),
        np.asarray(counter, np.int32),
        members,
        replicas,
    )


def orset_scan_vocab(state: ORSet, members: Vocab, replicas: Vocab) -> None:
    """Grow the vocabularies with everything the state mentions, without
    building planes — the cheap first pass when densifying many states to
    a shared vocabulary.  New actors append in sorted order
    (deterministic), collected through one ``set.update`` per entry dict."""
    if not state.entries and not state.deferred and not state.clock.counters:
        return
    actor_set: set = set()
    for m, entry in state.entries.items():
        members.intern(m)
        actor_set.update(entry)
    for m, dfr in state.deferred.items():
        members.intern(m)
        actor_set.update(dfr)
    actor_set.update(state.clock.counters)
    index = replicas.index
    new = [r for r in actor_set if r not in index]
    try:
        new.sort()
    except TypeError:  # mixed-type actor ids: sort by canonical bytes
        new.sort(key=codec.pack)
    for r in new:
        replicas.intern(r)


def orset_state_to_planes(
    state: ORSet, members: Vocab, replicas: Vocab, *, scanned: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``(clock[R], add[E,R], rm[E,R])`` planes (int32).

    The vocabs are extended in place with anything the state mentions;
    pass ``scanned=True`` when ``orset_scan_vocab`` already ran for this
    state (skips a redundant sparse pass).
    """
    if not scanned:
        orset_scan_vocab(state, members, replicas)
    E, R = len(members), len(replicas)
    clock = np.zeros(R, np.int32)
    add = np.zeros((E, R), np.int32)
    rm = np.zeros((E, R), np.int32)
    for r, c in state.clock.counters.items():
        clock[replicas.index[r]] = c
    for m, entry in state.entries.items():
        e = members.index[m]
        for r, c in entry.items():
            add[e, replicas.index[r]] = c
    for m, dfr in state.deferred.items():
        e = members.index[m]
        for r, c in dfr.items():
            rm[e, replicas.index[r]] = c
    return clock, add, rm


def _fill_dicts_from_plane(plane: np.ndarray, members: Vocab,
                           replicas: Vocab, target: dict) -> None:
    """Nonzero plane cells → nested ``{member: {actor: counter}}`` dicts.
    ``np.nonzero`` yields cells in row-major order, i.e. grouped by
    member."""
    es, rs = np.nonzero(plane)
    if not len(es):
        return
    mitems, ritems = members.items, replicas.items
    vals = plane[es, rs].tolist()
    for e, r, c in zip(es.tolist(), rs.tolist(), vals):
        target.setdefault(mitems[e], {})[ritems[r]] = c


def orset_planes_to_state(
    clock: np.ndarray, add: np.ndarray, rm: np.ndarray, members: Vocab, replicas: Vocab
) -> ORSet:
    """Inverse of ``orset_state_to_planes`` (planes must be normalized:
    entries killed where add ≤ rm, rm zeroed where rm ≤ clock)."""
    clock = np.asarray(clock)
    add = np.asarray(add)
    rm = np.asarray(rm)
    state = ORSet()
    state.clock = VClock(
        {replicas.items[r]: int(clock[r]) for r in np.nonzero(clock)[0]}
    )
    _fill_dicts_from_plane(add, members, replicas, state.entries)
    _fill_dicts_from_plane(rm, members, replicas, state.deferred)
    return state
