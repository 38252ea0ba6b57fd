"""Columnar encodings bridging host CRDT states and the device kernels.

The OR-Set, counter and LWW parts of ``crdt_enc_tpu/ops/columnar.py``.
The kernels consume dense tensors; states and op logs are sparse,
dict-shaped host objects.  This module owns the conversion:

* **interning**: replica UUIDs and set members become dense indices via a
  ``Vocab`` (order of first appearance; canonical output never depends on
  intern order because serialization re-sorts),
* **op columns**: a batch of OR-Set ops flattens to parallel int arrays —
  one row per add-dot or per (remove × context-actor),
* **state planes**: an ORSet becomes ``(clock[R], add[E,R], rm[E,R])``
  int32 matrices and back, losslessly; a counter's VClock a dense
  ``(R,)`` vector,
* **LWW columns**: actors and values are *rank*-interned (sorted by
  their bytes), so integer order on the device is the host's byte order.

The writeback fills the state dicts in Python: the JAX package's own
byte-identical fallback for its native ``grouped_rows_dicts`` pass, which
this slice does not copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.counters import NEG, POS
from ..models.lwwmap import LWWOp
from ..models.orset import AddOp, ORSet, RmOp, op_from_obj
from ..models.vclock import Dot, VClock
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


def orset_rows_to_ops(kind, member, actor, counter, members: Vocab,
                      replicas: Vocab) -> list:
    """Op objects for flat row columns, in row order: an add per add row,
    a single-actor remove per remove row; sentinel rows (``actor >=
    len(replicas)``) drop.  The host apply treats a remove's context actor
    by actor, so folding these equals folding the ops the rows came
    from."""
    R = len(replicas)
    mitems, ritems = members.items, replicas.items
    ops = []
    for k, m, a, c in zip(np.asarray(kind).tolist(), np.asarray(member).tolist(),
                          np.asarray(actor).tolist(), np.asarray(counter).tolist()):
        if a >= R:
            continue
        if k == KIND_ADD:
            ops.append(AddOp(mitems[m], Dot(ritems[a], c)))
        else:
            ops.append(RmOp(mitems[m], VClock({ritems[a]: c})))
    return ops


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


# ---- counters ------------------------------------------------------------

INT32_MAX = 2**31 - 1


@dataclass
class CounterColumns:
    sign: np.ndarray  # int8 — POS | NEG (always POS for G-Counter)
    actor: np.ndarray  # int32
    counter: np.ndarray  # int32, or int64 when a counter needs it
    replicas: Vocab = field(default_factory=Vocab)


def _counter_dtype(values) -> type:
    """int32, or int64 when any counter needs it: the host loop takes any
    counter, so the device route widens rather than truncates."""
    return np.int64 if any(c > INT32_MAX for c in values) else np.int32


def counter_ops_to_columns(ops, replicas: Vocab | None = None) -> CounterColumns:
    """Flatten G-Counter (Dot) or PN-Counter ((dir, Dot)) op batches."""
    replicas = replicas if replicas is not None else Vocab()
    sign, actor, counter = [], [], []
    for op in ops:
        if isinstance(op, Dot):
            direction, dot = POS, op
        else:
            direction, dot = op
            if not isinstance(dot, Dot):
                dot = Dot.from_obj(dot)
        if direction not in (POS, NEG):
            raise ValueError(f"bad counter op direction {direction!r}")
        sign.append(direction)
        actor.append(replicas.intern(dot.actor))
        counter.append(dot.counter)
    return CounterColumns(
        np.asarray(sign, np.int8),
        np.asarray(actor, np.int32),
        np.asarray(counter, _counter_dtype(counter)),
        replicas,
    )


def vclock_to_dense(clock: VClock, replicas: Vocab) -> np.ndarray:
    for r in clock.counters:
        replicas.intern(r)
    out = np.zeros(len(replicas), _counter_dtype(clock.counters.values()))
    for r, c in clock.counters.items():
        out[replicas.index[r]] = c
    return out


def dense_to_vclock(arr: np.ndarray, replicas: Vocab) -> VClock:
    arr = np.asarray(arr)
    nz = np.nonzero(arr)[0]
    robj = np.asarray(replicas.items, dtype=object)[nz].tolist()
    return VClock(dict(zip(robj, arr[nz].tolist())))


# ---- LWW -----------------------------------------------------------------


@dataclass
class LwwColumns:
    key: np.ndarray  # int32 — index into keys vocab
    ts_hi: np.ndarray  # int32 — timestamp high 31 bits
    ts_lo: np.ndarray  # int32 — timestamp low 31 bits
    actor: np.ndarray  # int32 — index into actors_sorted (rank)
    value: np.ndarray  # int32 — index into values_sorted (rank)
    tombstone: np.ndarray  # bool
    keys: Vocab = field(default_factory=Vocab)
    actors_sorted: list = field(default_factory=list)  # rank → actor bytes
    values_sorted: list = field(default_factory=list)  # rank → value object


def lww_ops_to_columns(ops, keys: Vocab | None = None) -> LwwColumns:
    """Flatten LWW ops.  Actors and values are *rank*-interned (sorted by
    bytes) so integer comparison on the device reproduces the host's
    lexicographic tie-breaks exactly.  Each value is packed once."""
    from .lww import ts_split

    ops = [LWWOp.from_obj(o) if isinstance(o, (list, tuple)) else o for o in ops]
    keys = keys if keys is not None else Vocab()
    actors = sorted({op.actor for op in ops})
    actor_rank = {a: i for i, a in enumerate(actors)}
    packed = []
    packed_vals = {}
    for op in ops:
        v = None if op.tombstone else op.value
        p = codec.pack(v)
        packed.append(p)
        packed_vals[p] = v
    order = sorted(packed_vals)
    values_sorted = [packed_vals[k] for k in order]
    value_rank = {k: i for i, k in enumerate(order)}
    intern = keys.intern
    key_col = [intern(op.key) for op in ops]
    ts_hi, ts_lo = ts_split(np.asarray([op.ts for op in ops], np.int64).reshape(-1))
    return LwwColumns(
        np.asarray(key_col, np.int32),
        ts_hi,
        ts_lo,
        np.asarray([actor_rank[op.actor] for op in ops], np.int32),
        np.asarray([value_rank[p] for p in packed], np.int32),
        np.asarray([op.tombstone for op in ops], bool),
        keys,
        actors,
        values_sorted,
    )
