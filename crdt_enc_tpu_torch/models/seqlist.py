"""Sequence CRDT: an ordered list with dense position identifiers.

The port's copy of ``crdt_enc_tpu/models/seqlist.py``.

The external engine's ``list`` capability (the reference is generic over
any ``crdts`` state type, lib.rs:189-197): concurrent inserts at the
same position converge to one total order without coordination.  Logoot
style: every element owns an identifier ``(path, actor, seq)`` where

* ``path`` is a tuple of integer digits in ``[0, BASE)`` — a point in a
  dense order (between any two paths another fits, growing one digit
  level when the gap closes),
* ``(actor, seq)`` breaks ties between concurrent allocations of the
  same path AND makes identifiers globally unique (``seq`` is the
  actor's insert counter, so no identifier is ever minted twice — a
  tombstone can never swallow a later unrelated insert).

Deletes tombstone the identifier (grow-only tombstone set); merge is
union-of-elements minus union-of-tombstones.  Ordering is identifier
order, so apply/merge are order-independent and the canonical encoding
is deterministic — the property tests pin convergence under adversarial
interleavings like every other model here.

The op-log analogue of long sequences (SURVEY.md §2.3): a list's history
chunks and folds like any op stream; the accelerator's columnar paths
decline this type and the core folds per-op on host.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import codec
from .vclock import Actor

BASE = 1 << 31


def path_between(lo: tuple, hi: tuple | None) -> tuple:
    """A digit path strictly between ``lo`` and ``hi`` (``hi=None`` = +∞).

    Walks levels keeping the invariant "out is lo's prefix (0-padded) or
    already diverged below hi"; the first level with a gap > 1 fits a new
    digit.  Terminates because past both lengths the gap is ``BASE``.
    """
    out = []
    i = 0
    while True:
        a = lo[i] if i < len(lo) else 0
        b = hi[i] if hi is not None and i < len(hi) else BASE
        if b - a > 1:
            out.append(a + 1)
            return tuple(out)
        out.append(a)
        i += 1


@dataclass(frozen=True)
class InsOp:
    path: tuple
    actor: Actor
    seq: int
    value: object

    @property
    def ident(self):
        return (self.path, self.actor, self.seq)

    def to_obj(self):
        return [0, list(self.path), self.actor, self.seq, self.value]


@dataclass(frozen=True)
class DelOp:
    path: tuple
    actor: Actor
    seq: int

    @property
    def ident(self):
        return (self.path, self.actor, self.seq)

    def to_obj(self):
        return [1, list(self.path), self.actor, self.seq]


def op_from_obj(obj):
    if isinstance(obj, (InsOp, DelOp)):
        return obj
    kind = obj[0]
    path = tuple(int(d) for d in obj[1])
    actor, seq = bytes(obj[2]), int(obj[3])
    if kind == 0:
        return InsOp(path, actor, seq, obj[4])
    if kind == 1:
        return DelOp(path, actor, seq)
    raise ValueError(f"bad list op kind {kind!r}")


@dataclass
class SeqList:
    elems: dict = field(default_factory=dict)  # ident -> value (visible)
    tombs: set = field(default_factory=set)  # deleted idents
    _seq_seen: dict = field(default_factory=dict)  # actor -> max seq seen

    # -- op derivation (ctx style: derive against current state, apply) ---
    def insert_ctx(self, actor: Actor, index: int, value) -> InsOp:
        """An insert placing ``value`` at ``index`` of the visible list.

        Placement caveat shared with the Logoot family: elements whose
        paths collide (only possible via *concurrent* same-position
        inserts) order by ``(actor, seq)``, and a later insert aimed
        between such twins lands adjacent to the cluster instead of
        inside it — identically on every replica, so convergence and
        determinism hold; only the index intuition bends, and only
        around concurrency.
        """
        order = self._order()
        if not 0 <= index <= len(order):
            raise IndexError(f"insert index {index} out of range")
        lo = order[index - 1][0] if index > 0 else ()
        hi = order[index][0] if index < len(order) else None
        actor = bytes(actor)
        seq = self._seq_seen.get(actor, 0) + 1
        return InsOp(path_between(lo, hi), actor, seq, value)

    def append_ctx(self, actor: Actor, value) -> InsOp:
        return self.insert_ctx(actor, len(self.elems), value)

    def delete_ctx(self, index: int) -> DelOp:
        order = self._order()
        if not 0 <= index < len(order):
            # no negative indexing: a caller's off-by-one would silently
            # tombstone the LAST element, irreversibly, on every replica
            raise IndexError(f"delete index {index} out of range")
        path, actor, seq = order[index]
        return DelOp(path, actor, seq)

    # -- CmRDT -------------------------------------------------------------
    def apply(self, op) -> None:
        op = op_from_obj(op) if isinstance(op, (list, tuple)) else op
        ident = op.ident
        seen = self._seq_seen.get(op.actor, 0)
        if op.seq > seen:
            self._seq_seen[op.actor] = op.seq
        if isinstance(op, InsOp):
            if ident not in self.tombs:
                self.elems[ident] = op.value
        else:
            self.elems.pop(ident, None)
            self.tombs.add(ident)

    # -- CvRDT -------------------------------------------------------------
    def merge(self, other: "SeqList") -> None:
        self.tombs |= other.tombs
        for ident, value in other.elems.items():
            if ident not in self.tombs:
                self.elems[ident] = value
        for ident in [i for i in self.elems if i in self.tombs]:
            del self.elems[ident]
        for actor, seq in other._seq_seen.items():
            if seq > self._seq_seen.get(actor, 0):
                self._seq_seen[actor] = seq

    # -- reads -------------------------------------------------------------
    def _order(self) -> list:
        return sorted(self.elems)

    def read(self) -> list:
        return [self.elems[i] for i in self._order()]

    def __len__(self) -> int:
        return len(self.elems)

    # -- canonical serialization ------------------------------------------
    @staticmethod
    def _ident_obj(ident):
        path, actor, seq = ident
        return [list(path), actor, seq]

    def to_obj(self):
        return [
            [self._ident_obj(i), self.elems[i]] for i in self._order()
        ] + [[self._ident_obj(i)] for i in sorted(self.tombs)]

    @classmethod
    def from_obj(cls, obj) -> "SeqList":
        lst = cls()
        for entry in obj or []:
            ident_obj = entry[0]
            ident = (
                tuple(int(d) for d in ident_obj[0]),
                bytes(ident_obj[1]),
                int(ident_obj[2]),
            )
            seen = lst._seq_seen.get(ident[1], 0)
            if ident[2] > seen:
                lst._seq_seen[ident[1]] = ident[2]
            if len(entry) == 2:
                lst.elems[ident] = entry[1]
            else:
                lst.tombs.add(ident)
        return lst
