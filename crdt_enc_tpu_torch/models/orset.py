"""Observed-remove set (Orswot-style, tombstone-free), dense-semantics.

A copy of the host OR-Set of ``crdt_enc_tpu/models/orset.py``: the port's
state type and its host reference.  State is exactly three planes that
map 1:1 onto dense tensors —

* ``clock[r]``      — global per-replica max counter seen (VClock),
* ``entries[e][r]`` — the single latest surviving add-dot counter of member
                      ``e`` from replica ``r`` (0 = none),
* ``deferred[e][r]``— pending remove horizon: a remove observed dots up to
                      this counter that we have not seen yet (kept only while
                      it exceeds ``clock[r]``).

Presence: ``e ∈ set  ⟺  ∃r: entries[e][r] > 0``.

Merge is pure elementwise arithmetic (the kernels in
``crdt_enc_tpu_torch.ops.orset`` run the same formulas over (E, R)
tensors):

* ``clock' = max(clockA, clockB)``
* a dot ``a`` from one side survives iff the other side hasn't seen it
  (``a > other.clock[r]``) or holds the same dot (``a == b``); the merged
  entry is the max surviving dot,
* ``rm' = max(deferredA, deferredB)``; any surviving entry ``≤ rm'`` is
  killed (the remove it predicted has caught up),
* ``deferred'`` keeps only ``rm' > clock'``.

Causal-delivery contract: per-replica op streams are applied in dot order;
cross-replica interleaving is unconstrained.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import codec
from .vclock import Actor, Dot, VClock

Member = object  # any msgpack-able hashable: bytes, int, str, tuple


@dataclass(frozen=True)
class AddOp:
    member: Member
    dot: Dot

    def to_obj(self):
        return [0, self.member, self.dot.to_obj()]


@dataclass(frozen=True)
class RmOp:
    member: Member
    ctx: VClock  # the add-dots this remove observed (per-member read ctx)

    def to_obj(self):
        return [1, self.member, self.ctx.to_obj()]


def op_from_obj(obj):
    kind, member, payload = obj
    if kind == 0:
        return AddOp(member, Dot.from_obj(payload))
    if kind == 1:
        return RmOp(member, VClock.from_obj(payload))
    raise ValueError(f"bad ORSet op kind {kind!r}")


@dataclass
class ORSet:
    clock: VClock = field(default_factory=VClock)
    entries: dict = field(default_factory=dict)  # member -> {actor: counter}
    deferred: dict = field(default_factory=dict)  # member -> {actor: counter}
    # mutation epoch: bumped by every mutating method and by the
    # accelerator's plane writebacks, so a device-resident plane cache can
    # key its validity on it
    _mut: int = field(default=0, compare=False, repr=False)

    # -- op construction (local replica) -----------------------------------
    def add_ctx(self, actor: Actor, member: Member) -> AddOp:
        return AddOp(member, self.clock.inc(actor))

    def rm_ctx(self, member: Member) -> RmOp:
        """Remove everything currently observed for ``member``."""
        return RmOp(member, VClock(dict(self.entries.get(member, {}))))

    # -- CmRDT apply -------------------------------------------------------
    def apply(self, op) -> None:
        self._mut += 1
        if isinstance(op, (list, tuple)):
            op = op_from_obj(op)
        if isinstance(op, AddOp):
            self._apply_add(op.member, op.dot)
        elif isinstance(op, RmOp):
            self._apply_rm(op.member, op.ctx)
        else:
            raise TypeError(f"bad ORSet op {op!r}")

    def _apply_add(self, member: Member, dot: Dot) -> None:
        r, c = dot.actor, dot.counter
        if c <= self.clock.get(r):
            return  # already seen (duplicate/stale op replay)
        self.clock.counters[r] = c
        if self.deferred.get(member, {}).get(r, 0) >= c:
            # a remove already observed this dot: born dead
            self._normalize_member(member)
            return
        self.entries.setdefault(member, {})[r] = c
        self._normalize_member(member)

    def _apply_rm(self, member: Member, ctx: VClock) -> None:
        entry = self.entries.get(member)
        dfr = None
        for r, c in ctx.counters.items():
            if entry is not None and entry.get(r, 0) <= c:
                entry.pop(r, None)
            if c > self.clock.get(r):
                if dfr is None:
                    dfr = self.deferred.setdefault(member, {})
                if c > dfr.get(r, 0):
                    dfr[r] = c
        self._normalize_member(member)

    # -- CvRDT merge -------------------------------------------------------
    def merge(self, other: "ORSet") -> None:
        self._mut += 1
        members = set(self.entries) | set(other.entries)
        new_entries: dict = {}
        for e in members:
            ea = self.entries.get(e, {})
            eb = other.entries.get(e, {})
            merged: dict = {}
            for r in set(ea) | set(eb):
                a, b = ea.get(r, 0), eb.get(r, 0)
                surv_a = a if (a == b or a > other.clock.get(r)) else 0
                surv_b = b if (a == b or b > self.clock.get(r)) else 0
                c = max(surv_a, surv_b)
                if c:
                    merged[r] = c
            if merged:
                new_entries[e] = merged

        # remove horizons combine by max; they kill any entry they cover
        new_deferred: dict = {}
        for e in set(self.deferred) | set(other.deferred):
            da = self.deferred.get(e, {})
            db = other.deferred.get(e, {})
            merged_rm = {r: max(da.get(r, 0), db.get(r, 0)) for r in set(da) | set(db)}
            if merged_rm:
                new_deferred[e] = merged_rm

        self.clock.merge(other.clock)
        self.entries = new_entries
        self.deferred = new_deferred
        for e in list(members | set(new_deferred)):
            self._normalize_member(e)

    def reset_remove(self, ctx: VClock) -> None:
        """ResetRemove (for causal-map children): forget every dot and
        horizon the removed context observed — entries, deferred removes,
        and the clock itself all drop state ≤ ctx per actor."""
        self._mut += 1
        for m in list(self.entries):
            entry = self.entries[m]
            for r in [r for r, c in entry.items() if c <= ctx.get(r)]:
                del entry[r]
            if not entry:
                del self.entries[m]
        for m in list(self.deferred):
            dfr = self.deferred[m]
            for r in [r for r, c in dfr.items() if c <= ctx.get(r)]:
                del dfr[r]
            if not dfr:
                del self.deferred[m]
        self.clock.reset_remove(ctx)

    def _normalize_member(self, member: Member) -> None:
        entry = self.entries.get(member)
        dfr = self.deferred.get(member)
        if entry is not None and dfr:
            for r in list(entry):
                if entry[r] <= dfr.get(r, 0):
                    del entry[r]
        if dfr:
            # a horizon the clock has caught up with has fully applied
            for r in list(dfr):
                if dfr[r] <= self.clock.get(r):
                    del dfr[r]
            if not dfr:
                self.deferred.pop(member, None)
        if entry is not None and not entry:
            self.entries.pop(member, None)

    # -- reads -------------------------------------------------------------
    def contains(self, member: Member) -> bool:
        return member in self.entries

    def members(self) -> list:
        return sorted(self.entries, key=lambda m: codec.pack(m))

    # -- canonical serialization ------------------------------------------
    def to_obj(self):
        """Canonical form.  The per-op apply path normalizes lazily (only
        the touched member), so a remove horizon another member's adds have
        retired (``≤ clock``) can linger in ``deferred`` — semantically
        inert, but it would break byte equality against the batched folds,
        which normalize globally.  Serialization is where canonical means
        canonical: inert horizons are filtered here."""
        dfr = {
            m: {r: c for r, c in v.items() if c > self.clock.get(r)}
            for m, v in self.deferred.items()
        }
        return {
            b"c": self.clock.to_obj(),
            b"e": {m: dict(v) for m, v in self.entries.items() if v},
            b"d": {m: v for m, v in dfr.items() if v},
        }

    @classmethod
    def from_obj(cls, obj) -> "ORSet":
        s = cls()
        if obj is None:
            return s
        s.clock = VClock.from_obj(obj.get(b"c"))
        s.entries = {
            m: {bytes(r): int(c) for r, c in v.items()}
            for m, v in (obj.get(b"e") or {}).items()
            if v
        }
        s.deferred = {
            m: {bytes(r): int(c) for r, c in v.items()}
            for m, v in (obj.get(b"d") or {}).items()
            if v
        }
        return s

    def __eq__(self, other) -> bool:
        if not isinstance(other, ORSet):
            return NotImplemented
        return codec.pack(self.to_obj()) == codec.pack(other.to_obj())
