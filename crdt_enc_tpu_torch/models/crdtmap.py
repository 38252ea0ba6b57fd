"""Causal reset-remove map: keys to nested CRDT values.

The port's copy of ``crdt_enc_tpu/models/crdtmap.py``.

The external engine's ``map`` capability (the reference is generic over
any ``crdts`` state type, lib.rs:189-197): a map whose values are
themselves CRDTs, where removing a key deletes exactly the causal
history the remover had *observed* — updates concurrent with the remove
survive (observed-remove, the same add-wins discipline as the ORSet),
and the nested value forgets only the removed context
(``reset_remove``).

Dot discipline (mirrors the crate's ctx protocol): ONE dot per update
authorizes both the map entry (the key's "birth" dots) and the child
mutation — the function making the child op receives that dot, so
map-level replay protection and removal cover the child coherently.
See ``CHILD_TYPES`` for why the ORSet is the one child this stays
coherent for.

Structure parallels the tombstone-free ORSet (models/orset.py): per-key
birth dots as dense per-actor maxima, one global clock — but removes
whose context cites unseen dots defer as WHOLE ops, not per-actor
horizons, and a child's remove-horizons retire against the MAP clock.
Both rules exist because the transport is per-actor FIFO, *not* causal:
each was driven by a concrete divergence found under true-concurrency
fuzzing (ops derived from divergent replicas, gossiped out of causal
order) — the oracle-based law tests alone cannot reach those states.
CmRDT/CvRDT agreement, adversarial interleavings, and the
true-concurrency class are all pinned in tests/test_crdtmap.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import codec
from .orset import ORSet
from .orset import op_from_obj as orset_op_from_obj
from .vclock import Actor, Dot, VClock


# child registry: name -> (type, op_from_obj, op_to_obj)
#
# The ORSet is the one child whose dot discipline is coherent under the
# map (the crate's canonical Orswot-in-map usage): a child add's dot IS
# the map dot, so map-level replay gates, resets, and the merge's
# clock-coverage arguments all see one consistent dot space.  Two
# families are deliberately absent, each verified non-convergent by
# fuzzing before exclusion:
#
# * MVReg — its unit of state is a (context-clock, value) pair; a
#   key-remove's reset shrinks pair clocks, two distinct writes can
#   collapse onto one clock, and no merge rule can then tell their
#   histories apart (re-merges resurrect dead dots).  The external
#   crate's MVReg-in-map shares these corners under the non-causal
#   delivery this framework's file-sync transport provides.
# * Counters — shared map dots corrupt counts (max-dot ≠ op count when
#   an actor alternates inc/dec), and child-local dots break the shared
#   dot space the reset rules need.
#
# A register- or counter-per-key is served by LWWMap or separate Cores.
CHILD_TYPES = {
    b"orset": (ORSet, orset_op_from_obj, lambda op: op.to_obj()),
}


@dataclass(frozen=True)
class UpOp:
    """One update: the dot births the key and authorizes ``child_op``."""

    dot: Dot
    key: object
    child_op: object

    def to_obj(self, child_op_to_obj):
        return [0, self.dot.to_obj(), self.key, child_op_to_obj(self.child_op)]


@dataclass(frozen=True)
class RmOp:
    """Observed-remove of ``keys`` under the read context ``ctx``."""

    ctx: VClock
    keys: tuple

    def to_obj(self, _child_op_to_obj=None):
        return [1, self.ctx.to_obj(), list(self.keys)]


@dataclass
class CrdtMap:
    """``CrdtMap(child=b"orset")`` — the child type is fixed per map."""

    child: bytes = b"orset"
    clock: VClock = field(default_factory=VClock)
    # key -> {actor: max birth counter}
    births: dict = field(default_factory=dict)
    # key -> child CRDT state
    vals: dict = field(default_factory=dict)
    # pending whole removes whose context cites dots beyond the clock:
    # canonical-ctx-bytes -> (VClock, set of keys).  Deferring the WHOLE
    # op (the crdts-crate discipline) — not per-actor horizons — is what
    # keeps non-causal delivery convergent: a remove fires only once
    # every update it observed has arrived, so the updates' child
    # sub-ops (e.g. a child remove citing an actor the remover never
    # saw) are never lost to suppression.
    deferred: dict = field(default_factory=dict)
    # mutation epoch: bumped by every mutating method (and by the
    # accelerator's fold writebacks, ops/map_columnar.py) so caches and
    # checkpoint stashes can key their validity on it — same law as
    # ORSet._mut (MUT001 enforces it statically)
    _mut: int = field(default=0, compare=False, repr=False)

    def __post_init__(self):
        if self.child not in CHILD_TYPES:
            raise ValueError(f"unknown child CRDT type {self.child!r}")

    def _child_type(self):
        return CHILD_TYPES[self.child]

    # -- op derivation -----------------------------------------------------
    def update_ctx(self, actor: Actor, key, build_child_op) -> UpOp:
        """Derive an update: ``build_child_op(child_state, dot)`` returns
        the child op the shared dot authorizes (the child it receives is
        the current value or a fresh empty one — never mutated here)."""
        dot = self.clock.inc(actor)
        cls = self._child_type()[0]
        child = self.vals.get(key)
        child = child if child is not None else cls()
        return UpOp(dot, key, build_child_op(child, dot))

    def rm_ctx(self, *keys) -> RmOp:
        """Remove keys as observed: the context is the keys' birth dots
        (everything this replica has seen of them)."""
        ctx = VClock()
        for key in keys:
            for a, c in self.births.get(key, {}).items():
                if c > ctx.get(a):
                    ctx.counters[a] = c
        return RmOp(ctx, tuple(keys))

    # -- CmRDT -------------------------------------------------------------
    def apply(self, op) -> None:
        self._mut += 1
        if isinstance(op, (list, tuple)):
            op = self.op_from_obj(op)
        if isinstance(op, UpOp):
            self._apply_up(op)
        elif isinstance(op, RmOp):
            self._apply_rm(op)
        else:
            raise TypeError(f"bad CrdtMap op {op!r}")

    def _apply_up(self, op: UpOp) -> None:
        if self.clock.contains(op.dot):
            return  # replay
        birth = self.births.setdefault(op.key, {})
        if op.dot.counter > birth.get(op.dot.actor, 0):
            birth[op.dot.actor] = op.dot.counter
        cls = self._child_type()[0]
        child = self.vals.get(op.key)
        if child is None:
            child = self.vals[op.key] = cls()
        child.apply(op.child_op)
        self.clock.apply(op.dot)
        # retire child remove-horizons the MAP clock covers: child dots
        # are key-bound, so a cited dot ≤ the map clock either reached
        # this child incarnation (its own normalize handles it) or
        # belonged to a previous incarnation a key-remove consumed —
        # either way it can never arrive again (per-actor FIFO + replay
        # gate), and keeping it would diverge from replicas that saw the
        # dot before the key died
        self._retire_child_horizons(child)
        self._flush_deferred()

    def _retire_child_horizons(self, child) -> None:
        dfr = getattr(child, "deferred", None)
        if not dfr:
            return
        clock = self.clock
        for m in list(dfr):
            d = dfr[m]
            for a in [a for a, c in d.items() if c <= clock.get(a)]:
                del d[a]
            if not d:
                del dfr[m]

    def _apply_rm(self, op: RmOp) -> None:
        if self.clock.descends(op.ctx):
            self._rm_now(op.ctx, op.keys)
        else:
            self._defer(op.ctx, op.keys)

    def _rm_now(self, ctx: VClock, keys) -> None:
        for key in keys:
            birth = self.births.get(key)
            child = self.vals.get(key)
            if birth is None and child is None:
                continue
            if birth is not None:
                for a in [a for a, c in birth.items() if c <= ctx.get(a)]:
                    del birth[a]
            if child is not None:
                child.reset_remove(ctx)
            if not birth:
                self.births.pop(key, None)
                # the child may hold RESIDUE the key's death must not
                # erase: remove horizons citing dots this replica has not
                # seen (delivery is per-actor FIFO, not causal — an
                # arriving update's child sub-ops can reference actors
                # the key-remover never saw).  Without the residue,
                # replicas that got the remove first would resurrect
                # state that replicas who saw the update first killed.
                if child is not None and not self._child_residue(child):
                    self.vals.pop(key, None)

    def _child_residue(self, child) -> bool:
        return child.to_obj() != self._child_type()[0]().to_obj()

    def _defer(self, ctx: VClock, keys) -> None:
        tag = codec.pack(ctx.to_obj())
        slot = self.deferred.get(tag)
        if slot is None:
            self.deferred[tag] = (ctx.copy(), set(keys))
        else:
            slot[1].update(keys)

    def _flush_deferred(self) -> None:
        """Fire every pending remove whose cited history has now fully
        arrived (called after each clock advance and after merges)."""
        if not self.deferred:
            return
        for tag in [
            t for t, (ctx, _) in self.deferred.items()
            if self.clock.descends(ctx)
        ]:
            ctx, keys = self.deferred.pop(tag)
            self._rm_now(ctx, keys)

    # -- CvRDT -------------------------------------------------------------
    #
    # The survivor rule everywhere below relies on global dot uniqueness:
    # a dot (actor, counter) names ONE map update, which targeted ONE key
    # — so "dot covered by the other side's MAP clock, yet absent from
    # the other side's state" can only mean observed-removed.  Child
    # state therefore merges against the MAP clocks, not the children's
    # own clocks (a remover's child forgot the removed dots via
    # reset_remove, so its own clock cannot testify about them).
    def merge(self, other: "CrdtMap") -> None:
        if self.child != other.child:
            raise ValueError("cannot merge maps with different child types")
        self._mut += 1
        keys = (
            set(self.births) | set(other.births)
            | set(self.vals) | set(other.vals)  # residue-only keys too
        )
        cls = self._child_type()[0]
        new_births: dict = {}
        new_vals: dict = {}
        for key in keys:
            ba = self.births.get(key, {})
            bb = other.births.get(key, {})
            merged: dict = {}
            for a in set(ba) | set(bb):
                c = self._surv2(
                    ba.get(a, 0), bb.get(a, 0),
                    self.clock.get(a), other.clock.get(a),
                )
                if c:
                    merged[a] = c
            va = self.vals.get(key)
            vb = other.vals.get(key)
            child = self._merge_child_ctx(
                va if va is not None else cls(),
                vb if vb is not None else cls(),
                self.clock, other.clock,
            )
            if merged:
                new_births[key] = merged
                new_vals[key] = child
            elif self._child_residue(child):
                new_vals[key] = child  # dead key, live residue

        # pending removes union (keys union per identical context)
        for tag, (ctx, rm_keys) in other.deferred.items():
            slot = self.deferred.get(tag)
            if slot is None:
                self.deferred[tag] = (ctx.copy(), set(rm_keys))
            else:
                slot[1].update(rm_keys)

        self.clock.merge(other.clock)
        self.births = new_births
        self.vals = new_vals
        # pending removes whose cited history is now complete fire on the
        # merged state
        self._flush_deferred()

    @staticmethod
    def _surv2(xa: int, xb: int, ca_r: int, cb_r: int) -> int:
        """Per-actor survivor max: a side's value stands if both agree or
        it is beyond the other side's map clock (else observed-removed)."""
        surv_a = xa if (xa == xb or xa > cb_r) else 0
        surv_b = xb if (xa == xb or xb > ca_r) else 0
        return max(surv_a, surv_b)

    def _merge_child_ctx(self, va, vb, ca: VClock, cb: VClock):
        """Merge two child states under the MAP clocks (see merge())."""
        if self.child == b"orset":
            return self._merge_orset_ctx(va, vb, ca, cb)
        raise ValueError(f"unknown child CRDT type {self.child!r}")

    @classmethod
    def _merge_clock_ctx(cls, a: VClock, b: VClock, ca: VClock, cb: VClock) -> VClock:
        out = VClock()
        for r in set(a.counters) | set(b.counters):
            c = cls._surv2(a.get(r), b.get(r), ca.get(r), cb.get(r))
            if c:
                out.counters[r] = c
        return out

    @classmethod
    def _merge_orset_ctx(cls, va: ORSet, vb: ORSet, ca: VClock, cb: VClock) -> ORSet:
        out = ORSet()
        for m in set(va.entries) | set(vb.entries):
            ea, eb = va.entries.get(m, {}), vb.entries.get(m, {})
            merged = {}
            for r in set(ea) | set(eb):
                c = cls._surv2(ea.get(r, 0), eb.get(r, 0), ca.get(r), cb.get(r))
                if c:
                    merged[r] = c
            if merged:
                out.entries[m] = merged
        # remove horizons union by max…
        for src in (va.deferred, vb.deferred):
            for m, d in src.items():
                slot = out.deferred.setdefault(m, {})
                for r, c in d.items():
                    if c > slot.get(r, 0):
                        slot[r] = c
        out.clock = cls._merge_clock_ctx(va.clock, vb.clock, ca, cb)
        for m in list(set(out.entries) | set(out.deferred)):
            out._normalize_member(m)
        # …then retire any the merged MAP knowledge covers: a dot ≤ both
        # effective clocks can never re-enter this child (the map-level
        # survivor filter and replay gate both block it), and the fold
        # side retired the same horizons through the child clock the
        # map-level reset has since forgotten
        mapk = ca.copy()
        mapk.merge(cb)
        for m in list(out.deferred):
            d = out.deferred[m]
            for r in [r for r, c in d.items() if c <= mapk.get(r)]:
                del d[r]
            if not d:
                del out.deferred[m]
        return out

    # -- reads -------------------------------------------------------------
    def get(self, key):
        return self.vals.get(key)

    def keys(self) -> list:
        return sorted(self.births, key=codec.pack)

    def contains(self, key) -> bool:
        return key in self.births

    # -- wire --------------------------------------------------------------
    def op_to_obj(self, op):
        return op.to_obj(self._child_type()[2])

    def op_from_obj(self, obj):
        if isinstance(obj, (UpOp, RmOp)):
            return obj
        kind = obj[0]
        if kind == 0:
            return UpOp(
                Dot.from_obj(obj[1]), self._thaw_key(obj[2]),
                self._child_type()[1](obj[3]),
            )
        if kind == 1:
            return RmOp(
                VClock.from_obj(obj[1]),
                tuple(self._thaw_key(k) for k in obj[2]),
            )
        raise ValueError(f"bad CrdtMap op kind {kind!r}")

    @staticmethod
    def _thaw_key(key):
        if isinstance(key, (bytearray, memoryview)):
            return bytes(key)
        if isinstance(key, list):
            return tuple(key)
        return key

    def to_obj(self):
        all_keys = sorted(set(self.births) | set(self.vals), key=codec.pack)
        cls = self._child_type()[0]
        return [
            self.child,
            self.clock.to_obj(),
            [
                [
                    k,
                    {
                        a: c
                        for a, c in sorted(self.births.get(k, {}).items())
                    },
                    self.vals[k].to_obj() if k in self.vals else cls().to_obj(),
                ]
                for k in all_keys
            ],
            [
                [ctx.to_obj(), sorted(rm_keys, key=codec.pack)]
                for _, (ctx, rm_keys) in sorted(self.deferred.items())
            ],
        ]

    @classmethod
    def from_obj(cls, obj) -> "CrdtMap":
        child, clock, entries, deferred = obj
        m = cls(child=bytes(child))
        m.clock = VClock.from_obj(clock)
        ctype = m._child_type()[0]
        for k, birth, val in entries:
            k = cls._thaw_key(k)
            if birth:
                m.births[k] = {bytes(a): int(c) for a, c in birth.items()}
            m.vals[k] = ctype.from_obj(val)
        for ctx_obj, rm_keys in deferred:
            m._defer(
                VClock.from_obj(ctx_obj),
                [cls._thaw_key(k) for k in rm_keys],
            )
        return m
