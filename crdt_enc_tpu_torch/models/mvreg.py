"""Multi-value register with causal read/write contexts.

The port's copy of ``crdt_enc_tpu/models/mvreg.py`` (without the
causal-map ``reset_remove``, which no port type calls).

Replaces the ``crdts`` crate's MVReg (reference usage: the Keys CRDT at
crdt-enc/src/key_cryptor.rs:35-52 and the RemoteMeta plugin-blob registers at
lib.rs:745-750).  A write supersedes everything it causally saw; concurrent
writes survive side by side until a later write (or an application-level
tie-break, cf. ``latest_key``) resolves them.

Values are opaque msgpack-able objects (in this framework almost always the
msgpack form of a VersionBytes — versioned opaque blobs, as in the reference).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import codec
from .vclock import Actor, VClock


@dataclass(frozen=True)
class MVRegOp:
    clock: VClock
    value: object


@dataclass
class ReadCtx:
    """A read plus the causal context it was taken under (crdts ReadCtx)."""

    clock: VClock
    values: list

    def derive_write(self, actor: Actor, value) -> MVRegOp:
        """Build a write op that supersedes everything this read saw."""
        clock = self.clock.copy()
        clock.apply(clock.inc(actor))
        return MVRegOp(clock, value)


@dataclass
class MVReg:
    # parallel lists of (clock, value) pairs, none dominated by another
    vals: list = field(default_factory=list)  # list[tuple[VClock, object]]

    def read(self) -> ReadCtx:
        clock = VClock()
        for c, _ in self.vals:
            clock.merge(c)
        return ReadCtx(clock, [v for _, v in self.vals])

    def write_ctx(self, actor: Actor, value) -> MVRegOp:
        return self.read().derive_write(actor, value)

    def apply(self, op: MVRegOp) -> None:
        # Drop pairs the op STRICTLY supersedes; keep the op unless itself
        # strictly superseded.  Equal-clock pairs with distinct values
        # coexist (ordinary ctx-derived writes never produce them — each
        # write carries a fresh dot — but a causal-Map reset can shrink
        # two different writes onto one clock, and preferring one by
        # serialization order would diverge; exact duplicates are deduped
        # by _canonicalize).
        kept = [(c, v) for c, v in self.vals if not op.clock.dominates(c)]
        if not any(c.dominates(op.clock) for c, _ in kept):
            kept.append((op.clock.copy(), op.value))
        self.vals = kept
        self._canonicalize()

    def merge(self, other: "MVReg") -> None:
        mine = [(c, v) for c, v in self.vals if self._survives(c, v, other.vals)]
        theirs = [(c, v) for c, v in other.vals if self._survives(c, v, self.vals)]
        merged = mine + [(c.copy(), v) for c, v in theirs]
        self.vals = merged
        self._canonicalize()

    def reset_remove(self, ctx: VClock) -> None:
        """ResetRemove (for causal-Map children): each surviving value
        forgets the removed context's dots; values whose entire causal
        basis was observed-removed vanish."""
        kept = []
        for c, v in self.vals:
            c.reset_remove(ctx)
            if not c.is_empty():
                kept.append((c, v))
        self.vals = kept
        self._canonicalize()

    @staticmethod
    def _survives(clock: VClock, value, opposing: list) -> bool:
        """A pair survives unless some opposing pair strictly dominates it."""
        for oc, _ in opposing:
            if oc.dominates(clock):
                return False
        return True

    def _canonicalize(self) -> None:
        # dedupe identical (clock, value) pairs, sort by canonical bytes
        seen = {}
        for c, v in self.vals:
            seen[codec.pack([c.to_obj(), v])] = (c, v)
        self.vals = [seen[k] for k in sorted(seen)]

    def is_empty(self) -> bool:
        return not self.vals

    def to_obj(self):
        return [[c.to_obj(), v] for c, v in self.vals]

    @classmethod
    def from_obj(cls, obj) -> "MVReg":
        reg = cls()
        if obj is None:
            return reg
        reg.vals = [(VClock.from_obj(c), v) for c, v in obj]
        reg._canonicalize()
        return reg

    def __eq__(self, other) -> bool:
        if not isinstance(other, MVReg):
            return NotImplemented
        return codec.pack(self.to_obj()) == codec.pack(other.to_obj())
