"""G-Counter and PN-Counter.

A copy of ``crdt_enc_tpu/models/counters.py``.  A G-Counter is a VClock
whose value is the sum of per-actor counters; an increment op is the
actor's next dot and apply is a max (so replayed or duplicated op files
are idempotent).  The device analogue is a segment-max over
(actor → counter) columns (``crdt_enc_tpu_torch.ops.counters``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .vclock import Actor, Dot, VClock

POS, NEG = 0, 1


@dataclass
class GCounter:
    clock: VClock = field(default_factory=VClock)

    def inc(self, actor: Actor, steps: int = 1) -> Dot:
        """Build the op advancing this actor's counter by ``steps``."""
        if steps < 1:
            raise ValueError("steps must be >= 1")
        return Dot(actor, self.clock.get(actor) + steps)

    def apply(self, op: Dot) -> None:
        self.clock.apply(op)

    def merge(self, other: "GCounter") -> None:
        self.clock.merge(other.clock)

    def read(self) -> int:
        return sum(self.clock.counters.values())

    def reset_remove(self, ctx) -> None:
        """ResetRemove (for causal-Map children): forget increments the
        removed context observed."""
        self.clock.reset_remove(ctx)

    def to_obj(self):
        return self.clock.to_obj()

    @classmethod
    def from_obj(cls, obj) -> "GCounter":
        return cls(VClock.from_obj(obj))

    def __eq__(self, other) -> bool:
        return isinstance(other, GCounter) and self.clock == other.clock


@dataclass
class PNCounter:
    """Increment/decrement counter: two G-Counter planes."""

    p: GCounter = field(default_factory=GCounter)
    n: GCounter = field(default_factory=GCounter)

    def inc(self, actor: Actor, steps: int = 1):
        return (POS, self.p.inc(actor, steps))

    def dec(self, actor: Actor, steps: int = 1):
        return (NEG, self.n.inc(actor, steps))

    def apply(self, op) -> None:
        direction, dot = op
        if not isinstance(dot, Dot):
            dot = Dot.from_obj(dot)
        if direction == POS:
            self.p.apply(dot)
        elif direction == NEG:
            self.n.apply(dot)
        else:
            raise ValueError(f"bad PNCounter op direction {direction!r}")

    def merge(self, other: "PNCounter") -> None:
        self.p.merge(other.p)
        self.n.merge(other.n)

    def read(self) -> int:
        return self.p.read() - self.n.read()

    def reset_remove(self, ctx) -> None:
        """ResetRemove (for causal-Map children): both planes forget the
        removed context."""
        self.p.reset_remove(ctx)
        self.n.reset_remove(ctx)

    def to_obj(self):
        return [self.p.to_obj(), self.n.to_obj()]

    @classmethod
    def from_obj(cls, obj) -> "PNCounter":
        p, n = obj
        return cls(GCounter.from_obj(p), GCounter.from_obj(n))

    def __eq__(self, other) -> bool:
        return isinstance(other, PNCounter) and self.p == other.p and self.n == other.n
