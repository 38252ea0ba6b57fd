"""Vector clocks and dots — the causality substrate of the OR-Set.

A copy of ``crdt_enc_tpu/models/vclock.py``.  Actors are 16-byte UUIDs
(bytes).  A ``Dot`` is one event ``(actor, counter)``; a ``VClock``
summarizes a causal history as the per-actor max counter.
"""

from __future__ import annotations

from dataclasses import dataclass, field

Actor = bytes  # 16-byte UUID


@dataclass(frozen=True, order=True)
class Dot:
    actor: Actor
    counter: int

    def to_obj(self):
        return [self.actor, self.counter]

    @classmethod
    def from_obj(cls, obj) -> "Dot":
        actor, counter = obj
        return cls(bytes(actor), int(counter))


@dataclass
class VClock:
    counters: dict[Actor, int] = field(default_factory=dict)

    def get(self, actor: Actor) -> int:
        return self.counters.get(actor, 0)

    def inc(self, actor: Actor) -> Dot:
        """The next dot this actor would produce (does not mutate: applying
        the op that carries it commits it)."""
        return Dot(actor, self.get(actor) + 1)

    def apply(self, dot: Dot) -> None:
        if dot.counter > self.get(dot.actor):
            self.counters[dot.actor] = dot.counter

    def merge(self, other: "VClock") -> None:
        for a, c in other.counters.items():
            if c > self.get(a):
                self.counters[a] = c

    def is_empty(self) -> bool:
        return not self.counters

    # canonical form: map actor → counter, zero entries dropped
    def to_obj(self):
        return {a: c for a, c in self.counters.items() if c > 0}

    @classmethod
    def from_obj(cls, obj) -> "VClock":
        if obj is None:
            return cls()
        return cls({bytes(a): int(c) for a, c in obj.items() if int(c) > 0})

    def __eq__(self, other) -> bool:
        if not isinstance(other, VClock):
            return NotImplemented
        return {a: c for a, c in self.counters.items() if c} == {
            a: c for a, c in other.counters.items() if c
        }
