"""Vector clocks and dots — the causality substrate of every CRDT here.

A copy of ``crdt_enc_tpu/models/vclock.py``.  Actors are 16-byte UUIDs
(bytes).  A ``Dot`` is one event ``(actor, counter)``; a ``VClock``
summarizes a causal history as the per-actor max counter.
"""

from __future__ import annotations

from collections.abc import Iterator
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

    def contains(self, dot: Dot) -> bool:
        """Has this history seen the event?  (counter ≤ clock[actor])"""
        return dot.counter <= self.get(dot.actor)

    def dominates(self, other: "VClock") -> bool:
        """Strictly greater: descends from ``other`` and differs."""
        return self.descends(other) and self.counters != other.counters

    def descends(self, other: "VClock") -> bool:
        """Greater or equal on every actor ``other`` has seen."""
        return all(self.get(a) >= c for a, c in other.counters.items())

    def concurrent(self, other: "VClock") -> bool:
        """Neither history descends from the other."""
        return not self.descends(other) and not other.descends(self)

    def actors(self) -> Iterator[Actor]:
        return iter(self.counters)

    def copy(self) -> "VClock":
        return VClock(dict(self.counters))

    def is_empty(self) -> bool:
        return not self.counters

    def reset_remove(self, ctx: "VClock") -> None:
        """Forget every event the removed context ``ctx`` observed: drop
        per-actor counters ≤ ctx's (the ResetRemove protocol the causal
        map applies to its children — models/crdtmap.py)."""
        for a in [a for a, c in self.counters.items() if c <= ctx.get(a)]:
            del self.counters[a]

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
