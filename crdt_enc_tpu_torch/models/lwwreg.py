"""Single last-writer-wins register.

The port's copy of ``crdt_enc_tpu/models/lwwreg.py``.

The one-slot sibling of :mod:`lwwmap` (the external engine's ``lwwreg``;
the reference is generic over any of its state types, lib.rs:189-197).
The ``(timestamp, actor)`` marker totally orders writes; where the crate
*panics* on equal markers with different values, this converges
deterministically with the same value-bytes tie-break the map uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .lwwmap import _wins
from .vclock import Actor


@dataclass(frozen=True)
class LWWRegOp:
    ts: int
    actor: Actor
    value: object

    def to_obj(self):
        return [self.ts, self.actor, self.value]

    @classmethod
    def from_obj(cls, obj) -> "LWWRegOp":
        ts, actor, value = obj
        return cls(int(ts), bytes(actor), value)


@dataclass
class LWWReg:
    # [ts, actor, value] of the winning write, or None before any write
    slot: list | None = field(default=None)

    def write(self, ts: int, actor: Actor, value) -> LWWRegOp:
        return LWWRegOp(ts, actor, value)

    def read(self):
        return None if self.slot is None else self.slot[2]

    def apply(self, op) -> None:
        if isinstance(op, (list, tuple)):
            op = LWWRegOp.from_obj(op)
        self._take(op.ts, bytes(op.actor), op.value)

    def merge(self, other: "LWWReg") -> None:
        if other.slot is not None:
            ts, actor, value = other.slot
            self._take(int(ts), bytes(actor), value)

    def _take(self, ts: int, actor: bytes, value) -> None:
        if self.slot is None or _wins(
            ts, actor, value, False,
            int(self.slot[0]), bytes(self.slot[1]), self.slot[2], False,
        ):
            self.slot = [ts, actor, value]

    def to_obj(self):
        return None if self.slot is None else list(self.slot)

    @classmethod
    def from_obj(cls, obj) -> "LWWReg":
        reg = cls()
        if obj is not None:
            reg.slot = [int(obj[0]), bytes(obj[1]), obj[2]]
        return reg
