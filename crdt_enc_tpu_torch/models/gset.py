"""Grow-only set.

The port's copy of ``crdt_enc_tpu/models/gset.py``.

The simplest member of the external engine's catalogue (the reference is
generic over any ``crdts`` state type, lib.rs:189-197; the crate ships
``gset`` alongside the types the reference example uses).  An op IS the
member; merge is set union — no clocks, no contexts, removal impossible
by construction.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import codec


@dataclass
class GSet:
    members: set = field(default_factory=set)

    # ops are members themselves (crdts gset::Op::Insert { member })
    def insert_ctx(self, member):
        return member

    def apply(self, op) -> None:
        self.members.add(self._freeze(op))

    def merge(self, other: "GSet") -> None:
        self.members |= other.members

    def contains(self, member) -> bool:
        return self._freeze(member) in self.members

    def read(self) -> list:
        return sorted(self.members, key=codec.pack)

    @staticmethod
    def _freeze(member):
        # msgpack round-trip would thaw bytes-like views; store hashables
        if isinstance(member, (bytearray, memoryview)):
            return bytes(member)
        if isinstance(member, list):
            return tuple(member)
        return member

    def to_obj(self):
        return [m for m in self.read()]

    @classmethod
    def from_obj(cls, obj) -> "GSet":
        s = cls()
        for m in obj or []:
            s.apply(m)
        return s
