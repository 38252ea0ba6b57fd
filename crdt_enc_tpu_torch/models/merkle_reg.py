"""Merkle-DAG register: a register whose write history is a content-

The port's copy of ``crdt_enc_tpu/models/merkle_reg.py``.
addressed DAG.

The external engine's ``merkle_reg`` (the reference is generic over any
``crdts`` state type, lib.rs:189-197): each write names the hashes of
the writes it supersedes, so the "current" value(s) are the DAG's heads
— nodes no other node claims as a parent.  Concurrent writes coexist as
multiple heads until a later write cites them all.  Content addressing
(SHA3-256 over the canonical node encoding, the same hash family the
storage backends use for file names) makes apply/merge idempotent by
construction: a node IS its bytes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

from ..utils import codec


def node_hash(parents, value) -> bytes:
    return hashlib.sha3_256(
        codec.pack([sorted(bytes(p) for p in parents), value])
    ).digest()


@dataclass(frozen=True)
class MerkleNode:
    parents: tuple  # tuple[bytes, ...], sorted
    value: object

    @property
    def hash(self) -> bytes:
        return node_hash(self.parents, self.value)

    def to_obj(self):
        return [list(self.parents), self.value]

    @classmethod
    def from_obj(cls, obj) -> "MerkleNode":
        parents, value = obj
        return cls(tuple(sorted(bytes(p) for p in parents)), value)


@dataclass
class MerkleReg:
    nodes: dict = field(default_factory=dict)  # hash -> MerkleNode

    def write_ctx(self, value) -> MerkleNode:
        """A write superseding the current heads (cite them as parents)."""
        return MerkleNode(tuple(sorted(self.heads())), value)

    def heads(self) -> list:
        """Hashes of nodes no stored node cites as a parent."""
        cited = {p for n in self.nodes.values() for p in n.parents}
        return sorted(h for h in self.nodes if h not in cited)

    def read(self) -> list:
        """Values at the heads, in canonical order."""
        return [self.nodes[h].value for h in self.heads()]

    def apply(self, op) -> None:
        if isinstance(op, (list, tuple)):
            op = MerkleNode.from_obj(op)
        self.nodes[op.hash] = op

    def merge(self, other: "MerkleReg") -> None:
        self.nodes.update(other.nodes)

    def to_obj(self):
        return [self.nodes[h].to_obj() for h in sorted(self.nodes)]

    @classmethod
    def from_obj(cls, obj) -> "MerkleReg":
        reg = cls()
        for node in obj or []:
            reg.apply(MerkleNode.from_obj(node))
        return reg
