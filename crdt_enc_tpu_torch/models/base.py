"""The CRDT protocol, canonical serialization of states, and the no-op
state type.

A copy of ``Crdt``, ``canonical_bytes`` and ``EmptyCrdt`` from
``crdt_enc_tpu/models/base.py``: op-based (CmRDT) apply plus state-based
(CvRDT) merge, and every
state type's ``to_obj()`` emits a canonical (sorted, normalized) object,
so its packed bytes are deterministic whatever the op arrival order —
which is what makes "byte-identical device result" a meaningful test.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from ..utils import codec


@runtime_checkable
class Crdt(Protocol):
    def apply(self, op: Any) -> None:  # CmRDT
        ...

    def merge(self, other: "Crdt") -> None:  # CvRDT
        ...

    def to_obj(self) -> Any: ...

    @classmethod
    def from_obj(cls, obj: Any) -> "Crdt": ...


def canonical_bytes(state) -> bytes:
    return codec.pack(state.to_obj())


class EmptyCrdt:
    """No-op state type (reference utils/mod.rs:12-35): useful when a Core is
    opened purely for key/metadata management."""

    def apply(self, op) -> None:
        pass

    def merge(self, other) -> None:
        pass

    def to_obj(self):
        return None

    @classmethod
    def from_obj(cls, obj) -> "EmptyCrdt":
        return cls()

    def __eq__(self, other) -> bool:
        return isinstance(other, EmptyCrdt)
