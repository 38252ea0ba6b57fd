"""Host CRDT models of the port: the OR-Set state type and its reference
semantics (copies of the JAX package's ``models``)."""

from .base import canonical_bytes
from .orset import AddOp, ORSet, RmOp, op_from_obj
from .vclock import Dot, VClock

__all__ = ["AddOp", "Dot", "ORSet", "RmOp", "VClock", "canonical_bytes", "op_from_obj"]
