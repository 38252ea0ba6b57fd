"""Host CRDT models of the port: the OR-Set, counter and LWW-map state
types and their reference semantics (copies of the JAX package's
``models``)."""

from .base import canonical_bytes
from .counters import NEG, POS, GCounter, PNCounter
from .lwwmap import LWWMap, LWWOp
from .orset import AddOp, ORSet, RmOp, op_from_obj
from .vclock import Dot, VClock

__all__ = [
    "NEG",
    "POS",
    "AddOp",
    "Dot",
    "GCounter",
    "LWWMap",
    "LWWOp",
    "ORSet",
    "PNCounter",
    "RmOp",
    "VClock",
    "canonical_bytes",
    "op_from_obj",
]
