"""Host CRDT models of the port: the OR-Set, counter and LWW-map state
types and their reference semantics, and the multi-value register the
core's remote metadata and key registers are made of (copies of the JAX
package's ``models``)."""

from .base import canonical_bytes
from .counters import NEG, POS, GCounter, PNCounter
from .lwwmap import LWWMap, LWWOp
from .mvreg import MVReg
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
    "MVReg",
    "ORSet",
    "PNCounter",
    "RmOp",
    "VClock",
    "canonical_bytes",
    "op_from_obj",
]
