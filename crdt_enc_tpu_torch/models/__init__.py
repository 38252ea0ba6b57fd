"""Host CRDT models of the port: the whole catalogue of the JAX package's
``models`` — the OR-Set, counters, LWW map and register, multi-value and
Merkle-DAG registers, G-Set, sequence list, causal map and the no-op
type — as copies with their reference semantics."""

from .base import EmptyCrdt, canonical_bytes
from .counters import NEG, POS, GCounter, PNCounter
from .crdtmap import CrdtMap
from .crdtmap import RmOp as MapRmOp
from .crdtmap import UpOp as MapUpOp
from .gset import GSet
from .lwwmap import LWWMap, LWWOp
from .lwwreg import LWWReg, LWWRegOp
from .merkle_reg import MerkleNode, MerkleReg
from .mvreg import MVReg, MVRegOp, ReadCtx
from .orset import AddOp, ORSet, RmOp, op_from_obj
from .seqlist import DelOp, InsOp, SeqList
from .vclock import Dot, VClock

__all__ = [
    "NEG",
    "POS",
    "AddOp",
    "CrdtMap",
    "DelOp",
    "Dot",
    "EmptyCrdt",
    "GCounter",
    "GSet",
    "InsOp",
    "LWWMap",
    "LWWOp",
    "LWWReg",
    "LWWRegOp",
    "MapRmOp",
    "MapUpOp",
    "MerkleNode",
    "MerkleReg",
    "MVReg",
    "MVRegOp",
    "ORSet",
    "PNCounter",
    "ReadCtx",
    "RmOp",
    "SeqList",
    "VClock",
    "canonical_bytes",
    "op_from_obj",
]
