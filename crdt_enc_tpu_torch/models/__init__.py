"""Host CRDT models of the port: the whole catalogue of the JAX package's
``models`` — the OR-Set, counters, LWW map and register, multi-value and
Merkle-DAG registers, G-Set, sequence list, causal map and the no-op
type — as copies with their reference semantics, and ``REGISTRY``, the
type table by wire name."""

from .base import Crdt, EmptyCrdt, canonical_bytes
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
from .vclock import Actor, Dot, VClock

# Registry used by state decoders that need to resolve a CRDT type by name.
REGISTRY = {
    b"empty": EmptyCrdt,
    b"gcounter": GCounter,
    b"pncounter": PNCounter,
    b"mvreg": MVReg,
    b"orset": ORSet,
    b"lwwmap": LWWMap,
    b"gset": GSet,
    b"lwwreg": LWWReg,
    b"merklereg": MerkleReg,
    b"list": SeqList,
    b"map": CrdtMap,
}

__all__ = [
    "NEG",
    "POS",
    "REGISTRY",
    "Actor",
    "AddOp",
    "Crdt",
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
