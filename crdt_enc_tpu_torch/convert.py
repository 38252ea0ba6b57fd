"""Carry state across from the JAX package.

The port never imports ``crdt_enc_tpu``; what crosses between the two
packages is plain Python objects and numpy arrays:

* ``orset_from_reference_obj`` builds the port's ``ORSet`` from the
  output of the JAX package's ``ORSet.to_obj()`` (``{b"c": clock,
  b"e": entries, b"d": deferred}``), keeping member and actor objects as
  they are;
* ``lwwmap_from_reference_obj``, ``gcounter_from_reference_obj`` and
  ``pncounter_from_reference_obj`` do the same for ``LWWMap``
  (``{key: [ts, actor, value, tombstone]}``), ``GCounter`` (``{actor:
  counter}``) and ``PNCounter`` (``[p, n]``);
* ``mvreg_``, ``gset_``, ``lwwreg_``, ``merklereg_``, ``seqlist_``,
  ``crdtmap_`` and ``empty_from_reference_obj`` do the same for the rest
  of the catalogue: ``MVReg`` (``[[clock, value], ...]``), ``GSet``
  (members in canonical order), ``LWWReg`` (``[ts, actor, value]`` or
  ``None``), ``MerkleReg`` (``[[parents, value], ...]``), ``SeqList``
  (``[[ident, value] | [ident], ...]``), ``CrdtMap`` (``[child, clock,
  entries, deferred]``) and ``EmptyCrdt`` (``None``);
* ``planes_from_numpy`` / ``planes_to_numpy`` move int32 state planes
  ``(clock (R,), add (E, R), rm (E, R))`` between numpy and torch.
"""

from __future__ import annotations

import numpy as np
import torch

from .models import (
    CrdtMap,
    EmptyCrdt,
    GCounter,
    GSet,
    LWWMap,
    LWWReg,
    MerkleReg,
    MVReg,
    ORSet,
    PNCounter,
    SeqList,
    VClock,
)


def orset_from_reference_obj(obj) -> ORSet:
    s = ORSet()
    if obj is None:
        return s
    s.clock = VClock({a: int(c) for a, c in (obj.get(b"c") or {}).items()})
    s.entries = {
        m: {r: int(c) for r, c in v.items()}
        for m, v in (obj.get(b"e") or {}).items()
        if v
    }
    s.deferred = {
        m: {r: int(c) for r, c in v.items()}
        for m, v in (obj.get(b"d") or {}).items()
        if v
    }
    return s


def lwwmap_from_reference_obj(obj) -> LWWMap:
    return LWWMap.from_obj(obj)


def gcounter_from_reference_obj(obj) -> GCounter:
    return GCounter.from_obj(obj)


def pncounter_from_reference_obj(obj) -> PNCounter:
    return PNCounter.from_obj(obj)


def mvreg_from_reference_obj(obj) -> MVReg:
    return MVReg.from_obj(obj)


def gset_from_reference_obj(obj) -> GSet:
    return GSet.from_obj(obj)


def lwwreg_from_reference_obj(obj) -> LWWReg:
    return LWWReg.from_obj(obj)


def merklereg_from_reference_obj(obj) -> MerkleReg:
    return MerkleReg.from_obj(obj)


def seqlist_from_reference_obj(obj) -> SeqList:
    return SeqList.from_obj(obj)


def crdtmap_from_reference_obj(obj) -> CrdtMap:
    return CrdtMap.from_obj(obj)


def empty_from_reference_obj(obj) -> EmptyCrdt:
    return EmptyCrdt.from_obj(obj)


def planes_from_numpy(clock, add, rm, *, device) -> tuple:
    """int32 numpy planes → int32 tensors on ``device``."""
    return tuple(
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.int32)).to(device)
        for x in (clock, add, rm)
    )


def planes_to_numpy(clock, add, rm) -> tuple:
    """int32 tensors (any device) → int32 numpy planes."""
    return tuple(
        x.detach().to("cpu", torch.int32).numpy() for x in (clock, add, rm)
    )
