"""CRDT-type adapters and the host accelerator.

The port's copy of ``HostAccelerator`` and the OR-Set, counter and LWW-map
adapters from ``crdt_enc_tpu/core/adapters.py``.  An adapter bundles how the core
(de)serializes a state type and its ops; the *accelerator* is the
pluggable execution backend for the two hot paths (per-op fold and state
merge).  ``HostAccelerator`` is the plain loop; ``TorchAccelerator``
(crdt_enc_tpu_torch/parallel/accel.py) batches onto the CUDA kernels.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from ..models.counters import GCounter, PNCounter
from ..models.lwwmap import LWWMap, LWWOp
from ..models.orset import ORSet
from ..models.orset import op_from_obj as orset_op_from_obj
from ..models.vclock import Dot


class HostAccelerator:
    """Reference execution: sequential host loops (the thing the device
    path replaces)."""

    def fold_ops(self, state, ops: list):
        for op in ops:
            state.apply(op)
        return state

    def merge_states(self, state, others: list):
        for other in others:
            state.merge(other)
        return state

    def fold_payloads(self, state, payloads: list, actors_hint=()) -> bool:
        """Fold raw decrypted op-file payloads without per-op Python
        objects.  Returns True if handled; False tells the caller to decode
        and use ``fold_ops`` (the host reference always declines)."""
        return False


@dataclass
class CrdtAdapter:
    name: bytes
    new: Callable[[], object]
    state_to_obj: Callable = field(default=lambda s: s.to_obj())
    state_from_obj: Callable = None  # type: ignore[assignment]
    op_to_obj: Callable = field(default=lambda op: op.to_obj())
    op_from_obj: Callable = field(default=lambda obj: obj)


def gcounter_adapter() -> CrdtAdapter:
    return CrdtAdapter(
        name=b"gcounter",
        new=GCounter,
        state_from_obj=GCounter.from_obj,
        op_from_obj=Dot.from_obj,
    )


def pncounter_adapter() -> CrdtAdapter:
    return CrdtAdapter(
        name=b"pncounter",
        new=PNCounter,
        state_from_obj=PNCounter.from_obj,
        op_to_obj=lambda op: [op[0], op[1].to_obj()],
        op_from_obj=lambda obj: (int(obj[0]), Dot.from_obj(obj[1])),
    )


def orset_adapter() -> CrdtAdapter:
    return CrdtAdapter(
        name=b"orset",
        new=ORSet,
        state_from_obj=ORSet.from_obj,
        op_from_obj=orset_op_from_obj,
    )


def lwwmap_adapter() -> CrdtAdapter:
    return CrdtAdapter(
        name=b"lwwmap",
        new=LWWMap,
        state_from_obj=LWWMap.from_obj,
        op_from_obj=LWWOp.from_obj,
    )
