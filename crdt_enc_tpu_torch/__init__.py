"""crdt_enc_tpu_torch: the PyTorch/CUDA port of crdt_enc_tpu.

The port sits beside the JAX package and never imports it: every host
module it needs is its own copy, and every Pallas kernel on its path is a
hand-written CUDA kernel for Hopper (``csrc/``), built on first use.

The port covers the accelerator boundary ``Core`` uses:
``TorchAccelerator.fold_ops`` for OR-Set, G-/PN-Counter and LWW-map op
batches, and ``TorchAccelerator.merge_states`` for OR-Sets.  Importing the package loads torch and
numpy only when a name below is first touched (PEP 562), so ``import
crdt_enc_tpu_torch`` stays cheap and never needs a GPU.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "TorchAccelerator": ".parallel.accel",
    "HostAccelerator": ".core.adapters",
    "ORSet": ".models.orset",
    "AddOp": ".models.orset",
    "RmOp": ".models.orset",
    "LWWMap": ".models.lwwmap",
    "LWWOp": ".models.lwwmap",
    "GCounter": ".models.counters",
    "PNCounter": ".models.counters",
    "Dot": ".models.vclock",
    "canonical_bytes": ".models.base",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
