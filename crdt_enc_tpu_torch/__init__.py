"""crdt_enc_tpu_torch: the PyTorch/CUDA port of crdt_enc_tpu.

The port sits beside the JAX package and never imports it: every host
module it needs is its own copy, and every Pallas kernel on its path is a
hand-written CUDA kernel for Hopper (``csrc/``), built on first use.

The port covers the compaction front end: ``Core`` (open, apply_ops,
read_remote, compact, and the local fold checkpoint that lets a
replica reopen warm) over the ``FsStorage`` / ``MemoryStorage``,
``XChaChaCryptor``, ``IdentityCryptor``, ``PlainKeyCryptor``,
``PassphraseKeyCryptor``, ``GpgKeyCryptor`` and ``X25519KeyCryptor``
plugins, with the native
decrypt and payload decode and the native state assembly and canonical
packer (``native/``), and the accelerator boundary ``Core`` uses:
``TorchAccelerator.fold_ops`` and ``fold_payloads`` for OR-Set (the
sparse regime included), G-/PN-Counter (and, per op, LWW-map) batches,
``fold_payloads`` and a fold session for the causal map and
``fold_payloads`` for the rest of the catalogue (the LWW and multi-value
registers on the device, the G-Set, sequence list and Merkle register on
the host), and ``TorchAccelerator.merge_states`` for OR-Sets and
multi-value registers; strong reads (``Core.read(linearizable=True)``)
and replication sampling; the multi-tenant ``FoldService``, which
compacts a fleet of small remotes in one K2 launch per bucket; and the
``FleetDaemon`` that runs it as a supervised process
(``python -m crdt_enc_tpu_torch.tools.daemon run``).
Importing the package
loads torch and numpy only when a name below is first touched (PEP 562),
so ``import crdt_enc_tpu_torch`` stays cheap and never needs a GPU.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "Core": ".core.core",
    "OpenOptions": ".core.core",
    "FsStorage": ".backends.fs",
    "MemoryRemote": ".backends.memory",
    "MemoryStorage": ".backends.memory",
    "XChaChaCryptor": ".backends.xchacha",
    "PlainKeyCryptor": ".backends.plain_keys",
    "IdentityCryptor": ".backends.identity_crypto",
    "PassphraseKeyCryptor": ".backends.passphrase_keys",
    "GpgKeyCryptor": ".backends.gpg_keys",
    "X25519KeyCryptor": ".backends.x25519_keys",
    "orset_adapter": ".core.adapters",
    "gcounter_adapter": ".core.adapters",
    "pncounter_adapter": ".core.adapters",
    "lwwmap_adapter": ".core.adapters",
    "mvreg_adapter": ".core.adapters",
    "gset_adapter": ".core.adapters",
    "lwwreg_adapter": ".core.adapters",
    "merklereg_adapter": ".core.adapters",
    "list_adapter": ".core.adapters",
    "map_adapter": ".core.adapters",
    "empty_adapter": ".core.adapters",
    "TorchAccelerator": ".parallel.accel",
    "HostAccelerator": ".core.adapters",
    "ORSet": ".models.orset",
    "AddOp": ".models.orset",
    "RmOp": ".models.orset",
    "LWWMap": ".models.lwwmap",
    "LWWOp": ".models.lwwmap",
    "GCounter": ".models.counters",
    "CrdtMap": ".models.crdtmap",
    "EmptyCrdt": ".models.base",
    "GSet": ".models.gset",
    "LWWReg": ".models.lwwreg",
    "MerkleReg": ".models.merkle_reg",
    "MVReg": ".models.mvreg",
    "SeqList": ".models.seqlist",
    "PNCounter": ".models.counters",
    "Dot": ".models.vclock",
    "canonical_bytes": ".models.base",
    "FoldService": ".serve.service",
    "ServeConfig": ".serve.service",
    "FleetDaemon": ".serve.daemon",
    "DaemonConfig": ".serve.daemon",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(mod, __name__), name)
    globals()[name] = value
    return value
