"""Canonical serialization of CRDT states.

A copy of ``canonical_bytes`` from ``crdt_enc_tpu/models/base.py``: every
state type's ``to_obj()`` emits a canonical (sorted, normalized) object,
so its packed bytes are deterministic whatever the op arrival order —
which is what makes "byte-identical device result" a meaningful test.
"""

from __future__ import annotations

from ..utils import codec


def canonical_bytes(state) -> bytes:
    return codec.pack(state.to_obj())
