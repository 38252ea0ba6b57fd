"""Codecs folding an ``MVReg[VersionBytes]`` into one CRDT value and back.

The port's copy of ``crdt_enc_tpu/utils/mvreg_codec.py``, without the
blob transform and the tolerated-failure skip that only the asymmetric
key backends (not ported) use.

The remote metadata gives each plugin one MVReg register holding opaque
versioned blobs (reference lib.rs:745-750).  When a plugin's blob is itself
a CRDT (e.g. the Keys CRDT), concurrent register values must be *decoded and
merged*, not tie-broken: version-check each blob, msgpack-decode, then
CvRDT-merge all of them (reference utils/mod.rs:37-126).  Writing back
encodes the merged value under the writer's add-context so it supersedes
everything it saw (mod.rs:128-163).
"""

from __future__ import annotations

from typing import Iterable

from . import codec
from .version_bytes import VersionBytes


def decode_version_bytes_mvreg(mvreg, supported_versions: Iterable[bytes], crdt_cls):
    """Fold all concurrent register values into one ``crdt_cls`` instance.
    Returns None if the register is empty."""
    merged = None
    for obj in mvreg.read().values:
        vb = VersionBytes.from_obj(obj).ensure_versions(supported_versions)
        value = crdt_cls.from_obj(codec.unpack(vb.content))
        if merged is None:
            merged = value
        else:
            merged.merge(value)
    return merged


def encode_version_bytes_mvreg(mvreg, value, actor: bytes, version: bytes) -> None:
    """Write ``value`` (a CRDT) into the register, superseding every value
    the current read observes (derived add-context, mod.rs:128-163)."""
    vb = VersionBytes(version, codec.pack(value.to_obj()))
    mvreg.apply(mvreg.write_ctx(actor, vb.to_obj()))
