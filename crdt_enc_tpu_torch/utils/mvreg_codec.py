"""Codecs folding an ``MVReg[VersionBytes]`` into one CRDT value and back.

The port's copy of ``crdt_enc_tpu/utils/mvreg_codec.py``.

The remote metadata gives each plugin one MVReg register holding opaque
versioned blobs (reference lib.rs:745-750).  When a plugin's blob is itself
a CRDT (e.g. the Keys CRDT), concurrent register values must be *decoded and
merged*, not tie-broken: version-check each blob, optionally transform
(decrypt), decode, then CvRDT-merge all of them (reference
utils/mod.rs:37-126).  Writing back encodes the merged value under the
writer's add-context so it supersedes everything it saw (mod.rs:128-163).
"""

from __future__ import annotations

import inspect
import logging
from typing import Awaitable, Callable, Iterable

from . import codec
from .version_bytes import VersionBytes

logger = logging.getLogger("crdt_enc_tpu_torch.mvreg_codec")


async def _maybe_await(x):
    if inspect.isawaitable(x):
        return await x
    return x


async def decode_version_bytes_mvreg(
    mvreg,
    supported_versions: Iterable[bytes],
    crdt_cls,
    transform: Callable[[VersionBytes], bytes | Awaitable[bytes]] | None = None,
    tolerate: tuple = (),
):
    """Fold all concurrent register values into one ``crdt_cls`` instance.

    ``transform`` maps the version-checked blob to cleartext (e.g.
    decrypt); the default takes the content as it is.  Returns None if the
    register is empty.

    ``tolerate``: exception types from ``transform`` that skip just that
    value (e.g. a concurrent blob sealed to a recipient set this replica
    is not in).  If EVERY value fails, the first error propagates — an
    entirely unreadable register must stay loud.
    """
    values = mvreg.read().values
    if not values:
        return None
    merged = None
    first_err = None
    for obj in values:
        vb = VersionBytes.from_obj(obj).ensure_versions(supported_versions)
        try:
            raw = await _maybe_await(transform(vb)) if transform else vb.content
        except tolerate as e:
            # visible, not fatal: could be a stale concurrent writer — or a
            # forgery attempt by whoever controls the storage
            logger.warning("skipping unreadable register value: %s", e)
            if first_err is None:
                first_err = e
            continue
        value = crdt_cls.from_obj(codec.unpack(raw))
        if merged is None:
            merged = value
        else:
            merged.merge(value)
    if merged is None and first_err is not None:
        raise first_err
    return merged


async def encode_version_bytes_mvreg(
    mvreg,
    value,
    actor: bytes,
    version: bytes,
    transform: Callable[[bytes], bytes | Awaitable[bytes]] | None = None,
) -> None:
    """Write ``value`` (a CRDT) into the register, superseding every value
    the current read observes (derived add-context, mod.rs:128-163)."""
    raw = codec.pack(value.to_obj())
    if transform:
        raw = await _maybe_await(transform(raw))
    vb = VersionBytes(version, raw)
    mvreg.apply(mvreg.write_ctx(actor, vb.to_obj()))
