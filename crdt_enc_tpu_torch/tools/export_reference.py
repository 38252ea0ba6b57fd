"""One-shot exporter to the reference implementation's remote format.

The port's copy of ``crdt_enc_tpu/tools/export_reference.py``, the
inverse of :mod:`.import_reference`: takes a replica of this framework —
a port ``Core``, folding on the card by default — and writes a remote
directory the reference (chpio/crdt-enc) reads, for migrating back or
feeding a mixed deployment during a staged migration.  Layer-exact to
the importer's citations: op dirs named by the actor UUID's Display form
with files from version **0** (crdt-enc-tokio/src/lib.rs:249-257); three
nested layers with no key id in the outer one
(crdt-enc/src/lib.rs:670-695); the msgpack ``EncBox`` cipher envelope
(crdt-enc-xchacha20poly1305/src/lib.rs:59-68).

Two modes:

* **state** (default) — fold the source replica (``read_remote``), then
  write its state as ONE synthetic op file under a fresh export actor.
  Correct whatever the source compacted away.
* **log** — translate the per-actor op logs 1:1 (our version N file →
  reference version N-1), keeping actor attribution and causal history.
  Refused when the source has compacted (a state snapshot exists) or a
  log does not start at version 1 or has a gap.

The tool writes no reference ``meta`` files: the operator supplies the
32-byte data key here and configures the same key on the reference side.

    python -m crdt_enc_tpu_torch.tools.export_reference SRC_LOCAL \\
        SRC_REMOTE DEST_REF_REMOTE --key-hex HEX --data-version-uuid UUID \\
        [--mode state|log] [--device cuda]
"""

from __future__ import annotations

import logging
import os
import secrets
import uuid as uuidm
from dataclasses import dataclass, field

from ..models import MVReg, MVRegOp
from ..utils import codec
from .import_reference import (
    KEY_LEN,
    NONCE_LEN,
    REF_CIPHER_DATA_VERSION,
    REF_CONTAINER_VERSION,
    ReferenceFormatError,
)

logger = logging.getLogger("crdt_enc_tpu_torch.export_reference")


def seal_reference_blob(key: bytes, payload: bytes, data_version: bytes) -> bytes:
    """Seal ``payload`` exactly as the reference writes an op file: inner
    raw ``VersionBytes(data_version)`` → XChaCha20-Poly1305 → named-map
    ``EncBox`` → msgpack cipher envelope → outer raw ``VersionBytes``
    with the reference container version (and no key id)."""
    from ..backends import xchacha

    if len(key) != KEY_LEN:
        raise ReferenceFormatError(f"data key must be {KEY_LEN} bytes")
    if len(data_version) != 16:
        raise ReferenceFormatError("app data version must be a 16-byte UUID")
    inner = bytes(data_version) + bytes(payload)
    nonce = secrets.token_bytes(NONCE_LEN)
    enc_box = codec.pack(
        {"nonce": nonce, "enc_data": xchacha.seal_raw(key, nonce, inner)}
    )
    middle = codec.pack([REF_CIPHER_DATA_VERSION, enc_box])
    return REF_CONTAINER_VERSION + middle


def _ref_vclock(clock) -> dict:
    """crdts ``VClock`` named-map serde form: ``{"dots": {bin16: u64}}``."""
    return {"dots": {bytes(a): int(c) for a, c in clock.counters.items()}}


def mvreg_op_untranslator(op: MVRegOp):
    """``MVRegOp`` → the crdts v7 ``mvreg::Op { clock, val }`` named-map
    encoding (the exact form :func:`import_reference.mvreg_translator`
    parses back)."""
    return {"clock": _ref_vclock(op.clock), "val": op.value}


def mvreg_state_untranslator(state: MVReg) -> list:
    """An MVReg state is exactly its surviving ``(clock, value)`` pairs;
    each is a valid ``mvreg::Op`` — applying them all reconstructs the
    state on any replica."""
    return [
        {"clock": _ref_vclock(c), "val": v} for c, v in state.vals
    ]


@dataclass
class ExportStats:
    actors: int = 0
    op_files: int = 0
    ops: int = 0
    mode: str = "state"
    export_actor: bytes | None = None
    data_version: bytes = b""
    skipped: list = field(default_factory=list)


def _write_ref_op_file(
    dest_remote: str, actor: bytes, ref_version: int, blob: bytes
) -> None:
    d = os.path.join(dest_remote, "ops", str(uuidm.UUID(bytes=actor)))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, str(ref_version))
    # the reference's own create_new discipline: immutable files, no
    # silent overwrite (crdt-enc-tokio lib.rs:326-346)
    with open(path, "xb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())


async def export_reference_state(
    src,
    dest_remote: str | os.PathLike,
    key: bytes,
    data_version: bytes,
    state_untranslator=mvreg_state_untranslator,
    export_actor: bytes | None = None,
) -> ExportStats:
    """Fold the source replica and write its state as ONE synthetic op
    file under a fresh export actor (reference version 0).  ``src`` is an
    opened ``Core``; the source remote is never written to."""
    dest = os.fspath(dest_remote)
    await src.read_remote()
    ref_ops = src.with_state(state_untranslator)
    actor = export_actor if export_actor is not None else uuidm.uuid4().bytes
    stats = ExportStats(
        mode="state", export_actor=actor, data_version=bytes(data_version)
    )
    if not ref_ops:
        logger.warning("source state is empty; nothing exported")
        return stats
    blob = seal_reference_blob(key, codec.pack(ref_ops), data_version)
    _write_ref_op_file(dest, actor, 0, blob)
    stats.actors = 1
    stats.op_files = 1
    stats.ops = len(ref_ops)
    return stats


async def export_reference_log(
    src,
    dest_remote: str | os.PathLike,
    key: bytes,
    data_version: bytes,
    op_untranslator=mvreg_op_untranslator,
) -> ExportStats:
    """Translate the source remote's per-actor op logs 1:1 into reference
    layout (our dense-from-1 versions → the reference's dense-from-0).

    Refuses a compacted source: a state snapshot's history has no op-file
    form, and a GC'd log starting beyond version 1 would be invisible to
    the reference's from-0 scan — silent data loss, so fail loudly and
    point at state mode.
    """
    dest = os.fspath(dest_remote)
    stats = ExportStats(mode="log", data_version=bytes(data_version))

    state_names = await src.storage.list_state_names()
    if state_names:
        raise ReferenceFormatError(
            f"source remote holds {len(state_names)} state snapshot(s); "
            "compacted history has no reference op-file form — "
            "use state mode"
        )
    actors = await src.storage.list_op_actors()
    if not actors:
        raise ReferenceFormatError("source remote has no op logs to export")
    from .fsck import _list_op_versions

    for actor in sorted(actors):
        files = await src.storage.load_ops([(actor, 1)])
        if not files:
            raise ReferenceFormatError(
                f"actor {actor.hex()}'s log does not start at version 1 "
                "(GC'd prefix?): the reference's dense from-0 scan would "
                "see none of it — use state mode"
            )
        # a mid-log hole with files beyond it would silently truncate the
        # export (load_ops scans densely and stops at the hole) — refuse,
        # exactly as the importer refuses a gapped source
        versions = await _list_op_versions(src.storage, actor)
        if versions is not None and len(versions) > len(files):
            raise ReferenceFormatError(
                f"actor {actor.hex()}'s log has a gap at version "
                f"{files[-1][1] + 1} with {len(versions) - len(files)} "
                "file(s) stranded beyond it — refusing a partial export "
                "(run tools.fsck for the damage report)"
            )
        stats.actors += 1
        for _, version, raw in files:
            # same tool↔core pairing the importer uses with dest._seal:
            # the shared wire contract lives in core.open_sealed_blob
            objs = await src._open_sealed(raw)
            ops = [src.adapter.op_from_obj(o) for o in objs]
            payload = codec.pack([op_untranslator(op) for op in ops])
            blob = seal_reference_blob(key, payload, data_version)
            _write_ref_op_file(dest, actor, version - 1, blob)
            stats.op_files += 1
            stats.ops += len(ops)
    return stats


def main(argv=None) -> int:
    """CLI: ``python -m crdt_enc_tpu_torch.tools.export_reference SRC_LOCAL
    SRC_REMOTE DEST_REF_REMOTE --key-hex <64 hex> --data-version-uuid
    <uuid> [--mode state|log] [--device cuda]``.  The source opens with
    the XChaCha cryptor, the plain key cryptor and the MVReg adapter (the
    reference example's state type) on ``TorchAccelerator(device)``;
    other deployments drive the async API with their own adapter and
    untranslators.  Exit 0; 2 usage; 1 ``DeviceUnavailableError`` for
    ``--device cuda`` without a card."""
    import argparse
    import asyncio

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src_local", help="source replica's local dir")
    ap.add_argument("src_remote", help="source remote directory (read-only)")
    ap.add_argument("dest_remote", help="reference remote directory to create")
    ap.add_argument(
        "--key-hex", required=True,
        help="32-byte data key for the reference deployment, hex-encoded",
    )
    ap.add_argument(
        "--data-version-uuid", required=True,
        help="app data version UUID the reference deployment expects "
        "(its OpenOptions.supported_data_versions)",
    )
    ap.add_argument("--mode", choices=("state", "log"), default="state")
    ap.add_argument("--device", default="cuda",
                    help="where the source folds: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from .daemon import device_or_exit

    device, rc = device_or_exit(args.device)
    if device is None:
        return rc

    from ..backends import FsStorage, PlainKeyCryptor, XChaChaCryptor
    from ..core.adapters import mvreg_adapter
    from ..core.core import Core, OpenOptions
    from ..parallel.accel import TorchAccelerator
    from ..utils.versions import DEFAULT_DATA_VERSION_1

    key = bytes.fromhex(args.key_hex)
    data_version = uuidm.UUID(args.data_version_uuid).bytes

    async def go():
        src = await Core.open(OpenOptions(
            storage=FsStorage(args.src_local, args.src_remote),
            cryptor=XChaChaCryptor(),
            key_cryptor=PlainKeyCryptor(),
            adapter=mvreg_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1,
            create=False,
            accelerator=TorchAccelerator(device),
        ))
        if args.mode == "state":
            stats = await export_reference_state(
                src, args.dest_remote, key, data_version
            )
        else:
            stats = await export_reference_log(
                src, args.dest_remote, key, data_version
            )
        print(
            f"exported {stats.ops} ops in {stats.op_files} files "
            f"({stats.mode} mode, {stats.actors} actor(s))"
        )

    asyncio.run(go())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
