"""One-shot importer for remotes written by the reference implementation.

The port's copy of ``crdt_enc_tpu/tools/import_reference.py``.  It takes
over a deployment of the reference (chpio/crdt-enc): reads its remote
directory layout, decrypts its op files with a supplied data key,
translates the ops, and re-seals everything in this framework's wire
format under a destination replica — a port ``Core`` folding on the card
by default — after which the reference remote can be retired.

Reference format facts this importer implements:

* op dirs are named by the actor UUID's hyphenated Display form and op
  files by version counting from **0** (crdt-enc-tokio/src/lib.rs:249-257,
  280-288; crdt-enc/src/lib.rs:697-716);
* an op file is three nested layers (crdt-enc/src/lib.rs:670-695): raw
  ``VersionBytes`` = 16-byte container UUID ‖ payload (no key id); the
  payload is the cipher envelope ``rmp_serde::to_vec_named(
  VersionBytesRef(DATA_VERSION, EncBox))``
  (crdt-enc-xchacha20poly1305/src/lib.rs:59-68) — msgpack
  ``[bin16-uuid, bin(encbox)]`` with ``encbox = {"nonce": bin24,
  "enc_data": bin}``; the cleartext is another raw VersionBytes tagged
  with the app data version around ``rmp(Vec<Op>)``;
* state snapshot files are NOT imported (the reference's own compaction
  output is unreadable by its own reader, and its example never
  compacts): any present is warned about and skipped;
* remote meta files carry the reference's key material in the external
  ``crdts`` crate's encoding, so the 32-byte data key is asked for
  explicitly.

Translation of app-defined ops is pluggable (``translator``); the
translator for the reference example's state type (``MVReg<_, Uuid>``,
examples/test/src/main.rs:12-26) ships here.  The reference's version-0
files land at version 1, and a gap in an actor's log refuses the import.

    python -m crdt_enc_tpu_torch.tools.import_reference SRC_REMOTE \\
        DEST_LOCAL DEST_REMOTE --key-hex HEX [--compact] [--device cuda]
"""

from __future__ import annotations

import logging
import os
import uuid as uuidm
from dataclasses import dataclass, field

from ..models import MVRegOp, VClock
from ..utils import codec

logger = logging.getLogger("crdt_enc_tpu_torch.import_reference")

# crdt-enc/src/lib.rs:26
REF_CONTAINER_VERSION = uuidm.UUID("e834d789-101b-4634-9823-9de990a9051f").bytes
# crdt-enc-xchacha20poly1305/src/lib.rs:11-13
REF_CIPHER_DATA_VERSION = uuidm.UUID("c7f269be-0ff5-4a77-99c3-7c23c96d5cb4").bytes
REF_KEY_VERSION = uuidm.UUID("5df28591-439a-4cef-8ca6-8433276cc9ed").bytes

KEY_LEN = 32
NONCE_LEN = 24
TAG_LEN = 16


class ReferenceFormatError(Exception):
    """The file does not parse as the reference's wire format."""


def open_reference_blob(key: bytes, raw: bytes) -> tuple[bytes, bytes]:
    """Unwrap one reference-sealed blob: outer raw VersionBytes → msgpack
    cipher envelope → XChaCha20-Poly1305 → inner raw VersionBytes.
    Returns ``(app_data_version, payload)``."""
    from ..backends import xchacha

    if len(key) != KEY_LEN:
        raise ReferenceFormatError(f"data key must be {KEY_LEN} bytes")
    raw = bytes(raw)
    if len(raw) < 16 or raw[:16] != REF_CONTAINER_VERSION:
        raise ReferenceFormatError(
            "outer container version is not the reference's "
            f"({uuidm.UUID(bytes=raw[:16]) if len(raw) >= 16 else 'short'})"
        )
    try:
        ver, enc_box_bytes = codec.unpack(raw[16:])
        ver = bytes(ver)
    except Exception as e:
        raise ReferenceFormatError(f"malformed cipher envelope: {e}") from e
    if ver != REF_CIPHER_DATA_VERSION:
        raise ReferenceFormatError(
            f"cipher envelope version {uuidm.UUID(bytes=ver)} is not the "
            "reference XChaCha backend's"
        )
    try:
        box = codec.unpack(enc_box_bytes)
        if isinstance(box, dict):  # rmp to_vec_named: {"nonce":…, "enc_data":…}
            nonce = bytes(box[b"nonce"] if b"nonce" in box else box["nonce"])
            ct = bytes(
                box[b"enc_data"] if b"enc_data" in box else box["enc_data"]
            )
        else:  # tolerate the positional (to_vec) form
            nonce, ct = bytes(box[0]), bytes(box[1])
    except Exception as e:
        raise ReferenceFormatError(f"malformed EncBox: {e}") from e
    if len(nonce) != NONCE_LEN or len(ct) < TAG_LEN:
        raise ReferenceFormatError("malformed EncBox (nonce/ct lengths)")
    # same AEAD, shared primitive: raw XChaCha20-Poly1305 open
    clear = xchacha.open_raw(key, nonce, ct)
    if len(clear) < 16:
        raise ReferenceFormatError("inner VersionBytes too short")
    return clear[:16], clear[16:]


def _vclock_from_ref(obj) -> VClock:
    """crdts ``VClock`` serde forms: ``{"dots": {actor: counter}}``
    (to_vec_named) or a bare map (tolerated)."""
    if isinstance(obj, dict) and (b"dots" in obj or "dots" in obj):
        obj = obj.get(b"dots", obj.get("dots"))
    if not isinstance(obj, dict):
        raise ReferenceFormatError(f"unrecognized VClock encoding: {obj!r}")
    return VClock({bytes(a): int(c) for a, c in obj.items()})


def mvreg_translator(payload: bytes) -> list:
    """Ops of the reference example's state type ``MVReg<V, Uuid>``
    (crdts v7 ``mvreg::Op { clock, val }``; named-map and positional
    encodings both accepted) → this framework's ``MVRegOp``."""
    ops = codec.unpack(payload)
    out = []
    for o in ops:
        if isinstance(o, dict):
            clock = o.get(b"clock", o.get("clock"))
            val = o.get(b"val", o.get("val"))
        elif isinstance(o, (list, tuple)) and len(o) == 2:
            clock, val = o
        else:
            raise ReferenceFormatError(f"unrecognized MVReg op encoding: {o!r}")
        out.append(MVRegOp(_vclock_from_ref(clock), val))
    return out


@dataclass
class ImportStats:
    actors: int = 0
    op_files: int = 0
    ops: int = 0
    skipped_states: int = 0
    skipped_metas: int = 0
    data_versions: set = field(default_factory=set)


async def import_reference_remote(
    src_remote: str | os.PathLike,
    dest,
    key: bytes,
    translator=mvreg_translator,
    compact: bool = False,
) -> ImportStats:
    """Migrate a reference-format remote into ``dest`` (an opened
    ``Core``): every source op file is decrypted, translated, re-sealed
    with the destination's wire format/keys, and written under the SAME
    source actor at version+1 (the reference counts files from 0, this
    framework from 1) — per-actor history and causal structure survive,
    so replicas joining the new remote converge exactly as they would
    have on the old one.  Ends with ``dest.read_remote()`` (and
    optionally ``compact``) so the destination state is folded.

    Returns an :class:`ImportStats`.  The source is never written to.
    """
    src = os.fspath(src_remote)
    stats = ImportStats()

    states_dir = os.path.join(src, "states")
    if os.path.isdir(states_dir):
        stats.skipped_states = len(os.listdir(states_dir))
        if stats.skipped_states:
            logger.warning(
                "skipping %d reference state file(s): the reference's own "
                "compaction output is unreadable by its own reader "
                "(SURVEY.md §3.4 defect 1)", stats.skipped_states,
            )
    meta_dir = os.path.join(src, "meta")
    if os.path.isdir(meta_dir):
        stats.skipped_metas = len(os.listdir(meta_dir))

    ops_root = os.path.join(src, "ops")
    actors: list[tuple[bytes, str]] = []
    if os.path.isdir(ops_root):
        for name in sorted(os.listdir(ops_root)):
            try:
                actors.append((uuidm.UUID(name).bytes, name))
            except ValueError:
                logger.warning("ignoring non-actor dir %r in ops/", name)
    if not actors:
        raise ReferenceFormatError(f"no reference op directories under {ops_root}")

    for actor, dirname in actors:
        stats.actors += 1
        d = os.path.join(ops_root, dirname)
        version = 0  # the reference's first op file is version 0
        while True:
            path = os.path.join(d, str(version))
            try:
                with open(path, "rb") as f:
                    raw = f.read()
            except FileNotFoundError:
                break
            data_version, payload = open_reference_blob(key, raw)
            stats.data_versions.add(data_version)
            ops = translator(payload)
            blob = await dest._seal([dest.adapter.op_to_obj(op) for op in ops])
            # +1: this framework's dense per-actor scan starts at version 1
            await dest.storage.store_ops(actor, version + 1, blob)
            stats.op_files += 1
            stats.ops += len(ops)
            version += 1
        # a gap would silently strand every file beyond it — the reference's
        # log is dense by contract, so leftovers mean corruption: fail loudly
        # rather than let the operator retire a partially-migrated source
        leftover = [
            n for n in os.listdir(d)
            if n.isdigit() and int(n) >= version
        ]
        if leftover:
            raise ReferenceFormatError(
                f"actor {dirname} has op files beyond a gap at version "
                f"{version} ({sorted(leftover, key=int)[:5]}…); the source "
                "log is not dense — refusing a partial import"
            )

    await dest.read_remote()
    if compact:
        await dest.compact()
    return stats


def main(argv=None) -> int:
    """CLI: ``python -m crdt_enc_tpu_torch.tools.import_reference
    SRC_REMOTE DEST_LOCAL DEST_REMOTE --key-hex <64 hex chars> [--compact]
    [--device cuda]``.  The destination opens with the XChaCha cryptor,
    the plain key cryptor and the MVReg adapter (the reference example's
    state type), on ``TorchAccelerator(device)``.  Exit 0; 2 usage; 1
    ``DeviceUnavailableError`` for ``--device cuda`` without a card."""
    import argparse
    import asyncio

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src_remote", help="reference remote directory (read-only)")
    ap.add_argument("dest_local", help="destination replica's local dir")
    ap.add_argument("dest_remote", help="destination remote directory")
    ap.add_argument(
        "--key-hex", required=True,
        help="the reference deployment's 32-byte data key, hex-encoded",
    )
    ap.add_argument("--compact", action="store_true",
                    help="compact the destination after import")
    ap.add_argument("--device", default="cuda",
                    help="where the destination folds: cuda (default) or cpu")
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

    async def go():
        dest = await Core.open(OpenOptions(
            storage=FsStorage(args.dest_local, args.dest_remote),
            cryptor=XChaChaCryptor(),
            key_cryptor=PlainKeyCryptor(),
            adapter=mvreg_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1,
            create=True,
            accelerator=TorchAccelerator(device),
        ))
        stats = await import_reference_remote(
            args.src_remote, dest, key, compact=args.compact
        )
        print(
            f"imported {stats.ops} ops in {stats.op_files} files from "
            f"{stats.actors} actors; skipped {stats.skipped_states} state "
            f"and {stats.skipped_metas} meta file(s)"
        )

    asyncio.run(go())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
