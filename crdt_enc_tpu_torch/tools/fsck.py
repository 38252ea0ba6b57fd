"""Remote integrity checker — failure detection for the synced directory.

The port's copy of ``crdt_enc_tpu/tools/fsck.py``; it reads remotes
written by either package.  fsck does no device work, so it takes no
device.

The replication substrate is a passively synced directory written by many
replicas; the failure modes that matter are
sync-tool damage and bit rot: torn/truncated blobs, tampered ciphertext,
content-addressed files whose name no longer matches their bytes, op-log
gaps that stall every consumer's dense scan, and key metadata that no
longer decodes.  The crash-safety ORDERING is by construction
(write-new-before-delete-old); this tool detects what ordering cannot
prevent.

``fsck_remote`` walks one remote through the SAME plugin stack a replica
uses (storage + cryptor + key cryptor), verifies every object family, and
returns a structured report; the CLI prints it.  Read-only — never
repairs, because the right repair is re-sync or restore of immutable
content-addressed files.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..backends.memory import content_name
from ..core.core import RemoteMeta, snapshot_sealer
from ..core.key_cryptor import Keys
from ..core.core import open_sealed_blob
from ..utils import codec, trace
from ..utils.version_bytes import VersionBytes
from ..utils.versions import SUPPORTED_CONTAINER_VERSIONS


@dataclass
class Issue:
    severity: str  # "error" | "warn"
    family: str  # "meta" | "states" | "ops" | "keys"
    obj: str  # file name / actor:version
    problem: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.family} {self.obj}: {self.problem}"


@dataclass
class FsckReport:
    meta_files: int = 0
    state_files: int = 0
    op_files: int = 0
    op_actors: int = 0
    ops_decoded: int = 0
    delta_files: int = 0
    keys_found: int = 0
    issues: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(i.severity == "error" for i in self.issues)

    def add(self, severity, family, obj, problem):
        self.issues.append(Issue(severity, family, obj, problem))

    def summary(self) -> str:
        errors = sum(1 for i in self.issues if i.severity == "error")
        warns = len(self.issues) - errors
        deltas = f", {self.delta_files} deltas" if self.delta_files else ""
        return (
            f"{'OK' if self.ok else 'DAMAGED'}: {self.meta_files} meta, "
            f"{self.state_files} states, {self.op_files} op files across "
            f"{self.op_actors} actors ({self.ops_decoded} ops){deltas}, "
            f"{self.keys_found} data keys; {errors} error(s), {warns} warning(s)"
        )


class _KeyCollector:
    """Just enough CoreSubHandle surface for a key cryptor — collects the
    decoded key set; never writes the remote.  Shared by ``fsck_remote``
    and ``verify_checkpoint``."""

    actor_id = b"\x00" * 16

    def __init__(self):
        self.keys = Keys()

    def set_keys(self, keys):
        self.keys = keys

    async def set_remote_meta_key_cryptor(self, reg):
        pass  # read-only: never write the remote


async def fsck_remote(storage, cryptor, key_cryptor, *, deep: bool = True) -> FsckReport:
    """Verify one remote.  ``deep=True`` additionally decrypts every state
    and op file (auth check) and parses the cleartext framing; ``False``
    checks structure and names only.

    The key cryptor receives the remote's converged key register exactly
    as a replica would (``set_remote_meta``); decrypting then uses a core
    stub that only collects keys — no replica state is created anywhere.
    """
    report = FsckReport()

    collector = _KeyCollector()
    await key_cryptor.init(collector)

    # ---- meta family -----------------------------------------------------
    meta = RemoteMeta()
    with trace.span("fsck.meta"):
        names = await storage.list_remote_meta_names()
        loaded = dict(await storage.load_remote_metas(names))
    for name in names:
        raw = loaded.get(name)
        if raw is None:
            report.add("warn", "meta", name, "listed but unreadable (racing GC?)")
            continue
        report.meta_files += 1
        if content_name(raw) != name:
            report.add("error", "meta", name, "content does not match its address")
            continue
        try:
            vb = VersionBytes.deserialize(raw).ensure_versions(
                SUPPORTED_CONTAINER_VERSIONS
            )
            meta.merge(RemoteMeta.from_obj(codec.unpack(vb.content)))
        except Exception as e:
            report.add("error", "meta", name, f"malformed: {e}")
    try:
        await key_cryptor.set_remote_meta(meta.key_cryptor)
    except Exception as e:
        report.add("error", "keys", "register", f"key metadata does not decode: {e}")
    keys = collector.keys
    report.keys_found = len(keys.keys.entries)
    latest_ok = False
    try:
        latest_ok = keys.latest_key() is not None
    except Exception as e:  # e.g. DanglingLatestKey: id survives, material lost
        report.add("error", "keys", "latest", f"latest key unresolvable: {e}")
        latest_ok = True  # already reported — not also "no resolvable key"

    async def open_sealed(raw: bytes):
        # the shared wire-contract implementation (core.open_sealed_blob);
        # the app's inner data-version set is unknown here, so that one
        # check is skipped
        return await open_sealed_blob(keys, cryptor, raw)

    # ---- states ----------------------------------------------------------
    with trace.span("fsck.states"):
        names = await storage.list_state_names()
        loaded = dict(await storage.load_states(names))
        for name in names:
            raw = loaded.get(name)
            if raw is None:
                report.add(
                    "warn", "states", name, "listed but unreadable (racing GC?)"
                )
                continue
            report.state_files += 1
            if content_name(raw) != name:
                report.add(
                    "error", "states", name, "content does not match its address"
                )
                continue
            if not deep:
                continue
            try:
                obj = await open_sealed(raw)
                # [state, cursor] or [state, cursor, sealer] — the
                # replication-obs layer appends the sealing replica's
                # actor id (StateWrapper's wire note in core/core.py)
                if not (isinstance(obj, (list, tuple)) and len(obj) in (2, 3)):
                    raise ValueError(
                        "state wrapper is not [state, cursor(, sealer)]"
                    )
                # same wire rule core ingest applies — but where core
                # silently drops a malformed sealer, fsck reports it
                if len(obj) == 3 and obj[2] and snapshot_sealer(obj) is None:
                    raise ValueError("snapshot sealer id is not 16 bytes")
            except Exception as e:
                report.add("error", "states", name, f"{e}")

    # ---- op logs ---------------------------------------------------------
    with trace.span("fsck.ops"):
        actors = await storage.list_op_actors()
        report.op_actors = len(actors)
        for actor in actors:
            hexa = actor.hex()
            versions = await _list_op_versions(storage, actor)
            if versions is None:
                report.add(
                    "warn", "ops", hexa,
                    "storage backend cannot enumerate op versions; "
                    "gap detection skipped",
                )
                if deep:
                    files = await storage.load_ops([(actor, 1)])
                    report.op_files += len(files)
                    await _deep_check_ops(report, open_sealed, hexa, files)
                continue
            report.op_files += len(versions)
            if not versions:
                continue
            # dense from the FLOOR — compaction legitimately GCs a prefix,
            # so a log starting at N+1 is healthy; only holes with files
            # beyond them strand data (every consumer's scan stops at the
            # hole)
            floor = versions[0]
            expected = set(range(floor, floor + len(versions)))
            missing = sorted(expected - set(versions))
            if missing:
                report.add(
                    "error", "ops", hexa,
                    f"gap at version {missing[0]}: "
                    f"{sum(1 for v in versions if v > missing[0])} file(s) "
                    "beyond it are unreachable by the dense scan",
                )
            if deep:
                files = await storage.load_ops([(actor, floor)])
                await _deep_check_ops(report, open_sealed, hexa, files)
    # ---- delta snapshots -------------------------------------------------
    await _check_deltas(report, storage, open_sealed, deep=deep)

    trace.add("fsck_ops_decoded", report.ops_decoded)
    if not latest_ok and (
        report.meta_files or report.keys_found
        or report.state_files or report.op_files
    ):
        report.add(
            "error", "keys", "latest",
            "no resolvable latest data key (key metadata lost?)",
        )
    return report


def _adapter_for_name(name: bytes):
    """Adapter instance for a delta payload's adapter name, or None —
    the refold check is skipped for types this build cannot decode."""
    key = bytes(name).decode(errors="replace")
    if key == "rcounter":
        from ..delta.compose import rcounter_adapter

        return rcounter_adapter()
    ctor = ADAPTERS.get(key)
    if ctor is None:
        return None
    from ..core import adapters as _adapters

    return getattr(_adapters, ctor)()


async def _check_deltas(report, storage, open_sealed, *, deep: bool) -> None:
    """Validate the delta file family:

    * **broken chains** — interior version gaps in a sealer's log
      (logs are append-only and GC removes only prefixes, so a hole
      with links beyond it is damage), and payloads missing the base
      watermark / cursors / names (malformed) — error rows;
    * **orphan deltas** — a link filed under one sealer's log whose
      payload names a different sealer: misfiled by the sync tool,
      unusable and misleading — error row;
    * **delta-vs-refold byte divergence** — whenever BOTH endpoint
      snapshots are still present, the base state + delta must refold
      byte-identically to the target snapshot's state — error row;
    * anchoring looseness is WARNED, not failed: a link's base may
      legitimately be an *earlier* anchor than its predecessor's
      target (a stale-checkpoint reopen re-anchors the chain), and a
      chain head may target a snapshot a superseding compactor GC'd —
      consumers holding the base name still apply such links, everyone
      else falls back.
    """
    if not getattr(storage, "has_deltas", False):
        return
    from ..delta import codec_for, wire

    with trace.span("fsck.deltas"):
        try:
            actors = await storage.list_delta_actors()
        except Exception as e:
            report.add("error", "deltas", "listing", f"unlistable: {e}")
            return
        state_names = set(await storage.list_state_names())
        for actor in actors:
            hexa = actor.hex()
            versions = await _list_delta_versions(storage, actor)
            if versions is None:
                report.add(
                    "warn", "deltas", hexa,
                    "storage backend cannot enumerate delta versions; "
                    "gap detection skipped",
                )
                versions = []
            if versions:
                floor = versions[0]
                expected = set(range(floor, floor + len(versions)))
                missing = sorted(expected - set(versions))
                if missing:
                    report.add(
                        "error", "deltas", hexa,
                        f"broken chain: gap at version {missing[0]} "
                        "(GC removes only prefixes — an interior hole "
                        "is damage)",
                    )
            if not deep:
                report.delta_files += len(versions)
                continue
            files = await storage.load_deltas([(actor, 1)])
            report.delta_files += len(files)
            records: list[tuple] = []  # (version, record) that parsed
            for _, version, raw in files:
                try:
                    obj = await open_sealed(raw)
                    rec = wire.parse_delta_obj(obj)
                except Exception as e:
                    report.add(
                        "error", "deltas", f"{hexa}:{version}", f"{e}"
                    )
                    continue
                if rec.sealer != actor:
                    report.add(
                        "error", "deltas", f"{hexa}:{version}",
                        "orphan delta: payload sealer "
                        f"{rec.sealer.hex()} does not own this log",
                    )
                    continue
                records.append((version, rec))
            # base anchoring: a link need not chain from its IMMEDIATE
            # predecessor (a stale-checkpoint reopen legitimately
            # re-anchors at an earlier own snapshot), but its base must
            # resolve SOMEWHERE — an earlier link's target or a listed
            # state.  Unresolvable is a warning (the anchor may have
            # been GC'd after consumers learned it), never silent.
            targets = {rec.new_name for _, rec in records}
            for version, rec in records:
                if (
                    rec.base_name not in targets
                    and rec.base_name not in state_names
                    and records[0][0] != version  # oldest link's base
                    # is routinely a GC'd predecessor target
                ):
                    report.add(
                        "warn", "deltas", f"{hexa}:{version}",
                        f"unanchored chain link: base "
                        f"{rec.base_name[:16]}… resolves to no listed "
                        "snapshot or log target",
                    )
                if rec.base_name in state_names and rec.new_name in state_names:
                    await _check_delta_refold(
                        report, storage, open_sealed, hexa, version, rec,
                        codec_for(rec.adapter),
                    )
            if records and records[-1][1].new_name not in state_names:
                report.add(
                    "warn", "deltas", f"{hexa}:{records[-1][0]}",
                    "chain head targets a GC'd snapshot; consumers "
                    "holding the base still apply it, everyone else "
                    "falls back",
                )


async def _check_delta_refold(
    report, storage, open_sealed, hexa, version, rec, codec_cls
) -> None:
    adapter = _adapter_for_name(rec.adapter)
    if adapter is None or codec_cls is None:
        report.add(
            "warn", "deltas", f"{hexa}:{version}",
            f"adapter {rec.adapter!r} unknown here; refold check skipped",
        )
        return
    loaded = dict(await storage.load_states([rec.base_name, rec.new_name]))
    if len(loaded) < 2:
        return  # racing GC; both were listed a moment ago
    try:
        base_obj = await open_sealed(loaded[rec.base_name])
        new_obj = await open_sealed(loaded[rec.new_name])
        base_state = adapter.state_from_obj(base_obj[0])
        codec_cls.apply(base_state, rec.delta_obj)
        refolded = codec.pack(adapter.state_to_obj(base_state))
        target = codec.pack(adapter.state_to_obj(
            adapter.state_from_obj(new_obj[0])
        ))
    except Exception as e:
        report.add(
            "error", "deltas", f"{hexa}:{version}", f"refold failed: {e}"
        )
        return
    if refolded != target:
        report.add(
            "error", "deltas", f"{hexa}:{version}",
            f"delta-vs-refold divergence: base+delta ({len(refolded)}B "
            f"canonical) != target snapshot ({len(target)}B canonical)",
        )


async def _list_delta_versions(storage, actor) -> list[int] | None:
    """Sorted delta versions for one sealer without reading bytes, or
    None when the backend cannot enumerate them."""
    deltas_dir = getattr(storage, "_deltas_dir", None)
    if deltas_dir is not None:
        import os

        try:
            names = os.listdir(deltas_dir(actor))
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit())
    table = getattr(storage, "remote", None)
    deltas = getattr(table, "deltas", None)
    if isinstance(deltas, dict):  # MemoryRemote: {actor: {version: bytes}}
        return sorted(int(v) for v in deltas.get(actor, {}))
    return None


async def _deep_check_ops(report, open_sealed, hexa: str, files: list) -> None:
    for _, version, raw in files:
        try:
            ops = await open_sealed(raw)
            if not isinstance(ops, (list, tuple)):
                raise ValueError("op payload is not an array")
            report.ops_decoded += len(ops)
        except Exception as e:
            report.add("error", "ops", f"{hexa}:{version}", f"{e}")


async def verify_checkpoint(
    local_storage, storage, cryptor, key_cryptor, *, adapter=None
) -> FsckReport:
    """Verify a replica's local fold checkpoint against its remote: load
    and decrypt the checkpoint, then REFOLD the remote (state snapshots
    whose cursors it covers, plus op files up to the checkpoint cursor —
    the same ingestion order a cold open runs) and byte-compare the two
    canonical serializations.  Divergence is an error row (non-zero CLI
    exit); a remote whose op logs no longer reach the cursor reports the
    refold as unverifiable (warn) rather than passing silently.

    ``adapter`` decodes generic-format checkpoints and replayed ops
    (default: the OR-Set adapter)."""
    from ..core.adapters import orset_adapter
    from ..core.core import unpack_checkpoint_state
    from ..models.vclock import VClock

    if adapter is None:
        adapter = orset_adapter()
    report = FsckReport()
    raw = await local_storage.load_local_checkpoint()
    if raw is None:
        report.add(
            "warn", "checkpoint", "local", "no local checkpoint to verify"
        )
        return report

    # keys from the remote's converged metadata, exactly as a replica
    # would read them (the same collector stub fsck_remote uses)
    collector = _KeyCollector()
    await key_cryptor.init(collector)
    meta = RemoteMeta()
    names = await storage.list_remote_meta_names()
    for name, blob in await storage.load_remote_metas(names):
        try:
            vb = VersionBytes.deserialize(blob).ensure_versions(
                SUPPORTED_CONTAINER_VERSIONS
            )
            meta.merge(RemoteMeta.from_obj(codec.unpack(vb.content)))
        except Exception as e:
            report.add("error", "meta", name, f"malformed: {e}")
    try:
        await key_cryptor.set_remote_meta(meta.key_cryptor)
    except Exception as e:
        report.add(
            "error", "keys", "register", f"key metadata does not decode: {e}"
        )
        return report
    keys = collector.keys

    async def open_sealed(blob: bytes):
        return await open_sealed_blob(keys, cryptor, blob)

    with trace.span("checkpoint.verify"):
        try:
            obj = await open_sealed(raw)
            fmt = int(obj[b"fmt"])
            cursor = VClock.from_obj(obj[b"cursor"])
            ck_state = unpack_checkpoint_state(adapter, fmt, obj[b"state"])
        except Exception as e:
            report.add("error", "checkpoint", "local", f"unreadable: {e}")
            return report

        refold = adapter.new()
        folded_cursor = VClock()
        state_names = await storage.list_state_names()
        for name, blob in sorted(await storage.load_states(state_names)):
            try:
                sobj = await open_sealed(blob)
                sc = VClock.from_obj(sobj[1])
            except Exception as e:
                report.add("error", "states", name, f"{e}")
                continue
            if any(c > cursor.get(a) for a, c in sc.counters.items()):
                report.add(
                    "warn", "checkpoint", name,
                    "snapshot exceeds the checkpoint cursor "
                    "(a later compaction); skipped from the refold",
                )
                continue
            refold.merge(adapter.state_from_obj(sobj[0]))
            folded_cursor.merge(sc)
            report.state_files += 1
        from contextlib import aclosing

        unverifiable = []
        for actor in sorted(cursor.counters):
            last = cursor.get(actor)
            v = folded_cursor.get(actor) + 1
            # chunked read, stopped at the cursor: the remote may hold a
            # long post-checkpoint tail this verification must not load
            done = False
            async with aclosing(
                storage.iter_op_chunks([(actor, v)])
            ) as chunks:
                async for files in chunks:
                    for _, version, blob in files:
                        if version > last:
                            done = True  # a tail the checkpoint never folded
                            break
                        try:
                            ops = await open_sealed(blob)
                        except Exception as e:
                            report.add(
                                "error", "ops",
                                f"{actor.hex()}:{version}", f"{e}",
                            )
                            return report
                        for o in ops:
                            refold.apply(adapter.op_from_obj(o))
                            report.ops_decoded += 1
                        report.op_files += 1
                        v = version + 1
                    if done:
                        break
            if v <= last:
                unverifiable.append((actor, v, last))
        if unverifiable:
            for actor, v, last in unverifiable:
                report.add(
                    "warn", "checkpoint", actor.hex(),
                    f"op files v{v}..v{last} are gone from the remote "
                    "and no snapshot covers them; refold incomplete — "
                    "checkpoint unverifiable",
                )
            return report
        ck_bytes = codec.pack(adapter.state_to_obj(ck_state))
        rf_bytes = codec.pack(adapter.state_to_obj(refold))
        if ck_bytes != rf_bytes:
            report.add(
                "error", "checkpoint", "local",
                f"checkpointed state ({len(ck_bytes)}B canonical) diverges "
                f"from the remote refold ({len(rf_bytes)}B canonical)",
            )
    return report


ADAPTERS = {
    "orset": "orset_adapter",
    "gcounter": "gcounter_adapter",
    "pncounter": "pncounter_adapter",
    "lwwmap": "lwwmap_adapter",
    "mvreg": "mvreg_adapter",
    "gset": "gset_adapter",
    "lwwreg": "lwwreg_adapter",
    "merklereg": "merklereg_adapter",
    "list": "list_adapter",
    "map": "map_adapter",
}

# composed adapters (delta/compose.py) resolve through _adapter_for_name,
# which special-cases them; they are CLI-selectable like the rest
CLI_ADAPTERS = sorted(ADAPTERS) + ["rcounter"]


async def _list_op_versions(storage, actor) -> list[int] | None:
    """Sorted op-file versions for one actor WITHOUT reading file bytes,
    or None when the backend cannot enumerate them (no fs directory and
    no in-memory table)."""
    ops_dir = getattr(storage, "_ops_dir", None)
    if ops_dir is not None:
        import os

        try:
            names = os.listdir(ops_dir(actor))
        except FileNotFoundError:
            return []
        return sorted(int(n) for n in names if n.isdigit())
    table = getattr(storage, "remote", None)
    ops = getattr(table, "ops", None)
    if isinstance(ops, dict):  # MemoryRemote: {actor: {version: bytes}}
        return sorted(int(v) for v in ops.get(actor, {}))
    return None


def main(argv=None) -> int:
    """CLI: ``python -m crdt_enc_tpu_torch.tools.fsck REMOTE [--shallow]
    [--passphrase …] [--obs] [--verify-checkpoint DIR] [--adapter NAME]``
    — checks a remote written with the XChaCha cryptor and the plain (or
    passphrase) key cryptor."""
    import argparse
    import asyncio
    import tempfile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("remote", help="remote directory to verify (read-only)")
    ap.add_argument("--shallow", action="store_true",
                    help="skip decrypt/auth; structure and names only")
    ap.add_argument("--passphrase", help="passphrase-sealed key metadata")
    ap.add_argument("--obs", action="store_true",
                    help="print the fsck phase table (and append a "
                    "snapshot to CRDT_OBS_SINK if set)")
    ap.add_argument("--verify-checkpoint", metavar="LOCAL_DIR",
                    help="additionally verify LOCAL_DIR's fold checkpoint: "
                    "refold the remote up to the checkpoint cursor and "
                    "byte-compare (error row + exit 1 on divergence)")
    ap.add_argument("--adapter", default="orset", choices=CLI_ADAPTERS,
                    help="CRDT adapter for checkpoint/op decoding "
                    "(--verify-checkpoint only; default orset)")
    args = ap.parse_args(argv)

    from ..backends import (
        FsStorage,
        PassphraseKeyCryptor,
        PlainKeyCryptor,
        XChaChaCryptor,
    )

    def make_kc():
        return (
            PassphraseKeyCryptor(args.passphrase)
            if args.passphrase
            else PlainKeyCryptor()
        )

    async def go():
        with tempfile.TemporaryDirectory() as scratch:
            storage = FsStorage(scratch, args.remote)
            report = await fsck_remote(
                storage, XChaChaCryptor(), make_kc(), deep=not args.shallow
            )
            if args.verify_checkpoint:
                local = FsStorage(args.verify_checkpoint, args.remote)
                vc = await verify_checkpoint(
                    local, storage, XChaChaCryptor(), make_kc(),
                    adapter=_adapter_for_name(args.adapter.encode()),
                )
                report.issues.extend(vc.issues)
        for issue in report.issues:
            print(issue)
        print(report.summary())
        if args.obs:
            import sys

            from ..obs import sink as obs_sink

            print(trace.report(), file=sys.stderr)
            obs_sink.maybe_write("fsck", meta={"remote": args.remote})
        return 0 if report.ok else 1

    return asyncio.run(go())


if __name__ == "__main__":
    raise SystemExit(main())
