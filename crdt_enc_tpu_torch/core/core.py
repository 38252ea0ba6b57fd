"""The core runtime: open / apply_ops / read_remote / compact.

The port's copy of ``crdt_enc_tpu/core/core.py``, trimmed to the
compaction front end.  Same lifecycle, invariants and wire forms as the
JAX package, so a remote written or compacted by either package reads
back to the same canonical bytes in the other:

* **three-layer wire format** on every op and state file — inner
  ``VersionBytes(data_version, msgpack payload)``, middle cipher envelope
  from the Cryptor, outer ``VersionBytes(container_version,
  [key_id, middle])``; a snapshot payload is ``[state, cursor, sealer]``;
* **writer serialization**: one async lock around apply_ops, and the
  LockBox discipline — mutable core data is only touched in sync
  sections, never across an await;
* **ordered op ingestion** with concurrent-read tolerance: op files apply
  in version order per actor; an already-applied version is skipped, a gap
  is a hard error; a damaged file is quarantined with its cursor held;
* **crash safety by ordering**: new content-addressed writes land before
  old files are removed, in compact and metadata rewrite;
* **complete op GC**: compaction removes every op file the snapshot covers.

Op files are read whole-batch: below ``BULK_MIN_FILES`` per file through
the accelerator's ``fold_ops``; from there on the bulk path unwraps every
outer envelope, opens each sealing key's files in one native batch and
hands the payloads to ``fold_payloads`` (native decode, one device fold),
decoding per op only where the accelerator declines.

Not copied (each still to port): local fold checkpoints, delta-state
replication, strong reads and the stable prefix, replication sampling and
the metrics sink, the pipelined session ingest and the payload-stream
branch of the bulk path, and the serving front end ``load_sealed_ops``.
A reader of either package full-loads a snapshot that carries no delta
chain, so dropping the delta seal changes nothing on the wire.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from dataclasses import dataclass, field

from ..models.mvreg import MVReg
from ..models.vclock import Actor, Dot, VClock
from ..utils import codec, trace
from ..utils.lockbox import LockBox
from ..utils.version_bytes import VersionBytes
from ..utils.versions import (
    CURRENT_CONTAINER_VERSION,
    SUPPORTED_CONTAINER_VERSIONS,
)
from .adapters import CrdtAdapter
from .cryptor import Cryptor
from .key_cryptor import Key, KeyCryptor, Keys
from .storage import Storage

IO_CONCURRENCY = 16  # bounded pipeline width (reference lib.rs:452,512)
BULK_MIN_FILES = 16  # below this the per-file asyncio path is cheaper

logger = logging.getLogger("crdt_enc_tpu_torch.core")


class CoreError(Exception):
    pass


class MissingKeyError(CoreError):
    """No usable data key (key management not initialized)."""


class OpOrderError(CoreError):
    """An op file arrived beyond the expected next version — the storage
    layer violated the gap-free ordering contract (lib.rs:527-531)."""


class IngestDecryptError(CoreError):
    """EVERY blob of a multi-file ingest batch failed to open — that is
    indistinguishable from a dead cryptor backend or damaged key
    material, so instead of quarantining the whole backlog the read aborts
    loudly with the last underlying error as ``__cause__``.  Nothing was
    ingested and no cursor moved.  A single damaged file still
    quarantines."""


class StaleWriterError(CoreError):
    """A reopened producer could not re-learn its own durable history, so
    writing now would mint event identifiers (Orswot dots) already used by
    pre-crash events.  Retry once the remote has synced."""


class _Quarantined:
    """Sentinel standing in a clears/payloads list for a synced file
    whose decrypt or decode failed: the file is SKIPPED, never folded,
    and the ingest cursor is NOT advanced past it, so a later repaired
    sync retries it.  An op quarantine also ends its actor's dense run for
    this pass.  Unknown sealing keys stay LOUD (:class:`MissingKeyError`)."""

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<quarantined>"


_QUARANTINED = _Quarantined()


@dataclass
class LocalMeta:
    """Private per-replica identity + durable producer cursors.  The wire
    form is the JAX package's (``last_delta`` is carried through untouched:
    the port seals no deltas)."""

    local_actor_id: bytes
    last_op_version: int = 0
    last_delta_version: int = 0
    # highest keys-ORSet dot counter this replica ever minted — the
    # durable cursor behind the key-register dot-reuse guard
    last_key_dot: int = 0

    def to_obj(self):
        return {
            b"actor": self.local_actor_id,
            b"last_op": self.last_op_version,
            b"last_delta": self.last_delta_version,
            b"last_key": self.last_key_dot,
        }

    @classmethod
    def from_obj(cls, obj) -> "LocalMeta":
        return cls(
            bytes(obj[b"actor"]),
            int(obj.get(b"last_op", 0)),
            int(obj.get(b"last_delta", 0)),
            int(obj.get(b"last_key", 0)),
        )


@dataclass
class RemoteMeta:
    """CRDT-of-CRDTs: one opaque MVReg config slot per plugin port
    (reference lib.rs:745-764) — the convergent "LUKS header"."""

    storage: MVReg = field(default_factory=MVReg)
    cryptor: MVReg = field(default_factory=MVReg)
    key_cryptor: MVReg = field(default_factory=MVReg)

    def merge(self, other: "RemoteMeta") -> None:
        self.storage.merge(other.storage)
        self.cryptor.merge(other.cryptor)
        self.key_cryptor.merge(other.key_cryptor)

    def to_obj(self):
        return {
            b"s": self.storage.to_obj(),
            b"c": self.cryptor.to_obj(),
            b"k": self.key_cryptor.to_obj(),
        }

    @classmethod
    def from_obj(cls, obj) -> "RemoteMeta":
        return cls(
            MVReg.from_obj(obj.get(b"s")),
            MVReg.from_obj(obj.get(b"c")),
            MVReg.from_obj(obj.get(b"k")),
        )


@dataclass
class StateWrapper:
    """A full-state snapshot: the CRDT value + the op-log cursor (VClock of
    last applied op-file versions — the resume point).  On the wire
    ``[state, cursor]`` or ``[state, cursor, sealer_actor]``; readers take
    both."""

    state: object
    next_op_versions: VClock


@dataclass
class Info:
    """Observability snapshot (reference Info, lib.rs:766-775)."""

    local_actor_id: bytes
    next_op_versions: VClock
    read_states: frozenset
    has_latest_key: bool


@dataclass
class ReadResult:
    """An eventual read: the state's object form and the ingest cursor it
    reflects."""

    obj: object
    consistency: str
    cursor: VClock


@dataclass
class OpenOptions:
    """Configuration-as-code (reference OpenOptions, lib.rs:725-732)."""

    storage: Storage
    cryptor: Cryptor
    key_cryptor: KeyCryptor
    adapter: CrdtAdapter
    supported_data_versions: tuple
    current_data_version: bytes
    create: bool = False
    # the card by default (raises without one); pass
    # ``TorchAccelerator(device="cpu")`` or ``HostAccelerator()`` to stay
    # on the host
    accelerator: object = field(default_factory=lambda: _default_accelerator())


def _default_accelerator():
    # imported here: parallel.accel imports core.adapters, and importing
    # the core must not import torch
    from ..parallel.accel import TorchAccelerator

    return TorchAccelerator()


class _MutData:
    """All mutable core state.  LockBox discipline: methods touching this
    must be synchronous (asyncio makes sync sections atomic); the only
    cross-await exclusion is the writer lock in apply_ops."""

    def __init__(self, state):
        self.state = state
        self.next_op_versions = VClock()
        self.read_states: set[str] = set()
        self.read_metas: set[str] = set()
        self.remote_meta = RemoteMeta()
        self.keys = Keys()


class Core:
    """One replica's runtime.  Construct via ``Core.open``."""

    def __init__(self, opts: OpenOptions):
        self.storage = opts.storage
        self.cryptor = opts.cryptor
        self.key_cryptor = opts.key_cryptor
        self.adapter = opts.adapter
        self.accel = opts.accelerator
        self.supported_data_versions = tuple(sorted(opts.supported_data_versions))
        self.current_data_version = opts.current_data_version
        self._data = _MutData(opts.adapter.new())
        self._apply_lock = asyncio.Lock()
        self._meta_lock = asyncio.Lock()
        # Serializes every keys read-copy-write against remote-meta
        # ingestion: the key cryptor's register write happens AFTER its
        # protect step, so without exclusion a Keys value merged during
        # that await would be superseded by a write built from a stale
        # snapshot.  Lock order: _keys_lock → _meta_lock (never reverse).
        self._keys_lock = asyncio.Lock()
        self._local_meta: LocalMeta | None = None
        # writer-side dot-reuse guard (_ensure_own_history): the first
        # write of this incarnation probes for un-refolded own history
        self._own_history_checked = False

    # ------------------------------------------------------------------ open
    @classmethod
    async def open(cls, opts: OpenOptions) -> "Core":
        core = cls(opts)
        # build the native library off the event loop before the first
        # seal or scan needs it (a failed build raises here)
        from .. import native

        await asyncio.to_thread(native.load)
        raw = await core.storage.load_local_meta()
        if raw is None:
            if not opts.create:
                raise CoreError(
                    "no local replica metadata; open with create=True to join"
                )
            core._local_meta = LocalMeta(uuid.uuid4().bytes)
            await core._store_local_meta()
        else:
            vb = VersionBytes.deserialize(raw).ensure_versions(
                SUPPORTED_CONTAINER_VERSIONS
            )
            core._local_meta = LocalMeta.from_obj(codec.unpack(vb.content))

        # plugins capture the core handle (CoreSubHandle, lib.rs:286-290)
        await asyncio.gather(
            core.storage.init(core),
            core.cryptor.init(core),
            core.key_cryptor.init(core),
        )
        # pull converged metadata; force-notify so plugins initialize even
        # from an empty remote (lib.rs:292)
        await core._read_remote_meta(force_notify=True)

        # bootstrap the first data key if key management has none yet
        if core._data.keys.latest_key() is None:
            await core._install_new_key()
            if core._data.keys.latest_key() is None:
                raise MissingKeyError(
                    "key cryptor did not install a latest key at open"
                )
        return core

    async def _store_local_meta(self) -> None:
        vb = VersionBytes(
            CURRENT_CONTAINER_VERSION, codec.pack(self._local_meta.to_obj())
        )
        await self.storage.store_local_meta(vb.serialize())

    # -------------------------------------------------------------- identity
    @property
    def actor_id(self) -> Actor:
        assert self._local_meta is not None
        return self._local_meta.local_actor_id

    def info(self) -> Info:
        d = self._data
        return Info(
            self.actor_id,
            d.next_op_versions.copy(),
            frozenset(d.read_states),
            d.keys.latest_key() is not None,
        )

    def with_state(self, fn):
        """Run ``fn(state)`` synchronously under the data-lock discipline —
        the way applications build ops against current state (reference
        lib.rs:325-330).  ``fn`` gets a revocable borrow (LockBox), so a
        retained state reference used after the section raises."""
        return LockBox(self._data.state).with_(fn)

    # ------------------------------------------------------ eventual reads
    async def read(self) -> ReadResult:
        """This replica's value: the live state's object form (eventual
        consistency; the strong tier is not ported)."""
        d = self._data
        return ReadResult(
            obj=self.adapter.state_to_obj(d.state),
            consistency="eventual",
            cursor=d.next_op_versions.copy(),
        )

    async def contains(self, member) -> bool:
        """Point membership lookup for set-shaped states; ``TypeError``
        for states without a ``contains``."""
        probe = getattr(self._data.state, "contains", None)
        if probe is None:
            raise TypeError(
                f"{type(self._data.state).__name__} has no membership lookup"
            )
        return bool(probe(member))

    async def value(self):
        """Point value lookup for value-shaped states (counters)."""
        state = self._data.state
        probe = getattr(state, "value", None)
        if probe is None:
            probe = getattr(state, "read", None)
        if probe is None:
            raise TypeError(f"{type(state).__name__} has no value()")
        return probe() if callable(probe) else probe

    # ----------------------------------------------------------- key rotation
    async def _install_new_key(self) -> Key:
        """Generate a key, add it to the Keys CRDT as the new latest, and
        push it through the key cryptor under ``_keys_lock``.

        Key-register dot-reuse guard: the durable ``LocalMeta.last_key_dot``
        cursor refuses the mint (:class:`MissingKeyError`, retry after
        sync) whenever the observed keys clock trails it, so a reopened
        replica whose own register write is not visible yet can never mint
        a keys-ORSet dot it already spent on a different key.  The cursor
        is persisted BEFORE the remote write."""
        for attempt in (0, 1):
            async with self._keys_lock:
                keys = Keys.from_obj(self._data.keys.to_obj())
                expected = keys.keys.clock.get(self.actor_id) + 1
                lm = self._local_meta
                stale = lm is not None and expected <= lm.last_key_dot
                if not stale:
                    material = await self.cryptor.gen_key()
                    key = Key.new(material)
                    keys.insert_latest_key(self.actor_id, key)
                    if lm is not None and expected > lm.last_key_dot:
                        lm.last_key_dot = expected
                        await self._store_local_meta()
                    await self.key_cryptor.set_keys(keys)
            if not stale:
                break
            if attempt == 0:
                # our own register may simply not have been read yet
                # this incarnation — one refresh before refusing
                await self._read_remote_meta()
                continue
            raise MissingKeyError(
                "own key-register history (keys dot "
                f"{self._local_meta.last_key_dot}) is not yet visible on "
                "the remote; minting now would reuse a spent key dot"
            )
        if self._data.keys.get_key(key.id) is None:
            raise MissingKeyError("key cryptor did not install the new key")
        return key

    async def rotate_key(self) -> Key:
        """Generate and install a fresh data key as the new latest.
        Rotation never re-encrypts data: every blob's outer layer records
        its sealing key id, and old keys stay in the Keys CRDT."""
        return await self._install_new_key()

    # ------------------------------------------------------- wire (3 layers)
    def _latest_key(self) -> Key:
        key = self._data.keys.latest_key()
        if key is None:
            raise MissingKeyError("no latest data key")
        return key

    async def _seal(self, payload_obj) -> bytes:
        """inner(data version) → cipher middle → outer(container), with the
        sealing key's id recorded in the outer layer so readers select the
        right key after rotation or concurrent bootstrap."""
        inner = VersionBytes(self.current_data_version, codec.pack(payload_obj))
        key = self._latest_key()
        middle = await self.cryptor.encrypt(key.material, inner.serialize())
        return VersionBytes(
            CURRENT_CONTAINER_VERSION, codec.pack([key.id, middle])
        ).serialize()

    async def _open_sealed(self, raw: bytes):
        """Unwrap one three-layer sealed blob: outer container → key id →
        cipher middle → inner data version → payload object."""
        outer = VersionBytes.deserialize(raw).ensure_versions(
            SUPPORTED_CONTAINER_VERSIONS
        )
        key_id, middle = codec.unpack(outer.content)
        key = self._data.keys.get_key(bytes(key_id))
        if key is None:
            raise MissingKeyError(
                f"blob sealed with unknown key {uuid.UUID(bytes=bytes(key_id))}; "
                "key metadata may not have synced yet"
            )
        clear = await self.cryptor.decrypt(key.material, bytes(middle))
        inner = VersionBytes.deserialize(clear).ensure_versions(
            self.supported_data_versions
        )
        return codec.unpack(inner.content)

    def _note_quarantine(self, family: str, ident: str, exc: Exception) -> None:
        """One quarantined synced file: counted under
        ``ingest_quarantined`` and one warning naming it."""
        trace.add("ingest_quarantined", 1)
        logger.warning(
            "quarantining %s %s: %r (cursor held; retried on repaired sync)",
            family, ident, exc,
        )

    async def _decrypt_tolerant(self, key: Key, files: list, middles: list) -> list:
        """Batched AEAD open with per-file quarantine: the batch first,
        and on failure a per-file pass that replaces each undecryptable
        blob with the :class:`_Quarantined` sentinel.  When EVERY file of
        a multi-file batch fails, :class:`IngestDecryptError` propagates
        instead (nothing consumed, cursors held)."""
        try:
            return await self.cryptor.decrypt_batch(key.material, middles)
        except Exception:
            logger.debug(
                "batch decrypt failed; isolating per file", exc_info=True
            )
        outs, failed = [], []
        for (actor, version, _), middle in zip(files, middles):
            try:
                outs.append(await self.cryptor.decrypt(key.material, middle))
            except Exception as e:
                outs.append(_QUARANTINED)
                failed.append((actor, version, e))
        if len(files) > 1 and len(failed) == len(files):
            raise IngestDecryptError(
                f"all {len(files)} op files in the batch failed to open"
            ) from failed[-1][2]
        for actor, version, e in failed:
            self._note_quarantine("op", f"{actor.hex()}:v{version}", e)
        return outs

    # ------------------------------------------------------------- apply_ops
    async def _ensure_own_history(self) -> None:
        """Dot-reuse guard, run under the writer lock before any op is
        BUILT: a producer whose in-memory clock trails its own durable
        history would mint dots its pre-crash incarnation already spent on
        different events.  One own-tail storage probe on the first write
        of each incarnation; when behind, the remote is re-read, and a
        remote that still does not show the recorded history refuses the
        write (:class:`StaleWriterError`).  A replica with history facing
        an empty own tail checks the snapshot listing too (a peer may have
        folded its orphan op file into a snapshot and collected it)."""
        actor = self.actor_id
        assert self._local_meta is not None
        behind = (
            self._data.next_op_versions.get(actor)
            < self._local_meta.last_op_version
        )
        probe_ok = True
        if not behind and not self._own_history_checked:
            try:
                tail = await self.storage.stat_ops(
                    [(actor, self._data.next_op_versions.get(actor) + 1)]
                )
                if not tail and self._local_meta.last_op_version > 0:
                    names = set(await self.storage.list_state_names())
                    unread = names - self._data.read_states
                    if unread:
                        tail = True  # re-read the covering snapshots
                    elif self._data.read_states and not (
                        self._data.read_states & names
                    ):
                        raise StaleWriterError(
                            "snapshots this replica merged were "
                            "garbage-collected but no replacement is "
                            "visible; writing now could reuse dots the "
                            "collecting peer's snapshot already folded"
                        )
                    elif not names and not await self.storage.stat_ops(
                        [(actor, 1)]
                    ):
                        raise StaleWriterError(
                            "own durable op history vanished with no "
                            "covering snapshot visible; writing now "
                            "could reuse dots it carried"
                        )
            except StaleWriterError:
                raise
            except Exception:
                # a safety guard must not fail OPEN permanently: the
                # recorded-cursor check above still fails closed, and
                # leaving the checked flag unset re-probes next write
                logger.warning(
                    "own-tail probe failed; re-probing on the next write",
                    exc_info=True,
                )
                tail = []
                probe_ok = False
            behind = bool(tail)
        if behind:
            await self.read_remote()
            if (
                self._data.next_op_versions.get(actor)
                < self._local_meta.last_op_version
            ):
                raise StaleWriterError(
                    "own durable history (op files through "
                    f"v{self._local_meta.last_op_version}) is not yet "
                    "visible on the remote; writing now would reuse "
                    "pre-crash event ids"
                )
        if probe_ok:
            self._own_history_checked = True

    async def apply_ops(self, ops: list) -> None:
        """Persist a batch of local ops as one immutable op file, then fold
        it into memory (producer path, lib.rs:666-722).  Ops must have
        been built against the current state (``with_state``); concurrent
        writers use ``update``."""
        if not ops:
            return
        async with self._apply_lock:
            await self._ensure_own_history()
            await self._apply_ops_locked(ops)

    async def update(self, build) -> list:
        """Build-and-apply under the writer lock: ``build(state)`` (sync,
        LockBox discipline) returns one op or a list of ops derived from
        the live state; they are persisted and folded atomically with
        respect to other writers.  Returns the ops."""
        async with self._apply_lock:
            await self._ensure_own_history()
            ops = LockBox(self._data.state).with_(build)
            if ops is None:
                return []
            if not isinstance(ops, list):
                ops = [ops]
            if ops:
                await self._apply_ops_locked(ops)
            return ops

    async def _apply_ops_locked(self, ops: list) -> None:
        payload = [self.adapter.op_to_obj(op) for op in ops]
        blob = await self._seal(payload)
        actor = self.actor_id
        assert self._local_meta is not None
        # past everything this replica has ever written (durable cursor)
        # and folded (memory cursor); a collision with a file a previous
        # crash left behind probes forward rather than clobbering
        version = (
            max(
                self._data.next_op_versions.get(actor),
                self._local_meta.last_op_version,
            )
            + 1
        )
        while True:
            try:
                await self.storage.store_ops(actor, version, blob)
                break
            except FileExistsError:
                version += 1
        self._local_meta.last_op_version = version
        await self._store_local_meta()
        # sync section: fold into memory
        self.accel.fold_ops(self._data.state, ops)
        self._data.next_op_versions.apply(Dot(actor, version))

    # ----------------------------------------------------------- read_remote
    async def read_remote(self) -> None:
        """Ingest everything new: metadata, then snapshots, then op tails
        (consumer path, lib.rs:390-399)."""
        await self._read_remote_meta()
        await self._read_remote_states()
        await self._read_remote_ops()

    async def _read_remote_states(self) -> None:
        with trace.span("states.list"):
            names = await self.storage.list_state_names()
        new = [n for n in names if n not in self._data.read_states]
        if not new:
            return
        with trace.span("states.load"):
            loaded = await self.storage.load_states(new)
        sem = asyncio.Semaphore(IO_CONCURRENCY)
        state_failures: list[tuple[str, Exception]] = []

        async def decode(name: str, raw: bytes):
            async with sem:
                try:
                    obj = await self._open_sealed(raw)
                    # [state, cursor] or [state, cursor, sealer]: the
                    # sealer id is observational and not used here
                    return name, StateWrapper(
                        self.adapter.state_from_obj(obj[0]),
                        VClock.from_obj(obj[1]),
                    )
                except MissingKeyError:
                    raise  # key metadata not synced: loud, not damage
                except Exception as e:
                    # torn/tampered snapshot: quarantine it — the name
                    # stays OUT of read_states, so a repaired sync is
                    # retried on the next listing
                    state_failures.append((name, e))
                    return None

        with trace.span("states.decrypt_decode"):
            decoded = [
                d
                for d in await asyncio.gather(
                    *(decode(n, raw) for n, raw in loaded)
                )
                if d is not None
            ]
        if len(loaded) > 1 and len(state_failures) == len(loaded):
            raise IngestDecryptError(
                f"all {len(loaded)} state snapshots failed to open"
            ) from state_failures[-1][1]
        for name, e in state_failures:
            self._note_quarantine("state", name, e)
        if not decoded:
            return
        # sync section: CvRDT merge (HOT LOOP #1 → accelerator)
        with trace.span("states.merge"):
            self.accel.merge_states(
                self._data.state, [sw.state for _, sw in decoded]
            )
        trace.add("states_merged", len(decoded))
        for _, sw in decoded:
            self._data.next_op_versions.merge(sw.next_op_versions)
        self._data.read_states.update(name for name, _ in decoded)

    async def _read_remote_ops(self) -> None:
        with trace.span("ops.list"):
            actors = await self.storage.list_op_actors()
        wanted = [
            (a, self._data.next_op_versions.get(a) + 1) for a in sorted(actors)
        ]
        if not wanted:
            return
        with trace.span("ops.load"):
            files = await self.storage.load_ops(wanted)
        trace.add("op_files_loaded", len(files))
        if not files:
            return
        if len(files) >= BULK_MIN_FILES:
            await self._read_remote_ops_bulk(files, actors)
            return
        sem = asyncio.Semaphore(IO_CONCURRENCY)
        failures: list[tuple[Actor, int, Exception]] = []

        async def decode(actor: Actor, version: int, raw: bytes):
            async with sem:
                try:
                    return actor, version, await self._open_sealed(raw)
                except MissingKeyError:
                    raise  # key metadata not synced: loud, not damage
                except Exception as e:
                    failures.append((actor, version, e))
                    return actor, version, _QUARANTINED

        # concurrent decode, ORDER PRESERVED (ordering is load-bearing,
        # lib.rs:497-514)
        with trace.span("ops.decrypt_decode"):
            decoded = await asyncio.gather(
                *(decode(a, v, raw) for a, v, raw in files)
            )
        if len(files) > 1 and len(failures) == len(files):
            raise IngestDecryptError(
                f"all {len(files)} op files failed to open"
            ) from failures[-1][2]
        for actor, version, e in failures:
            self._note_quarantine("op", f"{actor.hex()}:v{version}", e)

        # sync section: version bookkeeping + batched fold (HOT LOOP #2)
        batch = []
        blocked: set[Actor] = set()  # actors cut at a quarantined file
        for actor, version, payload in decoded:
            if actor in blocked:
                continue
            expected = self._data.next_op_versions.get(actor) + 1
            if version < expected:
                continue  # concurrent-read tolerance (lib.rs:521-525)
            if payload is _QUARANTINED:
                # the hole ends this actor's dense run for this pass;
                # the cursor stays put so the file is retried later
                blocked.add(actor)
                continue
            if version > expected:
                raise OpOrderError(
                    f"op file v{version} for {uuid.UUID(bytes=actor)} arrived "
                    f"beyond expected v{expected}"
                )
            batch.extend(self.adapter.op_from_obj(o) for o in payload)
            self._data.next_op_versions.apply(Dot(actor, version))
        if batch:
            with trace.span("ops.fold"):
                self.accel.fold_ops(self._data.state, batch)
            trace.add("ops_folded", len(batch))

    def _validate_chunk(self, files: list, clears: list, blocked: set):
        """Sync section: ordered version bookkeeping WITHOUT advancing the
        cursors (the caller advances only after the fold lands).
        ``blocked`` carries quarantine cuts: an actor whose run hit a
        damaged file folds nothing past the hole.  Returns ``(payloads,
        metas)``; skew tolerance and gap errors as lib.rs:519-531."""
        payloads, metas = [], []
        local: dict[Actor, int] = {}
        for (actor, version, _), clear in zip(files, clears):
            if actor in blocked:
                continue
            expected = (
                max(self._data.next_op_versions.get(actor), local.get(actor, 0))
                + 1
            )
            if version < expected:
                continue  # concurrent-read tolerance (lib.rs:521-525)
            if clear is _QUARANTINED:
                blocked.add(actor)  # already counted at the decrypt site
                continue
            if version > expected:
                raise OpOrderError(
                    f"op file v{version} for {uuid.UUID(bytes=actor)} arrived "
                    f"beyond expected v{expected}"
                )
            try:
                inner = VersionBytes.deserialize(clear).ensure_versions(
                    self.supported_data_versions
                )
            except Exception as e:
                # decrypted fine but the cleartext framing is damaged (or
                # a data version this build cannot read): quarantine
                self._note_quarantine("op", f"{actor.hex()}:v{version}", e)
                blocked.add(actor)
                continue
            payloads.append(inner.content)
            metas.append((actor, version))
            local[actor] = version
        return payloads, metas

    def _advance_cursors(self, metas: list) -> None:
        for actor, version in metas:
            self._data.next_op_versions.apply(Dot(actor, version))

    async def _read_remote_ops_bulk(self, files: list, actors) -> None:
        """Bulk ingestion: unwrap all outer envelopes, one batched decrypt
        per sealing key, then hand the raw payloads to the accelerator's
        columnar decode and fold.  Damaged files quarantine per file;
        key-auth and op-order violations raise as on the per-file path."""
        files, groups = self._unwrap_op_files(files)
        if not files:
            return  # every file quarantined: consumed, cursors held
        clears: list = [None] * len(files)
        with trace.span("ops.bulk_decrypt"):
            for key, idxs, mids in groups:
                outs = await self._decrypt_tolerant(
                    key, [files[i] for i in idxs], mids
                )
                for i, clear in zip(idxs, outs):
                    clears[i] = clear
            payloads, metas = self._validate_chunk(files, clears, set())
        trace.add(
            "bytes_decrypted",
            sum(len(m) for _, _, mids in groups for m in mids),
        )
        if not payloads:
            return
        with trace.span("ops.bulk_fold"):
            if self.accel.fold_payloads(
                self._data.state, payloads, actors_hint=actors
            ):
                self._advance_cursors(metas)
                trace.add("op_files_bulk_folded", len(payloads))
                return
            # accelerator declined (non-columnar CRDT, vocab collision,
            # sparse regime): decode per op, still fold as one batch
            batch = []
            for p in payloads:
                batch.extend(
                    self.adapter.op_from_obj(o) for o in codec.unpack(p)
                )
            self.accel.fold_ops(self._data.state, batch)
            self._advance_cursors(metas)
            trace.add("ops_folded", len(batch))

    def _unwrap_op_files(self, files: list):
        """Outer-envelope unwrap of loaded op files, grouped by sealing
        key: ``(kept, [(key, idxs, middles)])``.  A file whose outer
        framing does not parse is QUARANTINED (the actor's dense run ends
        there, cursor held), so ``kept`` may be shorter than ``files``;
        ``idxs`` index into ``kept``.  An unsynced sealing key raises
        :class:`MissingKeyError`."""
        with trace.span("ops.bulk_unwrap"):
            kept, key_ids, middles = [], [], []
            cut: set = set()
            for f in files:
                actor, version, raw = f
                if actor in cut:
                    continue
                try:
                    outer = VersionBytes.deserialize(raw).ensure_versions(
                        SUPPORTED_CONTAINER_VERSIONS
                    )
                    kid, middle = codec.unpack(outer.content)
                except Exception as e:
                    self._note_quarantine(
                        "op", f"{actor.hex()}:v{version}", e
                    )
                    cut.add(actor)
                    continue
                kept.append(f)
                key_ids.append(bytes(kid))
                middles.append(bytes(middle))
        by_kid: dict[bytes, list[int]] = {}
        for i, kid in enumerate(key_ids):
            by_kid.setdefault(kid, []).append(i)
        groups = []
        for kid, idxs in by_kid.items():
            key = self._data.keys.get_key(kid)
            if key is None:
                raise MissingKeyError(
                    f"ops sealed with unknown key {uuid.UUID(bytes=kid)}; "
                    "key metadata may not have synced yet"
                )
            groups.append((key, idxs, [middles[i] for i in idxs]))
        return kept, groups

    # --------------------------------------------------------------- compact
    async def compact(self) -> None:
        """Fold everything, snapshot, write-new-then-delete-old
        (north-star path, lib.rs:332-380)."""
        with trace.span("compact.ingest"):
            await self.read_remote()
        await self._compact_seal()

    async def _compact_seal(self) -> None:
        """Snapshot the CURRENT state + cursor, write the new snapshot,
        then collect the snapshots and op files it covers."""
        # sync section: the (state, cursor) cut comes from one loop slice
        d = self._data
        payload = [
            self.adapter.state_to_obj(d.state),
            d.next_op_versions.to_obj(),
            # sealer id: readers attribute the cursor to this replica
            self.actor_id,
        ]
        states_to_remove = sorted(d.read_states)
        ops_to_remove = sorted(d.next_op_versions.counters.items())
        prior_names = frozenset(d.read_states)
        with trace.span("compact.seal"):
            blob = await self._seal(payload)
        # crash safety: the new snapshot is durable before anything vanishes
        with trace.span("compact.write"):
            name = await self.storage.store_state(blob)
        # snapshot-GC guard: foreign snapshots may only be removed when the
        # justifying snapshot ``name`` was never published before.  A
        # re-seal of unchanged state reproduces its previous content-
        # addressed name — one concurrent peers may already have read and
        # may remove in THEIR GC; if every member of a batch re-seals
        # unchanged state, the union of removes can wipe every snapshot.
        # A never-before-published name cannot be a concurrent remove
        # target, so its removes stay covered by a durable snapshot.
        # Deferred names stay in read_states for the next new seal.
        if name in prior_names:
            stale_states: list[str] = []
            trace.add("seal_gc_deferred", 1)
        else:
            stale_states = states_to_remove
        with trace.span("compact.gc"):
            await asyncio.gather(
                self.storage.remove_states(stale_states),
                self.storage.remove_ops(ops_to_remove),
            )
        # sync bookkeeping section
        d.read_states.difference_update(stale_states)
        d.read_states.add(name)

    # ------------------------------------------------- remote meta lifecycle
    async def _read_remote_meta(self, force_notify: bool = False) -> None:
        names = await self.storage.list_remote_meta_names()
        new = [n for n in names if n not in self._data.read_metas]
        loaded = await self.storage.load_remote_metas(new) if new else []
        # the merge and the KEY-cryptor fan-out hold the keys lock (a
        # key-register merge inside _install_new_key's snapshot→write
        # window would be superseded); the storage/cryptor notifications
        # don't touch the keys register and run outside it
        storage_reg = cryptor_reg = None
        async with self._keys_lock:
            for name, raw in loaded:
                vb = VersionBytes.deserialize(raw).ensure_versions(
                    SUPPORTED_CONTAINER_VERSIONS
                )
                self._data.remote_meta.merge(
                    RemoteMeta.from_obj(codec.unpack(vb.content))
                )
                self._data.read_metas.add(name)
            if loaded or force_notify:
                rm = self._data.remote_meta
                storage_reg = MVReg.from_obj(rm.storage.to_obj())
                cryptor_reg = MVReg.from_obj(rm.cryptor.to_obj())
                await self.key_cryptor.set_remote_meta(
                    MVReg.from_obj(rm.key_cryptor.to_obj())
                )
        if storage_reg is not None:
            await asyncio.gather(
                self.storage.set_remote_meta(storage_reg),
                self.cryptor.set_remote_meta(cryptor_reg),
            )

    async def _store_remote_meta(self) -> None:
        """Persist converged metadata: content-addressed write, then remove
        superseded meta files (store-then-delete, lib.rs:647-664)."""
        vb = VersionBytes(
            CURRENT_CONTAINER_VERSION, codec.pack(self._data.remote_meta.to_obj())
        )
        old = set(self._data.read_metas)
        name = await self.storage.store_remote_meta(vb.serialize())
        await self.storage.remove_remote_metas([n for n in old if n != name])
        self._data.read_metas.difference_update(old)
        self._data.read_metas.add(name)

    # --------------------------------------- plugin callbacks (CoreSubHandle)
    def set_keys(self, keys: Keys) -> None:
        """Key cryptor installed a decoded key set (lib.rs:382-388)."""
        self._data.keys = keys

    async def set_remote_meta_storage(self, reg: MVReg) -> None:
        async with self._meta_lock:
            self._data.remote_meta.storage.merge(reg)
            await self._store_remote_meta()

    async def set_remote_meta_cryptor(self, reg: MVReg) -> None:
        async with self._meta_lock:
            self._data.remote_meta.cryptor.merge(reg)
            await self._store_remote_meta()

    async def set_remote_meta_key_cryptor(self, reg: MVReg) -> None:
        async with self._meta_lock:
            self._data.remote_meta.key_cryptor.merge(reg)
            await self._store_remote_meta()
