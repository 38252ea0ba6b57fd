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

Op files are read through the reference's route.  With an accelerator
that opens fold sessions (``TorchAccelerator``), ``_read_remote_ops``
first takes the pipelined ingest (as wide as the accelerator's
``stream_producers``, else ``CRDT_STREAM_PRODUCERS``, else one per core
but one): ``storage.iter_op_chunks`` reads
bounded chunks, a producer task unwraps and batch-decrypts each one, and
this task validates, decodes and reduces it through a fold session
(parallel/session.py) while the next chunk is read and decrypted; once
``BULK_MIN_FILES`` files are pending the session starts, a declined chunk
flips the rest to per-op folds in version order, and fewer files fold per
op.  Without a session (the host loop, the LWW map) the whole batch
loads: below ``BULK_MIN_FILES`` per file through ``fold_ops``; from there
on the bulk path unwraps every outer envelope, opens each sealing key's
files in one native batch and hands the payloads to ``fold_payloads``,
decoding per op only where the accelerator declines.

Delta-state replication: with ``OpenOptions.delta`` on (the default),
``CRDT_DELTA`` not ``0`` and a storage with the delta family,
``compact()`` also seals an encrypted
delta since this replica's previous snapshot into its own delta log
(``remote/deltas/<actor-hex>/<N>``), and ``read_remote()`` folds ``known
base + delta chain`` before it downloads any unread snapshot, falling
back to the snapshot on any gap, GC'd link or doubt (``delta_fallbacks``,
``last_delta_fallback_reason``).  The seal self-verifies (the delta
applied to the base must give the sealed state's bytes;
``CRDT_DELTA_VERIFY=0`` skips the check) and is refused when it is no
smaller than the state.  Each snapshot's and delta's sealer
cursor feeds the cursor matrix, and each delta carries the sealer's
stability watermark (obs/replication.py).  The wire is the JAX package's,
so either package reads a chain the other sealed.

Local fold checkpoints: with ``OpenOptions.checkpoint`` on (the
default), ``compact()`` ends by sealing the state, the ingest cursor, the
read snapshots, the cursor matrix, the delta consumption cursor, the
stable prefix and (when the state still equals it) the sealed snapshot's
name into the storage's local-checkpoint slot (``save_checkpoint``), and
``open`` restores them after verifying the fingerprint (adapter, actor,
data version, latest key, remote-meta hash), so a reopen ingests only the
op tails past the cursor and extends its delta chain; any doubt falls
back to the cold refold with the reason recorded.  The payload keys are
the JAX package's (``fmt``, ``state``, ``cursor``, ``rs``, ``fp``,
``cm``, ``rd``, ``snap``, ``sp``), so a checkpoint sealed by either
package opens warm in the other.

Replication sampling and strong reads: every open, ``read_remote`` and
compaction samples this replica's replication status
(``replication_status``: watermark, backlog, divergence, checkpoint
staleness; ``obs/replication.py``) into gauges, the live telemetry
server and, after a compaction, the metrics sink (``CRDT_REPL_SAMPLE=0``
opts out).  ``read(linearizable=True)`` answers from the stable prefix
(``read/stable.py``): the fold of the ops every replica of the
membership provably holds, refusing with ``StalenessError`` where the
caller's bounds cannot be met; ``await_stable`` waits for coverage.

Serving hooks: the multi-tenant fold service (``serve/service.py``)
ingests through ``load_sealed_ops`` (list, load and unwrap, no decrypt),
folds many tenants in one device launch, and seals each one through
``_compact_seal(_backlog=, _packed_state=, _state_obj=, _delta_cut=)`` —
the solo seal tail, with the service's pre-built checkpoint payload,
snapshot object and device-cut delta, each accepted only while the
state's mutation epoch still matches.

Consumer replicas: with ``OpenOptions.checkpoint_on_read`` a replica
that never compacts reseals its warm-open checkpoint after every
``read_remote()`` that moved its cursor or its read snapshots (a quiet
poll writes nothing).

The payload-stream branch of the bulk path: where the accelerator offers
``open_payload_stream`` and every file shares one sealing key, the bulk
path decrypts ``BULK_STREAM_CHUNK`` files at a time, one chunk ahead on
a worker thread, and feeds each validated chunk to the stream's decoder;
a declined chunk sends the whole batch down the per-op path.  It is
reached, as in the JAX package, only where no fold session opens.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import time
import uuid
from dataclasses import dataclass, field

import numpy as np

from ..models.mvreg import MVReg
from ..models.vclock import Actor, Dot, VClock
from ..ops import cuda_build
from ..read.stable import ReadResult
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
BULK_STREAM_CHUNK = 16384  # files per decrypt-lookahead chunk (bulk ingest)

# local fold-checkpoint payload formats (the JAX package's)
CHECKPOINT_FMT_OBJ = 0  # adapter.state_to_obj (any CRDT type)
CHECKPOINT_FMT_ORSET = 1  # ops/columnar.py orset_pack_checkpoint

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
    """Private per-replica identity + durable producer cursors (the op
    log's and the delta log's).  The wire form is the JAX package's."""

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

    def is_empty(self) -> bool:
        return (
            self.storage.is_empty()
            and self.cryptor.is_empty()
            and self.key_cryptor.is_empty()
        )


@dataclass
class StateWrapper:
    """A full-state snapshot: the CRDT value + the op-log cursor (VClock of
    last applied op-file versions — the resume point).  On the wire
    ``[state, cursor]`` or ``[state, cursor, sealer_actor]``; readers take
    both."""

    state: object
    next_op_versions: VClock


def snapshot_sealer(obj) -> bytes | None:
    """The validated sealer id from a decoded snapshot wrapper, or
    ``None`` when absent or malformed — the single encoding of the sealer
    wire rule (16-byte actor id in slot 2).  The type check matters:
    ``bytes(16)`` would coerce an integer into 16 NUL bytes, a phantom
    all-zero replica.  Ingest drops what this rejects (observational,
    never a read failure)."""
    sealer = obj[2] if len(obj) > 2 else None
    if (
        isinstance(sealer, (bytes, bytearray, memoryview))
        and len(sealer) == 16
    ):
        return bytes(sealer)
    return None


def snapshot_payload(state_bytes: bytes, cursor_obj, sealer: bytes) -> bytes:
    """The packed ``[state, cursor, sealer]`` wrapper around a state
    already packed canonically: a msgpack array of three is the header
    0x93 followed by its packed elements, so the state is not packed a
    second time."""
    return b"\x93" + state_bytes + codec.pack(cursor_obj) + codec.pack(sealer)


@dataclass
class Info:
    """Observability snapshot (reference Info, lib.rs:766-775)."""

    local_actor_id: bytes
    next_op_versions: VClock
    read_states: frozenset
    has_latest_key: bool


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
    # local fold checkpoints: with ``checkpoint`` on, compact() seals a
    # warm-open resume point through the storage's local-checkpoint slot
    # and open() restores it after verification (falling back to the
    # cold refold on any mismatch).
    checkpoint: bool = True
    # ``checkpoint_on_read`` also reseals after every read_remote() that
    # moved the cursor or the read snapshots: for consumer replicas that
    # never compact
    checkpoint_on_read: bool = False
    # delta-state replication: with ``delta`` on and a storage backend
    # that has the delta family, compact() also seals a delta since this
    # replica's previous snapshot, and read_remote() folds ``known base +
    # delta chain`` before re-reading full snapshots (with a counted
    # fallback on any gap, GC'd link or fingerprint doubt).
    delta: bool = True
    # strong-read membership policy (read/policy.py ``MembershipPolicy``)
    # pinning the watermark's denominator (expected replicas, silence
    # decay).  None = the observed replicas.
    membership: object | None = None


async def open_sealed_blob(
    keys: Keys, cryptor, raw: bytes, supported_data_versions=None
):
    """Unwrap one three-layer sealed blob: outer container → key id →
    cipher middle → inner data version → payload object.  The one
    implementation of the wire contract: the core and the fsck tool both
    go through here.  ``supported_data_versions=None`` skips the inner
    data-version check (diagnostic callers that do not know the
    application's version set)."""
    outer = VersionBytes.deserialize(raw).ensure_versions(
        SUPPORTED_CONTAINER_VERSIONS
    )
    key_id, middle = codec.unpack(outer.content)
    key = keys.get_key(bytes(key_id))
    if key is None:
        raise MissingKeyError(
            f"blob sealed with unknown key {uuid.UUID(bytes=bytes(key_id))}; "
            "key metadata may not have synced yet"
        )
    clear = await cryptor.decrypt(key.material, bytes(middle))
    inner = VersionBytes.deserialize(clear)
    if supported_data_versions is not None:
        inner.ensure_versions(supported_data_versions)
    return codec.unpack(inner.content)


def unpack_checkpoint_state(adapter, fmt: int, st):
    """Decode a checkpoint's state payload: the one implementation of the
    format dispatch."""
    if fmt == CHECKPOINT_FMT_ORSET:
        from ..ops.columnar import orset_unpack_checkpoint

        return orset_unpack_checkpoint(st)
    if fmt == CHECKPOINT_FMT_OBJ:
        return adapter.state_from_obj(st)
    raise CoreError(f"unknown checkpoint format {fmt!r}")


def _host(x):
    """A plane as a numpy array, copied off the card where it lies."""
    if hasattr(x, "cpu"):
        return x.cpu().numpy()
    return np.asarray(x)


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
        # cursor matrix: other replicas' last PUBLISHED ingest cursors,
        # learned from the sealer id + cursor each compacted snapshot (and
        # each delta) carries (obs/replication.py).  Monotone (clocks only
        # merge) and observational — convergence never depends on it.
        self.cursor_matrix: dict[Actor, VClock] = {}
        # delta-chain consumption cursor: per sealer, the highest delta
        # version already scanned (applied OR skipped) — the next read
        # loads only past it, and compaction GCs the consumed prefix
        self.read_deltas: dict[Actor, int] = {}


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
        self._checkpoint_enabled = opts.checkpoint
        self._checkpoint_on_read = opts.checkpoint_on_read
        # warm-open outcome: whether open() restored the local checkpoint,
        # and why a present one was rejected
        self.opened_from_checkpoint = False
        self.checkpoint_fallback_reason: str | None = None
        # SHA3 of the canonical converged RemoteMeta; dropped at every
        # meta merge
        self._remote_id_cache: bytes | None = None
        # delta-state replication: the retained base — the last snapshot
        # THIS replica sealed, as its canonical packed state bytes + name
        # + cursor obj — is what the next compaction diffs against;
        # ``CRDT_DELTA=0`` force-disables, ``CRDT_DELTA_VERIFY=0`` skips
        # the seal-time refold check
        self._delta_enabled = (
            opts.delta and os.environ.get("CRDT_DELTA", "") != "0"
        )
        self._delta_verify = os.environ.get("CRDT_DELTA_VERIFY", "") != "0"
        self._delta_base: dict | None = None
        self.last_delta_fallback_reason: str | None = None
        # replication sampling (obs/replication.py) on every open,
        # read_remote and compact unless ``CRDT_REPL_SAMPLE=0``; the last
        # status is kept for callers that want the whole dict
        self._repl_sample = os.environ.get("CRDT_REPL_SAMPLE", "") != "0"
        self.last_replication_status: dict | None = None
        # (cursor counters, read states) of the last durably sealed
        # checkpoint: the replication status's staleness base
        self._checkpoint_sig: tuple | None = None
        # what the last _compact_seal depended on (_seal_signature): the
        # fold service skips a quiet tenant's seal while it is unmoved
        self._last_seal_sig: tuple | None = None
        # strong reads: the stable prefix is made on the first
        # linearizable read (or restored from the checkpoint's sp slot)
        self._membership = opts.membership
        self._stable = None

    # ------------------------------------------------------------------ open
    @classmethod
    async def open(cls, opts: OpenOptions) -> "Core":
        with trace.span("core.open"):
            return await cls._open(opts)

    @classmethod
    async def _open(cls, opts: OpenOptions) -> "Core":
        core = cls(opts)
        # build the native libraries off the event loop before the first
        # pack, seal or scan needs them (a failed build raises here)
        from .. import native

        await asyncio.to_thread(native.warm)
        dev = getattr(core.accel, "device", None)
        if dev is not None and dev.type == "cuda":
            # and the CUDA kernels, for an accelerator on a card, before
            # a compaction launches one (a failed build raises here)
            await asyncio.to_thread(cuda_build.warm)
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
        if opts.checkpoint:
            await core._open_from_checkpoint()
        # replication status at open: the backlog gauge answers how much
        # the first read_remote will fold
        await core._sample_replication()
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

    # ------------------------------------------------------- replication obs
    async def replication_status(self, *, _backlog: list | None = None) -> dict:
        """This replica's replication status: the causal stability
        watermark, the op backlog past the local cursor (sized without
        reading, ``Storage.stat_ops``), divergence from everything known
        to exist, and checkpoint staleness.  Pure observation: nothing is
        mutated and no op payload is read; the math is
        :func:`crdt_enc_tpu_torch.obs.replication.compute_status`.

        ``_backlog`` is the post-ingest fast path: an ingest that just
        folded everything its own listing found passes ``[]`` instead of
        paying a second per-actor storage probe."""
        from ..obs import replication

        with trace.span("repl.status"):
            d = self._data
            if _backlog is None:
                actors = await self.storage.list_op_actors()
                wanted = [
                    (a, d.next_op_versions.get(a) + 1) for a in sorted(actors)
                ]
                backlog = (
                    await self.storage.stat_ops(wanted) if wanted else []
                )
            else:
                backlog = _backlog
            # sync section: clocks snapshot + compute, no await between
            ckpt = self._checkpoint_sig
            status = replication.compute_status(
                self.actor_id,
                d.next_op_versions.copy(),
                {a: c.copy() for a, c in d.cursor_matrix.items()},
                backlog,
                self._remote_id(),
                dict(ckpt[0]) if ckpt is not None else None,
                self._checkpoint_enabled,
            )
            if self._membership is not None:
                # who the watermark's denominator excludes rides with
                # every status (absent without a policy)
                status["membership"] = self._membership.summary()
        self.last_replication_status = status
        return status

    async def _sample_replication(
        self, *, _backlog: list | None = None
    ) -> dict | None:
        """Status → gauges (``obs.replication.sample``), the freshness
        SLO gauges and the live telemetry server, on every open,
        read_remote and compact; ``CRDT_REPL_SAMPLE=0`` opts out.  A
        failed probe logs at debug and samples nothing: observability
        never fails the run it observes."""
        if not self._repl_sample:
            return None
        from ..obs import replication

        try:
            status = await self.replication_status(_backlog=_backlog)
        except Exception:
            logger.debug("replication status sampling failed", exc_info=True)
            return None
        replication.sample(status)
        try:
            from ..obs import live as obs_live
            from ..obs import slo as obs_slo

            obs_slo.sample_freshness(status)
            obs_live.publish(status)
        except Exception:
            logger.debug("slo/live sampling failed", exc_info=True)
        return status

    # ---------------------------------------------------------------- reads
    def _strong(self):
        """The stable prefix, made on first use."""
        if self._stable is None:
            from ..read.stable import StablePrefix

            self._stable = StablePrefix(self.adapter)
        return self._stable

    async def stable_prefix(self, *, refresh: bool = True):
        """Advance the stable prefix to the current (policy-adjusted)
        stability watermark and return its
        :class:`~crdt_enc_tpu_torch.read.stable.StableView`.  With
        ``refresh`` (default) ``read_remote()`` runs first, so the
        watermark reflects the latest published cursors;
        ``refresh=False`` trusts current knowledge (the fold service's
        post-cycle reads).  Monotone: the frontier never regresses
        within an incarnation."""
        from ..read.stable import (
            StableView,
            effective_watermark,
            find_holdouts,
        )

        if refresh:
            await self.read_remote()
        prefix = self._strong()
        wm, union, replicas, excluded = effective_watermark(
            self, policy=self._membership
        )
        await prefix.advance(self, wm)
        # sync summary section
        lag = sum(
            c - prefix.cursor.get(a)
            for a, c in union.counters.items()
            if c > prefix.cursor.get(a)
        )
        wm_lag = sum(c - wm.get(a, 0) for a, c in union.counters.items())
        view = StableView(
            cursor=prefix.cursor.copy(),
            watermark=dict(wm),
            lag=lag,
            watermark_lag=wm_lag,
            excluded=tuple(sorted(a.hex() for a in excluded)),
            holdouts=tuple(find_holdouts(self, wm, union, replicas)),
            wedged={a.hex(): r for a, r in sorted(prefix.wedged.items())},
        )
        trace.gauge("read_stable_lag", lag)
        return view

    async def read(
        self,
        *,
        linearizable: bool = False,
        max_lag: int | None = None,
        min_cursor: VClock | None = None,
        refresh: bool = True,
    ) -> ReadResult:
        """Read this replica's value.  ``linearizable=False`` (default)
        is the eventual tier: the live state's object form, no guarantee
        beyond CRDT convergence.  ``linearizable=True`` answers from the
        stable prefix, a fold every replica of the denominator provably
        holds, and refuses with
        :class:`~crdt_enc_tpu_torch.read.StalenessError` where the
        caller's bounds cannot be met: ``max_lag`` bounds how many
        versions the union may be ahead of the served frontier
        (``lag_exceeded``), ``min_cursor`` demands coverage of a target
        clock such as the caller's own last write (``uncovered_target``).
        No silent fallback: a caller that accepts eventual values on
        refusal catches the error and reads with ``linearizable=False``."""
        from ..read.stable import StalenessError

        if not linearizable:
            if max_lag is not None or min_cursor is not None:
                # bounds are strong-read only; dropping one would hand
                # back an eventual value the caller bounded
                raise ValueError(
                    "max_lag/min_cursor require linearizable=True"
                )
            d = self._data
            return ReadResult(
                obj=self.adapter.state_to_obj(d.state),
                consistency="eventual",
                cursor=d.next_op_versions.copy(),
            )
        with trace.span("read.strong"):
            trace.add("read_strong_total", 1)
            view = await self.stable_prefix(refresh=refresh)
            status = {
                "watermark": {a.hex(): c for a, c in view.watermark.items()},
                "lag": view.lag,
                "watermark_lag": view.watermark_lag,
                "excluded": list(view.excluded),
                "holdouts": list(view.holdouts),
                "wedged": dict(view.wedged),
            }
            if min_cursor is not None and not view.covers(min_cursor):
                trace.add("read_strong_refusals", 1)
                raise StalenessError(
                    "uncovered_target",
                    "stable prefix does not cover the requested clock "
                    f"(holdouts: {', '.join(view.holdouts) or 'none'}); "
                    "await_stable() or retry later",
                    status=status,
                )
            if max_lag is not None and view.lag > max_lag:
                trace.add("read_strong_refusals", 1)
                raise StalenessError(
                    "lag_exceeded",
                    f"stable prefix lags the union by {view.lag} versions "
                    f"(> max_lag {max_lag}); holdouts: "
                    f"{', '.join(view.holdouts) or 'none'}"
                    + (
                        f"; policy excluded: {', '.join(view.excluded)}"
                        if view.excluded else ""
                    ),
                    status=status,
                )
            prefix = self._strong()
            return ReadResult(
                obj=self.adapter.state_to_obj(prefix.state),
                consistency="strong",
                cursor=view.cursor,
                view=view,
            )

    async def contains(self, member, **kw) -> bool:
        """Point membership lookup (eventual, or linearizable with
        ``linearizable=True``; the keywords of :meth:`read`) for
        set-shaped states; ``TypeError`` for states without one."""
        state = await self._read_state(**kw)
        probe = getattr(state, "contains", None)
        if probe is None:
            raise TypeError(
                f"{type(state).__name__} has no membership lookup"
            )
        return bool(probe(member))

    async def value(self, **kw):
        """Point value lookup (keywords of :meth:`read`) for
        value-shaped states (counters, registers)."""
        state = await self._read_state(**kw)
        probe = getattr(state, "value", None)
        if probe is None:
            probe = getattr(state, "read", None)
        if probe is None:
            raise TypeError(f"{type(state).__name__} has no value()")
        return probe() if callable(probe) else probe

    async def _read_state(self, *, linearizable: bool = False, **kw):
        """The live or stable state behind the point lookups, read-only
        by contract."""
        if not linearizable:
            return self._data.state
        await self.read(linearizable=True, **kw)  # advances + enforces
        return self._strong().state

    async def await_stable(
        self,
        target: VClock,
        *,
        timeout_s: float = 30.0,
        poll_interval_s: float = 0.05,
        on_poll=None,
        clock=None,
    ):
        """Block until the stable prefix covers ``target`` (e.g. the
        caller's own last-write clock: read-your-writes made strong),
        re-reading the remote each poll.  Returns the covering
        :class:`StableView`; raises ``StalenessError`` (``timeout``) when
        ``timeout_s`` elapses first.  ``on_poll`` and ``clock`` replace
        the asyncio sleep and the monotonic clock for deterministic
        replays."""
        from ..read.stable import StalenessError

        clock = clock if clock is not None else time.monotonic
        t0 = clock()
        trace.add("read_await_total", 1)
        with trace.span("read.await"):
            refresh = False  # the first pass reuses current knowledge
            while True:
                view = await self.stable_prefix(refresh=refresh)
                if view.covers(target):
                    return view
                refresh = True
                if clock() - t0 >= timeout_s:
                    trace.add("read_await_timeouts", 1)
                    raise StalenessError(
                        "timeout",
                        f"watermark did not cover the target within "
                        f"{timeout_s}s; holdouts: "
                        f"{', '.join(view.holdouts) or 'none'}",
                        status={"holdouts": list(view.holdouts),
                                "excluded": list(view.excluded)},
                    )
                if on_poll is not None:
                    await on_poll()
                else:
                    await asyncio.sleep(poll_interval_s)

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

    # ------------------------------------------------------ fold checkpoints
    def _checkpoint_fingerprint(self) -> dict:
        """The warm-open validity seal: a checkpoint is only installable
        into a replica whose adapter, identity, data version, key
        generation (the latest data-key id: rotation invalidates) and
        converged remote metadata all match the sealing replica's.  The
        meta hash covers the canonical packed RemoteMeta, so a plugin
        config or key-register change on the remote (a wiped and
        recreated remote included) forces a cold refold."""
        latest = self._data.keys.latest_key()
        return {
            b"a": self.adapter.name,
            b"id": self.actor_id,
            b"dv": self.current_data_version,
            b"key": latest.id if latest is not None else b"",
            b"meta": self._remote_id(),
        }

    def _remote_id(self) -> bytes:
        """SHA3 of the canonical converged RemoteMeta: the identity of the
        remote this replica is attached to.  Cached; every meta merge
        drops the cache."""
        if self._remote_id_cache is None:
            self._remote_id_cache = hashlib.sha3_256(
                codec.pack(self._data.remote_meta.to_obj())
            ).digest()
        return self._remote_id_cache

    def _pack_checkpoint_state(self):
        """``(fmt, obj)`` for the current state: the columnar ORSet
        encoding when it applies losslessly, else the adapter's object
        form (the compacted snapshot's payload).

        A fresh sparse fold stashes its surviving rows on the state
        (``_ckpt_rows``, ops/columnar.py ``_orset_fresh_fold_native``);
        while the state's epoch still equals the one recorded there, the
        checkpoint packs straight from those rows with no dict walk, and
        ``checkpoint_from_rows`` counts it."""
        from ..models.orset import ORSet

        state = self._data.state
        if type(state) is ORSet:
            from ..ops.columnar import (
                orset_pack_checkpoint,
                orset_pack_checkpoint_rows,
            )

            stash = getattr(state, "_ckpt_rows", None)
            if stash is not None:
                # consumed either way: a stale stash is dead weight, and a
                # used one has served its purpose
                state._ckpt_rows = None
                if stash[0] == state._mut:
                    trace.add("checkpoint_from_rows", 1)
                    return (CHECKPOINT_FMT_ORSET,
                            orset_pack_checkpoint_rows(*stash[1]))
            obj = orset_pack_checkpoint(state)
            if obj is not None:
                return CHECKPOINT_FMT_ORSET, obj
        return CHECKPOINT_FMT_OBJ, self.adapter.state_to_obj(state)

    async def save_checkpoint(self, *, _packed: tuple | None = None,
                              _snap: tuple | None = None) -> bool:
        """Seal the materialized state, the ingest cursor and the
        read-snapshot set as this replica's local warm-open checkpoint
        (sealed with the data-key cryptor, stored through the storage's
        atomic local-checkpoint slot).  A later ``open`` restores it and
        ingests only the op tails past the cursor.  Returns False when
        checkpointing is off on this core.

        ``_packed`` is the fold service's pre-packed state payload,
        ``(fmt, obj, mut_epoch)``, packed from the dense planes it holds;
        used only while the state's epoch still equals ``mut_epoch``,
        else the live state is packed here, so the sealed (state,
        cursor) pair cannot tear.

        ``_snap`` is ``(snapshot_name, mut_epoch)`` from the compaction's
        seal: when the live state provably still equals the just-sealed
        snapshot (same mutation epoch), the checkpoint records its name
        (``snap``), so a warm reopen restores the delta-sealing base and
        keeps its chain unbroken."""
        if not self._checkpoint_enabled:
            return False
        with trace.span("checkpoint.save"):
            # sync section: every mutable input is materialized before the
            # first await, so a concurrent apply cannot tear the (state,
            # cursor) pair
            d = self._data
            if (
                _packed is not None
                and _packed[2] == getattr(d.state, "_mut", None)
            ):
                fmt, st = _packed[0], _packed[1]
            else:
                fmt, st = self._pack_checkpoint_state()
            sig = (
                dict(d.next_op_versions.counters), frozenset(d.read_states)
            )
            payload = {
                b"fmt": fmt,
                b"state": st,
                b"cursor": d.next_op_versions.to_obj(),
                b"rs": sorted(d.read_states),
                b"fp": self._checkpoint_fingerprint(),
                # the cursor matrix rides along so a warm open keeps its
                # replication view; observational — never fingerprinted
                b"cm": {
                    a: c.to_obj() for a, c in sorted(d.cursor_matrix.items())
                },
                # delta-chain continuity (both observational): the
                # per-sealer delta consumption cursor, and — only when
                # the epoch proves state == sealed snapshot — its name
                b"rd": dict(sorted(d.read_deltas.items())),
            }
            if self._stable is not None and self._stable.cursor.counters:
                # the stable prefix only grows, so a warm reopen resumes
                # the exposed strong-read frontier; observational, never
                # fingerprinted (a bad slot costs a cold rebuild)
                payload[b"sp"] = self._stable.to_obj()
            if (
                _snap is not None
                and _snap[1] is not None
                and _snap[1] == getattr(d.state, "_mut", None)
            ):
                payload[b"snap"] = _snap[0].encode()
            blob = await self._seal(payload)
            await self.storage.store_local_checkpoint(blob)
            self._checkpoint_sig = sig  # only a durable seal counts
            trace.add("checkpoint_bytes", len(blob))
        return True

    async def _checkpoint_fallback(self, reason: str) -> bool:
        """Record why a present checkpoint was rejected (the
        ``checkpoint_fallbacks`` counter and ``checkpoint_fallback_reason``),
        drop the rejected blob, and signal the cold path."""
        self.checkpoint_fallback_reason = reason
        trace.add("checkpoint_fallbacks", 1)
        logger.info("local checkpoint rejected (%s); opening cold", reason)
        await self.storage.remove_local_checkpoint()
        return False

    @staticmethod
    def _fp_bytes(v) -> bytes | None:
        return bytes(v) if isinstance(v, (bytes, bytearray, memoryview)) else None

    async def _open_from_checkpoint(self) -> bool:
        """Restore the local fold checkpoint if one exists and verifies:
        it decrypts under a known key, its fingerprint is current, and its
        cursor is still traceable against the remote listing.  A torn
        file, a decrypt failure or any mismatch falls back to the cold
        refold with the reason recorded — a checkpoint is a cache, never a
        source of truth.  The strong-read slot ``sp`` restores the stable
        prefix; a malformed one only rebuilds the prefix cold."""
        raw = await self.storage.load_local_checkpoint()
        if raw is None:
            return False
        with trace.span("checkpoint.load"):
            try:
                obj = await self._open_sealed(raw)
            except Exception:
                logger.debug("checkpoint undecryptable", exc_info=True)
                return await self._checkpoint_fallback("unreadable")
            with trace.span("checkpoint.verify"):
                try:
                    fp = dict(obj[b"fp"])
                    fmt = int(obj[b"fmt"])
                    cursor = VClock.from_obj(obj[b"cursor"])
                    read_states = {str(n) for n in obj[b"rs"]}
                    cursor_matrix = {
                        bytes(a): VClock.from_obj(c)
                        for a, c in (obj.get(b"cm") or {}).items()
                    }
                    read_deltas = {
                        bytes(a): int(v)
                        for a, v in (obj.get(b"rd") or {}).items()
                    }
                except Exception:
                    logger.debug("checkpoint malformed", exc_info=True)
                    return await self._checkpoint_fallback("malformed")
                expected = self._checkpoint_fingerprint()
                for field_key, reason in (
                    (b"a", "adapter"),
                    (b"id", "actor"),
                    (b"dv", "data_version"),
                    (b"key", "key_rotation"),
                    (b"meta", "remote_meta"),
                ):
                    if self._fp_bytes(fp.get(field_key)) != expected[field_key]:
                        return await self._checkpoint_fallback(reason)
                # cursor ⊆ remote listing: every actor the checkpoint
                # claims folded must still have its op log listed, or a
                # snapshot must exist (compaction GCs op logs into
                # snapshots; the CvRDT merge of read_remote converges
                # either way).  A remote with neither is not the remote
                # this checkpoint came from.
                if cursor.counters:
                    op_actors = set(await self.storage.list_op_actors())
                    covered = set(cursor.counters) <= op_actors or bool(
                        await self.storage.list_state_names()
                    )
                    if not covered:
                        return await self._checkpoint_fallback("cursor")
                try:
                    state = unpack_checkpoint_state(
                        self.adapter, fmt, obj[b"state"])
                except Exception:
                    logger.debug("checkpoint state undecodable", exc_info=True)
                    return await self._checkpoint_fallback("malformed")
            # sync install section: the resume point becomes the live
            # replica state; read_remote ingests only past the cursor
            d = self._data
            d.state = state
            d.next_op_versions = cursor
            d.read_states = read_states
            d.cursor_matrix = cursor_matrix
            d.read_deltas = read_deltas
            self._checkpoint_sig = (
                dict(cursor.counters), frozenset(read_states)
            )
            sp = obj.get(b"sp")
            if sp is not None:
                try:
                    from ..read.stable import StablePrefix

                    self._stable = StablePrefix.from_obj(self.adapter, sp)
                except Exception:
                    logger.debug(
                        "checkpoint stable-prefix slot undecodable; "
                        "strong reads rebuild cold", exc_info=True,
                    )
                    self._stable = None
            # delta-base continuity: when the checkpoint proves it was
            # sealed WITH the snapshot (state == snapshot, name known),
            # the next compaction keeps extending the delta chain instead
            # of breaking it with a delta-less seal
            snap = obj.get(b"snap")
            if (
                self._delta_enabled
                and isinstance(snap, (bytes, bytearray, memoryview))
            ):
                snap_name = bytes(snap).decode()
                if snap_name in read_states:
                    self._set_delta_base(
                        snap_name,
                        codec.pack(self.adapter.state_to_obj(state)),
                        cursor.to_obj(),
                    )
        self.opened_from_checkpoint = True
        return True

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
        return await self._seal_packed(codec.pack(payload_obj))

    async def _seal_packed(self, payload: bytes) -> bytes:
        """:meth:`_seal` of a payload already packed canonically."""
        inner = VersionBytes(self.current_data_version, payload)
        key = self._latest_key()
        middle = await self.cryptor.encrypt(key.material, inner.serialize())
        return VersionBytes(
            CURRENT_CONTAINER_VERSION, codec.pack([key.id, middle])
        ).serialize()

    async def _open_sealed(self, raw: bytes):
        return await open_sealed_blob(
            self._data.keys, self.cryptor, raw, self.supported_data_versions
        )

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
    async def read_remote(self, *, _sample: bool = True) -> None:
        """Ingest everything new: metadata, then snapshots, then op tails
        (consumer path, lib.rs:390-399).  ``_sample=False`` is compact's
        inner call: it samples once itself, after the GC."""
        await self._read_remote_meta()
        await self._read_remote_states()
        await self._read_remote_ops()
        if self._checkpoint_on_read and self._checkpoint_enabled:
            # a consumer replica reseals its resume point after every
            # ingest, but not after a quiet poll (same cursor and read
            # snapshots as the last seal): a quiet remote must not cost a
            # re-pack and an fsync per poll
            d = self._data
            sig = (
                dict(d.next_op_versions.counters), frozenset(d.read_states)
            )
            if sig != self._checkpoint_sig:
                await self.save_checkpoint()
        if _sample:
            # the ingest folded everything its own listing found: the
            # backlog is empty as of that listing, no second probe
            await self._sample_replication(_backlog=[])

    async def _read_remote_states(self) -> None:
        with trace.span("states.list"):
            names = await self.storage.list_state_names()
        new = [n for n in names if n not in self._data.read_states]
        if not new:
            # a quiet poll pays NO delta machinery: deltas are sealed
            # with their snapshots, so no unread snapshot ⇒ no new delta
            return
        if self._delta_enabled and getattr(self.storage, "has_deltas", False):
            # delta-first: chains that anchor at an already-merged base
            # snapshot fold without downloading the full snapshot; any
            # snapshot a chain cannot reach (gap, GC'd link, fingerprint
            # doubt, no codec) is full-loaded below — the delta layer can
            # save bytes but never lose data
            if await self._read_remote_deltas():
                new = [n for n in new if n not in self._data.read_states]
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
                    # [state, cursor] or [state, cursor, sealer]; a
                    # malformed sealer id is ignored (observational),
                    # never a read failure
                    return name, snapshot_sealer(obj), StateWrapper(
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
                self._data.state, [sw.state for _, _, sw in decoded]
            )
        trace.add("states_merged", len(decoded))
        for _, sealer, sw in decoded:
            self._data.next_op_versions.merge(sw.next_op_versions)
            if sealer is not None and sealer != self.actor_id:
                # learn the sealing replica's published ingest cursor —
                # the matrix row the stability watermark mins over
                self._data.cursor_matrix.setdefault(
                    sealer, VClock()
                ).merge(sw.next_op_versions)
        self._data.read_states.update(name for name, _, _ in decoded)

    # ------------------------------------------------------- delta chains
    def _delta_fallback(self, actor: Actor, version: int, reason: str) -> None:
        """One unusable delta link: counted (``delta_fallbacks``) and
        attributed, never silent — the snapshot path picks the slack up
        in the same pass, so this is an efficiency signal, not an error.
        The last reason is kept in ``last_delta_fallback_reason``."""
        trace.add("delta_fallbacks", 1)
        self.last_delta_fallback_reason = reason
        logger.debug(
            "delta chain fallback at %s:v%d (%s); using the snapshot path",
            actor.hex(), version, reason,
        )

    async def _read_remote_deltas(self) -> int:
        """Walk every sealer's delta log past the consumed cursor and
        apply each link whose base snapshot this replica has already
        merged (base NAME ∈ ``read_states`` — the content address is the
        fingerprint, so an unknown or renamed base is doubt and falls
        back).  Applying a link is byte-equal to merging its target
        snapshot (delta/codec.py contract), so the target name is marked
        read, its cursor merged, and the sealer's cursor-matrix row
        advanced — exactly the full-snapshot bookkeeping.  Returns the
        number of links applied."""
        from ..delta import codec_for, wire

        d = self._data
        codec_cls = codec_for(self.adapter.name)
        with trace.span("delta.read"):
            actors = await self.storage.list_delta_actors()
            wanted = [
                (a, d.read_deltas.get(a, 0) + 1) for a in sorted(actors)
            ]
            if not wanted:
                return 0
            files = await self.storage.load_deltas(wanted)
            if not files:
                return 0
            trace.add("delta_bytes_read", sum(len(raw) for _, _, raw in files))
            applied = 0
            chain = 0  # longest contiguous applied run this pass
            run: dict[Actor, int] = {}
            for actor, version, raw in files:
                # scanned-is-consumed: whatever this link's fate, the next
                # poll starts past it (its target stays reachable through
                # the snapshot listing)
                if version > d.read_deltas.get(actor, 0):
                    d.read_deltas[actor] = version
                try:
                    obj = await self._open_sealed(raw)
                    rec = wire.parse_delta_obj(obj)
                except MissingKeyError:
                    # unlike op ingest this is NOT loud: the full snapshot
                    # (sealed with the same key register) raises it if the
                    # key truly has not synced
                    self._delta_fallback(actor, version, "unknown_key")
                    continue
                except Exception:
                    logger.debug("delta undecodable", exc_info=True)
                    self._delta_fallback(actor, version, "unreadable")
                    continue
                if rec.adapter != self.adapter.name:
                    self._delta_fallback(actor, version, "adapter")
                    continue
                if rec.new_name in d.read_states:
                    continue  # already merged (idempotent re-delivery)
                if codec_cls is None:
                    self._delta_fallback(actor, version, "no_codec")
                    continue
                if not rec.base_name or rec.base_name not in d.read_states:
                    self._delta_fallback(actor, version, "base_missing")
                    continue
                # sync section: fold the link + full snapshot bookkeeping
                codec_cls.apply(d.state, rec.delta_obj)
                d.next_op_versions.merge(rec.new_cursor)
                d.read_states.add(rec.new_name)
                if rec.sealer != self.actor_id:
                    d.cursor_matrix.setdefault(
                        rec.sealer, VClock()
                    ).merge(rec.new_cursor)
                applied += 1
                run[actor] = run.get(actor, 0) + 1
                chain = max(chain, run[actor])
            if applied:
                trace.add("delta_applied", applied)
                trace.gauge("delta_chain_length", chain)
        return applied

    async def _read_remote_ops(self) -> None:
        with trace.span("ops.list"):
            actors = await self.storage.list_op_actors()
        wanted = [
            (a, self._data.next_op_versions.get(a) + 1) for a in sorted(actors)
        ]
        if not wanted:
            return
        if await self._read_remote_ops_pipelined(wanted, actors):
            return
        # whole-batch flow: no fold session for this state type (the
        # pipelined route declines before it reads anything)
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

    def _validate_chunk(self, files: list, clears: list, overlay=None,
                        blocked: set | None = None):
        """Sync section: ordered version bookkeeping for one chunk WITHOUT
        advancing the cursors (the caller advances only after the chunk's
        fold is accepted — a declined or failed chunk stays re-readable).
        ``overlay`` carries validated-but-not-yet-advanced versions across
        chunks in flight; ``blocked`` carries quarantine cuts (an actor
        whose run hit a damaged file folds nothing past the hole, and its
        cursor holds there).  Returns ``(payloads, metas)``; skew
        tolerance and gap errors as lib.rs:519-531."""
        payloads, metas = [], []
        local: dict[Actor, int] = overlay if overlay is not None else {}
        cut: set = blocked if blocked is not None else set()
        for (actor, version, _), clear in zip(files, clears):
            if actor in cut:
                continue
            expected = (
                max(self._data.next_op_versions.get(actor), local.get(actor, 0))
                + 1
            )
            if version < expected:
                continue  # concurrent-read tolerance (lib.rs:521-525)
            if clear is _QUARANTINED:
                cut.add(actor)  # already counted at the decrypt site
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
                cut.add(actor)
                continue
            payloads.append(inner.content)
            metas.append((actor, version))
            local[actor] = version
        return payloads, metas

    def _advance_cursors(self, metas: list) -> None:
        for actor, version in metas:
            self._data.next_op_versions.apply(Dot(actor, version))

    async def _fold_chunk_python(self, files: list, clears: list,
                                 blocked: set | None = None) -> None:
        """Per-op fold of one decrypted chunk (a state type without a
        session, or a session decline), bounded by the chunk size."""
        payloads, metas = self._validate_chunk(files, clears, blocked=blocked)
        if not payloads:
            return
        batch = []
        for p in payloads:
            batch.extend(self.adapter.op_from_obj(o) for o in codec.unpack(p))
        if batch:
            with trace.span("ops.fold"):
                self.accel.fold_ops(self._data.state, batch)
            trace.add("ops_folded", len(batch))
        self._advance_cursors(metas)

    async def _read_remote_ops_pipelined(self, wanted, actors) -> bool:
        """Bounded-memory overlapped ingest: a producer task streams chunks
        (``storage.iter_op_chunks`` → outer unwrap → batched native
        decrypt) through a small queue while this task validates, decodes
        and reduces them through a fold session — the read of chunk i+1
        overlaps the decrypt of chunk i and the fold of chunk i-1, and
        host memory is bounded by chunk size × queue depth (restructures
        the reference's lib.rs:471-547).

        Returns True when the stream was consumed; False hands the whole
        read to the whole-batch flow (no session for this state type)."""
        open_session = getattr(self.accel, "open_fold_session", None)
        if open_session is None:
            return False
        # cheap type gate BEFORE any pipeline machinery: a session-less
        # state type must not pay the producer's storage scan
        can_open = getattr(self.accel, "can_open_fold_session", None)
        if can_open is not None and not can_open(self._data.state):
            return False

        q: asyncio.Queue = asyncio.Queue(maxsize=2)

        async def produce():
            ci = 0  # chunk index: span meta
            cut: set = set()  # actors ended by an unwrap quarantine
            chunks = self.storage.iter_op_chunks(wanted).__aiter__()
            try:
                while True:
                    # the storage read of this chunk (the whole-batch
                    # flow's ``ops.load``)
                    with trace.span("ops.chunk_read", meta=ci):
                        try:
                            files = await chunks.__anext__()
                        except StopAsyncIteration:
                            break
                    trace.add("op_files_loaded", len(files))
                    with trace.span("ops.chunk_unwrap", meta=ci):
                        kept, key_ids, middles = [], [], []
                        for f in files:
                            actor, version, raw = f
                            if actor in cut:
                                continue
                            try:
                                outer = VersionBytes.deserialize(
                                    raw
                                ).ensure_versions(SUPPORTED_CONTAINER_VERSIONS)
                                kid, middle = codec.unpack(outer.content)
                            except Exception as e:
                                # torn outer envelope: quarantine the file
                                # and end this actor's dense run (the
                                # cursor holds at the hole)
                                self._note_quarantine(
                                    "op", f"{actor.hex()}:v{version}", e
                                )
                                cut.add(actor)
                                continue
                            kept.append(f)
                            key_ids.append(bytes(kid))
                            middles.append(bytes(middle))
                    files = kept
                    groups: dict[bytes, list[int]] = {}
                    for i, kid in enumerate(key_ids):
                        groups.setdefault(kid, []).append(i)
                    clears: list = [None] * len(files)
                    with trace.span("ops.chunk_decrypt", meta=ci):
                        for kid, idxs in groups.items():
                            key = self._data.keys.get_key(kid)
                            if key is None:
                                raise MissingKeyError(
                                    "ops sealed with unknown key "
                                    f"{uuid.UUID(bytes=kid)}; key metadata "
                                    "may not have synced yet"
                                )
                            outs = await self._decrypt_tolerant(
                                key,
                                [files[i] for i in idxs],
                                [middles[i] for i in idxs],
                            )
                            for i, clear in zip(idxs, outs):
                                clears[i] = clear
                    trace.add("bytes_decrypted", sum(len(m) for m in middles))
                    if files:
                        await q.put(("chunk", files, clears))
                        ci += 1
                await q.put(("end",))
            except Exception as e:
                await q.put(("error", e))

        from ..ops.stream import stream_producer_count
        from ..parallel.session import SessionDeclined

        producer = asyncio.create_task(produce())
        # one tick steps the producer into its first storage scan (a
        # worker thread), so the session's state walk below runs
        # concurrently with it
        await asyncio.sleep(0)
        try:
            session = open_session(self._data.state, actors_hint=actors)
        except BaseException:
            producer.cancel()
            raise
        if session is None:
            producer.cancel()
            try:
                await producer
            except (asyncio.CancelledError, Exception):
                pass
            return False
        session_done = False
        python_mode = False
        pending: list[tuple[list, list]] = []  # buffered below BULK_MIN_FILES
        pending_files = 0
        session_started = False
        fed_files = 0
        overlay: dict[Actor, int] = {}  # validated-but-unadvanced versions
        blocked: set[Actor] = set()  # actors cut at a quarantined file
        # decodes run in worker threads (the native calls release the
        # interpreter lock); reduces drain strictly first in, first out,
        # so per-actor cursors advance in version order even under a
        # mid-stream failure.  The in-flight width is the ingest
        # fan-out (the accelerator's ``stream_producers``, else
        # ops/stream.py's resolution), at least 2 (one decode of
        # lookahead).
        inflight: list[tuple] = []  # (decode_task, metas, files, clears)
        n_producers = getattr(self.accel, "stream_producers", 0)
        if n_producers <= 0:
            n_producers = stream_producer_count()
        max_decodes = max(2, n_producers)
        trace.gauge("stream_producers", n_producers)

        async def finish_session():
            # the state mutates ONLY here, and before any per-op fold (the
            # session's plane capture would clobber a direct fold).
            # Synchronous on purpose: in a worker thread an update()
            # landing between finish's read and its writeback would be
            # lost; one event-loop stall buys atomicity
            nonlocal session_done
            if not session_done:
                session_done = True
                with trace.span("ops.session_finish"):
                    session.finish()

        async def drain_one() -> None:
            """Complete the oldest in-flight chunk: await its decode,
            reduce it, advance its cursors.  A decline flips to per-op
            folds for it and everything after it."""
            nonlocal python_mode, fed_files
            task, metas, files, clears = inflight.pop(0)
            try:
                decoded = await task
                if python_mode:
                    raise SessionDeclined("session already degraded")
                with trace.span("ops.chunk_fold"):
                    await asyncio.to_thread(session.reduce_chunk, decoded)
            except SessionDeclined:
                trace.add("session_declined_chunks", 1)
                if not python_mode:
                    await finish_session()
                    python_mode = True
                await self._fold_chunk_python(files, clears, blocked)
                # later chunks in flight were validated ahead of this one:
                # fold them NOW, in order, or a newer chunk would fold
                # first and trip the version-gap check
                while inflight:
                    t2, _m2, f2, c2 = inflight.pop(0)
                    t2.cancel()
                    try:
                        await t2
                    except (asyncio.CancelledError, Exception):
                        pass
                    await self._fold_chunk_python(f2, c2, blocked)
                return
            self._advance_cursors(metas)
            fed_files += len(files)

        async def dispatch(files, clears) -> None:
            if python_mode:
                await self._fold_chunk_python(files, clears, blocked)
                return
            with trace.span("ops.chunk_validate"):
                payloads, metas = self._validate_chunk(
                    files, clears, overlay, blocked
                )
            if not payloads:
                return
            task = asyncio.create_task(
                asyncio.to_thread(session.decode_chunk, payloads)
            )
            inflight.append((task, metas, files, clears))
            if len(inflight) >= max_decodes:
                await drain_one()

        try:
            while True:
                # the fold sat starved of chunks: the reads' share of the
                # compaction's critical path
                with trace.span("ops.chunk_wait"):
                    item = await q.get()
                tag = item[0]
                if tag == "end":
                    break
                if tag == "error":
                    raise item[1]
                _, files, clears = item
                if not session_started and not python_mode:
                    pending.append((files, clears))
                    pending_files += len(files)
                    if pending_files < BULK_MIN_FILES:
                        continue
                    session_started = True
                    backlog, pending = pending, []
                    for f, c in backlog:
                        await dispatch(f, c)
                    continue
                await dispatch(files, clears)
            # stream consumed; a never-started tiny ingest folds per op,
            # the shape of the whole-batch small path
            while inflight:
                await drain_one()
            await finish_session()
            for files, clears in pending:
                await self._fold_chunk_python(files, clears, blocked)
            pending = []
            return True
        finally:
            producer.cancel()
            for task, *_ in inflight:
                task.cancel()
            # fold whatever was fed: chunks whose cursors advanced must
            # land in the state even on an exceptional exit
            await finish_session()
            if fed_files:
                trace.add("op_files_bulk_folded", fed_files)

    async def _read_remote_ops_bulk(self, files: list, actors) -> None:
        """Bulk ingestion: unwrap all outer envelopes, one batched decrypt
        per sealing key, then hand the raw payloads to the accelerator's
        columnar decode and fold.  Damaged files quarantine per file;
        key-auth and op-order violations raise as on the per-file path."""
        files, groups = self._unwrap_op_files(files)
        if not files:
            return  # every file quarantined: consumed, cursors held
        # one sealing key (the common case) and an accelerator with a
        # payload stream: chunked decrypt with one-chunk lookahead — the
        # default pool decrypts chunk i+1 (native, GIL released) while
        # this task validates and decodes chunk i; one fold at the end
        open_stream = getattr(self.accel, "open_payload_stream", None)
        stream = (
            open_stream(self._data.state, actors_hint=actors)
            if open_stream is not None and len(groups) == 1
            else None
        )
        payloads: list = []
        metas: list = []
        with trace.span("ops.bulk_decrypt"):
            if stream is not None:
                streamed_ok = await self._stream_bulk_chunks(
                    stream, files, groups[0], payloads, metas)
            else:
                clears: list = [None] * len(files)
                for key, idxs, mids in groups:
                    outs = await self._decrypt_tolerant(
                        key, [files[i] for i in idxs], mids
                    )
                    for i, clear in zip(idxs, outs):
                        clears[i] = clear
                payloads, metas = self._validate_chunk(files, clears)
        trace.add(
            "bytes_decrypted",
            sum(len(m) for _, _, mids in groups for m in mids),
        )
        if not payloads:
            return
        with trace.span("ops.bulk_fold"):
            if stream is not None and streamed_ok and stream.finish():
                self._advance_cursors(metas)
                trace.add("op_files_bulk_folded", len(payloads))
                return
            if stream is None and self.accel.fold_payloads(
                self._data.state, payloads, actors_hint=actors
            ):
                self._advance_cursors(metas)
                trace.add("op_files_bulk_folded", len(payloads))
                return
            # the accelerator declined (non-columnar state, vocabulary
            # collision): decode per op, fold as one batch
            batch = []
            for p in payloads:
                batch.extend(
                    self.adapter.op_from_obj(o) for o in codec.unpack(p)
                )
            self.accel.fold_ops(self._data.state, batch)
            self._advance_cursors(metas)
            trace.add("ops_folded", len(batch))

    async def _stream_bulk_chunks(self, stream, files: list, group,
                                  payloads: list, metas: list) -> bool:
        """The bulk ingest's chunked decrypt with one-chunk lookahead,
        ``BULK_STREAM_CHUNK`` files a chunk: each chunk is validated (no
        cursor moves) into ``payloads`` and ``metas`` and fed to
        ``stream`` while the next one decrypts.  Returns False once the
        stream declined a chunk (the rest are still validated, so the
        caller can replay every payload per op)."""
        key, idxs, mids = group
        CH = BULK_STREAM_CHUNK
        slices = [idxs[i : i + CH] for i in range(0, len(idxs), CH)]
        mid_slices = [mids[i : i + CH] for i in range(0, len(mids), CH)]
        overlay: dict[Actor, int] = {}
        barred: set[Actor] = set()  # actors cut at a quarantined file
        streamed_ok = True

        async def decrypt_chunk(si):
            # span-tagged with the chunk index, so the overlap with the
            # decode below shows in the trace event log
            with trace.span("stream.decrypt", meta=si):
                return await self._decrypt_tolerant(
                    key, [files[i] for i in slices[si]], mid_slices[si]
                )

        nxt = asyncio.create_task(decrypt_chunk(0))
        try:
            for si, sl in enumerate(slices):
                clears = await nxt
                nxt = (
                    asyncio.create_task(decrypt_chunk(si + 1))
                    if si + 1 < len(slices)
                    else None
                )
                if nxt is not None:
                    # one tick steps the new task into its worker thread,
                    # so it decrypts WHILE this task validates and decodes
                    await asyncio.sleep(0)
                # sync: inner version checks WITHOUT cursor advance —
                # cursors move only after the fold lands
                with trace.span("stream.validate", meta=si):
                    p, m = self._validate_chunk(
                        [files[i] for i in sl], clears, overlay, barred
                    )
                metas.extend(m)
                payloads.extend(p)
                if streamed_ok:
                    with trace.span("stream.decode", meta=si):
                        streamed_ok = stream.feed(p)
        finally:
            if nxt is not None:
                nxt.cancel()
                try:
                    await nxt
                except (asyncio.CancelledError, Exception):
                    pass
        return streamed_ok

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

    async def load_sealed_ops(self):
        """The fold service's ingest front end (serve/service.py): list,
        load and outer-unwrap every op file past the local cursor,
        grouping the ciphertexts by sealing key, WITHOUT decrypting,
        validating, folding or advancing any cursor.  Returns ``(actors,
        files, groups)``, ``groups`` being ``[(key, idxs, middles)]``:
        the service opens many tenants' groups in one worker-thread hop
        (``Cryptor.decrypt_batch_fn``), validates through
        :meth:`_validate_chunk` and advances cursors only after its fold
        lands — the bulk ingest's discipline.  Nothing is decrypted here,
        so nothing counts under ``bytes_decrypted``."""
        with trace.span("ops.list"):
            actors = await self.storage.list_op_actors()
        wanted = [
            (a, self._data.next_op_versions.get(a) + 1) for a in sorted(actors)
        ]
        if not wanted:
            return [], [], []
        with trace.span("ops.load"):
            files = await self.storage.load_ops(wanted)
        trace.add("op_files_loaded", len(files))
        if not files:
            return actors, [], []
        files, groups = self._unwrap_op_files(files)
        return actors, files, groups

    # --------------------------------------------------------------- compact
    async def compact(self) -> None:
        """Fold everything, snapshot, write-new-then-delete-old
        (north-star path, lib.rs:332-380)."""
        with trace.span("core.compact"):
            with trace.span("compact.ingest"):
                await self.read_remote(_sample=False)
            await self._compact_seal()

    async def _compact_seal(
        self, *, _backlog: list | None = None,
        _packed_state: tuple | None = None,
        _state_obj: tuple | None = None,
        _delta_cut: dict | None = None,
    ) -> None:
        """The seal tail of :meth:`compact`: snapshot the CURRENT state +
        cursor, write the new snapshot and its delta, collect the deltas,
        snapshots and op files it covers, reseal the warm-open
        checkpoint, sample replication and append the sink record.

        The fold service installs a batch-folded state and then runs this
        same tail, so a served tenant's remote cannot drift from a solo
        ``compact()``.  ``_backlog`` goes to the replication sample (the
        service passes ``[]``: its ingest folded everything its listing
        found, so N tenants pay no N per-actor storage probes).
        ``_packed_state`` goes to :meth:`save_checkpoint`;
        ``_state_obj`` is ``(obj, mut_epoch)``, a snapshot object built
        from the fold's writeback, used only while the epoch still
        matches (the canonical packer re-sorts maps, so an equivalent
        object seals the same bytes); ``_delta_cut`` is the service's
        device-cut delta, checked in :meth:`_plan_delta_seal`."""
        # sync section: the snapshot/cursor/delta-plan cut comes from ONE
        # loop slice — an await here would let an ingest interleave and
        # seal a torn (state, cursor, delta) triple
        d = self._data
        if _state_obj is not None and _state_obj[1] == getattr(
            d.state, "_mut", None
        ):
            state_obj = _state_obj[0]
        else:
            with trace.span("compact.to_obj"):
                state_obj = self.adapter.state_to_obj(d.state)
        cursor_obj = d.next_op_versions.to_obj()
        snap_mut = getattr(d.state, "_mut", None)
        with trace.span("compact.seal"):
            # packed once: the snapshot payload and the delta plan's next
            # base share these bytes
            state_bytes = codec.pack(state_obj)
        delta_plan = self._plan_delta_seal(state_bytes, cursor_obj,
                                           _cut=_delta_cut)
        # sealer id: readers attribute the cursor to this replica
        with trace.span("compact.payload"):
            payload = snapshot_payload(state_bytes, cursor_obj, self.actor_id)
        states_to_remove = sorted(d.read_states)
        ops_to_remove = sorted(d.next_op_versions.counters.items())
        prior_names = frozenset(d.read_states)
        # consumed-prefix GC covers FOREIGN logs only: the own log is
        # governed by _seal_delta's MAX_CHAIN bound — a stale reopen that
        # re-scanned its own chain must not wipe links steady consumers
        # are still walking
        deltas_to_remove = sorted(
            (a, v) for a, v in d.read_deltas.items() if a != self.actor_id
        )
        with trace.span("compact.seal"):
            blob = await self._seal_packed(payload)
        # crash safety: the new snapshot is durable before anything vanishes
        with trace.span("compact.write"):
            name = await self.storage.store_state(blob)
        if delta_plan is not None:
            # the delta lands AFTER its target snapshot is durable (a crash
            # between the two leaves a snapshot consumers simply full-read)
            # and BEFORE the GC below
            await self._seal_delta(delta_plan, name)
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
            if deltas_to_remove and self._delta_enabled:
                # consumed delta prefixes go FIRST: the new snapshot covers
                # them, and removing them before their target snapshots
                # keeps any crash window free of dangling chain heads
                await self.storage.remove_deltas(deltas_to_remove)
            await asyncio.gather(
                self.storage.remove_states(stale_states),
                self.storage.remove_ops(ops_to_remove),
            )
        # sync bookkeeping section
        d.read_states.difference_update(stale_states)
        d.read_states.add(name)
        # what this seal depended on, at the snapshot's epoch: the fold
        # service skips the next seal while this has not moved (a
        # mutation landing mid-seal keeps the epochs apart)
        self._last_seal_sig = self._seal_signature(_mut=snap_mut)
        if self._checkpoint_enabled:
            # the freshly compacted state is the ideal warm-open resume
            # point: everything folded, op logs collected to the cursor
            await self.save_checkpoint(
                _packed=_packed_state, _snap=(name, snap_mut)
            )
        # replication status after the GC and the checkpoint (backlog and
        # staleness zero by construction): it rides into the sink record
        status = await self._sample_replication(_backlog=_backlog)
        from ..obs import sink as obs_sink

        if obs_sink.default_sink() is not None:
            # off the event loop: json.dumps and the append of a record
            # that may carry a full event ring must not stall ingests
            await asyncio.to_thread(
                obs_sink.maybe_write,
                "compact",
                {"gc_op_actors": len(ops_to_remove),
                 "gc_states": len(states_to_remove)},
                status,
            )

    # --------------------------------------------------------- delta sealing
    @property
    def delta_base_name(self) -> str | None:
        """Content-addressed name of the retained diff base (the last
        snapshot this replica sealed), or None.  The fold service matches
        it against a warm entry's ``seal_name`` to decide whether the
        tenant's delta can be cut on the device this cycle."""
        base = self._delta_base
        return base["name"] if base is not None else None

    def _seal_signature(self, _mut=None) -> tuple:
        """Everything a re-seal of the current state depends on: the op
        cursor, the read snapshot and delta sets, and the state's
        mutation epoch (``_mut`` overrides the live one).  Two equal
        signatures mean ``_compact_seal`` would publish the identical
        snapshot and GC set, so the fold service may skip it."""
        d = self._data
        return (
            tuple(sorted(d.next_op_versions.counters.items())),
            frozenset(d.read_states),
            tuple(sorted(d.read_deltas.items())),
            getattr(d.state, "_mut", None) if _mut is None else _mut,
        )

    def _plan_delta_seal(self, state_bytes: bytes, cursor_obj, _cut=None):
        """Sync section of the delta seal: diff the about-to-be-sealed
        state against the retained base (this replica's previous
        snapshot) and hand the await half (:meth:`_seal_delta`) an
        immutable plan.  Runs BEFORE the first await of the seal tail so
        a concurrent apply cannot tear the (base, new, delta) triple.

        The plan always carries ``new_bytes`` — ``state_bytes``, the
        canonical packed state — which becomes the NEXT base even when no
        delta can be cut this round (first seal, no codec, failed diff);
        ``dobj`` is None then and consumers fall back to the full snapshot
        for this link only.

        ``_cut`` is the fold service's device-cut delta: taken as the
        plan's delta only while its base name and mutation epoch still
        match this replica's base and state, with the base planes kept
        for the self-verify."""
        if not self._delta_enabled or not getattr(
            self.storage, "has_deltas", False
        ):
            return None
        from ..delta import codec_for

        codec_cls = codec_for(self.adapter.name)
        if codec_cls is None:
            return None
        with trace.span("delta.plan"):
            plan = {
                "new_bytes": state_bytes,
                "cursor": cursor_obj,
                "dobj": None,
                "codec": codec_cls,
                "base_state": None,
                "base_name": "",
                "base_cursor": None,
            }
            base = self._delta_base
            if base is None:
                return plan
            if (
                _cut is not None
                and _cut.get("base_name") == base["name"]
                and _cut.get("mut") == getattr(self._data.state, "_mut", None)
            ):
                # device-cut: the service compared the base and post-fold
                # planes on the card and built the wire object from the
                # diff rows alone; no host walk, no host base bytes
                plan["dobj"] = _cut["dobj"]
                plan["base_planes"] = _cut.get("base_planes")
                plan["base_name"] = base["name"]
                plan["base_cursor"] = base["cursor"]
                plan["device_cut"] = True
                trace.add("delta_device_cuts", 1)
                return plan
            if base["bytes"] is None:
                # a device-cut seal dropped the bytes and this cycle's cut
                # does not line up (warm-tier eviction, an epoch bump):
                # one snapshot-only link re-anchors the chain and
                # re-retains the bytes
                trace.add("delta_cut_fallbacks", 1)
                trace.add("delta_seal_skipped", 1)
                return plan
            try:
                base_state = self.adapter.state_from_obj(
                    codec.unpack(base["bytes"])
                )
                dobj = codec_cls.diff(base_state, self._data.state)
            except Exception:
                logger.warning(
                    "delta diff failed; sealing snapshot only", exc_info=True
                )
                trace.add("delta_seal_skipped", 1)
                return plan
        if dobj is None:
            trace.add("delta_seal_skipped", 1)
            return plan
        # the size guard and self-verify run in _seal_delta's await half
        # (everything they read is an immutable plan-owned copy) — only
        # the diff against the LIVE state needed this sync section
        plan["dobj"] = dobj
        plan["base_state"] = base_state
        plan["base_name"] = base["name"]
        plan["base_cursor"] = base["cursor"]
        return plan

    def _set_delta_base(self, name: str, state_bytes: bytes | None,
                        cursor_obj) -> None:
        """Retain the just-sealed snapshot as the next diff base.
        ``state_bytes`` is a resident O(state) canonical copy per Core —
        deliberate (the alternative is re-decrypting the sealed snapshot
        every compact) but not free, so its size is published
        (``delta_base_bytes``) and the subsystem is opt-out
        (``OpenOptions.delta``).  A tenant whose seal rode the device cut
        passes None: the warm tier's planes are the base, and the next
        cycle cuts on the card again or seals one snapshot-only link that
        re-retains the bytes."""
        self._delta_base = {
            "name": name, "bytes": state_bytes, "cursor": cursor_obj,
        }
        trace.gauge("delta_base_bytes",
                    0 if state_bytes is None else len(state_bytes))

    def _verify_delta_plan(self, plan) -> bool:
        """The refusal-to-publish guard (worker thread — the plan owns
        every input, so nothing races the live state): apply the delta to
        the base copy and require byte-identity with the sealed state.  A
        codec bug must surface HERE, on the sealer, not as divergence
        scattered across the fleet."""
        with trace.span("delta.verify"):
            try:
                base_state = plan["base_state"]
                if base_state is None:
                    # device-cut plan: rebuild the base from the plan's
                    # base planes (canonical by the fold's output law;
                    # zero padding reconstructs to nothing)
                    from ..ops.columnar import orset_planes_to_state

                    clock, add, rm, members, replicas = plan["base_planes"]
                    base_state = orset_planes_to_state(
                        _host(clock), _host(add), _host(rm), members,
                        replicas,
                    )
                plan["codec"].apply(base_state, plan["dobj"])
                return (
                    codec.pack(self.adapter.state_to_obj(base_state))
                    == plan["new_bytes"]
                )
            except Exception:
                logger.warning("delta verify crashed", exc_info=True)
                return False

    async def _seal_delta(self, plan, name: str) -> None:
        """Await half of the delta seal: wire-build, seal with the data
        key, publish at the next own-log version (FileExistsError probes
        forward — the op-file discipline), persist the bumped local-meta
        cursor, and retain the new base.  A delta-less round (``dobj``
        None: no base, a delta no smaller than the state, or one that does
        not refold to it) wipes the own log instead: a chain that cannot
        extend to the new snapshot is dead weight every consumer would
        scan and fall back on."""
        from ..delta import MAX_CHAIN, wire
        from ..obs.replication import stability_watermark

        d = self._data
        assert self._local_meta is not None
        if name == plan["base_name"]:
            return  # idempotent re-seal of the identical snapshot
        if plan["dobj"] is not None:
            if len(codec.pack(plan["dobj"])) >= len(plan["new_bytes"]):
                # a delta no smaller than the state saves nothing
                trace.add("delta_seal_skipped", 1)
                plan["dobj"] = None
            elif self._delta_verify and not await asyncio.to_thread(
                self._verify_delta_plan, plan
            ):
                logger.warning(
                    "delta diff does not refold to the sealed state; "
                    "refusing to publish it (snapshot only)"
                )
                trace.add("delta_seal_divergence", 1)
                plan["dobj"] = None
        if plan["dobj"] is None:
            self._set_delta_base(name, plan["new_bytes"], plan["cursor"])
            last = self._local_meta.last_delta_version
            if last:
                trace.add("delta_pruned", 1)
                await self.storage.remove_deltas([(self.actor_id, last)])
            return
        with trace.span("delta.seal"):
            union = d.next_op_versions.copy()
            for clock in d.cursor_matrix.values():
                union.merge(clock)
            rec = wire.DeltaRecord(
                base_name=plan["base_name"],
                new_name=name,
                base_cursor=VClock.from_obj(plan["base_cursor"]),
                new_cursor=VClock.from_obj(plan["cursor"]),
                sealer=self.actor_id,
                adapter=self.adapter.name,
                watermark=stability_watermark(
                    self.actor_id, d.next_op_versions, d.cursor_matrix, union
                ),
                delta_obj=plan["dobj"],
            )
            blob = await self._seal(wire.build_delta_obj(rec))
            version = self._local_meta.last_delta_version + 1
            while True:
                try:
                    await self.storage.store_delta(
                        self.actor_id, version, blob
                    )
                    break
                except FileExistsError:
                    version += 1
            self._local_meta.last_delta_version = version
            await self._store_local_meta()
            trace.add("delta_files_sealed", 1)
            trace.add("delta_bytes_sealed", len(blob))
            # own-log bound: consumers further than MAX_CHAIN behind
            # re-read the full snapshot once and rejoin the chain
            if version > MAX_CHAIN:
                trace.add("delta_pruned", 1)
                await self.storage.remove_deltas(
                    [(self.actor_id, version - MAX_CHAIN)]
                )
        # a published device cut proves the warm planes ARE this
        # snapshot: drop the host base copy
        self._set_delta_base(
            name,
            None if plan.get("device_cut") else plan["new_bytes"],
            plan["cursor"],
        )

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
                self._remote_id_cache = None
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
            self._remote_id_cache = None
            await self._store_remote_meta()

    async def set_remote_meta_cryptor(self, reg: MVReg) -> None:
        async with self._meta_lock:
            self._data.remote_meta.cryptor.merge(reg)
            self._remote_id_cache = None
            await self._store_remote_meta()

    async def set_remote_meta_key_cryptor(self, reg: MVReg) -> None:
        async with self._meta_lock:
            self._data.remote_meta.key_cryptor.merge(reg)
            self._remote_id_cache = None
            await self._store_remote_meta()
