"""Schedule execution: real Cores, one hostile remote, full checks.

The port's copy of ``crdt_enc_tpu/sim/runner.py``.  Runs a
:class:`~crdt_enc_tpu_torch.sim.schedule.Schedule` against a fleet of
REAL :class:`~crdt_enc_tpu_torch.core.core.Core` instances — even
replicas on the host reference (``HostAccelerator``), odd replicas on a
``TorchAccelerator`` on the runner's device (the card unless the caller
asks for the CPU), and :class:`~crdt_enc_tpu_torch.serve.FoldService`
and :class:`~crdt_enc_tpu_torch.serve.FleetDaemon` cycles all in the
same history — sharing one remote through per-replica
:class:`~crdt_enc_tpu_torch.sim.faults.FaultyStorage` wrappers.  No
mocks on the system-under-test side: every byte travels the production
wire format and every fold runs the production paths.  The oracle
refold, the warm≡cold pair's host side and fsck run on the host
reference, so the oracle stays independent of the device folds.

Determinism: with the default memory backend the whole run is a pure
function of the schedule.  Besides the seeded fault rolls, the two real
entropy sources are patched for the run's duration — ``uuid.uuid4``
(actor and key ids) draws from a schedule-seeded stream, and key
material comes from :class:`DeterministicCryptor` — so fault patterns,
file names, and final states replay bit-for-bit
(``SimResult.fingerprint`` pins it).  The fs backend keeps thread-pool
timing, so it is exercised for coverage, not replay fidelity.

Error discipline while faults are active:

* :class:`SimCrash` from a write step = that replica crashed — its Core
  is discarded and storage keeps whatever landed (later ``reopen``);
* :class:`MissingKeyError` / :class:`StaleWriterError` /
  :class:`IngestDecryptError` = documented loud-but-transient states
  (key metadata, own history, or a whole batch of blobs not yet synced
  intact); the step is a no-op and the occurrence is counted;
* anything else is a **violation** (kind ``step_error``): the fault
  classes are all survivable by design, so an unexpected exception is a
  robustness bug, exactly what the simulator hunts.
"""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import hashlib
import json
import logging
import os
import random
import uuid
from collections import Counter
from dataclasses import dataclass, field

from ..backends.identity_crypto import IdentityCryptor
from ..core.adapters import HostAccelerator
from ..core.core import (
    Core,
    IngestDecryptError,
    MissingKeyError,
    OpenOptions,
    StaleWriterError,
    open_sealed_blob,
)
from ..utils import trace
from ..utils.versions import IDENTITY_KEY_VERSION_1
from .check import (
    InvariantViolation,
    Violation,
    divergence_detail,
    known_replica_set,
    replication_regression,
)
from .faults import FaultyStorage, SimCrash
from .schedule import Schedule

logger = logging.getLogger("crdt_enc_tpu_torch.sim")

QUIESCE_MAX_ROUNDS = 8
WARM_COLD_SAMPLES = 2  # replicas per quiescence given the warm≡cold check


class DeterministicCryptor(IdentityCryptor):
    """Identity cryptor with seeded key material, so key registers —
    and therefore every content-addressed file name — replay exactly."""

    def __init__(self, seed: str):
        self._rng = random.Random(f"crdt-sim-key-{seed}")

    async def gen_key(self):
        from ..utils.version_bytes import VersionBytes

        return VersionBytes(
            IDENTITY_KEY_VERSION_1, self._rng.getrandbits(256).to_bytes(32, "big")
        )


# The per-run uuid stream lives in a ContextVar, not a bare global: a
# population run (sim/population.py) executes P schedules concurrently in
# one event loop, and each lane's task context — inherited by every child
# task and to_thread hop it spawns — carries its OWN schedule-seeded
# stream.  A serial run sees exactly the historical single stream, and
# code outside any sim context falls through to the real uuid4.
_UUID_RNG: contextvars.ContextVar = contextvars.ContextVar(
    "crdt_sim_uuid_rng", default=None
)
_uuid_orig = None
_uuid_patches = 0


def _context_uuid4():
    rng = _UUID_RNG.get()
    if rng is None:
        return _uuid_orig()
    return uuid.UUID(int=rng.getrandbits(128), version=4)


@contextlib.contextmanager
def _deterministic_uuid(seed: int):
    """Route ``uuid.uuid4`` to a schedule-seeded stream for the run:
    actor ids and key ids are the only remaining entropy behind file
    names and sort orders.  The stream is context-local (see above);
    the global ``uuid.uuid4`` patch is refcounted so overlapping
    population lanes install it once and the real uuid4 is restored
    when the last lane exits.  The event loop is single-threaded, so
    the refcount needs no lock."""
    global _uuid_orig, _uuid_patches
    rng = random.Random(f"crdt-sim-uuid-{seed}")
    token = _UUID_RNG.set(rng)
    if _uuid_patches == 0:
        _uuid_orig = uuid.uuid4
        uuid.uuid4 = _context_uuid4
    _uuid_patches += 1
    try:
        yield
    finally:
        _uuid_patches -= 1
        if _uuid_patches == 0:
            uuid.uuid4 = _uuid_orig
            _uuid_orig = None
        _UUID_RNG.reset(token)


@dataclass
class SimResult:
    violation: Violation | None
    steps_run: int = 0
    checks_run: int = 0
    fault_stats: Counter = field(default_factory=Counter)
    transient_missing_key: int = 0
    service_cycles: int = 0
    daemon_cycles: int = 0
    quarantined: int = 0
    strong_reads: int = 0
    strong_timeouts: int = 0
    fingerprint: str = ""

    @property
    def ok(self) -> bool:
        return self.violation is None


@dataclass
class _Replica:
    idx: int
    storage: FaultyStorage
    core: Core | None = None
    incarnation: int = 0
    last_status: dict | None = None  # per-incarnation monotonicity baseline
    actor_id: bytes | None = None  # survives crashes (dgc targets it)
    # strong-read session baseline (sim/linearize.py): the previous
    # strong cursor of THIS incarnation (a cold reopen starts a new
    # session), and the last clock a SUCCESSFUL
    # await_stable promised coverage of (the read-your-writes oblig.)
    last_strong: object | None = None
    awaited: object | None = None


class _TapStorage:
    """The oracle's recording seam: wraps a replica's REAL (inner)
    storage so every op file that durably lands is captured as
    plaintext the moment it is written — BEFORE compaction GC can erase
    it and INSIDE the fault wrapper (a crash-before never reaches the
    tap, a crash-after raises only after the tap recorded the landed
    file).  Decryption happens eagerly with the writing core's own key
    material (the sealer necessarily holds its sealing key), so key
    rotation mid-history costs the oracle nothing.  Everything else
    delegates untouched — the system under test sees its normal
    storage."""

    def __init__(self, inner, oplog: dict):
        self.inner = inner
        self._oplog = oplog
        self.core = None  # set by the runner after Core.open

    def __getattr__(self, name):
        return getattr(self.inner, name)

    async def store_ops(self, actor, version, data):
        await self.inner.store_ops(actor, version, data)
        core = self.core
        if core is not None:
            payload = await open_sealed_blob(
                core._data.keys, core.cryptor, data, None
            )
            self._oplog[(bytes(actor), int(version))] = payload


class SimRunner:
    """One schedule execution.  ``tmpdir`` is required for the fs
    backend (the shared remote + per-replica local dirs live under it);
    the memory backend ignores it.  ``device`` is where odd replicas fold
    (``None`` means ``"cuda"``, which raises without a card;
    ``"cpu"`` runs the kernels' plain PyTorch versions).  ``mesh`` (a
    ``parallel.mesh.Mesh``; default the substrate's) makes the
    ``service`` and ``daemon`` steps fold on that mesh."""

    def __init__(self, schedule: Schedule, *, tmpdir: str | None = None,
                 device=None, mesh=None, substrate=None):
        self.schedule = schedule
        self.tmpdir = tmpdir
        # population mode (sim/population.py): the shared substrate
        # supplies the ONE process-wide accelerator and FoldService
        # every lane folds through — the warm tier and the device plane
        # cache are fleet-wide, while storage, fault rolls, cryptors, and
        # the uuid stream stay strictly per-lane
        self.substrate = substrate
        if substrate is not None:
            device = substrate.accel.device
            if mesh is None:
                mesh = substrate.mesh
        self.mesh = mesh  # service and daemon cycles fold on the mesh
        self.device = "cuda" if device is None else device
        self.replicas: list[_Replica] = []
        self.members = [
            f"member-{i}".encode() for i in range(schedule.members)
        ]
        self.transient_missing_key = 0
        self.service_cycles = 0
        self.daemon_cycles = 0
        self.checks_run = 0
        # strong-read oracle (sim/linearize.py): plaintext of every op
        # file that ever landed, recorded by the _TapStorage seam —
        # compaction GC cannot erase the checker's evidence
        self._oplog: dict = {}
        self.strong_count = 0
        self.strong_timeouts = 0
        self._remote = None  # memory backend's shared MemoryRemote
        # persistent FleetDaemon for the daemon/ddrain vocabulary: one
        # control-plane instance lives ACROSS steps (that is the point —
        # its backoff/quarantine state meets the same hostile history
        # the replicas do); created lazily at the first daemon step
        self._daemon = None
        # ONE FoldService reused across every `service` step (the sim
        # fast path): service construction — warm tier,
        # config, telemetry wiring — was per-step overhead; run_cycle's
        # tenant-subset override cycles exactly the step's replicas, and
        # the shared warm tier's identity×epoch guard keeps reuse
        # byte-exact across the hostile history
        self._service_pool = None

    # ----------------------------------------------------------- plumbing
    def _inner_storage(self, idx: int):
        if self.schedule.backend == "memory":
            from ..backends.memory import MemoryRemote, MemoryStorage

            if self._remote is None:
                self._remote = MemoryRemote()
            return MemoryStorage(self._remote)
        if self.tmpdir is None:
            raise ValueError("fs backend needs a tmpdir")
        from ..backends.fs import FsStorage

        return FsStorage(
            os.path.join(self.tmpdir, f"r{idx}"),
            os.path.join(self.tmpdir, "remote"),
        )

    def _clean_storage(self, label: str):
        """A fresh, fault-free storage over the same remote (oracle,
        fsck): its local side is private scratch."""
        if self.schedule.backend == "memory":
            from ..backends.memory import MemoryStorage

            return MemoryStorage(self._remote)
        from ..backends.fs import FsStorage

        return FsStorage(
            os.path.join(self.tmpdir, f"check-{label}"),
            os.path.join(self.tmpdir, "remote"),
        )

    def _accel(self, idx: int):
        # odd replicas fold on the device, even on the host reference —
        # both execution paths face every history
        if idx % 2 == 1:
            if self.substrate is not None:
                # one accelerator for the whole population: its plane
                # cache is state-identity keyed (never aliases across
                # lanes)
                return self.substrate.accel
            from ..parallel.accel import TorchAccelerator

            return TorchAccelerator(self.device, min_device_batch=1)
        return HostAccelerator()

    def _opts(self, rep: _Replica, *, create: bool, storage=None,
              checkpoint: bool = True, host: bool = False) -> OpenOptions:
        from ..backends.plain_keys import PlainKeyCryptor
        from ..core.adapters import orset_adapter
        from ..utils.versions import DEFAULT_DATA_VERSION_1

        return OpenOptions(
            storage=storage if storage is not None else rep.storage,
            cryptor=DeterministicCryptor(f"{self.schedule.seed}:{rep.idx}"),
            key_cryptor=PlainKeyCryptor(),
            adapter=orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1,
            create=create,
            checkpoint=checkpoint,
            delta=self.schedule.deltas,
            accelerator=HostAccelerator() if host else self._accel(rep.idx),
        )

    async def _open(self, rep: _Replica, *, create: bool) -> None:
        rep.core = await Core.open(self._opts(rep, create=create))
        rep.actor_id = rep.core.actor_id
        rep.incarnation += 1
        rep.last_status = None  # monotonicity holds per incarnation
        # a reopen starts a new strong-read session: a cold rebuild may
        # legitimately expose an older frontier,
        # and any read-your-writes obligation died with the session
        rep.last_strong = None
        rep.awaited = None
        tap = getattr(rep.storage, "inner", None)
        if isinstance(tap, _TapStorage):
            tap.core = rep.core

    # --------------------------------------------------------------- run
    def run(self) -> SimResult:
        """Execute the schedule + final quiescence check.  Returns a
        :class:`SimResult`; protocol violations land on
        ``result.violation`` instead of raising, so the shrinker and
        the CLI share one calling convention."""
        return asyncio.run(self.run_async())

    async def run_async(self) -> SimResult:
        """Population entry (sim/population.py): the same run, awaited
        inside an already-running event loop so P lanes share one loop
        and one substrate.  The uuid stream installs into THIS task's
        context only — concurrent lanes never see each other's draws."""
        with _deterministic_uuid(self.schedule.seed):
            return await self._run()

    async def _run(self) -> SimResult:
        sched = self.schedule
        trace.add("sim_schedules", 1)
        result = SimResult(violation=None)
        with trace.span("sim.run", meta=sched.seed):
            for i in range(sched.n_replicas):
                inner = self._inner_storage(i)
                if sched.strong_reads:
                    # the tap sits INSIDE the fault wrapper: it records
                    # exactly the files that durably land (crash-before
                    # never reaches it, crash-after raises only after
                    # it recorded).  Only strong-read schedules pay it,
                    # so every earlier fixture replays untouched.
                    inner = _TapStorage(inner, self._oplog)
                wrapper = FaultyStorage(
                    inner, sched.faults, seed=sched.seed, name=f"r{i}"
                )
                rep = _Replica(i, wrapper)
                self.replicas.append(rep)
            # bootstrap with faults off: a fleet that cannot even form
            # (e.g. every replica's key bootstrap crashes) explores
            # nothing — the adversary starts once the fleet exists
            for rep in self.replicas:
                rep.storage.heal()
            for rep in self.replicas:
                await self._open(rep, create=True)
            for rep in self.replicas:
                rep.storage.arm()

            # per-run quarantine tally via a context-local counter tap:
            # the registry's ingest_quarantined is process-wide, and a
            # population interleaves P runs' increments — the tap sees
            # exactly the increments made by THIS run's task tree
            with trace.counter_tap() as tap:
                try:
                    for step_idx, step in enumerate(sched.steps):
                        result.steps_run = step_idx + 1
                        trace.add("sim_steps", 1)
                        with trace.span("sim.step", meta=step_idx):
                            violation = await self._exec(step, step_idx)
                        if violation is not None:
                            result.violation = violation
                            break
                    if result.violation is None:
                        try:
                            result.violation = await self._quiesce_and_check(
                                len(sched.steps)
                            )
                        except InvariantViolation:
                            raise
                        except Exception as e:
                            result.violation = Violation(
                                "check_error", repr(e), len(sched.steps)
                            )
                except InvariantViolation as iv:
                    result.violation = iv.violation
        for rep in self.replicas:
            result.fault_stats.update(rep.storage.stats)
        trace.add(
            "sim_faults_injected", sum(result.fault_stats.values())
        )
        if result.violation is not None:
            trace.add("sim_violations", 1)
        result.transient_missing_key = self.transient_missing_key
        result.strong_reads = self.strong_count
        result.strong_timeouts = self.strong_timeouts
        result.service_cycles = self.service_cycles
        result.daemon_cycles = self.daemon_cycles
        result.checks_run = self.checks_run
        result.quarantined = int(tap.get("ingest_quarantined", 0))
        result.fingerprint = self._fingerprint(result)
        return result

    def _fingerprint(self, result: SimResult) -> str:
        """Digest of everything a deterministic replay must reproduce:
        final states, cursors, and the injected-fault tallies."""
        from ..models import canonical_bytes

        h = hashlib.sha256()
        for rep in self.replicas:
            if rep.core is not None:
                h.update(rep.core.with_state(canonical_bytes))
                h.update(
                    json.dumps(
                        sorted(
                            (a.hex(), v)
                            for a, v in
                            rep.core.info().next_op_versions.counters.items()
                        )
                    ).encode()
                )
        h.update(json.dumps(sorted(result.fault_stats.items())).encode())
        return h.hexdigest()

    # -------------------------------------------------------------- steps
    async def _exec(self, step, step_idx: int) -> Violation | None:
        rep = self.replicas[step.replica] if step.replica < len(self.replicas) else None
        kind = step.kind
        if kind == "tick":
            for r in self.replicas:
                r.storage.tick()
            return None
        if kind == "quiesce":
            try:
                violation = await self._quiesce_and_check(step_idx)
            except InvariantViolation:
                raise
            except Exception as e:
                # a checker that cannot even run (open crashes on a
                # corrupt remote) is itself a finding — surface it as a
                # shrinkable violation, never a harness traceback
                violation = Violation("check_error", repr(e), step_idx)
            for r in self.replicas:
                r.storage.arm()
            return violation
        if kind == "dgc":
            # GC-mid-chain: collect the target sealer's whole delta log
            # out from under every consumer — they must fall back to
            # the snapshot path, never diverge or stall
            target = self.replicas[step.arg]
            if target.actor_id is not None:
                await self._clean_storage(
                    f"dgc{step_idx}"
                ).remove_deltas([(target.actor_id, 1 << 62)])
            return None
        if kind == "daemon":
            return await self._daemon_step(step_idx)
        if kind == "ddrain":
            return await self._daemon_drain(step_idx)
        if kind == "reopen":
            if rep.core is None:
                try:
                    await self._open(rep, create=False)
                except SimCrash:
                    pass  # crashed again mid-reopen; stays dead
                except MissingKeyError:
                    self.transient_missing_key += 1
            return None
        if rep is None or rep.core is None:
            return None  # steps on dead replicas are no-ops (shrink-safe)
        if kind == "crash":
            # the process dies mid-anything: memory state discarded,
            # storage keeps exactly what landed
            rep.core = None
            return None
        try:
            if kind == "add":
                m = self.members[step.arg % len(self.members)]
                core = rep.core
                await core.update(lambda s: s.add_ctx(core.actor_id, m))
            elif kind == "rm":
                m = self.members[step.arg % len(self.members)]
                await rep.core.update(
                    lambda s: s.rm_ctx(m) if s.contains(m) else None
                )
            elif kind in ("read", "dread"):
                await rep.core.read_remote()
            elif kind in ("compact", "dseal"):
                await rep.core.compact()
            elif kind == "rotate":
                await rep.core.rotate_key()
            elif kind == "compact2":
                return await self._compact2(rep, step.arg, step_idx)
            elif kind == "service":
                return await self._service(rep, step.arg, step_idx)
            elif kind == "read_strong":
                return await self._read_strong(rep, step_idx)
            elif kind == "await_stable":
                return await self._await_stable(rep, step_idx)
            else:
                raise ValueError(f"unknown step kind {kind!r}")
        except SimCrash:
            rep.core = None
        except (MissingKeyError, StaleWriterError, IngestDecryptError):
            # documented loud-but-transient states: key metadata / own
            # history not yet visible, or a whole batch of torn blobs
            # (the escalation rule fires loudly; the sim's tears ARE
            # transient, so the step is simply retried later)
            self.transient_missing_key += 1
        except Exception as e:
            logger.warning(
                "sim step %d (%s on r%d) failed", step_idx, kind, rep.idx,
                exc_info=True,
            )
            return Violation("step_error", f"{kind} on r{rep.idx}: {e!r}", step_idx)
        return None

    async def _compact2(self, rep, peer_idx: int, step_idx: int) -> Violation | None:
        """Two replicas compact the same remote CONCURRENTLY."""
        peer = self.replicas[peer_idx]
        targets = [rep] if peer.core is None or peer is rep else [rep, peer]
        outcomes = await asyncio.gather(
            *(r.core.compact() for r in targets), return_exceptions=True
        )
        for r, out in zip(targets, outcomes):
            if isinstance(out, SimCrash):
                r.core = None
            elif isinstance(out, (MissingKeyError, IngestDecryptError)):
                self.transient_missing_key += 1
            elif isinstance(out, BaseException):
                logger.warning(
                    "sim step %d concurrent compact on r%d failed: %r",
                    step_idx, r.idx, out,
                )
                return Violation(
                    "step_error",
                    f"concurrent compact on r{r.idx}: {out!r}",
                    step_idx,
                )
        return None

    async def _service(self, rep, peer_idx: int, step_idx: int) -> Violation | None:
        """A FoldService cycle compacts 1-2 replicas as tenants — the
        serving layer's sealing path in the same hostile history as the
        solo compactors."""
        from ..serve import FoldService, ServeConfig

        peer = self.replicas[peer_idx]
        tenants = [rep]
        if peer is not rep and peer.core is not None:
            tenants.append(peer)
        if self._service_pool is None:
            if self.substrate is not None:
                self._service_pool = self.substrate.service
            else:
                self._service_pool = FoldService(
                    [], ServeConfig(seal_empty=True), mesh=self.mesh
                )
        cores = [t.core for t in tenants]
        if self.substrate is not None:
            # shared-owner entry: overlapping lanes queue; each queued
            # cycle touches only this lane's tenants, so the lane's
            # cycle is byte-identical to the private-service cycle
            results = await self._service_pool.run_cycle_shared(cores)
        else:
            results = await self._service_pool.run_cycle(cores)
        self.service_cycles += 1
        for t, res in zip(tenants, results):
            if res.error is None:
                continue
            if "SimCrash" in res.error:
                t.core = None
            elif (
                "MissingKeyError" in res.error
                or "IngestDecryptError" in res.error
            ):
                self.transient_missing_key += 1
            else:
                return Violation(
                    "service_error",
                    f"tenant r{t.idx}: {res.error}",
                    step_idx,
                )
        if self.schedule.strong_reads:
            # served tenants get the same guarantee: a strong read
            # through the service's per-tenant endpoint, validated by
            # the same checker (refresh=False — the cycle just ingested)
            for t, res in zip(tenants, results):
                if res.error is None and t.core is not None:
                    v = await self._read_strong(
                        t, step_idx, service=True
                    )
                    if v is not None:
                        return v
        return None

    # ------------------------------------------------------ strong reads
    async def _read_strong(self, rep, step_idx: int, *,
                           service: bool = False) -> Violation | None:
        """One linearizable read + the full checker
        (sim/linearize.py): exactness against the oracle fold of its
        cut, durability, session monotonicity, and any pending
        read-your-writes obligation.  ``service=True`` routes through
        the FoldService per-tenant endpoint instead of the core —
        same guarantee, same checker."""
        from .linearize import check_strong_read

        if service:
            res = await self._service_pool.read_strong(
                rep.core, refresh=False
            )
        else:
            res = await rep.core.read(linearizable=True)
        self.strong_count += 1
        defect = check_strong_read(
            self._oplog, res, rep.last_strong, ryw_target=rep.awaited
        )
        rep.awaited = None  # the obligation is checked exactly once
        if defect is not None:
            return Violation(
                "linearizability", f"r{rep.idx}: {defect}", step_idx
            )
        rep.last_strong = res.cursor
        return None

    async def _await_stable(self, rep, step_idx: int) -> Violation | None:
        """The freshness-wait protocol on the replica's own last-write
        clock.  Determinism seams: polling advances every replica's
        sync ticks (delayed files move toward visibility) and the
        timeout counts polls, not wall time.  A timeout under faults is
        loud-but-transient (a silent or crashed peer legitimately holds
        the watermark); a SUCCESS creates the read-your-writes
        obligation the follow-up strong read is checked against."""
        from ..models.vclock import VClock
        from ..read.stable import StalenessError

        lm = rep.core._local_meta
        if lm is None or lm.last_op_version == 0:
            return None  # never wrote: nothing to await
        target = VClock({rep.core.actor_id: lm.last_op_version})

        async def on_poll():
            for r in self.replicas:
                r.storage.tick()

        polls = [0.0]

        def clock():
            polls[0] += 1.0
            return polls[0]

        try:
            await rep.core.await_stable(
                target, timeout_s=6.0, on_poll=on_poll, clock=clock
            )
        except StalenessError:
            self.strong_timeouts += 1
            return None
        rep.awaited = target
        return await self._read_strong(rep, step_idx)

    # ------------------------------------------------------------ daemon
    def _daemon_transient(self, err: str) -> bool:
        return any(
            t in err
            for t in ("MissingKeyError", "StaleWriterError",
                      "IngestDecryptError")
        )

    async def _daemon_step(self, step_idx: int) -> Violation | None:
        """One supervised FleetDaemon cycle over the alive fleet: the
        always-on control plane (serve/daemon.py) inside the hostile
        history.  The daemon instance persists across steps; its tenant
        set is synced to replica liveness before the cycle (crashed
        replicas are discarded, reopened ones re-admitted), and its
        per-tenant error reprs follow the same discipline as the
        ``service`` step: crash kills the replica, the documented
        transient classes are counted, anything else is a violation."""
        from ..serve import DaemonConfig, FleetDaemon, ServeConfig

        if self._daemon is None:
            self._daemon = FleetDaemon(
                config=DaemonConfig(
                    max_idle_cycles=1,
                    backoff_base=1.0, backoff_cap=4.0,
                    quarantine_after=3, quarantine_probe_every=2,
                    breaker_after=4, breaker_probe_every=2,
                    serve=ServeConfig(seal_empty=True),
                ),
                seed=self.schedule.seed,
                mesh=self.mesh,
                # the deterministic-clock seam: daemon wall-time reads
                # (uptime, SLO burn window) count cycles instead of
                # reading the host clock, so replays stay bit-for-bit
                clock=lambda: float(self.daemon_cycles),
            )
        daemon = self._daemon
        await self._daemon_sync(daemon)
        report = await daemon.run_cycle()
        self.daemon_cycles += 1
        for tid, res in report["results"].items():
            err = res.get("error")
            if not err:
                continue
            rep = self.replicas[int(tid[1:])]
            if "SimCrash" in err:
                rep.core = None
                await daemon.discard(tid)
            elif self._daemon_transient(err):
                self.transient_missing_key += 1
            else:
                return Violation(
                    "daemon_error", f"tenant {tid}: {err}", step_idx
                )
        return None

    async def _daemon_sync(self, daemon) -> None:
        """Sync the daemon's tenant set to replica liveness: crashed
        replicas are discarded (their core handles are dead
        incarnations the crash model says are gone), reopened ones
        re-admitted.  Runs before every cycle AND before a drain — a
        drain must never checkpoint a dead incarnation's handle."""
        for rep in self.replicas:
            tid = f"r{rep.idx}"
            entry = daemon.entry(tid)
            if rep.core is None:
                if entry is not None:
                    await daemon.discard(tid)
            elif entry is None:
                await daemon.admit(rep.core, tid=tid)
            elif entry.core is not rep.core:
                await daemon.discard(tid)
                await daemon.admit(rep.core, tid=tid)

    async def _daemon_drain(self, step_idx: int) -> Violation | None:
        """Graceful drain: checkpoint every tenant, stop the instance.
        The next ``daemon`` step starts fresh — reopening the fleet's
        control plane through the checkpoints just sealed."""
        if self._daemon is None:
            return None
        daemon, self._daemon = self._daemon, None
        await self._daemon_sync(daemon)
        errors = await daemon.drain()
        for tid, err in errors.items():
            if "SimCrash" in err:
                # the checkpoint write crashed the replica's process
                self.replicas[int(tid[1:])].core = None
            else:
                # a failed drain checkpoint is survivable by design —
                # the next open falls back cold — never a violation
                self.transient_missing_key += 1
        return None

    # -------------------------------------------------------- quiescence
    async def _quiesce_and_check(self, step_idx: int) -> Violation | None:
        """Heal, drain to a read fixed point, run every invariant."""
        from ..models import canonical_bytes

        with trace.span("sim.check", meta=step_idx):
            self.checks_run += 1
            for rep in self.replicas:
                rep.storage.heal()
            for rep in self.replicas:
                if rep.core is None:
                    try:
                        await self._open(rep, create=False)
                    except MissingKeyError:
                        return Violation(
                            "step_error",
                            f"r{rep.idx} missing key AFTER heal",
                            step_idx,
                        )
                    except Exception as e:
                        # e.g. DanglingLatestKey: corruption must become
                        # a shrinkable VIOLATION, never a harness crash
                        return Violation(
                            "step_error",
                            f"r{rep.idx} reopen after heal: {e!r}",
                            step_idx,
                        )
            prev = None
            for _ in range(QUIESCE_MAX_ROUNDS):
                # batched host-reference reads: the whole fleet's drain
                # round fans out in one gather instead of N serial
                # awaits (the sim fast path's second half) — reads are
                # idempotent merges over a healed, quiet remote, and
                # each replica's own call stream stays ordered, so the
                # fixed point and the fault-roll streams are unchanged
                await asyncio.gather(
                    *(rep.core.read_remote() for rep in self.replicas)
                )
                snap = [
                    (
                        rep.core.with_state(canonical_bytes),
                        tuple(
                            sorted(
                                rep.core.info().next_op_versions.counters.items()
                            )
                        ),
                    )
                    for rep in self.replicas
                ]
                if snap == prev and len({s[0] for s in snap}) == 1:
                    break
                prev = snap
            else:
                detail = divergence_detail(
                    [
                        (f"r{rep.idx}", rep.core.with_state(canonical_bytes))
                        for rep in self.replicas
                    ]
                )
                return Violation(
                    "no_quiescence",
                    detail or "reads never reached a fixed point",
                    step_idx,
                )
            blobs = [
                (f"r{rep.idx}", rep.core.with_state(canonical_bytes))
                for rep in self.replicas
            ]
            detail = divergence_detail(blobs)
            if detail is not None:
                return Violation("divergence", detail, step_idx)
            reference = blobs[0][1]

            v = await self._check_oracle(reference, step_idx)
            if v is None:
                v = await self._check_warm_cold(reference, step_idx)
            if v is None:
                v = await self._check_monotonicity(step_idx)
            if v is None:
                v = await self._check_fsck(step_idx)
            return v

    async def _check_oracle(self, reference: bytes, step_idx: int):
        from ..models import canonical_bytes

        rep0 = self.replicas[0]
        oracle = await Core.open(
            self._opts(
                rep0, create=True,
                storage=self._clean_storage(f"oracle{self.checks_run}"),
                checkpoint=False, host=True,
            )
        )
        await oracle.read_remote()
        if oracle.with_state(canonical_bytes) != reference:
            return Violation(
                "oracle",
                "fresh host refold of the remote diverges from the fleet",
                step_idx,
            )
        return None

    async def _check_warm_cold(self, reference: bytes, step_idx: int):
        """Warm-open vs cold-open byte identity for the sampled
        replicas.  The per-replica (warm → cold) pair fans out ACROSS
        replicas in one gather (the sim fast path's second slice —
        the same argument as the drain loop's: each replica's own
        storage-call stream keeps its order inside its coroutine, and
        the fault-roll RNG streams are per-storage, so cross-replica
        interleaving cannot move a single tally); the violation scan
        stays serial in replica order, so the FIRST violation reported
        is deterministic."""
        from ..models import canonical_bytes

        async def one(rep):
            warm = await Core.open(self._opts(rep, create=False))
            await warm.read_remote()
            cold = await Core.open(
                self._opts(rep, create=False, checkpoint=False)
            )
            await cold.read_remote()
            return (
                warm.with_state(canonical_bytes),
                cold.with_state(canonical_bytes),
                warm.checkpoint_fallback_reason,
            )

        sampled = self.replicas[:WARM_COLD_SAMPLES]
        results = await asyncio.gather(*(one(rep) for rep in sampled))
        for rep, (wb, cb, fallback) in zip(sampled, results):
            if wb != cb or wb != reference:
                return Violation(
                    "warm_cold",
                    f"r{rep.idx}: warm-open {'==' if wb == cb else '!='} "
                    f"cold-open, fleet match warm={wb == reference} "
                    f"cold={cb == reference} "
                    f"(fallback={fallback})",
                    step_idx,
                )
        return None

    async def _check_monotonicity(self, step_idx: int):
        """Replication-status sampling fans out across replicas in one
        gather (same per-replica stream argument as above); the
        regression comparison and the ``last_status`` update run
        serially in replica order afterwards, so both the violation
        choice and the stored baselines are deterministic."""
        statuses = await asyncio.gather(
            *(rep.core.replication_status() for rep in self.replicas)
        )
        for rep, status in zip(self.replicas, statuses):
            defect = replication_regression(rep.last_status, status)
            if defect is not None:
                return Violation(
                    "monotonicity", f"r{rep.idx}: {defect}", step_idx
                )
            if rep.last_status is not None and known_replica_set(
                status
            ) < known_replica_set(rep.last_status):
                return Violation(
                    "monotonicity",
                    f"r{rep.idx}: known replica set shrank",
                    step_idx,
                )
            rep.last_status = status
        return None

    async def _check_fsck(self, step_idx: int):
        from ..backends.plain_keys import PlainKeyCryptor
        from ..tools.fsck import fsck_remote

        report = await fsck_remote(
            self._clean_storage(f"fsck{self.checks_run}"),
            DeterministicCryptor("fsck"),
            PlainKeyCryptor(),
            deep=True,
        )
        if not report.ok:
            issues = "; ".join(
                str(i) for i in report.issues if i.severity == "error"
            )
            return Violation("fsck", issues[:500], step_idx)
        return None


def run_schedule(schedule: Schedule, *, tmpdir: str | None = None,
                 device=None) -> SimResult:
    """Convenience front door: one runner, one result."""
    return SimRunner(schedule, tmpdir=tmpdir, device=device).run()
