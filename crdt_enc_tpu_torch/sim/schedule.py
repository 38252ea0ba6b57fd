"""Seeded schedules: the explorable space of replica interleavings.

The port's copy of ``crdt_enc_tpu/sim/schedule.py``: the same step
kinds, the same fixture format and the same RNG stream, so one seed
names one schedule in both packages.

A :class:`Schedule` is a fully materialized, JSON-serializable program
for the simulator: N replicas, a step list, and a fault configuration.
:func:`generate` derives one deterministically from a seed — no wall
clock, no global RNG — so ``(seed, replicas, steps, faults)`` names one
exact history and a failure found at fleet scale replays bit-for-bit
from four numbers.  Shrunk failures serialize through
:meth:`Schedule.to_obj` into the committed fixtures under
``tests/data/sim/``.

Step kinds (``Step.kind``):

========== ==================================================================
``add``     replica adds member ``arg`` to the OR-Set
``rm``      replica removes member ``arg`` (no-op when absent)
``read``    replica ``read_remote()``
``compact`` replica ``compact()``
``compact2`` replicas ``replica`` and ``arg`` compact CONCURRENTLY
``service`` a :class:`~crdt_enc_tpu_torch.serve.FoldService` cycle compacts
            replica ``replica`` (and ``arg`` when different) as tenants
``rotate``  replica rotates the data key mid-sync
``crash``   replica crashes (Core discarded; storage keeps what landed)
``reopen``  replica reopens from its local dir (warm checkpoint in play)
``tick``    one sync tick on every replica's fault wrapper (delayed
            files move toward visibility)
``quiesce`` mid-run quiescence point: heal, drain, run the full
            invariant check, then re-arm the faults
``dseal``   seal-delta: replica compacts with delta-state replication
            in play (generated only for ``deltas`` schedules)
``dread``   read-delta-chain: replica ``read_remote()`` — with deltas
            on, the chain-first consumer path
``dgc``     GC-mid-chain: replica ``arg``'s whole delta log is removed
            out from under every consumer (the hostile move that
            forces the fallback-to-snapshot path)
``daemon``  one supervised :class:`~crdt_enc_tpu_torch.serve.FleetDaemon`
            cycle over a PERSISTENT daemon instance whose tenants are
            the currently-alive replicas (admitted/evicted to match
            liveness before the cycle runs) — staleness scheduling,
            backoff and quarantine all face the same hostile storage
``ddrain``  graceful daemon drain (checkpoints every tenant, stops the
            instance); the next ``daemon`` step starts a fresh daemon
            that reopens through the checkpoints
``read_strong`` replica serves a linearizable read from its stable
            prefix (``Core.read(linearizable=True)``); the result is
            validated on the spot by the linearizability checker
            (sim/linearize.py) — exactness against the oracle fold of
            its cut, session monotonicity, durability
``await_stable`` replica runs the freshness-wait protocol on its own
            last-write clock (read-your-writes made strong): a timeout
            under faults is loud-but-transient, a SUCCESS obligates the
            follow-up strong read to cover the awaited clock — checked
========== ==================================================================

``Schedule.deltas`` turns delta-state replication on for every
replica's ``OpenOptions``; it defaults OFF so pre-delta fixtures
replay bit-for-bit, and the generator only emits the ``d*`` step
kinds (and only perturbs its RNG stream) when it is on.
``Schedule.daemon`` does the same for the ``daemon``/``ddrain``
vocabulary: default OFF, so every pre-daemon fixture and
seed replays untouched.  ``Schedule.strong_reads`` gates the
``read_strong``/``await_stable`` vocabulary under the same
RNG-stream preservation rule.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from .faults import FaultConfig

SCHEDULE_VERSION = 1

STEP_KINDS = (
    "add",
    "rm",
    "read",
    "compact",
    "compact2",
    "service",
    "rotate",
    "crash",
    "reopen",
    "tick",
    "quiesce",
    "dseal",
    "dread",
    "dgc",
    "daemon",
    "ddrain",
    "read_strong",
    "await_stable",
)


@dataclass
class Step:
    kind: str
    replica: int = 0
    arg: int = 0

    def to_obj(self):
        return [self.kind, self.replica, self.arg]

    @classmethod
    def from_obj(cls, obj) -> "Step":
        kind, replica, arg = obj
        if kind not in STEP_KINDS:
            raise ValueError(f"unknown step kind {kind!r}")
        return cls(str(kind), int(replica), int(arg))


@dataclass
class Schedule:
    seed: int
    n_replicas: int
    steps: list = field(default_factory=list)
    faults: FaultConfig = field(default_factory=FaultConfig)
    members: int = 12
    backend: str = "memory"  # "memory" (deterministic) | "fs"
    deltas: bool = False  # delta-state replication on every replica
    daemon: bool = False  # daemon/ddrain vocabulary (FleetDaemon runs)
    strong_reads: bool = False  # read_strong/await_stable vocabulary
    note: str = ""

    def to_obj(self) -> dict:
        return {
            "v": SCHEDULE_VERSION,
            "seed": self.seed,
            "replicas": self.n_replicas,
            "members": self.members,
            "backend": self.backend,
            "deltas": self.deltas,
            "daemon": self.daemon,
            "strong": self.strong_reads,
            "faults": self.faults.to_obj(),
            "steps": [s.to_obj() for s in self.steps],
            "note": self.note,
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "Schedule":
        v = obj.get("v")
        if v != SCHEDULE_VERSION:
            raise ValueError(f"unsupported schedule version {v!r}")
        backend = obj.get("backend", "memory")
        if backend not in ("memory", "fs"):
            raise ValueError(f"unknown backend {backend!r}")
        sched = cls(
            seed=int(obj["seed"]),
            n_replicas=int(obj["replicas"]),
            steps=[Step.from_obj(s) for s in obj["steps"]],
            faults=FaultConfig.from_obj(obj.get("faults", {})),
            members=int(obj.get("members", 12)),
            backend=backend,
            deltas=bool(obj.get("deltas", False)),
            daemon=bool(obj.get("daemon", False)),
            strong_reads=bool(obj.get("strong", False)),
            note=str(obj.get("note", "")),
        )
        bad = [
            s for s in sched.steps
            if not (0 <= s.replica < sched.n_replicas)
            or (s.kind in ("compact2", "service", "dgc")
                and not (0 <= s.arg < sched.n_replicas))
        ]
        if bad:
            raise ValueError(f"steps reference replicas out of range: {bad[:3]}")
        return sched

    def with_steps(self, steps: list) -> "Schedule":
        return Schedule(
            seed=self.seed,
            n_replicas=self.n_replicas,
            steps=list(steps),
            faults=self.faults,
            members=self.members,
            backend=self.backend,
            deltas=self.deltas,
            daemon=self.daemon,
            strong_reads=self.strong_reads,
            note=self.note,
        )

    def with_faults(self, faults: FaultConfig) -> "Schedule":
        sched = self.with_steps(self.steps)
        sched.faults = faults
        return sched


# step-kind weights: mostly writes and syncs, a steady trickle of the
# hostile moves (concurrent compactors, service cycles, rotation,
# crashes).  ``reopen`` weight applies only while someone is dead —
# the generator tracks liveness so schedules stay well-formed.
_WEIGHTS = [
    ("add", 0.34),
    ("rm", 0.10),
    ("read", 0.16),
    ("compact", 0.09),
    ("compact2", 0.03),
    ("service", 0.04),
    ("rotate", 0.02),
    ("crash", 0.03),
    ("reopen", 0.05),
    ("tick", 0.12),
    ("quiesce", 0.02),
]

# extra vocabulary for delta-enabled schedules: explicit seal-delta / read-delta-chain traffic plus the
# GC-mid-chain hostile move.  Appended ONLY when deltas are on, so the
# RNG stream — and therefore every pre-delta seed — is untouched.
_DELTA_WEIGHTS = [
    ("dseal", 0.06),
    ("dread", 0.06),
    ("dgc", 0.02),
]

# daemon vocabulary: a steady trickle of supervised control-
# plane cycles plus the occasional graceful drain (the next daemon step
# restarts through checkpoints).  Appended only when the daemon flag is
# on — same RNG-stream preservation rule as the delta vocabulary.
_DAEMON_WEIGHTS = [
    ("daemon", 0.06),
    ("ddrain", 0.01),
]

# strong-read vocabulary: a steady stream of linearizable
# reads plus occasional freshness waits on the reader's own last write.
# Appended only when the strong_reads flag is on — same RNG-stream
# preservation rule, so every earlier fixture and seed replays
# untouched.
_STRONG_WEIGHTS = [
    ("read_strong", 0.08),
    ("await_stable", 0.03),
]


def generate(
    seed: int,
    n_replicas: int,
    n_steps: int,
    faults: FaultConfig,
    *,
    members: int = 12,
    backend: str = "memory",
    deltas: bool = False,
    daemon: bool = False,
    strong_reads: bool = False,
) -> Schedule:
    """One deterministic schedule from a seed.  Every replica both
    writes and syncs; dead replicas receive only ``reopen`` steps; the
    final step list always ends in enough reopens that the quiescence
    phase starts with a full fleet."""
    rng = random.Random(f"crdt-sim-{seed}")
    table = (
        _WEIGHTS
        + (_DELTA_WEIGHTS if deltas else [])
        + (_DAEMON_WEIGHTS if daemon else [])
        + (_STRONG_WEIGHTS if strong_reads else [])
    )
    kinds = [k for k, _ in table]
    weights = [w for _, w in table]
    dead: set[int] = set()
    steps: list[Step] = []
    for _ in range(n_steps):
        kind = rng.choices(kinds, weights)[0]
        if kind == "reopen":
            if not dead:
                kind = "read"
        elif kind == "crash" and len(dead) >= max(1, n_replicas // 2):
            kind = "tick"  # keep a quorum alive so histories stay dense
        if kind == "tick":
            steps.append(Step("tick"))
            continue
        if kind == "quiesce":
            steps.append(Step("quiesce"))
            dead.clear()  # quiescence reopens every dead replica
            continue
        if kind in ("daemon", "ddrain"):
            # global control-plane steps: the replica field is unused
            # (the daemon's tenants are whatever is alive at execution)
            steps.append(Step(kind))
            continue
        if kind == "reopen":
            r = rng.choice(sorted(dead))
            dead.discard(r)
            steps.append(Step("reopen", r))
            continue
        alive = [i for i in range(n_replicas) if i not in dead]
        if not alive:
            steps.append(Step("tick"))
            continue
        r = rng.choice(alive)
        if kind == "crash":
            dead.add(r)
            steps.append(Step("crash", r))
        elif kind in ("add", "rm"):
            steps.append(Step(kind, r, rng.randrange(members)))
        elif kind in ("compact2", "service"):
            peer = rng.choice(alive)
            steps.append(Step(kind, r, peer))
        elif kind == "dgc":
            # arg names the sealer whose delta log gets collected
            steps.append(Step(kind, r, rng.choice(alive)))
        else:
            steps.append(Step(kind, r))
    for r in sorted(dead):
        steps.append(Step("reopen", r))
    return Schedule(
        seed=seed,
        n_replicas=n_replicas,
        steps=steps,
        faults=faults,
        members=members,
        backend=backend,
        deltas=deltas,
        daemon=daemon,
        strong_reads=strong_reads,
    )
