"""Population runner: P independent schedules through ONE shared substrate.

The port's copy of ``crdt_enc_tpu/sim/population.py``.  Schedules never
interact, so they batch the way tenants batch: P
:class:`~crdt_enc_tpu_torch.sim.runner.SimRunner` lanes run concurrently
in one event loop, all folding through a single process-wide
:class:`PopulationSubstrate` — one ``TorchAccelerator`` on one device
(its plane cache keyed by state identity, so lanes never alias) and one
:class:`~crdt_enc_tpu_torch.serve.FoldService` whose
``run_cycle_shared`` queues overlapping lane cycles.

**The determinism law**: every RNG stream stays strictly per-(schedule,
replica, family, counter) — fault rolls are pure functions of those
four, the uuid stream is context-local to the lane's task tree,
cryptors are seeded per (schedule, replica), storage is a per-lane
``MemoryRemote``, and the daemon clock counts lane-local cycles.
Cooperative scheduling preserves each lane's own call order, so
cross-lane interleaving cannot move a single draw: **each schedule's
fingerprint is bit-identical to its serial run**.
:func:`verify_serial_equality` checks it.

The fs backend keeps thread-pool timing and cannot honor the contract,
so population runs are memory-backend only.

Front doors: :func:`run_population` (a fixed schedule list),
:func:`run_budget` (wall-clock budgeted, lanes refilled with the next
seed — ``tools.sim explore --budget-s``), :func:`verify_serial_equality`
(the contract checker).
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field

from ..utils import trace
from .runner import SimResult, SimRunner
from .schedule import Schedule


class PopulationSubstrate:
    """The shared serving substrate every lane folds through.

    One accelerator, ``TorchAccelerator(device, min_device_batch=1)``
    (``device=None`` means ``"cuda"``): its plane cache is keyed by
    state identity (weakref validated), so lanes never alias.  One
    FoldService, on ``mesh`` when one is given (``parallel.mesh.
    mesh_for_population``; the runners' service and daemon steps then
    fold on it): ``run_cycle_shared`` serializes overlapping owners, and
    the identity-keyed warm tier gives each lane the same byte-exact
    reuse a private service would.  Nothing in here is schedule-keyed:
    RNG streams, storage, fault counters, and cryptors all stay in the
    lanes (module docs: the determinism law)."""

    def __init__(self, device=None, *, mesh=None):
        from ..parallel.accel import TorchAccelerator
        from ..serve import FoldService, ServeConfig

        self.mesh = mesh
        self.accel = TorchAccelerator(device, min_device_batch=1)
        self.service = FoldService([], ServeConfig(seal_empty=True),
                                   mesh=mesh)

    def close(self) -> None:
        self.service.close()


@dataclass
class PopulationReport:
    """One population run's outcome: ``schedules[i]`` produced
    ``results[i]`` (index-aligned; a budget run orders by seed)."""

    schedules: list[Schedule] = field(default_factory=list)
    results: list[SimResult] = field(default_factory=list)
    wall_s: float = 0.0
    refills: int = 0

    @property
    def violations(self) -> list[tuple[Schedule, SimResult]]:
        return [
            (s, r)
            for s, r in zip(self.schedules, self.results)
            if not r.ok
        ]

    @property
    def steps_run(self) -> int:
        return sum(r.steps_run for r in self.results)


def _require_memory(schedule: Schedule) -> None:
    if schedule.backend != "memory":
        raise ValueError(
            "population runs are memory-backend only: the fs backend "
            "keeps thread-pool timing and cannot honor the serial-"
            "equality contract (sim/population.py module docs)"
        )


async def run_population_async(
    schedules, *, population: int | None = None, substrate=None,
    device=None,
) -> PopulationReport:
    """Run every schedule, at most ``population`` lanes concurrently
    (default: all).  A lane that finishes pulls the next schedule —
    ``sim_lane_refills`` counts those pulls — so the population stays
    full until the work list drains.  Violations land on the results,
    never raise (the CLI/shrink calling convention, unchanged)."""
    schedules = list(schedules)
    for s in schedules:
        _require_memory(s)
    n = len(schedules)
    lanes = max(1, min(population or n, n)) if n else 0
    own = substrate is None
    if own:
        substrate = PopulationSubstrate(device)
    results: list[SimResult | None] = [None] * n
    t0 = time.perf_counter()
    try:
        with trace.span("sim.population", meta=n):
            trace.gauge("sim_population", lanes)
            # a plain iterator is a safe work queue here: the loop is
            # single-threaded and next() runs between awaits, atomically
            work = iter(range(n))

            async def lane():
                first = True
                for i in work:
                    if not first:
                        trace.add("sim_lane_refills", 1)
                    first = False
                    runner = SimRunner(schedules[i], substrate=substrate)
                    results[i] = await runner.run_async()

            await asyncio.gather(*(lane() for _ in range(lanes)))
    finally:
        if own:
            substrate.close()
    return PopulationReport(
        schedules=schedules,
        results=results,
        wall_s=time.perf_counter() - t0,
        refills=max(0, n - lanes),
    )


def run_population(
    schedules, *, population: int | None = None, substrate=None,
    device=None,
) -> PopulationReport:
    """Sync front door over :func:`run_population_async`."""
    return asyncio.run(
        run_population_async(
            schedules, population=population, substrate=substrate,
            device=device,
        )
    )


async def run_budget_async(
    make_schedule,
    *,
    budget_s: float,
    population: int,
    start_seed: int = 0,
    substrate=None,
    device=None,
) -> PopulationReport:
    """Wall-clock budgeted exploration: keep ``population`` lanes full —
    a finished lane immediately refills with ``make_schedule(next
    seed)`` — until the budget expires.  The budget gates STARTS, never
    kills a lane mid-run, so the overshoot is bounded by one schedule's
    duration per lane (the ±1-cycle contract the CLI test pins).  The
    wall clock is harness control flow only; nothing inside a lane ever
    reads it, so every schedule that runs is still a pure function of
    its seed."""
    t0 = time.perf_counter()
    own = substrate is None
    if own:
        substrate = PopulationSubstrate(device)
    lanes = max(1, int(population))
    seeds = itertools.count(start_seed)
    done: list[tuple[Schedule, SimResult]] = []
    refills = 0
    try:
        with trace.span("sim.population", meta=lanes):
            trace.gauge("sim_population", lanes)

            async def lane():
                nonlocal refills
                first = True
                while time.perf_counter() - t0 < budget_s:
                    if not first:
                        trace.add("sim_lane_refills", 1)
                        refills += 1
                    first = False
                    sched = make_schedule(next(seeds))
                    _require_memory(sched)
                    runner = SimRunner(sched, substrate=substrate)
                    done.append((sched, await runner.run_async()))

            await asyncio.gather(*(lane() for _ in range(lanes)))
    finally:
        if own:
            substrate.close()
    done.sort(key=lambda sr: sr[0].seed)
    return PopulationReport(
        schedules=[s for s, _ in done],
        results=[r for _, r in done],
        wall_s=time.perf_counter() - t0,
        refills=refills,
    )


def run_budget(
    make_schedule, *, budget_s: float, population: int,
    start_seed: int = 0, substrate=None, device=None,
) -> PopulationReport:
    """Sync front door over :func:`run_budget_async`."""
    return asyncio.run(
        run_budget_async(
            make_schedule, budget_s=budget_s, population=population,
            start_seed=start_seed, substrate=substrate, device=device,
        )
    )


def verify_serial_equality(report: PopulationReport,
                           device=None) -> list[str]:
    """THE contract check: re-run each schedule serially — private
    accelerator on ``device`` (``None`` means ``"cuda"``), the
    single-lane path — and compare fingerprints and fault tallies.
    Returns human-readable mismatch lines (empty = the law held).
    Deliberately the dumbest possible implementation: any cleverness
    shared with the population path could hide the very divergence it
    must catch."""
    problems = []
    for sched, res in zip(report.schedules, report.results):
        serial = SimRunner(sched, device=device).run()
        if serial.fingerprint != res.fingerprint:
            problems.append(
                f"seed {sched.seed}: population fingerprint "
                f"{res.fingerprint[:16]} != serial {serial.fingerprint[:16]}"
            )
        elif serial.fault_stats != res.fault_stats:
            problems.append(
                f"seed {sched.seed}: fault tallies diverge: "
                f"population {sorted(res.fault_stats.items())} != "
                f"serial {sorted(serial.fault_stats.items())}"
            )
    return problems
