"""Delta-debugging shrink: a fleet-scale failure → a minimal fixture.

The port's copy of ``crdt_enc_tpu/sim/shrink.py``.

A violation found in a 500-step, 8-replica schedule is unreadable as a
bug report.  :func:`shrink` reduces it to (nearly) the smallest
schedule that still reproduces the SAME invariant violation:

1. **steps** — classic ddmin over the step list (remove chunks at
   halving granularity; keep any removal that still reproduces);
2. **faults** — try disabling each fault class entirely; keep it off
   when the failure survives (the surviving classes name the trigger);
3. **replicas** — try dropping the highest-indexed replicas whose steps
   all vanished during ddmin (renumbering is not attempted — a gap-free
   fleet keeps fixtures readable).

Reproduction compares ``Violation.invariant`` — a shrunk schedule that
fails a *different* invariant is a different bug and is not accepted as
a reduction (it would silently swap the regression being pinned).

Every candidate run is a full deterministic simulation, so the budget
matters: ``max_runs`` bounds the search and the best-so-far schedule is
returned when it runs out.  Shrunk schedules serialize into replayable
JSON fixtures (``tests/data/sim/``) via :func:`to_fixture`.
"""

from __future__ import annotations

from .check import Violation
from .schedule import Schedule, Step
from ..utils import trace


def _reproduces(
    candidate: Schedule, want: str, run_fn, budget: list
) -> Violation | None:
    """Run one candidate (respecting the run budget); returns its
    violation when it reproduces the wanted invariant."""
    if budget[0] <= 0:
        return None
    budget[0] -= 1
    result = run_fn(candidate)
    v = result.violation
    if v is not None and v.invariant == want:
        return v
    return None


def _ddmin_steps(
    schedule: Schedule, want: str, run_fn, budget: list
) -> Schedule:
    steps = list(schedule.steps)
    n = 2
    while len(steps) >= 2:
        chunk = max(1, len(steps) // n)
        reduced = False
        start = 0
        while start < len(steps):
            candidate_steps = steps[:start] + steps[start + chunk:]
            if not candidate_steps:
                start += chunk
                continue
            cand = schedule.with_steps(candidate_steps)
            if _reproduces(cand, want, run_fn, budget) is not None:
                steps = candidate_steps
                n = max(n - 1, 2)
                reduced = True
                # restart the scan: earlier chunks may now be removable
                start = 0
            else:
                start += chunk
            if budget[0] <= 0:
                return schedule.with_steps(steps)
        if not reduced:
            if chunk <= 1:
                break
            n = min(n * 2, len(steps))
    return schedule.with_steps(steps)


def _shrink_faults(
    schedule: Schedule, want: str, run_fn, budget: list
) -> Schedule:
    best = schedule
    for name in schedule.faults.CLASSES:
        if not getattr(best.faults, name):
            continue
        cand = best.with_faults(best.faults.without(name))
        if _reproduces(cand, want, run_fn, budget) is not None:
            best = cand
        if budget[0] <= 0:
            break
    return best


def _shrink_replicas(
    schedule: Schedule, want: str, run_fn, budget: list
) -> Schedule:
    best = schedule
    while best.n_replicas > 2:
        hi = best.n_replicas - 1
        if any(
            s.replica == hi or (s.kind in ("compact2", "service") and s.arg == hi)
            for s in best.steps
        ):
            break
        cand = Schedule(
            seed=best.seed,
            n_replicas=hi,
            steps=list(best.steps),
            faults=best.faults,
            members=best.members,
            backend=best.backend,
            note=best.note,
        )
        if _reproduces(cand, want, run_fn, budget) is None:
            break
        best = cand
        if budget[0] <= 0:
            break
    return best


def shrink(
    schedule: Schedule,
    violation: Violation,
    run_fn,
    *,
    max_runs: int = 200,
) -> tuple[Schedule, Violation]:
    """Reduce ``schedule`` (which produced ``violation``) to a minimal
    reproducer of the same invariant.  ``run_fn(schedule) -> SimResult``
    executes candidates (the caller chooses tmpdirs etc.).  Returns the
    shrunk schedule and the violation it produces."""
    want = violation.invariant
    budget = [max_runs]
    with trace.span("sim.shrink"):
        best = _ddmin_steps(schedule, want, run_fn, budget)
        best = _shrink_faults(best, want, run_fn, budget)
        best = _ddmin_steps(best, want, run_fn, budget)
        best = _shrink_replicas(best, want, run_fn, budget)
        final = _reproduces(best, want, run_fn, [1])
    if final is None:
        # the budget ran dry mid-move; fall back to the original, which
        # is known-good as a reproducer
        return schedule, violation
    return best, final


def to_fixture(schedule: Schedule, violation: Violation, note: str = "") -> dict:
    """The committed-fixture JSON shape: the shrunk schedule plus what
    it USED to violate.  Replay asserts the schedule now passes — every
    fixture is a fixed bug's permanent regression test."""
    obj = schedule.to_obj()
    obj["violation"] = violation.to_obj()
    if note:
        obj["note"] = note
    return obj
