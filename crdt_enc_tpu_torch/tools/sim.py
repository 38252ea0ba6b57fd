"""Adversarial convergence simulator CLI: the port's copy of
``crdt_enc_tpu/tools/sim.py``.

    python -m crdt_enc_tpu_torch.tools.sim run --seed 42 --replicas 8 \\
        --steps 500 --faults all [--device cuda|cpu] [--backend memory|fs] \\
        [--deltas] [--daemon] [--strong-reads] [--shrink OUT.json]
    python -m crdt_enc_tpu_torch.tools.sim explore --seeds 0:20 \\
        --replicas 4 --steps 120 --faults all [--device cuda|cpu] \\
        [--population P] [--budget-s N] [--coverage-out f.json] \\
        [--shrink OUT.json]
    python -m crdt_enc_tpu_torch.tools.sim replay [--device cuda|cpu] \\
        tests/data/sim [FILE.json ...]

``run`` executes one seeded schedule and checks every quiescence
invariant; on failure, ``--shrink`` delta-debugs the schedule to a
minimal reproducer and writes a replayable fixture (the JAX package's
format: either package replays it).  ``explore`` sweeps a seed range —
``--population P`` runs P schedules concurrently through one shared
substrate (bit-identical results), ``--budget-s N`` keeps the population
full by refilling finished lanes with the next seed until the wall-clock
budget expires, and ``--coverage-out`` dumps the fault×vocabulary
co-fire matrix.  ``replay`` runs committed fixtures (directories expand
to their ``*.json``) and exits non-zero if any regresses; a non-fixture
file in a fixture directory is an error.

``--device`` is where the odd replicas, the service and the daemon fold:
``cuda`` (the default, the card) or ``cpu`` (the kernels' plain PyTorch
versions).  Without a card, ``--device cuda`` stops with
``DeviceUnavailableError`` (exit 1); the simulator never moves to the
CPU on its own.

Exit codes: 0 all invariants held, 1 violation (or fixture regression,
or no device), 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _build_faults(spec: str):
    from ..sim import FaultConfig

    if spec == "all":
        return FaultConfig.all_faults()
    if spec == "none":
        return FaultConfig.none()
    chosen = [c.strip() for c in spec.split(",") if c.strip()]
    full = FaultConfig.all_faults()
    cfg = FaultConfig.none()
    for c in chosen:
        if c not in FaultConfig.CLASSES:
            raise SystemExit(
                f"unknown fault class {c!r}; choose from "
                f"{', '.join(FaultConfig.CLASSES)}, or all/none"
            )
        setattr(cfg, c, getattr(full, c))
    cfg.delay_max_ticks = full.delay_max_ticks
    return cfg


def _executor(device):
    """One-schedule runs on ``device``; fs schedules get a fresh scratch
    dir (a reused dir would leak one run's remote into the next)."""
    from ..sim import run_schedule

    def execute(schedule):
        if schedule.backend == "fs":
            with tempfile.TemporaryDirectory(prefix="crdt-sim-") as td:
                return run_schedule(schedule, tmpdir=td, device=device)
        return run_schedule(schedule, device=device)

    return execute


def _report(tag: str, schedule, result) -> None:
    stats = ", ".join(
        f"{k}={v}" for k, v in sorted(result.fault_stats.items())
    ) or "none"
    print(
        f"{tag}: seed={schedule.seed} replicas={schedule.n_replicas} "
        f"steps={result.steps_run} checks={result.checks_run} "
        f"service_cycles={result.service_cycles} "
        f"daemon_cycles={result.daemon_cycles} "
        f"strong_reads={result.strong_reads} "
        f"strong_timeouts={result.strong_timeouts} "
        f"quarantined={result.quarantined} faults[{stats}]"
    )
    if result.violation is not None:
        v = result.violation
        print(f"  VIOLATION [{v.invariant}] at step {v.step}: {v.detail}")


def _cmd_run(args) -> int:
    from ..sim import generate, shrink, to_fixture

    _execute = _executor(args.device)
    faults = _build_faults(args.faults)
    schedule = generate(
        args.seed, args.replicas, args.steps, faults,
        members=args.members, backend=args.backend, deltas=args.deltas,
        daemon=args.daemon, strong_reads=args.strong_reads,
    )
    result = _execute(schedule)
    _report("run", schedule, result)
    if result.ok:
        return 0
    if args.shrink:
        small, violation = shrink(
            schedule, result.violation, _execute, max_runs=args.shrink_budget
        )
        fixture = to_fixture(small, violation)
        with open(args.shrink, "w") as f:
            json.dump(fixture, f, indent=1)
            f.write("\n")
        print(
            f"  shrunk to {len(small.steps)} steps / "
            f"{small.n_replicas} replicas / faults "
            f"{small.faults.enabled_classes()} -> {args.shrink}"
        )
    return 1


def _cmd_explore(args) -> int:
    from ..sim import generate

    _execute = _executor(args.device)
    try:
        lo, hi = (int(x) for x in args.seeds.split(":"))
    except ValueError:
        raise SystemExit(f"--seeds wants LO:HI, got {args.seeds!r}")
    faults = _build_faults(args.faults)
    if (args.population > 1 or args.budget_s) and args.backend != "memory":
        raise SystemExit(
            "--population/--budget-s need --backend memory: population "
            "runs are bound by the serial-equality contract, which the "
            "fs backend's thread-pool timing cannot honor"
        )

    def make_schedule(seed):
        return generate(
            seed, args.replicas, args.steps, faults,
            members=args.members, backend=args.backend, deltas=args.deltas,
            daemon=args.daemon, strong_reads=args.strong_reads,
        )

    pairs = []  # (schedule, result), seed order
    if args.budget_s:
        # wall-clock budget mode: keep the population full (a finished
        # lane refills with the next seed) until the budget expires —
        # seeds start at LO and the HI bound is ignored, the budget IS
        # the bound
        from ..sim import run_budget

        rep = run_budget(
            make_schedule, budget_s=args.budget_s,
            population=max(1, args.population), start_seed=lo,
            device=args.device,
        )
        pairs = list(zip(rep.schedules, rep.results))
        for schedule, result in pairs:
            _report(f"seed {schedule.seed}", schedule, result)
        print(
            f"explore: {len(pairs)} schedules in {rep.wall_s:.1f}s "
            f"(budget {args.budget_s:g}s, {rep.refills} refill(s)), "
            f"{sum(1 for _, r in pairs if not r.ok)} failure(s)"
        )
    elif args.population > 1:
        from ..sim import run_population

        rep = run_population(
            [make_schedule(s) for s in range(lo, hi)],
            population=args.population, device=args.device,
        )
        pairs = list(zip(rep.schedules, rep.results))
        for schedule, result in pairs:
            _report(f"seed {schedule.seed}", schedule, result)
        print(
            f"explore: {len(pairs)} schedules in {rep.wall_s:.1f}s "
            f"(population {args.population}), "
            f"{sum(1 for _, r in pairs if not r.ok)} failure(s)"
        )
    else:
        for seed in range(lo, hi):
            schedule = make_schedule(seed)
            result = _execute(schedule)
            _report(f"seed {seed}", schedule, result)
            pairs.append((schedule, result))
        print(
            f"explore: {len(pairs)} schedules, "
            f"{sum(1 for _, r in pairs if not r.ok)} failure(s)"
        )

    if args.coverage_out:
        from ..sim import CoFireMatrix

        matrix = CoFireMatrix()
        for schedule, result in pairs:
            matrix.record(schedule, result)
        matrix.dump(args.coverage_out)
        print(f"coverage matrix ({matrix.runs} runs) -> {args.coverage_out}")

    failing = [(s, r) for s, r in pairs if not r.ok]
    if failing and args.shrink:
        # same ddmin flow as `run --shrink`, applied to the FIRST
        # failure: the shrinker replays serially, so a violation found
        # inside a population shrinks to the same replayable fixture
        from ..sim import shrink, to_fixture

        schedule, result = failing[0]
        small, violation = shrink(
            schedule, result.violation, _execute, max_runs=args.shrink_budget
        )
        fixture = to_fixture(small, violation)
        with open(args.shrink, "w") as f:
            json.dump(fixture, f, indent=1)
            f.write("\n")
        print(
            f"  shrunk seed {schedule.seed} to {len(small.steps)} steps / "
            f"{small.n_replicas} replicas / faults "
            f"{small.faults.enabled_classes()} -> {args.shrink}"
        )
    return 1 if failing else 0


def _expand_fixtures(paths: list[str]) -> list[str]:
    out = []
    for p in paths:
        if os.path.isdir(p):
            entries = sorted(os.listdir(p))
            stray = [e for e in entries if not e.endswith(".json")]
            if stray:
                raise SystemExit(
                    f"non-fixture files in {p}: {stray} — every file in a "
                    "fixture dir must be a replayable .json schedule"
                )
            out.extend(os.path.join(p, e) for e in entries)
        else:
            out.append(p)
    return out


def _cmd_replay(args) -> int:
    from ..sim import Schedule

    _execute = _executor(args.device)
    files = _expand_fixtures(args.fixtures)
    if not files:
        print("replay: no fixtures found", file=sys.stderr)
        return 2
    regressions = 0
    for path in files:
        try:
            with open(path) as f:
                obj = json.load(f)
            schedule = Schedule.from_obj(obj)
        except (OSError, ValueError, KeyError) as e:
            print(f"{path}: unreadable fixture: {e!r}", file=sys.stderr)
            return 2
        result = _execute(schedule)
        was = obj.get("violation", {}).get("invariant", "?")
        if result.ok:
            print(f"{path}: PASS (was: {was})")
        else:
            regressions += 1
            v = result.violation
            print(
                f"{path}: REGRESSED [{v.invariant}] {v.detail}",
                file=sys.stderr,
            )
    print(f"replay: {len(files)} fixture(s), {regressions} regression(s)")
    return 1 if regressions else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m crdt_enc_tpu_torch.tools.sim", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument("--device", default="cuda",
                       help="device the odd replicas, the service and the "
                       "daemon fold on: cuda or cpu")

    def common(p):
        device(p)
        p.add_argument("--replicas", type=int, default=4)
        p.add_argument("--steps", type=int, default=120)
        p.add_argument("--members", type=int, default=12)
        p.add_argument("--faults", default="all",
                       help="all | none | comma-list of fault classes")
        p.add_argument("--backend", choices=("memory", "fs"),
                       default="memory")
        p.add_argument("--deltas", action="store_true",
                       help="enable delta-state replication on every "
                       "replica + the dseal/dread/dgc step vocabulary")
        p.add_argument("--daemon", action="store_true",
                       help="enable the daemon/ddrain step vocabulary: "
                       "a persistent FleetDaemon cycles inside the "
                       "schedule")
        p.add_argument("--strong-reads", action="store_true",
                       help="enable the read_strong/await_stable step "
                       "vocabulary + the linearizability checker")

    p_run = sub.add_parser("run", help="one seeded schedule + checks")
    p_run.add_argument("--seed", type=int, default=0)
    common(p_run)
    p_run.add_argument("--shrink", metavar="OUT.json",
                       help="on failure, ddmin to a minimal fixture")
    p_run.add_argument("--shrink-budget", type=int, default=200)
    p_run.set_defaults(fn=_cmd_run)

    p_exp = sub.add_parser("explore", help="sweep a seed range")
    p_exp.add_argument("--seeds", default="0:10", metavar="LO:HI")
    common(p_exp)
    p_exp.add_argument("--population", type=int, default=1, metavar="P",
                       help="run P schedules concurrently through one "
                       "shared substrate (sim/population.py); results "
                       "are bit-identical to serial runs")
    p_exp.add_argument("--budget-s", type=float, default=0.0, metavar="N",
                       help="wall-clock budget mode: keep the population "
                       "full, refilling finished lanes with the next "
                       "seed (starting at LO; HI is ignored) until N "
                       "seconds elapse — in-flight schedules finish")
    p_exp.add_argument("--coverage-out", metavar="F.json",
                       help="dump the fault-class × vocabulary co-fire "
                       "matrix")
    p_exp.add_argument("--shrink", metavar="OUT.json",
                       help="on failure, ddmin the first failing "
                       "schedule to a minimal fixture")
    p_exp.add_argument("--shrink-budget", type=int, default=200)
    p_exp.set_defaults(fn=_cmd_explore)

    p_rep = sub.add_parser("replay", help="replay committed fixtures")
    device(p_rep)
    p_rep.add_argument("fixtures", nargs="+",
                       help="fixture .json files and/or directories")
    p_rep.set_defaults(fn=_cmd_replay)

    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    from .daemon import device_or_exit

    args.device, rc = device_or_exit(args.device)
    if args.device is None:
        return rc
    try:
        return args.fn(args)
    except SystemExit as e:  # usage errors found past the parser
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 2
        return int(e.code or 0)


if __name__ == "__main__":
    sys.exit(main())
