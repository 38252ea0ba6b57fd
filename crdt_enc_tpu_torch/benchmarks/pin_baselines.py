"""Measure and write the port's pinned host baselines.

The twin of the JAX package's ``benchmarks/pin_baselines.py``.  Same-run
host rates swing with the machine's load, so a published ratio may rest
on ONE committed measurement per config taken on a quiet machine.  This
tool runs ONLY the host loops of the five suite configs (the same
generators and subsamples: each ``bench_*``'s ``host_only`` mode) and
the daemon family's solo-compaction loop, each median-of-N, and writes
``pinned_baselines.json`` beside this module with the raw samples and
the machine they were taken on.  It never reads or writes the JAX
package's pin file.  ``crdt_enc_tpu_torch.bench`` and ``.benchmarks.suite``
take a pin only where its workload shape matches.

Run it on the machine whose numbers it pins, otherwise idle:

    python3 -m crdt_enc_tpu_torch.benchmarks.pin_baselines [--runs 5]
        [--config N] [--force] [--machine TEXT]

Spread gate: a config whose ``host_spread_pct`` exceeds
:data:`SPREAD_LIMIT_PCT` is refused (nothing written for it, exit 1);
``--force`` writes it anyway with a printed warning.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys

#: the largest host sample spread a committed pin may carry, in percent
SPREAD_LIMIT_PCT = 30.0


def spread_gate(config_name: str, rec: dict, force: bool = False) -> bool:
    """Whether ``rec`` may be written: refused, with the reason printed,
    when ``host_spread_pct`` exceeds :data:`SPREAD_LIMIT_PCT`; ``force``
    writes it with a printed warning instead."""
    spread = rec.get("host_spread_pct")
    if spread is None or float(spread) <= SPREAD_LIMIT_PCT:
        return True
    if force:
        print(f"WARNING: pinning {config_name} with host_spread_pct "
              f"{float(spread):.1f} > {SPREAD_LIMIT_PCT:.0f} (--force): "
              "this denominator carries the noise of a busy machine",
              file=sys.stderr)
        return True
    print(f"REFUSING to pin {config_name}: host_spread_pct "
          f"{float(spread):.1f} > {SPREAD_LIMIT_PCT:.0f} — rerun on an idle "
          "machine, or pass --force to accept the noisy denominator",
          file=sys.stderr)
    return False


def runners() -> dict:
    from ..bench import e2e_daemon_host
    from .suite import (
        bench_gcounter,
        bench_lwwmap,
        bench_orset,
        bench_pncounter,
        bench_streaming,
    )

    return {
        1: lambda: bench_gcounter(1_000, 4, 0, host_only=True),
        2: lambda: bench_pncounter(100_000, 1_000, 0, host_only=True),
        3: lambda: bench_orset(1_000_000, 10_000, 4096, n_host=100_000,
                               iters=0, host_only=True),
        4: lambda: bench_lwwmap(1_000_000, 1_000_000, 10_000, n_host=50_000,
                                iters=0, host_only=True),
        5: lambda: bench_streaming(200_000, 100_000, 1024, ops_per_file=48,
                                   n_host_files=300, iters=0,
                                   host_only=True),
        6: lambda: e2e_daemon_host(),
    }


def main(argv: list | None = None) -> int:
    from .. import bench

    ap = argparse.ArgumentParser(
        prog="python3 -m crdt_enc_tpu_torch.benchmarks.pin_baselines")
    ap.add_argument("--runs", type=int, default=0,
                    help="host runs per config (default BENCH_HOST_RUNS)")
    ap.add_argument("--config", type=int, default=0,
                    help="re-pin one config (1-6) only")
    ap.add_argument("--force", action="store_true",
                    help="write pins past the spread gate (warns)")
    ap.add_argument("--machine", default=None,
                    help="the machine the pins describe (default: the "
                    "platform's processor, node name and CPU count)")
    ap.add_argument("--out", default=bench.PINNED_PATH,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    host_runs = bench.HOST_RUNS
    if args.runs:
        bench.HOST_RUNS = args.runs
    try:
        return pin(args)
    finally:
        bench.HOST_RUNS = host_runs


def pin(args) -> int:
    from .. import bench

    machine = args.machine or (
        f"{platform.node()}, {platform.processor() or platform.machine()}, "
        f"{os.cpu_count()} CPUs")
    try:
        with open(args.out) as f:
            pins = json.load(f)
    except (OSError, ValueError):
        pins = {}
    run = runners()
    wanted = [args.config] if args.config else sorted(run)
    ts = bench.now_iso()
    refused = []
    for c in wanted:
        print(f"pinning config {c}…", file=sys.stderr, flush=True)
        r = run[c]()
        rec = {
            "host_rate": round(r["host_rate"], 1), "n_ops": r["n_ops"],
            "shape": r["shape"], "median_s": round(r["median_s"], 4),
            "host_samples_s": r["host_samples_s"],
            "host_spread_pct": r["host_spread_pct"],
            "machine": machine, "ts": ts,
        }
        if not spread_gate(r["config"], rec, force=args.force):
            refused.append(r["config"])
            continue
        pins[r["config"]] = rec
        print(json.dumps({r["config"]: rec}), flush=True)
    with open(args.out, "w") as f:
        json.dump(pins, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 1 if refused else 0


if __name__ == "__main__":
    raise SystemExit(main())
