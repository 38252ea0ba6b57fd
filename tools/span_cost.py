"""Nanoseconds per ``trace.span`` enter and exit, with the event log off
and on, on the host's CPU.

    python tools/span_cost.py [CHECKOUT ...]

Each checkout (default: this one) is measured in a process of its own,
the checkouts in turn, ``--rounds`` times; each figure is the median of
its rounds.  "on, nested" opens each span inside one outer span, as the
spans of a compaction sit under its root.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
from crdt_enc_tpu_torch.utils import trace

N = int(sys.argv[2])


def flat(on):
    trace.reset()
    trace.enable_events(on)
    trace.set_events_capacity(N + 1)
    t = time.perf_counter_ns()
    for _ in range(N):
        with trace.span("a"):
            pass
    return (time.perf_counter_ns() - t) / N


def nested():
    trace.reset()
    trace.enable_events(True)
    trace.set_events_capacity(N + 1)
    with trace.span("root"):
        t = time.perf_counter_ns()
        for _ in range(N):
            with trace.span("a"):
                pass
        dt = time.perf_counter_ns() - t
    return dt / N


flat(False)  # warm
print(json.dumps({"off": flat(False), "on": flat(True), "on, nested": nested()}))
"""


def measure(checkout: str, n: int) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD, checkout, str(n)],
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python tools/span_cost.py")
    p.add_argument("checkouts", nargs="*", default=[ROOT])
    p.add_argument("--rounds", type=int, default=7)
    p.add_argument("--spans", type=int, default=200_000)
    args = p.parse_args(argv)
    runs: dict = {c: [] for c in args.checkouts}
    for _ in range(args.rounds):
        for c in args.checkouts:
            runs[c].append(measure(c, args.spans))
    for c, rs in runs.items():
        med = {k: statistics.median(r[k] for r in rs) for k in rs[0]}
        print(c, "  ".join(f"{k} {v:.0f} ns" for k, v in med.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
