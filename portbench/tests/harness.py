"""Shared by the benchmark's CPU tests: run a cell in process, shrunk to
a size a test can hold, through the plain PyTorch path."""

from __future__ import annotations

import copy
import json
import os

from portbench import gen, run

SMALL = {
    "orset-10kx1M": {"replicas": 64, "members": 32, "ops_per_actor": 20,
                     "rm_every": 10, "rm_back": 5, "ops_per_file": 8},
}


def small_cell(workload: str) -> dict:
    """The cell's files as the harness resolves them, with the
    configuration's scale cut and its stated counts worked out again."""
    cell = run.resolve(run.manifest(), workload)
    cell = copy.deepcopy(cell)
    conf = cell["config"]
    shape = dict(SMALL[conf["name"]])
    conf["shape"] = shape
    tr = cell["traffic"]
    snaps = tr.get("snapshots", 0)
    c = gen.counts(shape, snaps, tr.get("snapshot_stride", 16))
    conf["counts"] = {k: c[k] for k in conf["counts"]}
    tr["counts"] = {k: c[k] for k in tr["counts"]}
    return cell


def run_small(monkeypatch, workload: str, seed: int, *extra: str,
              seconds: float = 0.5, trace: int = 0) -> dict:
    cell = small_cell(workload)
    monkeypatch.setattr(run, "resolve", lambda bench, name: cell)
    result = run.run(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace),
                      "--device", "cpu", *extra])
    json.dumps(result)  # the line the harness prints
    return result


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
