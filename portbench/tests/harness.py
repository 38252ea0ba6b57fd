"""Shared by the benchmark's CPU tests: run a cell in process, shrunk to
a size a test can hold, through the plain PyTorch path.

What a test needs of a cell is found by name, as the runner finds its
files: the small shape in ``portbench/tests/small/<config>.json`` (keys
that replace the configuration's and the traffic's own), and the stated
and measured work and the checks that catch a fault in the module of the
driver its traffic names (``run.driver``)."""

from __future__ import annotations

import copy
import json
import os

from portbench import run


def cells() -> list:
    """The names of the manifest's cells."""
    return [w["name"] for w in run.manifest()["workloads"]]


def driver(workload: str):
    """The module of the driver the cell's traffic names."""
    return run.driver(run.resolve(run.manifest(), workload)["traffic"]["driver"])


def small_cell(workload: str) -> dict:
    """The cell's files as the harness resolves them, with the small
    shape's keys in place and the stated counts worked out again by the
    cell's driver."""
    cell = copy.deepcopy(run.resolve(run.manifest(), workload))
    conf, tr = cell["config"], cell["traffic"]
    with open(os.path.join(run.PKG, "tests", "small",
                           cell["cell"]["config"] + ".json")) as f:
        small = json.load(f)
    conf.update(small.get("config", {}))
    tr.update(small.get("traffic", {}))
    c = driver(workload).stated(conf, tr)
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


def over(result: dict) -> set:
    """The checks of a run that read above their limits."""
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
