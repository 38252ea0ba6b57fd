"""BENCHMARK.json keeps to the benchmark's contract, and every file the
harness finds by name is there."""

import json
import os
import re

import pytest

from harness import repo_root
from portbench import run

ROOT = repo_root()
BENCH = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) and not w.startswith("/") for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(BENCH["configs"]) <= 24
    assert 1 <= len(BENCH["end_to_end"]) <= 16
    assert 1 <= len(BENCH["per_layer"]) <= 128
    # a full check of 24 cells at this length fits its time
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90
            + 1200) <= 43200


def test_names_units_and_lines():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in BENCH[group]]
        assert len(ns) == len(set(ns))
        assert all(NAME.match(n) for n in ns)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    # every driver reports these two (portbench/run.py)
    for name in ("setup_s", "compact_rss_mb"):
        assert name in e2e and "workloads" not in e2e[name]
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        mine = run.metrics_for(BENCH, w["name"], False)
        assert len(mine) >= 2, w["name"]
        assert run.metrics_for(BENCH, w["name"], True), w["name"]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in BENCH["workloads"]}
            assert m["moves"] in {x["name"] for x in run.metrics_for(BENCH, w, False)}


def test_every_file_is_found_by_name():
    pkg = os.path.join(ROOT, "portbench")
    files = set()
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert os.path.exists(os.path.join(ROOT, conf["reference"]))
        assert set(conf["widths"]) >= {"stream_producers", "torch_threads"}
    assert len(files) == len(BENCH["configs"])
    for w in BENCH["workloads"]:
        cell = run.resolve(BENCH, w["name"])
        driver = cell["traffic"]["driver"]
        assert os.path.exists(os.path.join(pkg, "drivers", driver + ".py"))
        mod = run.driver(driver)
        assert all(callable(getattr(mod, f)) for f in ("run", "stated", "measured"))
        assert mod.CONTROL_CHECKS and mod.FAULT_CHECKS
    for m in BENCH["per_layer"]:
        path = os.path.join(pkg, "metrics", m["name"] + ".py")
        assert os.path.exists(path), path
        assert callable(run.load_file_module(path, "m_" + m["name"].replace(".", "_")).read)


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(ROOT, "portbench", "metrics"))))
def test_no_stray_reader(name):
    assert name[:-3] in {m["name"] for m in BENCH["per_layer"]} or name == "__pycache__"


def _named(kind: str) -> set:
    cells = [run.resolve(BENCH, w["name"]) for w in BENCH["workloads"]]
    return {"configs": {os.path.basename(c["file"]) for c in BENCH["configs"]},
            "traffic": {w["traffic"] + ".json" for w in BENCH["workloads"]},
            "drivers": {c["traffic"]["driver"] + ".py" for c in cells}
            | {"__init__.py"},
            "tests/small": {c["name"] + ".json" for c in BENCH["configs"]},
            }[kind]


@pytest.mark.parametrize("kind", ["configs", "traffic", "drivers",
                                  "tests/small"])
def test_no_stray_data_file_or_driver(kind):
    """Every configuration, traffic mix, driver and small shape on disk is
    one a cell names: nothing is kept that no cell measures.  A driver's
    helper modules live outside ``drivers/``, as ``gen.py`` and
    ``reference/`` do."""
    here = set(os.listdir(os.path.join(ROOT, "portbench", kind))) - {"__pycache__"}
    assert here == _named(kind)
