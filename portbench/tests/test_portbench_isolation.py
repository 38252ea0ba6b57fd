"""No run loads JAX, jaxlib, flax or the JAX package (top-level names
compared whole: ``crdt_enc_tpu_torch`` is the port), nor the port's own
bench modules; the reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from harness import repo_root

ROOT = repo_root()
PKG = os.path.join(ROOT, "portbench")
SOURCES = sorted(os.path.join(d, n) for d, _, ns in os.walk(PKG)
                 for n in ns if n.endswith(".py") and "tests" not in d)


def _imports(path: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, PKG))
def test_sources_import_no_jax_and_no_port_bench(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "flax", "crdt_enc_tpu", "bench",
                           "benchmarks"), (path, name)
        assert not name.startswith(("crdt_enc_tpu_torch.bench",
                                    "crdt_enc_tpu_torch.benchmarks")), (path, name)


@pytest.mark.parametrize("path", [p for p in SOURCES if "reference" in p],
                         ids=os.path.basename)
def test_reference_is_numpy_and_the_standard_library(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top == "numpy" or top in sys.stdlib_module_names, (path, name)


def test_a_run_loads_no_forbidden_module():
    code = (
        "import sys, json\n"
        "sys.path.insert(0, 'portbench/tests')\n"
        "import harness\n"
        "from portbench import run\n"
        "cell = harness.small_cell('orset3-merge8')\n"
        "run.resolve = lambda b, n: cell\n"
        "res = run.run(['--workload', 'orset3-merge8', '--seed', '1',"
        " '--seconds', '0.2', '--device', 'cpu'])\n"
        "print(json.dumps([0, res['correct'], run.forbidden_loaded(),"
        " sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'crdt_enc_tpu'))]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[0, true, [], []]"


def test_the_check_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "crdt_enc_tpu_torch_probe", sys)
    assert "crdt_enc_tpu_torch_probe" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert "jaxlib.probe" in run.forbidden_loaded()


def test_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails before any result: the program is not there."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "orset3-merge8",
         "--seed", "1", "--seconds", "1", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "crdt_enc_tpu_torch" in out.stderr
