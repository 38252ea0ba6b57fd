"""On the card, at each cell's own size: a short run is correct, and the
control (one stored op file not folded) is not, every check its driver
names for the control above its limit.  Run on the card's machine with
``python3 -m pytest portbench/tests -m cuda``; skips here."""

import json
import os
import subprocess
import sys

import pytest

from harness import cells, driver, over, repo_root


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(workload: str, seed: int, *extra: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", "5", "--trace", "0", *extra],
        cwd=repo_root(), capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("workload", cells())
def test_a_short_run_is_correct_and_the_control_is_not(card, workload):
    sound = _run(workload, 2**31 + 101)
    assert sound["correct"], sound["checks"]
    assert sound["device"]["platform"] == "gpu"
    control = _run(workload, 2**31 + 101, "--fault", "control")
    assert not control["correct"]
    assert set(driver(workload).CONTROL_CHECKS) <= over(control), (
        control["checks"])
