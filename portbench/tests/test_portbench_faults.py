"""The control and every fault a cell can have, planted under the timed
path of a whole run (past the look for a card): ``correct`` comes out
false, and the numbers that catch it are above their limits.  The
exchange between cards is not among them: every cell runs on one."""

import pytest

from harness import run_small
from portbench import faults

CELLS = ["orset3-merge8"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", faults.NAMES)
def test_the_fault_is_not_correct(monkeypatch, workload, fault):
    res = run_small(monkeypatch, workload, 17, "--fault", fault)
    assert not res["correct"]
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert "snap_cells_off" in over or "mem_cells_off" in over, over


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_reads_the_lost_file(monkeypatch, workload):
    res = run_small(monkeypatch, workload, 23, "--fault", "control")
    checks = res["checks"]
    assert checks["snap_cells_off"]["value"] > 0
    assert checks["snap_clock_off"]["value"] > 0
    assert checks["files_left"]["value"] > 0
