"""The control and every fault a cell can have, planted under the timed
path of a whole run (past the look for a card): ``correct`` comes out
false, and the numbers that catch it, as the cell's driver names them,
are above their limits.  The exchange between cards is not among them:
every cell runs on one."""

import pytest

from harness import cells, driver, over, run_small
from portbench import faults


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("fault", faults.NAMES)
def test_the_fault_is_not_correct(monkeypatch, workload, fault):
    res = run_small(monkeypatch, workload, 17, "--fault", fault)
    assert not res["correct"]
    # caught by the checks, not by a compaction that crashed
    assert res["failed"] == 0
    caught = over(res) & set(driver(workload).FAULT_CHECKS)
    assert caught, res["checks"]


@pytest.mark.parametrize("workload", cells())
def test_the_control_reads_the_lost_file(monkeypatch, workload):
    res = run_small(monkeypatch, workload, 23, "--fault", "control")
    assert res["failed"] == 0
    assert set(driver(workload).CONTROL_CHECKS) <= over(res), (
        res["checks"])
