"""The port's population runner (crdt_enc_tpu_torch.sim.population)
against the JAX package's, on the CPU.

P schedules run concurrently through ONE shared
``PopulationSubstrate(device="cpu")`` — one ``TorchAccelerator`` and one
``FoldService`` — and each schedule's fingerprint and fault tallies must
equal its serial run (the determinism law) AND the JAX package's
population run of the same schedule.  Around it: the budget mode, the
explore CLI's population, coverage and shrink flows, the co-fire matrix,
the counter tap the per-lane quarantine tally rides, and no build after
warm-up as P grows (the port compiles nothing per shape; its only
builds are the native and CUDA libraries, counted by
``obs.runtime.build_count``).  The 32-schedule acceptance run is
``slow`` like its JAX twin.
"""

from __future__ import annotations

import asyncio
import json
import threading

import pytest

import crdt_enc_tpu.sim as jsim
import crdt_enc_tpu_torch.sim as psim
from crdt_enc_tpu_torch.obs import runtime as obs_runtime
from crdt_enc_tpu_torch.sim import (
    CoFireMatrix,
    FaultConfig,
    PopulationReport,
    Schedule,
    Step,
    Violation,
    generate,
    run_budget,
    run_population,
    run_schedule,
    verify_serial_equality,
)
from crdt_enc_tpu_torch.sim.coverage import VOCABULARIES
from crdt_enc_tpu_torch.sim.population import PopulationSubstrate
from crdt_enc_tpu_torch.sim.runner import SimResult
from crdt_enc_tpu_torch.tools import sim as sim_cli
from crdt_enc_tpu_torch.utils import trace


def mixed(pkg):
    F = pkg.FaultConfig.all_faults
    return [
        pkg.generate(0, 3, 40, F(), members=6),
        pkg.generate(1, 3, 40, F(), members=6, deltas=True),
        pkg.generate(2, 3, 40, F(), members=6, daemon=True,
                     strong_reads=True),
    ]


def tallies(report) -> list:
    return [(r.ok, r.fingerprint, dict(r.fault_stats), r.checks_run,
             r.service_cycles, r.daemon_cycles, r.strong_reads)
            for r in report.results]


# -------------------------------------------------- the determinism law
def test_population_bit_identical_to_serial_mixed_vocabs():
    report = run_population(mixed(psim), population=2, device="cpu")
    assert [r.ok for r in report.results] == [True] * 3, report.violations
    assert report.refills == 1
    assert verify_serial_equality(report, device="cpu") == []
    again = run_population(mixed(psim), population=3, device="cpu")
    assert [r.fingerprint for r in again.results] == [
        r.fingerprint for r in report.results]
    # the JAX package's population of the same schedules
    jreport = jsim.run_population(mixed(jsim), population=2)
    assert tallies(report) == tallies(jreport)


def test_population_rejects_fs_backend():
    sched = generate(0, 3, 10, FaultConfig.none(), backend="fs")
    with pytest.raises(ValueError, match="memory-backend only"):
        run_population([sched], device="cpu")


def test_verify_serial_equality_catches_divergence():
    sched = generate(3, 3, 20, FaultConfig.all_faults(), members=6)
    report = run_population([sched], device="cpu")
    assert verify_serial_equality(report, device="cpu") == []
    forged = PopulationReport(
        schedules=list(report.schedules),
        results=[SimResult(None, fingerprint="f" * 64,
                           fault_stats=report.results[0].fault_stats)],
    )
    problems = verify_serial_equality(forged, device="cpu")
    assert len(problems) == 1 and "seed 3" in problems[0]
    forged2 = PopulationReport(
        schedules=list(report.schedules),
        results=[SimResult(None,
                           fingerprint=report.results[0].fingerprint)],
    )
    assert any("fault tallies" in p
               for p in verify_serial_equality(forged2, device="cpu"))


def test_substrate_defaults_to_cuda():
    """``PopulationSubstrate()`` folds on the card; without one it
    raises instead of moving to the CPU."""
    import torch

    if torch.cuda.is_available():
        sub = PopulationSubstrate()
        assert sub.accel.device.type == "cuda"
        sub.close()
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PopulationSubstrate()


# ------------------------------------------------------- budget mode
def test_budget_gates_starts_and_refills_lanes(monkeypatch):
    from crdt_enc_tpu_torch.sim import population as pop_mod

    class FakeTime:
        def __init__(self, step):
            self.now, self.step = 0.0, step

        def perf_counter(self):
            self.now += self.step
            return self.now

    monkeypatch.setattr(pop_mod, "time", FakeTime(0.25))
    substrate = PopulationSubstrate("cpu")
    try:
        report = run_budget(
            lambda seed: generate(seed, 2, 5, FaultConfig.none(), members=4),
            budget_s=1.0, population=2, start_seed=10, substrate=substrate,
        )
    finally:
        substrate.close()
    assert [s.seed for s in report.schedules] == [10, 11, 12]
    assert report.refills == 1
    assert all(r.ok for r in report.results)
    assert all(r.fingerprint for r in report.results)


# -------------------------------------- explore CLI: population + shrink
def test_explore_population_cli_with_coverage_out(tmp_path, capsys):
    cov = tmp_path / "cov.json"
    rc = sim_cli.main([
        "explore", "--device", "cpu", "--seeds", "0:2", "--replicas", "2",
        "--steps", "25", "--members", "6", "--faults", "all",
        "--population", "2", "--coverage-out", str(cov),
    ])
    out = capsys.readouterr().out
    assert rc == 0
    assert "population 2" in out
    matrix = CoFireMatrix.load(str(cov))
    assert matrix.runs == 2
    assert all(matrix.cells[(f, v)] == 0 for f in FaultConfig.CLASSES
               for v in ("deltas", "daemon", "strong_reads"))
    assert sum(matrix.cells[(f, "base")] for f in FaultConfig.CLASSES) > 0
    # the JAX CLI's matrix over the same sweep is the same matrix
    jcov = tmp_path / "jcov.json"
    from crdt_enc_tpu.tools import sim as jsim_cli

    assert jsim_cli.main([
        "explore", "--seeds", "0:2", "--replicas", "2", "--steps", "25",
        "--members", "6", "--faults", "all", "--population", "2",
        "--coverage-out", str(jcov)]) == 0
    assert json.loads(jcov.read_text()) == json.loads(cov.read_text())


@pytest.mark.parametrize("extra", [["--population", "2"],
                                   ["--budget-s", "1"]])
def test_explore_population_refuses_fs_backend(capsys, extra):
    rc = sim_cli.main(["explore", "--device", "cpu", "--seeds", "0:2",
                       "--backend", "fs", *extra])
    assert rc == 2
    assert "backend memory" in capsys.readouterr().err


def test_explore_population_violation_shrinks_to_replayable_fixture(
    tmp_path, monkeypatch, capsys
):
    """A violation found inside a population ddmin-shrinks (serially,
    through the CLI's executor) to a fixture the real runners of both
    packages replay clean."""
    base = generate(0, 3, 30, FaultConfig.all_faults())
    bad = base.with_steps(list(base.steps)
                          + [Step("rotate", 2), Step("compact", 2)])
    violation = Violation("divergence", "synthetic", step=3)

    def fake_run_population(schedules, *, population=None, substrate=None,
                            device=None):
        return PopulationReport(
            schedules=[generate(1, 3, 30, FaultConfig.all_faults()), bad],
            results=[SimResult(None, fingerprint="a" * 64),
                     SimResult(violation)],
        )

    def oracle(s):
        has = {(st.kind, st.replica) for st in s.steps}
        if ("rotate", 2) in has and ("compact", 2) in has:
            return SimResult(Violation("divergence", "synthetic"))
        return SimResult(None)

    monkeypatch.setattr(psim, "run_population", fake_run_population)
    monkeypatch.setattr(sim_cli, "_executor", lambda device: oracle)
    out_path = tmp_path / "shrunk.json"
    rc = sim_cli.main(["explore", "--device", "cpu", "--seeds", "0:2",
                       "--population", "2", "--shrink", str(out_path)])
    assert rc == 1
    assert "shrunk seed 0" in capsys.readouterr().out
    fixture = json.loads(out_path.read_text())
    small = Schedule.from_obj(fixture)
    assert sorted((s.kind, s.replica) for s in small.steps) == [
        ("compact", 2), ("rotate", 2)]
    assert small.faults.enabled_classes() == []
    assert fixture["violation"]["invariant"] == "divergence"
    port = run_schedule(small, device="cpu")
    jax = jsim.run_schedule(jsim.Schedule.from_obj(fixture))
    assert port.ok and jax.ok and port.fingerprint == jax.fingerprint


# ------------------------------------------------- co-fire coverage map
def _result_firing(*classes):
    r = SimResult(None)
    for c in classes:
        r.fault_stats[c] = 3
    return r


def test_cofire_matrix_counts_holes_and_roundtrips(tmp_path):
    m = CoFireMatrix()
    jm = jsim.CoFireMatrix()
    for mat, pkg in ((m, psim), (jm, jsim)):
        mat.record(pkg.generate(0, 3, 10, pkg.FaultConfig.all_faults()),
                   _result_firing("torn_read"))
        mat.record(pkg.generate(1, 3, 10, pkg.FaultConfig.all_faults(),
                                deltas=True),
                   _result_firing("torn_read", "write_crash"))
    assert m.to_obj() == jm.to_obj()
    assert m.render() == jm.render()
    assert m.runs == 2
    assert m.cells[("torn_read", "base")] == 2
    assert m.cells[("torn_read", "deltas")] == 1
    assert m.cells[("write_crash", "deltas")] == 1
    assert m.cells[("write_crash", "daemon")] == 0
    holes = m.holes()
    assert ("torn_read", "base") not in holes
    assert ("stale_checkpoint", "base") in holes
    assert ("dup_delivery", "base") in holes
    m.dump(str(tmp_path / "cov.json"))
    again = CoFireMatrix.load(str(tmp_path / "cov.json"))
    assert again.to_obj() == m.to_obj()
    with pytest.raises(ValueError, match="version"):
        CoFireMatrix.from_obj({**m.to_obj(), "version": 99})
    table = m.render()
    assert "torn_read" in table and all(v in table for v in VOCABULARIES)
    full = CoFireMatrix()
    full.record(generate(2, 3, 10, FaultConfig.all_faults(), deltas=True,
                         daemon=True, strong_reads=True),
                _result_firing(*FaultConfig.CLASSES))
    assert full.holes() == []
    assert "every fault×vocabulary pair has co-fired" in full.render()


# --------------------------------------------- obs: the counter tap
def test_counter_tap_is_context_local_and_nests():
    trace.add("tap_probe_total", 0)
    with trace.counter_tap() as outer:
        trace.add("tap_probe_total", 2)
        with trace.counter_tap() as inner:
            trace.add("tap_probe_total", 5)
        trace.add("tap_probe_total", 1)
    assert inner == {"tap_probe_total": 5}
    assert outer == {"tap_probe_total": 8}
    trace.add("tap_probe_total", 100)
    assert outer == {"tap_probe_total": 8}

    async def scenario():
        with trace.counter_tap() as tap:
            async def child():
                trace.add("tap_probe_total", 3)
            await asyncio.gather(child(), asyncio.create_task(child()))
            await asyncio.to_thread(trace.add, "tap_probe_total", 4)
        return tap

    assert asyncio.run(scenario()) == {"tap_probe_total": 10}
    with trace.counter_tap() as tap2:
        t = threading.Thread(target=trace.add, args=("tap_probe_total", 7))
        t.start()
        t.join()
    assert tap2 == {}


# ------------------------------------- no build after warm-up as P grows
def test_population_builds_nothing_as_p_grows():
    """After a 4-schedule warm-up through one substrate, re-running the
    same schedules at P = 4 and a twice-larger population of fresh seeds
    builds nothing: no CUDA kernel, no native library."""
    substrate = PopulationSubstrate("cpu")
    try:
        warm = [generate(s, 3, 30, FaultConfig.all_faults(), members=6)
                for s in range(4)]
        assert all(r.ok for r in run_population(
            warm, substrate=substrate).results)
        baseline = obs_runtime.build_count()
        again = run_population(warm, population=4, substrate=substrate)
        assert all(r.ok for r in again.results)
        more = [generate(s, 3, 30, FaultConfig.all_faults(), members=6)
                for s in range(10, 18)]
        grown = run_population(more, population=4, substrate=substrate)
        assert all(r.ok for r in grown.results)
        assert obs_runtime.build_count() == baseline
    finally:
        substrate.close()


# ------------------------------------------------------ fleet acceptance
@pytest.mark.slow
def test_population_acceptance_32_schedules():
    def schedules(pkg):
        return [pkg.generate(seed, 4, 100, pkg.FaultConfig.all_faults(),
                             members=6, deltas=True, daemon=True,
                             strong_reads=True) for seed in range(32)]

    report = run_population(schedules(psim), population=8, device="cpu")
    assert report.violations == []
    assert report.refills == 32 - 8
    fired = set()
    for r in report.results:
        fired.update(k for k, v in r.fault_stats.items() if v)
    assert fired == set(FaultConfig.CLASSES)
    sample = PopulationReport(schedules=report.schedules[:4],
                              results=report.results[:4])
    assert verify_serial_equality(sample, device="cpu") == []
    jreport = jsim.run_population(schedules(jsim), population=8)
    assert tallies(report) == tallies(jreport)
