"""The port's adversarial simulator (crdt_enc_tpu_torch.sim) against the
JAX package's on the CPU.

Each twin generates one schedule in both packages (the generators must
agree step for step), runs it through the JAX runner and through the
port's ``SimRunner(..., device="cpu")`` — odd replicas, the service and
the daemon folding through the kernels' plain PyTorch versions — and
compares ``ok``, the violation, the fault tallies, the counts of checks,
service and daemon cycles, and the ``fingerprint`` (final canonical
states, cursors and fault tallies) exactly.  The fs backend keeps
thread-pool timing, so its runs compare ``ok`` only.  The fleet-scale
run is ``slow`` like its JAX twin.
"""

from __future__ import annotations

import glob
import json
import os

import pytest
from _jax_gc_guard import hold_the_cyclic_collector  # noqa: F401 (autouse)
import torch

import crdt_enc_tpu.sim as jsim
import crdt_enc_tpu_torch.sim as psim
from crdt_enc_tpu_torch.core.adapters import HostAccelerator
from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "data", "sim")
FIXTURES = sorted(glob.glob(os.path.join(FIXTURE_DIR, "*.json")))


def both(seed, n, steps, faults="all_faults", **kw):
    """The same schedule from both generators (asserted step-equal)."""
    j = jsim.generate(seed, n, steps, getattr(jsim.FaultConfig, faults)(),
                      **kw)
    p = psim.generate(seed, n, steps, getattr(psim.FaultConfig, faults)(),
                      **kw)
    assert p.to_obj() == j.to_obj()
    return j, p


def summary(result) -> dict:
    v = result.violation
    return {
        "ok": result.ok,
        "violation": None if v is None else v.to_obj(),
        "fault_stats": dict(result.fault_stats),
        "steps_run": result.steps_run,
        "checks_run": result.checks_run,
        "service_cycles": result.service_cycles,
        "daemon_cycles": result.daemon_cycles,
        "strong_reads": result.strong_reads,
        "strong_timeouts": result.strong_timeouts,
        "transient_missing_key": result.transient_missing_key,
        "quarantined": result.quarantined,
        "fingerprint": result.fingerprint,
    }


def twin(jsched, psched, **kw):
    """Run both; the port's summary must equal the JAX one field for
    field.  Returns the port's result."""
    jres = jsim.run_schedule(jsched, **kw)
    pres = psim.run_schedule(psched, device="cpu", **kw)
    assert summary(pres) == summary(jres)
    return pres


# ---------------------------------------------------------------- smokes
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_schedule_converges(seed):
    j, p = both(seed, 4, 80)
    result = twin(j, p)
    assert result.ok, result.violation
    assert result.checks_run >= 1
    assert sum(result.fault_stats.values()) > 0


def test_adversarial_schedule_converges_fs(tmp_path):
    j, p = both(1, 3, 60, backend="fs")
    assert jsim.run_schedule(j, tmpdir=str(tmp_path / "jax")).ok
    result = psim.run_schedule(p, tmpdir=str(tmp_path / "port"),
                               device="cpu")
    assert result.ok, result.violation


def test_adversarial_schedule_converges_chunked_sessions(tmp_path,
                                                         monkeypatch):
    """Tiny fs chunks and instant session promotion force multi-chunk
    fold sessions on every device-replica sync, under faults."""
    import crdt_enc_tpu.parallel.session as JS
    import crdt_enc_tpu_torch.parallel.session as PS
    from crdt_enc_tpu.backends.fs import FsStorage as JFs
    from crdt_enc_tpu_torch.backends.fs import FsStorage as PFs

    for S, Fs in ((JS, JFs), (PS, PFs)):
        monkeypatch.setattr(S, "BUFFER_BYTES", 64)
        monkeypatch.setattr(Fs, "CHUNK_BYTES", 2048)
    j, p = both(7, 3, 50, backend="fs")
    assert jsim.run_schedule(j, tmpdir=str(tmp_path / "jax")).ok
    result = psim.run_schedule(p, tmpdir=str(tmp_path / "port"),
                               device="cpu")
    assert result.ok, result.violation


# --------------------------------------------------------- determinism
def test_deterministic_replay_from_seed():
    j, p = both(5, 4, 70)
    r1 = twin(j, p)
    r2 = psim.run_schedule(p, device="cpu")
    assert r1.ok, r1.violation
    assert summary(r2) == summary(r1)
    assert sum(r1.fault_stats.values()) > 0


@pytest.mark.parametrize("flags", [
    {"deltas": True},
    {"daemon": True},
    {"strong_reads": True},
    {"deltas": True, "daemon": True, "strong_reads": True},
], ids=["deltas", "daemon", "strong_reads", "all_vocabularies"])
def test_vocabulary_schedules_match(flags):
    """Each vocabulary extension (and all three at once): the same
    steps from both generators, the same fingerprint from both
    runners."""
    j, p = both(3, 4, 100, **flags)
    assert twin(j, p).ok


# ------------------------------------------------- FoldService in the loop
def test_service_sealed_tenants_in_faulty_history():
    j, p = both(6, 4, 50)
    extra = [("service", 0, 1), ("add", 2, 3), ("compact", 2, 0),
             ("service", 3, 3), ("add", 1, 5), ("service", 1, 2)]
    j = j.with_steps(list(j.steps) + [jsim.Step(*s) for s in extra])
    p = p.with_steps(list(p.steps) + [psim.Step(*s) for s in extra])
    result = twin(j, p)
    assert result.ok, result.violation
    assert result.service_cycles >= 3


# ------------------------------------------------------------- fixtures
@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(f) for f in FIXTURES])
def test_shrunk_fixtures_replay_clean(path, tmp_path):
    """Every committed fixture (the JAX package's format) replays clean
    on the port, with the JAX runner's fingerprint."""
    with open(path) as f:
        obj = json.load(f)
    assert obj.get("violation", {}).get("invariant") or obj["note"]
    j, p = jsim.Schedule.from_obj(obj), psim.Schedule.from_obj(obj)
    assert p.to_obj() == j.to_obj()
    result = twin(j, p, tmpdir=str(tmp_path))
    assert result.ok, (path, result.violation)


def test_fixture_set_is_the_jax_packages():
    assert len(FIXTURES) >= 8
    assert [e for e in os.listdir(FIXTURE_DIR) if not e.endswith(".json")] \
        == []


def test_fixture_schema_roundtrip():
    schedule = psim.generate(3, 3, 20, psim.FaultConfig.all_faults())
    again = psim.Schedule.from_obj(schedule.to_obj())
    assert again.to_obj() == schedule.to_obj()
    assert jsim.Schedule.from_obj(schedule.to_obj()).to_obj() \
        == schedule.to_obj()
    with pytest.raises(ValueError):
        psim.Schedule.from_obj({**schedule.to_obj(), "v": 99})
    with pytest.raises(ValueError):
        bad = schedule.to_obj()
        bad["steps"] = [["add", 17, 0]]  # replica out of range
        psim.Schedule.from_obj(bad)


@pytest.mark.parametrize("flags", [
    {}, {"daemon": True}, {"deltas": True}, {"strong_reads": True},
    {"deltas": True, "daemon": True, "strong_reads": True, "members": 6},
    {"backend": "fs"},
], ids=["base", "daemon", "deltas", "strong_reads", "all", "fs"])
def test_generators_agree(flags):
    """``generate`` draws the JAX package's RNG stream: the same seed
    and flags give the same steps, with and without faults."""
    for seed in (0, 3, 42):
        both(seed, 4, 200, "none", **flags)
        both(seed, 8, 200, **flags)


# -------------------------------------------------------------- shrinker
class FakeResult:
    def __init__(self, violation):
        self.violation = violation


def needle_oracle(pkg):
    def run_fn(s):
        has = {(st.kind, st.replica) for st in s.steps}
        if ("rotate", 2) in has and ("compact", 2) in has:
            return FakeResult(pkg.Violation("divergence", "synthetic"))
        return FakeResult(None)

    return run_fn


def test_shrinker_minimizes_steps_and_faults():
    """ddmin against a synthetic oracle, in both packages: the same
    minimal schedule (two steps, no faults)."""
    out = []
    for pkg in (jsim, psim):
        schedule = pkg.generate(0, 3, 40, pkg.FaultConfig.all_faults())
        schedule = schedule.with_steps(
            list(schedule.steps) + [pkg.Step("rotate", 2),
                                    pkg.Step("compact", 2)])
        small, violation = pkg.shrink(
            schedule, pkg.Violation("divergence", "synthetic"),
            needle_oracle(pkg), max_runs=400)
        assert violation.invariant == "divergence"
        out.append(pkg.to_fixture(small, violation))
    assert out[1] == out[0]
    small = psim.Schedule.from_obj(out[1])
    assert sorted((s.kind, s.replica) for s in small.steps) == [
        ("compact", 2), ("rotate", 2)]
    assert small.faults.enabled_classes() == []


def test_shrinker_rejects_different_invariant():
    schedule = psim.generate(0, 3, 10, psim.FaultConfig.none())
    schedule = schedule.with_steps(list(schedule.steps)
                                   + [psim.Step("rotate", 1)])

    def run_fn(s):
        if len(s.steps) == len(schedule.steps):
            return FakeResult(psim.Violation("divergence", "original"))
        return FakeResult(psim.Violation("fsck", "decoy"))

    small, violation = psim.shrink(
        schedule, psim.Violation("divergence", "original"), run_fn,
        max_runs=60)
    assert violation.invariant == "divergence"
    assert len(small.steps) == len(schedule.steps)


@pytest.mark.parametrize("shrinker", ["jax", "port"])
def test_shrunk_schedule_replays_in_the_other_package(shrinker):
    """A fixture shrunk by either package replays in both, with equal
    fingerprints: the real runner's first ``compact``-bearing prefix of
    a faulty schedule, reduced by ddmin against a prefix oracle."""
    pkg = jsim if shrinker == "jax" else psim
    schedule = pkg.generate(4, 3, 40, pkg.FaultConfig.all_faults())

    def run_fn(s):
        kinds = [st.kind for st in s.steps]
        if "compact" in kinds and "add" in kinds:
            return FakeResult(pkg.Violation("oracle", "synthetic"))
        return FakeResult(None)

    small, violation = pkg.shrink(
        schedule, pkg.Violation("oracle", "synthetic"), run_fn,
        max_runs=300)
    fixture = json.loads(json.dumps(pkg.to_fixture(small, violation)))
    j, p = jsim.Schedule.from_obj(fixture), psim.Schedule.from_obj(fixture)
    assert len(p.steps) == 2
    assert twin(j, p).ok


# ----------------------------------------------- where each replica folds
def test_even_replicas_and_oracle_on_host_odd_on_device(monkeypatch):
    """Even replicas, the oracle refold and the warm≡cold opens' even
    sample run on ``HostAccelerator``; odd replicas on a
    ``TorchAccelerator`` on the runner's device."""
    from crdt_enc_tpu_torch.core.core import Core

    seen = []
    real_open = Core.open.__func__

    async def spy(cls, opts):
        seen.append((opts.storage, opts.accelerator))
        return await real_open(cls, opts)

    monkeypatch.setattr(Core, "open", classmethod(spy))
    runner = psim.SimRunner(
        psim.Schedule(seed=1, n_replicas=3,
                      steps=[psim.Step("add", 0, 1), psim.Step("add", 1, 2),
                             psim.Step("quiesce")]),
        device="cpu")
    assert runner.run().ok
    wrappers = {id(r.storage): r.idx for r in runner.replicas}
    for storage, accel in seen:
        idx = wrappers.get(id(storage))
        if idx is not None and idx % 2 == 1:
            assert type(accel) is TorchAccelerator
            assert accel.device == torch.device("cpu")
        else:
            # even replicas, the oracle and the fsck/clean opens
            assert type(accel) is HostAccelerator, (idx, accel)
    # the oracle opened (clean storage, not a replica wrapper)
    assert any(id(s) not in wrappers for s, _ in seen)
    assert any(type(a) is TorchAccelerator for _, a in seen)


def test_device_defaults_to_cuda():
    """``SimRunner`` and ``run_schedule`` fold on the card unless asked
    otherwise; without one, the first device replica's open raises."""
    sched = psim.generate(0, 2, 5, psim.FaultConfig.none())
    runner = psim.SimRunner(sched)
    assert runner.device == "cuda"
    if torch.cuda.is_available():
        assert runner.run().ok
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run()


# ------------------------------------------------------------ fleet scale
@pytest.mark.slow
def test_fleet_scale_every_fault_class():
    j, p = both(42, 8, 500)
    result = twin(j, p)
    assert result.ok, result.violation
    for cls in psim.FaultConfig.CLASSES:
        assert result.fault_stats.get(cls, 0) > 0, f"{cls} never fired"
    assert result.service_cycles >= 1
    assert psim.run_schedule(p, device="cpu").fingerprint \
        == result.fingerprint
