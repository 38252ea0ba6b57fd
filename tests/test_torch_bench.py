"""The port's bench entry points on the CPU: ``crdt_enc_tpu_torch.bench``
(the ten modes of the root ``bench.py``) and ``crdt_enc_tpu_torch.
benchmarks`` (the suite, the compaction, config 5's phases, the pins).

Each mode runs in process under ``--device cpu`` at a tiny size: one JSON
line with the JAX bench's metric and its gates true, one record in the
``--record`` file and nothing anywhere else.  Without a card and without
``--device cpu`` every entry point prints the ``cuda_unavailable`` line
and exits 3.  The generators equal the JAX bench's byte for byte, and the
data-determined record fields of the default, streaming, delta,
multitenant, idle-cycle and sim modes equal the JAX bench's at the same
seed and size (the fields that differ by design are named with the
reason where they are left out)."""

from __future__ import annotations

import hashlib
import inspect
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
from _jax_gc_guard import hold_the_cyclic_collector  # noqa: F401 (autouse)

from crdt_enc_tpu_torch import bench as pbench
from crdt_enc_tpu_torch.benchmarks import compaction_e2e, pin_baselines
from crdt_enc_tpu_torch.benchmarks import streaming_phases
from crdt_enc_tpu_torch.benchmarks import suite as psuite
from crdt_enc_tpu_torch.tools import obs_report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tiny shapes for every mode (the JAX bench's own knobs)
TINY = {
    "BENCH_OPS": "3000", "BENCH_REPLICAS": "64", "BENCH_MEMBERS": "32",
    "BENCH_HOST_OPS": "1500", "BENCH_CHAIN": "2", "BENCH_ITERS": "1",
    "BENCH_ROUNDS": "1", "BENCH_HOST_RUNS": "1",
    "BENCH_E2E_OPS": "3000", "BENCH_E2E_REPLICAS": "200",
    "BENCH_E2E_MEMBERS": "64", "BENCH_E2E_ITERS": "1",
    "BENCH_DD_OPS": "2000", "BENCH_DD_REPLICAS": "100", "BENCH_DD_ITERS": "1",
    "BENCH_MT_OPS": "48", "BENCH_MT_OPF": "12", "BENCH_MT_MEMBERS": "16",
    "BENCH_DMN_OPS": "48", "BENCH_DMN_OPF": "12", "BENCH_DMN_MEMBERS": "16",
    "BENCH_DMN_CYCLES": "4", "BENCH_IDLE_CYCLES": "1",
    "BENCH_WARM_OPS": "3000", "BENCH_WARM_REPLICAS": "60",
    "BENCH_WARM_MEMBERS": "48",
    "BENCH_DELTA_OPS": "3000", "BENCH_DELTA_REPLICAS": "40",
    "BENCH_DELTA_MEMBERS": "48",
    "BENCH_SIM_SEEDS": "2",
    "BENCH_LOCAL_DISABLE": "1",
}

# mode flags → (the JAX bench's metric, the gate fields that must be true)
MODES = {
    "default": ([], "orset_compaction_fold_ops_per_sec",
                ("full_batch_equal",)),
    "streaming": (["--e2e-streaming", "--producers", "1,2"],
                  "orset_e2e_streaming_ops_per_sec", ("full_batch_equal",)),
    "device-decode": (["--device-decode"], "orset_device_decode_ops_per_sec",
                      ("columns_equal",)),
    "multitenant": (["--e2e-multitenant", "--tenants", "4"],
                    "orset_multitenant_agg_ops_per_sec", ("byte_identical",)),
    "multitenant-mesh": (["--e2e-multitenant", "--tenants", "4", "--mesh",
                          "dp=2,mp=2"],
                         "orset_multitenant_sharded_agg_ops_per_sec",
                         ("byte_identical",)),
    "daemon": (["--e2e-daemon", "--tenants", "4"],
               "daemon_e2e_agg_ops_per_sec", ("byte_identical",)),
    "idle-cycle": (["--e2e-idle-cycle", "--tenants", "4"],
                   "idle_cycle_speedup", ("byte_identical",)),
    "warm-open": (["--e2e-warm-open"], "orset_e2e_warm_open_speedup",
                  ("byte_identical", "opened_from_checkpoint")),
    "delta": (["--e2e-delta"], "orset_e2e_delta_bytes_reduction",
              ("byte_identical",)),
    "strong-read": (["--e2e-strong-read"], "strong_read_e2e_reads_per_sec",
                    ("byte_identical",)),
    "sim": (["--sim"], "sim_schedules_per_sec", ()),
    "sim-population": (["--sim", "--population", "2"],
                       "sim_schedules_per_sec", ("serial_equivalent",)),
}


@pytest.fixture(autouse=True)
def keep_the_logging_state():
    """The JAX bench's ``--sim`` disables logging process-wide
    (``logging.disable(WARNING)``); later tests in this worker read
    warnings, so each test here leaves the switch and the port's logger
    level as it found them."""
    disabled = logging.root.manager.disable
    level = logging.getLogger("crdt_enc_tpu_torch").level
    yield
    logging.disable(disabled)
    logging.getLogger("crdt_enc_tpu_torch").setLevel(level)


def test_the_port_sim_mode_leaves_its_logger_level(tiny, capsys):
    logger = logging.getLogger("crdt_enc_tpu_torch")
    before = logger.level
    run_port(["--sim"], capsys)
    assert logger.level == before


@pytest.fixture
def tiny(monkeypatch):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(pbench, "HOST_RUNS", 1)


def one_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def read_records(path) -> list:
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def committed_records() -> dict:
    out = {}
    for rel in ("BENCH_LOCAL.jsonl", "SUITE_LOCAL.jsonl",
                "benchmarks/pinned_baselines.json"):
        with open(os.path.join(ROOT, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def run_port(argv: list, capsys) -> dict:
    pbench.main(argv + ["--smoke", "--device", "cpu"])
    return one_line(capsys)


def run_jax(argv: list, capsys, monkeypatch) -> dict:
    """The root bench.py's mode in process (its CPU path at ``--smoke``),
    writing nothing."""
    import bench as jbench

    monkeypatch.setattr("sys.argv", ["bench.py", *argv, "--smoke"])
    jbench.main()
    return one_line(capsys)


# ------------------------------------------------------ the line contract


@pytest.mark.parametrize("mode", list(MODES))
def test_each_mode_prints_one_record_and_appends_it(mode, tiny, tmp_path,
                                                    capsys):
    flags, metric, gates = MODES[mode]
    path = tmp_path / "records.jsonl"
    before = committed_records()
    rec = run_port(flags + ["--record", str(path)], capsys)
    assert rec["metric"] == metric
    assert rec["value"] is not None and rec["value"] > 0
    for g in gates:
        assert rec[g] is True, g
    assert rec["backend"] == "cpu" and rec["device_count"] == 1
    assert rec["power_limit_w"] is None
    assert set(rec["launches"]) == {"orset_scatter", "orset_fold",
                                    "orset_stack_cells", "orset_merge_many",
                                    "lww_fold"}
    # the CPU runs the plain versions: no kernel launches
    assert not any(rec["launches"].values())
    (stored,) = read_records(path)
    assert {k: stored[k] for k in rec} == rec
    assert stored["ts"] and stored["host_cpus"]
    assert committed_records() == before


def test_without_record_nothing_is_written(tiny, tmp_path, capsys,
                                           monkeypatch):
    monkeypatch.chdir(tmp_path)
    before = committed_records()
    run_port(["--e2e-streaming"], capsys)
    assert committed_records() == before
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------- the refused record


def plant_full_batch_divergence(monkeypatch):
    """K2's wrapper right on the 20,000-row subsample and wrong (every
    replica's clock one past) on any larger batch."""
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as ocuda

    real = ocuda.orset_fold_cuda

    def wrong_past_the_subsample(clock, add, rm, kind, *rows, **kw):
        out = real(clock, add, rm, kind, *rows, **kw)
        if kind.numel() > 20_000:
            return (out[0] + 1, *out[1:])
        return out

    monkeypatch.setattr(ocuda, "orset_fold_cuda", wrong_past_the_subsample)


def plant_time_past_the_memory_rate(monkeypatch):
    """A roofline share over 100%: a time that measured the enqueue."""
    monkeypatch.setattr(pbench, "roofline_pct", lambda *a: 150.0)


@pytest.mark.parametrize("fault,gate", [
    (plant_full_batch_divergence, "full_batch_equal"),
    (plant_time_past_the_memory_rate, "pct_hbm_peak"),
])
def test_the_fold_record_is_refused(fault, gate, tiny, tmp_path, capsys,
                                    monkeypatch):
    """The default mode prints its line and exits 1, recording nothing,
    when any route diverges at the full batch (after passing the
    subsample) or implies more than the card's memory rate."""
    monkeypatch.setenv("BENCH_OPS", "24000")
    fault(monkeypatch)
    path = tmp_path / "records.jsonl"
    with pytest.raises(SystemExit) as ei:
        pbench.main(["--smoke", "--device", "cpu", "--record", str(path)])
    assert ei.value.code == 1
    rec = one_line(capsys)
    if gate == "full_batch_equal":
        assert rec["full_batch_equal"] is False
        assert rec["diverged"] == ["k2_fused"]
    else:
        assert rec["full_batch_equal"] is True
        assert rec["pct_hbm_peak"] == 150.0
    assert not path.exists()


def test_the_streaming_record_is_held_to_the_host_loop(tiny, tmp_path,
                                                       capsys, monkeypatch):
    """A fault common to the sequential front end and the overlapped
    stream (one extra element after every fold session's finish) passes
    a comparison of the two; the host loop refuses it (exit 1)."""
    from crdt_enc_tpu_torch.models.orset import AddOp
    from crdt_enc_tpu_torch.models.vclock import Dot
    from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator

    real = TorchAccelerator.open_fold_session

    def faulty_session(self, state, actors_hint=()):
        session = real(self, state, actors_hint=actors_hint)
        finish = session.finish

        def finish_then_add():
            out = finish()
            state.apply(AddOp(10**6, Dot(b"\xff" * 16, 1)))
            return out

        session.finish = finish_then_add
        return session

    monkeypatch.setattr(TorchAccelerator, "open_fold_session",
                        faulty_session)
    path = tmp_path / "records.jsonl"
    with pytest.raises(SystemExit) as ei:
        pbench.main(["--e2e-streaming", "--producers", "1,2", "--smoke",
                     "--device", "cpu", "--record", str(path)])
    assert ei.value.code == 1
    rec = one_line(capsys)
    assert rec["full_batch_equal"] is False
    assert rec["sequential_equal"] is False
    assert not any(r["full_batch_equal"]
                   for r in rec["producer_sweep"].values())
    assert not path.exists()


ENTRY_POINTS = {
    **{f"bench {m}": (pbench.main, flags) for m, (flags, _, _) in
       MODES.items()},
    "suite": (psuite.main, []),
    "compaction_e2e": (compaction_e2e.main, []),
    "streaming_phases": (streaming_phases.main, []),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_no_card_without_device_cpu_exits_3(entry, tmp_path, capsys,
                                            monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn, flags = ENTRY_POINTS[entry]
    path = tmp_path / "records.jsonl"
    with pytest.raises(SystemExit) as ei:
        fn(flags + ["--smoke", "--record", str(path)])
    assert ei.value.code == 3
    rec = one_line(capsys)
    assert rec["value"] is None and rec["error"] == "cuda_unavailable"
    assert not path.exists()


def test_the_module_exits_3_with_the_diagnostic_line_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the missing-card path cannot run")
    r = subprocess.run(
        [sys.executable, "-m", "crdt_enc_tpu_torch.bench", "--smoke"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec == {**rec, "metric": "orset_compaction_fold_ops_per_sec",
                   "value": None, "error": "cuda_unavailable"}


def test_suite_prints_one_line_a_config_and_records_each(tiny, tmp_path,
                                                        capsys, monkeypatch):
    monkeypatch.setenv("SUITE_SCALE", "0.004")
    path = tmp_path / "suite.jsonl"
    before = committed_records()
    assert psuite.main(["--device", "cpu", "--iters", "1", "--record",
                        str(path)]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r.get("config") for r in lines[:5]] == [
        "gcounter_4x1k", "pncounter_1kx100k", "orset_10kx1M",
        "lwwmap_1Mx10k", "mixed_streaming_100k"]
    assert all(r["byte_equal"] and r["backend"] == "cpu" and r["value"] > 0
               for r in lines[:5])
    assert lines[4]["metric"] == "ops_streamed_per_sec"
    assert lines[5]["suite"] == "baseline_configs"
    assert lines[5]["all_byte_equal"] is True
    assert [r["config"] for r in read_records(path)] == [
        r["config"] for r in lines[:5]]
    assert committed_records() == before


def test_compaction_e2e_byte_equal_across_its_children(tmp_path, capsys,
                                                       monkeypatch):
    """The children run in this process here (each one's contract is its
    last stdout line); the card's run spawns them."""
    def child(args):
        compaction_e2e.main(args)
        return capsys.readouterr().out.strip().splitlines()[-1]

    monkeypatch.setattr(compaction_e2e, "_child", child)
    path = tmp_path / "c.jsonl"
    compaction_e2e.main(["--device", "cpu", "--writers", "3", "--files", "4",
                         "--ops-per-file", "9", "--members", "16",
                         "--snapshots", "2", "--record", str(path)])
    rec = one_line(capsys)
    assert rec["metric"] == "compaction_e2e_ops_per_sec"
    assert rec["byte_equal"] is True and rec["n_ops"] == 3 * 4 * 9
    assert rec["n_files"] == 12 and rec["backend"] == "cpu"
    # three states (the replica's and two snapshots) take K4's route
    assert "merge.device" in rec["device_spans"]
    assert read_records(path)[0]["value"] == rec["value"]


def test_streaming_phases_one_line(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(streaming_phases, "ITERS", 1)
    path = tmp_path / "p.jsonl"
    streaming_phases.main(["--smoke", "--device", "cpu", "--record",
                           str(path)])
    rec = one_line(capsys)
    assert rec["config"] == "mixed_streaming_100k_phases"
    assert rec["byte_equal"] is True and rec["ops"] > 0
    assert read_records(path)[0]["e2e_overlapped_s"] == rec["e2e_overlapped_s"]


def test_pin_tool_writes_only_its_own_file_with_the_machine(tmp_path,
                                                          capsys):
    out = tmp_path / "pins.json"
    before = committed_records()
    assert pin_baselines.main(["--config", "1", "--runs", "1", "--out",
                               str(out), "--machine", "test host"]) == 0
    pins = json.loads(out.read_text())
    assert pins["gcounter_4x1k"]["machine"] == "test host"
    assert pins["gcounter_4x1k"]["shape"] == {"N": 1000, "R": 4}
    assert committed_records() == before
    assert pin_baselines.SPREAD_LIMIT_PCT == 30.0
    assert pin_baselines.spread_gate("x", {"host_spread_pct": 30.0})
    assert not pin_baselines.spread_gate("x", {"host_spread_pct": 30.1})
    assert pin_baselines.spread_gate("x", {"host_spread_pct": 99}, force=True)


def test_the_port_never_reads_the_jax_pin_file():
    assert os.path.dirname(pbench.PINNED_PATH) == os.path.join(
        ROOT, "crdt_enc_tpu_torch", "benchmarks")
    assert pbench.load_pinned("orset_10kx1M",
                              {"N": 1, "R": 1, "E": 1, "n_host": 1}) is None


def test_trend_and_gap_read_a_port_record_file(tiny, tmp_path, capsys):
    path = tmp_path / "records.jsonl"
    for flags in (["--e2e-streaming"], ["--e2e-streaming"],
                  ["--e2e-multitenant", "--tenants", "4"]):
        run_port(flags + ["--record", str(path)], capsys)
    assert obs_report.main(["trend", str(path)]) == 0
    out = capsys.readouterr().out
    assert "orset_e2e_streaming_ops_per_sec [cpu]" in out
    assert "orset_multitenant_agg_ops_per_sec [cpu]" in out
    assert obs_report.main(["trend", str(path), "--json"]) == 0
    trend = json.loads(capsys.readouterr().out)["trend"]
    assert sorted(len(c["runs"]) for c in trend) == [1, 2]
    for metric, pipeline in (("orset_e2e_streaming_ops_per_sec", "streaming"),
                             ("orset_multitenant_agg_ops_per_sec", "serve")):
        assert obs_report.main(["gap", str(path), "--metric", metric]) == 0
        assert f"({pipeline} pipeline)" in capsys.readouterr().out


# ------------------------------------------------ the JAX bench's data


@pytest.mark.parametrize("N,R,E,seed", [(5000, 64, 32, 7), (20_000, 500, 128,
                                                           5),
                                        (777, 3, 9, 23), (10, 1, 1, 11)])
def test_gen_columns_equals_the_jax_bench(N, R, E, seed):
    import bench as jbench

    for got, want in zip(pbench.gen_columns(N, R, E, seed),
                         jbench.gen_columns(N, R, E, seed)):
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()


def test_bytes_model_and_tenant_layout_equal_the_jax_bench():
    import bench as jbench

    assert pbench.orset_fold_bytes_model(10**6, 4096, 10**4) == \
        jbench.orset_fold_bytes_model(10**6, 4096, 10**4)
    for seed in (100, 500, 901):
        assert pbench.tenant_files(384, 4, 64, 24, seed) == \
            jbench._daemon_tenant_files(384, 4, 64, 24, seed)


def test_suite_generators_equal_the_jax_suite():
    import secrets

    from benchmarks import suite as jsuite
    from crdt_enc_tpu.backends.xchacha import decrypt_blob as j_decrypt

    from crdt_enc_tpu_torch.backends.xchacha import decrypt_blob

    g = np.random.default_rng(3).integers(0, 50, 4000).astype(np.int32)
    assert psuite.running_count(g, 50).tobytes() == \
        jsuite.running_count(g, 50).tobytes()
    assert psuite.actor_bytes_table(300) == jsuite.actor_bytes_table(300)
    key = secrets.token_bytes(32)
    port = psuite._build_encrypted_files(3000, 400, 64, 48, key, n_headers=3)
    jax = jsuite._build_encrypted_files(3000, 400, 64, 48, key, n_headers=3)
    # the ciphertexts carry random nonces; what they seal is byte-equal
    assert port[1] == jax[1]
    assert port[3] == jax[3]
    assert [decrypt_blob(key, b) for b in port[0]] == port[1]
    assert [j_decrypt(key, b) for b in port[0]] == jax[1]
    assert [decrypt_blob(key, b) for b in port[2]] == \
        [j_decrypt(key, b) for b in jax[2]]


def test_default_mode_fields_equal_the_jax_bench(tiny, capsys, monkeypatch):
    port = run_port([], capsys)
    jax = run_jax([], capsys, monkeypatch)
    # the JAX record's method names its TPU timing (marginal_chain); the
    # port's its CUDA events or host clock; best_variant names each
    # package's own routes
    for k in ("metric", "unit", "bytes_model", "full_batch_equal"):
        assert port[k] == jax[k], k


def test_streaming_fields_equal_the_jax_bench(tiny, capsys, monkeypatch,
                                              tmp_path):
    import bench as jbench

    monkeypatch.setenv("BENCH_LOCAL_DISABLE", "0")
    monkeypatch.setenv("BENCH_LOCAL_ALL", "1")
    jlog = tmp_path / "jax.jsonl"
    monkeypatch.setattr(jbench, "LOCAL_LOG", str(jlog))
    flags = ["--e2e-streaming", "--producers", "1,3"]
    port = run_port(flags, capsys)
    jax = run_jax(flags, capsys, monkeypatch)
    (jrec,) = read_records(jlog)
    for k in ("metric", "config", "unit", "full_batch_equal"):
        assert port[k] == jax[k], k
    assert port["shape"] == jrec["shape"]
    assert {n: r["full_batch_equal"] for n, r in
            port["producer_sweep"].items()} == {
        n: r["full_batch_equal"] for n, r in jax["producer_sweep"].items()}


def test_delta_fields_equal_the_jax_bench(tiny, capsys, monkeypatch):
    port = run_port(["--e2e-delta"], capsys)
    jax = run_jax(["--e2e-delta"], capsys, monkeypatch)
    for k in ("metric", "config", "unit", "files_read_delta_path",
              "files_read_snapshot_path", "deltas_applied", "deltas_sealed",
              "delta_fallbacks", "byte_identical"):
        assert port[k] == jax[k], k
    # By design the bytes differ: the JAX generator burns its first tail
    # round (bench.py:2139-2144, the prefix loop's break consumes it), so
    # each round's files land one version past a gap and no reader ever
    # folds them; the port stores the rounds it makes, so its deltas and
    # snapshots carry the tails.
    assert port["delta_bytes_sealed"] > jax["delta_bytes_sealed"]
    assert port["bytes_read_snapshot_path"] > jax["bytes_read_snapshot_path"]


def test_multitenant_fields_equal_the_jax_bench(tiny, capsys, monkeypatch):
    flags = ["--e2e-multitenant", "--tenants", "4"]
    port = run_port(flags, capsys)
    jax = run_jax(flags, capsys, monkeypatch)
    for k in ("metric", "config", "unit", "fold_paths", "byte_identical"):
        assert port[k] == jax[k], k
    for k in ("tail_ops", "warm_hits"):
        assert port["warm_cycle"][k] == jax["warm_cycle"][k], k


def test_idle_cycle_fields_equal_the_jax_bench(tiny, capsys, monkeypatch):
    flags = ["--e2e-idle-cycle", "--tenants", "4"]
    port = run_port(flags, capsys)
    jax = run_jax(flags, capsys, monkeypatch)
    for k in ("metric", "config", "unit", "byte_identical"):
        assert port[k] == jax[k], k
    # h2d_bytes differs by design (the JAX CPU backend counts its
    # device_puts, the port counts uploads to a card only) and the JAX
    # jax_compiles is the port's cuda_builds.  delta_base_bytes is a
    # last-writer gauge across tenants (crdt_enc_tpu/core/core.py:2281):
    # where every tenant re-seals (full_refold) the writer is whichever
    # seal task ends last, so it is compared where one tenant seals
    keys = ("active_fraction", "active_tenants", "serve_noop_cycles",
            "delta_device_cuts")
    for arm in ("continuation", "full_refold"):
        extra = ("delta_base_bytes",) if arm == "continuation" else ()
        assert [{k: r[k] for k in keys + extra} for r in port[arm]] == \
            [{k: r[k] for k in keys + extra} for r in jax[arm]], arm
        assert all(r["cuda_builds"] == 0 for r in port[arm])


def test_sim_fields_and_fingerprints_equal_the_jax_simulator(tiny, capsys,
                                                            monkeypatch):
    from crdt_enc_tpu.sim import generate, run_schedule
    from crdt_enc_tpu.tools.sim import _build_faults

    flags = ["--sim", "--replicas", "3", "--steps", "30"]
    port = run_port(flags, capsys)
    jax = run_jax(flags, capsys, monkeypatch)
    for k in ("metric", "config", "unit", "schedules", "replicas", "steps",
              "faults", "faults_survived", "faults_survived_total",
              "ingest_quarantined", "quiescence_checks", "violations"):
        assert port[k] == jax[k], k
    faults = _build_faults("all")
    assert port["fingerprints"] == [
        run_schedule(generate(seed, 3, 30, faults)).fingerprint
        for seed in range(2)]


# ------------------------------------------------ the switches' defaults


def test_the_switches_the_benches_set_have_the_jax_defaults():
    from crdt_enc_tpu.parallel.accel import TpuAccelerator
    from crdt_enc_tpu.serve import DaemonConfig as JDaemonConfig
    from crdt_enc_tpu.serve import ServeConfig as JServeConfig

    from crdt_enc_tpu_torch.parallel import accel as A
    from crdt_enc_tpu_torch.serve import DaemonConfig, ServeConfig

    for k in ("warm", "noop_skip"):
        assert getattr(ServeConfig(), k) == getattr(JServeConfig(), k) is True
    for k in ("admission_bytes", "min_backlog_files"):
        assert getattr(DaemonConfig(), k) == getattr(JDaemonConfig(), k)
    port = inspect.signature(A.TorchAccelerator.fold_encrypted_stream)
    jax = inspect.signature(TpuAccelerator.fold_encrypted_stream)
    assert port.parameters["n_producers"].default == \
        jax.parameters["n_producers"].default == 0
    # None resolves to the module's chunk count, the JAX default
    assert port.parameters["n_chunks"].default is None
    assert A.ENCRYPTED_STREAM_CHUNKS == jax.parameters["n_chunks"].default
