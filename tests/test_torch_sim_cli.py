"""``python -m crdt_enc_tpu_torch.tools.sim`` against the JAX package's
simulator CLI, on the CPU (``--device cpu``).

``run``, ``explore`` and ``replay`` print the JAX CLI's report lines for
the same schedules; ``replay`` runs the committed fixtures; usage errors
exit 2; and ``--device cuda`` (the default) without a card exits 1 with
the ``DeviceUnavailableError`` message ``tools.daemon run`` gives.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from crdt_enc_tpu.tools import sim as jcli
from crdt_enc_tpu_torch.sim import SimResult, Violation
from crdt_enc_tpu_torch.tools import daemon as daemon_cli
from crdt_enc_tpu_torch.tools import sim as cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "tests", "data", "sim")


def both(capsys, argv):
    """The port CLI (with ``--device cpu``) and the JAX CLI on the same
    arguments: exit codes and standard output must be equal."""
    rc = cli.main([argv[0], "--device", "cpu", *argv[1:]])
    out = capsys.readouterr().out
    jrc = jcli.main(argv)
    jout = capsys.readouterr().out
    assert (rc, out) == (jrc, jout)
    return rc, out


@pytest.mark.parametrize("flags", [[], ["--deltas", "--daemon",
                                        "--strong-reads"]],
                         ids=["base", "all_vocabularies"])
def test_run_matches_the_jax_cli(capsys, flags):
    rc, out = both(capsys, ["run", "--seed", "2", "--replicas", "3",
                            "--steps", "40", "--faults", "all", *flags])
    assert rc == 0 and out.startswith("run: seed=2 replicas=3")


def test_explore_matches_the_jax_cli(capsys):
    rc, out = both(capsys, ["explore", "--seeds", "0:3", "--replicas", "3",
                            "--steps", "25", "--faults",
                            "torn_read,write_crash"])
    assert rc == 0 and "explore: 3 schedules, 0 failure(s)" in out


def test_replay_committed_fixtures(capsys):
    rc = cli.main(["replay", "--device", "cpu", FIXTURE_DIR])
    out = capsys.readouterr().out
    assert rc == 0
    assert out.count(": PASS (was: ") == len(
        [f for f in os.listdir(FIXTURE_DIR) if f.endswith(".json")])
    assert "8 fixture(s), 0 regression(s)" in out


def test_replay_refuses_stray_and_unreadable_files(tmp_path, capsys):
    (tmp_path / "notes.txt").write_text("x")
    assert cli.main(["replay", "--device", "cpu", str(tmp_path)]) == 2
    assert "non-fixture files" in capsys.readouterr().err
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"v": 99}))
    assert cli.main(["replay", "--device", "cpu", str(bad)]) == 2
    assert "unreadable fixture" in capsys.readouterr().err


def test_run_shrinks_a_violation_to_a_fixture(tmp_path, monkeypatch, capsys):
    """``run --shrink`` on a failure writes a fixture both packages'
    schema readers accept (a synthetic two-step oracle stands in for
    the runner)."""

    def oracle(s):
        kinds = {st.kind for st in s.steps}
        if "add" in kinds and "compact" in kinds:
            return SimResult(Violation("divergence", "synthetic"))
        return SimResult(None)

    monkeypatch.setattr(cli, "_executor", lambda device: oracle)
    out_path = tmp_path / "small.json"
    rc = cli.main(["run", "--device", "cpu", "--seed", "1", "--replicas",
                   "3", "--steps", "60", "--shrink", str(out_path)])
    assert rc == 1
    assert "VIOLATION [divergence]" in capsys.readouterr().out
    from crdt_enc_tpu.sim import Schedule as JSchedule

    fixture = json.loads(out_path.read_text())
    assert len(JSchedule.from_obj(fixture).steps) == 2


@pytest.mark.parametrize("argv", [
    ["run", "--device", "tpu"],
    ["run", "--device", "meta"],
    ["run", "--device", "cpu", "--faults", "nonsense"],
    ["explore", "--device", "cpu", "--seeds", "zero"],
    ["bogus"],
    ["replay", "--device", "cpu"],
], ids=["tpu", "meta", "fault_class", "seeds", "command", "no_fixtures"])
def test_usage_errors_exit_2(argv, capsys):
    assert cli.main(argv) == 2


def test_no_card_exits_1_like_tools_daemon(capsys):
    """``--device cuda`` (the default) without a card: exit 1 with the
    message ``tools.daemon run`` prints; never a silent CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    daemon_rc = daemon_cli.main(["run", "--tenant", "l=r"])
    daemon_err = capsys.readouterr().err
    for argv in (["run"], ["run", "--device", "cuda"],
                 ["replay", FIXTURE_DIR], ["explore", "--seeds", "0:1"]):
        assert cli.main(argv) == 1 == daemon_rc
        err = capsys.readouterr().err
        assert err == daemon_err
        assert err.startswith("DeviceUnavailableError: --device cuda")


def test_module_entry_point(tmp_path):
    """``python -m crdt_enc_tpu_torch.tools.sim`` runs as a program."""
    fixture = os.path.join(FIXTURE_DIR, "torn_op_read_abort.json")
    proc = subprocess.run(
        [sys.executable, "-m", "crdt_enc_tpu_torch.tools.sim", "replay",
         "--device", "cpu", fixture],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "1 fixture(s), 0 regression(s)" in proc.stdout
