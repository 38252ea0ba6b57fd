"""The port's daemon entry point (``python -m
crdt_enc_tpu_torch.tools.daemon run``) on the CPU.

Three tenants' remotes on the filesystem are written once, then copied
byte for byte (remote and local directory) for the port's CLI and for the
JAX CLI (``crdt_enc_tpu.tools.daemon.main(["run", ...])``).  Each runs two
supervised cycles with a live endpoint on an ephemeral port and drains:
both exit 0, every tenant then reopens warm from the drain's checkpoint,
and each tenant's state, cursor and sealed snapshot payloads are equal
across the packages (tolerance 0; the snapshot ciphertexts differ only by
their nonces, so the payloads are compared decrypted).  Usage errors exit
2, ``--device cuda`` without a card stops with ``DeviceUnavailableError``
and exit 1, and SIGTERM drains a running process.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from crdt_enc_tpu.tools import daemon as jdaemon_cli
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    HostAccelerator,
    OpenOptions,
    PlainKeyCryptor,
    XChaChaCryptor,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.tools import daemon as daemon_cli
from crdt_enc_tpu_torch.utils import codec
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_TENANTS = 3


def run(coro):
    return asyncio.run(coro)


def host_opts(local, remote, create=True):
    return OpenOptions(
        storage=FsStorage(str(local), str(remote)), cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=HostAccelerator(),
    )


async def seed(root: pathlib.Path) -> None:
    """Three tenants under ``root/base``: a writer's adds and removes on
    each remote, and the tenant's own local directory (its actor)."""
    for t in range(N_TENANTS):
        remote = root / "base" / f"r{t}"
        w = await Core.open(host_opts(root / "base" / f"w{t}", remote))
        for i in range(20 + 7 * t):
            m = b"t%d-%d" % (t, i % 9)
            await w.update(lambda s, m=m: s.add_ctx(w.actor_id, m))
            if i % 6 == 5:
                v = b"t%d-%d" % (t, (i * 5) % 9)
                await w.update(
                    lambda s, v=v: s.rm_ctx(v) if v in s.entries else [])
        await Core.open(host_opts(root / "base" / f"l{t}", remote))


def copy_fleet(root: pathlib.Path, variant: str) -> list:
    out = []
    for t in range(N_TENANTS):
        for k in ("r", "l"):
            shutil.copytree(root / "base" / f"{k}{t}",
                            root / variant / f"{k}{t}")
        out.append(f"{root / variant / f'l{t}'}={root / variant / f'r{t}'}")
    return out


async def reopened(root: pathlib.Path, variant: str) -> list:
    """Each tenant reopened by a host-loop core from its local directory:
    (warm?, state bytes, cursor, decrypted snapshot payloads)."""
    out = []
    for t in range(N_TENANTS):
        core = await Core.open(host_opts(root / variant / f"l{t}",
                                         root / variant / f"r{t}",
                                         create=False))
        names = await core.storage.list_state_names()
        snaps = sorted([codec.pack(await core._open_sealed(raw)) for _, raw
                        in await core.storage.load_states(names)])
        out.append((core.opened_from_checkpoint,
                    core.with_state(canonical_bytes),
                    codec.pack(core._data.next_op_versions.to_obj()),
                    snaps))
    return out


@pytest.mark.parametrize("deltas", [False, True])
def test_run_seals_what_the_jax_cli_seals(tmp_path, deltas):
    run(seed(tmp_path))
    args = {v: ["run", "--cycles", "2", "--port", "0", "--interval", "0"]
            + [a for spec in copy_fleet(tmp_path, v) for a in
               ("--tenant", spec)] + (["--deltas"] if deltas else [])
            for v in ("port", "jax")}
    assert daemon_cli.main(args["port"] + ["--device", "cpu"]) == 0
    assert jdaemon_cli.main(args["jax"]) == 0
    port = run(reopened(tmp_path, "port"))
    jax = run(reopened(tmp_path, "jax"))
    assert port == jax
    for warm, state, _, snaps in port:
        assert warm, "the drain's checkpoint did not reopen warm"
        assert len(snaps) == 1 and state


@pytest.mark.parametrize("argv", [
    [],
    ["selftest"],
    ["run"],
    ["run", "--tenant", "no-equals-sign"],
    ["run", "--tenant", "=remote"],
    ["run", "--tenant", "l=r", "--device", "tpu"],
    ["run", "--tenant", "l=r", "--device", "meta"],
    ["run", "--tenant", "l=r", "--cycles", "two"],
])
def test_usage_errors_exit_2(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert daemon_cli.main(argv) == 2
    assert not any(tmp_path.iterdir()), "a usage error touched the disk"


def test_cuda_without_a_card_is_a_named_error(tmp_path, monkeypatch, capsys):
    """No silent move to the CPU: without a card, ``--device cuda`` (the
    default) stops before any tenant opens."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = f"{tmp_path / 'l'}={tmp_path / 'r'}"
    for extra in ([], ["--device", "cuda"], ["--device", "cuda:0"]):
        assert daemon_cli.main(["run", "--tenant", spec, "--cycles", "1"]
                               + extra) == 1
        assert "DeviceUnavailableError" in capsys.readouterr().err
    assert not (tmp_path / "r").exists()
    with pytest.raises(daemon_cli.DeviceUnavailableError):
        daemon_cli._accelerator(torch.device("cuda"))


def test_sigterm_drains_a_running_daemon(tmp_path):
    """The process runs until SIGTERM, then drains: exit 0, the drain
    line, and every tenant reopens warm."""
    run(seed(tmp_path))
    specs = copy_fleet(tmp_path, "port")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "crdt_enc_tpu_torch.tools.daemon", "run",
         "--device", "cpu", "--port", "0", "--interval", "0.05"]
        + [a for s in specs for a in ("--tenant", s)],
        cwd=str(tmp_path), env=env, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stderr.readline()
        assert "live telemetry on :" in line, line
        port = int(line.split(":")[1].split()[0])
        deadline = time.monotonic() + 60
        while True:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                        timeout=5) as resp:
                d = json.loads(resp.read())["daemon"]
            if d.get("cycles", 0) >= 2:
                break
            assert time.monotonic() < deadline, "the daemon never cycled"
            time.sleep(0.05)
        assert d["state"] == "running" and d["tenants"] == N_TENANTS
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err
    assert "drained after" in err
    assert all(warm for warm, *_ in run(reopened(tmp_path, "port")))
