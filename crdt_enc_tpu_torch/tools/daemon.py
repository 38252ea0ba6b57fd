"""Fleet daemon entry point: the port's copy of the ``run`` subcommand of
``crdt_enc_tpu/tools/daemon.py``.

    python -m crdt_enc_tpu_torch.tools.daemon run \\
        --tenant /var/crdt/localA=/mnt/remoteA \\
        --tenant /var/crdt/localB=/mnt/remoteB \\
        [--device cuda] [--port 9464] [--interval 1.0] [--cycles 0] \\
        [--deltas]

``run`` opens one fs-backed :class:`~crdt_enc_tpu_torch.core.core.Core` per
``--tenant LOCAL=REMOTE`` pair (XChaCha data cryptor, plain key wrap,
OR-Set adapter, ``TorchAccelerator(device, min_device_batch=1)``), admits
them into a :class:`~crdt_enc_tpu_torch.serve.FleetDaemon`, and runs the
supervised loop until SIGTERM/SIGINT, which drains gracefully: the
in-flight cycle finishes, every tenant seals a warm-open checkpoint, the
live endpoint stops.  ``--cycles N`` bounds the loop (smoke runs).
``--port`` serves ``/metrics`` + ``/healthz`` (with the ``daemon``
control-plane section) from the daemon's own live telemetry server.

``--device`` names the device every tenant folds on: ``cuda`` (the
default, the card) or ``cpu`` (the plain PyTorch versions of the
kernels).  Without a card, ``--device cuda`` stops with
:class:`DeviceUnavailableError`; the daemon never moves to the CPU on its
own.

Exit codes: 0 clean, 1 failed expectation / fatal error (no device
included), 2 usage.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

logger = logging.getLogger("crdt_enc_tpu_torch.tools.daemon")


class DeviceUnavailableError(RuntimeError):
    """``--device`` names a device this machine does not have."""


def _accelerator(device):
    """A tenant's accelerator on ``device`` (a ``torch.device``); raises
    :class:`DeviceUnavailableError` where that device is absent."""
    import torch

    from ..parallel.accel import TorchAccelerator

    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"--device {device}: CUDA is not available on this machine "
            "(pass --device cpu to fold with the plain PyTorch versions)"
        )
    return TorchAccelerator(device, min_device_batch=1)


def _open_opts(storage, accel, *, create: bool, deltas: bool):
    from ..backends.plain_keys import PlainKeyCryptor
    from ..backends.xchacha import XChaChaCryptor
    from ..core.adapters import orset_adapter
    from ..core.core import OpenOptions
    from ..utils.versions import DEFAULT_DATA_VERSION_1

    return OpenOptions(
        storage=storage,
        cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        accelerator=accel,
        delta=deltas,
    )


# ---------------------------------------------------------------- run
async def _run(args) -> int:
    import torch

    from ..backends.fs import FsStorage
    from ..core.core import Core
    from ..serve import DaemonConfig, FleetDaemon

    pairs = []
    for spec in args.tenant:
        local, sep, remote = spec.partition("=")
        if not sep or not local or not remote:
            print(f"--tenant wants LOCAL=REMOTE, got {spec!r}",
                  file=sys.stderr)
            return 2
        pairs.append((local, remote))
    if not pairs:
        print("run: at least one --tenant LOCAL=REMOTE required",
              file=sys.stderr)
        return 2
    try:
        device = torch.device(args.device)
    except RuntimeError as e:
        print(f"--device: {e}", file=sys.stderr)
        return 2
    if device.type not in ("cpu", "cuda"):
        print(f"--device wants cpu or cuda, got {args.device!r}",
              file=sys.stderr)
        return 2
    try:
        accels = [_accelerator(device) for _ in pairs]
    except DeviceUnavailableError as e:
        print(f"DeviceUnavailableError: {e}", file=sys.stderr)
        return 1

    cores = [
        await Core.open(_open_opts(
            FsStorage(local, remote), accel, create=True, deltas=args.deltas,
        ))
        for (local, remote), accel in zip(pairs, accels)
    ]
    cfg = DaemonConfig(interval_s=args.interval)
    daemon = FleetDaemon(cores, cfg, live_port=args.port)
    if daemon.service.live is not None:
        print(f"live telemetry on :{daemon.service.live.port} "
              "(/metrics /healthz /snapshot)", file=sys.stderr)

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, daemon.request_drain)
        except (NotImplementedError, RuntimeError):
            pass  # non-unix, or not the main thread
    await daemon.run_forever(max_cycles=args.cycles)
    h = daemon.health()
    print(
        f"drained after {h['cycles']} cycle(s): {h['tenants']} tenant(s), "
        f"{h['quarantined']} quarantined, degraded={h['degraded']}",
        file=sys.stderr,
    )
    return 0


def _cmd_run(args) -> int:
    return asyncio.run(_run(args))


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    ap = argparse.ArgumentParser(
        prog="python -m crdt_enc_tpu_torch.tools.daemon",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="run a fleet daemon over fs remotes")
    p_run.add_argument(
        "--tenant", action="append", default=[], metavar="LOCAL=REMOTE",
        help="one tenant's local dir + remote dir (repeatable)",
    )
    p_run.add_argument("--device", default="cuda",
                       help="device the tenants fold on: cuda or cpu")
    p_run.add_argument("--port", type=int, default=None,
                       help="live telemetry port (0 = ephemeral)")
    p_run.add_argument("--interval", type=float, default=1.0,
                       help="seconds between supervised cycles")
    p_run.add_argument("--cycles", type=int, default=0,
                       help="stop after N cycles (0 = run until SIGTERM)")
    p_run.add_argument("--deltas", action="store_true",
                       help="delta-state replication on every tenant")
    p_run.set_defaults(fn=_cmd_run)

    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
