"""Fleet daemon entry point: the port's copy of
``crdt_enc_tpu/tools/daemon.py``.

    python -m crdt_enc_tpu_torch.tools.daemon run \\
        --tenant /var/crdt/localA=/mnt/remoteA \\
        --tenant /var/crdt/localB=/mnt/remoteB \\
        [--device cuda] [--port 9464] [--interval 1.0] [--cycles 0] \\
        [--deltas]

    python -m crdt_enc_tpu_torch.tools.daemon selftest \\
        [--device cuda] [--tenants 6] [--cycles 6] [--faulty 2] [--seed 0] \\
        [--mesh dp=N[,mp=M]]

``run`` opens one fs-backed :class:`~crdt_enc_tpu_torch.core.core.Core` per
``--tenant LOCAL=REMOTE`` pair (XChaCha data cryptor, plain key wrap,
OR-Set adapter, ``TorchAccelerator(device, min_device_batch=1)``), admits
them into a :class:`~crdt_enc_tpu_torch.serve.FleetDaemon`, and runs the
supervised loop until SIGTERM/SIGINT, which drains gracefully: the
in-flight cycle finishes, every tenant seals a warm-open checkpoint, the
live endpoint stops.  ``--cycles N`` bounds the loop (smoke runs).
``--port`` serves ``/metrics`` + ``/healthz`` (with the ``daemon``
control-plane section) from the daemon's own live telemetry server.

``selftest`` is the bounded smoke: an in-memory fleet with the
simulator's fault injector armed on some tenants and one tenant whose op
listing fails runs N supervised cycles — tenant errors must be isolated
into backoff/quarantine while healthy tenants keep sealing — then the
faults heal, the fleet recovers, the daemon drains, and every remote
must fsck clean AND refold cold on the host reference byte-identical to
the daemon's live tenant state.  Exit 0 on a clean pass, 1 on any failed
expectation.  ``--mesh dp=N[,mp=M]`` runs the whole smoke through a
mesh-backed service (the sharded tenant folds of ``parallel/mesh.py``):
on ``--device cuda`` over the visible cards, and it exits 2 when ``dp·mp``
exceeds them; on ``--device cpu`` over ``dp·mp`` CPU shards.

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


def device_or_exit(spec: str):
    """``--device`` for a CLI: ``(torch.device, None)``, or ``(None, exit
    code)`` after printing why — 2 for a usage error (not a device, or
    neither cpu nor cuda), 1 with :class:`DeviceUnavailableError` for a
    card this machine lacks."""
    import torch

    try:
        device = torch.device(spec)
    except RuntimeError as e:
        print(f"--device: {e}", file=sys.stderr)
        return None, 2
    if device.type not in ("cpu", "cuda"):
        print(f"--device wants cpu or cuda, got {spec!r}", file=sys.stderr)
        return None, 2
    try:
        _require(device)
    except DeviceUnavailableError as e:
        print(f"DeviceUnavailableError: {e}", file=sys.stderr)
        return None, 1
    return device, None


def _require(device) -> None:
    """Raise :class:`DeviceUnavailableError` where ``device`` (a
    ``torch.device``) is a card this machine lacks."""
    import torch

    if device.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            f"--device {device}: CUDA is not available on this machine "
            "(pass --device cpu to fold with the plain PyTorch versions)"
        )


def _accelerator(device):
    """A tenant's accelerator on ``device`` (a ``torch.device``); raises
    :class:`DeviceUnavailableError` where that device is absent."""
    from ..parallel.accel import TorchAccelerator

    _require(device)
    return TorchAccelerator(device, min_device_batch=1)


def _open_opts(storage, accel, *, create: bool, deltas: bool,
               identity: bool = False):
    from ..backends.identity_crypto import IdentityCryptor
    from ..backends.plain_keys import PlainKeyCryptor
    from ..backends.xchacha import XChaChaCryptor
    from ..core.adapters import orset_adapter
    from ..core.core import OpenOptions
    from ..utils.versions import DEFAULT_DATA_VERSION_1

    return OpenOptions(
        storage=storage,
        cryptor=IdentityCryptor() if identity else XChaChaCryptor(),
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
    device, rc = device_or_exit(args.device)
    if device is None:
        return rc
    accels = [_accelerator(device) for _ in pairs]

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


def _parse_mesh(spec: str | None, device):
    """``dp=N[,mp=M]`` → ``(mesh, None)``, ``(None, None)`` without a
    spec, or ``(None, 2)`` after printing why: a malformed spec, a mesh
    of fewer than two shards (``parse_mesh_spec``, so ``--mesh dp=1`` can
    never smoke the unsharded path while claiming a mesh), or more shards
    than ``device`` offers — the visible cards for ``cuda``; ``cpu``
    takes ``dp·mp`` CPU shards, as the JAX CLI counts the host's virtual
    devices."""
    if not spec:
        return None, None
    import torch

    from ..parallel.mesh import make_mesh, parse_mesh_spec

    try:
        dp, mp = parse_mesh_spec(spec)
    except ValueError as e:
        print(f"--mesh: {e} (got {spec!r})", file=sys.stderr)
        return None, 2
    if device.type == "cpu":
        return make_mesh((dp, mp), devices=[device] * (dp * mp)), None
    found = torch.cuda.device_count()
    if found < dp * mp:
        print(f"--mesh dp={dp},mp={mp} needs {dp * mp} devices, found "
              f"{found} ({torch.cuda.get_device_name(0)}); pass --device "
              "cpu for a mesh of CPU shards", file=sys.stderr)
        return None, 2
    return make_mesh((dp, mp)), None


# ----------------------------------------------------------- selftest
async def _selftest(args) -> int:
    from ..backends.memory import MemoryRemote, MemoryStorage
    from ..backends.plain_keys import PlainKeyCryptor
    from ..core.adapters import HostAccelerator
    from ..core.core import Core
    from ..models import canonical_bytes
    from ..serve import DaemonConfig, FleetDaemon, ServeConfig
    from ..sim import DeterministicCryptor, FaultConfig, FaultyStorage
    from .fsck import fsck_remote

    device, rc = device_or_exit(args.device)
    if device is None:
        return rc
    mesh, rc = _parse_mesh(args.mesh, device)
    if rc is not None:
        return rc

    class _FlakyStorage(MemoryStorage):
        """Deterministic outage: tenant 0's remote refuses listings
        while ``broken`` — the guaranteed-error half of the smoke (the
        seeded FaultyStorage half exercises the survivable damage
        classes, whose tenant-level escalation is probabilistic)."""

        broken = False

        async def list_op_actors(self):
            if self.broken:
                raise OSError("selftest: remote unreachable")
            return await super().list_op_actors()

    T, faulty = args.tenants, min(1 + args.faulty, args.tenants)
    remotes = [MemoryRemote() for _ in range(T)]
    cores = []
    wrappers = []
    flaky = None
    for t, remote in enumerate(remotes):
        writer = await Core.open(_open_opts(
            MemoryStorage(remote), HostAccelerator(), create=True,
            deltas=True, identity=True,
        ))
        for i in range(24):
            m = b"t%d-%d" % (t, i % 11)
            await writer.update(
                lambda s, m=m: s.add_ctx(writer.actor_id, m)
            )
        if t == 0:
            storage = flaky = _FlakyStorage(remote)
        else:
            storage = MemoryStorage(remote)
            if t < faulty:
                storage = FaultyStorage(
                    storage, FaultConfig.all_faults(),
                    seed=args.seed, name=f"t{t}",
                )
                storage.heal()  # open clean; arm once admitted
                wrappers.append(storage)
        cores.append(await Core.open(_open_opts(
            storage, _accelerator(device), create=True, deltas=True,
            identity=True,
        )))

    cfg = DaemonConfig(
        interval_s=0.0, max_idle_cycles=1, quarantine_after=2,
        quarantine_probe_every=3, backoff_base=1.0, backoff_cap=2.0,
        breaker_after=T + 1, serve=ServeConfig(seal_empty=False),
    )
    daemon = FleetDaemon(cores, cfg, seed=args.seed, mesh=mesh)
    for w in wrappers:
        w.arm()
    flaky.broken = True

    failures: list[str] = []
    for _ in range(args.cycles):
        report = await daemon.run_cycle()
        h = daemon.health()
        print(
            f"cycle {report['cycle']}: selected={len(report['selected'])} "
            f"errors={h['last_cycle']['errors']} backoff={h['backoff']} "
            f"quarantined={h['quarantined']}", file=sys.stderr,
        )
    # isolation checks: the flaky tenant must have failed into the
    # backoff/quarantine machine, and every HEALTHY tenant must have
    # kept sealing through the fault phase — tenant failures never
    # poison the cycle
    t0 = daemon.entry("t0")
    if t0.failures == 0 and t0.state == "active":
        failures.append("flaky tenant t0 never entered backoff/quarantine")
    for t in range(faulty, T):
        entry = daemon.entry(f"t{t}")
        if entry is None or entry.last_sealed < 0:
            failures.append(
                f"healthy tenant t{t} never sealed while peers faulted"
            )

    # heal: the transient faults clear, the backoff re-probe path must
    # bring every tenant back to sealing
    flaky.broken = False
    for w in wrappers:
        w.heal()
    for _ in range(max(6, 2 * cfg.quarantine_probe_every)):
        await daemon.run_cycle()
        if all(
            daemon.entry(tid).state == "active"
            and daemon.entry(tid).last_sealed >= 0
            for tid in daemon.tenant_ids
        ):
            break
    else:
        failures.append("fleet did not recover to all-active after heal")

    await daemon.drain()
    if daemon.state != "drained":
        failures.append(f"drain left state {daemon.state!r}")

    # post-drain audit: every remote fscks clean and refolds cold on the
    # host reference to the daemon tenant's live state (the
    # no-divergence oracle)
    for t, (core, remote) in enumerate(zip(cores, remotes)):
        report = await fsck_remote(
            MemoryStorage(remote), DeterministicCryptor(f"selftest{t}"),
            PlainKeyCryptor(), deep=True,
        )
        if not report.ok:
            failures.append(f"tenant {t}: fsck errors: {report.issues[:3]}")
        cold = await Core.open(_open_opts(
            MemoryStorage(remote), HostAccelerator(), create=True,
            deltas=False, identity=True,
        ))
        await cold.read_remote()
        if cold.with_state(canonical_bytes) != core.with_state(
            canonical_bytes
        ):
            failures.append(f"tenant {t}: cold refold diverges from daemon")

    for line in failures:
        print(f"SELFTEST FAIL: {line}", file=sys.stderr)
    if not failures:
        print(
            f"selftest OK: {T} tenants ({faulty} faulted), "
            f"{daemon.cycle} cycles, drained, fsck clean",
            file=sys.stderr,
        )
    return 1 if failures else 0


def _cmd_selftest(args) -> int:
    return asyncio.run(_selftest(args))


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

    p_st = sub.add_parser(
        "selftest", help="bounded in-memory smoke with injected faults"
    )
    p_st.add_argument("--device", default="cuda",
                      help="device the tenants fold on: cuda or cpu")
    p_st.add_argument("--tenants", type=int, default=6)
    p_st.add_argument("--cycles", type=int, default=6)
    p_st.add_argument("--faulty", type=int, default=2,
                      help="tenants wrapped in the all-fault injector")
    p_st.add_argument("--seed", type=int, default=0)
    p_st.add_argument("--mesh", default=None, metavar="dp=N[,mp=M]",
                      help="run the smoke through a mesh-backed service")
    p_st.set_defaults(fn=_cmd_selftest)

    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
