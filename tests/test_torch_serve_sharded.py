"""The mesh-backed fold service and daemon of the port against the JAX
package's, on the conftest's 8 virtual CPU devices and ``[cpu] * dp·mp``
port shards.

Sharding the tenant folds (tenant lanes over ``dp``, member planes over
``mp``) must be an invisible layout change: per tenant, the mesh-backed
``FoldService`` seals what the unsharded port service and the JAX mesh
service seal, over a mixed fleet and two cycles (the second with
device-cut deltas); ``FleetDaemon(mesh=)`` runs cycle for cycle equal to
the JAX mesh daemon; the planner quantizes to the mesh axes as the JAX
planner does; the warm tier belongs to one mesh; and ``tools.daemon
selftest --mesh`` keeps the JAX CLI's rules.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from crdt_enc_tpu.parallel import mesh as jmesh
from crdt_enc_tpu.serve import FleetDaemon as JFleetDaemon
from crdt_enc_tpu.serve import FoldService as JFoldService
from crdt_enc_tpu.serve import ServeConfig as JServeConfig
from crdt_enc_tpu.serve import TenantShape as JTenantShape
from crdt_enc_tpu.serve import plan_buckets as j_plan_buckets
from crdt_enc_tpu.tools import daemon as jdaemon_cli
from crdt_enc_tpu.utils import trace as jtrace

from crdt_enc_tpu_torch.parallel import make_mesh
from crdt_enc_tpu_torch.parallel import mesh as pmesh
from crdt_enc_tpu_torch.serve import (
    FleetDaemon,
    FoldService,
    PlaneWarmTier,
    ServeConfig,
    TenantShape,
    plan_buckets,
)
from crdt_enc_tpu_torch.tools import daemon as daemon_cli
from crdt_enc_tpu_torch.utils import trace

from tests.test_torch_daemon import JAX, PORT, Pair, quick_cfg, twin_fleet
from tests.test_torch_daemon_cli import selftest_lines
from tests.test_torch_mesh import IDS, JITTED, MESHES, jax_mesh, port_mesh
from tests.test_torch_serve import (
    Fleet,
    _break,
    _mixed_fleet,
    _shapes,
    sealed,
    write_orset,
)

CPU = torch.device("cpu")


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def jitted_jax_mesh(monkeypatch):
    """The JAX mesh accelerator's eager shard_map calls, jitted (see
    tests/test_torch_mesh.py)."""
    for name, fn in JITTED.items():
        monkeypatch.setattr(jmesh, name, fn)


# the mixed fleet in three byte-identical copies: the unsharded port
# service's, the port mesh service's and the JAX mesh service's
VARIANTS = ("flat", "mesh", "jax")


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_mesh_service_equals_the_unsharded_and_the_jax_mesh_service(
        tmp_path, dp, mp, monkeypatch):
    """Two cycles over the mixed fleet (ragged OR-Sets, an oversize spill
    folding through the service's mesh accelerator, G- and PN-Counters,
    a G-Set, an LWW map, a member collision, an empty and a failing
    tenant): every tenant's state, snapshot, cursor and delta equal the
    unsharded port service's and the JAX mesh service's, with the same
    paths.  Cycle 2 cuts the OR-Set tenants' deltas on the mesh."""
    monkeypatch.setattr(Fleet, "VARIANTS", VARIANTS)

    async def scenario():
        fleet = await _mixed_fleet(tmp_path)
        flat, mesh_cores, jax = [await fleet.open(v) for v in VARIANTS]
        for cores in (flat, mesh_cores, jax):
            _break(cores[10])
        cfg = dict(rows_cap=64)
        pm = port_mesh(dp, mp)
        fsvc = FoldService(flat, ServeConfig(**cfg))
        msvc = FoldService(mesh_cores, ServeConfig(**cfg), mesh=pm)
        jsvc = JFoldService(jax, JServeConfig(**cfg), mesh=jax_mesh(dp, mp))
        assert msvc.warm.mesh_key is pm and msvc._mesh_accel.mesh is pm
        for cycle in range(2):
            if cycle:
                for t in (1, 2, 3, 4):
                    await write_orset(fleet.writers[t], 9, b"tail%d" % t,
                                      rm_every=4)
                fleet.sync_tails()
            fres = await fsvc.run_cycle()
            trace.reset()
            jtrace.reset()
            mres = await msvc.run_cycle()
            jres = await jsvc.run_cycle()
            for attr in ("path", "rows", "sealed"):
                assert [getattr(r, attr) for r in mres] == \
                    [getattr(r, attr) for r in fres] == \
                    [getattr(r, attr) for r in jres]
            snap = trace.snapshot()
            jsnap = jtrace.snapshot()
            for name in ("serve_sharded_folds", "serve_sharded_tenants"):
                assert snap["counters"][name] == jsnap["counters"][name] > 0
            assert "serve.shard" in snap["spans"]
            assert snap["gauges"].get("serve_mesh_devices", dp * mp) == dp * mp
            if cycle:
                assert snap["counters"]["delta_device_cuts"] == 3
            for t in range(len(flat)):
                if t == 10:
                    continue
                f, m, j = [await sealed(c[t])
                           for c in (flat, mesh_cores, jax)]
                assert m == f, f"tenant {t}: mesh service != unsharded"
                assert m == j, f"tenant {t}: mesh service != JAX mesh"

    run(scenario())


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_mesh_daemon_cycles_equal_the_jax_mesh_daemon(dp, mp):
    """``FleetDaemon(mesh=)`` against the JAX daemon on its mesh, in
    lockstep: each cycle's report, the entries, the health and the
    tenants' bytes, through a flaky tenant's backoff and recovery and a
    late tail; then both drain alike."""

    async def scenario():
        tw, fleet = await twin_fleet(
            [(15, b"bad"), (20, b"a"), (9, b"b"), (0, b"q")],
            flaky_tenants={0})
        pair = Pair.__new__(Pair)
        pair.fleet = fleet
        pm = port_mesh(dp, mp)
        pair.d = {
            side.name: side.Daemon(
                [c for c, _ in fleet[side.name]],
                quick_cfg(side, quarantine_after=3,
                          quarantine_probe_every=1),
                mesh=pm if side is PORT else jax_mesh(dp, mp))
            for side in (PORT, JAX)
        }
        assert isinstance(pair.port, FleetDaemon)
        assert isinstance(pair.jax, JFleetDaemon)
        assert pair.port.service.mesh is pm
        pair.set_broken(0, True)
        await pair.cycle()
        await pair.cycle()
        pair.set_broken(0, False)
        await tw.write(1, b"late")
        for _ in range(4):
            await pair.cycle()
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_plan_buckets_on_a_mesh_matches_jax(seed, dp, mp):
    shapes = _shapes(seed)
    kw = dict(dp=dp, mp=mp, rows_cap=1024, tenants_cap=5)
    mine, mine_solo = plan_buckets([TenantShape(*s) for s in shapes], **kw)
    theirs, theirs_solo = j_plan_buckets([JTenantShape(*s) for s in shapes],
                                         **kw)
    assert mine_solo == theirs_solo
    assert [(b.kind, b.rows, b.members, b.replicas, b.tenants, b.slots)
            for b in mine] == [(b.kind, b.rows, b.members, b.replicas,
                                b.tenants, b.slots) for b in theirs]
    assert all(b.slots % dp == 0 for b in mine)
    assert all(b.members % mp == 0 for b in mine if b.kind == "orset")


def test_the_warm_tier_belongs_to_one_mesh(monkeypatch):
    """The service's tier is keyed to its mesh by identity; a tier made
    for another mesh (two meshes over the same devices included) is
    refused where the service consumes it."""
    pm = port_mesh(4, 2)
    svc = FoldService([], mesh=pm)
    assert svc.warm.compatible_with(pm)
    assert not svc.warm.compatible_with(port_mesh(4, 2))
    flat = FoldService([])
    assert flat.warm.mesh_key is None and flat._mesh_accel is None

    foreign = PlaneWarmTier(mesh_key=port_mesh(4, 2))
    monkeypatch.setattr("crdt_enc_tpu_torch.serve.service.PlaneWarmTier",
                        lambda *a, **kw: foreign)
    with pytest.raises(ValueError, match="different mesh identity"):
        FoldService([], mesh=pm)


def test_the_service_refuses_a_mesh_that_spans_processes():
    mesh = pmesh.Mesh([[CPU, CPU]], processes=2, rank=0, group=object())
    with pytest.raises(ValueError, match="spans processes"):
        FoldService([], mesh=mesh)


def test_a_size_one_mesh_serves_unsharded():
    svc = FoldService([], mesh=make_mesh((1, 1), devices=[CPU]))
    assert not svc._mesh_active and svc._mesh_accel is None


# ---- tools.daemon selftest --mesh ----------------------------------------------


@pytest.mark.parametrize("spec", ["dp=2,mp=2", "dp=8"])
def test_selftest_on_a_cpu_mesh_matches_the_jax_mesh_selftest(capsys, spec):
    """``selftest --mesh SPEC --device cpu``: exit 0, fsck clean, and per
    cycle the JAX mesh selftest's selections, errors, backoffs and
    quarantines."""
    assert daemon_cli.main(["selftest", "--device", "cpu", "--mesh",
                            spec]) == 0
    port = selftest_lines(capsys.readouterr().err)
    assert jdaemon_cli.main(["selftest", "--mesh", spec]) == 0
    assert port == selftest_lines(capsys.readouterr().err)
    assert port[-1].startswith("selftest OK")


def exit_code(main, argv) -> int:
    """A CLI's exit code, returned or raised (the JAX CLI raises its
    ``--mesh`` usage errors as ``SystemExit``)."""
    try:
        return main(argv)
    except SystemExit as e:
        return int(e.code)


@pytest.mark.parametrize("spec", ["dp=1", "mp=1", "dp=2,xp=2", "dp=0,mp=4"])
def test_selftest_mesh_usage_errors_exit_2(capsys, spec):
    for main, extra in ((daemon_cli.main, ["--device", "cpu"]),
                        (jdaemon_cli.main, [])):
        assert exit_code(main, ["selftest", "--mesh", spec] + extra) == 2
        assert capsys.readouterr().err.startswith("--mesh")


def test_selftest_mesh_on_cuda_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert daemon_cli.main(["selftest", "--device", "cuda", "--mesh",
                            "dp=2"]) == 1
    assert capsys.readouterr().err.startswith(
        "DeviceUnavailableError: --device cuda")


def test_selftest_mesh_past_the_visible_cards_exits_2(monkeypatch, capsys):
    """One card: ``--mesh dp=2 --device cuda`` exits 2 and names what it
    found, as the JAX CLI does on a one-chip host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *_: "NVIDIA H100 80GB HBM3")
    assert daemon_cli.main(["selftest", "--device", "cuda", "--mesh",
                            "dp=2"]) == 2
    err = capsys.readouterr().err
    assert "needs 2 devices, found 1" in err and "H100" in err
