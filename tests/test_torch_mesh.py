"""The port's in-process mesh (``crdt_enc_tpu_torch/parallel/mesh.py``)
against the JAX package's ``shard_map`` programs.

The JAX side runs on the conftest's 8 virtual CPU devices, the port on
``[cpu] * dp·mp`` shards, the same numpy inputs through both, over the
meshes (8, 1), (4, 2), (2, 4) and (1, 8); every result must be exactly
equal.  Covered: each ``*_sharded`` function (the OR-Set fold with both
per-shard kernels, also against the JAX Pallas route in interpret mode;
the merge; the tenant folds and plane diff; the counters; LWW; the map's
scatter phase; MVReg), ``TorchAccelerator(mesh=)`` through ``Core``
(fold, merge, counters, LWW, map, MVReg), the sharded fold session, and
``SimRunner(mesh=)`` / ``PopulationSubstrate(mesh=)``.  One test per
trap of the rewrite: the clock sees every row, partial folds never
retire, padding, empty vocabularies, int32, the PN value, the warm
tier's identity, and a size-1 mesh is never a mesh.
"""

from __future__ import annotations

import asyncio
import random
import uuid

import jax
import numpy as np
import pytest
import torch

import crdt_enc_tpu.models as J
import crdt_enc_tpu.sim as jsim
from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import canonical_bytes as jcb
from crdt_enc_tpu.ops.map_device import _pad_rows
from crdt_enc_tpu.parallel import TpuAccelerator
from crdt_enc_tpu.parallel import mesh as jmesh
from crdt_enc_tpu.parallel import session as JS
from crdt_enc_tpu.utils import codec as jcodec

import crdt_enc_tpu_torch.models as P
import crdt_enc_tpu_torch.sim as psim
from crdt_enc_tpu_torch import (
    Core,
    IdentityCryptor,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    PlainKeyCryptor,
    canonical_bytes,
)
from crdt_enc_tpu_torch.core import adapters as padapters
from crdt_enc_tpu_torch.core.adapters import HostAccelerator
from crdt_enc_tpu_torch.ops import orset as O
from crdt_enc_tpu_torch.ops.orset_fold_cuda import orset_scatter
from crdt_enc_tpu_torch.parallel import distributed, make_mesh
from crdt_enc_tpu_torch.parallel import mesh as pmesh
from crdt_enc_tpu_torch.parallel import session as S
from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
from crdt_enc_tpu_torch.serve import PlaneWarmTier
from crdt_enc_tpu_torch.utils import codec as pcodec
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

from tests.test_torch_catalogue import ACTORS as MAP_ACTORS
from tests.test_torch_catalogue import map_history, map_script_from
from tests.test_torch_catalogue import mvreg_snapshots
from tests.test_torch_map_columnar import payloads_from_streams, scatter_inputs

CPU = torch.device("cpu")
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]

# The JAX package calls its shard_map programs eagerly, which compiles
# every primitive of a body on its own.  The tests install jitted twins of
# the same functions (the mesh static), built once per module so their
# compiles are shared across cases; what they compute is unchanged.
JITTED = {
    "orset_fold_sharded": jax.jit(
        jmesh.orset_fold_sharded, static_argnums=0,
        static_argnames=("impl", "tile_cap", "interpret", "retire_rm")),
    "orset_merge_sharded": jax.jit(jmesh.orset_merge_sharded,
                                   static_argnums=0),
    "pncounter_fold_sharded": jax.jit(jmesh.pncounter_fold_sharded,
                                      static_argnums=0),
    "lww_fold_sharded": jax.jit(jmesh.lww_fold_sharded, static_argnums=0,
                                static_argnames=("num_keys",)),
    "mvreg_keep_sharded": jax.jit(jmesh.mvreg_keep_sharded,
                                  static_argnums=0),
    "crdtmap_scatter_sharded": jax.jit(
        jmesh.crdtmap_scatter_sharded, static_argnums=0,
        static_argnames=("num_groups",)),
}


@pytest.fixture(autouse=True)
def jitted_jax_mesh(monkeypatch):
    for name, fn in JITTED.items():
        monkeypatch.setattr(jmesh, name, fn)


IDS = [f"dp{dp}mp{mp}" for dp, mp in MESHES]
ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(6)]


def run(coro):
    return asyncio.run(coro)


def port_mesh(dp, mp):
    return make_mesh((dp, mp), devices=[CPU] * (dp * mp))


def jax_mesh(dp, mp):
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jmesh.make_mesh((dp, mp))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def equal(got, ref):
    """Port tensors (or a tuple) against JAX arrays, exactly."""
    if isinstance(got, tuple):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            equal(g, r)
        return
    r = np.asarray(ref)
    g = got.numpy()
    assert g.shape == r.shape, (g.shape, r.shape)
    assert np.array_equal(g.astype(np.int64), r.astype(np.int64))


def fold_inputs(seed, E=16, R=6, N=203, dp=1):
    """A prior state's planes (not normalized) and op rows with sentinel
    rows, the rows padded to a dp multiple."""
    rng = np.random.default_rng(seed)
    n = -(-N // dp) * dp
    kind = (rng.random(n) < 0.3).astype(np.int8)
    member = rng.integers(0, E, n).astype(np.int32)
    actor = rng.integers(0, R + 1, n).astype(np.int32)
    counter = rng.integers(1, 50, n).astype(np.int32)
    actor[N:] = R
    clock0 = rng.integers(0, 20, R).astype(np.int32)
    add0 = (rng.integers(0, 40, (E, R)) * (rng.random((E, R)) < .4)).astype(
        np.int32)
    rm0 = (rng.integers(0, 40, (E, R)) * (rng.random((E, R)) < .3)).astype(
        np.int32)
    return clock0, add0, rm0, kind, member, actor, counter


# ---- the sharded functions against the shard_map programs -------------------


@pytest.mark.parametrize("impl", ["scatter", "fold"])
@pytest.mark.parametrize("retire_rm", [True, False])
@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_orset_fold_sharded_matches_jax(dp, mp, retire_rm, impl):
    args = fold_inputs(dp * 10 + mp, dp=dp)
    ref = jmesh.orset_fold_sharded(jax_mesh(dp, mp), *args,
                                   retire_rm=retire_rm)
    got = pmesh.orset_fold_sharded(port_mesh(dp, mp), *args,
                                   retire_rm=retire_rm, impl=impl)
    equal(got, ref)
    whole = O.orset_fold(*map(t, args), num_members=16, num_replicas=6,
                         retire_rm=retire_rm)
    assert all(torch.equal(g, w) for g, w in zip(got, whole))


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_orset_fold_sharded_matches_the_jax_pallas_route(dp, mp):
    """The JAX route whose shards scatter through the Pallas kernel
    (interpret mode), as tests/test_parallel.py runs it."""
    args = fold_inputs(7 + dp, E=16, R=6, N=120, dp=dp)
    cap = jmesh.sharded_fold_cap(args[4], 16, dp, mp)
    ref = jmesh.orset_fold_sharded(jax_mesh(dp, mp), *args, impl="pallas",
                                   tile_cap=cap, interpret=True)
    equal(pmesh.orset_fold_sharded(port_mesh(dp, mp), *args), ref)


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_orset_merge_sharded_matches_jax(dp, mp):
    a = fold_inputs(1, dp=dp)[:3]
    b = fold_inputs(2, dp=dp)[:3]
    ref = jmesh.orset_merge_sharded(jax_mesh(dp, mp), *a, *b)
    equal(pmesh.orset_merge_sharded(port_mesh(dp, mp), *a, *b), ref)


def tenant_inputs(seed, T=16, E=8, R=4, N=24):
    rng = np.random.default_rng(seed)
    clock0 = rng.integers(0, 5, (T, R)).astype(np.int32)
    add0 = np.where(rng.random((T, E, R)) < 0.3,
                    rng.integers(1, 9, (T, E, R)), 0).astype(np.int32)
    rm0 = np.where(rng.random((T, E, R)) < 0.2,
                   rng.integers(1, 9, (T, E, R)), 0).astype(np.int32)
    kind = rng.integers(0, 2, (T, N)).astype(np.int8)
    member = rng.integers(0, E, (T, N)).astype(np.int32)
    actor = rng.integers(0, R + 1, (T, N)).astype(np.int32)
    counter = rng.integers(1, 12, (T, N)).astype(np.int32)
    actor[-2:] = R  # dummy all-sentinel lanes
    return clock0, add0, rm0, kind, member, actor, counter


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_tenant_folds_and_diff_sharded_match_jax(dp, mp):
    jm, pm = jax_mesh(dp, mp), port_mesh(dp, mp)
    args = tenant_inputs(dp * 3 + mp)
    orset_step, gcounter_step = jmesh.tenant_fold_steps(jm)
    ref = orset_step(*args)
    got = pmesh.orset_fold_tenants_sharded(pm, *args)
    equal(got, ref)
    # the plane diff over the layout the fold left
    jcode, jcount = jmesh.tenant_diff_step(jm)(*args[:3], *ref)
    code, count = pmesh.tenant_plane_diff_sharded(pm, *args[:3], *got)
    equal(code, jcode)
    equal(count, jcount)
    # G-Counter tenants
    clock0, _, _, _, _, actor, counter = args
    equal(pmesh.gcounter_fold_tenants_sharded(pm, clock0, actor, counter),
          gcounter_step(clock0, actor, counter))


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_counters_sharded_match_jax(dp, mp):
    rng = np.random.default_rng(dp)
    R, N = 24, 256
    actor = rng.integers(0, R + 1, N).astype(np.int32)  # with sentinels
    sign = (rng.random(N) < 0.4).astype(np.int8)
    counter = rng.integers(1, 30, N).astype(np.int32)
    p0 = rng.integers(0, 5, R).astype(np.int32)
    n0 = rng.integers(0, 5, R).astype(np.int32)
    jm, pm = jax_mesh(dp, mp), port_mesh(dp, mp)
    ref = jmesh.pncounter_fold_sharded(jm, p0, n0, sign, actor, counter)
    got = pmesh.pncounter_fold_sharded(pm, p0, n0, sign, actor, counter)
    equal(got, ref)
    equal(pmesh.gcounter_fold_sharded(pm, p0, actor, counter),
          jmesh.gcounter_fold_sharded(jm, p0, actor, counter))


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_lww_fold_sharded_matches_jax(dp, mp):
    rng = np.random.default_rng(9 + dp)
    Kk, N = 40, 512
    key = rng.integers(0, Kk + 1, N).astype(np.int32)  # with sentinels
    hi = rng.integers(0, 4, N).astype(np.int32)
    lo = rng.integers(0, 100, N).astype(np.int32)
    actor = rng.integers(0, 16, N).astype(np.int32)
    value = rng.integers(0, 50, N).astype(np.int32)
    cols = (key, hi, lo, actor, value)
    ref = jmesh.lww_fold_sharded(jax_mesh(dp, mp), *cols, num_keys=Kk)
    equal(pmesh.lww_fold_sharded(port_mesh(dp, mp), *cols, num_keys=Kk), ref)


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_mvreg_keep_sharded_matches_jax(dp, mp):
    rng = np.random.default_rng(dp + mp)
    V, R = 40, 5
    clocks = rng.integers(0, 4, (V, R)).astype(np.int32)
    valid = rng.random(V) < 0.9
    ref = jmesh.mvreg_keep_sharded(jax_mesh(dp, mp), clocks, valid)
    equal(pmesh.mvreg_keep_sharded(port_mesh(dp, mp), clocks, valid), ref)


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_crdtmap_scatter_sharded_matches_jax(dp, mp):
    args, static = scatter_inputs(dp * 7 + mp)
    planes, rows = args[:6], list(args[6:])
    R = static["num_replicas"]
    fams, fills = [], []
    for lo, hi, fill in ((0, 3, (0, R, 0)), (3, 7, (0, R, 0, 0)),
                         (7, 11, (0, 0, R, 0)), (11, 16, (0, R, 0, R, 0))):
        fam = rows[lo:hi]
        n = -(-len(fam[0]) // dp) * dp
        fams.append(_pad_rows(fam, n, fill))
    ref = jmesh.crdtmap_scatter_sharded(jax_mesh(dp, mp), *planes, *fams,
                                        num_groups=static["num_groups"])
    got = pmesh.crdtmap_scatter_sharded(
        port_mesh(dp, mp), *(np.asarray(p, np.int64) for p in planes),
        *[[np.asarray(c, np.int64) for c in f] for f in fams],
        num_groups=static["num_groups"])
    equal(got, ref)


@pytest.mark.parametrize("fn", ["fold", "tenants", "diff", "lww", "mvreg"])
def test_undivisible_inputs_raise_pad_first(fn):
    pm = port_mesh(4, 2)
    z = np.zeros
    with pytest.raises(ValueError, match="pad first|multiple"):
        if fn == "fold":
            pmesh.orset_fold_sharded(pm, z(3, np.int32), z((9, 3), np.int32),
                                     z((9, 3), np.int32), z(8, np.int8),
                                     *(z(8, np.int32),) * 3)
        elif fn == "tenants":
            pmesh.orset_fold_tenants_sharded(
                pm, z((6, 3), np.int32), *(z((6, 8, 3), np.int32),) * 2,
                z((6, 4), np.int8), *(z((6, 4), np.int32),) * 3)
        elif fn == "diff":
            c, p = z((8, 3), np.int32), z((8, 5, 3), np.int32)
            pmesh.tenant_plane_diff_sharded(pm, c, p, p, c, p, p)
        elif fn == "lww":
            pmesh.lww_fold_sharded(pm, *(z(6, np.int32),) * 5, num_keys=2)
        else:
            pmesh.mvreg_keep_sharded(pm, z((6, 2), np.int32), z(6, bool))


# ---- the mesh layer's own contract -------------------------------------------


def test_parse_mesh_spec_matches_jax():
    for spec in ("dp=8", "dp=4,mp=2", "mp=8", "dp=2,mp=4"):
        assert pmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    for bad in ("dp=1", "mp=1", "dp=0,mp=4", "xp=2", "dp=-2,mp=-2"):
        with pytest.raises(ValueError):
            jmesh.parse_mesh_spec(bad)
        with pytest.raises(ValueError):
            pmesh.parse_mesh_spec(bad)


def test_make_mesh_takes_the_cards_and_never_the_cpu_silently(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.make_multihost_mesh()
    m = port_mesh(4, 2)
    assert m.shape == {"dp": 4, "mp": 2} and m.size == 8
    assert m.home == CPU and not m.spans_processes
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((4, 2), devices=[CPU] * 7)


@pytest.mark.parametrize("n_lanes", [1, 3, 4, 8, 32])
def test_mesh_for_population_matches_jax(n_lanes):
    got = pmesh.mesh_for_population(n_lanes, devices=[CPU] * 8)
    ref = jmesh.mesh_for_population(n_lanes)
    assert got.shape == dict(ref.shape)
    assert pmesh.mesh_for_population(n_lanes, devices=[CPU]) is None


def test_a_size_one_mesh_is_never_a_mesh():
    one = make_mesh((1, 1), devices=[CPU])
    accel = TorchAccelerator(min_device_batch=1, mesh=one)
    assert not accel._mesh_active() and not accel.sharded_stream
    assert TorchAccelerator(min_device_batch=1, mesh=port_mesh(2, 1)
                            ).sharded_stream
    with pytest.raises(ValueError, match="not the mesh's home"):
        TorchAccelerator("cuda", mesh=port_mesh(2, 1))


def test_warm_tier_mesh_identity_is_identity():
    a, b = port_mesh(4, 2), port_mesh(4, 2)  # same devices, two meshes
    tier = PlaneWarmTier(mesh_key=a)
    assert tier.compatible_with(a)
    assert not tier.compatible_with(b)
    assert not tier.compatible_with(None)
    assert PlaneWarmTier().compatible_with(None)


def test_tenant_layout_of_a_service_view_is_contiguous():
    """The service hands the sharded tenant fold ``(T, E, R)`` views of
    its ``(E, T·R)`` layout; a dp shard's slice of such a view must
    reach the fold kernel as a contiguous layout (the kernel refuses a
    strided one, the plain version would not notice)."""
    E, T, R = 8, 4, 3
    layout = torch.arange(E * T * R, dtype=torch.int32).view(E, T * R)
    view = O.tenant_planes(layout, T)
    for ts in (slice(0, 2), slice(2, 4), slice(0, 4)):
        got = pmesh.tenant_layout(view[ts])
        assert got.is_contiguous()
        assert torch.equal(got, view[ts].permute(1, 0, 2).reshape(E, -1))


# ---- the traps ---------------------------------------------------------------


def test_trap_the_clock_sees_every_row_the_planes_their_slice():
    """An actor whose only add lands in member slice 1: its clock entry
    must reach the fold's clock (and retire its horizon in slice 0),
    though the K1/K2 launch of slice 0 sees that row as padding."""
    E, R = 8, 2
    kind = np.array([0, 1, 0, 0], np.int8)
    member = np.array([6, 1, 2, 0], np.int32)  # slice 1 holds member 6
    actor = np.array([1, 1, 0, 2], np.int32)  # row 3 pads
    counter = np.array([5, 3, 1, 0], np.int32)
    planes = (np.zeros(R, np.int32), np.zeros((E, R), np.int32),
              np.zeros((E, R), np.int32))
    args = (*planes, kind, member, actor, counter)
    pm = port_mesh(1, 2)
    whole = O.orset_fold(*map(t, args), num_members=E, num_replicas=R)
    for impl in ("scatter", "fold"):
        got = pmesh.orset_fold_sharded(pm, *args, impl=impl)
        assert all(torch.equal(g, w) for g, w in zip(got, whole))
    assert int(whole[0][1]) == 5 and int(whole[2][1, 1]) == 0
    # a kernel clock over slice 0 alone would have missed actor 1's add
    lo_member, lo_actor = pmesh._slice_rows(t(member), t(actor), 0, 4, R)
    clock = torch.zeros(R, dtype=torch.int32)
    orset_scatter(t(kind), lo_member, lo_actor, t(counter), num_members=4,
                  num_replicas=R, clock=clock)
    assert int(clock[1]) == 0
    # the same for the tenant fold, whose rows replicate over mp
    T = 2
    targs = (np.zeros((T, R), np.int32), np.zeros((T, E, R), np.int32),
             np.zeros((T, E, R), np.int32), np.stack([kind] * T),
             np.stack([member] * T), np.stack([actor] * T),
             np.stack([counter] * T))
    ref = jmesh.tenant_fold_steps(jax_mesh(2, 2))[0](*targs)
    equal(pmesh.orset_fold_tenants_sharded(port_mesh(2, 2), *targs), ref)


def test_trap_partial_folds_never_retire():
    """The streaming step keeps horizons at or below the clock; the
    session's finish retires once against the merged clock."""
    args = fold_inputs(3, dp=4)
    pm = port_mesh(4, 2)
    clock, add, rm = pmesh.sharded_stream_fold_step(pm)(*map(t, args))
    ref = O.orset_fold(*map(t, args), num_members=16, num_replicas=6,
                       retire_rm=False)
    assert all(torch.equal(g, w) for g, w in zip((clock, add, rm), ref))
    assert bool(((rm > 0) & (rm <= clock[None, :])).any())
    assert torch.equal(O.orset_retire(clock, rm),
                       O.orset_fold(*map(t, args), num_members=16,
                                    num_replicas=6)[2])


# ---- the accelerator through Core --------------------------------------------


def popts(remote, accel=None, adapter=None):
    return OpenOptions(
        storage=MemoryStorage(remote), cryptor=IdentityCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=adapter or padapters.orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel or HostAccelerator(),
    )


def jopts(remote, accel=None, adapter=None):
    return JOpenOptions(
        storage=JMemoryStorage(remote), cryptor=JIdentityCryptor(),
        key_cryptor=JPlainKeyCryptor(),
        adapter=adapter or jadapters.orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        **({"accelerator": accel} if accel else {}),
    )


def add_many(core, members):
    def build(s):
        ops = []
        for m in members:
            op = s.add_ctx(core.actor_id, m)
            s.apply(op)
            ops.append(op)
        return ops

    return build


async def mesh_lifecycle(pkg, dp, mp):
    """tests/test_parallel.py's mesh lifecycle in either package: a
    writer compacts through the mesh, a second writer adds a tail, a
    mesh reader folds snapshot + tail, compacts, and a fresh host reader
    reads it back.  Returns the canonical bytes at each step."""
    if pkg == "jax":
        remote, opts, open_ = JMemoryRemote(), jopts, JCore.open
        maccel = TpuAccelerator(min_device_batch=1, mesh=jax_mesh(dp, mp))
        cb = jcb
    else:
        remote, opts, open_ = MemoryRemote(), popts, Core.open
        maccel = TorchAccelerator(min_device_batch=1, mesh=port_mesh(dp, mp))
        cb = canonical_bytes
    producer = await open_(opts(remote, maccel))
    await producer.update(add_many(producer, [m % 17 for m in range(40)]))
    await producer.update(lambda s: [s.rm_ctx(m) for m in (2, 7, 11)])
    await producer.compact()
    writer2 = await open_(opts(remote, maccel))
    await writer2.update(add_many(writer2, [100 + m for m in range(9)]))
    host = await open_(opts(remote))
    mesh_core = await open_(opts(remote, maccel))
    await host.read_remote()
    await mesh_core.read_remote()
    out = [mesh_core.with_state(cb), host.with_state(cb)]
    await mesh_core.compact()
    fresh = await open_(opts(remote))
    await fresh.read_remote()
    out.append(fresh.with_state(cb))
    return out


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_mesh_core_lifecycle_matches_the_jax_mesh_core(dp, mp):
    got = run(mesh_lifecycle("port", dp, mp))
    assert got[0] == got[1] == got[2]
    # the actors differ between the two runs (random ids), so the JAX
    # run is held to its own host reader, and the port's state to the
    # JAX state shape by member set and entry count
    ref = run(mesh_lifecycle("jax", dp, mp))
    assert ref[0] == ref[1] == ref[2]
    pst = P.ORSet.from_obj(pcodec.unpack(got[0]))
    jst = J.ORSet.from_obj(jcodec.unpack(ref[0]))
    assert sorted(pst.entries) == sorted(jst.entries)


def history(n_ops, n_members, seed=0, rm_every=7):
    rng = np.random.default_rng(seed)
    state, ops = P.ORSet(), []
    for i in range(n_ops):
        a = ACTORS[int(rng.integers(len(ACTORS)))]
        m = int(rng.integers(n_members))
        if i % rm_every == rm_every - 1 and state.contains(m):
            op = state.rm_ctx(m)
        else:
            op = state.add_ctx(a, m)
        state.apply(op)
        ops.append(op)
    return state, ops


def jops(ops):
    return [J.orset.op_from_obj(jcodec.unpack(pcodec.pack(o.to_obj())))
            for o in ops]


@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_accel_fold_and_merge_match_the_jax_mesh_accel(dp, mp):
    """fold_ops with E = 17 members (padded to mp) and merge_states of
    two snapshots (pairwise, sharded) against the JAX mesh accelerator
    and the host loop."""
    host, ops = history(300, 17, seed=dp + mp)
    pacc = TorchAccelerator(min_device_batch=1, mesh=port_mesh(dp, mp))
    jacc = TpuAccelerator(min_device_batch=1, mesh=jax_mesh(dp, mp))
    got = pacc.fold_ops(P.ORSet(), ops)
    ref = jacc.fold_ops(J.ORSet(), jops(ops))
    assert canonical_bytes(got) == canonical_bytes(host) == jcb(ref)
    a, ops_a = history(120, 9, seed=1)
    b, ops_b = history(90, 13, seed=2)
    pm = pacc.merge_states(P.ORSet.from_obj(a.to_obj()), [b])
    jm = jacc.merge_states(J.ORSet.from_obj(jcodec.unpack(pcodec.pack(
        a.to_obj()))), [J.ORSet.from_obj(jcodec.unpack(pcodec.pack(
            b.to_obj())))])
    hm = HostAccelerator().merge_states(P.ORSet.from_obj(a.to_obj()), [b])
    assert canonical_bytes(pm) == canonical_bytes(hm) == jcb(jm)


def test_trap_empty_vocabulary_merges_clocks_as_the_host_loop():
    """Clock-only states: the sharded merge hands them to the host merge,
    which merges the clocks (the JAX mesh route does the same)."""
    a, b = P.ORSet(), P.ORSet()
    a.clock.counters[ACTORS[0]] = 4
    b.clock.counters[ACTORS[1]] = 2
    pacc = TorchAccelerator(min_device_batch=1, mesh=port_mesh(4, 2))
    got = pacc.merge_states(P.ORSet.from_obj(a.to_obj()), [b])
    host = HostAccelerator().merge_states(P.ORSet.from_obj(a.to_obj()), [b])
    assert canonical_bytes(got) == canonical_bytes(host)
    assert dict(got.clock.counters) == {ACTORS[0]: 4, ACTORS[1]: 2}


def test_trap_counters_past_int32_take_the_host_loop():
    big = 2**31 + 5
    state = P.ORSet()
    state.apply(state.add_ctx(ACTORS[0], 1))
    state.clock.counters[ACTORS[0]] = big
    state.entries[1] = {ACTORS[0]: big}
    _, ops = history(40, 5, seed=4)
    pacc = TorchAccelerator(min_device_batch=1, mesh=port_mesh(2, 2))
    host = HostAccelerator().fold_ops(P.ORSet.from_obj(state.to_obj()), ops)
    got = pacc.fold_ops(P.ORSet.from_obj(state.to_obj()), ops)
    assert canonical_bytes(got) == canonical_bytes(host)
    other, _ = history(30, 5, seed=5)
    got = pacc.merge_states(P.ORSet.from_obj(state.to_obj()), [other])
    host = HostAccelerator().merge_states(P.ORSet.from_obj(state.to_obj()),
                                          [other])
    assert canonical_bytes(got) == canonical_bytes(host)


def test_trap_pn_value_is_read_from_the_planes():
    """The sharded PN value is int64 ``sum(p) − sum(n)`` even where an
    int32 sum would wrap; the accelerator writes the planes back."""
    pm = port_mesh(2, 1)
    R = 4
    p0 = torch.full((R,), 2**30, dtype=torch.int64)
    sign = torch.zeros(2, dtype=torch.int8)
    p, n, value = pmesh.pncounter_fold_sharded(
        pm, p0, torch.zeros(R, dtype=torch.int64), sign,
        torch.tensor([0, R], dtype=torch.int32),
        torch.tensor([2**30 + 1, 0], dtype=torch.int64))
    assert int(value) == int(p.sum()) - int(n.sum()) == 4 * 2**30 + 1
    assert value.dtype == torch.int64


@pytest.mark.parametrize("adapter", ["pncounter", "gcounter", "lwwmap"])
def test_mesh_accel_counters_and_lww_match_the_host_loop(adapter):
    async def scenario():
        remote = MemoryRemote()
        ad = getattr(padapters, f"{adapter}_adapter")
        prod = await Core.open(popts(remote, adapter=ad()))
        if adapter == "lwwmap":
            await prod.update(lambda s: [
                s.put(i % 11, 1000 + i, prod.actor_id, i * 3)
                for i in range(40)])
            await prod.update(lambda s: s.delete(4, 5000, prod.actor_id))
        else:
            for i in range(25):
                await prod.update(lambda s, i=i: (
                    s.dec(prod.actor_id, i + 1)
                    if adapter == "pncounter" and i % 3 == 0
                    else s.inc(prod.actor_id, i + 1)))
        host = await Core.open(popts(remote, adapter=ad()))
        meshc = await Core.open(popts(
            remote, TorchAccelerator(min_device_batch=1,
                                     mesh=port_mesh(4, 2)), ad()))
        await host.read_remote()
        await meshc.read_remote()
        assert meshc.with_state(canonical_bytes) == host.with_state(
            canonical_bytes)

    run(scenario())


@pytest.mark.parametrize("dp,mp", [(8, 1), (2, 4)], ids=["dp8mp1", "dp2mp4"])
def test_mesh_accel_map_and_mvreg_match_the_jax_mesh_accel(dp, mp):
    rng = random.Random(dp * 31 + mp)
    pacc = TorchAccelerator(min_device_batch=1, mesh=port_mesh(dp, mp))
    jacc = TpuAccelerator(min_device_batch=1, mesh=jax_mesh(dp, mp))
    for _ in range(4):
        oracle, streams = map_history(P, map_script_from(rng, 4, 30))
        payloads = payloads_from_streams(streams)
        got = P.CrdtMap(child=b"orset")
        assert pacc.fold_payloads(got, payloads, actors_hint=MAP_ACTORS)
        ref = J.CrdtMap(child=b"orset")
        assert jacc.fold_payloads(ref, payloads, actors_hint=MAP_ACTORS)
        assert canonical_bytes(got) == canonical_bytes(oracle) == jcb(ref)
    snaps = mvreg_snapshots(dp + mp, n_snaps=6)
    got = pacc.merge_states(P.MVReg.from_obj(snaps[0].to_obj()), snaps[1:])
    jsnaps = [J.MVReg.from_obj(jcodec.unpack(canonical_bytes(s)))
              for s in snaps]
    ref = jacc.merge_states(jsnaps[0], jsnaps[1:])
    host = HostAccelerator().merge_states(
        P.MVReg.from_obj(snaps[0].to_obj()), snaps[1:])
    assert canonical_bytes(got) == canonical_bytes(host) == jcb(ref)


# ---- the sharded fold session -------------------------------------------------


def payloads_of(ops, per_file=10):
    return [pcodec.pack([op.to_obj() for op in ops[lo:lo + per_file]])
            for lo in range(0, len(ops), per_file)]


@pytest.mark.parametrize("prefix", [0, 120], ids=["fresh", "into_state"])
@pytest.mark.parametrize("dp,mp", MESHES, ids=IDS)
def test_sharded_stream_session_matches_the_jax_session(dp, mp, prefix,
                                                        monkeypatch):
    """An active mesh promotes straight to the sharded DEVICE_STREAM
    (never HOST_REDUCE); each chunk folds through the sharded step, and
    finish combines against the state by op-apply semantics: equal to
    the JAX mesh session and the host loop, also into a state that holds
    a prefix whose members the tail removes."""
    host, ops = history(300, 19, seed=dp * 5 + mp, rm_every=5)
    # each actor's last dot stays live, off the JAX session's clock fault
    # (see the next test)
    for i, a in enumerate(ACTORS):
        op = host.add_ctx(a, 100 + i)
        host.apply(op)
        ops.append(op)
    start = P.ORSet()
    for op in ops[:prefix]:
        start.apply(op)
    steps = []
    real = pmesh.sharded_stream_fold_step

    def spy(mesh):
        step = real(mesh)

        def wrapped(*a):
            steps.append(1)
            return step(*a)

        return wrapped

    monkeypatch.setattr(pmesh, "sharded_stream_fold_step", spy)
    pacc = TorchAccelerator(min_device_batch=1, mesh=port_mesh(dp, mp))
    jacc = TpuAccelerator(min_device_batch=1, mesh=jax_mesh(dp, mp))
    state = P.ORSet.from_obj(start.to_obj())
    jstate = J.ORSet.from_obj(jcodec.unpack(pcodec.pack(start.to_obj())))
    sess = S.OrsetFoldSession(pacc, state, actors_hint=ACTORS)
    jsess = JS.OrsetFoldSession(jacc, jstate, actors_hint=ACTORS)
    sess._buffered_bytes = jsess._buffered_bytes = 10**9
    payloads = payloads_of(ops[prefix:])
    for lo in range(0, len(payloads), 4):
        sess.feed(payloads[lo:lo + 4])
        jsess.feed(payloads[lo:lo + 4])
    assert sess.mode == jsess.mode == "device_stream"
    assert sess._d_E % mp == 0 and len(steps) == sess.device_chunks >= 1
    got, ref = sess.finish(), jsess.finish()
    assert canonical_bytes(got) == canonical_bytes(host) == jcb(ref)


@pytest.mark.parametrize("mesh", [None, (4, 2)], ids=["one_device", "mesh"])
def test_device_stream_keeps_the_clock_of_dots_the_batch_removed(mesh):
    """A fault of the reference: the DEVICE_STREAM finish recomputes the
    clock from the streamed add plane, which the fold's kill has emptied
    of every dot the batch itself removed, so an actor whose newest dot
    was removed keeps an older clock (JAX session.py:686-695).  The
    port's finish takes the stream's own clock, as the one-big-fold
    does."""
    a, b = ACTORS[:2]
    host, ops = P.ORSet(), []
    for op_fn in (lambda s: s.add_ctx(a, 1), lambda s: s.add_ctx(b, 2),
                  lambda s: s.add_ctx(a, 3), lambda s: s.rm_ctx(3)):
        op = op_fn(host)
        host.apply(op)
        ops.append(op)
    S.HOST_PLANE_CELLS, JS.HOST_PLANE_CELLS = -1, -1
    try:
        pacc = TorchAccelerator(device="cpu", min_device_batch=1,
                                mesh=None if mesh is None
                                else port_mesh(*mesh))
        jacc = TpuAccelerator(min_device_batch=1,
                              mesh=None if mesh is None else jax_mesh(*mesh))
        sess = S.OrsetFoldSession(pacc, P.ORSet(), actors_hint=ACTORS)
        jsess = JS.OrsetFoldSession(jacc, J.ORSet(), actors_hint=ACTORS)
        sess._buffered_bytes = jsess._buffered_bytes = 10**9
        sess.feed(payloads_of(ops))
        jsess.feed(payloads_of(ops))
        assert sess.mode == jsess.mode == "device_stream"
        got, ref = sess.finish(), jsess.finish()
    finally:
        S.HOST_PLANE_CELLS = JS.HOST_PLANE_CELLS = 1 << 27
    assert canonical_bytes(got) == canonical_bytes(host)
    assert got.clock.counters[a] == 2
    assert jcb(ref) != canonical_bytes(host)
    assert ref.clock.counters[a] == 1


@pytest.mark.parametrize("why", ["toggle_off", "spans_processes"])
def test_sharded_stream_gated_sessions_stay_buffered(why):
    """sharded_stream=False, or a mesh whose dp axis spans processes,
    keeps the session buffered: finish runs the whole-batch sharded
    fold."""
    host, ops = history(200, 11, seed=8)
    if why == "toggle_off":
        mesh = port_mesh(4, 2)
        accel = TorchAccelerator(min_device_batch=1, mesh=mesh,
                                 sharded_stream=False)
    else:
        mesh = pmesh.Mesh([[CPU, CPU]], processes=1, group=object())
        assert mesh.spans_processes and mesh.size == 2
        accel = TorchAccelerator(min_device_batch=1, mesh=mesh)
    sess = S.OrsetFoldSession(accel, P.ORSet(), actors_hint=ACTORS)
    sess._buffered_bytes = 10**9
    for p in payloads_of(ops):
        sess.feed([p])
    assert sess.mode == "buffer" and sess.device_chunks == 0
    if why == "toggle_off":
        assert canonical_bytes(sess.finish()) == canonical_bytes(host)


def test_fold_chunks_overlapped_takes_the_placement():
    from crdt_enc_tpu_torch.ops.stream import fold_chunks_overlapped

    put, _, _ = pmesh.stream_sharding(port_mesh(2, 2))
    seen = []

    def tagged(x, non_blocking):
        seen.append(non_blocking)
        return put(x, non_blocking)

    planes = (torch.zeros(2, dtype=torch.int32),) * 3
    out = fold_chunks_overlapped(
        planes, [(np.zeros(4, np.int8),) * 2], lambda p, c: p, put=tagged)
    assert out is planes and seen == [False, False]


# ---- the simulator on a mesh -------------------------------------------------


def test_sim_runner_on_a_mesh_gives_the_jax_fingerprint():
    """A schedule with service and daemon steps, its cycles on a (4, 2)
    mesh in both packages: the fingerprints equal (and equal the
    unsharded run's: the mesh is a layout, not a result)."""
    kw = dict(daemon=True, deltas=True)
    sched = jsim.generate(5, 4, 80, jsim.FaultConfig.all_faults(), **kw)
    psched = psim.generate(5, 4, 80, psim.FaultConfig.all_faults(), **kw)
    assert psched.to_obj() == sched.to_obj()
    steps = {s.kind for s in psched.steps}
    assert {"service", "daemon"} <= steps
    ref = jsim.runner.SimRunner(sched, mesh=jax_mesh(4, 2)).run()
    got = psim.runner.SimRunner(psched, device="cpu",
                                mesh=port_mesh(4, 2)).run()
    flat = psim.runner.SimRunner(psched, device="cpu").run()
    assert got.ok and ref.ok
    assert got.fingerprint == ref.fingerprint == flat.fingerprint
    assert got.service_cycles == ref.service_cycles


def test_population_substrate_on_a_mesh_gives_the_jax_fingerprints():
    scheds = [psim.generate(s, 3, 40, psim.FaultConfig.all_faults())
              for s in range(3)]
    jscheds = [jsim.generate(s, 3, 40, jsim.FaultConfig.all_faults())
               for s in range(3)]
    pm = pmesh.mesh_for_population(len(scheds), devices=[CPU] * 8)
    sub = psim.population.PopulationSubstrate("cpu", mesh=pm)
    try:
        assert sub.service.mesh is pm and sub.service._mesh_active
        got = psim.population.run_population(scheds, population=3,
                                             substrate=sub)
    finally:
        sub.close()
    jsub = jsim.population.PopulationSubstrate(
        mesh=jmesh.mesh_for_population(len(scheds)))
    try:
        ref = jsim.population.run_population(jscheds, population=3,
                                             substrate=jsub)
    finally:
        jsub.close()
    assert [r.fingerprint for r in got.results] == [
        r.fingerprint for r in ref.results]
