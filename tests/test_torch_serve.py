"""The port's multi-tenant fold service on the CPU.

Batching N tenants into one fold must be invisible: every tenant's state,
sealed snapshot, cursors and delta equal its own solo ``compact()``'s,
and equal what the JAX package's ``FoldService`` seals from a
byte-identical copy of the same remote, with the same ``TenantResult.path``
(tolerance 0: canonical bytes and decrypted payloads).  The tenant fold
itself (``orset_fold_tenants``: one fold over ``(E, T·R)`` planes) and the
G-Counter twin are held against the JAX ``vmap`` programs on seeded
inputs, padding rows at ``actor == R`` in every tenant included; the
bucket planner against the JAX planner; and the cases of
tests/test_serve.py that apply without a mesh run on the port.

Every port accelerator is ``TorchAccelerator(device="cpu",
min_device_batch=1)``; the JAX service's tenants use
``TpuAccelerator(min_device_batch=1)`` on the CPU backend.
"""

from __future__ import annotations

import asyncio
import copy
import os
import random
import shutil

import numpy as np
import pytest
import torch

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.ops import counters as jcounters
from crdt_enc_tpu.ops import orset as jorset
from crdt_enc_tpu.parallel import TpuAccelerator
from crdt_enc_tpu.serve import FoldService as JFoldService
from crdt_enc_tpu.serve import ServeConfig as JServeConfig
from crdt_enc_tpu.serve import TenantShape as JTenantShape
from crdt_enc_tpu.serve import plan_buckets as j_plan_buckets
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    gcounter_adapter,
    gset_adapter,
    lwwmap_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.obs import runtime as obs_runtime
from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.ops.columnar import (
    Vocab,
    orset_pack_checkpoint,
    orset_pack_checkpoint_planes,
    orset_state_to_planes,
    orset_unpack_checkpoint,
)
from crdt_enc_tpu_torch.ops.counters import gcounter_fold_tenants
from crdt_enc_tpu_torch.serve import (
    FoldService,
    PlaneWarmTier,
    ServeConfig,
    TenantShape,
    plan_buckets,
)
from crdt_enc_tpu_torch.utils import codec, trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


def run(coro):
    return asyncio.run(coro)


def make_opts(storage, adapter=None, create=True, **kw):
    kw.setdefault("accelerator", TorchAccelerator(device="cpu",
                                                  min_device_batch=1))
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=adapter if adapter is not None else orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create, **kw,
    )


def jopts(storage, adapter, create=False):
    return JOpenOptions(
        storage=storage, cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(), adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=TpuAccelerator(min_device_batch=1),
    )


async def write_orset(core, n_ops, tag, rm_every=7):
    """Adds and causal removes through one writer core."""
    for i in range(n_ops):
        m = b"%s-%d" % (tag, i % 31)
        await core.apply_ops(
            [core.with_state(lambda s, m=m: s.add_ctx(core.actor_id, m))])
        if rm_every and i % rm_every == rm_every - 1:
            victim = b"%s-%d" % (tag, (i * 3) % 31)
            op = core.with_state(
                lambda s, v=victim: s.rm_ctx(v) if v in s.entries else None)
            if op is not None:
                await core.apply_ops([op])


async def writer_for(storage, n_ops, tag, rm_every=7):
    core = await Core.open(make_opts(storage))
    await write_orset(core, n_ops, tag, rm_every)
    return core


# ---- the tenant folds, against the JAX programs ----------------------------


def tenant_inputs(T, E, R, N, seed, *, dummy=0):
    """T tenants' canonical planes and op rows; every tenant but the last
    carries padding rows (``actor == R``) whose counters exceed the next
    tenant's clock, so a mapping that sends them to ``t·R + R`` (tenant
    t+1's column 0) would raise that tenant's clock.  The last ``dummy``
    slots are the planner's dummy slots: zero planes, all padding."""
    rng = np.random.default_rng(seed)
    hi = 50
    clock0 = rng.integers(0, hi, (T, R)).astype(np.int32)
    add0 = np.where(rng.random((T, E, R)) < 0.3,
                    rng.integers(1, hi, (T, E, R)), 0)
    add0 = np.minimum(add0, clock0[:, None, :])
    rm0 = np.where(rng.random((T, E, R)) < 0.1,
                   rng.integers(1, 2 * hi, (T, E, R)), 0)
    add0 = np.where(add0 > rm0, add0, 0)
    rm0 = np.where(rm0 > clock0[:, None, :], rm0, 0)
    kind = (rng.random((T, N)) < 0.3).astype(np.int8)
    member = rng.integers(0, E, (T, N)).astype(np.int32)
    actor = rng.integers(0, R, (T, N)).astype(np.int32)
    counter = rng.integers(1, 2 * hi, (T, N)).astype(np.int32)
    pad = rng.random((T, N)) < 0.25
    pad[-1] = False
    actor[pad] = R
    counter[pad] = 10 * hi  # past every clock: a leak would show
    if dummy:
        for a in (clock0, add0, rm0):
            a[-dummy:] = 0
        kind[-dummy:] = 0
        member[-dummy:] = 0
        actor[-dummy:] = R
        counter[-dummy:] = 0
    return (clock0, add0.astype(np.int32), rm0.astype(np.int32), kind,
            member, actor, counter)


def _jax_tenants(inputs, E, R):
    out = jorset.orset_fold_tenants(*inputs, num_members=E, num_replicas=R)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("T,E,R,N,dummy", [
    (1, 8, 8, 40, 0), (3, 5, 4, 30, 0), (7, 16, 8, 64, 2), (8, 8, 16, 24, 5),
])
@pytest.mark.parametrize("seed", range(3))
def test_orset_fold_tenants_matches_jax(T, E, R, N, dummy, seed):
    inputs = tenant_inputs(T, E, R, N, seed, dummy=dummy)
    want = _jax_tenants(inputs, E, R)
    tens = [torch.from_numpy(x) for x in inputs]
    got = P.orset_fold_tenants(*tens, num_members=E, num_replicas=R)
    plain = P.orset_fold_tenants_plain(*tens, num_members=E, num_replicas=R)
    for g, p, w in zip(got, plain, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), w)
        assert np.array_equal(p.numpy(), w)
    if dummy:  # dummy slots stay zero
        for g in got:
            assert not g[-dummy:].any()


def test_naive_tenant_mapping_would_leak_padding_into_the_next_tenant():
    """The sentinel trap: mapping a padding row to ``t·R + R`` instead of
    the layout's sentinel ``T·R`` lands it in tenant t+1's column 0, and
    the fold then differs from the JAX program; the port's mapping does
    not."""
    T, E, R, N = 4, 6, 4, 32
    inputs = tenant_inputs(T, E, R, N, seed=5)
    want = _jax_tenants(inputs, E, R)
    clock0, add0, rm0, kind, member, actor, counter = (
        torch.from_numpy(x) for x in inputs)
    naive = (actor + torch.arange(T, dtype=torch.int32)[:, None] * R)
    out = P.orset_fold(
        clock0.reshape(T * R), add0.permute(1, 0, 2).reshape(E, T * R),
        rm0.permute(1, 0, 2).reshape(E, T * R), kind.reshape(-1),
        member.reshape(-1), naive.reshape(-1), counter.reshape(-1),
        num_members=E, num_replicas=T * R,
    )
    assert not np.array_equal(out[0].view(T, R).numpy(), want[0])
    cols = P.tenant_columns(actor, R).view(T, N)
    assert bool((cols[actor == R] == T * R).all())
    got = P.orset_fold_tenants(clock0, add0, rm0, kind, member, actor,
                               counter, num_members=E, num_replicas=R)
    assert np.array_equal(got[0].numpy(), want[0])


def test_tenant_columns_refuse_past_int32():
    actor = torch.zeros((1024, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        P.tenant_columns(actor, 1 << 21)


@pytest.mark.parametrize("T,R,N", [(1, 8, 30), (5, 8, 40), (16, 16, 8)])
def test_gcounter_fold_tenants_matches_jax(T, R, N):
    rng = np.random.default_rng(T * 31 + R)
    clock0 = rng.integers(0, 40, (T, R)).astype(np.int32)
    actor = rng.integers(0, R + 1, (T, N)).astype(np.int32)  # R pads
    counter = rng.integers(1, 80, (T, N)).astype(np.int32)
    want = np.asarray(jcounters.gcounter_fold_tenants(
        clock0, actor, counter, num_replicas=R))
    got = gcounter_fold_tenants(*(torch.from_numpy(x) for x in
                                  (clock0, actor, counter)), num_replicas=R)
    assert np.array_equal(got.numpy(), want)


# ---- the bucket planner, against the JAX planner ---------------------------


def _shapes(seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind = rng.choice(["orset", "orset", "gcounter"])
        rows = rng.choice([0, 1, 7, 50, 300, 2000, 40_000])
        members = rng.choice([1, 9, 64, 1500]) if kind == "orset" else 0
        out.append((i, kind, rows, members, rng.choice([1, 4, 5, 600, 1100])))
    rng.shuffle(out)
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("caps", [{}, {"rows_cap": 1024, "tenants_cap": 3},
                                  {"cells_cap": 1 << 12}])
def test_plan_buckets_matches_jax(seed, caps):
    shapes = _shapes(seed)
    mine, mine_solo = plan_buckets([TenantShape(*s) for s in shapes], **caps)
    theirs, theirs_solo = j_plan_buckets([JTenantShape(*s) for s in shapes],
                                         **caps)
    assert mine_solo == theirs_solo
    assert [(b.kind, b.rows, b.members, b.replicas, b.tenants, b.slots)
            for b in mine] == [(b.kind, b.rows, b.members, b.replicas,
                                b.tenants, b.slots) for b in theirs]


def test_plan_buckets_spills_and_splits():
    shapes = [
        TenantShape(0, "orset", 10_000, 10, 4),
        TenantShape(1, "orset", 100, 3000, 600),
        TenantShape(2, "orset", 100, 10, 4),
        TenantShape(3, "orset", 100, 10, 4),
        TenantShape(4, "orset", 100, 10, 4),
    ]
    buckets, solo = plan_buckets(shapes, rows_cap=1024, cells_cap=1 << 20,
                                 tenants_cap=2)
    assert solo == [0, 1]
    assert [b.tenants for b in buckets] == [[2, 3], [4]]
    with pytest.raises(ValueError):
        plan_buckets(shapes, rows_cap=0)


# ---- the mixed fleet: port service ≡ port solo ≡ JAX service ---------------


def _break(core):
    """After open, the tenant's op listing fails."""

    async def list_op_actors():
        raise OSError("remote unreachable")

    core.storage.list_op_actors = list_op_actors


class Fleet:
    """Tenant remotes on the filesystem, frozen into byte-identical
    copies: ``solo`` (the port's solo compact), ``port`` (the port's
    service) and ``jax`` (the JAX service).  The tenants' local dirs are
    copied too, so each copy opens the same actor id.  Writers keep
    writing into ``base``; :meth:`sync_tails` copies their new op files
    into every copy."""

    VARIANTS = ("solo", "port", "jax")

    def __init__(self, root):
        self.root = root
        self.kinds: list = []
        self.writers: list = []

    def path(self, variant, kind, t):
        return os.path.join(self.root, variant, f"{kind}{t}")

    async def add(self, adapter_name, write):
        t = len(self.kinds)
        remote = self.path("base", "r", t)
        w = await Core.open(make_opts(
            FsStorage(self.path("base", "w", t), remote),
            ADAPTERS[adapter_name][0]()))
        await write(w)
        # the tenant's identity, made once and copied with its remote
        await Core.open(make_opts(FsStorage(self.path("base", "l", t),
                                            remote),
                                  ADAPTERS[adapter_name][0]()))
        self.kinds.append(adapter_name)
        self.writers.append(w)

    def freeze(self):
        self._seen = self._remote_files()
        for v in self.VARIANTS:
            for t in range(len(self.kinds)):
                for k in ("r", "l"):
                    shutil.copytree(self.path("base", k, t),
                                    self.path(v, k, t))

    def _remote_files(self):
        out = set()
        for t in range(len(self.kinds)):
            top = self.path("base", "r", t)
            for d, _, files in os.walk(top):
                out.update(os.path.relpath(os.path.join(d, f), top)
                           for f in files)
        return out

    def sync_tails(self):
        now = self._remote_files()
        for v in self.VARIANTS:
            for t in range(len(self.kinds)):
                top = self.path("base", "r", t)
                for rel in sorted(now - self._seen):
                    src = os.path.join(top, rel)
                    if os.path.exists(src) and rel.startswith("ops"):
                        dst = os.path.join(self.path(v, "r", t), rel)
                        os.makedirs(os.path.dirname(dst), exist_ok=True)
                        shutil.copy2(src, dst)
        self._seen = now

    async def open(self, variant):
        cores = []
        for t, name in enumerate(self.kinds):
            st_args = (self.path(variant, "l", t), self.path(variant, "r", t))
            if variant == "jax":
                cores.append(await JCore.open(jopts(
                    JFsStorage(*st_args), ADAPTERS[name][1]())))
            else:
                cores.append(await Core.open(make_opts(
                    FsStorage(*st_args), ADAPTERS[name][0](), create=False)))
        return cores


ADAPTERS = {
    "orset": (orset_adapter, jadapters.orset_adapter),
    "gcounter": (gcounter_adapter, jadapters.gcounter_adapter),
    "pncounter": (pncounter_adapter, jadapters.pncounter_adapter),
    "gset": (gset_adapter, jadapters.gset_adapter),
    "lwwmap": (lwwmap_adapter, jadapters.lwwmap_adapter),
}


async def sealed(core):
    """(state bytes, decrypted snapshot payloads, cursor, decrypted delta
    payloads without their snapshot names) of one tenant, each
    canonically packed."""
    state = core.with_state(
        canonical_bytes if isinstance(core, Core) else j_canonical_bytes)
    names = await core.storage.list_state_names()
    snaps = sorted([codec.pack(await core._open_sealed(raw))
                    for _, raw in await core.storage.load_states(names)])
    deltas = []
    for a in sorted(await core.storage.list_delta_actors()):
        for _, v, raw in await core.storage.load_deltas([(a, 1)]):
            obj = dict(await core._open_sealed(raw))
            # the base and new snapshot names address ciphertexts, whose
            # nonces differ between copies; everything else must match
            obj.pop(b"new"), obj.pop(b"base")
            deltas.append((v, codec.pack(obj)))
    return state, snaps, codec.pack(core._data.next_op_versions.to_obj()), \
        sorted(deltas)


async def _mixed_fleet(root):
    fleet = Fleet(str(root))

    async def orset_n(n, tag):
        async def w(core):
            await write_orset(core, n, tag)
        return w

    async def gc(core):
        for _ in range(30):
            await core.apply_ops([core.with_state(
                lambda s: s.inc(core.actor_id))])

    async def pn(core):
        for i in range(20):
            await core.apply_ops([core.with_state(
                lambda s, i=i: s.inc(core.actor_id) if i % 3 else
                s.dec(core.actor_id))])

    async def gs(core):
        for i in range(25):
            await core.apply_ops([b"m%d" % (i % 13)])

    async def lww(core):
        for i in range(20):
            await core.apply_ops([core.with_state(
                lambda s, i=i: s.put(b"k%d" % (i % 5), 1000 + i,
                                     core.actor_id, i))])

    async def collide(core):
        # 1 and True pack apart but collide as Python values: the native
        # vocabulary declines and the Python columns take the tenant
        for m in (1, True, 2, b"x", 0.0, -0.0):
            await core.apply_ops([core.with_state(
                lambda s, m=m: s.add_ctx(core.actor_id, m))])

    async def nothing(core):
        pass

    await fleet.add("orset", nothing)  # 0: empty
    for t, n in ((1, 23), (2, 57), (3, 40)):
        await fleet.add("orset", await orset_n(n, b"t%d" % t))
    await fleet.add("orset", await orset_n(130, b"big"))  # 4: oversize
    await fleet.add("gcounter", gc)  # 5
    await fleet.add("pncounter", pn)  # 6: no bucket kind: solo
    await fleet.add("gset", gs)  # 7: solo
    await fleet.add("lwwmap", lww)  # 8: perop
    await fleet.add("orset", collide)  # 9: the decoder declines
    await fleet.add("orset", await orset_n(30, b"err"))  # 10: error
    fleet.freeze()
    return fleet


def test_mixed_fleet_port_service_equals_solo_and_the_jax_service(tmp_path):
    """Two cycles over a mixed fleet (ragged OR-Sets, an oversize spill,
    G- and PN-Counters, a G-Set, an LWW map, a member collision, an
    empty and a failing tenant): every tenant's state, sealed snapshot,
    cursor and delta equal the port's solo ``compact()`` and the JAX
    service's, and the paths equal the JAX service's.  Cycle 2 takes a
    tail on every OR-Set tenant, so the warm tier serves and the deltas
    are cut on the device."""
    async def scenario():
        fleet = await _mixed_fleet(tmp_path)
        solo, port, jax = [await fleet.open(v) for v in Fleet.VARIANTS]
        for cores in (solo, port, jax):
            _break(cores[10])
        cfg = dict(rows_cap=64)
        psvc = FoldService(port, ServeConfig(**cfg))
        jsvc = JFoldService(jax, JServeConfig(**cfg))
        for cycle in range(2):
            if cycle:
                for t in (1, 2, 3, 4):
                    await write_orset(fleet.writers[t], 9, b"tail%d" % t,
                                      rm_every=4)
                fleet.sync_tails()
            trace.reset()
            pres = await psvc.run_cycle()
            jres = await jsvc.run_cycle()
            for t, c in enumerate(solo):
                if t == 10:
                    with pytest.raises(OSError):
                        await c.compact()
                elif pres[t].sealed:
                    # a quiet tenant whose seal the service skips (its
                    # signature unmoved) is not re-sealed solo either
                    await c.compact()
            assert [r.path for r in pres] == [r.path for r in jres]
            assert [r.rows for r in pres] == [r.rows for r in jres]
            assert [r.sealed for r in pres] == [r.sealed for r in jres]
            if cycle == 0:
                assert [r.path for r in pres] == [
                    "empty", "batched", "batched", "batched", "solo",
                    "batched", "solo", "solo", "perop", "batched", "error"]
            else:
                snap = trace.snapshot()["counters"]
                assert snap["serve_warm_hits"] == 3
                assert snap["delta_device_cuts"] == 3
            for t in range(len(solo)):
                if t == 10:
                    assert "remote unreachable" in pres[t].error
                    continue
                s, p, j = [await sealed(c[t]) for c in (solo, port, jax)]
                assert p == s, f"tenant {t}: port service != port solo"
                assert p == j, f"tenant {t}: port service != JAX service"

    run(scenario())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_remote_sealed_by_one_service_continues_in_the_other(tmp_path,
                                                                first):
    """A fleet cycled by one package's service, then by the other's on
    the same remotes (new tails each cycle), reads back equal to a solo
    host-loop compaction of a byte-identical copy."""

    async def scenario():
        fleet = Fleet(str(tmp_path))
        fleet.VARIANTS = ("solo", "port")  # one served copy, both packages
        for t in range(3):
            await fleet.add("orset", lambda c, t=t: write_orset(
                c, 20 + 7 * t, b"x%d" % t))
        fleet.freeze()
        solo = await fleet.open("solo")
        order = [first, "port" if first == "jax" else "jax"]
        for cycle, who in enumerate(order):
            if cycle:
                for t in range(3):
                    await write_orset(fleet.writers[t], 6, b"y%d" % t)
                fleet.sync_tails()
            if who == "jax":
                cores = []
                for t in range(3):
                    cores.append(await JCore.open(jopts(JFsStorage(
                        fleet.path("port", "l", t),
                        fleet.path("port", "r", t)),
                        jadapters.orset_adapter())))
                res = await JFoldService(cores).run_cycle()
            else:
                cores = await fleet.open("port")
                res = await FoldService(cores).run_cycle()
            assert [r.path for r in res] == ["batched"] * 3
            for c in solo:
                await c.compact()
            for t in range(3):
                served = cores[t].with_state(
                    canonical_bytes if who == "port" else j_canonical_bytes)
                assert served == solo[t].with_state(canonical_bytes)
        # a cold reader of either package reads the last seal back
        for t in range(3):
            cold = await Core.open(make_opts(FsStorage(
                str(tmp_path / f"cold{t}"), fleet.path("port", "r", t))))
            await cold.read_remote()
            assert cold.with_state(canonical_bytes) == \
                solo[t].with_state(canonical_bytes)

    run(scenario())


def test_counter_past_int32_folds_as_the_host_loop(tmp_path):
    """An OR-Set dot past 2^31 − 1.  Cycle 1: the port's native decoder
    declines, the int32 columns cannot hold the rows, and the tenant
    folds per op (the host loop).  Cycle 2: the state itself holds the
    counter, so the tenant leaves the bucket (``solo``, then ``perop``)
    instead of failing it, and its bucket mate still batches.  Each cycle
    equals a solo compact with ``TorchAccelerator`` (whose fold routes
    now take the host loop for such counters) and with the host loop.
    The JAX service batches the row, its native decoder narrowing the
    counter, and loses the add: a reference fault the port does not
    copy."""
    from crdt_enc_tpu_torch import HostAccelerator

    async def scenario():
        fleet = Fleet(str(tmp_path))
        fleet.VARIANTS = ("solo", "port", "jax", "host")

        async def big(core):
            await core.apply_ops([AddOp(b"big",
                                        Dot(core.actor_id, 2**31 + 5))])
            await write_orset(core, 20, b"small")

        await fleet.add("orset", big)
        await fleet.add("orset", lambda c: write_orset(c, 20, b"mate"))
        fleet.freeze()
        solo, port, jax = [await fleet.open(v) for v in ("solo", "port",
                                                         "jax")]
        host = [await Core.open(make_opts(
            FsStorage(fleet.path("host", "l", t), fleet.path("host", "r", t)),
            create=False, accelerator=HostAccelerator())) for t in range(2)]
        service = FoldService(port)
        for cycle in range(2):
            if cycle:
                for t in range(2):
                    await write_orset(fleet.writers[t], 5, b"tail%d" % t)
                fleet.sync_tails()
            res = await service.run_cycle()
            for c in solo + host:
                await c.compact()
            assert [r.path for r in res] == ["perop", "batched"]
            assert all(r.sealed for r in res)
            for t in range(2):
                p = (await sealed(port[t]))[:3]
                assert p == (await sealed(solo[t]))[:3]
                assert p == (await sealed(host[t]))[:3]
            assert port[0].with_state(lambda s: s.contains(b"big"))
        (jres, _) = await JFoldService(jax).run_cycle()
        assert jres.path == "batched"
        assert not jax[0].with_state(lambda s: s.contains(b"big"))

    run(scenario())


def test_snapshots_past_int32_merge_on_the_host():
    """Three OR-Set snapshots, one holding a counter past 2^31 − 1, merge
    on the host (the int32 planes cannot hold it), equal to the host
    loop's merge; without it they take K4's plain version, equal too."""
    from crdt_enc_tpu_torch import HostAccelerator

    actors = [bytes([i]) * 16 for i in range(1, 4)]

    def snaps(big):
        out = []
        for i, a in enumerate(actors):
            s = ORSet()
            s.apply(AddOp(b"m%d" % i, Dot(a, (2**31 + 9) if big and i == 1
                                           else 5 + i)))
            out.append(s)
        return out

    for big in (True, False):
        dev, host = ORSet(), ORSet()
        trace.reset()
        TorchAccelerator(device="cpu", min_device_batch=1).merge_states(
            dev, snaps(big))
        HostAccelerator().merge_states(host, snaps(big))
        assert canonical_bytes(dev) == canonical_bytes(host)
        assert ("merge.device" in trace.snapshot()["spans"]) is not big


# ---- the cases of tests/test_serve.py without a mesh -----------------------


def test_single_tenant_service_equals_solo_compact():
    async def scenario():
        remote = MemoryRemote()
        await writer_for(MemoryStorage(remote), 60, b"solo")
        twin = copy.deepcopy(remote)
        solo = await Core.open(make_opts(MemoryStorage(twin)))
        served = await Core.open(make_opts(MemoryStorage(remote)))
        await solo.compact()
        (res,) = await FoldService([served]).run_cycle()
        assert res.error is None and res.path == "batched" and res.sealed
        assert solo.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)
        cold = await Core.open(make_opts(MemoryStorage(remote)))
        await cold.read_remote()
        assert cold.with_state(canonical_bytes) == \
            solo.with_state(canonical_bytes)
        stats = await served.storage.stat_ops(
            [(a, 1) for a in await served.storage.list_op_actors()])
        assert stats == []

    run(scenario())


def test_empty_tenant_seal_parity_then_noop():
    """A tenant never sealed seals even with no new ops, as a solo
    compact does; the next quiet cycle publishes nothing."""
    async def scenario():
        remote = MemoryRemote()
        served = await Core.open(make_opts(MemoryStorage(remote)))
        service = FoldService([served])
        (res,) = await service.run_cycle()
        assert res.path == "empty" and res.sealed
        assert len(remote.states) == 1
        names = set(remote.states)
        (res2,) = await service.run_cycle()
        assert res2.path == "empty" and not res2.sealed
        assert set(remote.states) == names

    run(scenario())


def test_oversize_tenant_spills_to_solo_path():
    async def scenario():
        remotes = [MemoryRemote(), MemoryRemote()]
        await writer_for(MemoryStorage(remotes[0]), 120, b"big")
        await writer_for(MemoryStorage(remotes[1]), 30, b"small")
        twins = [copy.deepcopy(r) for r in remotes]
        solo_cores = []
        for r in twins:
            c = await Core.open(make_opts(MemoryStorage(r)))
            await c.compact()
            solo_cores.append(c)
        served = [await Core.open(make_opts(MemoryStorage(r)))
                  for r in remotes]
        trace.reset()
        results = await FoldService(served,
                                    ServeConfig(rows_cap=64)).run_cycle()
        assert [r.path for r in results] == ["solo", "batched"]
        assert trace.snapshot()["counters"]["serve_solo_spills"] == 1
        for a, b in zip(solo_cores, served):
            assert a.with_state(canonical_bytes) == \
                b.with_state(canonical_bytes)

    run(scenario())


def test_zero_row_op_files_still_advance_cursors():
    async def scenario():
        remote = MemoryRemote()
        w = await Core.open(make_opts(MemoryStorage(remote)))
        await w.apply_ops([RmOp(b"ghost", VClock())])  # a 0-row op file
        twin = copy.deepcopy(remote)
        solo = await Core.open(make_opts(MemoryStorage(twin)))
        await solo.compact()
        served = await Core.open(make_opts(MemoryStorage(remote)))
        service = FoldService([served])
        (res,) = await service.run_cycle()
        assert res.error is None and res.sealed and res.path == "batched"
        assert served._data.next_op_versions.counters == \
            solo._data.next_op_versions.counters
        assert await served.storage.list_op_actors() == []
        assert solo.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)
        (res2,) = await service.run_cycle()
        assert res2.path == "empty"

    run(scenario())


def test_all_tenants_land_in_one_bucket_and_one_fold():
    async def scenario():
        remotes = [MemoryRemote() for _ in range(5)]
        for t, r in enumerate(remotes):
            await writer_for(MemoryStorage(r), 40, b"same%d" % t)
        served = [await Core.open(make_opts(MemoryStorage(r)))
                  for r in remotes]
        trace.reset()
        results = await FoldService(served).run_cycle()
        snap = trace.snapshot()
        assert snap["gauges"]["serve_buckets"] == 1
        assert snap["spans"]["serve.fold"]["count"] == 1
        assert all(r.path == "batched" for r in results)
        assert snap["counters"]["serve_rows_folded"] == sum(
            r.rows for r in results)

    run(scenario())


def test_zero_builds_after_the_first_cycle_across_shuffled_mixes():
    """The port's twin of the bounded-recompile acceptance: after the
    first cycle, neither a shuffled fleet of the same size classes nor a
    quiet cycle builds any kernel or native library."""

    async def build_fleet(sizes, tag):
        served = []
        for t, n in enumerate(sizes):
            remote = MemoryRemote()
            await writer_for(MemoryStorage(remote), n, b"%s%d" % (tag, t),
                             rm_every=5)
            served.append(await Core.open(make_opts(MemoryStorage(remote))))
        return served

    async def scenario():
        sizes = [20, 25, 30, 90, 100, 40]
        fleet_a = await build_fleet(sizes, b"a")
        service = FoldService(fleet_a)
        await service.run_cycle()
        baseline = obs_runtime.build_count()
        shuffled = list(sizes)
        random.Random(11).shuffle(shuffled)
        fleet_b = await build_fleet(shuffled, b"b")
        await FoldService(fleet_b).run_cycle()
        results = await service.run_cycle()  # quiet
        assert all(r.path == "empty" for r in results)
        assert obs_runtime.build_count() == baseline

    run(scenario())


class _ProbeCountingStorage(MemoryStorage):
    def __init__(self, remote):
        super().__init__(remote)
        self.stat_calls = 0
        self.list_calls = 0

    def reset_counts(self):
        self.stat_calls = 0
        self.list_calls = 0

    async def stat_ops(self, actor_first_versions):
        self.stat_calls += 1
        return await super().stat_ops(actor_first_versions)

    async def list_op_actors(self):
        self.list_calls += 1
        return await super().list_op_actors()


def test_service_cycle_pays_zero_replication_probes():
    """Per tenant a cycle pays exactly one ``list_op_actors`` (its own
    ingest) and zero ``stat_ops``; a solo compact pays a second listing
    for its status sample.  Every tenant still publishes a sample."""

    async def scenario():
        n = 4
        storages, served = [], []
        for t in range(n):
            remote = MemoryRemote()
            await writer_for(MemoryStorage(remote), 25, b"p%d" % t)
            st = _ProbeCountingStorage(remote)
            storages.append(st)
            served.append(await Core.open(make_opts(st)))
        for st in storages:
            st.reset_counts()
        trace.reset()
        results = await FoldService(served).run_cycle()
        assert all(r.sealed for r in results)
        assert [st.stat_calls for st in storages] == [0] * n
        assert [st.list_calls for st in storages] == [1] * n
        assert trace.snapshot()["counters"]["repl_samples"] == n
        for c in served:
            assert c.last_replication_status["backlog"]["files"] == 0
        for st in storages:
            st.reset_counts()
        for c in served:
            await c.compact()
        assert [st.list_calls for st in storages] == [2] * n

    run(scenario())


def test_warm_tier_unit_lru_budget_and_invalidation():
    class S:
        _mut = 0

    tier = PlaneWarmTier(byte_budget=100)
    states = [S(), S(), S()]

    def planes(n):
        return (torch.zeros(n, dtype=torch.int32),)  # n*4 bytes

    trace.reset()
    tier.store(states[0], None, None, planes(10))
    tier.store(states[1], None, None, planes(10))
    assert tier.lookup(states[0]) is not None
    tier.store(states[2], None, None, planes(10))  # evicts state 1
    assert len(tier) == 2 and tier.bytes_held == 80
    assert tier.lookup(states[1]) is None
    assert trace.snapshot()["counters"]["serve_warm_evictions"] == 1
    assert tier.lookup(states[2]) is not None
    states[2]._mut = 99
    assert tier.lookup(states[2]) is None
    assert trace.snapshot()["counters"]["serve_warm_expired"] == 1
    assert len(tier) == 1
    assert not tier.stamp_seal(states[2], "n")
    assert tier.stamp_seal(states[0], "n")
    del states[0]
    assert len(tier) == 0  # the finalizer dropped the dead state's entry
    with pytest.raises(ValueError):
        PlaneWarmTier(byte_budget=0)


def test_warm_tier_reuse_across_cycles_byte_identical():
    async def scenario():
        remotes = [MemoryRemote() for _ in range(3)]
        writers = [await writer_for(MemoryStorage(r), 35, b"w%d" % t)
                   for t, r in enumerate(remotes)]
        served = [await Core.open(make_opts(MemoryStorage(r)))
                  for r in remotes]
        service = FoldService(served)
        await service.run_cycle()
        assert len(service.warm) == 3
        for t, w in enumerate(writers):
            await write_orset(w, 12, b"x%d" % t, rm_every=0)
        await served[0].apply_ops([served[0].with_state(
            lambda s: s.add_ctx(served[0].actor_id, b"local"))])
        trace.reset()
        results = await service.run_cycle()
        snap = trace.snapshot()["counters"]
        assert snap["serve_warm_hits"] == 2
        assert snap["serve_warm_misses"] == 1
        assert all(r.path == "batched" for r in results)
        for c, r in zip(served, remotes):
            cold = await Core.open(make_opts(MemoryStorage(r)))
            await cold.read_remote()
            assert c.with_state(canonical_bytes) == \
                cold.with_state(canonical_bytes)

    run(scenario())


def test_pack_checkpoint_planes_roundtrip_equals_sparse_pack():
    rng = random.Random(13)
    actors = [bytes([i]) * 16 for i in range(9)]
    s = ORSet()
    for _ in range(800):
        a = rng.choice(actors)
        m = rng.choice([b"x", 5, "s", (2, "t"), rng.randrange(25)])
        s.apply(AddOp(m, s.clock.inc(a)))
        if rng.random() < 0.3 and s.entries:
            m2 = rng.choice(list(s.entries))
            s.apply(RmOp(m2, VClock(dict(s.entries[m2]))))
    s.apply(RmOp(b"ahead", VClock({b"z" * 16: 7})))  # a deferred-only member
    members, replicas = Vocab(), Vocab()
    clock, add, rm = orset_state_to_planes(s, members, replicas)
    add_p = np.pad(add, ((0, 5), (0, 3)))
    rm_p = np.pad(rm, ((0, 5), (0, 3)))
    clock_p = np.pad(clock, (0, 3))
    packed = orset_pack_checkpoint_planes(clock_p, add_p, rm_p, members,
                                          replicas)
    via_planes = orset_unpack_checkpoint(codec.unpack(codec.pack(packed)))
    via_sparse = orset_unpack_checkpoint(codec.unpack(codec.pack(
        orset_pack_checkpoint(s))))
    assert codec.pack(via_planes.to_obj()) == codec.pack(s.to_obj())
    assert codec.pack(via_planes.to_obj()) == codec.pack(via_sparse.to_obj())
    from crdt_enc_tpu.ops import columnar as jcolumnar

    jv_m, jv_r = jcolumnar.Vocab(members.items), jcolumnar.Vocab(
        replicas.items)
    assert codec.pack(packed) == codec.pack(
        jcolumnar.orset_pack_checkpoint_planes(clock_p, add_p, rm_p, jv_m,
                                               jv_r))
    empty = orset_unpack_checkpoint(codec.unpack(codec.pack(
        orset_pack_checkpoint_planes(
            np.zeros(4, np.int32), np.zeros((4, 4), np.int32),
            np.zeros((4, 4), np.int32), Vocab(), Vocab()))))
    assert codec.pack(empty.to_obj()) == codec.pack(ORSet().to_obj())


def test_service_sealed_checkpoint_warm_opens():
    async def scenario():
        remote = MemoryRemote()
        await writer_for(MemoryStorage(remote), 45, b"ck")
        storage = MemoryStorage(remote)
        served = await Core.open(make_opts(storage))
        (res,) = await FoldService([served]).run_cycle()
        assert res.path == "batched" and res.sealed
        reopened = await Core.open(make_opts(storage, create=False))
        assert reopened.opened_from_checkpoint, \
            reopened.checkpoint_fallback_reason
        assert reopened.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)

    run(scenario())


def test_close_is_idempotent_and_cycle_after_close_refuses():
    async def scenario():
        core = await Core.open(make_opts(MemoryStorage(MemoryRemote())))
        service = FoldService([core], live_port=0)
        port = service.live.port
        await service.run_cycle()
        service.close()
        assert service.closed
        service.close()
        with pytest.raises(RuntimeError, match="closed"):
            await service.run_cycle()
        import socket

        with socket.socket() as s:
            assert s.connect_ex(("127.0.0.1", port)) != 0

    run(scenario())


def test_run_cycle_is_not_reentrant_and_the_shared_entry_queues():
    class StallingStorage(MemoryStorage):
        def __init__(self, remote, gate):
            super().__init__(remote)
            self._gate = gate

        async def list_op_actors(self):
            await self._gate.wait()
            return await super().list_op_actors()

    async def scenario():
        gate = asyncio.Event()
        gate.set()
        remote = MemoryRemote()
        await writer_for(MemoryStorage(remote), 10, b"re")
        core = await Core.open(make_opts(StallingStorage(remote, gate)))
        service = FoldService([core])
        gate.clear()
        first = asyncio.ensure_future(service.run_cycle())
        await asyncio.sleep(0)
        with pytest.raises(RuntimeError, match="not reentrant"):
            await service.run_cycle()
        gate.set()
        assert (await first)[0].error is None
        (res2,) = await service.run_cycle()
        assert res2.error is None
        both = await asyncio.gather(service.run_cycle_shared(),
                                    service.run_cycle_shared())
        assert [r[0].error for r in both] == [None, None]

    run(scenario())


def test_run_cycle_subset_override():
    async def scenario():
        remotes = [MemoryRemote() for _ in range(3)]
        for t, r in enumerate(remotes):
            await writer_for(MemoryStorage(r), 20, b"s%d" % t)
        served = [await Core.open(make_opts(MemoryStorage(r)))
                  for r in remotes]
        results = await FoldService(served).run_cycle(served[:2])
        assert len(results) == 2 and all(r.sealed for r in results)
        assert await served[2].storage.list_op_actors() != []

    run(scenario())


def test_tenant_failure_is_isolated():
    async def scenario():
        ok_remote = MemoryRemote()
        await writer_for(MemoryStorage(ok_remote), 20, b"ok")
        broken = await Core.open(make_opts(MemoryStorage(MemoryRemote())))
        _break(broken)
        healthy = await Core.open(make_opts(MemoryStorage(ok_remote)))
        results = await FoldService([broken, healthy]).run_cycle()
        assert results[0].path == "error"
        assert "remote unreachable" in results[0].error
        assert not results[0].sealed
        assert results[1].path == "batched" and results[1].sealed

    run(scenario())


def test_a_failing_bucket_leaves_the_other_buckets_folding(monkeypatch):
    """Isolation is per bucket: a fold that raises marks its bucket's
    tenants ``error`` (cursors unmoved, nothing sealed) while a bucket of
    another size class folds and seals."""

    async def scenario():
        remotes = [MemoryRemote() for _ in range(3)]
        sizes = [20, 22, 300]  # two row classes: two buckets
        for t, (r, n) in enumerate(zip(remotes, sizes)):
            await writer_for(MemoryStorage(r), n, b"b%d" % t, rm_every=0)
        served = [await Core.open(make_opts(MemoryStorage(r)))
                  for r in remotes]
        real = P.orset_fold_tenant_layout

        def flaky(*args, **kw):
            if args[3].shape[1] == 32:  # the small tenants' row class
                raise MemoryError("bucket too large")
            return real(*args, **kw)

        monkeypatch.setattr(P, "orset_fold_tenant_layout", flaky)
        results = await FoldService(served).run_cycle()
        assert [r.path for r in results] == ["error", "error", "batched"]
        assert "bucket too large" in results[0].error
        assert served[0]._data.next_op_versions.counters == {}
        assert results[2].sealed

    run(scenario())
