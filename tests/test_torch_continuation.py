"""The fold service's continuation on the port: warm planes that serve
as the next cycle's fold base AND its delta base, the delta cut on the
device, and the quiet cycle that costs a listing.

The plane diff (``orset_plane_diff*``) and the wire builder
(``orset_delta_from_rows``) are held against the host dict walk
``orset_delta_diff`` (the port's and the JAX package's) and against the
JAX XLA programs on the same planes; the cycle cases of
tests/test_continuation.py that apply without a mesh run on the port
over memory and fs storage, each tenant byte-equal to a solo
``compact()`` and to a cold reader.  Tolerance 0 throughout.
"""

from __future__ import annotations

import asyncio
import copy
import random

import numpy as np
import pytest
import torch

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.delta import codec as jdelta_codec
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.ops import orset as jorset
from crdt_enc_tpu.tools.fsck import fsck_remote
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
    orset_adapter,
)
from crdt_enc_tpu_torch import ops as K
from crdt_enc_tpu_torch.delta import ResettableCounter, rcounter_adapter
from crdt_enc_tpu_torch.delta.codec import orset_delta_diff, orset_delta_from_rows
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.obs import runtime as obs_runtime
from crdt_enc_tpu_torch.ops import orset as P
from crdt_enc_tpu_torch.serve import FoldService, ServeConfig
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


@pytest.fixture(params=["memory", "fs"])
def storage_factory(request, tmp_path):
    """name -> a Storage on one shared remote; one name, one local dir."""
    if request.param == "memory":
        remote = MemoryRemote()

        def make(name="a"):
            return MemoryStorage(remote)

        make.remote_dir = None
        return make

    def make(name="a"):
        return FsStorage(str(tmp_path / f"local-{name}"),
                         str(tmp_path / "remote"))

    make.remote_dir = str(tmp_path / "remote")
    return make


def counters():
    return trace.snapshot()["counters"]


def gauges():
    return trace.snapshot()["gauges"]


# ---- the plane diff --------------------------------------------------------


def _rand_orset(rng, rounds):
    s = ORSet()
    for _ in range(rounds):
        m = b"m%d" % rng.randrange(8)
        r = b"r%d" % rng.randrange(4)
        if rng.random() < 0.65:
            s.apply(AddOp(m, Dot(r, s.clock.get(r) + rng.randrange(1, 3))))
        else:
            s.apply(RmOp(m, VClock(dict(s.clock.counters))))
    return s


def _evolve(rng, s, rounds):
    n = copy.deepcopy(s)
    for _ in range(rounds):
        m = b"m%d" % rng.randrange(10)
        r = b"r%d" % rng.randrange(4)
        if rng.random() < 0.6:
            n.apply(AddOp(m, Dot(r, n.clock.get(r) + rng.randrange(1, 3))))
        else:
            n.apply(RmOp(m, VClock(dict(n.clock.counters))))
    return n


def _planes(base, new, pad=(0, 0)):
    members, replicas = K.Vocab(), K.Vocab()
    K.orset_scan_vocab(base, members, replicas)
    K.orset_scan_vocab(new, members, replicas)
    b = K.orset_state_to_planes(base, members, replicas, scanned=True)
    n = K.orset_state_to_planes(new, members, replicas, scanned=True)
    pe, pr = pad
    padded = []
    for c, a, r in (b, n):
        padded.append((np.pad(c, (0, pr)), np.pad(a, ((0, pe), (0, pr))),
                       np.pad(r, ((0, pe), (0, pr)))))
    return padded, members, replicas


@pytest.mark.parametrize("pad", [(0, 0), (3, 5)])
@pytest.mark.parametrize("seed", range(8))
def test_plane_diff_matches_the_host_dict_walk_and_jax(seed, pad):
    """Randomized causal pairs: the device cut's wire object packs to the
    bytes of the host walk (the port's and the JAX package's), and the
    code plane equals the JAX program's, on bucket-padded planes too."""
    rng = random.Random(seed)
    base = _rand_orset(rng, 60)
    new = _evolve(rng, base, 40)
    (b, n), members, replicas = _planes(base, new, pad)
    code, count = P.orset_plane_diff(*(torch.from_numpy(x) for x in b + n))
    jcode, jcount = jorset.orset_plane_diff(*b, *n)
    assert np.array_equal(code.numpy(), np.asarray(jcode))
    assert int(count) == int(jcount)
    # the service's gather at T = 1 (the (E, R) planes are that layout)
    _, *rows = P.orset_plane_diff_rows_tenants(
        code, torch.from_numpy(b[1]), torch.from_numpy(n[1]),
        torch.from_numpy(n[2]), 1, torch.tensor([0]))
    assert len(rows[0]) == int(count)
    jrows = jorset.orset_plane_diff_rows(code.numpy(), b[1], n[1], n[2],
                                         size=int(count))
    for got, want in zip(rows, jrows):
        assert np.array_equal(got.numpy(), np.asarray(want))
    dev = orset_delta_from_rows(
        tuple(r.numpy() for r in rows), members=members.items,
        replicas=replicas.items, row_width=b[0].shape[0],
        base_clock=b[0], new_clock=n[0],
    )
    host = orset_delta_diff(base, new)
    jhost = jdelta_codec.orset_delta_diff(JORSet.from_obj(base.to_obj()),
                                          JORSet.from_obj(new.to_obj()))
    assert codec.pack(dev) == codec.pack(host) == codec.pack(jhost)


def test_plane_diff_of_identical_states_is_empty():
    s = _rand_orset(random.Random(99), 50)
    (b, _), _, _ = _planes(s, s)
    code, count = P.orset_plane_diff(*(torch.from_numpy(x) for x in b + b))
    assert int(count) == 0 and not code.any()


@pytest.mark.parametrize("T", [1, 3, 6])
def test_tenant_diffs_match_jax_and_the_one_gather(T):
    """The bucket's diff as the service runs it: ``orset_plane_diff`` over
    the tenant layout equals the JAX ``vmap`` program tenant by tenant,
    and the one gather (``orset_plane_diff_rows_tenants``) returns each
    selected tenant's rows as JAX's per-tenant gather does, and no row
    of an unselected tenant."""
    rng = random.Random(T)
    E, R = 12, 8
    stacks = [[], [], [], [], [], []]
    for _ in range(T):
        base = _rand_orset(rng, 40)
        new = _evolve(rng, base, 25)
        (b, n), members, replicas = _planes(base, new)
        e, r = b[1].shape
        for i, x in enumerate(b + n):
            if x.ndim == 1:
                stacks[i].append(np.pad(x, (0, R - r)))
            else:
                stacks[i].append(np.pad(x, ((0, E - e), (0, R - r))))
    cb, ab, rb, cn, an, rn = (np.stack(s).astype(np.int32) for s in stacks)
    jcode, jcounts = jorset.orset_plane_diff_tenants(cb, ab, rb, cn, an, rn)
    # the same planes in the tenant layout, diffed and gathered once
    lay = lambda x: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(x.transpose(1, 0, 2)).reshape(E, T * R))
    lcode, lcount = P.orset_plane_diff(
        torch.from_numpy(cb.reshape(-1)), lay(ab), lay(rb),
        torch.from_numpy(cn.reshape(-1)), lay(an), lay(rn))
    code = P.tenant_planes(lcode, T)
    assert np.array_equal(code.numpy(), np.asarray(jcode))
    assert int(lcount) == int(np.asarray(jcounts).sum())
    selected = list(range(0, T, 2)) if T > 1 else [0]
    t, idx, cd, a_b, a_n, r_n = (x.numpy() for x in P.orset_plane_diff_rows_tenants(
        lcode, lay(ab), lay(an), lay(rn), T, torch.tensor(selected)))
    assert set(t.tolist()) <= set(selected)
    assert np.all(np.diff(t) >= 0)
    for s in selected:
        want = jorset.orset_plane_diff_rows(
            np.asarray(jcode[s]), ab[s], an[s], rn[s],
            size=int(jcounts[s]))
        mine = t == s
        for got, w in zip((idx, cd, a_b, a_n, r_n), want):
            assert np.array_equal(got[mine], np.asarray(w))


# ---- continuation cycles ---------------------------------------------------


async def _write_orset(core, n, tag):
    for i in range(n):
        m = b"%s-%d" % (tag, i % 13)
        await core.apply_ops(
            [core.with_state(lambda s, m=m: s.add_ctx(core.actor_id, m))])
        if i % 7 == 6:
            victim = b"%s-%d" % (tag, (i * 3) % 13)
            op = core.with_state(
                lambda s, v=victim: s.rm_ctx(v) if v in s.entries else None)
            if op is not None:
                await core.apply_ops([op])


def test_device_cut_cycle_differential(storage_factory):
    """A continuation cycle seals its delta by device cut (base bytes
    dropped, ``delta_base_bytes`` 0), a quiet cycle no-ops, the next
    active cycle cuts again from the re-stamped planes — and at every
    step the served tenant equals a cold reader and a delta consumer,
    with the seal-time self-verify on."""

    async def go():
        writer = await Core.open(make_opts(storage_factory("w")))
        served = await Core.open(make_opts(storage_factory("s")))
        service = FoldService([served], ServeConfig())
        await _write_orset(writer, 30, b"a")
        trace.reset()
        (r1,) = await service.run_cycle()
        assert r1.sealed and r1.path == "batched"
        assert counters().get("serve_continuations") == 1
        await _write_orset(writer, 10, b"b")
        trace.reset()
        (r2,) = await service.run_cycle()
        assert r2.sealed
        assert counters().get("delta_device_cuts") == 1
        assert counters().get("delta_files_sealed") == 1
        assert not counters().get("delta_seal_divergence")
        assert gauges().get("delta_base_bytes") == 0
        trace.reset()
        (r3,) = await service.run_cycle()
        assert r3.path == "empty" and not r3.sealed
        assert counters().get("serve_noop_cycles") == 1
        assert not counters().get("delta_device_cuts")
        await _write_orset(writer, 7, b"c")
        trace.reset()
        (r4,) = await service.run_cycle()
        assert r4.sealed
        assert counters().get("delta_device_cuts") == 1
        cold = await Core.open(make_opts(storage_factory("cold"), delta=False))
        await cold.read_remote()
        assert cold.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)
        trace.reset()
        consumer = await Core.open(make_opts(storage_factory("consumer")))
        await consumer.read_remote()
        assert consumer.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)

    run(go())


def test_device_cut_matches_host_diff_arm(storage_factory):
    """The warm tier cleared after every cycle (host dict-walk diff,
    retained base bytes) and kept (device cut, dropped base): both arms
    stay equal to a solo compact."""

    async def go():
        for arm in ("host", "cut"):
            writer = await Core.open(make_opts(storage_factory(f"w-{arm}")))
            served = await Core.open(make_opts(storage_factory(f"s-{arm}")))
            service = FoldService([served], ServeConfig())
            trace.reset()
            for rnd in range(3):
                await _write_orset(writer, 12, b"r%d" % rnd)
                (res,) = await service.run_cycle()
                assert res.sealed
                if arm == "host":
                    # every next cycle misses the tier: a cold fold
                    for key in list(service.warm._entries):
                        service.warm._drop(key)
            if arm == "cut":
                assert counters().get("delta_device_cuts") == 2
                assert gauges().get("delta_base_bytes") == 0
            else:
                assert not counters().get("delta_device_cuts")
            assert not counters().get("delta_seal_divergence")
            solo = await Core.open(make_opts(storage_factory(f"x-{arm}")))
            await solo.compact()
            assert solo.with_state(canonical_bytes) == \
                served.with_state(canonical_bytes), arm

    run(go())


@pytest.mark.parametrize("which", ["rcounter", "gcounter"])
def test_other_kinds_ride_the_continuation(storage_factory, which):
    """rcounter states are OR-Sets, so they ride the device cut;
    G-Counters take the continuation and no-op path with their own
    codec.  Both stay equal to a solo compact."""

    async def go():
        if which == "rcounter":
            adapter = rcounter_adapter

            async def write(core, n, r):
                for i in range(n):
                    await core.apply_ops([core.with_state(
                        lambda s, i=i: ResettableCounter.inc(
                            s, core.actor_id, i + r + 1))])
        else:
            adapter = gcounter_adapter

            async def write(core, n, r):
                for _ in range(n):
                    await core.apply_ops([core.with_state(
                        lambda s: s.inc(core.actor_id))])

        writer = await Core.open(make_opts(storage_factory("w"), adapter()))
        served = await Core.open(make_opts(storage_factory("s"), adapter(),
                                           delta=which == "rcounter"))
        service = FoldService([served])
        trace.reset()
        for rnd in range(3):
            await write(writer, 10, rnd)
            (res,) = await service.run_cycle()
            assert res.sealed and res.path == "batched"
        if which == "rcounter":
            assert counters().get("delta_device_cuts")
            assert not counters().get("delta_seal_divergence")
        trace.reset()
        (rq,) = await service.run_cycle()
        assert rq.path == "empty" and not rq.sealed
        assert counters().get("serve_noop_cycles") == 1
        solo = await Core.open(make_opts(storage_factory("solo"), adapter()))
        await solo.compact()
        assert solo.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)

    run(go())


def test_eviction_mid_continuation_falls_back_and_recovers(storage_factory):
    async def go():
        writers, served = [], []
        for t in range(2):
            writers.append(await Core.open(make_opts(storage_factory(f"w{t}"))))
            served.append(await Core.open(make_opts(storage_factory(f"s{t}"))))
        service = FoldService(served, ServeConfig(warm_bytes=64))
        for t in range(2):
            await _write_orset(writers[t], 20, b"t%d" % t)
        trace.reset()
        r = await service.run_cycle()
        assert all(x.sealed for x in r)
        assert counters().get("serve_warm_evictions")
        for t in range(2):
            await _write_orset(writers[t], 8, b"u%d" % t)
        trace.reset()
        r = await service.run_cycle()
        assert all(x.sealed for x in r)
        assert counters().get("serve_warm_misses")
        assert counters().get("delta_device_cuts", 0) <= 1
        assert not counters().get("delta_seal_divergence")
        for t in range(2):
            solo = await Core.open(make_opts(storage_factory(f"solo{t}")))
            await solo.compact()
            assert solo.with_state(canonical_bytes) == \
                served[t].with_state(canonical_bytes)

    run(go())


def test_mut_epoch_bump_mid_continuation_refolds(storage_factory):
    """A local apply between cycles bumps the epoch: the stamped warm
    entry is never served (``serve_warm_expired``), the tenant refolds
    from its state and no device cut is taken."""

    async def go():
        writer = await Core.open(make_opts(storage_factory("w")))
        served = await Core.open(make_opts(storage_factory("s")))
        service = FoldService([served])
        await _write_orset(writer, 20, b"a")
        (r1,) = await service.run_cycle()
        assert r1.sealed
        await served.apply_ops([served.with_state(
            lambda s: s.add_ctx(served.actor_id, b"local-op"))])
        await _write_orset(writer, 8, b"b")
        trace.reset()
        (r2,) = await service.run_cycle()
        assert r2.sealed
        assert counters().get("serve_warm_expired")
        assert not counters().get("delta_device_cuts")
        assert not counters().get("delta_seal_divergence")
        solo = await Core.open(make_opts(storage_factory("solo")))
        await solo.compact()
        assert solo.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)

    run(go())


def test_dropped_base_without_cut_reanchors_snapshot_only(storage_factory):
    """After a device cut dropped the base bytes, a cycle with no valid
    cut (a fresh service: nothing stamped) fabricates no delta: it counts
    ``delta_cut_fallbacks`` and ``delta_seal_skipped``, re-anchors with a
    snapshot-only link, and the next cycle deltas again; a consumer stays
    equal, and on fs the JAX package's fsck passes the remote."""

    async def go():
        writer = await Core.open(make_opts(storage_factory("w")))
        served = await Core.open(make_opts(storage_factory("s")))
        service = FoldService([served])
        await _write_orset(writer, 20, b"a")
        await service.run_cycle()
        await _write_orset(writer, 8, b"b")
        trace.reset()
        await service.run_cycle()
        assert counters().get("delta_device_cuts") == 1
        assert gauges().get("delta_base_bytes") == 0
        service2 = FoldService([served])
        await _write_orset(writer, 8, b"c")
        trace.reset()
        (r,) = await service2.run_cycle()
        assert r.sealed
        assert counters().get("delta_cut_fallbacks") == 1
        assert counters().get("delta_seal_skipped") == 1
        assert not counters().get("delta_files_sealed")
        await _write_orset(writer, 6, b"d")
        trace.reset()
        await service2.run_cycle()
        assert counters().get("delta_files_sealed") == 1
        consumer = await Core.open(make_opts(storage_factory("consumer")))
        await consumer.read_remote()
        assert consumer.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)
        if storage_factory.remote_dir is not None:
            report = await fsck_remote(
                JFsStorage(storage_factory.remote_dir + "-fsck-local",
                           storage_factory.remote_dir),
                JXChaChaCryptor(), JPlainKeyCryptor(), deep=True)
            assert report.ok, [str(i) for i in report.issues]

    run(go())


class SpyStorage(MemoryStorage):
    """Counts every storage call, split into listing probes and the rest
    (loads, stores, removes)."""

    LISTING = frozenset({
        "list_remote_meta_names", "list_state_names", "list_op_actors",
        "stat_ops", "list_delta_actors",
    })

    def __init__(self, remote):
        super().__init__(remote)
        self.calls: dict = {}

    def __getattribute__(self, name):
        attr = super().__getattribute__(name)
        if (not name.startswith("_") and callable(attr)
                and name != "calls"
                and asyncio.iscoroutinefunction(attr)):
            calls = super().__getattribute__("calls")

            async def counted(*a, **kw):
                calls[name] = calls.get(name, 0) + 1
                return await attr(*a, **kw)

            return counted
        return attr


def test_quiet_steady_state_cycle_is_listing_only():
    """A quiet tenant's steady-state cycle: zero library builds, zero
    bytes uploaded, zero storage calls beyond the listing probes, and
    one counted no-op per tenant."""

    async def go():
        tenants = 4
        spies, served = [], []
        for t in range(tenants):
            remote = MemoryRemote()
            writer = await Core.open(make_opts(MemoryStorage(remote)))
            await _write_orset(writer, 15, b"t%d" % t)
            spy = SpyStorage(remote)
            spies.append(spy)
            served.append(await Core.open(make_opts(spy)))
        service = FoldService(served)
        await service.run_cycle()
        await service.run_cycle()
        for spy in spies:
            spy.calls.clear()
        builds = obs_runtime.build_count()
        trace.reset()
        results = await service.run_cycle()
        assert all(r.path == "empty" and not r.sealed for r in results)
        c = counters()
        assert c.get("serve_noop_cycles") == tenants
        assert obs_runtime.build_count() == 0 <= builds
        assert not c.get("h2d_bytes")
        assert not c.get("delta_device_cuts")
        for spy in spies:
            beyond = {k: v for k, v in spy.calls.items()
                      if k not in SpyStorage.LISTING}
            assert not beyond, beyond

    run(go())


def test_quiet_tenant_reseals_once_its_state_moves():
    """A quiet tenant no-ops while its seal signature holds; a local
    apply moves the mutation epoch, and the next cycle seals it again,
    equal to a solo compact of the same remote."""
    async def go():
        remote = MemoryRemote()
        writer = await Core.open(make_opts(MemoryStorage(remote)))
        await _write_orset(writer, 15, b"a")
        served = await Core.open(make_opts(MemoryStorage(remote)))
        service = FoldService([served], ServeConfig())
        await service.run_cycle()
        trace.reset()
        (r,) = await service.run_cycle()
        assert r.path == "empty" and not r.sealed
        assert counters().get("serve_noop_cycles") == 1
        await served.apply_ops(
            [served.with_state(lambda s: s.add_ctx(served.actor_id, b"z"))])
        trace.reset()
        (r,) = await service.run_cycle()
        assert r.path == "empty" and r.sealed
        assert not counters().get("serve_noop_cycles")
        solo = await Core.open(make_opts(MemoryStorage(remote)))
        await solo.compact()
        assert solo.with_state(canonical_bytes) == \
            served.with_state(canonical_bytes)

    run(go())
