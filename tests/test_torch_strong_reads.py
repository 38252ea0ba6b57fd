"""Strong reads of the port's ``Core`` on the CPU: the stable prefix,
``read(linearizable=True)``, ``await_stable``, the membership policy and
the checkpoint's ``sp`` slot.

The applicable cases of tests/test_strong_reads.py, run on the port with
``XChaChaCryptor`` and ``TorchAccelerator(device="cpu",
min_device_batch=1)``.  The oracle is the JAX package's
``crdt_enc_tpu.sim.linearize.check_strong_read`` (imported by this test
only): every strong read must equal the host fold of exactly the op
prefix its cursor names, never regress within an incarnation, and cover
what a successful ``await_stable`` promised.  The membership policy is
held against the JAX one on the same observations, and a checkpoint's
``sp`` slot opens warm across the packages both ways.
"""

from __future__ import annotations

import asyncio

import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.read import MembershipPolicy as JMembershipPolicy
from crdt_enc_tpu.sim.linearize import check_strong_read
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
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.read import MembershipPolicy, StalenessError
from crdt_enc_tpu_torch.serve import FoldService, ServeConfig
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


def run(coro):
    return asyncio.run(coro)


def make_opts(storage, adapter=None, **kw):
    kw.setdefault("create", True)
    kw.setdefault("accelerator", TorchAccelerator(device="cpu",
                                                  min_device_batch=1))
    return OpenOptions(
        storage=storage,
        cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=adapter if adapter is not None else orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        **kw,
    )


def jopts(storage, **kw):
    kw.setdefault("create", True)
    return JOpenOptions(
        storage=storage,
        cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(),
        adapter=jadapters.orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        accelerator=jadapters.HostAccelerator(),
        **kw,
    )


async def _write(core, member, oplog=None):
    """One add through the writer path, its plaintext recorded for the
    oracle."""
    ops = await core.update(lambda s: s.add_ctx(core.actor_id, member))
    if oplog is not None:
        oplog[(core.actor_id, core._local_meta.last_op_version)] = [
            op.to_obj() for op in ops
        ]
    return ops


# ---- membership policy, against the JAX one --------------------------------

A = b"\xaa" * 16
B = b"\xbb" * 16
C = b"\xcc" * 16


def _both(fn):
    """Run one policy scenario on both packages' policy and clock types;
    return both results."""
    return (fn(MembershipPolicy, VClock), fn(JMembershipPolicy, JVClock))


def test_policy_expected_pins_the_denominator():
    def scenario(Policy, VC):
        pol = Policy(expected=[B])
        return (
            pol.denominator(A, {}, VC({A: 3, C: 5})),
            pol.observe(A, {}, VC({A: 3, C: 5})),
            C in pol.denominator(A, {C: VC({C: 5})}, VC({C: 5})),
            pol.summary(),
        )

    port, jax = _both(scenario)
    assert port == jax
    assert port[0] == port[1] == {A, B} and not port[2]


def test_policy_silence_quarantine_and_revival():
    def scenario(Policy, VC):
        pol = Policy(silent_after=2)
        union = VC({A: 1, B: 1})
        row = {B: VC({B: 1})}
        seen = []
        for _ in range(4):
            seen.append(pol.observe(A, row, union))
        excluded = pol.excluded
        summary = pol.summary()
        revived = pol.observe(A, {B: VC({B: 2})}, union)
        return seen, excluded, summary, revived, pol.excluded

    port, jax = _both(scenario)
    assert port == jax
    seen, excluded, summary, revived, after = port
    assert B not in seen[-1] and excluded == frozenset({B})
    assert summary["excluded"] == [B.hex()]
    assert B in revived and A in revived and after == frozenset()


def test_policy_off_by_default_is_the_observed_denominator():
    def scenario(Policy, VC):
        pol = Policy()
        return (pol.observe(A, {B: VC({B: 1})}, VC({A: 1, B: 1, C: 2})),
                pol.summary())

    port, jax = _both(scenario)
    assert port == jax
    assert port[0] == {A, B, C}
    assert port[1] == {"expected": None, "silent_after": 0, "excluded": []}


# ---- the stable prefix: exactness, taxonomy, waits -------------------------


def test_strong_read_exact_oracle_fold_memory():
    async def scenario():
        remote = MemoryRemote()
        a = await Core.open(make_opts(MemoryStorage(remote)))
        b = await Core.open(make_opts(MemoryStorage(remote)))
        oplog: dict = {}
        await _write(a, b"x", oplog)
        await _write(b, b"y", oplog)
        await a.compact()  # publishes a's cursor (covers b's op)
        res = await b.read(linearizable=True)
        assert res.consistency == "strong"
        assert check_strong_read(oplog, res, None) is None
        res2 = await b.read(linearizable=True)
        assert check_strong_read(oplog, res2, res.cursor) is None
        ev = await b.read()
        assert ev.consistency == "eventual" and ev.view is None
        assert await b.contains(b"x", linearizable=True)
        assert await b.contains(b"y", linearizable=True)
        assert not await b.contains(b"zzz", linearizable=True)

    run(scenario())


def test_strong_read_exact_oracle_fold_fs(tmp_path):
    async def scenario():
        remote = str(tmp_path / "remote")
        a = await Core.open(make_opts(FsStorage(str(tmp_path / "a"), remote)))
        b = await Core.open(make_opts(FsStorage(str(tmp_path / "b"), remote)))
        oplog: dict = {}
        for m in (b"x", b"y", b"z"):
            await _write(a, m, oplog)
        await _write(b, b"w", oplog)
        await a.compact()
        res = await b.read(linearizable=True)
        assert check_strong_read(oplog, res, None) is None
        assert sorted(b._strong().state.members()) == [
            b"w", b"x", b"y", b"z",
        ]

    run(scenario())


def test_refusal_taxonomy_uncovered_target_and_lag():
    async def scenario():
        remote = MemoryRemote()
        a = await Core.open(make_opts(MemoryStorage(remote)))
        b = await Core.open(make_opts(MemoryStorage(remote)))
        await _write(a, b"x")
        await _write(b, b"y")  # unpublished: holds the watermark back
        await b.read_remote()
        with pytest.raises(StalenessError) as ei:
            await b.read(linearizable=True,
                         min_cursor=VClock({b.actor_id: 1}))
        assert ei.value.reason == "uncovered_target"
        with pytest.raises(StalenessError) as ei:
            await b.read(linearizable=True, max_lag=0)
        assert ei.value.reason == "lag_exceeded"
        assert ei.value.status["holdouts"]
        trace.reset()
        with pytest.raises(StalenessError):
            await b.read(linearizable=True, max_lag=0)
        snap = trace.snapshot()
        assert snap["counters"]["read_strong_refusals"] == 1
        assert snap["counters"]["read_strong_total"] == 1

    run(scenario())


def test_eventual_read_rejects_strong_only_constraints():
    async def scenario():
        core = await Core.open(make_opts(MemoryStorage(MemoryRemote())))
        with pytest.raises(ValueError):
            await core.read(max_lag=3)
        with pytest.raises(ValueError):
            await core.read(min_cursor=VClock())

    run(scenario())


def test_await_stable_read_your_writes_and_timeout():
    async def scenario():
        remote = MemoryRemote()
        a = await Core.open(make_opts(MemoryStorage(remote)))
        b = await Core.open(make_opts(MemoryStorage(remote)))
        oplog: dict = {}
        await _write(a, b"theirs", oplog)
        await _write(b, b"mine", oplog)
        await b.read_remote()
        target = VClock({b.actor_id: 1})
        ticks = [0.0]

        def clock():
            ticks[0] += 1.0
            return ticks[0]

        with pytest.raises(StalenessError) as ei:
            await b.await_stable(target, timeout_s=3, clock=clock,
                                 poll_interval_s=0.0)
        assert ei.value.reason == "timeout"
        await a.compact()
        view = await b.await_stable(target, timeout_s=5, poll_interval_s=0.0)
        assert view.covers(target)
        res = await b.read(linearizable=True, min_cursor=target)
        assert check_strong_read(oplog, res, None, ryw_target=target) is None

    run(scenario())


def test_gc_gap_wedges_then_recovers_via_stable_snapshot():
    async def scenario():
        remote = MemoryRemote()
        a = await Core.open(make_opts(MemoryStorage(remote)))
        b = await Core.open(make_opts(MemoryStorage(remote)))
        reader = await Core.open(make_opts(MemoryStorage(remote)))
        oplog: dict = {}
        await _write(a, b"x", oplog)
        r0 = await reader.read(linearizable=True)
        assert r0.cursor.get(a.actor_id) == 1
        await _write(b, b"y", oplog)
        await _write(a, b"z", oplog)
        await a.compact()
        r1 = await reader.read(linearizable=True)
        assert r1.cursor.get(a.actor_id) >= r0.cursor.get(a.actor_id)
        assert r1.view.wedged.get(b.actor_id.hex()) == "gc_gap"
        assert r1.view.lag > 0
        await b.compact()
        r2 = await reader.read(linearizable=True)
        assert r2.view.wedged == {}
        assert check_strong_read(oplog, r2, r1.cursor) is None
        assert sorted(reader._strong().state.members()) == [
            b"x", b"y", b"z",
        ]

    run(scenario())


def test_prefix_survives_warm_reopen_and_rebuilds_cold(tmp_path):
    async def scenario():
        remote = str(tmp_path / "remote")
        local = str(tmp_path / "dev")
        a = await Core.open(make_opts(FsStorage(local, remote)))
        oplog: dict = {}
        for m in (b"p", b"q"):
            await _write(a, m, oplog)
        res = await a.read(linearizable=True)
        await a.compact()  # reseals the checkpoint with the sp slot
        frontier = a._strong().cursor.copy()
        warm = await Core.open(
            make_opts(FsStorage(local, remote), create=False))
        assert warm.opened_from_checkpoint
        assert warm._stable is not None
        assert warm._stable.cursor == frontier
        res_w = await warm.read(linearizable=True)
        assert check_strong_read(oplog, res_w, res.cursor) is None
        cold = await Core.open(make_opts(FsStorage(local, remote),
                                         create=False, checkpoint=False))
        assert cold._stable is None
        res_c = await cold.read(linearizable=True)
        assert canonical_bytes(ORSet.from_obj(res_c.obj)) == \
            canonical_bytes(ORSet.from_obj(res_w.obj))

    run(scenario())


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_stable_prefix_slot_opens_warm_across_packages(tmp_path, sealer):
    """A checkpoint sealed by either package carries the ``sp`` slot the
    other restores: the same frontier and the same stable state."""

    async def scenario():
        remote = str(tmp_path / "remote")
        local = str(tmp_path / "dev")
        if sealer == "jax":
            w = await JCore.open(jopts(JFsStorage(local, remote)))
        else:
            w = await Core.open(make_opts(FsStorage(local, remote)))
        for m in (b"p", b"q", b"r"):
            await w.update(lambda s, m=m: s.add_ctx(w.actor_id, m))
        await w.read(linearizable=True)
        await w.compact()
        frontier = {a: c for a, c in w._strong().cursor.counters.items()}
        stable_bytes = w._strong().state.to_obj()
        if sealer == "jax":
            r = await Core.open(make_opts(FsStorage(local, remote),
                                          create=False))
        else:
            r = await JCore.open(jopts(JFsStorage(local, remote),
                                       create=False))
        assert r.opened_from_checkpoint
        assert r._stable is not None
        assert dict(r._stable.cursor.counters) == frontier
        assert r._stable.state.to_obj() == stable_bytes
        res = await r.read(linearizable=True)
        assert res.consistency == "strong"
        assert sorted(ORSet.from_obj(res.obj).members()) == [
            b"p", b"q", b"r"]

    run(scenario())


def test_value_lookup_on_counter_and_type_refusal():
    async def scenario():
        g = await Core.open(make_opts(MemoryStorage(MemoryRemote()),
                                      adapter=gcounter_adapter()))
        await g.update(lambda s: s.inc(g.actor_id))
        await g.update(lambda s: s.inc(g.actor_id))
        assert await g.value() == 2
        assert await g.value(linearizable=True) == 2
        with pytest.raises(TypeError):
            await g.contains(b"x")

    run(scenario())


def test_watermark_collapse_then_recover_with_stale_checkpoint(tmp_path):
    """Membership growth collapses the watermark (a newly heard-from
    replica drags the min down) and a stale-checkpoint reopen replays
    through the collapse: the exposed frontier never regresses, and
    recovery converges byte-exactly."""

    async def scenario():
        remote = str(tmp_path / "remote")
        rdr_local = str(tmp_path / "reader")
        oplog: dict = {}
        a = await Core.open(make_opts(FsStorage(str(tmp_path / "a"), remote)))
        reader = await Core.open(make_opts(FsStorage(rdr_local, remote)))
        for m in (b"one", b"two"):
            await _write(a, m, oplog)
        r1 = await reader.read(linearizable=True)
        assert r1.cursor.get(a.actor_id) == 2
        await reader.save_checkpoint()
        b = await Core.open(make_opts(FsStorage(str(tmp_path / "b"), remote)))
        await _write(b, b"three", oplog)
        await _write(a, b"four", oplog)
        r2 = await reader.read(linearizable=True)
        assert r2.view.watermark.get(a.actor_id, 0) < 4
        assert check_strong_read(oplog, r2, r1.cursor) is None
        await a.compact()
        await reader.read_remote()
        await b.compact()
        r3 = await reader.read(linearizable=True)
        assert check_strong_read(oplog, r3, r2.cursor) is None
        assert r3.cursor.get(a.actor_id) == 3
        assert sorted(reader._strong().state.members()) == [
            b"four", b"one", b"three", b"two",
        ]
        stale = await Core.open(
            make_opts(FsStorage(rdr_local, remote), create=False))
        restored = (stale._stable.cursor.copy()
                    if stale._stable is not None else VClock())
        rs0 = await stale.read(linearizable=True)
        assert check_strong_read(oplog, rs0, restored) is None
        await a.compact()
        rs = await stale.read(linearizable=True)
        assert check_strong_read(oplog, rs, rs0.cursor) is None
        assert canonical_bytes(ORSet.from_obj(rs.obj)) == \
            canonical_bytes(ORSet.from_obj(r3.obj))

    run(scenario())


def test_strong_read_matches_the_jax_core_on_one_remote(tmp_path):
    """The port's and the JAX package's strong reads of one remote (two
    producers, one publishing) return the same cursor and value."""

    async def scenario():
        remote = str(tmp_path / "remote")
        a = await Core.open(make_opts(FsStorage(str(tmp_path / "a"), remote)))
        b = await JCore.open(jopts(JFsStorage(str(tmp_path / "b"), remote)))
        for m in (b"u", b"v"):
            await _write(a, m)
        await b.update(lambda s: s.add_ctx(b.actor_id, b"w"))
        await a.compact()
        port_reader = await Core.open(
            make_opts(FsStorage(str(tmp_path / "pr"), remote)))
        jax_reader = await JCore.open(
            jopts(JFsStorage(str(tmp_path / "jr"), remote)))
        pres = await port_reader.read(linearizable=True)
        jres = await jax_reader.read(linearizable=True)
        assert dict(pres.cursor.counters) == dict(jres.cursor.counters)
        assert pres.obj == jres.obj
        assert pres.view.lag == jres.view.lag
        assert pres.view.holdouts == jres.view.holdouts

    run(scenario())


# ---- serving layer ---------------------------------------------------------


def test_fold_service_strong_read_matches_core():
    async def scenario():
        remote = MemoryRemote()
        tenant = await Core.open(make_opts(MemoryStorage(remote)))
        writer = await Core.open(make_opts(MemoryStorage(remote)))
        oplog: dict = {}
        await _write(writer, b"served", oplog)
        service = FoldService([tenant], ServeConfig())
        await service.run_cycle()
        trace.reset()
        res = await service.read_strong(tenant, refresh=False)
        assert trace.snapshot()["counters"]["serve_strong_reads"] == 1
        assert check_strong_read(oplog, res, None) is None
        with pytest.raises(StalenessError):
            await service.read_strong(
                tenant, min_cursor=VClock({b"\x01" * 16: 9}))
        service.close()
        with pytest.raises(RuntimeError):
            await service.read_strong(tenant)

    run(scenario())
