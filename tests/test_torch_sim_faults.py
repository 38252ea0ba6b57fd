"""The fault-tolerance regressions the simulator's fault layer targets,
twinned: each case of tests/test_sim_faults.py runs once through the JAX
package and once through the port (host reference, or
``TorchAccelerator(device="cpu")`` where the JAX case uses the device
fold), asserts the case's properties on both, and holds the port's
observations (cursors, membership, counter movements, fault decisions,
crash outcomes) equal to the JAX package's.

* ingest quarantine — a torn/unauthenticated synced file (op or state)
  is skipped with ``ingest_quarantined`` bumped and the cursor held, and
  a repaired sync retries it;
* fs concurrent-GC tolerance — files and whole actor dirs disappearing
  between list and load skip-and-resample instead of raising;
* the writer's own-history guard and the key re-mint guard;
* ``FaultyStorage`` itself — deterministic decisions, density preserved
  under censoring, clean passthrough after ``heal()``, crash before or
  after the write.
"""

from __future__ import annotations

import asyncio
import os
import types

import pytest


def package(name: str):
    """The names a scenario needs, from one package."""
    if name == "jax":
        import crdt_enc_tpu.backends as B
        import crdt_enc_tpu.backends.fs as fs_mod
        import crdt_enc_tpu.core as C
        import crdt_enc_tpu.sim as S
        from crdt_enc_tpu import native
        from crdt_enc_tpu.models import ORSet, canonical_bytes
        from crdt_enc_tpu.parallel import TpuAccelerator
        from crdt_enc_tpu.serve import FoldService, ServeConfig
        from crdt_enc_tpu.utils import trace

        host = C.HostAccelerator
        device = lambda: TpuAccelerator(min_device_batch=1)  # noqa: E731
    else:
        import crdt_enc_tpu_torch.backends as B
        import crdt_enc_tpu_torch.backends.fs as fs_mod
        import crdt_enc_tpu_torch.core.core as C
        import crdt_enc_tpu_torch.sim as S
        from crdt_enc_tpu_torch import native
        from crdt_enc_tpu_torch.core.adapters import HostAccelerator as host
        from crdt_enc_tpu_torch.models import ORSet, canonical_bytes
        from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
        from crdt_enc_tpu_torch.serve import FoldService, ServeConfig
        from crdt_enc_tpu_torch.utils import trace

        def device():
            return TorchAccelerator("cpu", min_device_batch=1)
    from crdt_enc_tpu_torch.core.adapters import orset_adapter as porset
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    adapter = (C.orset_adapter if name == "jax" else porset)
    ns = types.SimpleNamespace(
        name=name, Core=C.Core, OpenOptions=C.OpenOptions,
        MissingKeyError=C.MissingKeyError,
        StaleWriterError=C.StaleWriterError,
        IngestDecryptError=C.IngestDecryptError,
        MemoryRemote=B.MemoryRemote, MemoryStorage=B.MemoryStorage,
        FsStorage=B.FsStorage, IdentityCryptor=B.IdentityCryptor,
        PlainKeyCryptor=B.PlainKeyCryptor, XChaChaCryptor=B.XChaChaCryptor,
        fs_mod=fs_mod, native=native, ORSet=ORSet,
        canonical_bytes=canonical_bytes, trace=trace, device=device,
        FoldService=FoldService, ServeConfig=ServeConfig,
        FaultConfig=S.FaultConfig, FaultyStorage=S.FaultyStorage,
        SimCrash=S.SimCrash,
    )

    def make_opts(storage, *, create=True, accel=None, cryptor=None):
        return ns.OpenOptions(
            storage=storage,
            cryptor=cryptor if cryptor is not None else ns.IdentityCryptor(),
            key_cryptor=ns.PlainKeyCryptor(),
            adapter=adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1,
            create=create,
            accelerator=accel if accel is not None else host(),
        )

    ns.make_opts = make_opts
    ns.quarantined = lambda: int(
        trace.snapshot()["counters"].get("ingest_quarantined", 0))
    return ns


def twin(scenario, tmp_path=None):
    """Run ``scenario(ns[, tmp])`` for both packages; the port's
    observations must equal the JAX package's."""
    out = []
    for name in ("jax", "port"):
        P = package(name)
        args = (P,) if tmp_path is None else (P, tmp_path / name)
        out.append(asyncio.run(scenario(*args)))
    assert out[1] == out[0]
    return out[1]


# ------------------------------------------------------ op quarantine
@pytest.mark.parametrize("backend", ["memory", "fs"])
def test_torn_op_blob_quarantined_then_retried(tmp_path, backend):
    async def go(P, tmp):
        if backend == "memory":
            remote = P.MemoryRemote()
            sa, sb = P.MemoryStorage(remote), P.MemoryStorage(remote)
        else:
            sa = P.FsStorage(str(tmp / "a"), str(tmp / "remote"))
            sb = P.FsStorage(str(tmp / "b"), str(tmp / "remote"))
        a = await P.Core.open(P.make_opts(sa))
        for i in range(3):
            await a.update(lambda s, i=i: s.add_ctx(a.actor_id, f"m{i}"))
        actor = a.actor_id
        if backend == "memory":
            intact = remote.ops[actor][2]
            remote.ops[actor][2] = intact[:5]
        else:
            path = os.path.join(str(tmp / "remote"), "ops", actor.hex(), "2")
            intact = open(path, "rb").read()
            with open(path, "wb") as f:
                f.write(intact[:5])
        b = await P.Core.open(P.make_opts(sb))
        q0 = P.quarantined()
        await b.read_remote()  # must NOT raise
        moved = P.quarantined() > q0
        held = b.info().next_op_versions.get(actor)
        seen = (b.with_state(lambda s: s.contains("m0")),
                b.with_state(lambda s: s.contains("m1")))
        if backend == "memory":
            remote.ops[actor][2] = intact
        else:
            with open(path, "wb") as f:
                f.write(intact)
        await b.read_remote()
        after = b.info().next_op_versions.get(actor)
        same = b.with_state(P.canonical_bytes) == a.with_state(
            P.canonical_bytes)
        return moved, held, seen, after, same

    assert twin(go, tmp_path) == (True, 1, (True, False), 3, True)


def test_torn_op_blob_quarantined_pipelined(tmp_path):
    """Through the device replica's pipelined ingest (producer-side
    unwrap quarantine and chunk validation)."""

    async def go(P, tmp):
        sa = P.FsStorage(str(tmp / "a"), str(tmp / "remote"))
        sb = P.FsStorage(str(tmp / "b"), str(tmp / "remote"))
        a = await P.Core.open(P.make_opts(sa))
        for i in range(20):
            await a.update(lambda s, i=i: s.add_ctx(a.actor_id, f"m{i}"))
        actor = a.actor_id
        path = os.path.join(str(tmp / "remote"), "ops", actor.hex(), "10")
        intact = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(intact[: len(intact) // 3])
        b = await P.Core.open(P.make_opts(sb, accel=P.device()))
        q0 = P.quarantined()
        await b.read_remote()
        moved = P.quarantined() > q0
        held = b.info().next_op_versions.get(actor)
        with open(path, "wb") as f:
            f.write(intact)
        await b.read_remote()
        return (moved, held, b.info().next_op_versions.get(actor),
                b.with_state(P.canonical_bytes)
                == a.with_state(P.canonical_bytes))

    assert twin(go, tmp_path) == (True, 9, 20, True)


def test_torn_snapshot_quarantined_then_retried():
    async def go(P):
        remote = P.MemoryRemote()
        a = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        await a.update(lambda s: s.add_ctx(a.actor_id, "x"))
        await a.compact()
        (name, intact), = list(remote.states.items())
        remote.states[name] = intact[:7]
        b = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        q0 = P.quarantined()
        await b.read_remote()
        first = (P.quarantined() > q0, b.with_state(lambda s: s.contains("x")),
                 name in b.info().read_states)
        remote.states[name] = intact
        await b.read_remote()
        return first, b.with_state(P.canonical_bytes) == a.with_state(
            P.canonical_bytes)

    assert twin(go) == ((True, False, False), True)


def test_tampered_aead_op_quarantined():
    async def go(P):
        P.native.load()
        remote = P.MemoryRemote()
        a = await P.Core.open(P.make_opts(P.MemoryStorage(remote),
                                          cryptor=P.XChaChaCryptor()))
        await a.update(lambda s: s.add_ctx(a.actor_id, "good"))
        await a.update(lambda s: s.add_ctx(a.actor_id, "alsogood"))
        actor = a.actor_id
        blob = bytearray(remote.ops[actor][1])
        blob[-1] ^= 1  # break the tag
        remote.ops[actor][1] = bytes(blob)
        b = await P.Core.open(P.make_opts(P.MemoryStorage(remote),
                                          cryptor=P.XChaChaCryptor()))
        q0 = P.quarantined()
        await b.read_remote()
        return (P.quarantined() > q0, b.info().next_op_versions.get(actor),
                b.with_state(lambda s: s.contains("good")))

    assert twin(go) == (True, 0, False)


def test_unknown_key_still_loud():
    async def go(P):
        ra, rb = P.MemoryRemote(), P.MemoryRemote()
        ca = await P.Core.open(P.make_opts(P.MemoryStorage(ra)))
        cb = await P.Core.open(P.make_opts(P.MemoryStorage(rb)))
        await cb.update(lambda s: s.add_ctx(cb.actor_id, "m"))
        for actor, log in rb.ops.items():
            ra.ops.setdefault(actor, {}).update(log)
        with pytest.raises(P.MissingKeyError):
            await ca.read_remote()
        return "loud"

    assert twin(go) == "loud"


def test_service_quarantines_torn_tenant_file():
    async def go(P):
        remote = P.MemoryRemote()
        a = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        await a.update(lambda s: s.add_ctx(a.actor_id, "k"))
        await a.update(lambda s: s.add_ctx(a.actor_id, "k2"))
        actor = a.actor_id
        intact = remote.ops[actor][1]
        remote.ops[actor][1] = intact[:4]
        b = await P.Core.open(P.make_opts(P.MemoryStorage(remote),
                                          accel=P.device()))
        service = P.FoldService([b], P.ServeConfig())
        q0 = P.quarantined()
        (res,) = await service.run_cycle()
        first = (res.error, P.quarantined() > q0,
                 b.info().next_op_versions.get(actor))
        remote.ops[actor][1] = intact
        (res,) = await service.run_cycle()
        service.close()
        return first, (res.error, b.info().next_op_versions.get(actor),
                       b.with_state(P.canonical_bytes)
                       == a.with_state(P.canonical_bytes))

    assert twin(go) == ((None, True, 0), (None, 2, True))


# ------------------------------------------------ writer dot-reuse guard
def test_reopened_producer_relearns_own_history():
    async def go(P):
        remote = P.MemoryRemote()
        storage = P.MemoryStorage(remote)
        a = await P.Core.open(P.make_opts(storage))
        await a.update(lambda s: s.add_ctx(a.actor_id, "pre-crash"))
        b = await P.Core.open(P.make_opts(storage, create=False))
        await b.update(lambda s: s.add_ctx(b.actor_id, "post-reopen"))
        reader = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        await reader.read_remote()
        return (b.with_state(lambda s: s.contains("pre-crash")),
                b.with_state(lambda s: s.contains("post-reopen")),
                reader.with_state(P.canonical_bytes)
                == b.with_state(P.canonical_bytes))

    assert twin(go) == (True, True, True)


def test_reopened_producer_refuses_write_when_history_hidden():
    async def go(P):
        class BlindStorage(P.MemoryStorage):
            async def list_op_actors(self):
                return []

            async def list_state_names(self):
                return []

            async def load_ops(self, wanted):
                return []

            async def stat_ops(self, wanted):
                return []

        remote = P.MemoryRemote()
        storage = P.MemoryStorage(remote)
        a = await P.Core.open(P.make_opts(storage))
        await a.update(lambda s: s.add_ctx(a.actor_id, "pre-crash"))
        blind = BlindStorage(remote)
        blind._local_meta = storage._local_meta  # same replica identity
        b = await P.Core.open(P.make_opts(blind, create=False))
        with pytest.raises(P.StaleWriterError):
            await b.update(lambda s: s.add_ctx(b.actor_id, "unsafe"))
        return "refused"

    assert twin(go) == "refused"


def test_reopen_refuses_key_remint_when_meta_hidden():
    async def go(P):
        class MetaBlindStorage(P.MemoryStorage):
            async def list_remote_meta_names(self):
                return []

        remote = P.MemoryRemote()
        storage = P.MemoryStorage(remote)
        a = await P.Core.open(P.make_opts(storage))
        await a.update(lambda s: s.add_ctx(a.actor_id, "sealed-pre-crash"))
        key_id = a._data.keys.latest_key().id
        blind = MetaBlindStorage(remote)
        blind._local_meta = storage._local_meta
        with pytest.raises(P.MissingKeyError):
            await P.Core.open(P.make_opts(blind, create=False))
        b = await P.Core.open(P.make_opts(storage, create=False))
        same_key = b._data.keys.latest_key().id == key_id
        await b.read_remote()
        reader = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        await reader.read_remote()
        return (same_key, b.with_state(lambda s: s.contains(
            "sealed-pre-crash")), reader.with_state(P.canonical_bytes)
            == b.with_state(P.canonical_bytes))

    assert twin(go) == (True, True, True)


# -------------------------------------------------- fs concurrent-GC races
def test_fs_reader_survives_real_concurrent_gc(tmp_path):
    async def go(P, tmp):
        class RacingStorage(P.FsStorage):
            race = None

            async def load_states(self, names):
                if RacingStorage.race is not None:
                    cb, RacingStorage.race = RacingStorage.race, None
                    await cb()
                return await super().load_states(names)

            async def load_ops(self, wanted):
                if RacingStorage.race is not None:
                    cb, RacingStorage.race = RacingStorage.race, None
                    await cb()
                return await super().load_ops(wanted)

        remote = str(tmp / "remote")
        a = await P.Core.open(P.make_opts(P.FsStorage(str(tmp / "a"),
                                                      remote)))
        for i in range(3):
            await a.update(lambda s, i=i: s.add_ctx(a.actor_id, f"m{i}"))
        await a.compact()
        await a.update(lambda s: s.add_ctx(a.actor_id, "tail"))
        b = await P.Core.open(P.make_opts(RacingStorage(str(tmp / "b"),
                                                        remote)))

        async def gc():
            await a.compact()

        RacingStorage.race = gc
        await b.read_remote()  # must not raise
        await b.read_remote()
        return b.with_state(P.canonical_bytes) == a.with_state(
            P.canonical_bytes)

    assert twin(go, tmp_path) is True


def test_fs_publish_survives_actor_dir_rmdir(tmp_path, monkeypatch):
    import shutil

    def go(P, tmp):
        d = str(tmp / "ops" / "aa")
        target = os.path.join(d, "1")
        real_write_tmp = P.fs_mod._write_tmp
        calls = {"n": 0}

        def racing_write_tmp(dd, data):
            calls["n"] += 1
            if calls["n"] == 1:
                shutil.rmtree(dd)
                raise FileNotFoundError(dd)
            return real_write_tmp(dd, data)

        with monkeypatch.context() as m:
            m.setattr(P.fs_mod, "_write_tmp", racing_write_tmp)
            P.fs_mod._write_file_new(target, b"payload")
        return open(target, "rb").read(), calls["n"]

    out = [go(package(n), tmp_path / n) for n in ("jax", "port")]
    assert out[1] == out[0] == (b"payload", 2)


@pytest.mark.parametrize("relink", [True, False],
                         ids=["content_addressed", "op_version"])
def test_fs_publish_vanishing_collider(tmp_path, monkeypatch, relink):
    """os.link says EEXIST but the collider is gone before the check: a
    content-addressed store relinks; a version-addressed op file burns
    the version (FileExistsError) instead of republishing."""

    def go(P, tmp):
        d = str(tmp / "x")
        target = os.path.join(d, "1")
        real_link = os.link
        calls = {"n": 0}

        def racing_link(src, dst, **kw):
            calls["n"] += 1
            if calls["n"] == 1:
                raise FileExistsError(dst)
            return real_link(src, dst, **kw)

        with monkeypatch.context() as m:
            m.setattr(P.fs_mod.os, "link", racing_link)
            try:
                P.fs_mod._write_file_new(
                    target, b"blob", relink_vanished_collider=relink)
                outcome = open(target, "rb").read()
            except FileExistsError:
                outcome = ("burned", os.path.exists(target))
        return outcome, calls["n"]

    out = [go(package(n), tmp_path / n) for n in ("jax", "port")]
    assert out[1] == out[0]
    assert out[1] == ((b"blob", 2) if relink else (("burned", False), 1))


def test_systemic_decrypt_failure_escalates_not_quarantines():
    async def go(P):
        remote = P.MemoryRemote()
        a = await P.Core.open(P.make_opts(P.MemoryStorage(remote)))
        await a.update(lambda s: s.add_ctx(a.actor_id, "x"))
        await a.update(lambda s: s.add_ctx(a.actor_id, "y"))

        class DeadCryptor(P.IdentityCryptor):
            async def decrypt(self, key, data):
                raise RuntimeError("cryptor backend is broken")

        b = await P.Core.open(P.make_opts(P.MemoryStorage(remote),
                                          cryptor=DeadCryptor()))
        with pytest.raises(P.IngestDecryptError) as ei:
            await b.read_remote()
        return ("backend is broken" in repr(ei.value.__cause__),
                b.info().next_op_versions.get(a.actor_id))

    assert twin(go) == (True, 0)


def test_own_tail_probe_failure_retries_next_write():
    async def go(P):
        class FlakyStatStorage(P.MemoryStorage):
            stat_calls = 0
            fail_next = False

            async def stat_ops(self, wanted):
                type(self).stat_calls += 1
                if type(self).fail_next:
                    type(self).fail_next = False
                    raise OSError("transient storage error")
                return await super().stat_ops(wanted)

        storage = FlakyStatStorage(P.MemoryRemote())
        c = await P.Core.open(P.make_opts(storage))
        base = FlakyStatStorage.stat_calls
        FlakyStatStorage.fail_next = True
        await c.update(lambda s: s.add_ctx(c.actor_id, "m1"))
        first = FlakyStatStorage.stat_calls
        await c.update(lambda s: s.add_ctx(c.actor_id, "m2"))
        second = FlakyStatStorage.stat_calls
        await c.update(lambda s: s.add_ctx(c.actor_id, "m3"))
        return (first - base, second - first,
                FlakyStatStorage.stat_calls - second)

    moves = twin(go)
    assert moves[0] > 0 and moves[1] > 0 and moves[2] == 0


# ------------------------------------------------- FaultyStorage itself
def test_faulty_storage_deterministic_and_heals():
    async def go(P):
        remote = P.MemoryRemote()
        writer = P.MemoryStorage(remote)
        actor = b"\x01" * 16
        for v in range(1, 9):
            await writer.store_ops(actor, v, f"payload-{v}".encode() * 4)

        def wrap():
            return P.FaultyStorage(
                P.MemoryStorage(remote),
                P.FaultConfig(torn_read=0.5, partial_list=0.3),
                seed=7, name="r0")

        async def observe(w):
            out = []
            for _ in range(4):
                out.append(await w.load_ops([(actor, 1)]))
                out.append(await w.list_op_actors())
            return out

        a = await observe(wrap())
        assert a == await observe(wrap())
        w = wrap()
        w.heal()
        clean = await w.load_ops([(actor, 1)])
        assert clean == await writer.load_ops([(actor, 1)])
        return a

    twin(go)


def test_faulty_storage_censor_preserves_density():
    async def go(P):
        remote = P.MemoryRemote()
        writer = P.MemoryStorage(remote)
        actors = [b"\x01" * 16, b"\x02" * 16]
        for actor in actors:
            for v in range(1, 6):
                await writer.store_ops(actor, v, b"x" * 8)
        w = P.FaultyStorage(
            P.MemoryStorage(remote),
            P.FaultConfig(delay_visibility=0.9, delay_max_ticks=2),
            seed=3, name="r1")
        rounds = []
        for _ in range(6):
            files = await w.load_ops([(a, 1) for a in actors])
            per_actor: dict = {}
            for actor, version, _ in files:
                per_actor.setdefault(actor, []).append(version)
            for versions in per_actor.values():
                assert versions == list(range(1, len(versions) + 1))
            rounds.append(sorted(per_actor.items()))
            w.tick()
        assert len(await w.load_ops([(a, 1) for a in actors])) == 10
        return rounds, dict(w.stats)

    twin(go)


def test_faulty_storage_write_crash_before_or_after():
    async def go(P):
        outcomes = []
        actor = b"\x03" * 16
        for seed in range(40):
            remote = P.MemoryRemote()
            w = P.FaultyStorage(
                P.MemoryStorage(remote),
                P.FaultConfig(write_crash=1.0, delay_visibility=1.0),
                seed=seed, name="r0")
            with pytest.raises(P.SimCrash):
                await w.store_ops(actor, 1, b"data")
            if remote.ops:
                w.cfg = P.FaultConfig(delay_visibility=1.0)  # crashes off
                files = await w.load_ops([(actor, 1)])
                assert [v for _, v, _ in files] == [1], "own write hidden"
                outcomes.append("after")
            else:
                outcomes.append("before")
        return outcomes

    outcomes = twin(go)
    assert "before" in outcomes and "after" in outcomes


def test_faulty_storage_covers_the_ports_storage_surface():
    """Every method of the port's ``Storage`` that the core, the service
    and the daemon call is overridden by ``FaultyStorage`` (no base-class
    fallback that would skip the fault layer or its inner storage)."""
    from crdt_enc_tpu_torch.core.storage import Storage
    from crdt_enc_tpu_torch.sim import FaultyStorage

    methods = {n for n, v in vars(Storage).items()
               if callable(v) and not n.startswith("__")}
    missing = sorted(n for n in methods if n not in vars(FaultyStorage))
    assert missing == []
    assert "has_deltas" in vars(FaultyStorage)
