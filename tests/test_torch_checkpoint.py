"""Warm-open fold checkpoints of the port's ``Core``, on the CPU.

The local checkpoint is a cache, never a source of truth: a verified
checkpoint restores a state byte-identical to a cold refold, for each of
the port's four adapters (ORSet, G-Counter, PN-Counter, LWW map) on memory
and fs storage, and any doubt (a torn file, a rotated key, a wiped remote,
another adapter) falls back to the cold path with the reason recorded.
Ports the applicable cases of tests/test_checkpoint.py, and adds
cross-package warm opens both ways: a checkpoint sealed by the JAX
``Core`` opens warm in the port's, and the reverse, with equal canonical
state bytes.

Every port accelerator here is ``TorchAccelerator(device="cpu",
min_device_batch=1)``: the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import random
import shutil

import numpy as np
import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import LWWOp as JLWWOp
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.ops import columnar as JC
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    LWWOp,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    gcounter_adapter,
    lwwmap_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.core import core as core_mod
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.ops import columnar as C
from crdt_enc_tpu_torch.utils import codec, trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


def run(coro):
    return asyncio.run(coro)


def make_opts(storage, adapter, create=True, **kw):
    kw.setdefault("accelerator", TorchAccelerator(device="cpu",
                                                  min_device_batch=1))
    return OpenOptions(
        storage=storage,
        cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        **kw,
    )


@pytest.fixture(params=["memory", "fs"])
def storage_factory(request, tmp_path):
    """name -> Storage factories sharing one remote; the same name gives
    the same local state (the warm-open identity)."""
    if request.param == "memory":
        remote = MemoryRemote()
        instances: dict = {}

        def make(name="a"):
            return instances.setdefault(name, MemoryStorage(remote))

        return make

    def make(name="a"):
        return FsStorage(str(tmp_path / f"local-{name}"),
                         str(tmp_path / "remote"))

    return make


# ---- the checkpoint codec -----------------------------------------------


def random_orset(seed=7):
    rng = random.Random(seed)
    actors = [bytes([i]) * 16 for i in range(12)]
    s = ORSet()
    for _ in range(1500):
        a = rng.choice(actors)
        m = rng.choice([b"b", 3, "s", (1, "t"), rng.randrange(40)])
        s.apply(AddOp(m, s.clock.inc(a)))
        if rng.random() < 0.25 and s.entries:
            m2 = rng.choice(list(s.entries))
            s.apply(RmOp(m2, VClock(dict(s.entries[m2]))))
    s.apply(RmOp(b"ahead", VClock({b"z" * 16: 9})))  # a deferred horizon
    return s


def test_columnar_checkpoint_roundtrip_randomized():
    """Pack → wire → unpack keeps the bytes, and the payload crosses the
    packages both ways."""
    s = random_orset()
    packed = C.orset_pack_checkpoint(s)
    wire = codec.unpack(codec.pack(packed))
    assert canonical_bytes(C.orset_unpack_checkpoint(wire)) == canonical_bytes(s)
    assert codec.pack(packed) == jcodec.pack(
        JC.orset_pack_checkpoint(JC.orset_unpack_checkpoint(wire)))
    assert j_canonical_bytes(JC.orset_unpack_checkpoint(wire)) == canonical_bytes(s)


def test_columnar_checkpoint_empty_and_overflow():
    empty = C.orset_unpack_checkpoint(
        codec.unpack(codec.pack(C.orset_pack_checkpoint(ORSet()))))
    assert canonical_bytes(empty) == canonical_bytes(ORSet())
    big = ORSet()
    big.clock.counters[b"a" * 16] = 2**70  # outside int64
    assert C.orset_pack_checkpoint(big) is None  # the object format takes over


# ---- warm open == cold open, across adapters -------------------------------


def _ops_orset(core, i):
    if i % 5 == 4:
        return core.with_state(lambda s: s.rm_ctx(b"m%d" % (i % 7)))
    return core.with_state(lambda s: s.add_ctx(core.actor_id, b"m%d" % (i % 7)))


def _ops_gcounter(core, i):
    return core.with_state(lambda s: s.inc(core.actor_id, 1 + i % 3))


def _ops_pncounter(core, i):
    if i % 3 == 2:
        return core.with_state(lambda s: s.dec(core.actor_id))
    return core.with_state(lambda s: s.inc(core.actor_id))


def _ops_lwwmap(core, i):
    return LWWOp(b"k%d" % (i % 4), 1000 + i, core.actor_id, b"v%d" % i)


ADAPTER_CASES = {
    "orset": (orset_adapter, jadapters.orset_adapter, _ops_orset),
    "gcounter": (gcounter_adapter, jadapters.gcounter_adapter, _ops_gcounter),
    "pncounter": (pncounter_adapter, jadapters.pncounter_adapter,
                  _ops_pncounter),
    "lwwmap": (lwwmap_adapter, jadapters.lwwmap_adapter, _ops_lwwmap),
}


@pytest.mark.parametrize("name", list(ADAPTER_CASES))
def test_warm_open_byte_identical_to_cold(storage_factory, name):
    """Compact → warm reopen against a cold replica, with a tail past the
    checkpoint that only the ingest can deliver."""
    mk_adapter, _, build = ADAPTER_CASES[name]

    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), mk_adapter()))
        for i in range(24):
            await c1.apply_ops([build(c1, i)])
        await c1.compact()
        w = await Core.open(make_opts(storage_factory("w"), mk_adapter()))
        for i in range(24, 30):
            await w.apply_ops([build(w, i)])
        warm = await Core.open(
            make_opts(storage_factory("a"), mk_adapter(), create=False))
        assert warm.opened_from_checkpoint, warm.checkpoint_fallback_reason
        await warm.read_remote()
        cold = await Core.open(make_opts(storage_factory("c"), mk_adapter()))
        await cold.read_remote()
        assert warm.with_state(canonical_bytes) == cold.with_state(canonical_bytes)

    run(go())


def test_warm_open_skips_refold(storage_factory):
    """The tail ingest of a warm open touches only files past the cursor."""

    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), orset_adapter()))
        for i in range(40):
            await c1.apply_ops([_ops_orset(c1, i % 4)])
        await c1.compact()
        w = await Core.open(make_opts(storage_factory("w"), orset_adapter()))
        await w.apply_ops([_ops_orset(w, 99 % 4)])
        trace.reset()
        warm = await Core.open(
            make_opts(storage_factory("a"), orset_adapter(), create=False))
        assert warm.opened_from_checkpoint
        assert trace.snapshot()["spans"]["checkpoint.load"]["count"] == 1
        await warm.read_remote()
        counters = trace.snapshot()["counters"]
        folded = counters.get("ops_folded", 0) + counters.get(
            "op_files_bulk_folded", 0)
        assert folded <= 1, f"warm open refolded history: {counters}"
        assert warm.with_state(lambda s: s.contains(b"m0"))

    run(go())


# ---- fallbacks -------------------------------------------------------------


def _truncate_checkpoint(storage) -> None:
    if isinstance(storage, MemoryStorage):
        assert storage._local_checkpoint
        storage._local_checkpoint = storage._local_checkpoint[:-7]
    else:
        path = storage._local_checkpoint_path()
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:-7])


def test_torn_checkpoint_falls_back_cold(storage_factory):
    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), orset_adapter()))
        for i in range(25):
            await c1.apply_ops([_ops_orset(c1, i)])
        await c1.compact()
        cold_bytes = c1.with_state(canonical_bytes)
        _truncate_checkpoint(storage_factory("a"))
        trace.reset()
        warm = await Core.open(
            make_opts(storage_factory("a"), orset_adapter(), create=False))
        assert not warm.opened_from_checkpoint
        assert warm.checkpoint_fallback_reason == "unreadable"
        assert trace.snapshot()["counters"].get("checkpoint_fallbacks") == 1
        # the rejected blob is dropped
        assert await storage_factory("a").load_local_checkpoint() is None
        await warm.read_remote()
        assert warm.with_state(canonical_bytes) == cold_bytes

    run(go())


def test_row_index_out_of_range_falls_back_cold(storage_factory,
                                                monkeypatch):
    """A checkpoint whose rows name a member past its table (sealed intact,
    so only the native dict pass can refuse it) raises in the unpack, and
    the open falls back to the cold refold."""
    pack = C.orset_pack_checkpoint

    def corrupt(state):
        obj = pack(state)
        em = np.frombuffer(obj[b"em"], np.int32).copy()
        em[-1] = len(obj[b"members"])
        obj[b"em"] = em.tobytes()
        return obj

    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), orset_adapter()))
        for i in range(25):
            await c1.apply_ops([_ops_orset(c1, i)])
        monkeypatch.setattr(C, "orset_pack_checkpoint", corrupt)
        await c1.compact()
        monkeypatch.setattr(C, "orset_pack_checkpoint", pack)
        with pytest.raises(RuntimeError, match="grouped_rows_dicts refused"):
            blob = await storage_factory("a").load_local_checkpoint()
            obj = await c1._open_sealed(blob)
            C.orset_unpack_checkpoint(obj[b"state"])
        warm = await Core.open(
            make_opts(storage_factory("a"), orset_adapter(), create=False))
        assert not warm.opened_from_checkpoint
        assert warm.checkpoint_fallback_reason == "malformed"
        await warm.read_remote()
        assert warm.with_state(canonical_bytes) == c1.with_state(canonical_bytes)

    run(go())


def test_key_rotation_invalidates_checkpoint(storage_factory):
    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), orset_adapter()))
        for i in range(10):
            await c1.apply_ops([_ops_orset(c1, i)])
        await c1.compact()
        await c1.rotate_key()  # the checkpoint belongs to an old generation
        warm = await Core.open(
            make_opts(storage_factory("a"), orset_adapter(), create=False))
        assert not warm.opened_from_checkpoint
        assert warm.checkpoint_fallback_reason == "key_rotation"
        await warm.read_remote()
        assert warm.with_state(canonical_bytes) == c1.with_state(canonical_bytes)

    run(go())


def test_adapter_mismatch_falls_back(storage_factory):
    async def go():
        c1 = await Core.open(make_opts(storage_factory("a"), gcounter_adapter()))
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 3))])
        await c1.compact()
        warm = await Core.open(
            make_opts(storage_factory("a"), orset_adapter(), create=False))
        assert not warm.opened_from_checkpoint
        assert warm.checkpoint_fallback_reason == "adapter"

    run(go())


def test_wiped_remote_rejects_checkpoint(tmp_path):
    """A checkpoint never installs over a remote it did not come from:
    wipe the remote, bootstrap it again, reopen the old local dir."""
    remote = tmp_path / "remote"

    def fs(local):
        return FsStorage(str(tmp_path / local), str(remote))

    async def go():
        c1 = await Core.open(make_opts(fs("localA"), orset_adapter()))
        for i in range(12):
            await c1.apply_ops([_ops_orset(c1, i)])
        await c1.compact()
        shutil.rmtree(remote)
        boot = await Core.open(make_opts(fs("localB"), orset_adapter()))
        await boot.apply_ops([_ops_orset(boot, 0)])
        warm = await Core.open(make_opts(fs("localA"), orset_adapter(),
                                         create=False))
        assert not warm.opened_from_checkpoint
        # the fresh remote bootstrapped a new key generation and new meta
        assert warm.checkpoint_fallback_reason in (
            "key_rotation", "remote_meta", "unreadable")

    run(go())


def test_checkpoint_disabled_never_writes(storage_factory):
    async def go():
        s_a = storage_factory("a")
        c1 = await Core.open(make_opts(s_a, orset_adapter(), checkpoint=False))
        for i in range(8):
            await c1.apply_ops([_ops_orset(c1, i)])
        await c1.compact()
        assert not await c1.save_checkpoint()
        assert await s_a.load_local_checkpoint() is None
        reopened = await Core.open(make_opts(storage_factory("a"),
                                             orset_adapter(), create=False))
        assert not reopened.opened_from_checkpoint
        assert reopened.checkpoint_fallback_reason is None

    run(go())


# ---- checkpoints from the fresh fold's rows --------------------------------


def test_pack_checkpoint_rows_semantically_equal_to_dict_walk():
    """The rows pack of a fresh sparse fold unpacks to the state the dict
    walk's pack unpacks to, in both packages."""
    import secrets

    rng = np.random.default_rng(4)
    R, E, N = 64, 200, 9000
    actors = sorted(secrets.token_bytes(16) for _ in range(R))
    counters = np.zeros(R, np.int64)
    kind = np.zeros(N, np.int8)
    member = rng.integers(0, E, N).astype(np.int32)
    actor = rng.integers(0, R, N).astype(np.int32)
    ctr = np.zeros(N, np.int32)
    for i in range(N):
        a = int(actor[i])
        roll = rng.random()
        if roll < 0.05:
            kind[i] = 1
            ctr[i] = counters[a] + 3
        elif roll < 0.18 and counters[a]:
            kind[i] = 1
            ctr[i] = counters[a]
        else:
            counters[a] += 1
            ctr[i] = counters[a]
    state = ORSet()
    C.orset_fold_sparse_host(state, kind, member, actor, ctr,
                             C.Vocab(range(E)), C.Vocab(actors))
    stash = state._ckpt_rows
    assert stash is not None and stash[0] == state._mut
    rows_obj = codec.unpack(codec.pack(C.orset_pack_checkpoint_rows(*stash[1])))
    from_rows = C.orset_unpack_checkpoint(rows_obj)
    from_dicts = C.orset_unpack_checkpoint(C.orset_pack_checkpoint(state))
    assert canonical_bytes(from_rows) == canonical_bytes(state)
    assert canonical_bytes(from_rows) == canonical_bytes(from_dicts)
    assert j_canonical_bytes(JC.orset_unpack_checkpoint(rows_obj)) == (
        canonical_bytes(state))


def test_streaming_compact_checkpoints_from_rows(storage_factory, monkeypatch):
    """A compaction whose ingest ran the fresh sparse fold seals its
    checkpoint FROM THE STASHED ROWS (the dict-walk packer is forbidden),
    and the warm reopen restores the cold refold's bytes."""
    from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator as TA

    monkeypatch.setattr(C, "CKPT_STASH_MIN_ROWS", 1)
    # the tiny test shape would pick the dense fold; the stash rides the
    # sparse regime (config 5's shape)
    monkeypatch.setattr(TA, "_use_sparse", lambda self, E, R, n: True)

    async def go():
        writer = await Core.open(make_opts(storage_factory("w"), orset_adapter()))
        for i in range(core_mod.BULK_MIN_FILES + 8):
            await writer.apply_ops([writer.with_state(
                lambda s: s.add_ctx(writer.actor_id, i % 9))])
        reader = await Core.open(make_opts(storage_factory("r"), orset_adapter()))

        def forbidden(state):
            raise AssertionError("dict-walk checkpoint pack ran despite a "
                                 "fresh rows stash")

        with monkeypatch.context() as m:
            m.setattr(C, "orset_pack_checkpoint", forbidden)
            trace.reset()
            await reader.compact()
        counters = trace.snapshot()["counters"]
        assert counters["checkpoint_from_rows"] == 1
        warm = await Core.open(make_opts(storage_factory("r"), orset_adapter(),
                                         create=False))
        assert warm.opened_from_checkpoint, warm.checkpoint_fallback_reason
        cold = await Core.open(make_opts(storage_factory("cold"),
                                         orset_adapter()))
        await cold.read_remote()
        assert warm.with_state(canonical_bytes) == cold.with_state(canonical_bytes)

    run(go())


# ---- across the packages ---------------------------------------------------


def jopts(storage, adapter, create=True):
    return JOpenOptions(
        storage=storage,
        cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(),
        adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        accelerator=jadapters.HostAccelerator(),
    )


def _jax_op(name, core, i):
    """The JAX core's op for step ``i`` of the adapter's script."""
    if name == "lwwmap":
        return JLWWOp(b"k%d" % (i % 4), 1000 + i, core.actor_id, b"v%d" % i)
    if name == "orset":
        if i % 5 == 4:
            return core.with_state(lambda s: s.rm_ctx(b"m%d" % (i % 7)))
        return core.with_state(
            lambda s: s.add_ctx(core.actor_id, b"m%d" % (i % 7)))
    if name == "gcounter":
        return core.with_state(lambda s: s.inc(core.actor_id, 1 + i % 3))
    if i % 3 == 2:
        return core.with_state(lambda s: s.dec(core.actor_id))
    return core.with_state(lambda s: s.inc(core.actor_id))


@pytest.mark.parametrize("name", list(ADAPTER_CASES))
@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_cross_package_warm_open(sealer, name, tmp_path):
    """One package compacts and seals the checkpoint in a local dir; the
    other opens that dir warm, with state bytes equal to the sealer's and,
    after a tail written past the checkpoint, to a cold replica's."""
    port_adapter, jax_adapter, build = ADAPTER_CASES[name]
    remote = str(tmp_path / "remote")

    def port_store(local):
        return FsStorage(str(tmp_path / local), remote)

    def jax_store(local):
        return JFsStorage(str(tmp_path / local), remote)

    async def go():
        if sealer == "jax":
            c1 = await JCore.open(jopts(jax_store("a"), jax_adapter()))
            for i in range(24):
                await c1.apply_ops([_jax_op(name, c1, i)])
            await c1.compact()
            sealed = c1.with_state(j_canonical_bytes)
            warm = await Core.open(make_opts(port_store("a"), port_adapter(),
                                             create=False))
            warm_bytes = warm.with_state(canonical_bytes)
        else:
            c1 = await Core.open(make_opts(port_store("a"), port_adapter()))
            for i in range(24):
                await c1.apply_ops([build(c1, i)])
            await c1.compact()
            sealed = c1.with_state(canonical_bytes)
            warm = await JCore.open(jopts(jax_store("a"), jax_adapter(),
                                          create=False))
            warm_bytes = warm.with_state(j_canonical_bytes)
        assert warm.opened_from_checkpoint, warm.checkpoint_fallback_reason
        assert warm_bytes == sealed
        # a tail past the checkpoint, then warm ≡ cold
        w = await Core.open(make_opts(port_store("w"), port_adapter()))
        for i in range(24, 30):
            await w.apply_ops([build(w, i)])
        await warm.read_remote()
        cold = await Core.open(make_opts(port_store("c"), port_adapter()))
        await cold.read_remote()
        got = warm.with_state(
            j_canonical_bytes if sealer == "port" else canonical_bytes)
        assert got == cold.with_state(canonical_bytes)

    run(go())


# ---- consumer replicas: checkpoint_on_read --------------------------------


def test_checkpoint_on_read_consumer_replica(storage_factory):
    """A consumer that never compacts, with ``checkpoint_on_read``,
    reseals after each ingest and warm-opens from it
    (tests/test_checkpoint.py:246)."""

    async def go():
        w = await Core.open(make_opts(storage_factory("w"), orset_adapter()))
        for i in range(20):
            await w.apply_ops([_ops_orset(w, i)])
        reader = await Core.open(make_opts(
            storage_factory("r"), orset_adapter(), checkpoint_on_read=True))
        await reader.read_remote()
        reopened = await Core.open(
            make_opts(storage_factory("r"), orset_adapter(), create=False))
        assert reopened.opened_from_checkpoint
        assert reopened.with_state(canonical_bytes) == reader.with_state(
            canonical_bytes)

    run(go())


def test_checkpoint_on_read_preserves_cursor_matrix():
    """A warm reopen of a consumer keeps its replication view: the cursor
    matrix rides in the checkpoint it resealed on read
    (tests/test_replication.py:432)."""

    async def go():
        remote = MemoryRemote()
        a = await Core.open(make_opts(MemoryStorage(remote), gcounter_adapter()))
        await a.apply_ops([a.with_state(lambda s: s.inc(a.actor_id))])
        await a.compact()
        storage_c = MemoryStorage(remote)
        c = await Core.open(make_opts(storage_c, gcounter_adapter(),
                                      checkpoint_on_read=True))
        await c.read_remote()
        before = await c.replication_status()
        assert before["matrix"] == {a.actor_id.hex(): {a.actor_id.hex(): 1}}
        c2 = await Core.open(make_opts(storage_c, gcounter_adapter(),
                                       checkpoint_on_read=True))
        assert c2.opened_from_checkpoint
        after = await c2.replication_status()
        assert after["matrix"] == before["matrix"]
        assert after["watermark"] == before["watermark"]

    run(go())


def _saves(snap) -> int:
    return snap["spans"].get("checkpoint.save", {}).get("count", 0)


@pytest.mark.parametrize("name", list(ADAPTER_CASES))
def test_consumer_replica_reseals_as_the_jax_consumer(name, tmp_path):
    """A port consumer and a JAX consumer, each with ``checkpoint_on_read``
    on a copy of the same remote, step in lockstep: the first read
    reseals, a quiet poll writes no checkpoint, a writer's tail reseals
    again, and a reopen restores warm.  Each step's canonical bytes and
    checkpoint count are equal across the packages."""
    from crdt_enc_tpu.utils import trace as jtrace

    port_adapter, jax_adapter, build = ADAPTER_CASES[name]
    remotes = {k: str(tmp_path / f"remote-{k}") for k in ("port", "jax")}

    def popts(local, create=True):
        return make_opts(FsStorage(str(tmp_path / local), remotes["port"]),
                         port_adapter(), create=create,
                         checkpoint_on_read=True)

    def jopts_(local, create=True):
        o = jopts(JFsStorage(str(tmp_path / local), remotes["jax"]),
                  jax_adapter(), create=create)
        o.checkpoint_on_read = True
        return o

    def mirror():
        shutil.rmtree(remotes["jax"], ignore_errors=True)
        shutil.copytree(remotes["port"], remotes["jax"])

    async def step(pc, jc, want_saves):
        trace.reset()
        jtrace.reset()
        await pc.read_remote()
        await jc.read_remote()
        assert (_saves(trace.snapshot()), _saves(jtrace.snapshot())) == \
            (want_saves, want_saves)
        assert pc.with_state(canonical_bytes) == jc.with_state(
            j_canonical_bytes)
        assert pc.info().next_op_versions.to_obj() == \
            jc.info().next_op_versions.to_obj()

    async def go():
        w = await Core.open(make_opts(
            FsStorage(str(tmp_path / "w"), remotes["port"]), port_adapter()))
        for i in range(24):
            await w.apply_ops([build(w, i)])
        mirror()
        pc = await Core.open(popts("pc"))
        jc = await JCore.open(jopts_("jc"))
        await step(pc, jc, 1)   # the first ingest reseals
        await step(pc, jc, 0)   # a quiet poll writes nothing
        for i in range(24, 30):
            await w.apply_ops([build(w, i)])
        mirror()
        await step(pc, jc, 1)   # the tail reseals
        await step(pc, jc, 0)
        warm = await Core.open(popts("pc", create=False))
        jwarm = await JCore.open(jopts_("jc", create=False))
        assert warm.opened_from_checkpoint and jwarm.opened_from_checkpoint
        assert warm.with_state(canonical_bytes) == pc.with_state(
            canonical_bytes) == jwarm.with_state(j_canonical_bytes)
        # the warm consumers' first poll is quiet: no reseal either side
        await step(warm, jwarm, 0)
        # a consumer without the option never writes a checkpoint
        trace.reset()
        plain = await Core.open(make_opts(
            FsStorage(str(tmp_path / "plain"), remotes["port"]),
            port_adapter()))
        await plain.read_remote()
        assert _saves(trace.snapshot()) == 0

    run(go())
