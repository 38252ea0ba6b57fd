"""The device plane cache of ``TorchAccelerator``, on the CPU.

After a dense OR-Set fold the accelerator keeps the planes it computed
(on the card in production), so the next fold of the same, unmutated
state walks no state and uploads only the op columns.  A CPU tensor
crosses no bus, so a hit shows here as the absent ``fold.planes`` and
``fold.vocab`` spans and as the cached tensors themselves reaching the
fold.  Every host mutation expires the entry: per-op apply, a delta
apply, a warm open (a new state object), the host merge.  Ports
tests/test_plane_reuse.py's cases; every state is byte-equal to the host
loop and to the JAX ``TpuAccelerator`` on the same ops.
"""

from __future__ import annotations

import asyncio
import gc

import numpy as np
import pytest

from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.models.orset import op_from_obj as j_op_from_obj
from crdt_enc_tpu.parallel import TpuAccelerator
from crdt_enc_tpu_torch import (
    Core,
    HostAccelerator,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.models.orset import AddOp, RmOp
from crdt_enc_tpu_torch.models.vclock import Dot, VClock
from crdt_enc_tpu_torch.parallel import accel as accel_mod
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

R, E = 16, 64
ACTORS = [bytes([i]) * 16 for i in range(R)]


def gen_ops(n, seed, clock):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        a = ACTORS[int(rng.integers(R))]
        m = int(rng.integers(E))
        if rng.random() < 0.15 and clock.get(a, 0):
            ops.append(RmOp(m, VClock({a: clock[a]})))
        else:
            clock[a] = clock.get(a, 0) + 1
            ops.append(AddOp(m, Dot(a, clock[a])))
    return ops


def spans():
    return trace.snapshot()["spans"]


def planes_built():
    s = spans()
    return "fold.planes" in s or "fold.vocab" in s


class Replicas:
    """One op stream folded by the port's accelerator, the host loop and
    the JAX ``TpuAccelerator``, each into its own state."""

    def __init__(self, accel=None):
        self.accel = accel or TorchAccelerator(device="cpu",
                                               min_device_batch=1)
        self.state, self.host, self.jax = ORSet(), ORSet(), JORSet()
        self.jaccel = TpuAccelerator(min_device_batch=1)
        self.clock: dict = {}

    def fold(self, ops):
        trace.reset()
        self.accel.fold_ops(self.state, ops)
        hit = not planes_built()
        HostAccelerator().fold_ops(self.host, list(ops))
        self.jaccel.fold_ops(self.jax, [j_op_from_obj(op.to_obj())
                                        for op in ops])
        return hit

    def apply(self, op):
        for s in (self.state, self.host):
            s.apply(op)
        self.jax.apply(j_op_from_obj(op.to_obj()))

    def assert_equal(self):
        assert (canonical_bytes(self.state) == canonical_bytes(self.host)
                == j_canonical_bytes(self.jax))


def test_round2_fold_reuses_device_planes(monkeypatch):
    rep = Replicas()
    assert not rep.fold(gen_ops(2000, 1, rep.clock))  # round 1 builds
    cache = rep.accel._plane_cache
    assert cache is not None and cache.token == rep.state._mut
    seen = []
    real = accel_mod.orset_fold

    def spy(*args, **kw):
        seen.append(args[:3])
        return real(*args, **kw)

    monkeypatch.setattr(accel_mod, "orset_fold", spy)
    assert rep.fold(gen_ops(2000, 2, rep.clock)), "round 2 rebuilt the planes"
    # the fold started from the cached tensors themselves (the vocabulary
    # did not grow, so nothing was padded)
    assert len(seen) == 1
    assert all(a is b for a, b in zip(seen[0], cache.planes))
    assert rep.accel._plane_cache is not cache  # replaced by round 2's
    rep.assert_equal()


def test_host_mutation_invalidates_plane_cache():
    rep = Replicas()
    rep.fold(gen_ops(1500, 3, rep.clock))
    # a host-side apply lands between rounds (the cache MUST notice)
    rep.clock[ACTORS[0]] += 1
    rep.apply(AddOp(E + 5, Dot(ACTORS[0], rep.clock[ACTORS[0]])))
    assert rep.accel._plane_cache_for(rep.state) is None
    assert not rep.fold(gen_ops(1500, 4, rep.clock)), (
        "stale planes were trusted after a host apply")
    rep.assert_equal()
    # …and the refreshed cache hits again on round 3
    assert rep.fold(gen_ops(1500, 5, rep.clock))
    rep.assert_equal()


def test_plane_cache_grows_with_vocab():
    """Round 2 brings members AND actors the cache has never seen: the
    cached planes are padded (on the device) and stay byte-correct."""
    rep = Replicas()
    rep.fold(gen_ops(1000, 6, rep.clock))
    extra = [bytes([100 + i]) * 16 for i in range(5)]
    ops2 = []
    for a in extra:
        for k in range(40):
            rep.clock[a] = rep.clock.get(a, 0) + 1
            ops2.append(AddOp(E + 50 + (k % 30), Dot(a, rep.clock[a])))
    ops2.extend(gen_ops(500, 7, rep.clock))
    assert rep.fold(ops2), "vocabulary growth fell off the cached path"
    _, add, _ = rep.accel._plane_cache.planes
    assert tuple(add.shape) == (E + 30, R + 5)
    rep.assert_equal()


def test_dropped_cache_folds_cold():
    """With the entry gone (a fresh accelerator, or the card's planes
    freed) the next fold scans and builds the planes again, byte-equal."""
    rep = Replicas()
    rep.fold(gen_ops(800, 8, rep.clock))
    rep.accel._plane_cache = None
    assert not rep.fold(gen_ops(800, 9, rep.clock)), "no entry, yet a hit"
    assert rep.accel._plane_cache.token == rep.state._mut
    rep.assert_equal()


def test_value_collision_takes_the_uncached_path():
    """The cache's vocabulary keeps member ``1`` after the state dropped
    it; a batch adding ``True`` (== 1 as a Python value, other canonical
    bytes) cannot remap onto it and folds uncached, byte-equal."""
    rep = Replicas()
    a = ACTORS[0]
    ops = []
    for k in range(300):
        ops.append(AddOp(k % 20 + 2, Dot(a, k + 1)))
    ops.append(AddOp(1, Dot(a, 301)))
    ops.append(RmOp(1, VClock({a: 301})))
    rep.fold(ops)
    cache = rep.accel._plane_cache
    assert 1 in cache.members.index and not rep.state.contains(1)
    batch = [AddOp(True, Dot(a, 302))] + [
        AddOp(k % 20 + 2, Dot(a, 303 + k)) for k in range(300)]
    assert not rep.fold(batch), "a colliding batch remapped onto the cache"
    rep.assert_equal()
    assert rep.state.contains(True)


def test_sentinel_indices_decline_the_remap():
    rep = Replicas()
    rep.fold(gen_ops(600, 11, rep.clock))
    cache = rep.accel._plane_cache
    members = accel_mod.Vocab([0, 1])
    replicas = accel_mod.Vocab(ACTORS[:2])
    ok = rep.accel._remap_to_cache(
        cache, np.array([0, 1], np.int32), np.array([0, 1], np.int32),
        members, replicas)
    assert ok is not None
    for member, actor in (([0, 2], [0, 1]), ([0, 1], [0, 2])):
        assert rep.accel._remap_to_cache(
            cache, np.array(member, np.int32), np.array(actor, np.int32),
            members, replicas) is None


def test_sparse_fold_and_merge_drop_the_cache():
    """The sparse writeback and the K4 merge rewrite the state: the first
    keeps its own epoch bump (its checkpoint stash is keyed on it) and
    drops the planes; the second bumps and drops."""
    rep = Replicas()
    rep.fold(gen_ops(600, 12, rep.clock))
    assert rep.accel._plane_cache is not None
    rep.accel.SPARSE_MIN_CELLS = 0
    rep.accel.SPARSE_CELLS_PER_ROW = 0
    mut = rep.state._mut
    ops = gen_ops(300, 13, rep.clock)
    trace.reset()
    rep.accel.fold_ops(rep.state, ops)
    assert "fold.device" not in spans() and "fold.planes" not in spans()
    assert rep.state._mut > mut
    assert rep.accel._plane_cache is None
    HostAccelerator().fold_ops(rep.host, list(ops))
    assert canonical_bytes(rep.state) == canonical_bytes(rep.host)
    rep.accel.SPARSE_MIN_CELLS = 1 << 22
    rep.accel.SPARSE_CELLS_PER_ROW = 64
    rep.fold(gen_ops(600, 14, rep.clock))
    assert rep.accel._plane_cache is not None
    others = [ORSet(), ORSet()]
    others[0].apply(AddOp(7, Dot(ACTORS[3], 10_000)))
    rep.accel.merge_states(rep.state, others)
    assert rep.accel._plane_cache is None


def test_dropped_state_frees_the_cache():
    accel = TorchAccelerator(device="cpu", min_device_batch=1)
    state = ORSet()
    accel.fold_ops(state, gen_ops(500, 15, {}))
    assert accel._plane_cache is not None
    del state
    gc.collect()
    assert accel._plane_cache is None


def test_delta_apply_expires_the_cache():
    """A delta apply rewrites the state on the host (and bumps the epoch):
    the next fold must rebuild its planes, byte-equal to the host loop and
    the JAX package."""
    from crdt_enc_tpu.delta.codec import orset_delta_apply as j_apply

    from crdt_enc_tpu_torch.delta.codec import orset_delta_apply, orset_delta_diff

    rep = Replicas()
    rep.fold(gen_ops(800, 16, rep.clock))
    base = ORSet.from_obj(rep.host.to_obj())
    new = ORSet.from_obj(base.to_obj())
    peer_clock = dict(rep.clock)
    HostAccelerator().fold_ops(new, gen_ops(400, 17, peer_clock))
    dobj = orset_delta_diff(base, new)
    orset_delta_apply(rep.state, dobj)
    orset_delta_apply(rep.host, dobj)
    j_apply(rep.jax, dobj)
    assert rep.accel._plane_cache_for(rep.state) is None
    rep.clock = peer_clock
    assert not rep.fold(gen_ops(800, 18, rep.clock))
    rep.assert_equal()


# ---- through the core ------------------------------------------------------


def make_opts(storage, accel, create=True):
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=accel,
    )


async def write(writer, n, tag):
    for i in range(n):
        await writer.apply_ops([writer.with_state(
            lambda s: s.add_ctx(writer.actor_id, b"%s-%d" % (tag, i)))])


def test_two_round_compact_product_path():
    """compact → pipelined session (BUFFER) → dense fold, twice: round 2
    builds no planes, and the state equals a cold host replica's."""

    async def go():
        remote = MemoryRemote()
        accel = TorchAccelerator(device="cpu", min_device_batch=1)
        reader = await Core.open(make_opts(MemoryStorage(remote), accel))
        writer = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await write(writer, 60, b"r1")
        trace.reset()
        await reader.compact()
        assert "session.decode" in spans() and planes_built()
        await write(writer, 60, b"r2")
        trace.reset()
        await reader.compact()
        assert "session.decode" in spans() and "fold.device" in spans()
        assert not planes_built(), "round 2 rebuilt the state planes"
        cold = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await cold.read_remote()
        assert reader.with_state(canonical_bytes) == cold.with_state(
            canonical_bytes)

    asyncio.run(go())


def test_delta_read_expires_the_cache_in_the_core():
    """A consumer's dense fold caches its planes; the delta link it then
    applies rewrites the state, so its next fold rebuilds them — and it
    ends byte-equal to a cold host replica."""

    async def go():
        remote = MemoryRemote()
        accel = TorchAccelerator(device="cpu", min_device_batch=1)
        producer = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        consumer = await Core.open(make_opts(MemoryStorage(remote), accel))
        writer = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await write(producer, 40, b"p")
        await producer.compact()
        await consumer.read_remote()
        await write(writer, 20, b"w1")
        await consumer.read_remote()
        assert accel._plane_cache_for(consumer._data.state) is not None
        await producer.compact()  # folds w1, seals a delta
        trace.reset()
        await consumer.read_remote()
        assert trace.snapshot()["counters"].get("delta_applied") == 1
        assert accel._plane_cache_for(consumer._data.state) is None
        await write(writer, 20, b"w2")
        trace.reset()
        await consumer.read_remote()
        assert planes_built()
        cold = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await cold.read_remote()
        assert consumer.with_state(canonical_bytes) == cold.with_state(
            canonical_bytes)

    asyncio.run(go())


def test_warm_open_expires_the_cache():
    """A warm open installs a new state object: the accelerator's entry
    for the old one never serves it."""

    async def go():
        remote = MemoryRemote()
        accel = TorchAccelerator(device="cpu", min_device_batch=1)
        storage = MemoryStorage(remote)
        reader = await Core.open(make_opts(storage, accel))
        writer = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await write(writer, 30, b"r1")
        await reader.compact()
        old = reader._data.state
        assert accel._plane_cache_for(old) is not None
        warm = await Core.open(make_opts(storage, accel, create=False))
        assert warm.opened_from_checkpoint
        assert warm._data.state is not old
        assert accel._plane_cache_for(warm._data.state) is None
        await write(writer, 30, b"r2")
        trace.reset()
        await warm.read_remote()
        assert planes_built()
        cold = await Core.open(
            make_opts(MemoryStorage(remote), HostAccelerator()))
        await cold.read_remote()
        assert warm.with_state(canonical_bytes) == cold.with_state(
            canonical_bytes)
        del reader, old
        gc.collect()
        # the warm core's own fold cached its state; the old entry is gone
        assert accel._plane_cache.ref() is warm._data.state

    asyncio.run(go())


@pytest.mark.parametrize("mode", ["host_reduce", "device_stream"])
def test_reduce_session_finish_drops_the_cache(monkeypatch, mode):
    from crdt_enc_tpu_torch.parallel import session as S
    from crdt_enc_tpu_torch.utils import codec

    rep = Replicas()
    rep.fold(gen_ops(600, 19, rep.clock))
    assert rep.accel._plane_cache is not None
    monkeypatch.setattr(S, "BUFFER_BYTES", 0)
    if mode == "device_stream":
        monkeypatch.setattr(S, "HOST_PLANE_CELLS", -1)
    ops = gen_ops(600, 20, rep.clock)
    payload = [codec.pack([op.to_obj() for op in ops[i : i + 24]])
               for i in range(0, len(ops), 24)]
    session = rep.accel.open_fold_session(rep.state, actors_hint=ACTORS)
    session.feed(payload)
    assert session.mode == mode
    mut = rep.state._mut
    session.finish()
    assert rep.state._mut == mut + 1
    assert rep.accel._plane_cache is None
    HostAccelerator().fold_ops(rep.host, list(ops))
    assert canonical_bytes(rep.state) == canonical_bytes(rep.host)


def test_stream_seeds_from_the_cached_planes(monkeypatch):
    """Past ``STREAM_CHUNK_ROWS`` the blockwise stream starts from the
    cached planes (no rebuild), byte-equal to the host loop."""
    rep = Replicas()
    rep.accel.STREAM_CHUNK_ROWS = 64
    rep.jaccel.STREAM_CHUNK_ROWS = 64
    rep.fold(gen_ops(500, 21, rep.clock))
    assert rep.fold(gen_ops(500, 22, rep.clock))
    assert spans()["stream.fold"]["count"] > 1
    rep.assert_equal()
    assert rep.accel._plane_cache is not None
