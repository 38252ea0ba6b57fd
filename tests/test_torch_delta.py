"""Delta-state replication of the port's ``Core``, on the CPU.

A consumer that folds ``full-at-base + delta chain`` must end
byte-identical to one that re-reads every full snapshot — for each of the
port's adapters with a delta codec (OR-Set, the composed resettable
counter, G-Counter, PN-Counter) on memory and fs storage, and under every
doubt path (gap, GC'd link, torn file, wrong adapter, no base), where the
fallback to the snapshot path is automatic and counted.  Ports the
applicable cases of tests/test_delta.py with ``XChaChaCryptor`` in place
of ``IdentityCryptor``, and adds cross-package cases: a chain sealed by
one package is read by the other's consumer, the two packages' decrypted
delta payloads agree field by field, and a checkpoint's ``cm``, ``rd`` and
``snap`` slots open warm across the packages.

Every port accelerator here is ``TorchAccelerator(device="cpu",
min_device_batch=1)``: the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import random
import shutil

import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.delta import codec as jdelta_codec
from crdt_enc_tpu.delta import wire as jdelta_wire
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.obs import replication as jreplication
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu.utils import trace as jtrace
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    GCounter,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    PNCounter,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    gcounter_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.delta import (
    MAX_CHAIN,
    ResettableCounter,
    UndoError,
    codec_for,
    rcounter_adapter,
)
from crdt_enc_tpu_torch.delta import wire as delta_wire
from crdt_enc_tpu_torch.delta.codec import orset_delta_apply, orset_delta_diff
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.obs.replication import stability_watermark
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


def jopts(storage, adapter, create=True, **kw):
    return JOpenOptions(
        storage=storage,
        cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(),
        adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        accelerator=jadapters.HostAccelerator(),
        **kw,
    )


@pytest.fixture(params=["memory", "fs"])
def storage_factory(request, tmp_path):
    """name -> Storage factories sharing one remote; the same name gives
    the same local state."""
    if request.param == "memory":
        remote = MemoryRemote()
        instances: dict = {}

        def make(name="a"):
            return instances.setdefault(name, MemoryStorage(remote))

        make.remote_dir = None
        return make

    def make(name="a"):
        return FsStorage(str(tmp_path / f"local-{name}"),
                         str(tmp_path / "remote"))

    make.remote_dir = str(tmp_path / "remote")
    return make


async def apply_each(core, builders):
    """One op file per builder — dots mint against the live state, the
    way real writers interleave build/apply."""
    for build in builders:
        await core.update(build)


async def add_members(core, names):
    for m in names:
        await core.update(lambda s, m=m: s.add_ctx(core.actor_id, m))


def counters():
    return trace.snapshot()["counters"]


# ---- codec unit level ------------------------------------------------------


def _rand_orset_history(seed, n_actors=4, n_members=10, n_ops=120):
    """Three causally related Orswot states: base B, its extension N
    (same replica after more folding), and a consumer X that merged B and
    then folded more third-party ops — the codec contract's
    precondition shape."""
    rng = random.Random(seed)
    actors = [bytes([i]) * 16 for i in range(n_actors)]
    members = [b"m%d" % i for i in range(n_members)]

    producer = ORSet()
    third = ORSet()  # a peer whose ops only X sees

    def mutate(s, owner):
        m = rng.choice(members)
        if rng.random() < 0.65 or not s.contains(m):
            s.apply(s.add_ctx(owner, m))
        else:
            s.apply(s.rm_ctx(m))

    for _ in range(n_ops):
        mutate(producer, actors[0])
    base = ORSet.from_obj(producer.to_obj())

    X = ORSet.from_obj(producer.to_obj())  # X merged the base exactly
    for _ in range(n_ops // 2):
        mutate(third, actors[1])
    X.merge(third)
    for _ in range(n_ops // 3):
        mutate(X, actors[2])

    # the producer keeps going: own ops AND part of the third party (so
    # the window kills dots X holds independently)
    for _ in range(n_ops):
        mutate(producer, actors[0])
    producer.merge(ORSet.from_obj(third.to_obj()))
    for _ in range(n_ops // 4):
        mutate(producer, actors[3])
    new = ORSet.from_obj(producer.to_obj())
    return base, new, X


@pytest.mark.parametrize("seed", range(8))
def test_orset_delta_apply_equals_full_merge(seed):
    base, new, consumer = _rand_orset_history(seed)
    dobj = orset_delta_diff(base, new)
    # the port's delta is the JAX package's, byte for byte on the wire
    jdobj = jdelta_codec.orset_delta_diff(
        JORSet.from_obj(base.to_obj()), JORSet.from_obj(new.to_obj()))
    assert codec.pack(dobj) == jcodec.pack(jdobj)
    dobj = codec.unpack(codec.pack(dobj))  # survives the wire

    via_delta = ORSet.from_obj(consumer.to_obj())
    mut = via_delta._mut
    orset_delta_apply(via_delta, dobj)
    assert via_delta._mut > mut  # device plane caches key on the epoch
    via_merge = ORSet.from_obj(consumer.to_obj())
    via_merge.merge(new)
    assert canonical_bytes(via_delta) == canonical_bytes(via_merge)
    jvia = JORSet.from_obj(consumer.to_obj())
    jdelta_codec.orset_delta_apply(jvia, jdobj)
    assert j_canonical_bytes(jvia) == canonical_bytes(via_delta)

    # and on the base itself (the sealer's self-verify shape)
    refold = ORSet.from_obj(base.to_obj())
    orset_delta_apply(refold, dobj)
    assert canonical_bytes(refold) == canonical_bytes(new)


def test_orset_delta_remove_only_window():
    """Removes never advance the Orswot clock, so a remove-only delta has
    an empty window — the apply's cheap path — and must still kill exactly
    the removed dots."""
    a = bytes([7]) * 16
    s = ORSet()
    for m in (b"x", b"y", b"z"):
        s.apply(s.add_ctx(a, m))
    base = ORSet.from_obj(s.to_obj())
    s.apply(s.rm_ctx(b"y"))
    new = ORSet.from_obj(s.to_obj())
    dobj = orset_delta_diff(base, new)
    assert not dobj[b"e"]  # no adds: pure removal
    consumer = ORSet.from_obj(base.to_obj())
    orset_delta_apply(consumer, dobj)
    assert canonical_bytes(consumer) == canonical_bytes(new)


@pytest.mark.parametrize("name", ["gcounter", "pncounter"])
def test_counter_codecs_are_sub_lattices(name):
    make, mutate = {
        "gcounter": (GCounter, lambda s, a, i: s.apply(s.inc(a, i + 1))),
        "pncounter": (PNCounter, lambda s, a, i: s.apply(
            s.inc(a, i + 1) if i % 3 else s.dec(a, i + 1))),
    }[name]
    cdc = codec_for(name.encode())
    a, b = bytes([1]) * 16, bytes([2]) * 16
    s = make()
    for i in range(6):
        mutate(s, a, i)
    base = make.from_obj(codec.unpack(codec.pack(s.to_obj())))
    for i in range(6, 12):
        mutate(s, a, i)
    new = make.from_obj(codec.unpack(codec.pack(s.to_obj())))
    dobj = codec.unpack(codec.pack(cdc.diff(base, new)))
    # consumer ahead of the base on another actor
    consumer = make.from_obj(codec.unpack(codec.pack(base.to_obj())))
    mutate(consumer, b, 20)
    via_merge = make.from_obj(codec.unpack(codec.pack(consumer.to_obj())))
    via_merge.merge(new)
    cdc.apply(consumer, dobj)
    assert canonical_bytes(consumer) == canonical_bytes(via_merge)


def test_codec_registry_covers_the_port_adapters():
    assert codec_for(b"orset") is codec_for(b"rcounter")
    for name in (b"orset", b"gcounter", b"pncounter", b"gset"):
        assert codec_for(name) is not None
    assert codec_for(b"lwwmap") is None  # LWW maps seal no deltas


def _wire_record():
    return delta_wire.DeltaRecord(
        base_name="b", new_name="n", base_cursor=VClock(),
        new_cursor=VClock({b"\x02" * 16: 3}), sealer=b"\x01" * 16,
        adapter=b"orset", watermark={b"\x02" * 16: 2}, delta_obj={},
    )


def test_delta_wire_roundtrip_matches_the_jax_wire():
    good = delta_wire.build_delta_obj(_wire_record())
    parsed = delta_wire.parse_delta_obj(codec.unpack(codec.pack(good)))
    assert parsed.new_name == "n" and parsed.base_name == "b"
    assert parsed.watermark == {b"\x02" * 16: 2}
    jrec = jdelta_wire.DeltaRecord(
        base_name="b", new_name="n", base_cursor=JVClock(),
        new_cursor=JVClock({b"\x02" * 16: 3}), sealer=b"\x01" * 16,
        adapter=b"orset", watermark={b"\x02" * 16: 2}, delta_obj={},
    )
    assert codec.pack(good) == jcodec.pack(jdelta_wire.build_delta_obj(jrec))


@pytest.mark.parametrize("breakage", [
    lambda o: o.pop(b"wm"),  # missing base watermark
    lambda o: o.pop(b"new"),
    lambda o: o.pop(b"d"),
    lambda o: o.__setitem__(b"s", b"short"),
    lambda o: o.__setitem__(b"v", 99),
    lambda o: o.__setitem__(b"a", b""),
    lambda o: o.__setitem__(b"base", 5),
    lambda o: o.pop(b"bcur"),
], ids=["wm", "new", "d", "sealer", "version", "adapter", "base", "bcur"])
def test_delta_wire_rejects_malformed(breakage):
    bad = dict(delta_wire.build_delta_obj(_wire_record()))
    breakage(bad)
    with pytest.raises(ValueError):
        delta_wire.parse_delta_obj(bad)
    with pytest.raises(ValueError):
        jdelta_wire.parse_delta_obj(bad)
    with pytest.raises(ValueError):
        delta_wire.parse_delta_obj([bad])


def test_delta_objects_pack_natively_as_pack_py_and_jax():
    """The size guard packs the delta object: the native packer must give
    the plain packer's bytes (and the JAX package's) on its nested
    shapes — int, str, bytes and tuple members, remove horizons."""
    rng = random.Random(5)
    actors = [bytes([i]) * 16 for i in range(6)]
    s = ORSet()
    members = [b"b", 3, "s", (1, "t"), -7, 2**40]
    for _ in range(300):
        s.apply(s.add_ctx(rng.choice(actors), rng.choice(members)))
    base = ORSet.from_obj(s.to_obj())
    for _ in range(200):
        m = rng.choice(members)
        if rng.random() < 0.3 and s.contains(m):
            s.apply(s.rm_ctx(m))
        else:
            s.apply(s.add_ctx(rng.choice(actors), m))
    s.apply(s.rm_ctx(b"ahead"))
    dobj = orset_delta_diff(base, s)
    rec = delta_wire.build_delta_obj(delta_wire.DeltaRecord(
        "b", "n", base.clock, s.clock, actors[0], b"orset",
        {actors[1]: 4}, dobj))
    for obj in (dobj, rec):
        assert codec.pack(obj) == codec.pack_py(obj) == jcodec.pack(obj)


def _watermark_inputs(rng, VC, actors, me):
    """One random (local clock, cursor matrix, union, replicas) case in
    the given package's VClock; the same rng state gives the same case in
    both packages."""
    def clock():
        k = rng.randint(0, len(actors))
        return VC({a: rng.randrange(0, 5) for a in rng.sample(actors, k)})

    local, union = clock(), clock()
    union.merge(local)
    matrix = {a: clock() for a in rng.sample(actors, rng.randint(0, len(actors)))}
    if rng.random() < 0.3:
        matrix[me] = clock()  # the local clock wins over its own row
    replicas = None
    if rng.random() < 0.3:
        replicas = set(rng.sample(actors + [me], rng.randint(0, len(actors))))
    return local, matrix, union, replicas


@pytest.mark.parametrize("seed", range(4))
def test_stability_watermark_matches_the_jax_package(seed):
    """The port computes the watermark from the silent replicas' count in
    place of the reference's (actor, replica) walk: the same dict on
    random fleets with 0, 1 and more silent replicas, explicit replica
    sets and a self row in the matrix."""
    rng = random.Random(seed)
    for _ in range(300):
        actors = [bytes([i]) * 16 for i in range(rng.randint(1, 6))]
        me = rng.choice(actors + [b"\xee" * 16])
        state = rng.getstate()
        got = stability_watermark(me, *_watermark_inputs(rng, VClock, actors, me))
        rng.setstate(state)
        want = jreplication.stability_watermark(
            me, *_watermark_inputs(rng, JVClock, actors, me))
        assert got == want


@pytest.mark.parametrize("silent", [0, 1, 2])
def test_stability_watermark_of_a_wide_fleet(silent):
    """300 producing replicas, all but ``silent`` of them with a published
    cursor: the JAX package's result, empty once two are silent."""
    actors = [i.to_bytes(16, "big") for i in range(1, 301)]
    me = actors[0]

    def case(VC):
        local = VC({a: 5 + i % 7 for i, a in enumerate(actors)})
        matrix = {r: VC({a: 3 + (i * 7 + k) % 5 for i, a in enumerate(actors)})
                  for k, r in enumerate(actors[1 : len(actors) - silent])}
        return local, matrix, local.copy()

    got = stability_watermark(me, *case(VClock))
    assert got == jreplication.stability_watermark(me, *case(JVClock))
    assert bool(got) == (silent < 2)


# ---- core differential: delta path ≡ snapshot path -------------------------

ADAPTER_CASES = {
    "orset": (
        orset_adapter,
        lambda actor, r: [
            (lambda s, m=b"m%d-%d" % (r, i): s.add_ctx(actor, m))
            for i in range(6)
        ] + [(lambda s, m=b"m%d-0" % max(0, r - 1):
              s.rm_ctx(m) if s.contains(m) else None)],
    ),
    "rcounter": (
        rcounter_adapter,
        lambda actor, r: [
            (lambda s: ResettableCounter.inc(s, actor, r + 1))
            for _ in range(5)
        ] + ([lambda s: ResettableCounter.reset(s)] if r == 2 else []),
    ),
    "gcounter": (
        gcounter_adapter,
        lambda actor, r: [(lambda s: s.inc(actor, r + 1))] * 4,
    ),
    "pncounter": (
        pncounter_adapter,
        lambda actor, r: [
            (lambda s: s.inc(actor, r + 2)), (lambda s: s.dec(actor, 1))
        ] * 2,
    ),
}


@pytest.mark.parametrize("which", sorted(ADAPTER_CASES))
def test_differential_delta_vs_snapshot_path(storage_factory, which):
    """Four adapters × memory+fs: after several producer compactions, a
    chained delta consumer and a full-snapshot consumer are
    byte-identical — and the delta consumer really used the chain."""
    make_adapter, round_ops = ADAPTER_CASES[which]

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), make_adapter()))
        c_delta = await Core.open(
            make_opts(storage_factory("cd"), make_adapter()))
        c_snap = await Core.open(
            make_opts(storage_factory("cs"), make_adapter(), delta=False))
        # a fleet of seed writers widens the state (multi-actor clocks) so
        # a one-writer round's delta beats the full snapshot even for the
        # counters, whose whole state is one small clock
        for w in range(6):
            writer = await Core.open(
                make_opts(storage_factory(f"w{w}"), make_adapter()))
            await apply_each(writer, round_ops(writer.actor_id, 0))
        await apply_each(
            producer,
            [b for r in range(3) for b in round_ops(producer.actor_id, r)],
        )
        await producer.compact()
        await c_delta.read_remote()
        await c_snap.read_remote()
        applied_total = 0
        for r in range(3, 7):
            await apply_each(producer, round_ops(producer.actor_id, r))
            await producer.compact()
            trace.reset()
            await c_delta.read_remote()
            applied_total += counters().get("delta_applied", 0)
            assert not counters().get("delta_fallbacks")
            await c_snap.read_remote()
            assert (
                c_delta.with_state(canonical_bytes)
                == c_snap.with_state(canonical_bytes)
                == producer.with_state(canonical_bytes)
            ), f"{which}: delta path diverged at round {r}"
            assert (c_delta.info().next_op_versions
                    == c_snap.info().next_op_versions)
        assert applied_total > 0, f"{which}: chain never applied"

    run(go())


@pytest.mark.parametrize("which", sorted(ADAPTER_CASES))
def test_snapshot_payload_reuses_the_packed_state(which):
    """``compact()`` packs the state once: the snapshot payload built
    around those bytes equals the packed ``[state, cursor, sealer]``
    wrapper — the native packer's, the plain packer's and the JAX
    package's — and the sealed snapshot reads back to it."""
    make_adapter, round_ops = ADAPTER_CASES[which]
    sealed = []

    async def go():
        core = await Core.open(make_opts(MemoryStorage(MemoryRemote()),
                                         make_adapter()))
        real = core._seal_packed

        async def spy(payload):
            sealed.append(payload)
            return await real(payload)

        for r in range(3):
            await apply_each(core, round_ops(core.actor_id, r))
            if r == 1:
                await core.compact()  # the next seal diffs against a base
        await core.read_remote()
        core._seal_packed = spy
        await core._compact_seal()  # the snapshot is its first seal
        state_obj = core.with_state(core.adapter.state_to_obj)
        wrapper = [state_obj, core.info().next_op_versions.to_obj(),
                   core.actor_id]
        (name,) = await core.storage.list_state_names()
        (blob,) = await core.storage.load_states([name])
        return wrapper, await core._open_sealed(blob[1])

    wrapper, opened = run(go())
    snapshot = sealed[0]
    assert (snapshot == codec.pack(wrapper) == codec.pack_py(wrapper)
            == jcodec.pack(wrapper))
    assert codec.pack(opened) == snapshot


def test_delta_files_smaller_than_snapshots(storage_factory):
    """The point of the subsystem: on an incremental workload the delta
    payloads are a small fraction of the snapshot they replace."""

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        await add_members(producer, [b"member-%04d" % i for i in range(150)])
        await producer.compact()
        trace.reset()
        await producer.update(
            lambda s: s.add_ctx(producer.actor_id, b"tail-1"))
        await producer.compact()
        c = counters()
        assert c.get("delta_files_sealed") == 1
        assert "delta.verify" in trace.snapshot()["spans"]
        names = await producer.storage.list_state_names()
        loaded = await producer.storage.load_states(names)
        snap_bytes = max(len(raw) for _, raw in loaded)
        assert c["delta_bytes_sealed"] * 5 <= snap_bytes
        assert producer._local_meta.last_delta_version == 1

    run(go())


# ---- fallbacks: every doubt path reads the full snapshot -------------------


def test_fallback_on_gc_mid_chain(storage_factory):
    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        consumer = await Core.open(
            make_opts(storage_factory("c"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(80)])
        await producer.compact()
        await consumer.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t1"))
        await producer.compact()
        # the hostile move: the whole delta log vanishes mid-chain
        await producer.storage.remove_deltas([(producer.actor_id, 1 << 62)])
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t2"))
        await producer.compact()
        await producer.storage.remove_deltas([(producer.actor_id, 1 << 62)])
        trace.reset()
        await consumer.read_remote()
        assert not counters().get("delta_applied")
        assert consumer.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)
        # next round the consumer re-anchors at the full snapshot it just
        # read and rejoins the chain
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t3"))
        await producer.compact()
        trace.reset()
        await consumer.read_remote()
        assert counters().get("delta_applied") == 1
        assert consumer.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)

    run(go())


def test_fallback_on_torn_delta_and_base_doubt(storage_factory):
    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        late = await Core.open(
            make_opts(storage_factory("l"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(60)])
        await producer.compact()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"x"))
        await producer.compact()
        # a consumer that never saw the base: base-name doubt → full read
        trace.reset()
        await late.read_remote()
        c = counters()
        assert c.get("delta_fallbacks", 0) >= 1
        assert late.last_delta_fallback_reason == "base_missing"
        assert not c.get("delta_applied")
        assert late.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)

        # torn delta file: unreadable → counted fallback, snapshot wins
        consumer = await Core.open(
            make_opts(storage_factory("c2"), orset_adapter()))
        await late.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"y"))
        await producer.compact()
        files = await producer.storage.load_deltas([(producer.actor_id, 1)])
        actor, version, raw = files[-1]
        await producer.storage.remove_deltas([(actor, version)])
        await producer.storage.store_delta(actor, version,
                                           raw[: len(raw) // 2])
        trace.reset()
        await consumer.read_remote()
        assert counters().get("delta_fallbacks", 0) >= 1
        assert consumer.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)

    run(go())


def test_fallback_on_adapter_mismatch(storage_factory):
    """A delta sealed by an orset fleet read by an rcounter-configured
    replica: fingerprint doubt (adapter name), full snapshot path."""

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        reader = await Core.open(
            make_opts(storage_factory("r"), rcounter_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(60)])
        await producer.compact()
        await reader.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"z"))
        await producer.compact()
        trace.reset()
        await reader.read_remote()
        assert reader.last_delta_fallback_reason == "adapter"
        assert not counters().get("delta_applied")
        assert reader.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)

    run(go())


def test_delta_disabled_seals_and_reads_nothing(storage_factory):
    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter(), delta=False))
        await add_members(producer, [b"m%d" % i for i in range(40)])
        await producer.compact()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t"))
        trace.reset()
        await producer.compact()
        assert not await producer.storage.list_delta_actors()
        assert "delta.plan" not in trace.snapshot()["spans"]
        assert producer._local_meta.last_delta_version == 0

    run(go())


# ---- GC discipline ---------------------------------------------------------


def test_compact_gcs_consumed_foreign_deltas(storage_factory):
    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        compactor = await Core.open(
            make_opts(storage_factory("c"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(60)])
        await producer.compact()
        await compactor.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t"))
        await producer.compact()
        assert await producer.storage.list_delta_actors() == [
            producer.actor_id]
        # the second compactor consumes the chain, then its compaction
        # removes the consumed prefix (covered by its new snapshot)
        await compactor.compact()
        assert compactor._data.read_deltas == {producer.actor_id: 1}
        files = await compactor.storage.load_deltas([(producer.actor_id, 1)])
        assert files == []

    run(go())


def test_own_log_bounded_at_max_chain(storage_factory):
    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        await add_members(producer, [b"base%d" % i for i in range(80)])
        await producer.compact()
        for r in range(MAX_CHAIN + 4):
            await producer.update(
                lambda s, m=b"r%d" % r: s.add_ctx(producer.actor_id, m))
            await producer.compact()
        files = await producer.storage.load_deltas([(producer.actor_id, 1)])
        versions = [v for _, v, _ in files]
        assert len(versions) == MAX_CHAIN
        assert max(versions) - min(versions) == MAX_CHAIN - 1
        assert producer._local_meta.last_delta_version == MAX_CHAIN + 4

    run(go())


def test_deltaless_compact_wipes_own_stale_chain(storage_factory):
    """A cold reopen (no delta base) compacts without a delta; its old
    chain cannot extend to the new snapshot and is removed rather than
    left for every consumer to scan and fall back on."""

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(60)])
        await producer.compact()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t"))
        await producer.compact()
        assert await producer.storage.load_deltas([(producer.actor_id, 1)])
        # cold restart: checkpoint disabled ⇒ no delta base survives
        reopened = await Core.open(make_opts(
            storage_factory("p"), orset_adapter(), create=False,
            checkpoint=False))
        await reopened.read_remote()
        await reopened.update(lambda s: s.add_ctx(reopened.actor_id, b"after"))
        await reopened.compact()
        assert not await reopened.storage.load_deltas(
            [(reopened.actor_id, 1)])

    run(go())


def test_warm_reopen_extends_chain(storage_factory):
    """Checkpoint continuity (``snap``): a warm-reopened compactor keeps
    sealing deltas against its pre-crash snapshot — the chain never
    breaks, and a steady consumer applies straight through."""

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        consumer = await Core.open(
            make_opts(storage_factory("c"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(60)])
        await producer.compact()
        await consumer.read_remote()
        reopened = await Core.open(
            make_opts(storage_factory("p"), orset_adapter(), create=False))
        assert reopened.opened_from_checkpoint
        assert reopened._delta_base["name"] == producer._delta_base["name"]
        await reopened.update(
            lambda s: s.add_ctx(reopened.actor_id, b"post-reopen"))
        await reopened.compact()
        trace.reset()
        await consumer.read_remote()
        assert counters().get("delta_applied") == 1
        assert consumer.with_state(canonical_bytes) == reopened.with_state(
            canonical_bytes)

    run(go())


async def _jax_fsck(remote_dir):
    from crdt_enc_tpu.tools.fsck import fsck_remote

    return await fsck_remote(
        JFsStorage(remote_dir + "-fsck-local", remote_dir),
        JXChaChaCryptor(), JPlainKeyCryptor(), deep=True,
    )


def test_stale_checkpoint_reanchors_chain(storage_factory):
    """A reopen from a one-generation-stale checkpoint re-anchors the
    delta chain at an EARLIER own snapshot.  The resulting link skips its
    predecessor's target — it must apply on consumers that hold the old
    anchor and converge byte-identically; on fs storage the JAX package's
    fsck passes the remote."""

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), orset_adapter()))
        consumer = await Core.open(
            make_opts(storage_factory("c"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(70)])
        await producer.compact()  # S1
        await consumer.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"a"))
        await producer.compact()  # S2 + D1(S1→S2); checkpoint gen A
        stale_ckpt = await producer.storage.load_local_checkpoint()
        await consumer.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"b"))
        await producer.compact()  # S3 + D2(S2→S3); checkpoint gen B
        # the fault: the resume point lags one generation
        await producer.storage.store_local_checkpoint(stale_ckpt)
        reopened = await Core.open(
            make_opts(storage_factory("p"), orset_adapter(), create=False))
        assert reopened.opened_from_checkpoint
        await reopened.read_remote()  # applies D2 from the old anchor
        await reopened.update(lambda s: s.add_ctx(reopened.actor_id, b"c"))
        await reopened.compact()  # S4 + D3(base = S2, not S3!)
        if storage_factory.remote_dir is not None:
            report = await _jax_fsck(storage_factory.remote_dir)
            assert report.ok, [str(i) for i in report.issues]
        trace.reset()
        await consumer.read_remote()
        assert counters().get("delta_applied", 0) >= 1
        assert consumer.with_state(canonical_bytes) == reopened.with_state(
            canonical_bytes)

    run(go())


# ---- composed resettable counter (semidirect product) ----------------------


def test_rcounter_inc_value_reset_undo():
    s = ORSet()
    a = bytes([3]) * 16
    op1 = ResettableCounter.inc(s, a, 5)
    s.apply(op1)
    op2 = ResettableCounter.inc(s, a, 2)
    s.apply(op2)
    assert ResettableCounter.value(s) == 7
    assert len(ResettableCounter.tokens(s)) == 2
    # exact inverse of one observed increment
    s.apply(ResettableCounter.undo(s, op1))
    assert ResettableCounter.value(s) == 2
    with pytest.raises(UndoError):
        ResettableCounter.undo(s, op1)  # nothing left to invert
    with pytest.raises(ValueError):
        ResettableCounter.inc(s, a, 0)
    # resets admit no inverse
    for op in ResettableCounter.reset(s):
        with pytest.raises(UndoError):
            ResettableCounter.undo(s, op)
        s.apply(op)
    assert ResettableCounter.value(s) == 0


def test_rcounter_tokens_are_the_jax_tokens():
    from crdt_enc_tpu.delta.compose import _token as j_token

    from crdt_enc_tpu_torch.delta.compose import _token

    a = bytes([3]) * 16
    for counter, amount in ((1, 5), (2**33, -4), (7, 2**40)):
        assert _token(a, counter, amount) == j_token(a, counter, amount)


def test_rcounter_concurrent_inc_survives_reset(storage_factory):
    """The semidirect action law: a reset cancels what it observed; a
    concurrent unobserved increment survives."""

    async def go():
        a = await Core.open(make_opts(storage_factory("a"), rcounter_adapter()))
        b = await Core.open(make_opts(storage_factory("b"), rcounter_adapter()))
        await a.update(lambda s: ResettableCounter.inc(s, a.actor_id, 10))
        await b.read_remote()
        # concurrent: a increments again, b resets what it has seen (10)
        await a.update(lambda s: ResettableCounter.inc(s, a.actor_id, 4))
        await b.update(lambda s: ResettableCounter.reset(s))
        await a.read_remote()
        await b.read_remote()
        await a.read_remote()
        va = a.with_state(ResettableCounter.value)
        vb = b.with_state(ResettableCounter.value)
        assert va == vb == 4  # the unobserved +4 survived the reset

    run(go())


def test_rcounter_rides_device_kernels_and_delta_chain(storage_factory):
    """No new kernels: the composed counter folds through the OR-Set
    route of ``TorchAccelerator`` and replicates through the same delta
    chains, byte-identical to the host path."""
    from crdt_enc_tpu_torch import HostAccelerator

    async def go():
        producer = await Core.open(
            make_opts(storage_factory("p"), rcounter_adapter()))
        host = await Core.open(make_opts(
            storage_factory("h"), rcounter_adapter(),
            accelerator=HostAccelerator()))
        for _ in range(40):
            await producer.update(
                lambda s: ResettableCounter.inc(s, producer.actor_id, 1))
        trace.reset()
        await producer.compact()
        await host.read_remote()
        await producer.update(
            lambda s: ResettableCounter.inc(s, producer.actor_id, 2))
        await producer.compact()
        trace.reset()
        await host.read_remote()
        assert counters().get("delta_applied") == 1
        assert host.with_state(canonical_bytes) == producer.with_state(
            canonical_bytes)
        assert host.with_state(ResettableCounter.value) == 42

    run(go())


# ---- across the packages ---------------------------------------------------


def _stores(tmp_path, remote="remote"):
    remote_dir = str(tmp_path / remote)

    def port(local):
        return FsStorage(str(tmp_path / f"{remote}-{local}"), remote_dir)

    def jax(local):
        return JFsStorage(str(tmp_path / f"{remote}-{local}"), remote_dir)

    return port, jax


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_cross_package_chain(sealer, tmp_path):
    """One package compacts and seals the delta chain; the other's
    consumer follows it by deltas (no fallback), ending at the same
    canonical bytes as a full-snapshot consumer of its own package."""
    port_store, jax_store = _stores(tmp_path)

    async def go():
        if sealer == "jax":
            producer = await JCore.open(
                jopts(jax_store("p"), jadapters.orset_adapter()))
            consumer = await Core.open(
                make_opts(port_store("c"), orset_adapter()))
            control = await Core.open(
                make_opts(port_store("s"), orset_adapter(), delta=False))
            mine, theirs = canonical_bytes, j_canonical_bytes
        else:
            producer = await Core.open(
                make_opts(port_store("p"), orset_adapter()))
            consumer = await JCore.open(
                jopts(jax_store("c"), jadapters.orset_adapter()))
            control = await JCore.open(
                jopts(jax_store("s"), jadapters.orset_adapter(), delta=False))
            mine, theirs = j_canonical_bytes, canonical_bytes
        for i in range(60):
            await producer.update(
                lambda s, m=b"m%d" % i: s.add_ctx(producer.actor_id, m))
        await producer.compact()
        await consumer.read_remote()
        applied = 0
        for r in range(3):
            for i in range(4):
                await producer.update(
                    lambda s, m=b"r%d-%d" % (r, i):
                    s.add_ctx(producer.actor_id, m))
            await producer.update(
                lambda s, m=b"m%d" % r: s.rm_ctx(m))
            await producer.compact()
            # the consumer counts in its own package's trace registry
            ctr = trace if sealer == "jax" else jtrace
            ctr.reset()
            await consumer.read_remote()
            c = ctr.snapshot()["counters"]
            applied += c.get("delta_applied", 0)
            assert not c.get("delta_fallbacks")
            await control.read_remote()
            assert (consumer.with_state(mine) == control.with_state(mine)
                    == producer.with_state(theirs))
        assert applied == 3
        assert consumer.last_delta_fallback_reason is None

    run(go())


def _copy_tree(tmp_path, src, dst):
    """Copy the remote and the compactor's local dir of one staged tree."""
    for part in ("", "-c", "-stage1", "-stage2"):
        shutil.copytree(tmp_path / f"{src}{part}", tmp_path / f"{dst}{part}")


def _unstage(tmp_path, tree, k):
    """Move staged op files into the tree's remote op logs."""
    stage = tmp_path / f"{tree}-stage{k}"
    for actor_dir in stage.iterdir():
        dest = tmp_path / tree / "ops" / actor_dir.name
        dest.mkdir(parents=True, exist_ok=True)
        for f in actor_dir.iterdir():
            shutil.move(str(f), str(dest / f.name))


def test_cross_package_delta_payloads_equal(tmp_path):
    """The same remote, the same ops and the same compactor identity,
    compacted round by round by each package: the decrypted delta
    payloads agree field by field — cursors, sealer, adapter, the
    watermark and the codec body; the snapshot names each point at that
    package's own sealed snapshots (the sealed bytes carry a random
    nonce, and names are their content addresses)."""
    port_store, _ = _stores(tmp_path, "base")

    async def seed():
        comp = await Core.open(make_opts(port_store("c"), orset_adapter()))
        w = await Core.open(make_opts(port_store("w"), orset_adapter()))
        for i in range(20):
            await w.update(lambda s, m=b"w%d" % i: s.add_ctx(w.actor_id, m))
        await w.compact()  # publishes the writer's cursor
        peer = await Core.open(make_opts(port_store("peer"), orset_adapter()))
        await peer.compact()  # a second published cursor, behind the tail
        for i in range(5):
            await w.update(lambda s, m=b"x%d" % i: s.add_ctx(w.actor_id, m))
        # two staged rounds of ops, held out of the remote until their
        # round
        ops_dir = tmp_path / "base" / "ops" / w.actor_id.hex()
        for k in (1, 2):
            before = {f.name for f in ops_dir.iterdir()}
            for i in range(3):
                await w.update(
                    lambda s, m=b"t%d-%d" % (k, i): s.add_ctx(w.actor_id, m))
            await w.update(lambda s, m=b"w%d" % k: s.rm_ctx(m))
            stage = tmp_path / f"base-stage{k}" / w.actor_id.hex()
            stage.mkdir(parents=True)
            for f in ops_dir.iterdir():
                if f.name not in before:
                    shutil.move(str(f), str(stage / f.name))
        return comp.actor_id

    actor = run(seed())
    _copy_tree(tmp_path, "base", "jx")
    _copy_tree(tmp_path, "base", "pt")

    async def rounds(core, tree):
        assert core.actor_id == actor
        await core.compact()
        out = []
        for k in (1, 2):
            _unstage(tmp_path, tree, k)
            await core.compact()
            files = await core.storage.load_deltas([(actor, 1)])
            assert [v for _, v, _ in files] == list(range(1, k + 1))
            obj = await core._open_sealed(files[-1][2])
            d = core._data
            union = d.next_op_versions.copy()
            for clock in d.cursor_matrix.values():
                union.merge(clock)
            out.append((obj, sorted(d.read_states), dict(
                (bytes(a), c) for a, c in (
                    jreplication.stability_watermark(
                        actor, d.next_op_versions, d.cursor_matrix, union)
                    if tree == "jx" else stability_watermark(
                        actor, d.next_op_versions, d.cursor_matrix, union)
                ).items())))
        return out

    async def go():
        pcore = await Core.open(make_opts(_stores(tmp_path, "pt")[0]("c"),
                                          orset_adapter(), create=False))
        jcore = await JCore.open(jopts(_stores(tmp_path, "jx")[1]("c"),
                                       jadapters.orset_adapter(),
                                       create=False))
        p_out = await rounds(pcore, "pt")
        j_out = await rounds(jcore, "jx")
        assert pcore.with_state(canonical_bytes) == jcore.with_state(
            j_canonical_bytes)
        prev = None
        for (pp, p_names, p_wm), (jp, j_names, j_wm) in zip(p_out, j_out):
            assert set(pp) == set(jp)
            for key in pp:
                if key not in (b"base", b"new"):
                    assert codec.pack(pp[key]) == jcodec.pack(jp[key]), key
            assert pp[b"new"].decode() in p_names
            assert jp[b"new"].decode() in j_names
            if prev is not None:
                assert pp[b"base"] == prev[0][b"new"]
                assert jp[b"base"] == prev[1][b"new"]
            prev = (pp, jp)
            prec = delta_wire.parse_delta_obj(pp)
            assert prec.sealer == actor
            # the watermark is the sealer's, recomputed from its matrix
            assert prec.watermark == p_wm == j_wm
            assert prec.watermark  # the published cursors make it real
            assert jdelta_wire.parse_delta_obj(jp).watermark == prec.watermark

    run(go())


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_cross_package_checkpoint_delta_slots(sealer, tmp_path):
    """A compactor's checkpoint carries the cursor matrix (``cm``), the
    delta consumption cursor (``rd``) and its snapshot's name (``snap``);
    the other package opens it warm with the same three, keeps sealing
    the same delta chain, and a steady consumer applies the next link."""
    port_store, jax_store = _stores(tmp_path)

    async def go():
        producer = await Core.open(make_opts(port_store("p"), orset_adapter()))
        if sealer == "jax":
            comp = await JCore.open(
                jopts(jax_store("c"), jadapters.orset_adapter()))
        else:
            comp = await Core.open(make_opts(port_store("c"), orset_adapter()))
        await add_members(producer, [b"m%d" % i for i in range(40)])
        await producer.compact()
        await comp.read_remote()
        await producer.update(lambda s: s.add_ctx(producer.actor_id, b"t"))
        await producer.compact()  # seals the producer's first delta
        await comp.compact()  # consumes it by delta, then seals
        assert comp._data.read_deltas == {producer.actor_id: 1}
        assert set(comp._data.cursor_matrix) == {producer.actor_id}
        snap = sorted(comp._data.read_states)
        consumer = await Core.open(make_opts(port_store("r"), orset_adapter()))
        await consumer.read_remote()
        if sealer == "jax":
            warm = await Core.open(make_opts(port_store("c"), orset_adapter(),
                                             create=False))
            base_name = warm._delta_base["name"]
        else:
            warm = await JCore.open(jopts(jax_store("c"),
                                          jadapters.orset_adapter(),
                                          create=False))
            base_name = warm.delta_base_name
        assert warm.opened_from_checkpoint, warm.checkpoint_fallback_reason
        assert warm._data.read_deltas == comp._data.read_deltas
        assert {a: c.counters for a, c in warm._data.cursor_matrix.items()} \
            == {a: c.counters for a, c in comp._data.cursor_matrix.items()}
        assert [base_name] == snap
        await add_members(producer, [b"tail-%d" % i for i in range(3)])
        await warm.compact()  # extends the chain from the restored base
        files = await warm.storage.load_deltas([(warm.actor_id, 1)])
        assert [v for _, v, _ in files] == [1]
        trace.reset()
        await consumer.read_remote()
        assert counters().get("delta_applied") == 1
        assert not counters().get("delta_fallbacks")
        got = warm.with_state(
            canonical_bytes if sealer == "jax" else j_canonical_bytes)
        assert consumer.with_state(canonical_bytes) == got

    run(go())
