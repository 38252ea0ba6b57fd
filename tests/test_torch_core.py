"""The port's compaction front end on the CPU: its ``Core`` and plugins,
against the JAX package's.

* Lifecycle mirrors of tests/test_core_lifecycle.py on memory and fs
  storage, with the port's own plugins (XChaCha20-Poly1305, plain keys).
* ``TorchAccelerator.fold_payloads`` against the JAX
  ``TpuAccelerator.fold_payloads`` on the same payloads, and each of its
  declines leaving the state untouched.
* Cross-package compaction: a remote written by the JAX ``Core`` is
  compacted by the port's ``Core`` (``TorchAccelerator`` on the CPU) and
  by the JAX ``Core`` with ``HostAccelerator`` and ``TpuAccelerator``;
  the three states are byte-equal, and each compacted remote reads back
  the same bytes in a fresh replica of the other package.  OR-Set on the
  bulk path (≥ 16 files, 3 snapshots, so the port's merge takes its
  ≥ 3-state device route) and on the per-file path, G-Counter, PN-Counter
  and LWW map.
* A torn op file is quarantined with its cursor held, the same way in
  both packages.

Every port accelerator here is ``TorchAccelerator(device="cpu",
min_device_batch=1)``: the kernels' plain PyTorch versions.
"""

from __future__ import annotations

import asyncio
import shutil
import uuid
from pathlib import Path

import numpy as np
import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    GCounter,
    HostAccelerator,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    PNCounter,
    LWWMap,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    gcounter_adapter,
    lwwmap_adapter,
    orset_adapter,
    pncounter_adapter,
)
from crdt_enc_tpu_torch.core import core as core_mod
from crdt_enc_tpu_torch.core.core import CoreError
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

ADAPTERS = {
    "orset": (orset_adapter, jadapters.orset_adapter),
    "gcounter": (gcounter_adapter, jadapters.gcounter_adapter),
    "pncounter": (pncounter_adapter, jadapters.pncounter_adapter),
    "lwwmap": (lwwmap_adapter, jadapters.lwwmap_adapter),
}


def run(coro):
    return asyncio.run(coro)


def torch_accel():
    return TorchAccelerator(device="cpu", min_device_batch=1)


def popts(storage, adapter, accel=None, create=True):
    return OpenOptions(
        storage=storage,
        cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        accelerator=accel if accel is not None else torch_accel(),
    )


def jopts(storage, adapter, accel=None):
    return JOpenOptions(
        storage=storage,
        cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(),
        adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=True,
        accelerator=accel if accel is not None else jadapters.HostAccelerator(),
    )


# ---- lifecycle on the port's own plugins ------------------------------------


@pytest.fixture(params=["memory", "fs"])
def storage_factory(request, tmp_path):
    """A () -> Storage factory whose instances share one remote."""
    if request.param == "memory":
        remote = MemoryRemote()
        return lambda: MemoryStorage(remote)
    counter = iter(range(1000))
    return lambda: FsStorage(str(tmp_path / f"local{next(counter)}"),
                             str(tmp_path / "remote"))


def test_open_requires_create(storage_factory):
    async def go():
        with pytest.raises(CoreError):
            await Core.open(popts(storage_factory(), gcounter_adapter(), create=False))

    run(go())


def test_open_options_default_to_the_card():
    """Left unset, the accelerator is ``TorchAccelerator()`` on CUDA, which
    raises where there is no card rather than folding on the host."""
    import torch

    def make():
        return OpenOptions(
            storage=MemoryStorage(MemoryRemote()), cryptor=XChaChaCryptor(),
            key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1)

    if torch.cuda.is_available():
        accel = make().accelerator
        assert isinstance(accel, TorchAccelerator)
        assert accel.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_open_persists_identity(storage_factory):
    async def go():
        storage = storage_factory()
        c1 = await Core.open(popts(storage, gcounter_adapter()))
        c2 = await Core.open(popts(storage, gcounter_adapter(), create=False))
        assert c2.actor_id == c1.actor_id

    run(go())


def test_key_bootstrap_and_share(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        assert c1.info().has_latest_key
        c2 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        k1 = c1._data.keys.latest_key()
        k2 = c2._data.keys.latest_key()
        assert k1.id == k2.id and k1.material == k2.material

    run(go())


def test_two_replica_convergence(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        c2 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 5))])
        await c2.apply_ops([c2.with_state(lambda s: s.inc(c2.actor_id, 7))])
        await c1.read_remote()
        await c2.read_remote()
        assert await c1.value() == await c2.value() == 12
        assert c1.with_state(canonical_bytes) == c2.with_state(canonical_bytes)

    run(go())


def test_orset_convergence_and_remove(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), orset_adapter()))
        c2 = await Core.open(popts(storage_factory(), orset_adapter()))
        await c1.update(lambda s: s.add_ctx(c1.actor_id, b"x"))
        await c2.read_remote()
        assert await c2.contains(b"x")
        await c2.update(lambda s: s.rm_ctx(b"x"))
        await c1.read_remote()
        assert not await c1.contains(b"x")
        assert c1.with_state(canonical_bytes) == c2.with_state(canonical_bytes)

    run(go())


def test_compact_roundtrip(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), orset_adapter()))
        for m in (b"a", b"b", b"c"):
            await c1.apply_ops([c1.with_state(lambda s, m=m: s.add_ctx(c1.actor_id, m))])
        await c1.apply_ops([c1.with_state(lambda s: s.rm_ctx(b"b"))])
        await c1.compact()
        storage = storage_factory()
        assert await storage.list_op_actors() == []
        assert len(await storage.list_state_names()) == 1
        c3 = await Core.open(popts(storage_factory(), orset_adapter()))
        await c3.read_remote()
        assert c3.with_state(lambda s: s.members()) == [b"a", b"c"]
        assert c3.with_state(canonical_bytes) == c1.with_state(canonical_bytes)
        assert (await c3.read()).obj == c1.with_state(lambda s: s.to_obj())

    run(go())


def test_compact_then_new_ops_resume(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 3))])
        await c1.compact()
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 4))])
        c2 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c2.read_remote()
        assert await c2.value() == 7
        await c2.compact()
        c3 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c3.read_remote()
        assert await c3.value() == 7

    run(go())


def test_duplicate_read_is_idempotent(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 2))])
        c2 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c2.read_remote()
        await c2.read_remote()  # replay: version-skew skip must absorb it
        assert await c2.value() == 2

    run(go())


def test_rotated_key_keeps_old_files_readable(storage_factory):
    async def go():
        c1 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 2))])
        old = c1._data.keys.latest_key()
        new = await c1.rotate_key()
        assert new.id != old.id
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 3))])
        c2 = await Core.open(popts(storage_factory(), gcounter_adapter()))
        await c2.read_remote()
        assert await c2.value() == 5
        assert c2._data.keys.get_key(old.id) is not None

    run(go())


# ---- fold_payloads against the JAX accelerator ------------------------------

ACTORS = sorted(uuid.UUID(int=i + 1).bytes for i in range(5))


def orset_files(seed: int, n_files: int = 24, members=None):
    """Op-file payloads of adds and removes, built on the port's host
    OR-Set so every dot and context is causally valid."""
    rng = np.random.default_rng(seed)
    members = members or [0, 1, 2, 300, b"m", "s", (1, b"t")]
    state = ORSet()
    payloads = []
    for _ in range(n_files):
        ops = []
        for _ in range(int(rng.integers(1, 6))):
            m = members[int(rng.integers(len(members)))]
            if rng.random() < 0.3 and state.entries.get(m):
                op = state.rm_ctx(m)
            else:
                op = state.add_ctx(ACTORS[int(rng.integers(len(ACTORS)))], m)
            state.apply(op)
            ops.append(op.to_obj())
        payloads.append(jcodec.pack(ops))
    return payloads


def jstate(port_state, adapter):
    """The port state's object form, rebuilt as a JAX state."""
    return adapter.state_from_obj(jcodec.unpack(canonical_bytes(port_state)))


@pytest.mark.parametrize("prior", [False, True])
def test_fold_payloads_orset_matches_the_jax_accelerator(prior):
    """Into an empty state and into one that already holds a history;
    both accelerators' folds and the port's host loop agree."""
    adapter = orset_adapter()
    state = ORSet()
    if prior:
        HostAccelerator().fold_ops(state, [
            adapter.op_from_obj(o) for p in orset_files(9, 8) for o in jcodec.unpack(p)
        ])
    payloads = orset_files(1)
    ref = jstate(state, jadapters.orset_adapter())
    host = ORSet.from_obj(state.to_obj())
    trace.reset()
    assert torch_accel().fold_payloads(state, payloads, actors_hint=ACTORS)
    assert "fold.decode" in trace.snapshot()["spans"]
    assert TpuAccelerator(min_device_batch=1).fold_payloads(
        ref, payloads, actors_hint=ACTORS)
    HostAccelerator().fold_ops(host, [
        adapter.op_from_obj(o) for p in payloads for o in jcodec.unpack(p)
    ])
    assert canonical_bytes(state) == j_canonical_bytes(ref) == canonical_bytes(host)


@pytest.mark.parametrize("kind", ["gcounter", "pncounter"])
def test_fold_payloads_counters_match_the_jax_accelerator(kind):
    rng = np.random.default_rng(3)
    counts = {}
    payloads = []
    for _ in range(20):
        ops = []
        for _ in range(int(rng.integers(1, 5))):
            a = ACTORS[int(rng.integers(len(ACTORS)))]
            d = int(rng.integers(2)) if kind == "pncounter" else 0
            counts[(a, d)] = counts.get((a, d), 0) + int(rng.integers(1, 9))
            dot = [a, counts[(a, d)]]
            ops.append([d, dot] if kind == "pncounter" else dot)
        payloads.append(jcodec.pack(ops))
    port_adapter, j_adapter = ADAPTERS[kind]
    state = port_adapter().new()
    ref = j_adapter().new()
    assert torch_accel().fold_payloads(state, payloads, actors_hint=ACTORS)
    assert TpuAccelerator(min_device_batch=1).fold_payloads(
        ref, payloads, actors_hint=ACTORS)
    assert canonical_bytes(state) == j_canonical_bytes(ref)


def decline_cases():
    """name -> (state factory, payloads, accelerator tweak)."""
    a = ACTORS[0]
    collide = [jcodec.pack([[0, 1, [a, 1]], [0, True, [a, 2]], [0, b"x", [a, 3]]])]

    def sparse(acc):
        acc.SPARSE_MIN_CELLS = 0
        acc.SPARSE_CELLS_PER_ROW = 0

    def stream(acc):
        acc.STREAM_CHUNK_ROWS = 2

    return {
        "member collision (1 and True)": (ORSet, collide, None),
        "sparse regime": (ORSet, orset_files(2), sparse),
        "past STREAM_CHUNK_ROWS": (ORSet, orset_files(2), stream),
        "unknown actor": (ORSet, [jcodec.pack([[0, 1, [uuid.UUID(int=99).bytes, 1]]])], None),
        "G-Counter dot past int32": (GCounter, [jcodec.pack([[a, 2**31 + 5]])], None),
        "PN-Counter dot past int32": (PNCounter, [jcodec.pack([[1, [a, 2**32 + 1]]])], None),
        "PN rows in a G-Counter": (GCounter, [jcodec.pack([[1, [a, 3]]])], None),
        "LWW map": (LWWMap, [jcodec.pack([["k", 5, a, 1, False]])], None),
    }


@pytest.mark.parametrize("name", list(decline_cases()))
def test_fold_payloads_declines_leave_the_state_untouched(name):
    """Each decline returns False before anything mutates; the core then
    decodes per op and calls ``fold_ops``, which must give the host
    loop's bytes."""
    new, payloads, tweak = decline_cases()[name]
    acc = torch_accel()
    if tweak is not None:
        tweak(acc)
    state = new()
    before = canonical_bytes(state)
    mut = getattr(state, "_mut", None)
    assert acc.fold_payloads(state, payloads, actors_hint=ACTORS) is False
    assert canonical_bytes(state) == before
    assert getattr(state, "_mut", None) == mut
    adapter = {ORSet: orset_adapter, GCounter: gcounter_adapter,
               PNCounter: pncounter_adapter, LWWMap: lwwmap_adapter}[new]()
    if name == "PN rows in a G-Counter":
        return
    ops = [adapter.op_from_obj(o) for p in payloads for o in jcodec.unpack(p)]
    if name == "past STREAM_CHUNK_ROWS":
        # the blockwise stream fold is still to port: fold_ops says so
        with pytest.raises(NotImplementedError):
            acc.fold_ops(new(), list(ops))
        return
    got = acc.fold_ops(new(), list(ops))
    host = HostAccelerator().fold_ops(new(), list(ops))
    assert canonical_bytes(got) == canonical_bytes(host)


# ---- cross-package compaction ----------------------------------------------


async def jax_writers(remote: str, tmp, adapter, n: int = 3):
    return [
        await JCore.open(jopts(JFsStorage(str(tmp / f"w{i}"), remote), adapter()))
        for i in range(n)
    ]


async def write_round(kind: str, writers, rnd: int, n_files: int):
    """``n_files`` op files spread over the writers (one op file each)."""
    for i in range(n_files):
        w = writers[i % len(writers)]
        a = w.actor_id
        if kind == "orset":
            m = (rnd * 7 + i) % 5

            def build(s, m=m, a=a, i=i):
                if i % 4 == 3 and s.entries.get(m):
                    return s.rm_ctx(m)
                return s.add_ctx(a, m)
        elif kind == "gcounter":
            def build(s, a=a, i=i):
                return s.inc(a, i % 3 + 1)
        elif kind == "pncounter":
            def build(s, a=a, i=i):
                return s.dec(a, 2) if i % 3 == 2 else s.inc(a, i % 4 + 1)
        else:
            def build(s, a=a, i=i):
                key = f"k{(rnd + i) % 6}"
                ts = 100 + rnd * 10 + i % 3  # ties across writers
                return s.delete(key, ts, a) if i % 5 == 4 else s.put(key, ts, a, i % 4)
        await w.update(build)


async def build_remote(kind: str, remote: str, tmp, *, tail_files: int,
                       snapshots: bool = True):
    """A remote written by three JAX replicas: a first round of op files
    (with cross-reads, so removes observe other replicas' adds), a
    snapshot sealed by each replica over what it has read (three
    coexisting snapshots), then ``tail_files`` op files past them."""
    writers = await jax_writers(remote, tmp, ADAPTERS[kind][1])
    await write_round(kind, writers, 0, 9)
    for w in writers:
        await w.read_remote()
    await write_round(kind, writers, 1, 6)
    if snapshots:
        for w in writers:
            await w._compact_seal()
    await write_round(kind, writers, 2, tail_files)


def copy_remote(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


async def compact_three_ways(kind: str, remote, tmp):
    """Port/Torch, JAX/Host and JAX/Tpu compactions of three copies of
    ``remote``.  Returns the states' bytes, the copies and the port's
    trace snapshot."""
    port_adapter, j_adapter = ADAPTERS[kind]
    rp = copy_remote(remote, tmp / "rp")
    rh = copy_remote(remote, tmp / "rh")
    rt = copy_remote(remote, tmp / "rt")
    port = await Core.open(popts(FsStorage(str(tmp / "lp"), rp), port_adapter()))
    trace.reset()
    await port.compact()
    snap = trace.snapshot()
    jh = await JCore.open(jopts(JFsStorage(str(tmp / "lh"), rh), j_adapter()))
    await jh.compact()
    jt = await JCore.open(jopts(JFsStorage(str(tmp / "lt"), rt), j_adapter(),
                                TpuAccelerator(min_device_batch=1)))
    await jt.compact()
    out = (port.with_state(canonical_bytes), jh.with_state(j_canonical_bytes),
           jt.with_state(j_canonical_bytes))
    return out, (rp, rh, rt), snap, (port, jh, jt)


CROSS_CASES = {
    "orset bulk": ("orset", 20),
    "orset per-file": ("orset", 6),
    "gcounter": ("gcounter", 20),
    "pncounter": ("pncounter", 20),
    "lwwmap": ("lwwmap", 20),
}


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_cross_package_compaction(case, tmp_path):
    kind, tail = CROSS_CASES[case]
    port_adapter, j_adapter = ADAPTERS[kind]

    async def go():
        remote = str(tmp_path / "remote")
        await build_remote(kind, remote, tmp_path, tail_files=tail)
        (bp, bh, bt), (rp, rh, _), snap, (port, jh, _) = await compact_three_ways(
            kind, remote, tmp_path)
        assert bp == bh == bt
        assert port.info().next_op_versions.to_obj() == jh.info().next_op_versions.to_obj()
        # the route the port took
        assert snap["counters"].get("states_merged") == 3
        if tail >= core_mod.BULK_MIN_FILES:
            assert snap["counters"]["op_files_loaded"] == tail
            assert "ops.bulk_decrypt" in snap["spans"]
            if kind in ("orset", "gcounter", "pncounter"):
                assert snap["counters"]["op_files_bulk_folded"] == tail
                assert "fold.decode" in snap["spans"]
            else:
                assert "fold.decode" not in snap["spans"]
        else:
            assert "ops.decrypt_decode" in snap["spans"]
        # the port's compaction collected every op file and snapshot
        ps = FsStorage(str(tmp_path / "check"), rp)
        assert await ps.list_op_actors() == []
        assert len(await ps.list_state_names()) == 1
        # each compacted remote reads back in the other package
        jr = await JCore.open(jopts(JFsStorage(str(tmp_path / "lj2"), rp), j_adapter()))
        await jr.read_remote()
        assert jr.with_state(j_canonical_bytes) == bp
        pr = await Core.open(popts(FsStorage(str(tmp_path / "lp2"), rh), port_adapter(),
                                   accel=HostAccelerator()))
        await pr.read_remote()
        assert pr.with_state(canonical_bytes) == bh

    run(go())


@pytest.mark.parametrize("tail", [20, 0], ids=["bulk", "per-file"])
@pytest.mark.parametrize("damage", ["truncated", "flipped byte"])
def test_torn_op_file_is_quarantined_in_both_packages(tail, damage, tmp_path):
    async def go():
        remote = tmp_path / "remote"
        await build_remote("orset", str(remote), tmp_path, tail_files=tail,
                           snapshots=False)
        actor_dir = sorted((remote / "ops").iterdir())[0]
        versions = sorted(int(p.name) for p in actor_dir.iterdir())
        torn = actor_dir / str(versions[1])
        raw = torn.read_bytes()
        if damage == "truncated":
            torn.write_bytes(raw[: len(raw) // 2])
        else:
            torn.write_bytes(raw[:-1] + bytes([raw[-1] ^ 1]))
        actor = bytes.fromhex(actor_dir.name)
        (bp, bh, bt), (rp, rh, _), snap, (port, jh, _) = await compact_three_ways(
            "orset", remote, tmp_path)
        assert bp == bh == bt
        assert snap["counters"]["ingest_quarantined"] == 1
        loaded = snap["counters"]["op_files_loaded"]
        bulk = "ops.bulk_decrypt" in snap["spans"]
        assert bulk == (loaded >= core_mod.BULK_MIN_FILES) == (tail > 0)
        for core in (port, jh):
            assert core.info().next_op_versions.get(actor) == versions[0]
        # the torn file and the rest of its actor's run stay for a retry
        for r in (rp, rh):
            left = sorted(int(p.name) for p in
                          (Path(r) / "ops" / actor_dir.name).iterdir())
            assert left == versions[1:]

    run(go())


def test_clock_only_snapshots_merge_like_the_host_loop(tmp_path):
    """Three snapshots whose OR-Sets hold clocks but no entries or
    horizons (every add removed): the port's merge sends them to the host
    loop, so the compaction keeps every clock, as the JAX host loop does
    (the JAX device merge returns such a state unmerged; ROADMAP queue 3)."""

    async def go():
        remote = str(tmp_path / "remote")
        writers = await jax_writers(remote, tmp_path, jadapters.orset_adapter)
        for i, w in enumerate(writers):
            await w.update(lambda s, w=w, i=i: s.add_ctx(w.actor_id, i))
            await w.update(lambda s, i=i: s.rm_ctx(i))
            await w._compact_seal()
        rp = copy_remote(remote, tmp_path / "rp")
        port = await Core.open(popts(FsStorage(str(tmp_path / "lp"), rp), orset_adapter()))
        trace.reset()
        await port.compact()
        assert trace.snapshot()["counters"]["states_merged"] == 3
        jh = await JCore.open(jopts(JFsStorage(str(tmp_path / "lh"), remote),
                                    jadapters.orset_adapter()))
        await jh.compact()
        assert port.with_state(canonical_bytes) == jh.with_state(j_canonical_bytes)
        assert len(port.with_state(lambda s: s.clock.counters)) == 3

    run(go())
