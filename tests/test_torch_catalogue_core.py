"""Cross-package ``Core`` round trips for the seven adapters of the rest of
the catalogue: ``mvreg``, ``gset``, ``lwwreg``, ``merklereg``, ``list``,
``map+orset`` and ``empty``.

In each direction a remote written by three replicas of one package (a
first round of op files read back by every writer, a snapshot sealed by
each, then a tail of op files) is compacted by the other package's
``Core`` on its accelerator — the port's ``TorchAccelerator(device=
"cpu", min_device_batch=1)``, the JAX ``TpuAccelerator`` — and by the
host loop on a copy; the states are byte-equal, the compacted remote
reads back the same bytes in a fresh replica of the writing package, and
the map's tail goes through the port's fold session.  For the G-Set the
delta chain crosses too: one package seals it, the other's consumer
follows it by deltas.
"""

from __future__ import annotations

import asyncio
import shutil

import pytest

import crdt_enc_tpu.models as J
from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models import canonical_bytes as jcb
from crdt_enc_tpu.parallel.accel import TpuAccelerator
from crdt_enc_tpu.utils import trace as jtrace

import crdt_enc_tpu_torch.models as P
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    HostAccelerator,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
)
from crdt_enc_tpu_torch.core import adapters as padapters
from crdt_enc_tpu_torch.core import core as core_mod
from crdt_enc_tpu_torch.models import canonical_bytes as pcb
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

KINDS = {
    # kind -> adapter factory name in both packages
    "mvreg": "mvreg_adapter",
    "gset": "gset_adapter",
    "lwwreg": "lwwreg_adapter",
    "merklereg": "merklereg_adapter",
    "list": "list_adapter",
    "map+orset": "map_adapter",
    "empty": "empty_adapter",
}
TAIL = 20  # past BULK_MIN_FILES: the map's tail takes a fold session


def run(coro):
    return asyncio.run(coro)


def popts(storage, adapter, accel=None, **kw):
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel if accel is not None else TorchAccelerator(
            device="cpu", min_device_batch=1), **kw)


def jopts(storage, adapter, accel=None, **kw):
    return JOpenOptions(
        storage=storage, cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(), adapter=adapter,
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel if accel is not None else jadapters.HostAccelerator(),
        **kw)


def build_op(kind: str, M, actor: bytes, i: int):
    """Op ``i`` of a writer, derived from its live state ``s`` (the
    models of ``M``: the writer's own package)."""
    def build(s):
        if kind == "mvreg":
            return s.write_ctx(actor, i % 5)
        if kind == "gset":
            return s.insert_ctx([i % 7, f"m{i % 5}", b"b%d" % (i % 3)][i % 3])
        if kind == "lwwreg":
            return s.write(100 + i % 4, actor, i)  # ties across writers
        if kind == "merklereg":
            return s.write_ctx(i % 6)
        if kind == "list":
            if i % 5 == 4 and len(s):
                return s.delete_ctx((i * 3) % len(s))
            return s.insert_ctx(actor, (i * 7) % (len(s) + 1), i)
        if kind == "map+orset":
            key = f"k{i % 4}"
            child = s.get(key)
            if i % 6 == 5:
                op = s.rm_ctx(key)
                if not op.ctx.is_empty():
                    return op
            if i % 7 == 3 and child is not None and child.entries:
                m = sorted(child.entries)[0]
                return s.update_ctx(actor, key, lambda c, d: c.rm_ctx(m))
            return s.update_ctx(actor, key, lambda c, d: M.AddOp(i % 5, d))
        return [None]  # the no-op type: one empty op per file

    return build


async def write_history(kind, writers, M):
    """Nine op files, every writer reads the others, six more, a snapshot
    by each writer, then the tail."""
    async def round_(start, n):
        for i in range(start, start + n):
            w = writers[i % len(writers)]
            await w.update(build_op(kind, M, w.actor_id, i))

    await round_(0, 9)
    for w in writers:
        await w.read_remote()
    await round_(9, 6)
    for w in writers:
        await w._compact_seal()
    await round_(15, TAIL)


def copy_remote(src, dst) -> str:
    shutil.copytree(src, dst)
    return str(dst)


@pytest.mark.parametrize("kind", list(KINDS))
def test_jax_writer_port_compactor_jax_reader(kind, tmp_path):
    fn = KINDS[kind]
    port_adapter = getattr(padapters, fn)
    jax_adapter = getattr(jadapters, fn)

    async def go():
        remote = str(tmp_path / "remote")
        writers = [await JCore.open(jopts(JFsStorage(str(tmp_path / f"w{i}"),
                                                     remote), jax_adapter()))
                   for i in range(3)]
        await write_history(kind, writers, J)
        rp = copy_remote(remote, tmp_path / "rp")
        rh = copy_remote(remote, tmp_path / "rh")
        rt = copy_remote(remote, tmp_path / "rt")
        port = await Core.open(popts(FsStorage(str(tmp_path / "lp"), rp),
                                     port_adapter()))
        trace.reset()
        await port.compact()
        snap = trace.snapshot()
        host = await Core.open(popts(FsStorage(str(tmp_path / "lh"), rh),
                                     port_adapter(), HostAccelerator()))
        await host.compact()
        jt = await JCore.open(jopts(JFsStorage(str(tmp_path / "lt"), rt),
                                    jax_adapter(),
                                    TpuAccelerator(min_device_batch=1)))
        await jt.compact()
        got = port.with_state(pcb)
        assert got == host.with_state(pcb) == jt.with_state(jcb)
        assert snap["counters"].get("states_merged") == 3
        assert snap["counters"]["op_files_loaded"] == TAIL
        if kind == "map+orset":
            assert "session.map_fold" in snap["spans"]
            assert "map.scatter_device" in snap["spans"]
        elif kind != "empty":
            assert "ops.bulk_fold" in snap["spans"]
        jr = await JCore.open(jopts(JFsStorage(str(tmp_path / "lj"), rp),
                                    jax_adapter()))
        await jr.read_remote()
        assert jr.with_state(jcb) == got
        assert (port.info().next_op_versions.to_obj()
                == jr.info().next_op_versions.to_obj())

    run(go())


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_writer_jax_compactor_port_reader(kind, tmp_path):
    fn = KINDS[kind]
    port_adapter = getattr(padapters, fn)
    jax_adapter = getattr(jadapters, fn)

    async def go():
        remote = str(tmp_path / "remote")
        writers = [await Core.open(popts(FsStorage(str(tmp_path / f"w{i}"),
                                                   remote), port_adapter(),
                                         HostAccelerator()))
                   for i in range(3)]
        await write_history(kind, writers, P)
        rj = copy_remote(remote, tmp_path / "rj")
        rh = copy_remote(remote, tmp_path / "rh")
        jt = await JCore.open(jopts(JFsStorage(str(tmp_path / "lt"), rj),
                                    jax_adapter(),
                                    TpuAccelerator(min_device_batch=1)))
        await jt.compact()
        host = await Core.open(popts(FsStorage(str(tmp_path / "lh"), rh),
                                     port_adapter(), HostAccelerator()))
        await host.compact()
        got = jt.with_state(jcb)
        assert got == host.with_state(pcb)
        pr = await Core.open(popts(FsStorage(str(tmp_path / "lp"), rj),
                                   port_adapter()))
        await pr.read_remote()
        assert pr.with_state(pcb) == got

    run(go())


@pytest.mark.parametrize("sealer", ["jax", "port"])
def test_gset_delta_chain_across_packages(sealer, tmp_path):
    """One package compacts a G-Set and seals its delta chain; the other's
    consumer follows it by deltas (no fallback) to the bytes a
    full-snapshot reader of its own package reads."""
    remote = str(tmp_path / "remote")

    def pstore(name):
        return FsStorage(str(tmp_path / f"p-{name}"), remote)

    def jstore(name):
        return JFsStorage(str(tmp_path / f"j-{name}"), remote)

    async def go():
        if sealer == "jax":
            producer = await JCore.open(jopts(jstore("p"),
                                              jadapters.gset_adapter()))
            consumer = await Core.open(popts(pstore("c"),
                                             padapters.gset_adapter()))
            control = await Core.open(popts(pstore("s"),
                                            padapters.gset_adapter(),
                                            delta=False))
            mine, theirs, ctr = pcb, jcb, trace
        else:
            producer = await Core.open(popts(pstore("p"),
                                             padapters.gset_adapter()))
            consumer = await JCore.open(jopts(jstore("c"),
                                              jadapters.gset_adapter()))
            control = await JCore.open(jopts(jstore("s"),
                                             jadapters.gset_adapter(),
                                             delta=False))
            mine, theirs, ctr = jcb, pcb, jtrace
        for i in range(30):
            await producer.update(lambda s, i=i: s.insert_ctx(f"m{i}"))
        await producer.compact()
        await consumer.read_remote()
        applied = 0
        for r in range(3):
            for i in range(4):
                await producer.update(lambda s, r=r, i=i: s.insert_ctx((r, i)))
            await producer.compact()
            ctr.reset()
            await consumer.read_remote()
            c = ctr.snapshot()["counters"]
            applied += c.get("delta_applied", 0)
            assert not c.get("delta_fallbacks")
            await control.read_remote()
            assert (consumer.with_state(mine) == control.with_state(mine)
                    == producer.with_state(theirs))
        assert applied == 3

    run(go())


def test_the_port_offers_every_adapter_of_the_jax_package():
    names = sorted(n for n in dir(jadapters) if n.endswith("_adapter"))
    assert names == sorted(n for n in dir(padapters) if n.endswith("_adapter"))
    for n in names:
        assert getattr(padapters, n)().name == getattr(jadapters, n)().name
    assert core_mod.BULK_MIN_FILES <= TAIL
