"""The port's span tree and storage counters on the CPU.

* While the event log is on, every span names its ``parent`` and
  ``root``: nested in one task, in child ``asyncio`` tasks, across
  ``asyncio.to_thread`` and in an ingest pipeline's producer thread;
  counter events name the span they were made in.
* With the log off, ``span()`` leaves the context variable unset and the
  aggregate is what it always was.
* A fresh replica's ``FsStorage`` compaction: every event inside it names
  the root of its ``core.open`` or ``core.compact``, and the storage
  counters equal the files on disk before and after.
"""

from __future__ import annotations

import asyncio
import os
import shutil

import pytest

from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    HostAccelerator,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    orset_adapter,
)
from crdt_enc_tpu_torch.obs import record
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


@pytest.fixture(autouse=True)
def clean_registry():
    trace.reset()
    yield
    trace.reset()


def _spans(events) -> dict:
    return {e["name"]: e for e in events if e["kind"] == "span"}


async def _nested():
    with trace.span("top"):
        with trace.span("mid"):
            with trace.span("leaf"):
                trace.add("tree_counter", 1)


async def _tasks():
    async def child():
        with trace.span("leaf"):
            trace.add("tree_counter", 1)

    with trace.span("top"):
        with trace.span("mid"):
            await asyncio.gather(asyncio.create_task(child()))


async def _threads():
    def child():
        with trace.span("leaf"):
            trace.add("tree_counter", 1)

    with trace.span("top"):
        with trace.span("mid"):
            await asyncio.to_thread(child)


async def _pipeline():
    from crdt_enc_tpu_torch.ops import stream

    def ingest(span, k):
        with trace.span("leaf"):
            trace.add("tree_counter", 1)

    with trace.span("top"):
        with trace.span("mid"):
            # the producer thread's own stream.ingest span sits between
            stream.run_ingest_pipeline([0], ingest, lambda item, k: None)


@pytest.mark.parametrize("where", [_nested, _tasks, _threads, _pipeline],
                         ids=["nested", "task", "to_thread", "pipeline"])
def test_spans_name_their_parent_and_root(where):
    trace.enable_events()
    asyncio.run(where())
    with trace.span("other"):  # a later outermost span is a root of its own
        pass
    events = trace.events()
    s = _spans(events)
    top, mid, leaf, other = s["top"], s["mid"], s["leaf"], s["other"]
    assert (top["parent"], top["root"]) == (None, top["id"])
    assert (mid["parent"], mid["root"]) == (top["id"], top["id"])
    up = mid
    if where is _pipeline:
        up = s["stream.ingest"]
        assert (up["parent"], up["root"]) == (mid["id"], top["id"])
    assert (leaf["parent"], leaf["root"]) == (up["id"], top["id"])
    assert (other["parent"], other["root"]) == (None, other["id"])
    assert len({top["id"], mid["id"], leaf["id"], other["id"]}) == 4
    (counter,) = [e for e in events if e["name"] == "tree_counter"]
    assert (counter["parent"], counter["root"]) == (leaf["id"], top["id"])
    # every span closed: nothing left open in this context
    assert record._open_span.get() is None


def test_log_off_leaves_the_context_alone_and_the_aggregate_unchanged(
        monkeypatch):
    clock = iter([10.0, 10.25, 11.0, 11.5])
    monkeypatch.setattr(record.time, "perf_counter", lambda: next(clock))
    seen = []
    with trace.span("a"):
        seen.append(record._open_span.get())
    with trace.span("a", meta=3):
        seen.append(record._open_span.get())
    assert seen == [None, None]
    assert trace.events() == []
    hist = {record._hist_index(0.25): 1}
    hist[record._hist_index(0.5)] = hist.get(record._hist_index(0.5), 0) + 1
    assert trace.snapshot()["spans"]["a"] == {
        "count": 2, "seconds": 0.75, "max_ms": 500.0,
        **record.quantiles_ms(hist, 2)}


# ---- a compaction on FsStorage ---------------------------------------------


def _opts(storage, accel):
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=accel,
    )


async def _write(writers, rnd: int, n: int) -> None:
    for i in range(n):
        w = writers[i % len(writers)]
        await w.update(lambda s, a=w.actor_id, m=(rnd * 5 + i) % 7:
                       s.add_ctx(a, m))


async def _build(tmp, remote: str):
    """Three writers' op files in two rounds, and a snapshot of the first
    round sealed by a replica on a copy of the folder, then moved in (so
    the folder keeps every op file, as a synced folder whose sealer ran
    elsewhere does)."""
    writers = [await Core.open(_opts(FsStorage(str(tmp / f"w{i}"), remote),
                                     HostAccelerator())) for i in range(3)]
    await _write(writers, 0, 18)
    side = str(tmp / "side")
    shutil.copytree(remote, side)
    sealer = await Core.open(_opts(FsStorage(str(tmp / "sealer"), side),
                                   HostAccelerator()))
    await sealer.compact()
    (name,) = os.listdir(os.path.join(side, "states"))
    os.makedirs(os.path.join(remote, "states"))
    shutil.move(os.path.join(side, "states", name),
                os.path.join(remote, "states", name))
    await _write(writers, 1, 18)


def _files(remote: str, family: str) -> dict:
    out = {}
    for d, _, names in os.walk(os.path.join(remote, family)):
        for n in names:
            out[os.path.join(d, n)] = os.path.getsize(os.path.join(d, n))
    return out


def test_a_compaction_is_one_tree_and_counts_its_files(tmp_path):
    remote = str(tmp_path / "remote")
    asyncio.run(_build(tmp_path, remote))
    ops, states = _files(remote, "ops"), _files(remote, "states")
    actors = len(os.listdir(os.path.join(remote, "ops")))
    # the snapshot covers the first round: versions 1-6 of each actor
    tail = {p: n for p, n in ops.items() if int(os.path.basename(p)) > 6}
    assert len(ops) == 36 and len(tail) == 18 and len(states) == 1

    trace.reset()
    trace.enable_events()

    async def compact():
        core = await Core.open(_opts(
            FsStorage(str(tmp_path / "fresh"), remote),
            TorchAccelerator(device="cpu", min_device_batch=1)))
        await core.compact()

    asyncio.run(compact())
    events = trace.events()
    trace.enable_events(False)
    roots = {e["id"]: e["name"] for e in events
             if e["kind"] == "span" and e["parent"] is None}
    assert sorted(roots.values()) == ["core.compact", "core.open"]
    assert {e["name"] for e in events
            if e["kind"] == "span" and e["root"] not in roots} == set()
    assert {e["name"] for e in events
            if e["kind"] != "span" and e["root"] not in roots} == set()
    assert "ops.chunk_wait" in _spans(events)  # the pipelined route ran

    c = trace.snapshot()["counters"]
    left = _files(remote, "ops"), _files(remote, "states")
    assert left[0] == {} and len(left[1]) == 1
    # read: the snapshot and the op files past its cursor
    assert c["storage_files_read"] == len(states) + len(tail)
    assert c["storage_bytes_read"] == sum(states.values()) + sum(tail.values())
    # stat'd: at open a probe hit and a size for every op file; at the
    # ingest a probe hit for every actor with a tail
    assert c["storage_files_statted"] == actors + len(ops) + actors
    # removed: every op file and the read snapshot
    assert c["storage_files_removed"] == len(ops) + len(states)
    assert c.get("h2d_pageable_bytes", 0) <= c.get("h2d_bytes", 0)
