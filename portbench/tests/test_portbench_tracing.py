"""The readers of the port's span tree and storage counters, each on a
synthetic run view: what it reads, and None where the program (a commit
without the span or counter) or the run (no tracing) gives nothing."""

import os
import types

import pytest

from harness import repo_root
from portbench import run

ROOT = repo_root()
BENCH = run.manifest()
NEW = ("core.open_ms", "core.unspanned_ms", "ops.read_wait_ms",
       "storage.fs_calls.merge8", "storage.read_mb.merge8",
       "accel.h2d_pageable_mb.merge8")


def reader(name):
    return run.load_file_module(
        os.path.join(ROOT, "portbench", "metrics", name + ".py"),
        "t_" + name.replace(".", "_"))


def view(units=2, spans=None, counters=None, trace_on=True):
    trace = types.SimpleNamespace(on=trace_on)
    return {"units": units, "spans": spans or {}, "counters": counters or {},
            "shapes": {}, "walls": [], "work": [], "trace": trace,
            "peaks": None}


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_has_its_entry_and_reader(name):
    (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
    assert m["workloads"] == ["orset3-merge8"] and m["moves"] == "setup_s"
    assert callable(reader(name).read)


@pytest.mark.parametrize("name,span", [("core.open_ms", "core.open"),
                                       ("ops.read_wait_ms", "ops.chunk_wait")])
def test_span_readers(name, span):
    r = reader(name)
    assert r.read(view(spans={span: {"count": 2, "seconds": 3.0}})) == 1500.0
    assert r.read(view(spans={"other": {"count": 1, "seconds": 1.0}})) is None
    assert r.read(view(units=0, spans={span: {"seconds": 1.0}})) is None


@pytest.mark.parametrize("name,counters,want", [
    ("storage.fs_calls.merge8",
     {"storage_files_read": 10, "storage_files_statted": 20,
      "storage_files_removed": 30}, 30.0),
    ("storage.fs_calls.merge8", {"storage_files_removed": 4}, 2.0),
    ("storage.read_mb.merge8", {"storage_bytes_read": 3_000_000}, 1.5),
    ("storage.read_mb.merge8", {"storage_bytes_read": 0}, 0.0),
    ("accel.h2d_pageable_mb.merge8", {"h2d_pageable_bytes": 5_000_000}, 2.5),
    ("accel.h2d_pageable_mb.merge8", {"h2d_pageable_bytes": 0}, 0.0),
])
def test_counter_readers(name, counters, want):
    r = reader(name)
    assert r.read(view(counters=counters)) == pytest.approx(want)
    assert r.read(view(counters={"h2d_bytes": 7})) is None
    assert r.read(view(units=0, counters=counters)) is None


def _span(i, name, t0, t1, parent, root, thread="MainThread"):
    return {"name": name, "kind": "span", "t0": t0, "t1": t1, "meta": None,
            "tid": 1, "thread": thread, "id": i, "parent": parent,
            "root": root}


# two compactions; times in seconds
EVENTS = [
    # compaction 1: open 0-10 with one leaf 1-9 (2 s uncovered)
    _span(2, "repl.status", 1.0, 9.0, 1, 1),
    _span(1, "core.open", 0.0, 10.0, None, 1),
    # compact 10-30 (7 s uncovered: 10-12, 14-16, 24-26, 29-30): a
    # wrapper 11-25 whose leaves (on two threads) leave its own gap 14-16
    # and its edges 11-12 and 24-25 uncovered; a leaf 26-29 directly
    # under the root
    _span(4, "ops.chunk_read", 12.0, 14.0, 5, 3, thread="asyncio_0"),
    _span(6, "ops.chunk_fold", 13.0, 14.0, 5, 3),
    _span(7, "ops.chunk_fold", 16.0, 24.0, 5, 3),
    _span(5, "compact.ingest", 11.0, 25.0, 3, 3),
    _span(8, "compact.gc", 26.0, 29.0, 3, 3),
    _span(3, "core.compact", 10.0, 30.0, None, 3),
    # a counter event, another tree and an event of a commit without the
    # span tree: none of them counts
    {"name": "c", "kind": "counter", "t0": 5.0, "t1": 5.0, "meta": None,
     "value": 1, "tid": 1, "thread": "MainThread", "parent": 2, "root": 1},
    _span(9, "serve.cycle", 0.0, 100.0, None, 9),
    {"name": "old", "kind": "span", "t0": 0.0, "t1": 1.0, "meta": None,
     "tid": 1, "thread": "MainThread"},
    # compaction 2: open with no leaf at all (all 4 s uncovered), compact
    # fully covered by one leaf
    _span(10, "core.open", 40.0, 44.0, None, 10),
    _span(12, "compact.ingest", 44.0, 50.0, 11, 11),
    _span(11, "core.compact", 44.0, 50.0, None, 11),
]


def test_unspanned_counts_only_time_outside_every_leaf(monkeypatch):
    r = reader("core.unspanned_ms")
    got = r.uncovered(EVENTS)
    assert {k: v[3] for k, v in got.items()} == {
        1: pytest.approx(2.0), 3: pytest.approx(2.0 + 2.0 + 2.0 + 1.0),
        10: pytest.approx(4.0), 11: pytest.approx(0.0)}
    from crdt_enc_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "events", lambda: list(EVENTS))
    # (2 + 7 + 4 + 0) s over two compactions
    assert r.read(view(units=2)) == pytest.approx(6500.0)
    assert r.read(view(units=2, trace_on=False)) is None
    monkeypatch.setattr(trace, "events", lambda: list(EVENTS[-5:-3]))
    assert r.read(view(units=2)) is None  # no root in the log
