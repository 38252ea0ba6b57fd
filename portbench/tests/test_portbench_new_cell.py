"""A cell of a second driver is new files and new entries only: in a
copy of the benchmark, a second configuration, traffic mix, stub driver
and small shape are added beside the OR-Set cell's, and every per-cell
helper of the tests finds them by name.  The ``alter`` fault changes an
LWW map's sealed state, and names a type it cannot alter."""

import asyncio
import contextlib
import json
import os
import shutil

import pytest

import harness
from portbench import faults, port, run
from portbench.reference import sealed

STUB_DRIVER = '''"""A second kind of cell, for the tests: one write per key."""

CONTROL_CHECKS = ("keys_off",)
FAULT_CHECKS = ("keys_off", "ts_off")


def stated(config, traffic):
    keys = config["shape"]["keys"]
    return {"keys": keys, "writes": keys * traffic["writes_per_key"]}


def measured(config, traffic, seed):
    return stated(config, traffic)


def run(ctx):
    raise NotImplementedError
'''

NEW_FILES = {
    "portbench/configs/lwwmap-stub.json": {
        "name": "lwwmap-stub", "source": "https://example.org/lwwmap",
        "reference": "portbench/reference/sealed.py",
        "shape": {"keys": 1_000_000}, "counts": {"keys": 1_000_000},
        "widths": {"stream_producers": 7, "torch_threads": 8}},
    "portbench/traffic/lww-stub.json": {
        "driver": "lwwstub", "writes_per_key": 2,
        "counts": {"writes": 2_000_000}},
    "portbench/tests/small/lwwmap-stub.json": {
        "config": {"shape": {"keys": 100}}},
    "portbench/drivers/lwwstub.py": STUB_DRIVER,
}


@pytest.fixture
def copy_with_a_second_cell(tmp_path, monkeypatch):
    root = harness.repo_root()
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, body in NEW_FILES.items():
        path = tmp_path / rel
        assert not path.exists(), rel  # new files only
        path.write_text(body if isinstance(body, str) else json.dumps(body))
    before = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # new entries only: every entry the manifest had is kept as it was
    bench = {**before,
             "configs": before["configs"] + [{
                 "name": "lwwmap-stub", "source": "https://example.org/lwwmap",
                 "file": "portbench/configs/lwwmap-stub.json", "reduced": [],
                 "why": "a stub"}],
             "workloads": before["workloads"] + [{
                 "name": "lww-stub", "config": "lwwmap-stub",
                 "traffic": "lww-stub", "chips": 1, "why": "a stub"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    monkeypatch.setattr(run, "PKG", str(tmp_path / "portbench"))
    return bench, before


def test_every_per_cell_helper_finds_the_second_cell(copy_with_a_second_cell):
    bench, before = copy_with_a_second_cell
    assert harness.cells() == [w["name"] for w in before["workloads"]] + ["lww-stub"]
    cell = harness.small_cell("lww-stub")
    assert cell["config"]["shape"] == {"keys": 100}
    assert cell["config"]["counts"] == {"keys": 100}
    assert cell["traffic"]["counts"] == {"writes": 200}
    work = harness.driver("lww-stub")
    assert work.__file__ == os.path.join(run.PKG, "drivers", "lwwstub.py")
    full = run.resolve(run.manifest(), "lww-stub")
    assert work.measured(full["config"], full["traffic"], 2**31 + 1) == {
        "keys": 1_000_000, "writes": 2_000_000}
    assert work.CONTROL_CHECKS == ("keys_off",)
    assert work.FAULT_CHECKS == ("keys_off", "ts_off")
    # the new cell reports every end-to-end metric that names no cells,
    # the host memory among them
    reported = {m["name"] for m in run.metrics_for(bench, "lww-stub", False)}
    assert reported == {m["name"] for m in bench["end_to_end"]
                        if "workloads" not in m}
    assert "compact_rss_mb" in reported


def _sealed_lwwmap(alter: bool) -> dict:
    from crdt_enc_tpu_torch import (Core, HostAccelerator, LWWOp,
                                    MemoryRemote, MemoryStorage,
                                    lwwmap_adapter)

    key = bytes(range(32))

    async def go():
        storage = MemoryStorage(MemoryRemote())
        core = await Core.open(port.options(storage, HostAccelerator(), key,
                                            adapter=lwwmap_adapter()))
        me = core.actor_id
        # the least key is a tombstone: the fault alters a live entry
        await core.apply_ops([LWWOp(b"a", 5, me, None, True)] + [
            LWWOp(b"k%d" % i, 10 + i, me, b"v%d" % i) for i in range(4)])
        with faults.scope("alter") if alter else contextlib.nullcontext():
            await core.compact()
        (blob,) = storage.remote.states.values()
        state, _, _ = sealed.open_snapshot(blob, key, port.DATA_VERSION)
        return {k: (ts, value, tomb) for k, (ts, _, value, tomb) in state.items()}

    return asyncio.run(go())


def test_alter_raises_one_live_timestamp_of_an_lwwmap():
    plain, altered = _sealed_lwwmap(False), _sealed_lwwmap(True)
    assert plain == {b"a": (5, None, True), **{
        b"k%d" % i: (10 + i, b"v%d" % i, False) for i in range(4)}}
    assert altered == {**plain, b"k0": (11, b"v0", False)}


def test_alter_names_a_type_it_cannot_alter():
    from crdt_enc_tpu_torch import (Core, HostAccelerator, MemoryRemote,
                                    MemoryStorage, gcounter_adapter)

    async def go():
        core = await Core.open(port.options(
            MemoryStorage(MemoryRemote()), HostAccelerator(), bytes(32),
            adapter=gcounter_adapter()))
        with faults.scope("alter"):
            await core.compact()

    with pytest.raises(TypeError, match="GCounter"):
        asyncio.run(go())
