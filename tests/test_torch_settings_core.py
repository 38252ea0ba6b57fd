"""The core's and the observability layer's environment settings, held
against the JAX package under the same environment.

* ``CRDT_REPL_SAMPLE=0``: no replication sample on open, ``read_remote``
  or ``compact`` (the twin of tests/test_replication.py::
  test_repl_sample_opt_out), with the same ``stat_ops`` calls as the
  JAX core;
* ``CRDT_DELTA=0``: a compaction's remote (every file name and its bytes)
  equals the JAX package's, with no delta file in either;
* ``CRDT_DELTA_VERIFY=0``: the seal-time refold check is not called, and
  the sealed delta is the JAX package's;
* ``CRDT_SLO_*``: the specs, gauges, burns and reports of both packages
  (the twin of tests/test_slo.py::test_spec_defaults_and_env_overrides);
* ``CRDT_OBS_SINK_MAX_MB``: the same rotation generations and bytes (the
  twin of tests/test_obs.py::test_sink_rotation_concurrent_writers);
* ``obs.live.configure``, ``publish_cycle`` and ``publish_daemon``: the
  same ``/healthz`` sections.

Every comparison is exact (tolerance 0).  The remotes are written once
by a port writer and copied into both packages with the compactor's
local meta (tests/test_torch_daemon.py's ``Twins``), under
``IdentityCryptor``, so a sealed file's bytes depend on nothing random.
"""

from __future__ import annotations

import asyncio
import json
import threading
import types

import pytest
from _jax_gc_guard import hold_the_cyclic_collector  # noqa: F401 (autouse)
from test_torch_daemon import SIDES, Twins

from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import gcounter_adapter as j_gcounter_adapter
from crdt_enc_tpu.obs import live as jlive
from crdt_enc_tpu.obs import sink as jsink
from crdt_enc_tpu.obs import slo as jslo
from crdt_enc_tpu.utils import trace as jtrace
from crdt_enc_tpu_torch import (
    Core,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    gcounter_adapter,
)
from crdt_enc_tpu_torch.backends import IdentityCryptor
from crdt_enc_tpu_torch.core import core as core_mod
from crdt_enc_tpu_torch.obs import live, sink, slo
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

ENV = ("CRDT_REPL_SAMPLE", "CRDT_DELTA", "CRDT_DELTA_VERIFY",
       slo.ENV_FRESHNESS, slo.ENV_SEAL, slo.ENV_OBJECTIVE, sink.ENV_MAX_MB,
       sink.ENV_VAR, live.ENV_VAR)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    trace.reset()
    jtrace.reset()
    yield
    trace.reset()
    jtrace.reset()


def run(coro):
    return asyncio.run(coro)


# ---- CRDT_REPL_SAMPLE -------------------------------------------------------


def counting(storage_cls):
    class Counting(storage_cls):
        stat_calls = 0

        async def stat_ops(self, *a, **kw):
            type(self).stat_calls += 1
            return await super().stat_ops(*a, **kw)

    return Counting


COUNTER = {
    "port": types.SimpleNamespace(
        Core=Core, Remote=MemoryRemote, Storage=counting(MemoryStorage),
        trace=trace,
        opts=lambda st, **kw: OpenOptions(
            storage=st, cryptor=IdentityCryptor(),
            key_cryptor=PlainKeyCryptor(), adapter=gcounter_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1,
            accelerator=TorchAccelerator(device="cpu", min_device_batch=1),
            **kw)),
    "jax": types.SimpleNamespace(
        Core=JCore, Remote=JMemoryRemote, Storage=counting(JMemoryStorage),
        trace=jtrace,
        opts=lambda st, **kw: JOpenOptions(
            storage=st, cryptor=JIdentityCryptor(),
            key_cryptor=JPlainKeyCryptor(), adapter=j_gcounter_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, **kw)),
}


def sample_run(side) -> dict:
    """Open a writer and a reader over one remote, write, read, compact,
    reopen: what the replication sampler left behind."""
    async def go():
        remote = side.Remote()
        w = await side.Core.open(side.opts(side.Storage(remote), create=True))
        await w.apply_ops([w.with_state(lambda s: s.inc(w.actor_id))])
        r = await side.Core.open(side.opts(side.Storage(remote), create=True))
        await r.read_remote()
        await w.compact()
        await r.read_remote()
        snap = side.trace.snapshot()
        out = {
            "writer_status": w.last_replication_status,
            "reader_status": r.last_replication_status,
            "repl_status_spans": snap["spans"].get(
                "repl.status", {}).get("count", 0),
            "repl_samples": snap["counters"].get("repl_samples", 0),
            "stat_calls": side.Storage.stat_calls,
        }
        # the public API still works on demand: the switch silences only
        # the automatic sampling
        status = await w.replication_status()
        out["backlog"] = status["backlog"]["files"]
        return out

    side.Storage.stat_calls = 0
    return run(go())


def test_repl_sample_opt_out(monkeypatch):
    monkeypatch.setenv("CRDT_REPL_SAMPLE", "0")
    got = {name: sample_run(side) for name, side in COUNTER.items()}
    assert got["port"] == got["jax"]
    assert got["port"]["writer_status"] is None
    assert got["port"]["reader_status"] is None
    assert got["port"]["repl_status_spans"] == 0
    assert got["port"]["repl_samples"] == 0
    assert got["port"]["backlog"] == 0


def test_repl_sample_on_by_default_in_both_packages():
    got = {name: sample_run(side) for name, side in COUNTER.items()}
    for name in got:
        assert got[name]["repl_status_spans"] > 0, name
        assert got[name]["writer_status"] is not None, name
    assert got["port"]["repl_status_spans"] == got["jax"]["repl_status_spans"]
    assert got["port"]["stat_calls"] == got["jax"]["stat_calls"] > 0
    assert got["port"]["repl_samples"] == got["jax"]["repl_samples"]


# ---- CRDT_DELTA and CRDT_DELTA_VERIFY ---------------------------------------


def remote_files(remote) -> dict:
    return {
        "metas": dict(remote.metas),
        "states": dict(remote.states),
        "ops": {a: dict(d) for a, d in remote.ops.items()},
        "deltas": {a: dict(d) for a, d in remote.deltas.items()},
    }


async def twin_compactions(tails=(6, 4)) -> dict:
    """One remote, copied into both packages; each package's compactor
    (the same actor) compacts it, then once more after each tail of new
    ops.  Returns each side's remote files after the last compaction."""
    tw = Twins()
    r = await tw.remote(12, b"dl")
    ident = await tw.identity(r)
    tw.freeze()
    cores = {}
    for side in SIDES:
        st = tw.storage(side, r, ident)
        cores[side.name] = await side.Core.open(side.opts(st, create=False))
    for side in SIDES:
        await cores[side.name].compact()
    for n in tails:
        for i in range(n):
            await tw.write(r, b"tail-%d" % i)
        for side in SIDES:
            await cores[side.name].compact()
    return {side.name: remote_files(tw.copies[side.name][r])
            for side in SIDES}


@pytest.mark.parametrize("delta_env", ["0", None])
def test_delta_switch_gives_the_jax_remote(monkeypatch, delta_env):
    if delta_env is not None:
        monkeypatch.setenv("CRDT_DELTA", delta_env)
    files = run(twin_compactions())
    assert files["port"] == files["jax"]
    deltas = sum(len(d) for d in files["port"]["deltas"].values())
    if delta_env == "0":
        assert deltas == 0
    else:
        assert deltas > 0


@pytest.mark.parametrize("verify_env", ["0", None])
def test_delta_verify_switch(monkeypatch, verify_env):
    if verify_env is not None:
        monkeypatch.setenv("CRDT_DELTA_VERIFY", verify_env)
    calls = []
    real = core_mod.Core._verify_delta_plan

    def spy(self, plan):
        calls.append(1)
        return real(self, plan)

    monkeypatch.setattr(core_mod.Core, "_verify_delta_plan", spy)
    files = run(twin_compactions(tails=(5,)))
    assert files["port"] == files["jax"]
    assert sum(len(d) for d in files["port"]["deltas"].values()) > 0
    assert len(calls) == (0 if verify_env == "0" else 1)


# ---- CRDT_SLO_* -------------------------------------------------------------

SLO_ENVS = [
    {},
    {slo.ENV_FRESHNESS: "8", slo.ENV_SEAL: "0.5", slo.ENV_OBJECTIVE: "0.9"},
    {slo.ENV_FRESHNESS: "banana", slo.ENV_OBJECTIVE: "7"},
    {slo.ENV_OBJECTIVE: "1.0"},
    {slo.ENV_SEAL: "", slo.ENV_OBJECTIVE: "0"},
]


def spec_fields(s):
    return (s.name, s.indicator, s.target, s.objective, s.budget)


@pytest.mark.parametrize("env", SLO_ENVS, ids=lambda e: ",".join(
    f"{k}={v}" for k, v in e.items()) or "unset")
def test_spec_defaults_and_env_overrides(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert spec_fields(slo.freshness_spec()) == spec_fields(
        jslo.freshness_spec())
    assert spec_fields(slo.seal_latency_spec()) == spec_fields(
        jslo.seal_latency_spec())
    assert [spec_fields(s) for s in slo.default_specs()] == [
        spec_fields(s) for s in jslo.default_specs()]
    # every default goes through the specs: gauges, cycle burns, reports
    for lag in (5, 9, 64, 65):
        status = {"divergence": {"watermark_lag": lag}}
        assert slo.sample_freshness(status) == jslo.sample_freshness(status)
        assert trace.snapshot()["gauges"] == {
            k: v for k, v in jtrace.snapshot()["gauges"].items()
            if k.startswith("repl_slo_")}
    results = [types.SimpleNamespace(sealed=True, error=None, latency_s=x)
               for x in (0.1, 0.6, 1.5, 2.5)]
    results.append(types.SimpleNamespace(sealed=False, error="x",
                                         latency_s=0.0))
    assert slo.cycle_burn(results) == jslo.cycle_burn(results)
    records = [
        {"ts": 10.0 * i, "replication": {"divergence": {"watermark_lag": i}}}
        for i in range(12)
    ] + [{"ts": 5.0 * i, "meta": {"slo": {"attempts": 4, "violations": i % 3}}}
         for i in range(9)]
    assert slo.burn_report(records, window_s=30.0) == jslo.burn_report(
        records, window_s=30.0)
    assert slo.format_burn(slo.burn_report(records)) == jslo.format_burn(
        jslo.burn_report(records))


# ---- CRDT_OBS_SINK_MAX_MB ---------------------------------------------------

SNAP = {"spans": {}, "counters": {"n": 1}, "gauges": {}}


def generations(path) -> list:
    out = []
    for p in (path, path.with_name(path.name + ".1")):
        out.append(p.read_bytes() if p.exists() else None)
    return out


@pytest.mark.parametrize("max_mb", ["0.0009", "0.0004", "banana", "-1", ""])
def test_sink_rotation_generations_match(tmp_path, monkeypatch, max_mb):
    """A serial run at a fixed clock: both packages leave the same bytes
    in the same generations; an unparsable or non-positive bound is
    off."""
    monkeypatch.setenv(sink.ENV_MAX_MB, max_mb)
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.5)
    monkeypatch.setattr(sink, "time", clock)
    monkeypatch.setattr(jsink, "time", clock)
    got = {}
    for name, mod in (("port", sink), ("jax", jsink)):
        path = tmp_path / f"{name}.jsonl"
        s = mod.MetricsSink(str(path))
        for i in range(20):
            s.write(f"rec-{i:02d}", snapshot=SNAP)
        got[name] = generations(path)
    assert got["port"] == got["jax"]
    rotated = got["port"][1] is not None
    assert rotated == (max_mb in ("0.0009", "0.0004"))


def test_env_opened_sink_rotates(tmp_path, monkeypatch):
    """``CRDT_OBS_SINK`` plus ``CRDT_OBS_SINK_MAX_MB``: the sink the
    environment opens rotates under ``maybe_write`` as the JAX one
    does."""
    monkeypatch.setattr(sink, "_configured", False)
    monkeypatch.setattr(jsink, "_configured", False)
    monkeypatch.setenv(sink.ENV_MAX_MB, "0.0005")
    clock = types.SimpleNamespace(time=lambda: 1_700_000_000.25)
    monkeypatch.setattr(sink, "time", clock)
    monkeypatch.setattr(jsink, "time", clock)
    got = {}
    for name, mod, tr in (("port", sink, trace), ("jax", jsink, jtrace)):
        path = tmp_path / f"env-{name}.jsonl"
        monkeypatch.setenv(mod.ENV_VAR, str(path))
        tr.reset()
        for i in range(12):
            tr.add("rows", i)
            mod.maybe_write(f"w{i}", meta={"i": i})
        got[name] = generations(path)
    assert got["port"] == got["jax"]
    assert got["port"][1] is not None


def test_sink_rotation_concurrent_writers(tmp_path, monkeypatch):
    """N threads through ``CRDT_OBS_SINK_MAX_MB`` rotation: the bound
    holds per generation, every record lands in exactly one generation,
    every record parses, and both packages end with the same number of
    generations and records."""
    n_threads, per_thread = 8, 6
    out = {}
    for name, mod in (("port", sink), ("jax", jsink)):
        monkeypatch.delenv(mod.ENV_MAX_MB, raising=False)
        path = tmp_path / f"rot-{name}.jsonl"
        s = mod.MetricsSink(str(path))
        probe = len(json.dumps(s.write("probe-00", snapshot=SNAP))) + 1
        total = n_threads * per_thread + 1
        # under the volume, past half of it: exactly one rotation
        limit = probe * (total - 4)
        monkeypatch.setenv(mod.ENV_MAX_MB, str(limit / 1e6))
        barrier = threading.Barrier(n_threads)

        def writer(i, s=s, barrier=barrier):
            barrier.wait()
            for k in range(per_thread):
                s.write(f"w-{i:03d}-{k:02d}", snapshot=SNAP)

        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        labels, gens = [], 0
        for p in (path, tmp_path / f"rot-{name}.jsonl.1"):
            if not p.exists():
                continue
            gens += 1
            assert p.stat().st_size <= int(limit / 1e6 * 1e6)
            records = mod.read_records(str(p))
            mod.check_schema(records, source=str(p))
            labels.extend(r["label"] for r in records)
        assert len(labels) == total == len(set(labels))
        out[name] = (gens, len(labels))
    assert out["port"] == out["jax"] == (2, n_threads * per_thread + 1)


# ---- obs.live ---------------------------------------------------------------


def test_live_configure_and_module_publishers():
    live._reset()
    jlive._reset()
    try:
        servers = {"port": live.configure(0), "jax": jlive.configure(0)}
        for srv in servers.values():
            assert srv is not None and srv.running and srv.port > 0
        assert live.default_server() is servers["port"]
        summary = {"tenants": 3, "paths": {"batched": 3}, "wall_s": 0.5}
        for mod in (live, jlive):
            mod.publish_cycle("fold_service", summary)
            mod.publish_daemon({"state": "running", "cycles": 2})
        sections = {}
        for name, srv in servers.items():
            h = srv.health()
            sections[name] = (h["cycles"], h["daemon"])
        assert sections["port"] == sections["jax"]
        assert sections["port"][1] == {"state": "running", "cycles": 2}
        # configure(None) stops the default server, and the environment
        # does not start another
        assert live.configure(None) is None
        assert not servers["port"].running
        assert live.default_server() is None
        live.publish_cycle("fold_service", summary)  # no server: a no-op
    finally:
        live._reset()
        jlive._reset()
