"""Observability of the port on the CPU: the registry's histograms and
counter taps, the replication status, the metrics sink, the SLO burn, the
live telemetry endpoints and the runtime build counter.

Each piece is held against its JAX twin where one exists (the same
inputs give the same quantiles, status dict, Prometheus text and burn),
and the live endpoints are read over HTTP on an ephemeral 127.0.0.1
port.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import stat
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.obs import record as jrecord
from crdt_enc_tpu.obs import replication as jreplication
from crdt_enc_tpu.obs import sink as jsink
from crdt_enc_tpu.obs import slo as jslo
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    orset_adapter,
)
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.obs import live, record, replication, runtime, sink, slo
from crdt_enc_tpu_torch.ops import cuda_build
from crdt_enc_tpu_torch.serve import FoldService
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


def run(coro):
    return asyncio.run(coro)


def make_opts(storage, create=True, **kw):
    kw.setdefault("accelerator", TorchAccelerator(device="cpu",
                                                  min_device_batch=1))
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create, **kw,
    )


def jopts(storage, create=True):
    return JOpenOptions(
        storage=storage, cryptor=JXChaChaCryptor(),
        key_cryptor=JPlainKeyCryptor(), adapter=jadapters.orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=jadapters.HostAccelerator(),
    )


@pytest.fixture(autouse=True)
def clean_registry():
    trace.reset()
    sink.configure(None)
    yield
    trace.reset()
    sink.configure(None)


# ---- the registry ----------------------------------------------------------


def test_trace_is_the_record_module():
    """``utils.trace`` and ``obs.record`` are one module object, so every
    old call site writes the one registry the new modules read."""
    assert trace is record
    trace.add("shared_counter", 3)
    assert record.snapshot()["counters"]["shared_counter"] == 3


@pytest.mark.parametrize("seed", range(4))
def test_histogram_quantiles_match_the_jax_registry(seed):
    """The same durations give the same p50/p95/p99 in both packages'
    registries (log-scale buckets, midpoints chosen off the edges)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-40, 10, 200)
    durations = [2.0 ** ((int(i) + 0.5) / 4) for i in idx]
    jrecord.reset()
    for d in durations:
        record.observe("serve.tenant", d)
        jrecord.observe("serve.tenant", d)
    mine = record.snapshot()["spans"]["serve.tenant"]
    theirs = jrecord.snapshot()["spans"]["serve.tenant"]
    jrecord.reset()
    assert mine["count"] == theirs["count"] == 200
    for q in ("p50_ms", "p95_ms", "p99_ms"):
        assert mine[q] == theirs[q]
    assert record.quantiles_ms({}, 0) == {}
    table = record.format_snapshot(record.snapshot())
    assert "serve.tenant" in table and "p99" in table
    assert record.format_snapshot({}) == "(no spans recorded)"


def test_counter_tap_sees_its_own_task_tree_only():
    async def scenario():
        async def work(n):
            trace.add("tapped", n)
            await asyncio.to_thread(trace.add, "tapped", n)

        with trace.counter_tap() as outer:
            with trace.counter_tap() as inner:
                await work(2)
            await work(1)
        trace.add("tapped", 100)  # outside every tap
        return outer, inner

    outer, inner = run(scenario())
    assert inner == {"tapped": 4}
    assert outer == {"tapped": 6}
    assert trace.snapshot()["counters"]["tapped"] == 106


def test_drain_consumes_the_event_log():
    trace.enable_events()
    with trace.span("a"):
        pass
    assert [e["name"] for e in trace.drain_events()] == ["a"]
    assert trace.drain_events() == []
    assert trace.events_enabled()


# ---- replication status ----------------------------------------------------


def _random_inputs(seed, VC):
    rng = np.random.default_rng(seed)
    actors = [bytes([i]) * 16 for i in range(1, 7)]
    me = actors[0]
    local = VC({a: int(rng.integers(0, 6)) for a in actors[:4]})
    matrix = {
        r: VC({a: int(rng.integers(0, 8)) for a in actors[:5]})
        for r in actors[1:1 + int(rng.integers(0, 4))]
    }
    backlog = []
    for a in actors[2:5]:
        for v in range(local.get(a) + 1, local.get(a) + 1 + int(
                rng.integers(0, 3))):
            backlog.append((a, v, int(rng.integers(10, 500))))
    ckpt = ({a: int(rng.integers(0, 4)) for a in actors[:3]}
            if seed % 2 else None)
    return me, local, matrix, backlog, b"\x07" * 32, ckpt, bool(seed % 3)


@pytest.mark.parametrize("seed", range(8))
def test_compute_status_matches_the_jax_function(seed):
    mine = replication.compute_status(*_random_inputs(seed, VClock))
    theirs = jreplication.compute_status(*_random_inputs(seed, JVClock))
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)


def test_sample_publishes_the_gauges():
    status = replication.compute_status(*_random_inputs(3, VClock))
    replication.sample(status)
    snap = trace.snapshot()
    assert snap["gauges"]["repl_backlog_files"] == status["backlog"]["files"]
    assert snap["gauges"]["repl_watermark_lag"] == \
        status["divergence"]["watermark_lag"]
    assert snap["counters"]["repl_samples"] == 1


def test_replication_status_matches_the_jax_core(tmp_path):
    """A port core and a JAX core with the same identity on one remote
    (two producers, one published cursor, one op file of backlog) report
    the same status, byte for byte under ``json.dumps(sort_keys=True)``."""

    async def scenario():
        remote = str(tmp_path / "remote")
        w1 = await JCore.open(jopts(JFsStorage(str(tmp_path / "w1"), remote)))
        w2 = await Core.open(make_opts(FsStorage(str(tmp_path / "w2"), remote)))
        for i in range(3):
            await w1.update(lambda s, i=i: s.add_ctx(w1.actor_id, b"a%d" % i))
        await w2.update(lambda s: s.add_ctx(w2.actor_id, b"b"))
        await w1.compact()  # publishes w1's cursor
        await w2.update(lambda s: s.add_ctx(w2.actor_id, b"c"))
        port = await Core.open(make_opts(FsStorage(str(tmp_path / "me"),
                                                   remote)))
        shutil.copytree(str(tmp_path / "me"), str(tmp_path / "me-jax"))
        jax = await JCore.open(jopts(JFsStorage(str(tmp_path / "me-jax"),
                                                remote), create=False))
        assert port.actor_id == jax.actor_id
        for core in (port, jax):
            await core._read_remote_meta()
            await core._read_remote_states()
        mine = await port.replication_status()
        theirs = await jax.replication_status()
        assert mine["backlog"]["files"] == 1  # w2's second op
        assert json.dumps(mine, sort_keys=True) == json.dumps(
            theirs, sort_keys=True)
        assert port.last_replication_status is mine

    run(scenario())


def test_failed_probe_samples_nothing_and_the_compaction_completes():
    """A storage whose size probe fails: the open's sample (a backlog to
    probe) records nothing and the open goes on; the compaction folds
    the backlog, and its post-seal sample, with no op file left to
    probe, records the status."""
    class FailingProbe(MemoryStorage):
        async def stat_ops(self, actor_first_versions):
            raise OSError("probe down")

    async def scenario():
        remote = MemoryRemote()
        writer = await Core.open(make_opts(MemoryStorage(remote)))
        await writer.update(lambda s: s.add_ctx(writer.actor_id, b"x"))
        trace.reset()
        core = await Core.open(make_opts(FailingProbe(remote)))
        assert core.last_replication_status is None
        assert "repl_samples" not in trace.snapshot()["counters"]
        await core.compact()
        return core

    core = run(scenario())
    assert core.last_replication_status["backlog"]["files"] == 0
    assert trace.snapshot()["counters"]["repl_samples"] == 1
    assert core.with_state(lambda s: b"x" in s.entries)


# ---- the sink --------------------------------------------------------------


def test_compact_and_cycle_append_sink_records(tmp_path):
    path = str(tmp_path / "run.jsonl")
    sink.configure(path)

    async def scenario():
        remote = MemoryRemote()
        core = await Core.open(make_opts(MemoryStorage(remote)))
        await core.update(lambda s: s.add_ctx(core.actor_id, b"x"))
        await core.compact()
        tenant = await Core.open(make_opts(MemoryStorage(MemoryRemote())))
        await FoldService([tenant]).run_cycle()
        return core

    core = run(scenario())
    recs = [json.loads(ln) for ln in open(path) if ln.strip()]
    labels = [r["label"] for r in recs]
    assert labels.count("compact") == 2 and labels[-1] == "serve_cycle"
    first = recs[0]
    assert first["schema"] == sink.SCHEMA_VERSION == jsink.SCHEMA_VERSION
    assert first["meta"] == {"gc_op_actors": 1, "gc_states": 0}
    assert first["replication"]["actor"] == core.actor_id.hex()
    assert {"spans", "counters", "gauges", "ts"} <= set(first)
    cycle = recs[-1]["meta"]
    assert cycle["tenants"] == 1 and cycle["paths"] == {"empty": 1}
    assert cycle["slo"]["sealed"] == 1


def test_sink_rotates_past_its_bound(tmp_path):
    path = str(tmp_path / "run.jsonl")
    s = sink.MetricsSink(path, max_bytes=200)
    for i in range(3):
        s.write("r%d" % i, snapshot={"spans": {}, "counters": {"n": i},
                                     "gauges": {}})
    assert os.path.exists(path + ".1")
    assert json.loads(open(path).read().strip())["label"] == "r2"


def test_default_sink_follows_the_environment(tmp_path, monkeypatch):
    sink._configured = False
    monkeypatch.setenv(sink.ENV_VAR, str(tmp_path / "env.jsonl"))
    assert sink.default_sink().path == str(tmp_path / "env.jsonl")
    assert sink.maybe_write("probe") is not None
    monkeypatch.delenv(sink.ENV_VAR)
    assert sink.default_sink() is None and sink.maybe_write("x") is None


def test_prometheus_text_matches_the_jax_exposition():
    snap = {
        "spans": {"serve.cycle": {"count": 2, "seconds": 0.5,
                                  "max_ms": 300.0, "p50_ms": 250.0,
                                  "p95_ms": 300.0, "p99_ms": 300.0}},
        "counters": {"serve_cycles": 2, "h2d_bytes": 4096},
        "gauges": {"serve_buckets": 3, "repl_watermark_lag": 0},
    }
    assert sink.to_prometheus(snap, timestamp=1700000000.0) == \
        jsink.to_prometheus(snap, timestamp=1700000000.0)
    text = sink.to_prometheus(snap)
    assert "# TYPE crdt_serve_cycles_total counter" in text
    assert 'crdt_span_seconds{span="serve.cycle",quantile="0.99"}' in text


# ---- SLO --------------------------------------------------------------------


@pytest.mark.parametrize("lat", [[0.1, 0.5, 3.0], [0.1], [], [9.0, 9.0]])
def test_cycle_burn_matches_the_jax_function(lat):
    results = [SimpleNamespace(sealed=True, error=None, latency_s=x)
               for x in lat]
    results += [SimpleNamespace(sealed=False, error="boom", latency_s=0.0),
                SimpleNamespace(sealed=False, error=None, latency_s=0.0)]
    assert slo.cycle_burn(results) == jslo.cycle_burn(results)
    burn = slo.cycle_burn(results)
    assert burn["attempts"] == len(lat) + 1  # the error counts, the skip not


@pytest.mark.parametrize("which", ["FRESHNESS", "SEAL_LATENCY"])
def test_slo_specs_match_the_jax_defaults(which):
    spec = (slo.freshness_spec() if which == "FRESHNESS"
            else slo.seal_latency_spec())
    theirs = (jslo.freshness_spec() if which == "FRESHNESS"
              else jslo.seal_latency_spec())
    assert (spec.name, spec.indicator, spec.target, spec.objective,
            spec.budget) == (theirs.name, theirs.indicator, theirs.target,
                             theirs.objective, theirs.budget)
    status = {"divergence": {"watermark_lag": 70}}
    assert slo.sample_freshness(status) is False
    assert trace.snapshot()["gauges"]["repl_slo_freshness_ok"] == 0.0
    assert slo.sample_freshness({"divergence": {"watermark_lag": 64}})


# ---- the live endpoints ----------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_live_endpoints_on_an_ephemeral_port():
    srv = live.LiveTelemetryServer(port=0)
    port = srv.start()
    try:
        assert srv.running and port > 0 and srv.host == "127.0.0.1"
        trace.add("serve_cycles", 1)
        status = replication.compute_status(*_random_inputs(5, VClock))
        srv.publish_health(status)
        srv.publish_cycle("fold_service", {"tenants": 3})
        code, ctype, body = _get(port, "/metrics")
        assert code == 200 and ctype.startswith("text/plain")
        assert b"crdt_serve_cycles_total 1" in body
        code, ctype, body = _get(port, "/healthz")
        health = json.loads(body)
        assert code == 200 and ctype == "application/json"
        assert health["cycles"] == {"fold_service": {"tenants": 3}}
        dev = health["remotes"][status["remote_id"]]["devices"][
            status["actor"]]
        assert dev["watermark"] == status["watermark"]
        assert "watermark_age_s" in dev and "matrix" not in dev
        code, _, body = _get(port, "/snapshot")
        assert json.loads(body)["counters"]["serve_cycles"] == 1
        code, _, _ = _get(port, "/nope")
        assert code == 404
    finally:
        srv.stop()
    assert not srv.running


def test_fold_service_publishes_to_its_live_server():
    async def scenario():
        tenant = await Core.open(make_opts(MemoryStorage(MemoryRemote())))
        await tenant.update(lambda s: s.add_ctx(tenant.actor_id, b"m"))
        service = FoldService([tenant], live_port=0)
        try:
            await service.run_cycle()
            _, _, body = _get(service.live.port, "/healthz")
        finally:
            service.close()
        service.close()  # a second close is a no-op
        return tenant, json.loads(body)

    tenant, health = run(scenario())
    # the tenant folded its own op at apply: nothing new to fold
    assert health["cycles"]["fold_service"]["paths"] == {"empty": 1}
    remote = tenant.last_replication_status["remote_id"]
    assert tenant.actor_id.hex() in health["remotes"][remote]["devices"]


def test_default_server_from_the_environment(monkeypatch):
    live._reset()
    monkeypatch.setenv(live.ENV_VAR, "0")
    try:
        srv = live.default_server()
        assert srv is not None and srv.running
        live.publish({"remote_id": "r", "actor": "a", "watermark": {}})
        assert "r" in srv.health()["remotes"]
    finally:
        live.shutdown()
    assert live.default_server() is None


# ---- runtime ---------------------------------------------------------------


def test_build_counter_and_device_memory_on_the_cpu():
    runtime.note_build("cuda", 0.5, n=3)
    runtime.note_build("native", 0.25)
    assert runtime.build_count() == 4
    snap = trace.snapshot()
    assert snap["counters"]["cuda_builds"] == 3
    assert snap["spans"]["build.native"]["count"] == 1
    assert runtime.sample_device_memory("cpu") is None


def test_a_kernel_build_counts(tmp_path, monkeypatch):
    """``cuda_build.build`` records each library it compiles (a stand-in
    compiler that writes its ``-o`` target)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "nvcc", lambda: str(fake))
    cuda_build.build(["orset_fold", "lww_fold"])
    assert runtime.build_count() == 2
    cuda_build.build(["orset_fold", "lww_fold"])  # present: no build
    assert runtime.build_count() == 2
