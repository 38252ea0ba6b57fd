"""The ingest pipelines', the fold service's and the fleet daemon's
settings, held against the JAX package on the CPU.

* ``stream_producer_count(requested)`` and ``CRDT_STREAM_PRODUCERS`` (the
  twin of tests/test_streaming_pipeline.py::test_producer_count_resolution);
* ``run_ingest_pipeline``: order, errors, the depth bound, worker lanes
  and bytes at 1–3 producers, each case run through both packages'
  pipelines (the twins of that file's ``run_ingest_pipeline`` cases);
  ``run_striped_ingest_pipeline``'s ``depth``, ``inline`` and
  ``thread_prefix``;
* ``ServeConfig(producers, io_width)``: a service cycle at each width
  seals the default cycle's bytes and the JAX service's, and its decode
  fan-out runs through ``run_ingest_pipeline`` at that width;
* ``DaemonConfig(interval_auto, interval_min_s, interval_max_s,
  burn_window_s)``: the same ``next_interval`` sequence on an injected
  clock (the twin of tests/test_strong_reads.py::
  test_daemon_wall_clock_interval_follows_slo_burn), also through real
  cycles; ``max_tenants``: the same admission refusals;
  ``TRANSIENT_ERRORS``: the same classes and backoff log lines.

Every comparison is exact, except the intervals, which are compared with
``pytest.approx`` (relative 1e-6) as the JAX test does.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import threading
import time

import numpy as np
import pytest
from _jax_gc_guard import hold_the_cyclic_collector  # noqa: F401 (autouse)
from test_torch_daemon import SIDES, Pair, quick_cfg, twin_fleet
from test_torch_serve import Fleet, sealed, write_orset
from test_torch_stream import assert_no_producer_threads, bounded

from crdt_enc_tpu import ops as JK
from crdt_enc_tpu.backends import xchacha as jx
from crdt_enc_tpu.serve import FoldService as JFoldService
from crdt_enc_tpu.serve import ServeConfig as JServeConfig
from crdt_enc_tpu.serve import daemon as jdaemon_mod
from crdt_enc_tpu.utils import trace as jtrace
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.ops import stream as S
from crdt_enc_tpu_torch.serve import FoldService, ServeConfig
from crdt_enc_tpu_torch.serve import daemon as daemon_mod
from crdt_enc_tpu_torch.utils import trace

PIPELINES = {"port": S, "jax": JK}


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("CRDT_STREAM_PRODUCERS", raising=False)
    trace.reset()
    jtrace.reset()
    yield
    trace.enable_events(False)
    trace.reset()
    jtrace.reset()


# ---- stream_producer_count --------------------------------------------------


@pytest.mark.parametrize("env", [None, "7", "1", "not-a-number", "0", "-3",
                                 " "])
@pytest.mark.parametrize("requested", [0, 2, -1])
def test_producer_count_resolution(monkeypatch, env, requested):
    if env is not None:
        monkeypatch.setenv("CRDT_STREAM_PRODUCERS", env)
    got = S.stream_producer_count(requested)
    assert got == JK.stream_producer_count(requested)
    auto = max(1, (S.os.cpu_count() or 1) - 1)
    if requested > 0:
        assert got == requested
    elif env in ("7", "1"):
        assert got == int(env)
    else:
        assert got == auto
    assert S.stream_producer_count() == JK.stream_producer_count()


# ---- run_ingest_pipeline ----------------------------------------------------


def events_by_name(name):
    return sorted((e for e in trace.events() if e["name"] == name),
                  key=lambda e: e["meta"])


@pytest.mark.parametrize("producers", [1, 2, 3])
def test_ingest_pipeline_order_deterministic(producers):
    delays = np.random.default_rng(17).random(24) * 0.01
    got = {}
    for name, mod in PIPELINES.items():
        order = []

        def ingest(span, k):
            time.sleep(delays[k])
            return span * 10

        bounded(lambda: mod.run_ingest_pipeline(
            list(range(24)), ingest, lambda item, k: order.append((k, item)),
            producers=producers))
        got[name] = order
    assert got["port"] == got["jax"] == [(k, 10 * k) for k in range(24)]


@pytest.mark.parametrize("producers", [1, 3])
def test_ingest_pipeline_producer_error_drains_the_prefix(producers):
    delays = np.random.default_rng(3).random(30) * 0.008
    got = {}
    for name, mod in PIPELINES.items():
        reduced = []

        def ingest(span, k):
            time.sleep(delays[k])
            if k == 7:
                raise ValueError("producer boom")
            return span

        with pytest.raises(mod.PipelineError) as ei:
            bounded(lambda: mod.run_ingest_pipeline(
                list(range(30)), ingest, lambda item, k: reduced.append(k),
                producers=producers))
        got[name] = (reduced, type(ei.value.__cause__), str(ei.value))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (list(range(7)), ValueError)
    assert_no_producer_threads()
    order = []
    S.run_ingest_pipeline(list(range(10)), lambda s, k: s,
                          lambda i, k: order.append(k), producers=3)
    assert order == list(range(10))


@pytest.mark.parametrize("producers,depth", [(1, 2), (3, 4)])
def test_ingest_pipeline_consumer_error_stops_the_pool(producers, depth):
    for mod in PIPELINES.values():
        ingested = []

        def ingest(span, k):
            ingested.append(k)
            return span

        def reduce(item, k):
            raise RuntimeError("reduce failed")

        with pytest.raises(RuntimeError, match="reduce failed"):
            bounded(lambda: mod.run_ingest_pipeline(
                list(range(50)), ingest, reduce, depth=depth,
                producers=producers))
        assert len(ingested) <= depth + producers
    assert_no_producer_threads()


@pytest.mark.parametrize("producers,depth", [(1, 2), (2, 3), (3, 0)])
def test_ingest_pipeline_depth_bound(producers, depth):
    """Chunk k+depth's ingest cannot start before chunk k's reduce
    released its slot (depth 0: producers + 1)."""
    trace.reset()
    trace.enable_events()
    bounded(lambda: S.run_ingest_pipeline(
        list(range(8)), lambda span, k: span,
        lambda item, k: time.sleep(0.02), depth=depth, producers=producers))
    trace.enable_events(False)
    ingests = events_by_name("stream.ingest")
    reduces = events_by_name("stream.reduce")
    bound = depth or max(2, producers + 1)
    assert [e["meta"] for e in reduces] == list(range(8))
    for k in range(len(ingests) - bound):
        assert ingests[k + bound]["t0"] >= reduces[k]["t1"], k


def test_ingest_pipeline_lanes_gauge_and_overlap():
    trace.reset()
    trace.enable_events()
    bounded(lambda: S.run_ingest_pipeline(
        list(range(6)), lambda span, k: time.sleep(0.02) or span,
        lambda item, k: time.sleep(0.05), producers=2,
        thread_prefix="crdt-test-lane"))
    trace.enable_events(False)
    assert trace.snapshot()["gauges"]["stream_producers"] == 2
    ingests = events_by_name("stream.ingest")
    reduces = events_by_name("stream.reduce")
    assert {e["thread"] for e in ingests} <= {"crdt-test-lane-0",
                                              "crdt-test-lane-1"}
    assert {"stream.producer.wait", "stream.sequence"} <= {
        e["name"] for e in trace.events()}
    assert any(ingests[k + 1]["t0"] < reduces[k]["t1"] for k in range(5))


@pytest.mark.parametrize("producers", [1, 2, 3])
def test_ingest_pipeline_bytes_at_every_width(producers):
    """Encrypted spans decrypted by the producers and joined by the
    consumer: the bytes of every width equal one decrypt of the whole
    and the JAX pipeline's over the JAX decrypt."""
    rng = np.random.default_rng(producers)
    key = secrets.token_bytes(32)
    blobs = [px.encrypt_blob(key, rng.bytes(int(rng.integers(1, 300))))
             for _ in range(60)]
    spans = [blobs[i:i + 7] for i in range(0, len(blobs), 7)]
    want = b"".join(bytes(v) for v in px.decrypt_blobs(key, blobs))
    got = {}
    for name, mod, xc in (("port", S, px), ("jax", JK, jx)):
        out = []
        bounded(lambda: mod.run_ingest_pipeline(
            spans,
            lambda span, k: b"".join(bytes(v) for v in
                                     xc.decrypt_blobs(key, span, 1)),
            lambda item, k: out.append(item), producers=producers))
        got[name] = b"".join(out)
    assert got["port"] == got["jax"] == want


# ---- run_striped_ingest_pipeline: depth, inline, thread_prefix --------------


def test_striped_inline_auto_on_single_core(monkeypatch):
    """One producer on a one-core host runs inline, no worker thread, as
    the JAX pipeline does; ``inline=False`` still threads."""
    monkeypatch.setattr(S.os, "cpu_count", lambda: 1)
    spawned = []
    real_thread = threading.Thread

    class SpyThread(real_thread):
        def __init__(self, *a, **kw):
            spawned.append(kw.get("name"))
            super().__init__(*a, **kw)

    monkeypatch.setattr(S.threading, "Thread", SpyThread)
    order = []
    S.run_striped_ingest_pipeline(
        list(range(6)), lambda sp, k: [0, 1], lambda it, k, s: (k, s),
        lambda parts, sp, k: (k, parts), lambda item, k: order.append(item),
        producers=1)
    assert order == [(k, [(k, 0), (k, 1)]) for k in range(6)]
    assert spawned == []
    bounded(lambda: S.run_striped_ingest_pipeline(
        list(range(2)), lambda sp, k: [0], lambda it, k, s: 0,
        lambda p, sp, k: 0, lambda i, k: None, producers=1, inline=False,
        thread_prefix="crdt-test-stripe"))
    assert [n for n in spawned if n] == ["crdt-test-stripe-0"]


@pytest.mark.parametrize("producers,depth", [(1, 3), (2, 2)])
def test_striped_depth_bound(producers, depth):
    trace.reset()
    trace.enable_events()
    bounded(lambda: S.run_striped_ingest_pipeline(
        list(range(8)), lambda span, k: [span], lambda st, k, s: st,
        lambda parts, span, k: parts[0], lambda item, k: time.sleep(0.02),
        depth=depth, producers=producers, inline=False))
    trace.enable_events(False)
    stripes = events_by_name("stream.stripe")
    reduces = events_by_name("stream.reduce")
    for k in range(len(stripes) - depth):
        assert stripes[k + depth]["t0"] >= reduces[k]["t1"], k


# ---- ServeConfig(producers, io_width) ---------------------------------------


class WidthFleet(Fleet):
    VARIANTS = ("default", "port", "jax")


@pytest.mark.parametrize("producers", [1, 3])
@pytest.mark.parametrize("io_width", [1, 4])
def test_service_widths_seal_the_default_and_jax_bytes(tmp_path, monkeypatch,
                                                       producers, io_width):
    """Two cycles (all ops, then a tail on three tenants) over six
    tenants: the service at ``producers``/``io_width`` seals what the
    default service and the JAX service at the same widths seal, and
    its decode runs through ``run_ingest_pipeline`` at that width."""
    widths, pipeline_producers = [], []
    real_sem = asyncio.Semaphore
    real_pipeline = S.run_ingest_pipeline

    class RecordingSemaphore(real_sem):
        def __init__(self, value=1):
            widths.append(value)
            super().__init__(value)

    def recording_pipeline(*a, **kw):
        pipeline_producers.append(kw.get("producers"))
        return real_pipeline(*a, **kw)

    monkeypatch.setattr(S, "run_ingest_pipeline", recording_pipeline)

    async def scenario():
        fleet = WidthFleet(str(tmp_path))
        for t, n in ((1, 23), (2, 41), (3, 17), (4, 60), (5, 9)):
            async def w(core, n=n, t=t):
                await write_orset(core, n, b"w%d" % t)
            await fleet.add("orset", w)

        async def gc(core):
            for _ in range(12):
                await core.apply_ops([core.with_state(
                    lambda s: s.inc(core.actor_id))])

        await fleet.add("gcounter", gc)
        fleet.freeze()
        default, port, jax = [await fleet.open(v) for v in fleet.VARIANTS]
        cfg = dict(producers=producers, io_width=io_width)
        services = (FoldService(default), FoldService(port, ServeConfig(**cfg)),
                    JFoldService(jax, JServeConfig(**cfg)))
        for cycle in range(2):
            if cycle:
                for t in (0, 2, 3):
                    await write_orset(fleet.writers[t], 8, b"tail%d" % t,
                                      rm_every=3)
                fleet.sync_tails()
            widths.clear()
            pipeline_producers.clear()
            results = []
            for i, svc in enumerate(services):
                if i == 1:
                    monkeypatch.setattr(asyncio, "Semaphore",
                                        RecordingSemaphore)
                    trace.reset()
                try:
                    results.append(await svc.run_cycle())
                finally:
                    monkeypatch.setattr(asyncio, "Semaphore", real_sem)
                if i == 1:
                    assert trace.snapshot()["gauges"]["stream_producers"] \
                        == producers
            assert widths == [io_width, io_width]  # the ingest and the seal
            d, p, j = ([(r.path, r.rows, r.sealed) for r in res]
                       for res in results)
            assert p == d == j
            assert "batched" in {path for path, _, _ in p}
            for t in range(len(default)):
                sd, sp, sj = [await sealed(c[t]) for c in (default, port, jax)]
                assert sp == sd, f"tenant {t}: widths change the bytes"
                assert sp == sj, f"tenant {t}: port service != JAX service"
        # the default service resolves its width from the cores
        assert pipeline_producers[0] == S.stream_producer_count()
        assert pipeline_producers[1] == producers

    run(scenario())


def test_service_producers_follow_the_environment(monkeypatch):
    monkeypatch.setenv("CRDT_STREAM_PRODUCERS", "2")
    seen = []
    real = S.run_ingest_pipeline

    def spy(*a, **kw):
        seen.append(kw["producers"])
        return real(*a, **kw)

    monkeypatch.setattr(S, "run_ingest_pipeline", spy)

    async def scenario():
        for cfg in (ServeConfig(), ServeConfig(producers=5)):
            _, fleet = await twin_fleet([(15, b"env"), (9, b"env2")])
            await FoldService([c for c, _ in fleet["port"]], cfg).run_cycle()

    run(scenario())
    assert seen == [2, 5]


# ---- DaemonConfig: the burn-paced interval ----------------------------------


def test_daemon_wall_clock_interval_follows_slo_burn():
    """The JAX test's sequence on both daemons at once, one clock."""
    async def scenario():
        t = [0.0]
        daemons = {side.name: side.Daemon([], quick_cfg(
            side, interval_auto=True, interval_min_s=0.1,
            interval_max_s=10.0, burn_window_s=30.0), clock=lambda: t[0])
            for side in SIDES}
        seq = {name: [] for name in daemons}
        for name, d in daemons.items():
            seq[name].append(d.next_interval())
            d._burn_window[:] = [(1.0, 5, 0)]
        t[0] = 2.0
        for name, d in daemons.items():
            seq[name].append(d.next_interval())
            # a window burning at half the budget: the geometric middle
            d._burn_window[:] = [(1.0, 1, 199)]
            seq[name].append(d.next_interval())
        t[0] = 40.0
        for name, d in daemons.items():
            d._note_burn(64.0)
            assert d._burn_window == [(40.0, 0, 0)]
            seq[name].append(d.next_interval())
            d.config.interval_auto = False
            seq[name].append(d.next_interval())
            await d.drain()
        assert seq["port"] == pytest.approx(seq["jax"], rel=1e-6)
        assert seq["port"] == pytest.approx(
            [10.0, 0.1, 1.0, 10.0, daemons["port"].config.interval_s],
            rel=1e-6)

    run(scenario())


def test_daemon_interval_through_cycles(monkeypatch):
    """Real cycles feed the window: with a freshness target every tenant
    misses, the interval falls from ``interval_max_s`` to
    ``interval_min_s``; once the target is met again and the bad samples
    age out of the window, it climbs back.  Both daemons, one clock."""
    async def scenario():
        t = [0.0]
        _, fleet = await twin_fleet([(11, b"ia"), (7, b"ib"), (0, b"ic")])
        pair = Pair(fleet, lambda side: quick_cfg(
            side, interval_auto=True, interval_min_s=0.05,
            interval_max_s=8.0, burn_window_s=5.0), clock=lambda: t[0])
        seq = {"port": [], "jax": []}

        def sample():
            seq["port"].append(pair.port.next_interval())
            seq["jax"].append(pair.jax.next_interval())

        sample()
        monkeypatch.setenv("CRDT_SLO_FRESHNESS_LAG", "-1")
        for step in range(3):
            t[0] = 1.0 + step
            await pair.cycle()
            sample()
        monkeypatch.delenv("CRDT_SLO_FRESHNESS_LAG")
        for step in range(3):
            t[0] = 10.0 + 4 * step
            await pair.cycle()
            sample()
        assert seq["port"] == pytest.approx(seq["jax"], rel=1e-6)
        assert seq["port"][0] == pytest.approx(8.0)
        assert seq["port"][1:4] == pytest.approx([0.05] * 3)
        assert seq["port"][-1] == pytest.approx(8.0)
        assert pair.port._burn_window == pair.jax._burn_window
        await pair.d["port"].drain()
        await pair.d["jax"].drain()

    run(scenario())


# ---- DaemonConfig.max_tenants, TRANSIENT_ERRORS -----------------------------


@pytest.mark.parametrize("cap", [1, 2, 3])
def test_max_tenants_refusals_match(cap):
    async def scenario():
        _, fleet = await twin_fleet([(5, b"m0"), (0, b"m1"), (0, b"m2"),
                                     (0, b"m3")])
        outcomes = {}
        for side in SIDES:
            cores = [c for c, _ in fleet[side.name]]
            d = side.Daemon(cores[:1], quick_cfg(side, max_tenants=cap))
            got = []
            for core in cores[1:]:
                try:
                    got.append(await d.admit(core))
                except side.AdmissionError as e:
                    got.append(f"refused: {e}")
            outcomes[side.name] = (got, d.tenant_ids)
            await d.drain()
        assert outcomes["port"] == outcomes["jax"]
        refused = sum(str(x).startswith("refused") for x in
                      outcomes["port"][0])
        assert refused == 4 - cap

    run(scenario())


def test_transient_errors_classify_the_backoff_log(caplog):
    assert daemon_mod.TRANSIENT_ERRORS == jdaemon_mod.TRANSIENT_ERRORS

    async def scenario():
        _, fleet = await twin_fleet([(6, b"tr"), (4, b"tr2")],
                                    flaky_tenants=(1,))
        pair = Pair(fleet, lambda side: quick_cfg(side, quarantine_after=9))
        pair.set_broken(1, True)
        for _ in range(3):
            await pair.cycle()
        await pair.d["port"].drain()
        await pair.d["jax"].drain()

    with caplog.at_level(logging.INFO):
        run(scenario())
    lines = {"port": [], "jax": []}
    for rec in caplog.records:
        if "backing off" not in rec.getMessage():
            continue
        name = "port" if rec.name.startswith("crdt_enc_tpu_torch") else "jax"
        lines[name].append(rec.getMessage())
    assert lines["port"] == lines["jax"]
    assert lines["port"] and all("(transient failure" in m
                                 for m in lines["port"])
