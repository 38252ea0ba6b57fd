"""The operator's read side of the port against the JAX package's.

``crdt_enc_tpu_torch.obs`` (``record`` event schema, ``sink`` reader,
``slo`` burn, ``timeline``, ``attribution``, ``fleet``) and
``crdt_enc_tpu_torch.tools.obs_report`` on the CPU: the same inputs go
through the JAX function and the port's, and the outputs must be equal —
report dicts and rendered text exactly, exit codes exactly, Chrome-trace
JSON exactly (synthetic events) or after rebasing the timestamps
(recorded runs).  Sink files cross in both directions: a file either
package writes renders the same text under either ``obs_report``.  The
two committed goldens (``tests/data/obs_gap_golden.txt``,
``obs_fleet_golden.txt``) render byte for byte under the port.
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import threading
import time

import numpy as np
import pytest
from _jax_gc_guard import hold_the_cyclic_collector  # noqa: F401 (autouse)

from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import adapters as jadapters
from crdt_enc_tpu.obs import attribution as jattribution
from crdt_enc_tpu.obs import fleet as jfleet
from crdt_enc_tpu.obs import record as jrecord
from crdt_enc_tpu.obs import sink as jsink
from crdt_enc_tpu.obs import slo as jslo
from crdt_enc_tpu.obs import timeline as jtimeline
from crdt_enc_tpu.sim import CoFireMatrix as JCoFireMatrix
from crdt_enc_tpu.tools import obs_report as jreport
from crdt_enc_tpu_torch import (
    Core,
    IdentityCryptor,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    ORSet,
    PlainKeyCryptor,
    TorchAccelerator,
    canonical_bytes,
)
from crdt_enc_tpu_torch.core import adapters as padapters
from crdt_enc_tpu_torch.obs import attribution, fleet, record, sink, slo, timeline
from crdt_enc_tpu_torch.parallel import accel as A
from crdt_enc_tpu_torch.parallel import session as PS
from crdt_enc_tpu_torch.tools import obs_report
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

DATA = pathlib.Path(__file__).parent / "data"
REPO = pathlib.Path(__file__).parent.parent
BENCH_LOCAL = str(REPO / "BENCH_LOCAL.jsonl")


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    for var in (jslo.ENV_FRESHNESS, jslo.ENV_SEAL, jslo.ENV_OBJECTIVE,
                jsink.ENV_MAX_MB):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.delenv("CRDT_OBS_SINK", raising=False)
    record.reset()
    jrecord.reset()
    sink.configure(None)
    jsink.configure(None)
    yield
    record.reset()
    jrecord.reset()
    sink.configure(None)
    jsink.configure(None)


def both_cli(capsys, argv) -> tuple:
    """``obs_report.main(argv)`` of each package: (rc, out, err) twice."""
    rc_j = jreport.main(list(argv))
    j = capsys.readouterr()
    rc_p = obs_report.main(list(argv))
    p = capsys.readouterr()
    return (rc_j, j.out, j.err), (rc_p, p.out, p.err)


def write_jsonl(path, records) -> str:
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def rebased(trace_obj: dict) -> dict:
    """A Chrome trace with its timestamps and durations zeroed: what is
    left is the lanes, names, order and args."""
    out = []
    for e in trace_obj["traceEvents"]:
        e = dict(e)
        for k in ("ts", "dur"):
            if k in e:
                e[k] = 0
        out.append(e)
    return {**trace_obj, "traceEvents": out}


# ---- fault 1: the event schema ---------------------------------------------


def record_two_lanes(rec_mod) -> list:
    """Spans on the main thread and on a worker, a counter and a gauge,
    with events on; returns the registry's events."""
    rec_mod.enable_events()
    with rec_mod.span("stream.ingest", meta=0):
        rec_mod.add("h2d_bytes", 4096)

    def worker():
        with rec_mod.span("stream.reduce", meta=0):
            rec_mod.gauge("stream_producers", 2)

    t = threading.Thread(target=worker, name="crdt-ingest-producer-0")
    t.start()
    t.join()
    return rec_mod.events()


def test_port_events_carry_the_jax_schema():
    """Every port event has the JAX keys: spans ``kind: "span"`` with
    ``tid``/``thread``; counter and gauge updates are events too.  The
    port adds the span tree and nothing else: ``id``, ``parent`` and
    ``root`` on a span, ``parent`` and ``root`` on a counter or gauge."""
    tree = {"span": ["id", "parent", "root"], "counter": ["parent", "root"],
            "gauge": ["parent", "root"]}
    pev = record_two_lanes(record)
    jev = record_two_lanes(jrecord)
    assert [(e["name"], e["kind"], sorted(e)) for e in pev] == [
        (e["name"], e["kind"], sorted([*e, *tree[e["kind"]]])) for e in jev]
    assert {e["kind"] for e in pev} == {"span", "counter", "gauge"}
    assert len({e["tid"] for e in pev if e["kind"] == "span"}) == 2
    counter = next(e for e in pev if e["kind"] == "counter")
    assert counter["value"] == 4096 and counter["t0"] == counter["t1"]


def test_port_sink_events_render_lanes_and_counter_tracks(tmp_path):
    """A sink record the port writes renders, under either package's
    timeline, one lane per recording thread and a counter track per
    counter or gauge — the same trace the JAX registry's events give."""
    record_two_lanes(record)
    rec = sink.MetricsSink(str(tmp_path / "run.jsonl")).write("lanes")
    record_two_lanes(jrecord)
    jrec = jsink.MetricsSink(str(tmp_path / "jrun.jsonl")).write("lanes")
    for tl in (jtimeline, timeline):
        obj = tl.to_chrome_trace(rec["events"])
        lanes = [e for e in obj["traceEvents"] if e["ph"] == "M"]
        assert len(lanes) == 2
        assert {e["args"]["name"] for e in lanes} == {
            threading.main_thread().name, "crdt-ingest-producer-0"}
        tracks = {e["name"]: e["args"]["value"]
                  for e in obj["traceEvents"] if e["ph"] == "C"}
        assert tracks == {"h2d_bytes": 4096, "stream_producers": 2}
        assert rebased(obj) == rebased(tl.to_chrome_trace(jrec["events"]))


def test_event_capacity_matches_the_jax_ring():
    for rec_mod in (record, jrecord):
        rec_mod.reset()
        rec_mod.enable_events()
        assert rec_mod.events_capacity() == 65536
        rec_mod.set_events_capacity(4)
        for i in range(6):
            with rec_mod.span("s", meta=i):
                pass
        assert [e["meta"] for e in rec_mod.events()] == [2, 3, 4, 5]
        rec_mod.set_events_capacity(2)
        assert rec_mod.snapshot()["counters"]["events_dropped"] == 4
        with pytest.raises(ValueError):
            rec_mod.set_events_capacity(0)
        rec_mod.reset()
        assert rec_mod.events_capacity() == 65536
        assert not rec_mod.events_enabled()


@pytest.mark.parametrize("seconds,count", [(0.5, 1000), (0.0, 5), (2.0, 0)])
def test_throughput_matches_the_jax_registry(seconds, count):
    for rec_mod in (record, jrecord):
        rec_mod.reset()
        if seconds:
            rec_mod.observe("stream.fold", seconds)
        if count:
            rec_mod.add("ops_folded", count)
    assert record.throughput("stream.fold", "ops_folded") == \
        jrecord.throughput("stream.fold", "ops_folded")


# ---- sink: reader and schema ----------------------------------------------


@pytest.mark.parametrize("bad", [99, "2", True, None, 2.0])
def test_check_schema_refuses_as_the_jax_reader(bad):
    records = [{"schema": 2}, {"schema": bad}, {}]
    with pytest.raises(jsink.SinkSchemaError) as je:
        jsink.check_schema(records, source="x.jsonl")
    with pytest.raises(sink.SinkSchemaError) as pe:
        sink.check_schema(records, source="x.jsonl")
    assert str(pe.value) == str(je.value)
    sink.check_schema([{"schema": 1}, {"schema": 2}, {}])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sink_files_read_in_the_other_package(tmp_path, writer):
    rec_mod, sink_mod = (jrecord, jsink) if writer == "jax" else (record, sink)
    path = tmp_path / "run.jsonl"
    rec_mod.observe("stream.fold", 0.01)
    rec_mod.add("ops_folded", 3)
    sink_mod.MetricsSink(str(path)).write("a", meta={"k": 1})
    with open(path, "a") as f:
        f.write("\n{\"truncated\": ")  # a killed run's last append
    assert sink.read_records(str(path)) == jsink.read_records(str(path))
    [rec] = sink.read_records(str(path))
    assert rec["schema"] == 2 and rec["meta"] == {"k": 1}


# ---- slo: burn accounting ---------------------------------------------------


def slo_records(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        ts = 1000.0 + float(rng.integers(0, 2000))
        if rng.random() < 0.5:
            out.append({"schema": 2, "label": "compact", "ts": ts,
                        "replication": {"divergence": {
                            "watermark_lag": int(rng.integers(0, 130))}}})
        else:
            n = int(rng.integers(0, 20))
            out.append({"schema": 2, "label": "serve_cycle", "ts": ts,
                        "meta": {"slo": {"attempts": n, "violations": int(
                            rng.integers(0, n + 1))}}})
    out.append({"schema": 2, "label": "no-ts"})
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("window", [60.0, 300.0])
def test_burn_report_matches_the_jax_function(seed, window):
    records = slo_records(seed)
    jrep = jslo.burn_report(records, window_s=window)
    prep = slo.burn_report(records, window_s=window)
    assert prep == jrep
    assert slo.format_burn(prep) == jslo.format_burn(jrep)


def test_burn_report_with_given_specs_and_no_samples():
    specs = [slo.SloSpec("freshness", "lag", 5.0),
             slo.SloSpec("seal_latency", "s", 1.0, objective=0.9)]
    jspecs = [jslo.SloSpec(s.name, s.indicator, s.target, s.objective)
              for s in specs]
    records = [{"ts": 1.0, "replication": {"divergence": {"watermark_lag": 9}}}]
    prep = slo.burn_report(records, specs)
    assert prep == jslo.burn_report(records, jspecs)
    assert prep["specs"][1]["samples"] == 0
    assert "(no samples)" in slo.format_burn(prep)
    assert prep["specs"][0]["budget_burn"] == 100.0


# ---- timeline --------------------------------------------------------------


def synthetic_events(serial: bool = False) -> list:
    """Two threads, four chunks: ingest k on the producer, reduce k on the
    consumer, overlapped (ingest k+1 inside reduce k) unless ``serial``;
    plus counter and gauge updates."""
    out = []
    for k in range(4):
        t0 = 3.0 * k if serial else 1.0 * k
        out.append({"name": "stream.ingest", "kind": "span", "t0": 10 + t0,
                    "t1": 10 + t0 + 1.0, "meta": k, "tid": 7,
                    "thread": "crdt-ingest-producer-0"})
        out.append({"name": "stream.reduce", "kind": "span",
                    "t0": 10 + t0 + 1.0, "t1": 10 + t0 + 2.0, "meta": k,
                    "tid": 3, "thread": "MainThread"})
        out.append({"name": "h2d_bytes", "kind": "counter",
                    "t0": 10 + t0 + 1.5, "t1": 10 + t0 + 1.5, "meta": None,
                    "value": 100 * (k + 1), "tid": 3, "thread": "MainThread"})
    out.append({"name": "stream_producers", "kind": "gauge", "t0": 10.0,
                "t1": 10.0, "meta": None, "value": 1, "tid": 3,
                "thread": "MainThread"})
    return out


@pytest.mark.parametrize("serial", [False, True])
def test_chrome_trace_equals_the_jax_export(tmp_path, serial):
    events = synthetic_events(serial)
    pobj = timeline.export_chrome_trace(str(tmp_path / "p.json"), events)
    jobj = jtimeline.export_chrome_trace(str(tmp_path / "j.json"), events)
    assert pobj == jobj
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    ks = timeline.chunk_overlaps(pobj)
    assert ks == jtimeline.chunk_overlaps(jobj)
    assert ks == ([] if serial else [0, 1, 2])
    assert timeline.to_chrome_trace([]) == jtimeline.to_chrome_trace([])


def test_chunk_overlaps_takes_the_last_run_only():
    """Two runs in one log (an overlapped one, then a serialized one):
    only the last run counts, in both packages."""
    run1 = synthetic_events(False)
    run2 = [dict(e, t0=e["t0"] + 100, t1=e["t1"] + 100)
            for e in synthetic_events(True)]
    obj = timeline.to_chrome_trace(run1 + run2)
    assert timeline.chunk_overlaps(obj) == []
    assert jtimeline.chunk_overlaps(jtimeline.to_chrome_trace(run1 + run2)) == []
    assert timeline.chunk_overlaps(
        timeline.to_chrome_trace(run1), "stream.ingest", "stream.reduce")


# ---- attribution -----------------------------------------------------------


def snap(spans: dict, counters=None) -> dict:
    return {"spans": {k: {"count": 1, "seconds": v} for k, v in spans.items()},
            "counters": counters or {}, "gauges": {}}


ATTRIBUTION_CASES = {
    "streaming": (snap({"stream.decrypt": 2.0, "stream.decode": 3.0,
                        "session.decode": 2.9, "stream.reduce": 1.0,
                        "stream.finish": 0.5}), dict(wall_s=5.0, ops=1000)),
    "bulk": (snap({"ops.bulk_decrypt": 1.0, "ops.bulk_fold": 4.0,
                   "compact.seal": 0.25, "compact.write": 0.25}),
             dict(wall_s=6.0, ops=600)),
    "serve": (snap({"serve.cycle": 2.0, "serve.decrypt": 0.5,
                    "serve.fold": 0.2, "serve.seal": 1.0}), dict(ops=400)),
    "nothing": (snap({"stream.decrypt": 1.0}), {}),
    "events": (snap({"stream.reduce": 2.0}),
               dict(events=synthetic_events(), ops=100)),
    "sim spans": (snap({"sim.run": 9.0, "serve.fold": 0.1,
                        "serve.seal": 0.2}), dict(ops=10)),
}


@pytest.mark.parametrize("case", sorted(ATTRIBUTION_CASES))
def test_attribute_cycle_matches_the_jax_function(case):
    s, kw = ATTRIBUTION_CASES[case]
    prep = attribution.attribute_cycle(s, **kw)
    assert prep == jattribution.attribute_cycle(s, **kw)
    assert attribution.format_attribution(prep) == \
        jattribution.format_attribution(prep)


@pytest.mark.parametrize("shape", ["bench", "sink"])
def test_from_record_matches_the_jax_function(shape):
    if shape == "bench":
        rec = {"metric": "orset_e2e_streaming_ops_per_sec",
               "e2e_overlapped_s": 2.0, "shape": {"total_ops": 1000},
               "obs": snap({"stream.decrypt": 1.5, "stream.reduce": 0.1})}
    else:
        rec = {"schema": 2, "label": "compact", "ts": 1.0,
               **snap({"serve.cycle": 1.0, "serve.fold": 0.5},
                      {"serve_rows_folded": 50})}
    assert attribution.from_record(rec) == jattribution.from_record(rec)


def port_compaction_record(tmp_path) -> dict:
    """A real port ``Core.compact()`` of 24 OR-Set op files through the
    pipelined route (a fold session), recorded through the port's sink."""
    remote = MemoryRemote()

    def opts():
        return OpenOptions(
            storage=MemoryStorage(remote), cryptor=IdentityCryptor(),
            key_cryptor=PlainKeyCryptor(), adapter=padapters.orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=True,
            accelerator=TorchAccelerator(device="cpu", min_device_batch=1))

    async def go():
        w = await Core.open(opts())
        for m in range(24):
            await w.update(lambda s, m=m: s.add_ctx(w.actor_id, m))
        path = tmp_path / "compact.jsonl"
        record.reset()
        sink.configure(str(path))
        c = await Core.open(opts())
        await c.compact()
        sink.configure(None)
        return sink.read_records(str(path))[-1]

    return run(go())


def test_port_compaction_attributes_chunk_read_to_ingest(tmp_path):
    """Fault 2: the port's pipelined compaction reads its op files under
    ``ops.chunk_read``; the stage map counts it as ingest, so ingest is
    not empty and the gap report does not miss the port's largest card
    stage."""
    rec = port_compaction_record(tmp_path)
    assert rec["label"] == "compact" and "ops.chunk_read" in rec["spans"]
    rep = attribution.from_record(rec)
    assert "ops.chunk_read" in rep["stages"]["ingest"]["spans"]
    assert rep["stages"]["ingest"]["seconds"] >= round(
        rec["spans"]["ops.chunk_read"]["seconds"], 6) - 1e-6
    # the JAX map has no such name: its ingest misses the read
    assert "ops.chunk_read" not in \
        jattribution.from_record(rec)["stages"]["ingest"]["spans"]


def test_map_session_fold_attributes_to_fold():
    s = snap({"ops.chunk_fold": 0.5, "session.map_fold": 2.0,
              "ops.chunk_read": 1.0})
    rep = attribution.attribute_cycle(s)
    assert rep["stages"]["fold"]["seconds"] == 2.5
    assert rep["stages"]["ingest"]["spans"] == {"ops.chunk_read": 1.0}
    assert rep["critical_path"] == "fold"


def test_gap_golden_renders_byte_for_byte(capsys):
    """The committed golden, under the port, and the JAX CLI's output."""
    argv = ["gap", BENCH_LOCAL, "--metric", "orset_e2e_streaming_ops_per_sec"]
    j, p = both_cli(capsys, argv)
    assert p == j
    assert p[0] == 0
    assert p[1] == (DATA / "obs_gap_golden.txt").read_text()


# ---- fleet -----------------------------------------------------------------


A_ID, B_ID, C_ID = b"\xaa" * 16, b"\xbb" * 16, b"\xcc" * 16
RID = b"\x99" * 32


def dev_record(actor, local, union, files, nbytes, wm_lag, ts=100.0,
               remote=RID, quarantined=0, excluded=()):
    return {
        "schema": 2, "label": "compact", "ts": ts, "spans": {},
        "counters": {"ingest_quarantined": quarantined}, "gauges": {},
        "replication": {
            "actor": actor.hex(), "remote_id": remote.hex(),
            "local_clock": {k.hex(): v for k, v in local.items()},
            "union_clock": {k.hex(): v for k, v in union.items()},
            "watermark": {k.hex(): v for k, v in local.items()},
            "matrix": {},
            "backlog": {"files": files, "bytes": nbytes, "per_actor": {}},
            "divergence": {"actors_behind": 0, "version_lag": 0,
                           "watermark_lag": wm_lag, "known_replicas": 2},
            "checkpoint": {"enabled": True, "sealed": True,
                           "staleness_versions": 0},
            **({"membership": {"excluded": list(excluded)}}
               if excluded else {}),
        },
    }


def fleet_files(tmp_path) -> list:
    pa = write_jsonl(tmp_path / "a.jsonl", [
        dev_record(A_ID, {A_ID: 3, B_ID: 2}, {A_ID: 3, B_ID: 2}, 0, 0, 0)])
    pb = write_jsonl(tmp_path / "b.jsonl", [
        dev_record(B_ID, {A_ID: 1}, {A_ID: 1}, 0, 0, 0, ts=50.0),
        dev_record(B_ID, {A_ID: 3}, {A_ID: 3, B_ID: 2}, 2, 410, 5, ts=150.0,
                   quarantined=2)])
    pc = write_jsonl(tmp_path / "c.jsonl", [
        dev_record(C_ID, {C_ID: 9}, {C_ID: 9}, 1, 7, 99, ts=7.0,
                   remote=b"\x77" * 32, excluded=["x"])])
    return [pa, pb, pc]


def test_fleet_report_matches_the_jax_aggregator(tmp_path):
    paths = fleet_files(tmp_path)
    prep = fleet.fleet_report(fleet.device_summaries(paths))
    jrep = jfleet.fleet_report(jfleet.device_summaries(paths))
    assert prep == jrep
    assert fleet.format_fleet(prep) == jfleet.format_fleet(jrep)
    main = next(r for r in prep["remotes"] if r["remote_id"] == RID.hex())
    assert main["stable_watermark"] == {A_ID.hex(): 3}
    assert main["lag"] == {"min": 0, "p50": 0, "p99": 2, "max": 2}


@pytest.mark.parametrize("bad", ["no replication", "future schema"])
def test_fleet_refuses_inputs_loudly(tmp_path, bad):
    if bad == "no replication":
        p = write_jsonl(tmp_path / "p.jsonl", [{"schema": 2, "spans": {}}])
        exc = fleet.FleetInputError
    else:
        p = write_jsonl(tmp_path / "p.jsonl", [{"schema": 3, "replication": {}}])
        exc = sink.SinkSchemaError
    with pytest.raises(exc):
        fleet.device_summaries([p])


def bench(metric, value, ts, shape=None, **kw):
    return {"metric": metric, "value": value, "ts": ts, "unit": "ops/s",
            "backend": "cpu", "shape": shape or {"n": 1000},
            "best_variant": "v", **kw}


TREND_CASES = {
    "synthetic": [bench("fold", 100.0, "t1"), bench("fold", 120.0, "t2"),
                  bench("fold", 90.0, "t3"),
                  bench("fold", 500.0, "t1", shape={"n": 9}),
                  bench("merge", 50.0, "t1"),
                  {"metric": "sim", "value": 1.3, "ts": "t1", "config": "a"},
                  {"schema": 2, "label": "compact", "spans": {}}],
    "bench_local": None,
}


@pytest.mark.parametrize("case", sorted(TREND_CASES))
@pytest.mark.parametrize("pct", [10.0, 30.0])
def test_bench_trend_matches_the_jax_function(case, pct):
    records = TREND_CASES[case] or sink.read_records(BENCH_LOCAL)
    ptrend = fleet.bench_trend(records)
    jtrend = jfleet.bench_trend(records)
    assert ptrend == jtrend
    preg = fleet.trend_regressions(ptrend, pct)
    jreg = jfleet.trend_regressions(jtrend, pct)
    assert preg == jreg
    assert fleet.format_trend(ptrend, preg) == jfleet.format_trend(jtrend, jreg)


# ---- obs_report, subcommand by subcommand ----------------------------------


def two_runs(tmp_path) -> tuple:
    """Two sink files of one label, written by the port."""
    paths = []
    for label, seconds in (("old", 0.010), ("new", 0.030)):
        record.reset()
        record.observe("stream.fold", seconds)
        record.observe("stream.fold", seconds / 3)
        record.add("ops_folded", 10 if label == "old" else 13)
        record.gauge("stream_producers", 2)
        p = tmp_path / f"{label}.jsonl"
        sink.MetricsSink(str(p)).write("run")
        paths.append(str(p))
    return tuple(paths)


@pytest.mark.parametrize("argv", [
    ["report", "{old}"],
    ["report", "{old}", "--label", "run", "--index", "0"],
    ["diff", "{old}", "{new}"],
    ["prom", "{new}"],
    ["prom", "{new}", "--timestamp"],
    ["gap", "{new}"],
    ["gap", "{new}", "--json"],
    ["slo", "{old}", "{new}"],
    ["report", BENCH_LOCAL],
])
def test_cli_text_and_exit_codes_match(tmp_path, capsys, argv):
    old, new = two_runs(tmp_path)
    argv = [a.format(old=old, new=new) for a in argv]
    j, p = both_cli(capsys, argv)
    assert p == j
    assert p[0] == 0


@pytest.mark.parametrize("argv,rc", [
    (["gap", BENCH_LOCAL, "--metric", "orset_multitenant_agg_ops_per_sec",
      "--json"], 0),
    (["gap", "{empty}"], 2),
    (["gap", "{future}"], 2),
    (["slo", "{future}"], 2),
    (["trend", "{future}"], 2),
    (["fleet", "{empty}"], 2),
    (["trend", BENCH_LOCAL], 0),
    (["trend", BENCH_LOCAL, "--fail-on-regression", "45"], 0),
    (["trend", "{regressed}", "--fail-on-regression", "10"], 1),
    (["trend", "{regressed}", "--json"], 0),
    (["slo", "{burning}"], 0),
    (["slo", "{burning}", "--fail-on-burn"], 1),
    (["slo", "{burning}", "--json", "--window", "60"], 0),
])
def test_cli_refusals_and_gates_match(tmp_path, capsys, argv, rc):
    files = {
        "empty": write_jsonl(tmp_path / "empty.jsonl",
                             [{"metric": "x", "value": 1.0}]),
        "future": write_jsonl(tmp_path / "future.jsonl",
                              [{"schema": 99, "label": "compact",
                                "spans": {}}]),
        "regressed": write_jsonl(tmp_path / "reg.jsonl", [
            bench("fold", 100.0, "t1"), bench("fold", 80.0, "t2")]),
        "burning": write_jsonl(tmp_path / "burn.jsonl", [
            {"schema": 2, "ts": 0.0, "replication": {
                "divergence": {"watermark_lag": 0}}},
            {"schema": 2, "ts": 1.0, "replication": {
                "divergence": {"watermark_lag": 100}}}]),
    }
    argv = [a.format(**files) for a in argv]
    j, p = both_cli(capsys, argv)
    if argv[0] == "fleet":
        # the JAX message also names its replication-sampling knob, which
        # the port does not have; the refusal itself is the same
        assert p[:2] == j[:2]
        assert p[2].split(" — ")[0] == j[2].split(" — ")[0]
    else:
        assert p == j
    assert p[0] == rc


def test_fleet_golden_renders_byte_for_byte(capsys):
    argv = ["fleet", str(DATA / "fleet_device_a.jsonl"),
            str(DATA / "fleet_device_b.jsonl")]
    j, p = both_cli(capsys, argv)
    assert p == j
    assert p[0] == 0
    assert p[1] == (DATA / "obs_fleet_golden.txt").read_text()
    j, p = both_cli(capsys, argv + ["--json"])
    assert p == j


def test_simcov_renders_the_jax_matrix(tmp_path, capsys):
    from crdt_enc_tpu.sim import FaultConfig as JFaultConfig
    from crdt_enc_tpu.sim import generate as jgenerate
    from crdt_enc_tpu.sim import run_schedule as jrun_schedule

    matrix = JCoFireMatrix()
    for seed in range(2):
        s = jgenerate(seed, 3, 40, JFaultConfig.all_faults())
        matrix.record(s, jrun_schedule(s))
    path = str(tmp_path / "cov.json")
    matrix.dump(path)
    for argv in (["simcov", path], ["simcov", path, "--json"]):
        j, p = both_cli(capsys, argv)
        assert p == j and p[0] == 0
    bad = write_jsonl(tmp_path / "bad.json", [{"nope": 1}])
    j, p = both_cli(capsys, ["simcov", bad])
    assert p[0] == j[0] == 2


def test_export_trace_without_events_exits_2(tmp_path, capsys):
    old, _ = two_runs(tmp_path)
    rc = obs_report.main(["export-trace", old, "-o", str(tmp_path / "t.json")])
    assert rc == 2
    assert "no event log" in capsys.readouterr().err


@pytest.mark.parametrize("serial", [False, True])
def test_export_trace_check_overlap_matches(tmp_path, capsys, serial):
    path = write_jsonl(tmp_path / "run.jsonl", [{
        "schema": 2, "label": "e2e", "ts": 1.0, "spans": {}, "counters": {},
        "gauges": {}, "events": synthetic_events(serial)}])
    out_j, out_p = tmp_path / "j.json", tmp_path / "p.json"
    rc_j = jreport.main(["export-trace", path, "-o", str(out_j),
                         "--check-overlap", "stream.ingest:stream.reduce"])
    j = capsys.readouterr()
    rc_p = obs_report.main(["export-trace", path, "-o", str(out_p),
                            "--check-overlap", "stream.ingest:stream.reduce"])
    p = capsys.readouterr()
    assert (rc_p, p.err) == (rc_j, j.err)
    assert rc_p == (1 if serial else 0)
    assert out_p.read_text() == out_j.read_text()
    assert p.out.replace(str(out_p), "T") == j.out.replace(str(out_j), "T")


# ---- the streaming run: a recorded overlap proof ---------------------------


def test_export_trace_proves_overlap_on_a_port_streaming_run(
        tmp_path, capsys, monkeypatch):
    """A recorded ``fold_encrypted_stream`` run of the port (6 chunks, 2
    producers, the reducer slowed by 5 ms so a pipelined run shows chunk
    k+1's ingest inside reduce k on any box): both packages'
    ``export-trace --check-overlap stream.ingest:stream.reduce`` exit 0
    on the port's sink file, with equal traces."""
    from crdt_enc_tpu_torch.ops import stream as S
    from tests.test_torch_stream import encrypted_orset_workload

    monkeypatch.setattr(A, "ENCRYPTED_STREAM_CHUNKS", 6)
    monkeypatch.setattr(S, "stream_producer_count", lambda: 2)
    real_reduce = PS.OrsetFoldSession.reduce_chunk

    def slow_reduce(self, decoded):
        time.sleep(0.005)
        return real_reduce(self, decoded)

    monkeypatch.setattr(PS.OrsetFoldSession, "reduce_chunk", slow_reduce)
    key, blobs, hint, host = encrypted_orset_workload(n_files=60,
                                                      ops_per_file=8)
    state = ORSet()
    record.enable_events()
    assert TorchAccelerator(device="cpu", min_device_batch=1) \
        .fold_encrypted_stream(state, key, blobs, actors_hint=hint)
    assert canonical_bytes(state) == canonical_bytes(host)
    path = str(tmp_path / "run.jsonl")
    rec = sink.MetricsSink(path).write("e2e-streaming")
    assert len({e["tid"] for e in rec["events"]}) >= 2
    outs = {}
    for name, main in (("jax", jreport.main), ("port", obs_report.main)):
        out = tmp_path / f"{name}.json"
        rc = main(["export-trace", path, "-o", str(out),
                   "--check-overlap", "stream.ingest:stream.reduce"])
        assert rc == 0, capsys.readouterr()
        assert "overlap proof" in capsys.readouterr().out
        outs[name] = json.loads(out.read_text())
    assert outs["port"] == outs["jax"]
    assert timeline.chunk_overlaps(outs["port"])


# ---- sink files across the packages ----------------------------------------


def jax_compaction_record(tmp_path) -> str:
    remote = JMemoryRemote()

    def opts():
        return JOpenOptions(
            storage=JMemoryStorage(remote), cryptor=JIdentityCryptor(),
            key_cryptor=JPlainKeyCryptor(), adapter=jadapters.orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=True,
            accelerator=jadapters.HostAccelerator())

    async def go():
        w = await JCore.open(opts())
        for m in range(24):
            await w.update(lambda s, m=m: s.add_ctx(w.actor_id, m))
        path = tmp_path / "jcompact.jsonl"
        jrecord.reset()
        jsink.configure(str(path))
        c = await JCore.open(opts())
        await c.compact()
        jsink.configure(None)
        return str(path)

    return run(go())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("cmd", ["report", "prom", "gap", "fleet", "slo"])
def test_a_compaction_record_renders_the_same_under_either_reader(
        tmp_path, capsys, writer, cmd):
    """A ``Core.compact()`` sink record written by either package renders
    the same text and exit code under both ``obs_report``s."""
    if writer == "jax":
        path = jax_compaction_record(tmp_path)
    else:
        port_compaction_record(tmp_path)
        path = str(tmp_path / "compact.jsonl")
    recs = sink.read_records(path)
    assert recs and isinstance(recs[-1].get("replication"), dict)
    j, p = both_cli(capsys, [cmd, path])
    assert p[0] == j[0] == 0
    if cmd == "gap" and writer == "port":
        # fault 2: the port's op reads (ops.chunk_read) are ingest under
        # the port's map and unattributed under the JAX one
        ingest = {r: next(ln for ln in out[1].splitlines()
                          if ln.startswith("ingest"))
                  for r, out in (("jax", j), ("port", p))}
        assert "ops.chunk_read" in ingest["port"]
        assert "ops.chunk_read" not in ingest["jax"]
        # every other stage lists the same spans under both maps
        def others(out):
            return [(ln.split()[0], ln.split()[-1])
                    for ln in out.splitlines()
                    if ln.split()[:1] and ln.split()[0] in (
                        "decrypt", "decode", "h2d", "fold", "scatter", "seal")]
        assert others(p[1]) == others(j[1])
    else:
        assert p == j
