"""Cycle attribution: stage marginals, critical path, and the gap report.

The port's copy of ``crdt_enc_tpu/obs/attribution.py``: a pure function
over recorded span and event data (what ``obs.timeline`` reads) that
decomposes one streaming compaction or fold service cycle into the
canonical stage marginals

    ingest / decrypt / decode / h2d / fold / scatter / seal

computes the **overlap efficiency** (serialized stage sum ÷ wall; above
1 the pipeline hid work under the fold; with an event log, the
chunk-level proof of :func:`obs.timeline.chunk_overlaps`), names the
**critical-path stage**, and emits the **gap report**: end-to-end ops/s
against the fold-marginal ops/s, with the dominant stage named.
``obs_report gap`` renders it for sink records and for the bench
records of ``BENCH_LOCAL.jsonl``.

Span aggregates nest (``stream.ingest`` wraps ``stream.decode``;
``session.decode`` runs inside ``stream.decode``), so naive summing
double-counts.  Each stage is therefore a tuple of **groups**; within a
group the FIRST span present in the snapshot is taken, and disjoint
groups sum.

Two names the JAX package never emits map here: the port's pipelined
compaction reads its op files under ``ops.chunk_read`` (the whole-batch
flow's ``ops.load``), an ingest group of its own, and folds a map
session under ``session.map_fold``, a fold group of its own.  A record
the JAX package wrote attributes exactly as under the JAX package.
"""

from __future__ import annotations

from . import record, timeline

#: canonical stage order — ties on the critical path resolve to the
#: earliest stage, and reports render in this order.
STAGES = ("ingest", "decrypt", "decode", "h2d", "fold", "scatter", "seal")

# stage -> groups of alternative span names (module docs).  The
# streaming map covers the solo pipeline (ops/stream + session + the
# bulk/legacy core paths); the serve map covers a FoldService cycle.
_STREAM_STAGES: dict[str, tuple[tuple[str, ...], ...]] = {
    "ingest": (("ops.list",), ("ops.load",), ("ops.chunk_read",),
               ("states.list",), ("states.load",)),
    "decrypt": (("stream.decrypt", "ops.bulk_decrypt",
                 "ops.chunk_decrypt"),),
    "decode": (("stream.decode", "session.decode", "fold.decode"),),
    "h2d": (("stream.h2d",),),
    "fold": (("stream.reduce", "ops.bulk_fold", "ops.chunk_fold",
              "session.device_fold", "session.host_reduce",
              "fold.device", "ops.fold"),
             ("session.sparse_fold",), ("session.map_fold",)),
    "scatter": (("session.writeback", "stream.finish",
                 "fold.writeback"), ("stream.d2h",)),
    "seal": (("compact.seal",), ("compact.write",), ("compact.gc",),
             ("checkpoint.save",), ("delta.seal",), ("delta.verify",)),
}
_SERVE_STAGES: dict[str, tuple[tuple[str, ...], ...]] = {
    "ingest": (("serve.ingest",), ("serve.plan",)),
    "decrypt": (("serve.decrypt",),),
    "decode": (("serve.decode",),),
    "h2d": (),
    "fold": (("serve.fold", "serve.shard"),),  # shard: the JAX mesh fold
    "scatter": (("serve.scatter",),),
    # delta.cut (device-cut delta build, disjoint from serve.scatter)
    # and serve.continue (post-seal warm-entry stamping) are seal-phase
    # work: separate groups because they never nest inside serve.seal
    "seal": (("serve.seal",), ("delta.cut",), ("serve.continue",)),
}


def detect_pipeline(snapshot: dict) -> str:
    """``"serve"`` when the snapshot carries FoldService spans, else
    ``"streaming"`` — the two cycle shapes this profiler decomposes."""
    spans = snapshot.get("spans", {})
    return "serve" if any(n.startswith("serve.") for n in spans) \
        else "streaming"


def _stage_seconds(spans: dict, groups) -> tuple[float, dict[str, float]]:
    total = 0.0
    contributors: dict[str, float] = {}
    for group in groups:
        for name in group:
            v = spans.get(name)
            if v is not None:
                s = float(v.get("seconds", 0.0))
                total += s
                contributors[name] = round(s, 6)
                break  # first present alternative wins (nesting guard)
    return total, contributors


def attribute_cycle(
    snapshot: dict,
    *,
    pipeline: str | None = None,
    wall_s: float | None = None,
    ops: int | None = None,
    events: list | None = None,
) -> dict:
    """Decompose one recorded cycle (module docs).

    ``snapshot`` is a registry snapshot (``record.snapshot()`` /
    a sink record / a bench record's ``obs`` dict).  ``wall_s`` is the
    cycle wall clock when the caller measured it (bench does); else it
    is inferred from the event log's extent, or from the ``serve.cycle``
    span.  ``ops`` enables the throughput half of the gap report.
    ``events`` (the record's event log) additionally yields the
    chunk-level overlap proof."""
    with record.span("attribution.gap"):
        spans = snapshot.get("spans", {})
        # simulator harness spans (sim.run / sim.step / sim.check /
        # sim.population) WRAP the serve spans a sim service cycle
        # records — they are schedule bookkeeping, not cycle stages.
        # Drop them explicitly: left in, they would dominate the
        # event-extent wall inference and report a whole simulation as
        # one impossibly slow cycle.
        spans = {n: v for n, v in spans.items()
                 if not n.startswith("sim.")}
        pipe = pipeline or detect_pipeline(snapshot)
        stage_map = _SERVE_STAGES if pipe == "serve" else _STREAM_STAGES

        stages: dict[str, dict] = {}
        serialized = 0.0
        for stage in STAGES:
            s, contributors = _stage_seconds(spans, stage_map.get(stage, ()))
            stages[stage] = {"seconds": round(s, 6), "spans": contributors}
            serialized += s

        if wall_s is None and events:
            span_events = [e for e in events
                           if e.get("kind", "span") == "span"
                           and not str(e.get("name", "")).startswith("sim.")]
            if span_events:
                wall_s = (max(e["t1"] for e in span_events)
                          - min(e["t0"] for e in span_events))
        if wall_s is None and pipe == "serve":
            cyc = spans.get("serve.cycle")
            if cyc:
                wall_s = float(cyc["seconds"])

        critical = max(
            STAGES, key=lambda st: (stages[st]["seconds"],
                                    -STAGES.index(st))
        )
        report = {
            "pipeline": pipe,
            "stages": stages,
            "serialized_s": round(serialized, 6),
            "wall_s": round(wall_s, 6) if wall_s else None,
            "critical_path": critical,
            "critical_share": round(
                stages[critical]["seconds"] / serialized, 4
            ) if serialized > 0 else None,
        }
        if wall_s:
            report["overlap_x"] = round(serialized / wall_s, 4)
        if events:
            chunks = timeline.chunk_overlaps(
                timeline.to_chrome_trace(events)
            )
            report["overlapped_chunks"] = len(chunks)

        fold_s = stages["fold"]["seconds"]
        if ops and wall_s:
            gap = {
                "ops": int(ops),
                "e2e_ops_per_sec": round(ops / wall_s, 1),
                "dominant_stage": critical,
            }
            if fold_s > 0:
                gap["fold_marginal_ops_per_sec"] = round(ops / fold_s, 1)
                gap["gap_x"] = round(wall_s / fold_s, 2)
            report["gap"] = gap
        return report


def from_record(rec: dict) -> dict:
    """Attribution for one JSONL record of ANY of the shapes the repo
    writes: a bench record (``obs`` + shape/wall fields), or a sink
    record (snapshot at top level).  Pure: only reads the record."""
    if isinstance(rec.get("obs"), dict):
        snapshot = rec["obs"]
        wall = rec.get("e2e_overlapped_s") or rec.get("service_cycle_s")
        shape = rec.get("shape") or {}
        ops = shape.get("total_ops")
    else:
        snapshot = rec
        wall = None
        counters = rec.get("counters", {})
        # best-effort op count for sink records: the batched-tenant and
        # per-op paths count rows; the solo bulk paths count files only
        ops = counters.get("serve_rows_folded") or \
            counters.get("ops_folded") or None
    return attribute_cycle(
        snapshot,
        wall_s=float(wall) if wall else None,
        ops=int(ops) if ops else None,
        events=rec.get("events") or snapshot.get("events"),
    )


def format_attribution(report: dict) -> str:
    """Deterministic human rendering (golden-tested by the CLI test)."""
    lines = [f"# cycle attribution ({report['pipeline']} pipeline)"]
    serialized = report["serialized_s"]
    for stage in STAGES:
        st = report["stages"][stage]
        if not st["spans"]:
            continue
        share = 100.0 * st["seconds"] / serialized if serialized else 0.0
        names = ",".join(sorted(st["spans"]))
        lines.append(
            f"{stage:<8} {st['seconds']:>9.4f}s  {share:>5.1f}%  {names}"
        )
    wall = report.get("wall_s")
    tail = f"  wall {wall:.4f}s" if wall else ""
    if report.get("overlap_x") is not None:
        tail += f"  overlap {report['overlap_x']:.2f}x"
    if report.get("overlapped_chunks") is not None:
        tail += f"  overlapped_chunks={report['overlapped_chunks']}"
    lines.append(f"serialized sum {serialized:.4f}s{tail}")
    crit = report["critical_path"]
    share = report.get("critical_share")
    lines.append(
        f"critical path: {crit}"
        + (f" ({100.0 * share:.1f}% of serialized time)" if share else "")
    )
    gap = report.get("gap")
    if gap:
        if "gap_x" in gap:
            lines.append(
                f"gap: e2e {gap['e2e_ops_per_sec']:,.1f} ops/s vs fold "
                f"marginal {gap['fold_marginal_ops_per_sec']:,.1f} ops/s "
                f"= {gap['gap_x']:.2f}x  (dominant stage: "
                f"{gap['dominant_stage']})"
            )
        else:
            lines.append(
                f"gap: e2e {gap['e2e_ops_per_sec']:,.1f} ops/s; no fold "
                "stage recorded"
            )
    return "\n".join(lines)
