"""Observability entry point: phase tables, timelines, diffs, fleet
reports, cycle attribution and SLO burn over sink files.

The port's copy of ``crdt_enc_tpu/tools/obs_report.py``.  It reads the
JSONL files the metrics sink writes (``obs.sink``, ``CRDT_OBS_SINK``) —
either package's — and the obs snapshots embedded in
``BENCH_LOCAL.jsonl`` records, and does no device work::

    python -m crdt_enc_tpu_torch.tools.obs_report report RUN.jsonl
    python -m crdt_enc_tpu_torch.tools.obs_report export-trace RUN.jsonl \\
        -o trace.json [--check-overlap stream.ingest:stream.reduce]
    python -m crdt_enc_tpu_torch.tools.obs_report diff OLD.jsonl NEW.jsonl
    python -m crdt_enc_tpu_torch.tools.obs_report prom RUN.jsonl [--timestamp]
    python -m crdt_enc_tpu_torch.tools.obs_report fleet DEV1.jsonl DEV2.jsonl
    python -m crdt_enc_tpu_torch.tools.obs_report trend BENCH_LOCAL.jsonl \\
        [--metric M] [--fail-on-regression PCT]
    python -m crdt_enc_tpu_torch.tools.obs_report gap RUN.jsonl [--metric M]
    python -m crdt_enc_tpu_torch.tools.obs_report slo RUN.jsonl \\
        [--window S] [--fail-on-burn]
    python -m crdt_enc_tpu_torch.tools.obs_report simcov COVERAGE.json

* **report** — the per-phase table (totals, counts, p50/p95/p99/max)
  plus counters and gauges of one record.
* **export-trace** — Chrome-trace/Perfetto JSON from a record's event
  log; with ``--check-overlap A:B`` the exit code asserts chunk k+1's
  stage A started before chunk k's stage B finished (exit 1 when the
  recorded run was serialized).
* **diff** — phase-by-phase seconds/count/p99 deltas between two runs.
* **prom** — the record in the Prometheus text exposition format.
* **fleet** — several devices' sink files merged (``obs.fleet``): the
  fleet stable watermark, each device's lag, backlog quantiles.
* **trend** — the per-config trajectory over BENCH_LOCAL.jsonl;
  ``--fail-on-regression PCT`` exits 1 when a config's latest run is
  more than PCT percent below its best earlier run.
* **gap** — cycle attribution (``obs.attribution``): stage marginals,
  overlap, the critical-path stage and the e2e-vs-fold-marginal gap.
* **slo** — freshness and seal-latency burn (``obs.slo``);
  ``--fail-on-burn`` exits 1 when a spec's budget burn exceeds 1.0x.
* **simcov** — a simulator co-fire matrix (``tools.sim explore
  --coverage-out``).

Record selection: ``--label`` filters by snapshot label, ``--index``
picks among matches (default -1, the newest).  Exit 2 for an input that
cannot contribute (no event log for export-trace, no replication record
for fleet, an unreadable sink schema).
"""

from __future__ import annotations

import argparse
import json
import sys

from ..obs import attribution as obs_attribution
from ..obs import fleet as obs_fleet
from ..obs import record as obs_record
from ..obs import sink as obs_sink
from ..obs import slo as obs_slo
from ..obs import timeline as obs_timeline

# one parse for the file format, shared with obs.fleet (obs.sink owns it)
load_records = obs_sink.read_records


def pick_record(records: list[dict], label: str | None, index: int) -> dict:
    """One record by label filter + index; the embedded ``obs`` dict of a
    bench record is hoisted so BENCH_LOCAL.jsonl works directly."""
    if label is not None:
        records = [r for r in records if r.get("label") == label]
    if not records:
        raise SystemExit(f"no matching records (label={label!r})")
    try:
        rec = records[index]
    except IndexError:
        raise SystemExit(
            f"index {index} out of range ({len(records)} matching records)"
        ) from None
    if "spans" not in rec and isinstance(rec.get("obs"), dict):
        rec = {**rec["obs"], "label": rec.get("metric", "bench")}
    return rec


def _fmt_label(rec: dict) -> str:
    lab = rec.get("label", "?")
    ts = rec.get("ts")
    return f"{lab} @ {ts}" if ts else str(lab)


def cmd_report(args) -> int:
    rec = pick_record(load_records(args.file), args.label, args.index)
    print(f"# {_fmt_label(rec)}")
    print(obs_record.format_snapshot(rec))
    return 0


def cmd_prom(args) -> int:
    rec = pick_record(load_records(args.file), args.label, args.index)
    ts = rec.get("ts") if args.timestamp else None
    sys.stdout.write(obs_sink.to_prometheus(rec, timestamp=ts))
    return 0


def cmd_fleet(args) -> int:
    try:
        summaries = obs_fleet.device_summaries(args.files)
    except (obs_fleet.FleetInputError, obs_sink.SinkSchemaError, OSError) as e:
        print(e, file=sys.stderr)
        return 2
    report = obs_fleet.fleet_report(summaries)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(obs_fleet.format_fleet(report))
    return 0


def cmd_trend(args) -> int:
    try:
        records = load_records(args.file)
        obs_sink.check_schema(records, source=args.file)
    except (obs_sink.SinkSchemaError, OSError) as e:
        print(e, file=sys.stderr)
        return 2
    trend = obs_fleet.bench_trend(records, metric=args.metric)
    regressed = (
        obs_fleet.trend_regressions(trend, args.fail_on_regression)
        if args.fail_on_regression is not None
        else []
    )
    if args.json:
        print(json.dumps({"trend": trend, "regressions": regressed},
                         sort_keys=True))
    else:
        print(obs_fleet.format_trend(trend, regressed))
    if regressed:
        print(
            f"{len(regressed)} config(s) regressed more than "
            f"{args.fail_on_regression}% vs prior best",
            file=sys.stderr,
        )
        return 1
    return 0


def cmd_gap(args) -> int:
    try:
        records = load_records(args.file)
        # refuse newer sink schemas loudly instead of attributing a
        # format this build cannot read (same contract as slo/trend)
        obs_sink.check_schema(records, source=args.file)
    except (obs_sink.SinkSchemaError, OSError) as e:
        print(e, file=sys.stderr)
        return 2
    if args.label is not None:
        records = [r for r in records if r.get("label") == args.label]
    if args.metric is not None:
        records = [r for r in records if r.get("metric") == args.metric]
    # attribution needs a snapshot: a bench record's "obs" or a sink
    # record's top-level spans
    records = [
        r for r in records
        if isinstance(r.get("obs"), dict) or "spans" in r
    ]
    if not records:
        print(
            f"no attributable records (label={args.label!r}, "
            f"metric={args.metric!r}) — need an 'obs' snapshot or "
            "top-level spans",
            file=sys.stderr,
        )
        return 2
    try:
        rec = records[args.index]
    except IndexError:
        print(
            f"index {args.index} out of range "
            f"({len(records)} matching records)",
            file=sys.stderr,
        )
        return 2
    report = obs_attribution.from_record(rec)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(f"# {_fmt_label(rec) if 'label' in rec else rec.get('metric', '?')}")
        print(obs_attribution.format_attribution(report))
    return 0


def cmd_slo(args) -> int:
    records = []
    try:
        for path in args.files:
            recs = load_records(path)
            obs_sink.check_schema(recs, source=path)
            records.extend(recs)
    except (obs_sink.SinkSchemaError, OSError) as e:
        print(e, file=sys.stderr)
        return 2
    report = obs_slo.burn_report(records, window_s=args.window)
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        print(obs_slo.format_burn(report))
    if args.fail_on_burn:
        burning = [
            s["name"] for s in report["specs"]
            if s.get("budget_burn", 0.0) > 1.0
        ]
        if burning:
            print(
                f"SLO budget burn > 1.0x for: {', '.join(burning)}",
                file=sys.stderr,
            )
            return 1
    return 0


def cmd_export_trace(args) -> int:
    rec = pick_record(load_records(args.file), args.label, args.index)
    events = rec.get("events")
    if not events:
        print(
            "record has no event log (run with trace.enable_events() / "
            "CRDT_OBS_SINK and events on)",
            file=sys.stderr,
        )
        return 2
    trace_obj = obs_timeline.export_chrome_trace(args.output, events)
    n = len(trace_obj["traceEvents"])
    print(f"wrote {n} trace events to {args.output}")
    if args.check_overlap:
        earlier, _, later = args.check_overlap.partition(":")
        ks = obs_timeline.chunk_overlaps(trace_obj, earlier, later or earlier)
        if not ks:
            print(
                f"NO overlap: no chunk's {earlier} started before the "
                f"previous chunk's {later} finished",
                file=sys.stderr,
            )
            return 1
        print(
            f"overlap proof: chunk k+1 {earlier} started inside chunk k "
            f"{later} for k in {ks}"
        )
    return 0


def cmd_diff(args) -> int:
    a = pick_record(load_records(args.old), args.label, args.index)
    b = pick_record(load_records(args.new), args.label, args.index)
    print(f"# old: {_fmt_label(a)}\n# new: {_fmt_label(b)}")
    names = sorted(set(a.get("spans", {})) | set(b.get("spans", {})))
    if names:
        w = max(len(n) for n in names)
        print(
            f"{'span':<{w}}  {'old s':>10}  {'new s':>10}  {'Δ%':>8}"
            f"  {'count':>11}  {'p99 ms':>17}"
        )
        for n in names:
            sa = a.get("spans", {}).get(n, {})
            sb = b.get("spans", {}).get(n, {})
            va, vb = sa.get("seconds", 0.0), sb.get("seconds", 0.0)
            pct = f"{100.0 * (vb - va) / va:+.1f}%" if va else "new"
            cnt = f"{sa.get('count', 0)}->{sb.get('count', 0)}"
            p99 = (
                f"{sa.get('p99_ms', 0.0):.3f}->{sb.get('p99_ms', 0.0):.3f}"
            )
            print(
                f"{n:<{w}}  {va:>10.4f}  {vb:>10.4f}  {pct:>8}"
                f"  {cnt:>11}  {p99:>17}"
            )
    cnames = sorted(set(a.get("counters", {})) | set(b.get("counters", {})))
    for n in cnames:
        va = a.get("counters", {}).get(n, 0)
        vb = b.get("counters", {}).get(n, 0)
        if va != vb:
            print(f"{n} = {va} -> {vb} ({vb - va:+d})")
    return 0


def cmd_simcov(args) -> int:
    from ..sim import CoFireMatrix

    try:
        matrix = CoFireMatrix.load(args.file)
    except (OSError, ValueError, KeyError) as e:
        print(f"{args.file}: unreadable coverage matrix: {e!r}",
              file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(matrix.to_obj(), sort_keys=True))
    else:
        print(matrix.render())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="crdt_enc_tpu_torch.tools.obs_report",
        description=__doc__.splitlines()[0],
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--label", help="filter records by snapshot label")
        p.add_argument(
            "--index", type=int, default=-1,
            help="which matching record (default -1, the newest)",
        )

    p = sub.add_parser("report", help="per-phase table for one record")
    p.add_argument("file")
    common(p)
    p.set_defaults(fn=cmd_report)

    p = sub.add_parser(
        "export-trace", help="Chrome-trace/Perfetto JSON from a record"
    )
    p.add_argument("file")
    p.add_argument("-o", "--output", required=True)
    p.add_argument(
        "--check-overlap", metavar="EARLIER:LATER",
        help="exit 1 unless chunk k+1's EARLIER span overlaps chunk k's "
        "LATER span (e.g. stream.ingest:stream.reduce)",
    )
    common(p)
    p.set_defaults(fn=cmd_export_trace)

    p = sub.add_parser("diff", help="phase deltas between two runs")
    p.add_argument("old")
    p.add_argument("new")
    common(p)
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("prom", help="Prometheus text exposition")
    p.add_argument("file")
    p.add_argument(
        "--timestamp", action="store_true",
        help="stamp every sample with the record's ts (ms epoch)",
    )
    common(p)
    p.set_defaults(fn=cmd_prom)

    p = sub.add_parser(
        "gap",
        help="cycle attribution + e2e-vs-fold-marginal gap report",
    )
    p.add_argument("file")
    p.add_argument("--metric", help="filter bench records by metric")
    p.add_argument("--json", action="store_true", help="machine output")
    common(p)
    p.set_defaults(fn=cmd_gap)

    p = sub.add_parser(
        "slo", help="SLO burn accounting over sink files"
    )
    p.add_argument("files", nargs="+", metavar="RUN.jsonl")
    p.add_argument(
        "--window", type=float, default=obs_slo.DEFAULT_WINDOW_S,
        help="burn window in seconds (default %(default)s)",
    )
    p.add_argument(
        "--fail-on-burn", action="store_true",
        help="exit 1 when any spec's overall budget burn exceeds 1.0x",
    )
    p.add_argument("--json", action="store_true", help="machine output")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "fleet", help="aggregate devices' sink files into one fleet report"
    )
    p.add_argument("files", nargs="+", metavar="DEVICE.jsonl")
    p.add_argument("--json", action="store_true", help="machine output")
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser(
        "simcov",
        help="render a fault-class × vocabulary co-fire matrix "
        "(tools.sim explore --coverage-out)",
    )
    p.add_argument("file", metavar="COVERAGE.json")
    p.add_argument("--json", action="store_true", help="machine output")
    p.set_defaults(fn=cmd_simcov)

    p = sub.add_parser(
        "trend", help="per-config perf trajectory over BENCH_LOCAL.jsonl"
    )
    p.add_argument("file")
    p.add_argument("--metric", help="only configs of this metric")
    p.add_argument(
        "--fail-on-regression", type=float, metavar="PCT",
        help="exit 1 when a config's latest run is more than PCT%% below "
        "its best earlier run",
    )
    p.add_argument("--json", action="store_true", help="machine output")
    p.set_defaults(fn=cmd_trend)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    try:
        code = main()
    except BrokenPipeError:  # e.g. `obs_report report … | head`
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        code = 0
    raise SystemExit(code)
