"""Fleet-level observability: merge per-device sink files into one view.

The port's copy of ``crdt_enc_tpu/obs/fleet.py``.  One device's
replication status (``obs.replication``) answers "how far behind am I?";
a fleet needs the cross-device questions, answered from the JSONL files
the metrics sink already writes (append-only, schema-stamped):

* :func:`device_summaries` — one summary per device file: the NEWEST
  record carrying a ``"replication"`` payload, after
  :func:`obs.sink.check_schema` has refused unreadable schemas.
* :func:`fleet_report` — devices grouped by the remote they replicate
  (``remote_id``): the **fleet stable watermark** (pointwise min over the
  devices' local clocks), each device's lag behind the fleet union clock
  with its min/p50/p99/max, backlog p50/p99 in files and bytes, and the
  freshness SLO verdict per device (:data:`obs.slo.FRESHNESS`).
* :func:`bench_trend` / :func:`trend_regressions` — the trajectory of
  each bench config in ``BENCH_LOCAL.jsonl`` and the configs whose latest
  run regressed past a threshold (``obs_report trend
  --fail-on-regression``).

Deterministic for a given input (sorted remotes, devices and configs; no
wall-clock reads), so ``obs_report fleet`` renders byte-stable text.
"""

from __future__ import annotations

import json
import math

from . import sink, slo


class FleetInputError(ValueError):
    """A device file cannot contribute to a fleet report."""


# ------------------------------------------------------------- devices
def device_summaries(paths: list[str]) -> list[dict]:
    """One summary per device sink file: the newest replication-bearing
    record.  Raises :class:`FleetInputError` when a file has none (the
    device ran with replication sampling off, or the file predates sink
    schema 2) and :class:`obs.sink.SinkSchemaError` on unreadable
    schemas — loudly, instead of silently averaging a partial fleet."""
    out = []
    for path in paths:
        records = sink.read_records(path)
        sink.check_schema(records, source=path)
        rep = ts = None
        counters: dict = {}
        gauges: dict = {}
        wm_change_ts = None  # record ts when the watermark last CHANGED
        prev_wm = None
        for rec in records:
            if isinstance(rec.get("replication"), dict):
                rep, ts = rec["replication"], rec.get("ts")
                counters = rec.get("counters") or {}
                gauges = rec.get("gauges") or {}
                wm = rep.get("watermark")
                if prev_wm is None or wm != prev_wm:
                    wm_change_ts = ts
                    prev_wm = wm
        if rep is None:
            raise FleetInputError(
                f"{path}: no record carries a replication status — the "
                "device must run with replication sampling on (sink "
                "schema >= 2) to join a fleet report"
            )
        out.append({
            "path": path, "ts": ts, "replication": rep,
            # the same record's registry snapshot, for the quarantine
            # column: ingest_quarantined (damaged synced files, cursor
            # held) and daemon_quarantined (tenants the fleet daemon
            # has parked, serve/daemon.py)
            "counters": counters, "gauges": gauges,
            # watermark AGE, derived purely from sink record timestamps
            # (deterministic — the newest sample's ts anchors "now"):
            # how long the device kept sampling without its stability
            # watermark moving.  A wedged watermark is a growing
            # duration an operator can see without reading gauges.
            "watermark_age_s": (
                round(max(0.0, float(ts) - float(wm_change_ts)), 3)
                if ts is not None and wm_change_ts is not None
                else None
            ),
        })
    return out


def _q(vals: list, q: float):
    """Nearest-rank quantile: the ceil(q·n)-th smallest value."""
    s = sorted(vals)
    rank = max(1, math.ceil(q * len(s)))
    return s[min(rank, len(s)) - 1]


def fleet_report(summaries: list[dict]) -> dict:
    """Aggregate device summaries into the per-remote fleet view (see
    module docs).  Two summaries for the same actor on the same remote
    keep the newer one (by record ``ts``) — re-shipped files are not a
    second device."""
    latest: dict[tuple[str, str], dict] = {}
    for s in summaries:
        rep = s["replication"]
        key = (rep["remote_id"], rep["actor"])
        old = latest.get(key)
        if old is None or (s["ts"] or 0) >= (old["ts"] or 0):
            latest[key] = s

    by_remote: dict[str, list[dict]] = {}
    for (remote_id, _actor), s in sorted(latest.items()):
        by_remote.setdefault(remote_id, []).append(s)

    remotes = []
    for remote_id, devs in sorted(by_remote.items()):
        union: dict[str, int] = {}
        for s in devs:
            for a, c in s["replication"]["union_clock"].items():
                if c > union.get(a, 0):
                    union[a] = c
        watermark = {}
        for a in union:
            lo = min(
                s["replication"]["local_clock"].get(a, 0) for s in devs
            )
            if lo:
                watermark[a] = lo
        freshness = slo.FRESHNESS
        devices = []
        for s in devs:
            rep = s["replication"]
            local = rep["local_clock"]
            lag = sum(c - local.get(a, 0) for a, c in union.items())
            devices.append({
                "actor": rep["actor"],
                "lag": lag,
                "backlog_files": rep["backlog"]["files"],
                "backlog_bytes": rep["backlog"]["bytes"],
                "watermark_lag": rep["divergence"]["watermark_lag"],
                # quarantine column: damaged synced files this device
                # skipped with the cursor held (ingest_quarantined),
                # plus tenants its fleet daemon currently parks
                # (daemon_quarantined gauge, serve/daemon.py)
                "quarantined_files": int(
                    (s.get("counters") or {}).get("ingest_quarantined", 0)
                ),
                "daemon_quarantined": int(
                    (s.get("gauges") or {}).get("daemon_quarantined", 0)
                ),
                # freshness-SLO verdict at the device's last sample:
                # watermark lag within the active target (obs.slo)
                "slo_ok": rep["divergence"]["watermark_lag"]
                <= freshness.target,
                "watermark_age_s": s.get("watermark_age_s"),
                # strong-read membership policy surfacing (present only
                # when the device runs one): replicas quarantined out
                # of the watermark denominator (docs/strong_reads.md)
                "membership_excluded": len(
                    (rep.get("membership") or {}).get("excluded") or []
                ),
            })
        lags = [d["lag"] for d in devices]
        bfiles = [d["backlog_files"] for d in devices]
        bbytes = [d["backlog_bytes"] for d in devices]
        remotes.append({
            "remote_id": remote_id,
            "devices": devices,
            "converged": all(v == 0 for v in lags),
            "slo": {
                "freshness_target": freshness.target,
                "devices_ok": sum(1 for d in devices if d["slo_ok"]),
                "devices_burning": sum(
                    1 for d in devices if not d["slo_ok"]
                ),
            },
            "stable_watermark": dict(sorted(watermark.items())),
            "union_clock": dict(sorted(union.items())),
            "lag": {
                "min": min(lags), "p50": _q(lags, 0.50),
                "p99": _q(lags, 0.99), "max": max(lags),
            },
            "backlog_files": {"p50": _q(bfiles, 0.50), "p99": _q(bfiles, 0.99)},
            "backlog_bytes": {"p50": _q(bbytes, 0.50), "p99": _q(bbytes, 0.99)},
        })
    return {"n_devices": len(latest), "remotes": remotes}


def format_fleet(report: dict) -> str:
    """Deterministic human rendering of :func:`fleet_report` output —
    the shape the committed golden (tests/data/obs_fleet_golden.txt)
    pins."""
    lines = [
        f"# fleet: {report['n_devices']} device(s), "
        f"{len(report['remotes'])} remote(s)"
    ]
    for r in report["remotes"]:
        conv = "yes" if r["converged"] else "no"
        lines.append(
            f"remote {r['remote_id']}  devices={len(r['devices'])}  "
            f"converged={conv}"
        )
        wm = r["stable_watermark"]
        total = sum(wm.values())
        lines.append(
            f"  stable watermark: {len(wm)} actor(s), {total} version(s)"
        )
        for a, c in wm.items():
            lines.append(f"    {a} = {c}")
        lag = r["lag"]
        lines.append(
            f"  lag vs fleet union: min={lag['min']} p50={lag['p50']} "
            f"p99={lag['p99']} max={lag['max']}"
        )
        bf, bb = r["backlog_files"], r["backlog_bytes"]
        lines.append(
            f"  backlog files p50={bf['p50']} p99={bf['p99']}  "
            f"bytes p50={bb['p50']} p99={bb['p99']}"
        )
        s = r["slo"]
        lines.append(
            f"  slo freshness (lag<={s['freshness_target']:g}): "
            f"{s['devices_ok']} ok, {s['devices_burning']} burning"
        )
        for d in r["devices"]:
            quar = d.get("quarantined_files", 0)
            dq = d.get("daemon_quarantined", 0)
            quar_s = f"quar={quar}" + (f"+{dq}t" if dq else "")
            age = d.get("watermark_age_s")
            age_s = f"  wm_age={age:g}s" if age is not None else ""
            excl = d.get("membership_excluded") or 0
            excl_s = f"  excl={excl}" if excl else ""
            lines.append(
                f"  device {d['actor']}  lag={d['lag']}  "
                f"backlog_files={d['backlog_files']}  "
                f"backlog_bytes={d['backlog_bytes']}  "
                f"{quar_s}  "
                f"slo={'ok' if d['slo_ok'] else 'BURN'}"
                f"{age_s}{excl_s}"
            )
    return "\n".join(lines)


# --------------------------------------------------------------- trend
def bench_trend(records: list[dict], metric: str | None = None) -> list[dict]:
    """Per-config perf trajectory from BENCH_LOCAL.jsonl records (file
    order = time order; bench appends).  A config is one (metric,
    backend, shape) triple; records without metric/value (e.g. sink
    records mixed into the file) are skipped, but unknown sink schemas
    still fail loudly via :func:`obs.sink.check_schema` first."""
    configs: dict[tuple, dict] = {}
    for rec in records:
        if "metric" not in rec or "value" not in rec:
            continue
        if metric is not None and rec["metric"] != metric:
            continue
        # shapeless records (the sim bench) fall back to their config
        # string — without it, e.g. a 4r×50s and an 8r×250s sim run
        # would collapse into ONE trajectory and the regression gate
        # would compare apples to oranges
        shape_obj = rec.get("shape")
        if not isinstance(shape_obj, dict) or not shape_obj:
            shape_obj = (
                {"config": rec["config"]} if rec.get("config") else {}
            )
        shape = json.dumps(shape_obj, sort_keys=True)
        key = (rec["metric"], rec.get("backend", "?"), shape)
        cfg = configs.setdefault(key, {
            "metric": rec["metric"],
            "backend": rec.get("backend", "?"),
            "shape": shape_obj,
            "unit": rec.get("unit", ""),
            "runs": [],
        })
        cfg["runs"].append({
            "ts": rec.get("ts", ""),
            "value": float(rec["value"]),
            "variant": rec.get("best_variant", ""),
        })
    out = []
    for key in sorted(configs):
        cfg = configs[key]
        values = [r["value"] for r in cfg["runs"]]
        cfg["latest"] = values[-1]
        cfg["best"] = max(values)
        if len(values) > 1:
            prior_best = max(values[:-1])
            cfg["prior_best"] = prior_best
            cfg["latest_vs_prior_best_pct"] = round(
                100.0 * (values[-1] - prior_best) / prior_best, 2
            )
        out.append(cfg)
    return out


def trend_regressions(trend: list[dict], pct: float) -> list[dict]:
    """Configs whose latest run is more than ``pct`` percent below the
    best earlier run — single-run configs have no trajectory and never
    flag."""
    return [
        cfg for cfg in trend
        if "prior_best" in cfg
        and cfg["latest"] < cfg["prior_best"] * (1.0 - pct / 100.0)
    ]


def format_trend(trend: list[dict], regressed: list[dict] | None = None) -> str:
    """Human trajectory table for :func:`bench_trend` output."""
    flagged = {id(c) for c in (regressed or [])}
    lines = []
    for cfg in trend:
        shape = json.dumps(cfg["shape"], sort_keys=True)
        lines.append(
            f"# {cfg['metric']} [{cfg['backend']}] {shape}  "
            f"unit={cfg['unit']}  runs={len(cfg['runs'])}"
        )
        for run in cfg["runs"]:
            variant = f"  ({run['variant']})" if run["variant"] else ""
            lines.append(f"  {run['ts']}  {run['value']:.1f}{variant}")
        if "prior_best" in cfg:
            mark = "  ** REGRESSION **" if id(cfg) in flagged else ""
            lines.append(
                f"  latest {cfg['latest']:.1f} vs prior best "
                f"{cfg['prior_best']:.1f}: "
                f"{cfg['latest_vs_prior_best_pct']:+.2f}%{mark}"
            )
    return "\n".join(lines) if lines else "(no bench records)"
