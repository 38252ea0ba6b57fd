"""Freshness and seal-latency SLOs: targets and live gauges.

The port's copy of ``crdt_enc_tpu/obs/slo.py``.  Two specs, each read
from the environment per call (:func:`freshness_spec`,
:func:`seal_latency_spec`):

* **freshness** — indicator ``divergence.watermark_lag`` of a
  replication status (versions the union clock is ahead of the causal
  stability watermark); target ``CRDT_SLO_FRESHNESS_LAG`` (default 64
  versions).
* **seal_latency** — a tenant's end-to-end completion latency in a
  ``FoldService`` cycle; target ``CRDT_SLO_SEAL_LATENCY_S`` (default
  2.0 s).

Both carry the objective ``CRDT_SLO_OBJECTIVE`` (default 0.99: at most
1% of samples may violate).  An unparsable value, or an objective
outside (0, 1], keeps the default.  :func:`sample_freshness` runs inside ``Core._sample_replication`` and
sets the ``repl_slo_*`` gauges; ``FoldService`` puts each cycle's
:func:`cycle_burn` into its summary, its ``serve_cycle`` sink record and
the ``serve_slo_seal_burn`` gauge.  A window's **burn rate** is its
violation fraction over the error budget (1 − objective): above 1 the
window ate budget faster than the objective allows.  Post hoc,
:func:`burn_report` is a pure function over sink records (freshness
samples from their ``replication`` payloads, seal-latency samples from
the ``serve_cycle`` records' ``meta.slo``) bucketed into fixed windows,
rendered by ``obs_report slo`` (:func:`format_burn`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from . import record

ENV_FRESHNESS = "CRDT_SLO_FRESHNESS_LAG"
ENV_SEAL = "CRDT_SLO_SEAL_LATENCY_S"
ENV_OBJECTIVE = "CRDT_SLO_OBJECTIVE"

DEFAULT_FRESHNESS_LAG = 64.0
DEFAULT_SEAL_LATENCY_S = 2.0
DEFAULT_OBJECTIVE = 0.99
DEFAULT_WINDOW_S = 300.0


@dataclass(frozen=True)
class SloSpec:
    """One objective: ``indicator <= target`` for at least ``objective``
    of samples.  ``name`` keys reports; ``indicator`` documents the
    measured value."""

    name: str
    indicator: str
    target: float
    objective: float = DEFAULT_OBJECTIVE

    @property
    def budget(self) -> float:
        """The error budget: the violation fraction the objective
        tolerates (floored so a 1.0 objective cannot zero-divide)."""
        return max(1.0 - self.objective, 1e-9)


def _env_float(var: str, default: float) -> float:
    raw = os.environ.get(var, "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _objective() -> float:
    obj = _env_float(ENV_OBJECTIVE, DEFAULT_OBJECTIVE)
    return obj if 0.0 < obj <= 1.0 else DEFAULT_OBJECTIVE


def freshness_spec() -> SloSpec:
    """Staleness-lag-vs-watermark target (env-tunable, module docs)."""
    return SloSpec(
        name="freshness",
        indicator="replication.divergence.watermark_lag (versions)",
        target=_env_float(ENV_FRESHNESS, DEFAULT_FRESHNESS_LAG),
        objective=_objective(),
    )


def seal_latency_spec() -> SloSpec:
    """Per-tenant seal-latency target for FoldService cycles."""
    return SloSpec(
        name="seal_latency",
        indicator="FoldService per-tenant completion latency (seconds)",
        target=_env_float(ENV_SEAL, DEFAULT_SEAL_LATENCY_S),
        objective=_objective(),
    )


def default_specs() -> list[SloSpec]:
    return [freshness_spec(), seal_latency_spec()]


# ------------------------------------------------------------- live side
def freshness_value(status: dict) -> float:
    """The freshness indicator of one replication status."""
    return float(status["divergence"]["watermark_lag"])


def sample_freshness(status: dict, spec: SloSpec | None = None) -> bool:
    """Publish the freshness-SLO gauges for one replication status —
    called by ``Core._sample_replication`` right after the ``repl_*``
    gauges.  Returns whether the sample met the target.  The target
    gauge rides along so a scraper can alert on
    ``repl_watermark_lag > repl_slo_freshness_target`` without
    duplicating config."""
    if spec is None:
        spec = freshness_spec()
    ok = freshness_value(status) <= spec.target
    record.gauge("repl_slo_freshness_ok", 1.0 if ok else 0.0)
    record.gauge("repl_slo_freshness_target", spec.target)
    return ok


def cycle_burn(results, spec: SloSpec | None = None) -> dict:
    """Seal-latency burn of ONE FoldService cycle: ``results`` are the
    cycle's TenantResult objects.  Sealed tenants' completion latencies
    compare against the target, and a tenant that ERRORED is a
    violation outright — a seal that never happened is infinitely late,
    so a total outage burns at the maximum rate instead of rendering as
    green (zero sealed = zero violations would be the lie).  Tenants
    legitimately skipped (a quiet tenant's no-op cycle) are not
    attempts and stay out of the denominator.  The dict rides into the
    service's cycle sink record."""
    if spec is None:
        spec = seal_latency_spec()
    sealed = [r for r in results if getattr(r, "sealed", False)]
    errors = sum(
        1 for r in results if getattr(r, "error", None) is not None
    )
    violations = sum(1 for r in sealed if r.latency_s > spec.target) \
        + errors
    attempts = len(sealed) + errors
    return {
        "target_s": spec.target,
        "objective": spec.objective,
        "tenants": len(results),
        "sealed": len(sealed),
        "errors": errors,
        "attempts": attempts,
        "violations": violations,
        "burn_rate": round(
            (violations / attempts) / spec.budget, 4
        ) if attempts else 0.0,
    }


# --------------------------------------------------------- post-hoc side
def _samples_for(spec: SloSpec, records: list[dict]):
    """(ts, good, bad) sample tuples for one spec over sink records."""
    out = []
    for rec in records:
        ts = rec.get("ts")
        if ts is None:
            continue
        if spec.name == "freshness":
            rep = rec.get("replication")
            if isinstance(rep, dict):
                bad = int(freshness_value(rep) > spec.target)
                out.append((float(ts), 1 - bad, bad))
        elif spec.name == "seal_latency":
            meta = rec.get("meta") or {}
            cyc = meta.get("slo")
            if isinstance(cyc, dict) and "attempts" in cyc:
                # attempts = sealed + errored tenants (errors count as
                # violations — see cycle_burn)
                n, v = int(cyc["attempts"]), int(cyc["violations"])
                out.append((float(ts), n - v, v))
    return out


def burn_report(
    records: list[dict],
    specs: list[SloSpec] | None = None,
    window_s: float = DEFAULT_WINDOW_S,
) -> dict:
    """Window-based burn accounting over sink records (module docs).
    Pure and deterministic: windows are fixed ``window_s`` buckets
    anchored at each spec's earliest sample, burn is violation fraction
    ÷ error budget.  A spec with no sample in the records reports 0
    samples, not compliance."""
    if specs is None:
        specs = default_specs()
    with record.span("slo.burn"):
        out = {"window_s": window_s, "specs": []}
        for spec in specs:
            samples = _samples_for(spec, records)
            entry = {
                "name": spec.name,
                "indicator": spec.indicator,
                "target": spec.target,
                "objective": spec.objective,
                "samples": sum(g + b for _, g, b in samples),
                "violations": sum(b for _, _, b in samples),
                "windows": [],
            }
            if samples:
                t0 = min(ts for ts, _, _ in samples)
                buckets: dict[int, list[int]] = {}
                for ts, g, b in samples:
                    slot = buckets.setdefault(
                        int((ts - t0) // window_s), [0, 0]
                    )
                    slot[0] += g
                    slot[1] += b
                for idx in sorted(buckets):
                    g, b = buckets[idx]
                    frac = b / (g + b) if (g + b) else 0.0
                    entry["windows"].append({
                        "window": idx,
                        "start_s": round(idx * window_s, 3),
                        "samples": g + b,
                        "violations": b,
                        "burn_rate": round(frac / spec.budget, 4),
                    })
                total = entry["samples"]
                frac = entry["violations"] / total if total else 0.0
                entry["bad_fraction"] = round(frac, 6)
                entry["budget_burn"] = round(frac / spec.budget, 4)
                entry["worst_window_burn"] = max(
                    (w["burn_rate"] for w in entry["windows"]), default=0.0
                )
            out["specs"].append(entry)
        return out


def format_burn(report: dict) -> str:
    """Deterministic human rendering of :func:`burn_report` output."""
    lines = [f"# SLO burn (window {report['window_s']:.0f}s)"]
    for spec in report["specs"]:
        lines.append(
            f"{spec['name']}: target <= {spec['target']:g} "
            f"objective {spec['objective']:g}  "
            f"samples={spec['samples']} violations={spec['violations']}"
        )
        if not spec["windows"]:
            lines.append("  (no samples)")
            continue
        lines.append(
            f"  budget burn {spec['budget_burn']:.2f}x  worst window "
            f"{spec['worst_window_burn']:.2f}x"
        )
        for w in spec["windows"]:
            lines.append(
                f"  window {w['window']:>3} (+{w['start_s']:.0f}s)  "
                f"samples={w['samples']}  violations={w['violations']}  "
                f"burn={w['burn_rate']:.2f}x"
            )
    return "\n".join(lines)
