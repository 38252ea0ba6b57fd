"""Freshness and seal-latency SLOs: targets and live gauges.

The port's copy of the live side of ``crdt_enc_tpu/obs/slo.py``.  Two
specs:

* **freshness** — indicator ``divergence.watermark_lag`` of a
  replication status (versions the union clock is ahead of the causal
  stability watermark); target 64 versions (:data:`FRESHNESS`).
* **seal_latency** — a tenant's end-to-end completion latency in a
  ``FoldService`` cycle; target 2.0 s (:data:`SEAL_LATENCY`).

Both carry the objective 0.99: at most 1% of samples may violate.  The
targets are the JAX package's defaults; a caller with other targets
passes its own :class:`SloSpec`.  :func:`sample_freshness` runs inside
``Core._sample_replication`` and sets the ``repl_slo_*`` gauges;
``FoldService`` puts each cycle's :func:`cycle_burn` into its summary, its
``serve_cycle`` sink record and the ``serve_slo_seal_burn`` gauge.  A
window's **burn rate** is its violation fraction over the error budget
(1 − objective): above 1 the window ate budget faster than the objective
allows.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import record

DEFAULT_OBJECTIVE = 0.99


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


#: staleness lag against the watermark, per replication status
FRESHNESS = SloSpec(
    name="freshness",
    indicator="replication.divergence.watermark_lag (versions)",
    target=64.0,
)

#: per-tenant seal latency of a FoldService cycle
SEAL_LATENCY = SloSpec(
    name="seal_latency",
    indicator="FoldService per-tenant completion latency (seconds)",
    target=2.0,
)


# ------------------------------------------------------------- live side
def freshness_value(status: dict) -> float:
    """The freshness indicator of one replication status."""
    return float(status["divergence"]["watermark_lag"])


def sample_freshness(status: dict, spec: SloSpec = FRESHNESS) -> bool:
    """Publish the freshness-SLO gauges for one replication status —
    called by ``Core._sample_replication`` right after the ``repl_*``
    gauges.  Returns whether the sample met the target.  The target
    gauge rides along so a scraper can alert on
    ``repl_watermark_lag > repl_slo_freshness_target`` without
    duplicating config."""
    ok = freshness_value(status) <= spec.target
    record.gauge("repl_slo_freshness_ok", 1.0 if ok else 0.0)
    record.gauge("repl_slo_freshness_target", spec.target)
    return ok


def cycle_burn(results, spec: SloSpec = SEAL_LATENCY) -> dict:
    """Seal-latency burn of ONE FoldService cycle: ``results`` are the
    cycle's TenantResult objects.  Sealed tenants' completion latencies
    compare against the target, and a tenant that ERRORED is a
    violation outright — a seal that never happened is infinitely late,
    so a total outage burns at the maximum rate instead of rendering as
    green (zero sealed = zero violations would be the lie).  Tenants
    legitimately skipped (a quiet tenant's no-op cycle) are not
    attempts and stay out of the denominator.  The dict rides into the
    service's cycle sink record."""
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
