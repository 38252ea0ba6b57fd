"""Quiescence invariants: what must hold once the adversary stops.

The port's copy of ``crdt_enc_tpu/sim/check.py``.

The simulator's acceptance bar at every quiescence point (schedule end
and every explicit ``quiesce`` step), after faults heal and reads reach
a fixed point:

1. **byte equality** — every replica's canonical serialization is
   byte-identical (the convergence claim);
2. **oracle refold** — a fresh host-reference Core joining the remote
   cold refolds to the same bytes (the remote itself, not just the
   survivors' memories, carries the state);
3. **warm ≡ cold** — reopening a replica from its warm-open checkpoint
   equals a cold refold (the checkpoint contract under fire);
4. **replication monotonicity** — per replica incarnation, the local
   clock, the union clock, and every cursor-matrix row only advance;
   the stability watermark is pointwise monotone *while the known
   replica set is unchanged* (membership growth may legitimately
   collapse it — a newly heard-from silent replica drags the min down,
   exactly as obs/replication.py documents — so the baseline resets
   when the known set grows);
5. **fsck cleanliness** — the healed remote passes a deep
   ``tools.fsck`` walk (no torn survivors, no op-log gaps, addresses
   match content).

This module is the pure half (comparisons over status dicts and state
bytes — exactly unit-testable); :mod:`crdt_enc_tpu_torch.sim.runner` gathers
the inputs and raises :class:`InvariantViolation`.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Violation:
    """One invariant failure, serializable into a shrunk fixture."""

    invariant: str  # "divergence" | "oracle" | "warm_cold" | "monotonicity"
    #               | "fsck" | "no_quiescence" | "step_error" | "service_error"
    detail: str
    step: int = -1  # schedule step index at/after which it was detected

    def to_obj(self) -> dict:
        return {
            "invariant": self.invariant,
            "detail": self.detail,
            "step": self.step,
        }


class InvariantViolation(AssertionError):
    def __init__(self, violation: Violation):
        super().__init__(
            f"[{violation.invariant} @ step {violation.step}] {violation.detail}"
        )
        self.violation = violation


def clock_regressions(prev: dict, cur: dict) -> list[str]:
    """Hex-keyed clock entries that moved backwards (prev > cur)."""
    return sorted(a for a, v in prev.items() if cur.get(a, 0) < v)


def known_replica_set(status: dict) -> frozenset:
    """The replica set a status' watermark minimized over: self, every
    published cursor row, every op producer in the union clock — the
    same construction as obs.replication.compute_status."""
    return frozenset(
        {status["actor"]} | set(status["matrix"]) | set(status["union_clock"])
    )


def replication_regression(prev: dict | None, cur: dict) -> str | None:
    """Compare two replication statuses of ONE replica incarnation.
    Returns a human-readable defect description, or None when every
    monotone quantity advanced (see module docs for which are monotone
    under membership growth and which are not)."""
    if prev is None:
        return None
    bad = clock_regressions(prev["local_clock"], cur["local_clock"])
    if bad:
        return f"local_clock regressed for {bad}"
    bad = clock_regressions(prev["union_clock"], cur["union_clock"])
    if bad:
        return f"union_clock regressed for {bad}"
    for r, row in prev["matrix"].items():
        bad = clock_regressions(row, cur["matrix"].get(r, {}))
        if bad:
            return f"cursor matrix row {r} regressed for {bad}"
    if known_replica_set(cur) <= known_replica_set(prev):
        bad = clock_regressions(prev["watermark"], cur["watermark"])
        if bad:
            return (
                "stability watermark regressed with no membership growth "
                f"for {bad}"
            )
    return None


def divergence_detail(blobs: list[tuple[str, bytes]]) -> str | None:
    """None when all canonical serializations agree, else which
    replicas disagree with the first."""
    if not blobs:
        return None
    ref_label, ref = blobs[0]
    off = [label for label, b in blobs[1:] if b != ref]
    if not off:
        return None
    return f"{off} diverged from {ref_label} ({len(blobs)} replicas)"
