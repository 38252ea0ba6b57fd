"""Expected-replica membership policy for the strong-read tier.

The port's copy of ``crdt_enc_tpu/read/policy.py``.

The stability watermark is a pointwise min over every known replica's
published cursor (obs/replication.py), which makes it *observationally
sound* but operationally fragile in exactly one way: **one silent
replica collapses it forever**.  A replica that crashed for good, was
decommissioned without ceremony, or simply never compacts again keeps
its last published cursor in every peer's matrix — and the min never
moves past it.  Silence is indistinguishable from lag, so the math
cannot fix this; only an explicit membership decision can
(the strong-read precondition of arXiv:1905.08733 includes pinned
membership).  This module is that decision, made loudly:

* ``expected=...`` **pins the denominator**: the watermark is the min
  over exactly ``expected ∪ {self}``.  A replica outside the set may
  still produce ops (they surface in the union and stabilize once every
  expected replica folds them) but its cursor no longer caps the
  watermark; an expected replica that has never published holds the
  watermark at zero — the honest wedge, not a silent skip.
* ``silent_after=N`` **decays provably-silent replicas**: a replica
  whose published cursor has not advanced for N policy observations is
  QUARANTINED out of the denominator until it advances again.  Every
  transition logs a warning and counts ``read_membership_quarantines``;
  the current exclusion set rides on every strong read's status, into
  ``/healthz`` (the ``membership`` key) and ``obs_report fleet`` —
  an operator can always see whose data the fleet stopped waiting for.

Excluding a replica is a real guarantee trade, stated in
docs/strong_reads.md: strong reads stay monotone, exact folds of a
consistent cut, but an excluded replica's state no longer provably
descends from every exposed read.  Both knobs default OFF — with no
policy the denominator is the observed replica set, the plain math
unchanged.

Determinism seam: observations tick a counter by default, so the
replays reproduce policies bit-for-bit; pass ``clock=`` for wall-time
decay in production.
"""

from __future__ import annotations

import logging

from ..models.vclock import Actor
from ..utils import trace

logger = logging.getLogger("crdt_enc_tpu_torch.read")


class MembershipPolicy:
    """The watermark-denominator policy (module docs).

    One instance per Core (``OpenOptions.membership``); ``observe`` is
    called by every strong-read/stable-prefix computation with the
    replica's current knowledge and returns the effective denominator.
    """

    def __init__(
        self,
        expected=None,
        *,
        silent_after: int = 0,
        clock=None,
    ):
        self.expected: frozenset | None = (
            frozenset(bytes(a) for a in expected)
            if expected is not None
            else None
        )
        self.silent_after = int(silent_after)
        self._clock = clock  # None = observation-count ticks
        self._tick = 0
        # replica -> (last tick/time its published cursor advanced,
        #             total versions in that cursor at the time)
        self._last_advance: dict[Actor, tuple[float, int]] = {}
        self.excluded: frozenset = frozenset()

    def _now(self) -> float:
        if self._clock is not None:
            return float(self._clock())
        self._tick += 1
        return float(self._tick)

    def denominator(
        self, actor_id: Actor, cursor_matrix: dict, union
    ) -> set:
        """The replica set the watermark mins over BEFORE silence decay:
        ``expected ∪ {self}`` when pinned, else the observed set (every
        published cursor + every op producer — the default construction)."""
        if self.expected is not None:
            return set(self.expected) | {actor_id}
        return set(cursor_matrix) | set(union.counters) | {actor_id}

    def observe(self, actor_id: Actor, cursor_matrix: dict, union) -> set:
        """One policy observation: update silence bookkeeping, apply the
        decay, and return the EFFECTIVE denominator (pinned-or-observed
        minus quarantined; never excludes ``actor_id`` itself).  The
        exclusion set is kept on ``self.excluded`` for status/health
        surfacing."""
        replicas = self.denominator(actor_id, cursor_matrix, union)
        if self.silent_after <= 0:
            self.excluded = frozenset()
            return replicas
        now = self._now()
        excluded = set()
        for r in replicas:
            if r == actor_id:
                continue  # self is never silent to itself
            row = cursor_matrix.get(r)
            total = (
                sum(c for c in row.counters.values()) if row is not None
                else 0
            )
            seen = self._last_advance.get(r)
            if seen is None or total > seen[1]:
                self._last_advance[r] = (now, total)
            elif now - seen[0] > self.silent_after:
                excluded.add(r)
        newly = excluded - set(self.excluded)
        for r in sorted(newly):
            trace.add("read_membership_quarantines", 1)
            logger.warning(
                "membership policy quarantined silent replica %s out of "
                "the watermark denominator (no cursor advance for > %d "
                "observations); strong reads no longer wait for it",
                r.hex(), self.silent_after,
            )
        for r in sorted(set(self.excluded) - excluded):
            logger.info(
                "membership policy re-admitted replica %s (cursor "
                "advanced)", r.hex(),
            )
        self.excluded = frozenset(excluded)
        trace.gauge("read_membership_excluded", len(excluded))
        return replicas - excluded

    def summary(self) -> dict:
        """The loud surface: rides on strong-read statuses and — via
        ``Core.replication_status`` — into ``/healthz`` and
        ``obs_report fleet``.  Sorted hex, byte-stable."""
        return {
            "expected": (
                sorted(a.hex() for a in self.expected)
                if self.expected is not None
                else None
            ),
            "silent_after": self.silent_after,
            "excluded": sorted(a.hex() for a in self.excluded),
        }
