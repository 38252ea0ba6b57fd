"""The stable prefix: a monotone state folded only from stable history.

The port's copy of ``crdt_enc_tpu/read/stable.py``.

``Core``'s live state folds everything it has seen — including ops no
other replica may hold yet, which is why eventual reads can "unsee"
nothing but guarantee nothing either.  The stable prefix is the second
state the strong-read tier maintains per replica: the fold of exactly
the ops covered by the **causal stability watermark** (obs/replication)
under the active :class:`~crdt_enc_tpu_torch.read.policy.MembershipPolicy`.
Every replica in the denominator has provably ingested everything in
it, so its value can never be rolled back, reordered, or contradicted
by any future merge — the strong-read precondition of
arXiv:1905.08733.

Materialization reuses the system's own invariant: a sealed snapshot is
byte-exactly the fold of the op prefix its cursor names (the compaction
contract every differential test pins), so the prefix advances by

1. merging any listed snapshot whose cursor is pointwise ≤ the
   watermark (a *stable snapshot* — only stable ops inside), and
2. folding op files from the prefix cursor up to the watermark, dense
   per actor, with the core's quarantine discipline (a torn file holds
   the cursor; a GC'd hole wedges that actor until a stable snapshot
   covers past it — recorded per actor in ``wedged``, never silent).

Both moves only grow the prefix, so it is monotone by construction
(reads can never go backwards within an incarnation) and checkpointable
(it rides the warm-open checkpoint as the observational ``b"sp"`` slot:
a warm reopen resumes the exposed frontier, a cold reopen rebuilds from
scratch and the session guarantee restarts).

The refusal taxonomy is :class:`StalenessError` — ``reason`` is one of
``lag_exceeded`` (watermark too far behind the union for the caller's
``max_lag``), ``uncovered_target`` (``min_cursor``/read-your-writes
target not yet stable), or ``timeout`` (``await_stable`` gave up) —
each message naming the holdout replicas so an operator knows WHO the
fleet is waiting for.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass

from ..models.vclock import Actor, Dot, VClock
from ..utils import trace

logger = logging.getLogger("crdt_enc_tpu_torch.read")


class StalenessError(Exception):
    """A linearizable read (or freshness wait) could not be served
    within the caller's constraints.  ``reason`` is the taxonomy key
    (module docs); ``status`` carries the watermark/lag/holdout detail
    the message summarizes.  Deliberately NOT a silent fallback: the
    caller chooses ``consistency="eventual"`` explicitly (Core.read
    with ``linearizable=False``), never gets it by surprise."""

    def __init__(self, reason: str, message: str, *, status: dict | None = None):
        super().__init__(message)
        self.reason = reason
        self.status = status or {}


@dataclass(frozen=True)
class StableView:
    """One advance's summary: the exposed frontier and how it relates
    to everything known to exist.  All actor ids are raw bytes in
    ``cursor`` (a VClock) and hex strings in the reporting fields."""

    cursor: VClock  # the materialized stable prefix frontier
    watermark: dict  # Actor -> int, the effective (policy) watermark
    lag: int  # versions the union is ahead of the PREFIX cursor
    watermark_lag: int  # versions the union is ahead of the watermark
    excluded: tuple  # hex: replicas the policy quarantined
    holdouts: tuple  # hex: replicas whose cursors cap the watermark
    wedged: dict  # actor hex -> reason ("gc_gap" | "torn")

    def covers(self, target: VClock) -> bool:
        return all(
            self.cursor.get(a) >= c for a, c in target.counters.items()
        )


@dataclass(frozen=True)
class ReadResult:
    """What ``Core.read`` returns: the state's object form, which
    consistency tier actually served it, and the frontier it reflects.
    ``obj`` may alias live structures — treat it as read-only."""

    obj: object
    consistency: str  # "strong" | "eventual"
    cursor: VClock
    view: StableView | None = None


class StablePrefix:
    """The per-replica stable prefix state + frontier (module docs).
    Owned by a Core (created lazily on first strong read, or restored
    from the warm-open checkpoint); all mutation happens inside
    :meth:`advance` under one asyncio lock, in sync sections between
    awaits — concurrent strong reads serialize their advances and both
    observe a monotone frontier."""

    def __init__(self, adapter):
        self.adapter = adapter
        self.state = adapter.new()
        self.cursor = VClock()
        self.consumed: set[str] = set()  # stable snapshot names merged
        self.wedged: dict[Actor, str] = {}
        self._lock = asyncio.Lock()

    # ---------------------------------------------------------- advance
    async def advance(self, core, watermark: dict) -> None:
        """Grow the prefix toward ``watermark`` (never past it, never
        backwards): stable snapshots first (they may jump the cursor
        over GC'd op history), then dense op tails."""
        async with self._lock:
            with trace.span("read.advance"):
                await self._merge_stable_snapshots(core, watermark)
                await self._fold_stable_ops(core, watermark)

    async def _merge_stable_snapshots(self, core, watermark: dict) -> None:
        from ..core.core import MissingKeyError

        names = await core.storage.list_state_names()
        new = [n for n in names if n not in self.consumed]
        # consumed names that vanished were GC'd; forgetting them is
        # safe — content-addressed names re-merge idempotently
        self.consumed.intersection_update(names)
        if not new:
            return
        loaded = await core.storage.load_states(new)
        for name, raw in loaded:
            try:
                obj = await core._open_sealed(raw)
                cursor = VClock.from_obj(obj[1])
            except MissingKeyError:
                raise  # key metadata not synced: loud, not damage
            except Exception:
                # torn snapshot: skip, NOT consumed — a repaired sync
                # retries it (the core's quarantine discipline)
                logger.debug(
                    "stable prefix: snapshot %s unreadable; skipped",
                    name, exc_info=True,
                )
                continue
            if any(
                c > watermark.get(a, 0) for a, c in cursor.counters.items()
            ):
                continue  # folds unstable ops; retried once covered
            # sync section: a snapshot IS the fold of its cursor's
            # prefix (compaction contract), so merging it keeps the
            # prefix == fold-of-cursor-cut invariant
            state = core.adapter.state_from_obj(obj[0])
            self.state.merge(state)
            self.cursor.merge(cursor)
            self.consumed.add(name)
            for a in cursor.counters:
                if self.cursor.get(a) >= watermark.get(a, 0):
                    self.wedged.pop(a, None)
            trace.add("read_stable_snapshots", 1)

    async def _fold_stable_ops(self, core, watermark: dict) -> None:
        from ..core.core import MissingKeyError

        wanted = []
        for a, hi in sorted(watermark.items()):
            lo = self.cursor.get(a) + 1
            if hi >= lo:
                wanted.append((a, lo))
            else:
                self.wedged.pop(a, None)
        if not wanted:
            return
        files = await core.storage.load_ops(wanted)
        folded = 0
        cut: set[Actor] = set()
        for actor, version, raw in files:
            if actor in cut or version > watermark.get(actor, 0):
                continue
            expected = self.cursor.get(actor) + 1
            if version < expected:
                continue  # a stable snapshot already covered it
            if version > expected:
                # a hole below the watermark: the file was GC'd into a
                # snapshot we cannot use yet (its cursor exceeds the
                # watermark).  Wedge the actor — honest staleness, the
                # snapshot merges the moment the watermark covers it.
                self.wedged[actor] = "gc_gap"
                cut.add(actor)
                continue
            try:
                payload = await core._open_sealed(raw)
            except MissingKeyError:
                raise
            except Exception:
                # torn op file: cursor holds, dense run ends here
                self.wedged[actor] = "torn"
                cut.add(actor)
                continue
            # sync section: host fold in version order (the causal-
            # delivery contract; cross-actor order is CmRDT-free)
            for o in payload:
                self.state.apply(core.adapter.op_from_obj(o))
            self.cursor.apply(Dot(actor, version))
            self.wedged.pop(actor, None)
            folded += 1
        # load_ops' dense-scan contract stops at the first missing
        # version, so an actor whose NEXT stable op was GC'd returns
        # nothing at all — record the wedge for observability
        got = {a for a, _, _ in files}
        for a, lo in wanted:
            if a not in got and a not in cut and watermark.get(a, 0) >= lo:
                self.wedged[a] = "gc_gap"
        if folded:
            trace.add("read_stable_ops", folded)

    # ------------------------------------------------------- checkpoint
    def to_obj(self) -> dict:
        """The observational ``b"sp"`` checkpoint slot: generic adapter
        state form + frontier + consumed snapshot names.  Never part of
        the checkpoint fingerprint — a missing or malformed slot only
        costs a cold prefix rebuild, never a wrong read."""
        return {
            b"state": self.adapter.state_to_obj(self.state),
            b"cursor": self.cursor.to_obj(),
            b"names": sorted(self.consumed),
        }

    @classmethod
    def from_obj(cls, adapter, obj) -> "StablePrefix":
        prefix = cls(adapter)
        prefix.state = adapter.state_from_obj(obj[b"state"])
        prefix.cursor = VClock.from_obj(obj[b"cursor"])
        prefix.consumed = {str(n) for n in obj[b"names"]}
        return prefix


# --------------------------------------------------------------- helpers
def effective_watermark(core, *, policy=None):
    """The (policy-adjusted) stability watermark from a core's CURRENT
    knowledge — no storage probe; callers refresh via ``read_remote``
    first when they need liveness.  Returns ``(watermark, union,
    denominator, excluded)``."""
    from ..obs.replication import stability_watermark

    d = core._data
    union = d.next_op_versions.copy()
    for clock in d.cursor_matrix.values():
        union.merge(clock)
    if policy is None:
        replicas = (
            set(d.cursor_matrix) | set(union.counters) | {core.actor_id}
        )
        excluded: frozenset = frozenset()
    else:
        replicas = policy.observe(core.actor_id, d.cursor_matrix, union)
        excluded = policy.excluded
    wm = stability_watermark(
        core.actor_id, d.next_op_versions, d.cursor_matrix, union,
        replicas=replicas,
    )
    return wm, union, replicas, excluded


def find_holdouts(core, watermark: dict, union: VClock, replicas) -> list:
    """The replicas whose published cursors cap the watermark at its
    lagging entries — WHO the fleet is waiting for.  These are exactly
    the laggards the daemon's cadence scheduler should visit first, and
    the names a :class:`StalenessError` message carries."""
    d = core._data
    holdouts: set[Actor] = set()
    for a, c in union.counters.items():
        lo = watermark.get(a, 0)
        if lo >= c:
            continue
        for r in replicas:
            if r == core.actor_id:
                k = d.next_op_versions.get(a)
            else:
                row = d.cursor_matrix.get(r)
                k = row.get(a) if row is not None else 0
            if r == a:
                k = max(k, union.get(a))
            if k <= lo:
                holdouts.add(r)
    return sorted(h.hex() for h in holdouts)
