"""The linearizability checker for strong reads.

The port's copy of ``crdt_enc_tpu/sim/linearize.py``.

The strong-read tier's contract is checked, not asserted: every
``read_strong`` the simulator issues is validated against an **oracle
op log** — the plaintext of every op file that ever became durable,
recorded at the storage seam the moment it landed (so compaction GC
cannot erase the evidence).  Four properties, each a
machine-checkable piece of the documented guarantee:

1. **consistent-cut exactness** — the returned value must be
   byte-identical to a fresh host fold of *exactly* the op prefix named
   by the read's stable cursor (per-actor dense, version order).  This
   is the linearization witness: the read IS the fold of one
   causally-closed cut of the history, not an approximation of it —
   "the oracle fold at some point" where points are the consistent cuts
   of the partial order, the CRDT generalization of an instant.
2. **durability** — every op in the cut landed before the read
   returned (a cut naming an op the oracle never saw is a phantom).
3. **session monotonicity** — within a replica incarnation, successive
   strong reads return pointwise-monotone cursors (reads never travel
   back in time; warm reopens keep the frontier via the checkpointed
   prefix, cold reopens start a new session — both per the docs).
4. **read-your-writes** — a strong read issued after a successful
   ``await_stable(target)`` must cover ``target`` (the freshness-wait
   protocol's whole point).

The oracle fold and all comparisons are pure and synchronous; the
runner gathers inputs (and decrypts tapped blobs with the writer's own
key material at the moment of the write, so key rotation mid-history
changes nothing).  A failed property becomes an ordinary
``Violation("linearizability", ...)`` — ddmin-shrinkable into a
committed fixture like any other simulator finding.
"""

from __future__ import annotations

from ..models import ORSet, canonical_bytes
from ..models.orset import op_from_obj
from ..models.vclock import VClock


def oracle_fold(oplog: dict, cursor: VClock):
    """Fold exactly the cut named by ``cursor`` from the plaintext op
    log ``{(actor, version): [op_obj, ...]}``: per-actor dense version
    order (the causal-delivery contract; cross-actor order is free by
    CmRDT commutativity).  Returns ``(state, missing)`` — ``missing``
    non-empty means the cut names ops that never landed."""
    state = ORSet()
    missing = []
    for actor in sorted(cursor.counters):
        for version in range(1, cursor.get(actor) + 1):
            payload = oplog.get((actor, version))
            if payload is None:
                missing.append((actor.hex(), version))
                continue
            for obj in payload:
                state.apply(op_from_obj(obj))
    return state, missing


def check_strong_read(
    oplog: dict,
    result,
    prev_cursor: VClock | None,
    *,
    ryw_target: VClock | None = None,
) -> str | None:
    """Validate one strong read against the oracle (module docs).
    ``result`` is the ``ReadResult`` a ``Core.read(linearizable=True)``
    returned; ``prev_cursor`` the same incarnation's previous strong
    cursor (None for the first); ``ryw_target`` the clock a preceding
    successful ``await_stable`` promised coverage of.  Returns a defect
    description, or None when every property holds."""
    cursor = result.cursor
    # 3: session monotonicity
    if prev_cursor is not None:
        regressed = sorted(
            a.hex()
            for a, c in prev_cursor.counters.items()
            if cursor.get(a) < c
        )
        if regressed:
            return (
                "strong-read cursor regressed within an incarnation "
                f"for actors {regressed}"
            )
    # 4: read-your-writes after a successful freshness wait
    if ryw_target is not None:
        uncovered = sorted(
            a.hex()
            for a, c in ryw_target.counters.items()
            if cursor.get(a) < c
        )
        if uncovered:
            return (
                "await_stable succeeded but the following strong read "
                f"does not cover the awaited clock for {uncovered}"
            )
    # 1 + 2: exactness against the oracle fold of the cut (+ phantoms)
    oracle, missing = oracle_fold(oplog, cursor)
    if missing:
        return (
            "strong-read cursor names ops that never became durable: "
            f"{missing[:4]}"
        )
    got = canonical_bytes(ORSet.from_obj(result.obj))
    want = canonical_bytes(oracle)
    if got != want:
        return (
            "strong read diverges from the oracle fold of its own cut "
            f"(cursor {sorted((a.hex()[:8], c) for a, c in cursor.counters.items())})"
        )
    return None
