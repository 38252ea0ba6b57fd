"""The causal stability watermark over the cursor matrix.

The port's copy of ``stability_watermark`` from
``crdt_enc_tpu/obs/replication.py``.  Each compacted snapshot carries its
sealer's ingest cursor, so reading a snapshot (or a delta) is learning a
replica's progress: the core keeps those published cursors as its
**cursor matrix**.  The watermark is the vector-clock frontier every
known replica has provably reached, ``watermark[a] = min over replicas r
of cursor_r[a]``.  A replica with no published cursor contributes only
its implied self-knowledge (it has certainly seen its own sealed ops), so
one silent replica collapses the watermark for every other actor's
entries — silence is indistinguishable from lag.  Each sealed delta is
tagged with its sealer's watermark (``delta/wire.py``).
"""

from __future__ import annotations

from ..models.vclock import Actor, VClock


def stability_watermark(
    actor_id: Actor,
    local_clock: VClock,
    cursor_matrix: dict[Actor, VClock],
    union: VClock,
    replicas=None,
) -> dict[Actor, int]:
    """The causal stability watermark: pointwise min over every known
    replica's cursor (module docs).  ``union`` is everything known to
    exist; by default replicas are this one, every published cursor,
    and every actor that ever produced ops.  An explicit ``replicas``
    set replaces that denominator.

    The reference walks every (actor, replica) pair, 10^8 steps for a
    fleet of 10^4 actors that publish no cursor.  This gives the same
    dict from the silent replicas' count: a replica with no published
    cursor reads 0 for every actor but itself, so two of them zero the
    whole watermark, one zeroes every actor but itself, and otherwise
    the minimum runs over the published rows alone."""
    if replicas is None:
        replicas = set(cursor_matrix) | set(union.counters) | {actor_id}
    silent = [r for r in replicas
              if r != actor_id and r not in cursor_matrix]
    if len(silent) > 1:
        return {}
    published = [(r, cursor_matrix[r]) for r in replicas
                 if r != actor_id and r in cursor_matrix]
    with_self = actor_id in replicas
    watermark: dict[Actor, int] = {}
    for a in union.counters:
        if silent and silent[0] != a:
            continue  # the silent replica reads 0 for a
        ua = union.get(a)
        # implied self-knowledge: a replica has certainly seen its own
        # sealed ops, published cursor or not
        ks = [max(c.get(a), ua) if r == a else c.get(a) for r, c in published]
        if with_self:
            k = local_clock.get(a)
            ks.append(max(k, ua) if a == actor_id else k)
        if silent:
            ks.append(ua)
        lo = min(ks, default=0)
        if lo:
            watermark[a] = lo
    return watermark
