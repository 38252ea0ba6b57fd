"""Replication status: the causal stability watermark over the cursor
matrix, the op backlog, divergence and checkpoint staleness.

The port's copy of ``crdt_enc_tpu/obs/replication.py``
(``stability_watermark`` computed in linear time, see there).  Each compacted snapshot carries its
sealer's ingest cursor, so reading a snapshot (or a delta) is learning a
replica's progress: the core keeps those published cursors as its
**cursor matrix**.  The watermark is the vector-clock frontier every
known replica has provably reached, ``watermark[a] = min over replicas r
of cursor_r[a]``.  A replica with no published cursor contributes only
its implied self-knowledge (it has certainly seen its own sealed ops), so
one silent replica collapses the watermark for every other actor's
entries — silence is indistinguishable from lag.  Each sealed delta is
tagged with its sealer's watermark (``delta/wire.py``).

:func:`compute_status` is a pure function of what the core tracks: its
ingest cursor, the cursor matrix, the ``Storage.stat_ops`` sizes of the
op tail past the cursor (sized without reading), and the last sealed
checkpoint's cursor.  ``Core.replication_status()`` gathers the inputs
and :func:`sample` publishes the scalar summary into gauges on every
``open`` / ``read_remote`` / ``compact``.  Actor ids in the status are
lowercase hex and every collection is sorted, so ``json.dumps(status,
sort_keys=True)`` is byte-stable for a given replica state.
"""

from __future__ import annotations

from ..models.vclock import Actor, VClock
from . import record


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


def _hex_clock(clock: VClock) -> dict[str, int]:
    return {a.hex(): c for a, c in sorted(clock.counters.items()) if c > 0}


def compute_status(
    actor_id: Actor,
    local_clock: VClock,
    cursor_matrix: dict[Actor, VClock],
    backlog_stats: list[tuple[Actor, int, int]],
    remote_id: bytes,
    checkpoint_cursor: dict[Actor, int] | None,
    checkpoint_enabled: bool,
) -> dict:
    """The replication status dict (module docs).

    ``backlog_stats`` is ``Storage.stat_ops`` output for versions past
    the local cursor: ``(actor, version, nbytes)`` in version order per
    actor.  ``cursor_matrix`` maps OTHER replicas' actor ids to their
    last published ingest cursor; the local replica's live cursor is
    ``local_clock``.  ``checkpoint_cursor`` is the cursor of the last
    durably sealed checkpoint (None when none was sealed)."""
    # everything known to exist: local history, the sealed tail past it
    # and every published cursor (a cursor claims the ops it counts)
    union = local_clock.copy()
    per_actor: dict[Actor, list[int]] = {}
    backlog_files = backlog_bytes = 0
    for actor, version, nbytes in backlog_stats:
        if version > union.get(actor):
            union.counters[actor] = version
        slot = per_actor.setdefault(actor, [0, 0])
        slot[0] += 1
        slot[1] += int(nbytes)
        backlog_files += 1
        backlog_bytes += int(nbytes)
    for clock in cursor_matrix.values():
        union.merge(clock)

    # replicas: this one, every published cursor and every actor that
    # ever produced ops (op files are written under the writer's id)
    replicas = set(cursor_matrix) | set(union.counters) | {actor_id}
    watermark = stability_watermark(actor_id, local_clock, cursor_matrix,
                                    union)

    actors_behind = sum(
        1 for a, c in union.counters.items() if c > local_clock.get(a)
    )
    version_lag = sum(
        c - local_clock.get(a) for a, c in union.counters.items()
        if c > local_clock.get(a)
    )
    watermark_lag = sum(
        c - watermark.get(a, 0) for a, c in union.counters.items()
    )

    sealed = checkpoint_cursor is not None
    base = checkpoint_cursor or {}
    staleness = sum(
        c - base.get(a, 0)
        for a, c in local_clock.counters.items()
        if c > base.get(a, 0)
    )

    return {
        "actor": actor_id.hex(),
        "remote_id": remote_id.hex(),
        "local_clock": _hex_clock(local_clock),
        "union_clock": _hex_clock(union),
        "watermark": {a.hex(): c for a, c in sorted(watermark.items())},
        "matrix": {
            r.hex(): _hex_clock(clock)
            for r, clock in sorted(cursor_matrix.items())
        },
        "backlog": {
            "files": backlog_files,
            "bytes": backlog_bytes,
            "per_actor": {
                a.hex(): {"files": f, "bytes": b}
                for a, (f, b) in sorted(per_actor.items())
            },
        },
        "divergence": {
            "actors_behind": actors_behind,
            "version_lag": version_lag,
            "watermark_lag": watermark_lag,
            "known_replicas": len(replicas),
        },
        "checkpoint": {
            "enabled": bool(checkpoint_enabled),
            "sealed": sealed,
            "staleness_versions": staleness,
        },
    }


def sample(status: dict) -> None:
    """Publish one status' scalar summary into the gauges (the names the
    JAX package registers)."""
    record.gauge("repl_backlog_files", status["backlog"]["files"])
    record.gauge("repl_backlog_bytes", status["backlog"]["bytes"])
    record.gauge("repl_actors_behind", status["divergence"]["actors_behind"])
    record.gauge("repl_version_lag", status["divergence"]["version_lag"])
    record.gauge("repl_watermark_lag", status["divergence"]["watermark_lag"])
    record.gauge("repl_known_replicas",
                 status["divergence"]["known_replicas"])
    record.gauge("checkpoint_staleness_versions",
                 status["checkpoint"]["staleness_versions"])
    record.add("repl_samples", 1)
