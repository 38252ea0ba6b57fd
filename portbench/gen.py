"""The benchmark's frozen op generator: the same work for every seed.

Every actor runs one fixed template of ``ops_per_actor`` OR-Set ops:
position ``p`` is a remove when ``(p + 1) % rm_every == 0``, and every
other position is an add.  The j-th add of an actor goes to member slot
``j % members`` with the dot counter ``j + 1``.  The remove at ``p``
targets the member of the add at ``p - rm_back``, with the actor's add
count so far as its horizon, so it always aims at a member that actor
added before it.  The template fixes the ops, adds and removes per actor,
the files per actor and the ops per file, and with them the live cells.

The seed picks only ids and orders: each actor's 16-byte id, the member
id behind each slot (a seeded permutation of the members, walked by a
seeded affine step per actor) and the data key.  ``counts`` states the
numbers a run prints and checks against its configuration.
"""

from __future__ import annotations

import math

import numpy as np


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for ``seed`` (any whole number) and a salt path."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), *salt]))


def template(ops_per_actor: int, rm_every: int, rm_back: int):
    """One actor's ops as (kind, add index, counter) columns: kind 0 add,
    1 remove; an add's ``add index`` is its j, a remove's is the j of the
    add it targets; ``counter`` is the dot (adds) or the horizon
    (removes)."""
    if not 1 <= rm_back < rm_every:
        raise ValueError("a remove must target an add before it")
    p = np.arange(ops_per_actor)
    kind = ((p + 1) % rm_every == 0).astype(np.int8)
    adds_before = np.cumsum(1 - kind) - (1 - kind)  # adds strictly before p
    target = np.where(kind == 1, adds_before[np.maximum(p - rm_back, 0)],
                      adds_before)
    counter = np.where(kind == 1, adds_before, adds_before + 1)
    return kind, target.astype(np.int64), counter.astype(np.int32)


def actor_ids(seed: int, R: int) -> list:
    """R distinct seeded 16-byte actor ids."""
    raw = rng_for(seed, 1, 0).integers(0, 256, (R, 16), dtype=np.uint8)
    ids = [bytes(row) for row in raw]
    if len(set(ids)) != R:
        raise AssertionError("actor id collision")
    return ids


def _units(E: int) -> np.ndarray:
    return np.array([u for u in range(1, E) if math.gcd(u, E) == 1] or [1])


def columns(seed: int, R: int, E: int, ops_per_actor: int, rm_every: int,
            rm_back: int):
    """The op columns, grouped by actor in op order: ``kind`` (int8),
    ``member`` (int32 ids 0..E-1), ``actor`` (int32 index), ``counter``
    (int32)."""
    kind_t, slot_j, counter_t = template(ops_per_actor, rm_every, rm_back)
    rng = rng_for(seed, 2, 0)
    gperm = rng.permutation(E).astype(np.int64)
    off = rng.integers(0, E, R)
    mul = rng.choice(_units(E), R)
    slot = slot_j % E
    member = gperm[(off[:, None] + mul[:, None] * slot[None, :]) % E]
    n = R * ops_per_actor
    return (np.tile(kind_t, R), member.reshape(n).astype(np.int32),
            np.repeat(np.arange(R, dtype=np.int32), ops_per_actor),
            np.tile(counter_t, R))


def files(cols, actors: list, ops_per_actor: int, ops_per_file: int) -> list:
    """Op files ``(actor index, actor id, version, ops)``: each actor's
    ops cut into files of ``ops_per_file`` (the last shorter), versions
    dense from 1, ops in their wire form."""
    kind, member, actor, counter = (c.tolist() for c in cols)
    out = []
    for a, ab in enumerate(actors):
        base = a * ops_per_actor
        for v, lo in enumerate(range(0, ops_per_actor, ops_per_file), 1):
            hi = min(lo + ops_per_file, ops_per_actor)
            out.append((a, ab, v, [
                [0, member[t], [ab, counter[t]]] if kind[t] == 0
                else [1, member[t], {ab: counter[t]}]
                for t in range(base + lo, base + hi)]))
    return out


def live_cells_per_actor(ops_per_actor: int, rm_every: int, rm_back: int,
                         E: int) -> int:
    """Cells (member, actor) one actor leaves live: its template replayed
    over slots."""
    kind, j, counter = template(ops_per_actor, rm_every, rm_back)
    last_add, last_rm = {}, {}
    for k, jj, c in zip(kind.tolist(), j.tolist(), counter.tolist()):
        s = jj % E
        if k == 0:
            last_add[s] = c
        else:
            last_rm[s] = max(last_rm.get(s, 0), c)
    return sum(1 for s, c in last_add.items() if c > last_rm.get(s, 0))


def counts(shape: dict, snapshots: int = 0, snapshot_stride: int = 16) -> dict:
    """The work a configuration implies, the same for every seed."""
    R, E, n = shape["replicas"], shape["members"], shape["ops_per_actor"]
    kind, _, _ = template(n, shape["rm_every"], shape["rm_back"])
    files_per_actor = -(-n // shape["ops_per_file"])
    covered = sum(len(range(i, R, snapshot_stride)) for i in range(snapshots))
    return {
        "ops": R * n,
        "removes": R * int(kind.sum()),
        "op_files": R * files_per_actor,
        "snapshots": snapshots,
        "files_in_snapshots": covered,
        "states": snapshots + 1 if snapshots else 0,
        "live_cells": R * live_cells_per_actor(
            n, shape["rm_every"], shape["rm_back"], E),
    }


def measured_counts(cols, R: int, ops_per_file: int, snapshots: int = 0,
                    snapshot_stride: int = 16) -> dict:
    """The same numbers counted from generated columns."""
    kind, member, actor, counter = cols
    per_actor = np.bincount(actor, minlength=R)
    add = kind == 0
    key = member.astype(np.int64) * R + actor
    cells, at = np.unique(key, return_inverse=True)
    add_max = np.zeros(len(cells), np.int64)
    rm_max = np.zeros(len(cells), np.int64)
    np.maximum.at(add_max, at[add], counter[add])
    np.maximum.at(rm_max, at[~add], counter[~add])
    live = int((add_max > rm_max).sum())
    covered = sum(1 for a in range(R)
                  if a % snapshot_stride < snapshots)
    return {
        "ops": int(len(kind)), "removes": int((~add).sum()),
        "op_files": int(sum(-(-int(x) // ops_per_file) for x in per_actor)),
        "snapshots": snapshots, "files_in_snapshots": covered,
        "states": snapshots + 1 if snapshots else 0, "live_cells": live,
    }
