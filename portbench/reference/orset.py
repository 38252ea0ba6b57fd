"""The plain reference of the OR-Set configurations, in NumPy.

It works the converged state out again from the generated op columns,
and judges a state object (a snapshot decoded by ``sealed.py``, or the
program's in-memory state read as plain dicts) cell by cell against it.

Semantics (add-wins OR-Set with per-actor dots): a cell (member, actor)
is live with counter ``c`` when the actor's highest add of the member,
``c``, exceeds the highest remove horizon the actor issued for it; the
clock is each actor's highest add; a horizon past the clock is kept as a
deferred remove.
"""

from __future__ import annotations

import numpy as np

SHIFT = 32  # cell code = (member * R + actor) << SHIFT | counter


def fold(cols, R: int) -> dict:
    """The converged state of one replica set's op columns."""
    kind, member, actor, counter = cols
    add = kind == 0
    key = member.astype(np.int64) * R + actor
    cells, at = np.unique(key, return_inverse=True)
    add_max = np.zeros(len(cells), np.int64)
    rm_max = np.zeros(len(cells), np.int64)
    np.maximum.at(add_max, at[add], counter[add].astype(np.int64))
    np.maximum.at(rm_max, at[~add], counter[~add].astype(np.int64))
    clock = np.zeros(R, np.int64)
    np.maximum.at(clock, actor[add], counter[add].astype(np.int64))
    live = add_max > rm_max
    dfr = rm_max > clock[cells % R]
    return {
        "R": R,
        "clock": clock,
        "entries": np.sort((cells[live] << SHIFT) | add_max[live]),
        "deferred": np.sort((cells[dfr] << SHIFT) | rm_max[dfr]),
    }


def _codes(groups: dict, index: dict, R: int):
    """Cell codes of ``{member: {actor: counter}}``; the count of cells
    naming an actor outside ``index`` comes back beside them."""
    out, unknown = [], 0
    for m, per in groups.items():
        base = int(m) * R
        for a, c in per.items():
            i = index.get(bytes(a))
            if i is None or not isinstance(m, int):
                unknown += 1
                continue
            out.append(((base + i) << SHIFT) | int(c))
    return np.sort(np.array(out, np.int64)), unknown


def encode(state_obj, index: dict, R: int) -> dict | None:
    """A state object (``{b"c": clock, b"e": entries, b"d": deferred}``)
    as arrays: what :func:`judge` compares, held without keeping the
    object's dicts alive.  None for an object of another shape."""
    if not isinstance(state_obj, dict):
        return None
    entries, unk_e = _codes(state_obj.get(b"e") or {}, index, R)
    deferred, unk_d = _codes(state_obj.get(b"d") or {}, index, R)
    clock, stray = _clock(state_obj.get(b"c") or {}, index, R)
    return {"entries": entries, "deferred": deferred, "clock": clock,
            "stray": unk_e + unk_d, "stray_clock": stray}


def judge(ref: dict, state) -> dict:
    """Cells of an encoded state that differ from the reference:
    ``cells_off`` counts entry and deferred cells present on one side
    only or with another counter, ``clock_off`` the actors whose clock
    differs."""
    if state is None:
        return {"cells_off": len(ref["entries"]) + len(ref["deferred"]),
                "clock_off": ref["R"]}
    cells_off = (len(np.setxor1d(state["entries"], ref["entries"]))
                 + len(np.setxor1d(state["deferred"], ref["deferred"]))
                 + state["stray"])
    return {"cells_off": int(cells_off),
            "clock_off": int((state["clock"] != ref["clock"]).sum())
            + state["stray_clock"]}


def _clock(got: dict, index: dict, R: int):
    seen = np.zeros(R, np.int64)
    stray = 0
    for a, c in got.items():
        i = index.get(bytes(a))
        if i is None:
            stray += 1
        else:
            seen[i] = int(c)
    return seen, stray


def clock_off(expected: np.ndarray, got: dict, index: dict) -> int:
    """Actors whose counter in ``got`` is not ``expected`` (zeros are
    absent from a canonical clock)."""
    seen, stray = _clock(got, index, len(expected))
    return int((seen != expected).sum()) + stray
