"""Fault-class × vocabulary co-fire accounting (reporting only; the
schedule generator is not biased by it).

The port's copy of ``crdt_enc_tpu/sim/coverage.py``.

A schedule exercises a *vocabulary* (the base step set, plus the deltas
/ daemon / strong-reads extensions its flags enable) and its storage
wrappers *fire* fault classes.  A bug that needs, say, a torn read
during a delta-chain walk can only be found by runs where that pair
co-occurs — so the honest first step toward coverage-guided generation
is the map of what has actually co-fired, accumulated across an explore
sweep and rendered without any editorializing.  A cell counts the runs
in which vocabulary V was enabled AND fault class F fired at least once
(``SimResult.fault_stats``, the injected-fault tallies); a zero cell is
a hole no nightly has ever tested.

``python -m crdt_enc_tpu_torch.tools.sim explore --coverage-out f.json``
dumps the matrix.  The matrix deliberately lives OUTSIDE the schedule
generator: recording must never perturb the RNG streams (the
seed-replay and fixture contracts), so it only ever reads results.
"""

from __future__ import annotations

import json

from .faults import FaultConfig

# vocabulary columns: the base vocabulary is always on; the extensions
# mirror the generate() flags exactly (schedule.py's weight tables)
VOCABULARIES = ("base", "deltas", "daemon", "strong_reads")

COVERAGE_VERSION = 1


class CoFireMatrix:
    """Accumulates (fault class × vocabulary) co-fire counts per run."""

    def __init__(self):
        self.runs = 0
        self.cells = {
            (f, v): 0 for f in FaultConfig.CLASSES for v in VOCABULARIES
        }

    def record(self, schedule, result) -> None:
        """Fold one finished run in: every fault class that FIRED
        (tally > 0, not merely enabled) co-fires with every vocabulary
        the schedule had enabled."""
        self.runs += 1
        vocabs = ["base"] + [
            v
            for v in ("deltas", "daemon", "strong_reads")
            if getattr(schedule, v, False)
        ]
        for f in FaultConfig.CLASSES:
            if result.fault_stats.get(f, 0) > 0:
                for v in vocabs:
                    self.cells[(f, v)] += 1

    def holes(self) -> list[tuple[str, str]]:
        """The never-co-fired pairs — what the map is FOR."""
        return [fv for fv in sorted(self.cells) if self.cells[fv] == 0]

    # ------------------------------------------------------------- wire
    def to_obj(self) -> dict:
        return {
            "version": COVERAGE_VERSION,
            "runs": self.runs,
            "faults": list(FaultConfig.CLASSES),
            "vocabularies": list(VOCABULARIES),
            "cells": {f"{f}:{v}": n for (f, v), n in self.cells.items()},
        }

    @classmethod
    def from_obj(cls, obj: dict) -> "CoFireMatrix":
        if obj.get("version") != COVERAGE_VERSION:
            raise ValueError(
                f"unsupported coverage version {obj.get('version')!r}"
            )
        m = cls()
        m.runs = int(obj.get("runs", 0))
        for key, n in obj.get("cells", {}).items():
            f, _, v = key.partition(":")
            if (f, v) in m.cells:
                m.cells[(f, v)] = int(n)
        return m

    def dump(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_obj(), fh, indent=1)
            fh.write("\n")

    @classmethod
    def load(cls, path: str) -> "CoFireMatrix":
        with open(path) as fh:
            return cls.from_obj(json.load(fh))

    # ----------------------------------------------------------- render
    def render(self) -> str:
        """Plain table, faults down, vocabularies across; '.' marks a
        hole (never co-fired), so holes jump out of a wall of counts."""
        w = max(len(f) for f in FaultConfig.CLASSES)
        cols = [max(len(v), 6) for v in VOCABULARIES]
        lines = [
            f"{'':<{w}}  "
            + "  ".join(f"{v:>{c}}" for v, c in zip(VOCABULARIES, cols))
        ]
        for f in FaultConfig.CLASSES:
            cells = []
            for v, c in zip(VOCABULARIES, cols):
                n = self.cells[(f, v)]
                cells.append(f"{n if n else '.':>{c}}")
            lines.append(f"{f:<{w}}  " + "  ".join(cells))
        holes = self.holes()
        lines.append(
            f"{self.runs} run(s); "
            + (
                f"{len(holes)} never-co-fired pair(s): "
                + ", ".join(f"{f}×{v}" for f, v in holes)
                if holes
                else "every fault×vocabulary pair has co-fired"
            )
        )
        return "\n".join(lines)
