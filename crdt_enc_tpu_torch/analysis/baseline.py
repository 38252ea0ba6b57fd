"""Committed suppression baseline for the static-analysis engine.

``crdt_enc_tpu_torch/analysis/baseline.toml`` records the *deliberate*
exceptions to the project invariants — each entry names the rule, the
file, usually the enclosing function, a human reason, and a pinned
``max`` match count.  The pin is what keeps the baseline honest: a NEW
violation in an already-baselined function exceeds the pin and surfaces
instead of riding the old exception (the thread-discipline lint's
per-file site counts, generalized).

The file is a deliberately small TOML subset so the engine stays stdlib
on Python 3.10 (no ``tomllib``): comments, ``[[suppress]]`` array
headers, and ``key = "string" | integer`` pairs.  :func:`parse_toml`
rejects anything else loudly rather than guessing.

Matching: a finding matches an entry when the rule and path are equal
and the entry's ``context`` (if present) equals the finding's enclosing
function qualname.  Entries suppress at most ``max`` findings (default
1), in source order; ``reason`` is mandatory — an unexplained exception
is indistinguishable from a rubber stamp.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

from .engine import Finding

_HEADER_RE = re.compile(r"^\[\[(\w+)\]\]$")
_PAIR_RE = re.compile(r"^(\w+)\s*=\s*(\"(?:[^\"\\]|\\.)*\"|\d+)$")


def _strip_comment(raw: str) -> str:
    """Drop a trailing ``#`` comment — but not a ``#`` inside a quoted
    value (a reason may quote a ``#``)."""
    out = []
    in_str = False
    i = 0
    while i < len(raw):
        c = raw[i]
        if in_str:
            if c == "\\" and i + 1 < len(raw):
                out.append(raw[i : i + 2])
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
        elif c == "#":
            break
        out.append(c)
        i += 1
    return "".join(out).strip()


def parse_toml(text: str) -> list[dict]:
    """Parse the ``[[suppress]]`` TOML subset (see module docs)."""
    entries: list[dict] = []
    current: dict | None = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        m = _HEADER_RE.match(line)
        if m:
            if m.group(1) != "suppress":
                raise ValueError(
                    f"baseline line {lineno}: unknown table [[{m.group(1)}]]"
                )
            current = {}
            entries.append(current)
            continue
        m = _PAIR_RE.match(line)
        if m and current is not None:
            key, val = m.group(1), m.group(2)
            if val.startswith('"'):
                current[key] = val[1:-1].replace('\\"', '"').replace("\\\\", "\\")
            else:
                current[key] = int(val)
            continue
        raise ValueError(f"baseline line {lineno}: cannot parse {raw!r}")
    return entries


@dataclasses.dataclass
class Entry:
    rule: str
    path: str
    reason: str
    context: str | None = None
    contains: str | None = None  # message substring, for co-located findings
    max: int = 1
    matched: int = 0

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule or self.path != f.path:
            return False
        if self.context is not None and self.context != f.context:
            return False
        if self.contains is not None and self.contains not in f.message:
            return False
        return True


class Baseline:
    def __init__(self, entries: list[Entry]):
        self.entries = entries

    @classmethod
    def load(cls, path: pathlib.Path | str) -> "Baseline":
        path = pathlib.Path(path)
        if not path.exists():
            return cls([])
        entries = []
        allowed = {"rule", "path", "reason", "context", "contains", "max"}
        for i, raw in enumerate(parse_toml(path.read_text())):
            missing = {"rule", "path", "reason"} - set(raw)
            if missing:
                raise ValueError(
                    f"baseline entry #{i + 1} missing {sorted(missing)}"
                )
            unknown = set(raw) - allowed
            if unknown:
                # a typo'd narrowing key (`contain`, `contxt`) must not
                # silently WIDEN the suppression
                raise ValueError(
                    f"baseline entry #{i + 1} has unknown "
                    f"key(s) {sorted(unknown)}"
                )
            entries.append(
                Entry(
                    rule=raw["rule"],
                    path=raw["path"],
                    reason=raw["reason"],
                    context=raw.get("context"),
                    contains=raw.get("contains"),
                    max=int(raw.get("max", 1)),
                )
            )
        return cls(entries)

    def apply(self, findings: list[Finding]) -> None:
        """Tag baseline-covered findings, in source order, up to each
        entry's ``max`` pin.  Pragma-suppressed findings don't consume
        baseline slots."""
        for entry in self.entries:
            entry.matched = 0
        for f in findings:
            if f.suppressed is not None:
                continue
            for entry in self.entries:
                if entry.matched < entry.max and entry.matches(f):
                    f.suppressed = "baseline"
                    entry.matched += 1
                    break

    def stale_entries(self) -> list[Entry]:
        """Entries that matched nothing in the last :meth:`apply` — the
        exception they document no longer exists and should be deleted."""
        return [e for e in self.entries if e.matched == 0]
