"""The analysis engine: one parse pass, rules fan out over the shared tree.

``Project`` walks the scan roots once, parsing every file into a
:class:`ModuleInfo` (AST + source lines + ``# lint: disable=RULE``
pragmas + a parent map + per-node enclosing-function qualnames).  Rules
are plain callables registered via :func:`rule`; each receives the whole
:class:`Project` and yields :class:`Finding`s, so cross-module rules
(FFI bindings vs. call sites, span registry vs. call sites) see the same
parsed trees as the per-function ones — nothing re-reads or re-parses a
file.

Suppression has exactly two channels, both carrying provenance:

* inline pragmas — ``# lint: disable=RULE[,RULE...]`` on the flagged
  line (or the line directly above it, comment-only), for point
  exceptions whose justification fits in the neighbouring comment;
* the committed baseline (``crdt_enc_tpu_torch/analysis/baseline.toml``,
  see :mod:`crdt_enc_tpu_torch.analysis.baseline`) for deliberate
  exceptions that need a recorded reason and a pinned match count.

A suppressed finding is not dropped — it is tagged with its channel so
``--json`` and ``--diff-baseline`` can audit the suppression inventory.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re
from typing import Callable, Iterable, Iterator

SEV_ERROR = "error"
SEV_WARNING = "warning"

#: the package this engine lints, as a repo-relative directory; every
#: rule scope is a prefix under it (``PKG_PREFIX + "serve/"``)
PKG = "crdt_enc_tpu_torch"
PKG_PREFIX = PKG + "/"

#: roots scanned relative to the repo root: the port's package alone.
#: ``tests/`` is deliberately absent (test code seeds violations on
#: purpose and uses scratch span names), and so is ``chip_smoke.py``,
#: which drives the package rather than being part of it.
SCAN_GLOBS: tuple[tuple[str, str], ...] = ((PKG, "**/*.py"),)

_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)")


@dataclasses.dataclass
class Finding:
    """One rule violation (or advisory) at a concrete source location."""

    rule: str
    severity: str  # SEV_ERROR | SEV_WARNING
    path: str  # repo-relative posix path
    line: int  # 1-based
    message: str
    context: str = "<module>"  # enclosing function qualname
    suppressed: str | None = None  # None | "pragma" | "baseline"
    #: effect provenance — the call path that introduced the effect,
    #: caller-first (populated by the interprocedural rules; None for
    #: the per-node pattern rules)
    chain: list[str] | None = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = f" [{self.suppressed}]" if self.suppressed else ""
        head = (
            f"{self.severity.upper()} {self.rule} {self.path}:{self.line} "
            f"({self.context}): {self.message}{tag}"
        )
        if self.chain:
            head += "".join(f"\n    via {link}" for link in self.chain)
        return head


class ModuleInfo:
    """One parsed source file plus the per-file indexes every rule needs."""

    def __init__(self, root: pathlib.Path, path: pathlib.Path):
        self.path = path
        self.rel = path.relative_to(root).as_posix()
        self.source = path.read_text()
        self.lines = self.source.splitlines()
        self.tree = ast.parse(self.source, filename=self.rel)
        self.pragmas = self._collect_pragmas(self.lines)
        self.parents: dict[ast.AST, ast.AST] = {}
        self.qualname: dict[ast.AST, str] = {}
        self._all_nodes: list[ast.AST] | None = None  # walk() cache
        self._index(self.tree, None, ())

    @staticmethod
    def _collect_pragmas(lines: list[str]) -> dict[int, set[str]]:
        out: dict[int, set[str]] = {}
        for i, line in enumerate(lines, start=1):
            m = _PRAGMA_RE.search(line)
            if m:
                out[i] = {r.strip() for r in m.group(1).split(",")}
        return out

    def _index(self, node: ast.AST, parent: ast.AST | None, stack: tuple) -> None:
        if parent is not None:
            self.parents[node] = parent
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            stack = stack + (node.name,)
        self.qualname[node] = ".".join(stack) if stack else "<module>"
        for child in ast.iter_child_nodes(node):
            self._index(child, node, stack)

    def suppressed_by_pragma(self, rule: str, line: int) -> bool:
        """Pragma on the flagged line, or comment-only pragma directly above."""
        if rule in self.pragmas.get(line, ()):
            return True
        above = self.pragmas.get(line - 1)
        if above and rule in above:
            text = self.lines[line - 2].strip() if line >= 2 else ""
            return text.startswith("#")
        return False

    def context_of(self, node: ast.AST) -> str:
        return self.qualname.get(node, "<module>")

    def walk(self, *types) -> Iterator[ast.AST]:
        # every rule re-walks every module; one cached flat list turns
        # the repeated traversals into plain list scans
        nodes = self._all_nodes
        if nodes is None:
            nodes = self._all_nodes = list(ast.walk(self.tree))
        if not types:
            return iter(nodes)
        return (n for n in nodes if isinstance(n, types))


class Project:
    """All scanned modules, parsed exactly once and shared by every rule."""

    def __init__(
        self,
        root: pathlib.Path,
        paths: Iterable[pathlib.Path] | None = None,
    ):
        self.root = pathlib.Path(root)
        self.modules: list[ModuleInfo] = []
        self.parse_errors: list[Finding] = []
        #: an explicit-paths run sees only a slice of the tree — rules
        #: with project-global negatives (SPN001 stale registry rows)
        #: and baseline staleness cannot be judged from it
        self.partial = paths is not None
        for path in sorted(set(paths if paths is not None else self._scan())):
            try:
                self.modules.append(ModuleInfo(self.root, path))
            except SyntaxError as e:
                self.parse_errors.append(
                    Finding(
                        rule="ENG000",
                        severity=SEV_ERROR,
                        path=path.relative_to(self.root).as_posix(),
                        line=e.lineno or 1,
                        message=f"file does not parse: {e.msg}",
                    )
                )
            except UnicodeDecodeError as e:
                # one bad file must degrade to a finding, not abort the
                # run — every other file still gets analyzed
                self.parse_errors.append(
                    Finding(
                        rule="ENG000",
                        severity=SEV_ERROR,
                        path=path.relative_to(self.root).as_posix(),
                        line=1,
                        message=(
                            f"file is not valid UTF-8: {e.reason} "
                            f"at byte {e.start}"
                        ),
                    )
                )

    def _scan(self) -> Iterator[pathlib.Path]:
        for base, pattern in SCAN_GLOBS:
            for path in (self.root / base).glob(pattern):
                if path.is_file() and "__pycache__" not in path.parts:
                    yield path

    @staticmethod
    def in_scan_scope(root: pathlib.Path, path: pathlib.Path) -> bool:
        """Would the default scan visit ``path``?  Explicit-path runs
        use this to honour the tests/-exempt contract: out-of-scope
        paths are skipped, not linted with library-invariant rules.
        Raises ValueError if ``path`` is outside ``root``."""
        rel = path.relative_to(root)
        if "__pycache__" in rel.parts:
            return False
        return any(
            rel.parts and rel.parts[0] == base and rel.suffix == ".py"
            for base, _pattern in SCAN_GLOBS
        )

    def module(self, rel: str) -> ModuleInfo | None:
        for mod in self.modules:
            if mod.rel == rel:
                return mod
        return None


# --------------------------------------------------------------- registry

#: name -> (callable(Project) -> Iterable[Finding], default severity, doc)
_RULES: dict[str, tuple[Callable, str, str]] = {}


def rule(name: str, severity: str = SEV_ERROR):
    """Register a rule.  The decorated callable takes a :class:`Project`
    and yields :class:`Finding`s; ``severity`` is its default (a rule may
    still emit individual findings at another severity)."""

    def deco(fn: Callable):
        _RULES[name] = (fn, severity, (fn.__doc__ or "").strip())
        fn.rule_name = name
        return fn

    return deco


def all_rules() -> dict[str, tuple[Callable, str, str]]:
    from . import rules as _  # noqa: F401 — importing registers the rules

    return dict(_RULES)


def run(
    project: Project,
    rule_names: Iterable[str] | None = None,
    baseline=None,
) -> list[Finding]:
    """Run the selected rules over the shared trees and apply suppression.

    Returns every finding (suppressed ones tagged, not dropped), sorted
    by (path, line, rule).  ``baseline`` is a
    :class:`crdt_enc_tpu_torch.analysis.baseline.Baseline` or None.
    """
    registry = all_rules()
    names = list(rule_names) if rule_names is not None else sorted(registry)
    unknown = [n for n in names if n not in registry]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}")
    findings: list[Finding] = list(project.parse_errors)
    for name in names:
        fn, _sev, _doc = registry[name]
        findings.extend(fn(project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    by_rel = {mod.rel: mod for mod in project.modules}
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None and mod.suppressed_by_pragma(f.rule, f.line):
            f.suppressed = "pragma"
    if baseline is not None:
        baseline.apply(findings)
    return findings


def unsuppressed_errors(findings: list[Finding]) -> list[Finding]:
    return [
        f for f in findings if f.severity == SEV_ERROR and f.suppressed is None
    ]
