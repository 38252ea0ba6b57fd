"""SPN001 — every span/metric name registered; proof spans must emit.

The observability registry is the two tables (``## Span registry`` and
``## Counter & gauge registry``) in the port's own
``crdt_enc_tpu_torch/analysis/observability.md``; library code may only
emit literal names that appear there (aggregation keys must stay
low-cardinality), and a
REGISTERED ``stream.*`` name with no call site is an error — those
spans back the machine-checked overlap/backpressure proofs
(``chunk_overlaps``, ``obs_report --check-overlap``), which would
silently read an empty timeline.

Severities: unregistered literal name → error; f-string / identifier
name → warning (identifiers are fine when the VALUES are registered
literals defined nearby); stale non-stream registry row → warning.
"""

from __future__ import annotations

import ast
import re

from ..astutil import const_str
from ..engine import PKG, SEV_ERROR, SEV_WARNING, Finding, Project, rule

_RECEIVERS = {"trace", "record", "_record"}
_KINDS = {"span", "add", "gauge", "observe"}
_TABLE_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|")
_REGISTRY_SECTIONS = ("## Span registry", "## Counter & gauge registry")
#: names maintained inside obs.record itself (no trace.* call site)
_INTERNAL = {"events_dropped"}
_PROOF_PREFIXES = ("stream.",)

DOC_REL = f"{PKG}/analysis/observability.md"


def _is_obs_call(func: ast.AST) -> bool:
    """``trace.add(...)`` — and the qualified spelling
    ``obs.record.add(...)``, where the receiver is the final attribute
    before the kind (the old regex lint matched both)."""
    if not (isinstance(func, ast.Attribute) and func.attr in _KINDS):
        return False
    base = func.value
    if isinstance(base, ast.Name):
        return base.id in _RECEIVERS
    if isinstance(base, ast.Attribute):
        return base.attr in _RECEIVERS
    return False


def registry_names(project: Project) -> dict[str, int] | None:
    """name -> doc line for the registry tables; None if the doc is
    missing/empty."""
    doc = project.root / DOC_REL
    if not doc.exists():
        return None
    names: dict[str, int] = {}
    in_registry = False
    for lineno, line in enumerate(doc.read_text().splitlines(), start=1):
        if line.startswith("## "):
            in_registry = line.strip() in _REGISTRY_SECTIONS
            continue
        if not in_registry:
            continue
        m = _TABLE_ROW_RE.match(line)
        if m:
            names.setdefault(m.group(1), lineno)
    return names or None


@rule("SPN001", SEV_ERROR)
def span_names_registered(project: Project):
    """trace/record span+metric names vs the observability registry."""
    registered = registry_names(project)
    if registered is None:
        yield Finding(
            rule="SPN001", severity=SEV_ERROR, path=DOC_REL, line=1,
            message="observability registry doc missing or has no "
            "registry tables",
        )
        return
    used: set[str] = set()
    for mod in project.modules:
        for call in mod.walk(ast.Call):
            func = call.func
            if not _is_obs_call(func):
                continue
            if not call.args:
                continue
            arg = call.args[0]
            kind = func.attr
            name = const_str(arg)
            if name is not None:
                used.add(name)
                if name not in registered:
                    yield Finding(
                        rule="SPN001", severity=SEV_ERROR, path=mod.rel,
                        line=call.lineno, context=mod.context_of(call),
                        message=(
                            f'{kind}("{name}") is not in the '
                            f"{DOC_REL} registry"
                        ),
                    )
            elif isinstance(arg, ast.JoinedStr):
                yield Finding(
                    rule="SPN001", severity=SEV_WARNING, path=mod.rel,
                    line=call.lineno, context=mod.context_of(call),
                    message=(
                        f"f-string {kind} name — dynamic cardinality "
                        "breaks the aggregate table"
                    ),
                )
            else:
                yield Finding(
                    rule="SPN001", severity=SEV_WARNING, path=mod.rel,
                    line=call.lineno, context=mod.context_of(call),
                    message=f"non-literal {kind} name",
                )
    if project.partial:
        # a path-subset run can't prove a registered name is unemitted
        return
    for stale in sorted(set(registered) - used - _INTERNAL):
        if stale.startswith(_PROOF_PREFIXES):
            yield Finding(
                rule="SPN001", severity=SEV_ERROR, path=DOC_REL,
                line=registered[stale],
                message=(
                    f"registry entry `{stale}` (stream.* proof family) has "
                    "no literal call site — the overlap proofs would read "
                    "an empty timeline"
                ),
            )
        else:
            yield Finding(
                rule="SPN001", severity=SEV_WARNING, path=DOC_REL,
                line=registered[stale],
                message=f"registry entry `{stale}` has no literal call site",
            )
