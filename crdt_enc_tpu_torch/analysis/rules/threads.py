"""THR001 — no bare ``threading.Thread`` outside the ingest pipeline.

Ad-hoc threads bypass everything ``ops/stream.py run_ingest_pipeline``
guarantees: backpressure (the BoundedSemaphore memory bound), ordered
sequencing, fault propagation (first failure cancels peers, threads are
joined) and per-lane observability.  The sanctioned exceptions — the
pipeline's own producer pools, the gpg stderr drain, the telemetry
listener — live in ``crdt_enc_tpu_torch/analysis/baseline.toml`` with
``max = 1`` pins: a NEW bare thread in an allowlisted function exceeds
the pin and still fails.
"""

from __future__ import annotations

import ast

from ..engine import SEV_ERROR, Finding, Project, rule


def _thread_aliases(mod) -> tuple[set[str], set[str]]:
    """(direct Thread names, threading-module names): covers
    ``from threading import Thread [as T]`` and
    ``import threading [as thr]``."""
    direct: set[str] = set()
    modules = {"threading"}
    for node in mod.walk(ast.ImportFrom):
        if node.module == "threading":
            for alias in node.names:
                if alias.name == "Thread":
                    direct.add(alias.asname or alias.name)
    for node in mod.walk(ast.Import):
        for alias in node.names:
            if alias.name == "threading":
                modules.add(alias.asname or alias.name)
    return direct, modules


@rule("THR001", SEV_ERROR)
def thread_discipline(project: Project):
    """Bare Thread construction outside run_ingest_pipeline."""
    for mod in project.modules:
        direct, modules = _thread_aliases(mod)
        for call in mod.walk(ast.Call):
            func = call.func
            bare = (
                isinstance(func, ast.Attribute)
                and func.attr == "Thread"
                and isinstance(func.value, ast.Name)
                and func.value.id in modules
            ) or (isinstance(func, ast.Name) and func.id in direct)
            if not bare:
                continue
            yield Finding(
                rule="THR001", severity=SEV_ERROR, path=mod.rel,
                line=call.lineno, context=mod.context_of(call),
                message=(
                    "bare threading.Thread outside run_ingest_pipeline — "
                    "route parallel ingest through ops/stream.py (or add "
                    "a baseline entry with a reason)"
                ),
            )
