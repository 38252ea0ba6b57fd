"""ASY001 — the event loop never blocks, and sync sections never yield.

Two obligations, both on the cooperative-scheduling contract that the
population runner and the serve tier depend on:

* no ``blocks`` effect (file/socket I/O, ``time.sleep``, subprocess,
  native and CUDA FFI, ``lock.acquire()``, a CUDA synchronize) may be
  reachable from an ``async def`` body in ``serve/``/``sim/``/``core/``
  of ``crdt_enc_tpu_torch/`` except through a sanctioned off-loop seam
  — ``asyncio.to_thread``/``run_in_executor`` and the ingest producer
  pool are modelled as laundering edges by the effect engine,
  everything else needs a baseline entry with a reason;
* no ``await`` inside a declared *sync section* — a region bracketed by
  ``# lint: sync-section-begin`` / ``# lint: sync-section-end`` whose
  correctness depends on not yielding to the loop (the compaction
  snapshot/cursor/delta-plan cut in ``core._compact_seal``).

Findings carry the provenance chain: the call path from the async body
down to the line that actually blocks.  When the effect arrives *via*
another in-scope async function, the finding is reported there (once),
not at every transitive caller.
"""

from __future__ import annotations

import ast
import re

from ..effects import KIND_BLOCKS, effect_index
from ..engine import PKG_PREFIX, SEV_ERROR, Finding, Project, rule

_SCOPE_PREFIXES = tuple(PKG_PREFIX + d for d in ("serve/", "sim/", "core/"))

_BEGIN_RE = re.compile(r"#\s*lint:\s*sync-section-begin\b")
_END_RE = re.compile(r"#\s*lint:\s*sync-section-end\b")


def _in_scope(rel: str) -> bool:
    return rel.startswith(_SCOPE_PREFIXES)


def _sync_sections(mod):
    """(begin_line, end_line) regions; unterminated regions yield
    (begin_line, None)."""
    begin = None
    for i, line in enumerate(mod.lines, start=1):
        # markers are standalone comment lines — a mention inside a
        # docstring or trailing a statement is not a declaration
        if not line.lstrip().startswith("#"):
            continue
        if _BEGIN_RE.search(line):
            if begin is not None:
                yield (begin, None)  # previous region never closed
            begin = i
        elif _END_RE.search(line):
            if begin is not None:
                yield (begin, i)
                begin = None
    if begin is not None:
        yield (begin, None)


@rule("ASY001", SEV_ERROR)
def no_blocking_in_async(project: Project):
    """Async bodies in serve/sim/core must not reach a blocks effect
    except through sanctioned off-loop seams; declared sync sections
    must not await."""
    idx = effect_index(project)
    for fi in idx.funcs.values():
        if not fi.is_async or not _in_scope(fi.mod.rel):
            continue
        for (kind, origin), prov in sorted(fi.effects.items()):
            if kind != KIND_BLOCKS:
                continue
            if prov.via:
                callee = idx.funcs.get(prov.via)
                if callee is not None and callee.is_async and _in_scope(callee.mod.rel):
                    continue  # reported at the inner async boundary
            chain = idx.chain(fi.key, kind, origin)
            yield Finding(
                rule="ASY001",
                severity=SEV_ERROR,
                path=fi.mod.rel,
                line=prov.line,
                context=fi.qualname,
                message=(
                    f"async def reaches blocking effect `{origin}` — "
                    "move it behind asyncio.to_thread / the producer "
                    "pool, or baseline with a reason"
                ),
                chain=chain,
            )
    for mod in project.modules:
        sections = list(_sync_sections(mod))
        if not sections:
            continue
        for begin, end in sections:
            if end is None:
                yield Finding(
                    rule="ASY001",
                    severity=SEV_ERROR,
                    path=mod.rel,
                    line=begin,
                    message=(
                        "sync-section-begin without a matching "
                        "sync-section-end — the region must be closed "
                        "explicitly"
                    ),
                )
        closed = [(b, e) for b, e in sections if e is not None]
        if not closed:
            continue
        for node in mod.walk(ast.Await):
            for b, e in closed:
                if b < node.lineno < e:
                    yield Finding(
                        rule="ASY001",
                        severity=SEV_ERROR,
                        path=mod.rel,
                        line=node.lineno,
                        context=mod.context_of(node),
                        message=(
                            f"await inside the sync section declared at "
                            f"line {b} — the region's snapshot/cursor cut "
                            "must not yield to the event loop"
                        ),
                    )
                    break
