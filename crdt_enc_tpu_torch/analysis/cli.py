"""CLI for the static-analysis engine.

``python -m crdt_enc_tpu_torch.tools.analyze [--json] [--diff-baseline]
[--rule RULE ...] [--effects QUALNAME] [--expect-json-version N]
[--list-rules] [--no-baseline] [--root DIR] [paths...]``

It lints ``crdt_enc_tpu_torch/`` under ``--root`` (default: the checkout
this file lies in) against the baseline and the span registry that lie
beside this file.

Exit codes: 0 = no unsuppressed error-severity findings (and, under
``--diff-baseline``, no stale baseline entries either); 1 = violations;
2 = usage/configuration error (including an ``--expect-json-version``
mismatch, and an ``--effects`` qualname that matches nothing).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from .baseline import Baseline
from .engine import (
    PKG,
    SEV_ERROR,
    Project,
    all_rules,
    run,
    unsuppressed_errors,
)

BASELINE_REL = f"{PKG}/analysis/baseline.toml"
# v2 (interprocedural effects): findings gained `chain` (the provenance
# call path, caller-first), and `--effects` emits the per-function
# effect dump.  Consumers pinned to a version pass --expect-json-version
# and get a loud exit-2 reject instead of silently mis-parsing.
JSON_SCHEMA_VERSION = 2


def default_root() -> pathlib.Path:
    # crdt_enc_tpu_torch/analysis/cli.py -> repo root
    return pathlib.Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m crdt_enc_tpu_torch.tools.analyze",
        description="Project-invariant static analysis of crdt_enc_tpu_torch/",
    )
    p.add_argument("paths", nargs="*", help="restrict to these files")
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument(
        "--diff-baseline", action="store_true",
        help="also fail on stale baseline entries (the committed baseline "
        "must exactly cover the deliberate exceptions)",
    )
    p.add_argument(
        "--rule", action="append", dest="rules", metavar="RULE",
        help="run only this rule (repeatable)",
    )
    p.add_argument("--list-rules", action="store_true")
    p.add_argument(
        "--effects", metavar="QUALNAME",
        help="dump the inferred effect set + provenance chains for a "
        "function (e.g. Core.open, or serve/service.py::FoldService.run_cycle)",
    )
    p.add_argument(
        "--expect-json-version", type=int, default=None, metavar="N",
        help="fail loudly (exit 2) unless the --json schema version is "
        "exactly N — pin your consumer instead of silently mis-parsing",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the committed baseline (show everything)",
    )
    p.add_argument("--root", default=None, help="repo root (default: auto)")
    return p


def _effects_json(idx, fi) -> dict:
    return {
        "key": fi.key,
        "qualname": fi.qualname,
        "async": fi.is_async,
        "effects": [
            {"kind": kind, "origin": origin,
             "chain": idx.chain(fi.key, kind, origin)}
            for (kind, origin) in sorted(fi.effects)
        ],
        "unresolved": [
            {"path": u.rel, "line": u.line, "desc": u.desc}
            for u in fi.unresolved
        ],
        "sanctioned": [
            {"kind": kind, "line": line, "desc": desc}
            for kind, line, desc in fi.sanctioned
        ],
    }


def _print_effects(idx, fi) -> None:
    head = "async def" if fi.is_async else "def"
    print(f"{head} {fi.qualname}  [{fi.mod.rel}]")
    if not fi.effects:
        print("  effects: none")
    for (kind, origin) in sorted(fi.effects):
        print(f"  {kind}: {origin}")
        for link in idx.chain(fi.key, kind, origin):
            print(f"    via {link}")
    for u in fi.unresolved:
        print(f"  unresolved call at {u.rel}:{u.line}: {u.desc}")
    for kind, line, desc in fi.sanctioned:
        print(f"  sanctioned [{kind}] at {fi.mod.rel}:{line}: {desc}")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    root = pathlib.Path(args.root).resolve() if args.root else default_root()

    if args.expect_json_version is not None and (
        args.expect_json_version != JSON_SCHEMA_VERSION
    ):
        print(
            f"JSON schema version mismatch: this analyzer emits v"
            f"{JSON_SCHEMA_VERSION}, consumer expects v"
            f"{args.expect_json_version} — update the consumer "
            "(v2 added per-finding `chain` provenance)",
            file=sys.stderr,
        )
        return 2

    if args.list_rules:
        for name, (_fn, sev, doc) in sorted(all_rules().items()):
            head = doc.splitlines()[0] if doc else ""
            print(f"{name}  [{sev}]  {head}")
        return 0

    if not (root / PKG).is_dir():
        print(
            f"{root} holds no {PKG}/ to analyze; "
            "run from the repository or pass --root",
            file=sys.stderr,
        )
        return 2

    if args.effects:
        from .effects import effect_index

        idx = effect_index(Project(root, None))
        matches = idx.lookup(args.effects)
        if not matches:
            print(
                f"no function matching {args.effects!r} — use a dotted "
                "qualname (Core.open) or a key "
                f"({PKG}/core/core.py::Core.open)",
                file=sys.stderr,
            )
            return 2
        if args.json:
            print(json.dumps(
                {"version": JSON_SCHEMA_VERSION,
                 "functions": [_effects_json(idx, fi) for fi in matches]},
                indent=2, sort_keys=True,
            ))
        else:
            for fi in matches:
                _print_effects(idx, fi)
        return 0

    try:
        rules = args.rules
        if rules:
            unknown = set(rules) - set(all_rules())
            if unknown:
                print(f"unknown rule(s): {sorted(unknown)}", file=sys.stderr)
                return 2
        baseline = (
            None if args.no_baseline else Baseline.load(root / BASELINE_REL)
        )
    except ValueError as e:
        print(f"baseline error: {e}", file=sys.stderr)
        return 2

    t0 = time.monotonic()
    try:
        raw = []
        for arg in args.paths:
            p = pathlib.Path(arg).resolve()
            if p.is_dir():
                # a directory argument means "every in-scope file under
                # it" — without the expansion `crdt-analyze foo/` would
                # analyze zero files yet exit 0
                found = sorted(
                    f for f in p.rglob("*.py")
                    if Project.in_scan_scope(root, f)
                )
                if not found:
                    print(
                        f"note: {p.relative_to(root).as_posix()} "
                        "contains no in-scope files, skipped",
                        file=sys.stderr,
                    )
                raw.extend(found)
            else:
                raw.append(p)
        skipped = [p for p in raw if not Project.in_scan_scope(root, p)]
        for p in skipped:
            # everything outside the package is exempt (SCAN_GLOBS):
            # a hook feeding changed files must not get spurious errors
            print(
                f"note: {p.relative_to(root).as_posix()} is outside the "
                "analysis scope, skipped",
                file=sys.stderr,
            )
        paths = [p for p in raw if p not in skipped] if args.paths else None
        project = Project(root, paths)
    except (ValueError, OSError) as e:
        # an explicit path outside the root, or unreadable
        print(f"path error: {e}", file=sys.stderr)
        return 2
    findings = run(project, rules, baseline)
    elapsed = time.monotonic() - t0

    stale = baseline.stale_entries() if baseline is not None else []
    if rules:  # a subset run can't judge other rules' entries
        stale = [e for e in stale if e.rule in rules]
    if project.partial:  # nor can a path-subset run judge any of them
        stale = []
    errors = unsuppressed_errors(findings)
    visible = [f for f in findings if f.suppressed is None]
    suppressed = [f for f in findings if f.suppressed is not None]

    if args.json:
        out = {
            "version": JSON_SCHEMA_VERSION,
            "root": str(root),
            "elapsed_s": round(elapsed, 3),
            "rules": sorted(rules) if rules else sorted(all_rules()),
            "findings": [f.to_json() for f in findings],
            "stale_baseline": [
                {"rule": e.rule, "path": e.path, "context": e.context,
                 "reason": e.reason}
                for e in stale
            ],
            "summary": {
                "files": len(project.modules),
                "errors": len(errors),
                "warnings": len(
                    [f for f in visible if f.severity != SEV_ERROR]
                ),
                "suppressed": len(suppressed),
            },
        }
        print(json.dumps(out, indent=2, sort_keys=True))
    else:
        for f in visible:
            print(f.render())
        for e in stale:
            print(
                f"STALE baseline entry {e.rule} {e.path}"
                + (f" ({e.context})" if e.context else "")
                + f" matched nothing — delete it (reason was: {e.reason})"
            )
        n_warn = len([f for f in visible if f.severity != SEV_ERROR])
        print(
            f"{len(project.modules)} files, {len(errors)} error(s), "
            f"{n_warn} warning(s), {len(suppressed)} suppressed, "
            f"{len(stale)} stale baseline entr(y/ies) in {elapsed:.2f}s"
        )

    if errors:
        return 1
    if args.diff_baseline and stale:
        return 1
    return 0
