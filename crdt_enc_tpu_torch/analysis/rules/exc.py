"""EXC001 — no silent broad except around native/crypto/CUDA fast paths.

A ``except Exception: <fall back>`` around a ``native.*`` or xchacha
fast path is how a project loses its native optimizations without
noticing (a binding regression made ``bytes_lens_join`` raise, the
broad except ate it, and every bulk decrypt silently ran the slow
Python path).  The port's kernels are the same kind of fast path: a
broad except around ``orset_fold_cuda``, ``orset_merge_many_cuda``,
``lww_fold_cuda`` or a ``cuda_build.load`` would fall back to a plain
version on the card without a word, which the port's rule — a kernel
launches or raises — forbids.  The fast-path roots are those modules
(``native``, ``xchacha``, ``cuda_build``, ``orset_fold_cuda``,
``orset_merge_cuda``, ``lww_fold_cuda``) and whatever is imported from
them, however spelled, plus any call through a library handle (``lib``,
``state_lib``, ...).  A broad handler (bare ``except``, ``Exception``,
``BaseException``) whose try body touches one must either re-raise or
call something that visibly logs (``logger.warning/...``, a ``*warn*``
helper, ``warnings.warn``).
"""

from __future__ import annotations

import ast
import re

from ..astutil import call_name, walk_in
from ..engine import SEV_ERROR, Finding, Project, rule
from .ffi import _LIB_NAMES

_BROAD = {"Exception", "BaseException"}
_LOG_ATTRS = {"warning", "error", "exception", "info", "debug", "critical"}
_WARN_NAME_RE = re.compile(r"warn", re.IGNORECASE)
#: modules whose names (and whatever is imported from them) are fast
#: paths: the native library, the AEAD backend and the CUDA kernels
_FAST_PATH_MODULES = (
    "native", "xchacha",
    "cuda_build", "orset_fold_cuda", "orset_merge_cuda", "lww_fold_cuda",
)


def _fast_path_roots(mod) -> set[str]:
    """Module-level names that are fast-path entry points: the
    ``native`` package, the xchacha backend, the CUDA build module and
    the three kernel wrappers' modules, however imported."""
    roots = set()
    for node in mod.walk(ast.Import, ast.ImportFrom):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            for alias in node.names:
                name = alias.asname or alias.name
                if alias.name in _FAST_PATH_MODULES or module.endswith(
                    _FAST_PATH_MODULES
                ):
                    roots.add(name)
        else:
            for alias in node.names:
                if alias.name.endswith(_FAST_PATH_MODULES):
                    roots.add(alias.asname or alias.name.split(".")[0])
    return roots


def _touches_fast_path(body: list[ast.stmt], roots: set[str]) -> bool:
    for stmt in body:
        for node in walk_in(stmt):
            if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name
            ):
                if node.value.id in roots:
                    return True
            if isinstance(node, ast.Call):
                cn = call_name(node) or ""
                recv = cn.rsplit(".", 1)[0] if "." in cn else ""
                if recv in roots or cn.split(".")[0] in roots:
                    return True
                # calls through a native handle are native calls (the
                # receiver spellings are FFI001's, kept in one place)
                if recv in _LIB_NAMES:
                    return True
    return False


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    for node in ([t] if not isinstance(t, ast.Tuple) else t.elts):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return any(n in _BROAD for n in names)


def _handler_is_loud(handler: ast.ExceptHandler) -> bool:
    for node in walk_in(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            cn = call_name(node) or ""
            last = cn.rsplit(".", 1)[-1]
            if last in _LOG_ATTRS:
                return True
            if _WARN_NAME_RE.search(last):
                return True
    return False


@rule("EXC001", SEV_ERROR)
def silent_native_fallback(project: Project):
    """Broad except around a native/xchacha/CUDA fast path must re-raise
    or log the fallback (one-shot helpers count)."""
    for mod in project.modules:
        roots = _fast_path_roots(mod)
        for node in mod.walk(ast.Try):
            if not _touches_fast_path(node.body, roots):
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if _handler_is_loud(handler):
                    continue
                yield Finding(
                    rule="EXC001", severity=SEV_ERROR, path=mod.rel,
                    line=handler.lineno, context=mod.context_of(handler),
                    message=(
                        "broad except swallows a native or CUDA fast-path "
                        "failure with no logged fallback — the "
                        "optimization can silently disable "
                        "(bytes_lens_join regression class); log once "
                        "(e.g. a _warn_* helper) or re-raise"
                    ),
                )
