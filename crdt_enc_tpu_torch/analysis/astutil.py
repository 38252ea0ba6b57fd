"""Small shared AST helpers for the analysis rules."""

from __future__ import annotations

import ast
from typing import Iterator


def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted(call.func)


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def func_params(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def walk_in(node: ast.AST, *types) -> Iterator[ast.AST]:
    for n in ast.walk(node):
        if not types or isinstance(n, types):
            yield n


def enclosing(
    mod, node: ast.AST, *types
) -> ast.AST | None:
    """Nearest ancestor of ``node`` (via the module parent map) of the
    given types."""
    cur = mod.parents.get(node)
    while cur is not None:
        if isinstance(cur, types):
            return cur
        cur = mod.parents.get(cur)
    return None


def functions(mod) -> Iterator[ast.FunctionDef | ast.AsyncFunctionDef]:
    yield from mod.walk(ast.FunctionDef, ast.AsyncFunctionDef)


def assigned_names(target: ast.AST) -> Iterator[str]:
    """Plain names bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_names(elt)
