"""SEC001 — no key material in spans, logs, or exception messages.

The paper's whole premise is that the storage/observability boundary
never sees plaintext or key bytes; one ``logger.warning("bad key %r",
key)`` undoes it.  The rule taints names whose tokens say they hold
secrets (``key``, ``passphrase``, ``plaintext``, ``secret``, ...),
propagates taint through straight-line assignments within a function,
and flags tainted values reaching an observability/log/exception sink:
``trace.span/add/gauge/observe`` args (incl. ``meta=``), ``logger.*``
and ``warnings.warn`` args, ``print``, and the arguments of a raised
exception.

Public *facts about* secrets are fine and excluded: ``len(key)``,
``type(key)``, ``key.key_id`` and other identifier-ish attributes, and
any name whose tokens include a public-fact marker (``id``,
``version``, ``len``, ``path``, ...) — ``key_id``/``key_path`` name
metadata, not material.  ``x.hex()`` on a tainted value is NOT exempt:
hex-encoding a key is still the key.
"""

from __future__ import annotations

import ast

from ..astutil import call_name, functions, walk_in
from ..engine import PKG_PREFIX, SEV_ERROR, Finding, Project, rule
from .exc import _LOG_ATTRS
from .spans import _is_obs_call

_SECRET_TOKENS = {
    "key", "keys", "passphrase", "password", "secret", "plaintext",
    "material", "privkey", "seckey",
}
#: a name containing any of these tokens is metadata about a secret,
#: not the secret itself (key_id, key_version, key_path, keylen...)
_PUBLIC_TOKENS = {
    "id", "ids", "version", "versions", "len", "length", "count", "num",
    "n", "name", "names", "path", "paths", "file", "files", "dir",
    "fmt", "type", "kind", "error", "err", "exc", "meta", "index", "idx",
    "ring", "cls", "backend", "cryptor", "store", "storage", "manager",
    "registry", "cache", "hash", "digest", "fingerprint", "public", "pub",
    "size", "sizes", "offset", "offsets",
}
_PUBLIC_ATTRS = {
    "key_id", "id", "version", "key_version", "name", "kind", "hex_id",
    # facts about an array, not its contents
    "shape", "ndim", "dtype", "size", "nbytes", "itemsize",
}
_SAFE_WRAPPERS = {"len", "type", "bool", "sorted", "list", "set"}
#: calls whose result is still the secret (taint flows through);
#: everything else blocks propagation — a status code or row count
#: computed FROM a key is not the key
_IDENTITY_CALLS = {
    "bytes", "bytearray", "memoryview", "hex", "frombuffer", "asarray",
    "ascontiguousarray", "in_ptr", "data_as", "tobytes", "decode",
    "encode", "join", "derive", "copy",
}

# sink identification is shared with EXC001 (_LOG_ATTRS) and SPN001
# (_KINDS/_RECEIVERS) — one definition per sink family


def _is_secret_name(name: str) -> bool:
    tokens = set(name.lower().strip("_").split("_"))
    if not tokens & _SECRET_TOKENS:
        return False
    return not tokens & _PUBLIC_TOKENS


def _names_in(expr: ast.AST):
    for n in walk_in(expr, ast.Name):
        if isinstance(n.ctx, ast.Load):
            yield n


def _tainted_refs(mod, expr: ast.AST, tainted: set[str]):
    """Tainted Name nodes in ``expr`` that are not behind a public-fact
    wrapper (len/type/...) or a public attribute."""
    for name in _names_in(expr):
        if name.id not in tainted:
            continue
        allowed = False
        cur, parent = name, mod.parents.get(name)
        while parent is not None and cur is not expr:
            if isinstance(parent, ast.Attribute) and parent.attr in _PUBLIC_ATTRS:
                allowed = True
                break
            if isinstance(parent, ast.Call):
                cn = (call_name(parent) or "").rsplit(".", 1)[-1]
                if cn in _SAFE_WRAPPERS and cur in parent.args:
                    allowed = True
                    break
            cur, parent = parent, mod.parents.get(parent)
        if not allowed:
            yield name


def _blocks_propagation(mod, name: ast.Name, rhs: ast.AST) -> bool:
    """Taint does NOT flow out of a call unless the call is
    identity-ish (``bytes(key)`` is still the key; ``decrypt(key, b)``'s
    status/count is not)."""
    cur, parent = name, mod.parents.get(name)
    while parent is not None and cur is not rhs:
        if isinstance(parent, ast.Call):
            cn = (call_name(parent) or "").rsplit(".", 1)[-1]
            # a method ON the tainted value (key.hex()) keeps taint
            on_tainted = (
                isinstance(parent.func, ast.Attribute)
                and parent.func.value is cur
            )
            if cn not in _IDENTITY_CALLS and not on_tainted:
                return True
        cur, parent = parent, mod.parents.get(parent)
    return False


def _target_names(target: ast.AST):
    if isinstance(target, ast.Name):
        yield target
    elif isinstance(target, ast.Starred):
        yield from _target_names(target.value)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from _target_names(e)


def _bindings(fn):
    """(target Name nodes, bound expr or None) for EVERY binding form —
    plain/annotated/augmented assignment, for targets, with-as, walrus,
    and comprehension targets all bind names a secret can arrive
    through, not just ``ast.Assign``."""
    for a in walk_in(fn, ast.Assign):
        names = [n for t in a.targets for n in _target_names(t)]
        yield names, a.value
    for a in walk_in(fn, ast.AnnAssign, ast.AugAssign):
        yield list(_target_names(a.target)), a.value
    for loop in walk_in(fn, ast.For, ast.AsyncFor):
        yield list(_target_names(loop.target)), loop.iter
    for w in walk_in(fn, ast.With, ast.AsyncWith):
        for item in w.items:
            if item.optional_vars is not None:
                yield (
                    list(_target_names(item.optional_vars)),
                    item.context_expr,
                )
    for comp in walk_in(fn, ast.comprehension):
        yield list(_target_names(comp.target)), comp.iter
    for ne in walk_in(fn, ast.NamedExpr):
        yield list(_target_names(ne.target)), ne.value


def _function_taint(mod, fn) -> set[str]:
    from ..astutil import func_params

    tainted = {p for p in func_params(fn) if _is_secret_name(p)}
    bindings = list(_bindings(fn))
    # secret-named binding targets are sources by convention
    # (`key = storage.load_key(...)`) — naming IS the project contract
    for names, _ in bindings:
        for n in names:
            if _is_secret_name(n.id):
                tainted.add(n.id)
    changed = True
    while changed:  # fixpoint: chains may taint against source order
        changed = False
        for names, value in bindings:
            if value is None:
                continue
            rhs_tainted = any(
                not _blocks_propagation(mod, n, value)
                for n in _tainted_refs(mod, value, tainted)
            )
            if not rhs_tainted:
                continue
            for n in names:
                if n.id not in tainted:
                    tainted.add(n.id)
                    changed = True
    return tainted


def _sink_exprs(mod, fn):
    """Yield (kind, line, context_node, [exprs]) for every sink in fn."""
    for node in walk_in(fn, ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if _is_obs_call(func):
                exprs = list(node.args) + [kw.value for kw in node.keywords]
                yield "trace meta", node, exprs
                continue
            if func.attr in _LOG_ATTRS:
                yield "log call", node, list(node.args) + [
                    kw.value for kw in node.keywords if kw.arg != "exc_info"
                ]
                continue
        cn = call_name(node) or ""
        if cn in ("warnings.warn", "print"):
            yield "log call", node, list(node.args)
    for node in walk_in(fn, ast.Raise):
        if isinstance(node.exc, ast.Call):
            yield "exception message", node, list(node.exc.args) + [
                kw.value for kw in node.exc.keywords
            ]


@rule("SEC001", SEV_ERROR)
def no_secrets_in_telemetry(project: Project):
    """Key material / plaintext must not reach spans, logs, or exception
    messages."""
    for mod in project.modules:
        # the boundary this rule guards is the LIBRARY's: test code
        # and the smoke script seed and print what they like
        if not mod.rel.startswith(PKG_PREFIX):
            continue
        for fn in functions(mod):
            tainted = _function_taint(mod, fn)
            if not tainted:
                continue
            for kind, node, exprs in _sink_exprs(mod, fn):
                hits: list[str] = []
                for expr in exprs:
                    hits.extend(
                        n.id for n in _tainted_refs(mod, expr, tainted)
                    )
                if hits:
                    uniq = ", ".join(sorted(set(hits)))
                    yield Finding(
                        rule="SEC001", severity=SEV_ERROR, path=mod.rel,
                        line=node.lineno, context=mod.context_of(node),
                        message=(
                            f"secret-tainted value(s) `{uniq}` reach a "
                            f"{kind} — key material must never cross the "
                            "observability/log boundary (lengths and "
                            "key_ids are fine)"
                        ),
                    )
