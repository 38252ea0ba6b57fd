"""FFI001 — every ctypes foreign call fully declared, checked, and bounded.

The invariant this encodes was bought with real bugs (an unbounded
``bytes_lens_join`` out-buffer): a ctypes call with no
``argtypes``/``restype`` declaration silently marshals through default
int conversions, an unchecked status return hides partial native fills,
and an out-buffer with no capacity argument is an overflow waiting for a
larger batch.  Concretely:

* every foreign function bound anywhere in the tree must declare BOTH
  ``argtypes`` and ``restype`` (a partial binding is worse than none —
  it looks audited);
* a declaration whose ``argtypes`` include raw pointer types must also
  carry at least one integer scalar (the capacity/length channel);
  fixed-width primitives (e.g. ``hchacha20``'s 32/16-byte blocks) are
  deliberate exceptions and live in the baseline with that reason;
* a call site invoking a bound function with an integer ``restype``
  must not discard the result (an expression statement) — that status
  is the only overflow/race signal the native side has;
* a call through a native library handle (a local assigned from
  ``native.load()`` / ``native.load_state()``) to a name with no
  declaration anywhere in the tree is an undeclared foreign call.
"""

from __future__ import annotations

import ast

from ..astutil import assigned_names, call_name, dotted, enclosing, walk_in
from ..engine import SEV_ERROR, Finding, Project, rule

_INT_CTYPES = {
    "c_int", "c_uint", "c_long", "c_ulong", "c_int32", "c_uint32",
    "c_int64", "c_uint64", "c_size_t", "c_ssize_t", "c_longlong",
    "c_ulonglong",
}
# receiver spellings that are a native library handle even without a
# visible `= native.load()` assignment in the same function
_LIB_NAMES = {"lib", "slib", "state_lib", "_state_lib", "_lib"}


class _Decl:
    __slots__ = ("argtypes", "restype", "argtypes_line", "restype_line", "rel")

    def __init__(self):
        self.argtypes = None
        self.restype = "<unset>"
        self.argtypes_line = 0
        self.restype_line = 0
        self.rel = ""


def _pointer_aliases(mod) -> set[str]:
    """Local/module names bound to ``ctypes.POINTER(...)`` (u8p, i32p...)."""
    out = set()
    for node in mod.walk(ast.Assign):
        if (
            isinstance(node.value, ast.Call)
            and call_name(node.value) in ("ctypes.POINTER", "POINTER")
        ):
            for t in node.targets:
                out.update(assigned_names(t))
    return out


def _classify_argtype(node: ast.AST, ptr_aliases: set[str]) -> str:
    """'ptr' | 'int' | 'other' for one element of an argtypes list."""
    name = dotted(node)
    if name is not None:
        base = name.rsplit(".", 1)[-1]
        if name in ptr_aliases or base in ptr_aliases:
            return "ptr"
        if base in _INT_CTYPES:
            return "int"
        return "other"  # py_object, c_char_p, c_void_p, ...
    if isinstance(node, ast.Call) and call_name(node) in (
        "ctypes.POINTER", "POINTER"
    ):
        return "ptr"
    return "other"


def _is_int_restype(expr) -> bool:
    if not isinstance(expr, ast.AST):
        return False
    name = dotted(expr)
    return name is not None and name.rsplit(".", 1)[-1] in _INT_CTYPES


def _record(decls: dict[str, _Decl], name: str, attr: str, node, mod):
    d = decls.setdefault(name, _Decl())
    d.rel = d.rel or mod.rel
    if attr == "argtypes":
        d.argtypes = node.value
        d.argtypes_line = node.lineno
    else:
        d.restype = node.value
        d.restype_line = node.lineno


def _loop_const_names(loop: ast.For) -> list[str]:
    """String constants iterated by ``for name in ("a", "b"):``."""
    if isinstance(loop.iter, (ast.Tuple, ast.List)):
        return [
            e.value
            for e in loop.iter.elts
            if isinstance(e, ast.Constant) and isinstance(e.value, str)
        ]
    return []


def _collect_declarations(project: Project) -> dict[str, _Decl]:
    decls: dict[str, _Decl] = {}
    for mod in project.modules:
        for node in mod.walk(ast.Assign):
            for target in node.targets:
                if not (
                    isinstance(target, ast.Attribute)
                    and target.attr in ("argtypes", "restype")
                ):
                    continue
                recv = target.value
                # direct form: lib.NAME.argtypes = [...]
                if isinstance(recv, ast.Attribute):
                    _record(decls, recv.attr, target.attr, node, mod)
                    continue
                # loop form: for name in ("a","b"): fn = getattr(lib, name);
                #            fn.argtypes = [...]
                if isinstance(recv, ast.Name):
                    loop = enclosing(mod, node, ast.For)
                    if loop is None:
                        continue
                    bound = False
                    for a in walk_in(loop, ast.Assign):
                        if (
                            isinstance(a.value, ast.Call)
                            and call_name(a.value) == "getattr"
                            and any(
                                n == recv.id for t in a.targets
                                for n in assigned_names(t)
                            )
                        ):
                            bound = True
                    if bound:
                        for cname in _loop_const_names(loop):
                            _record(decls, cname, target.attr, node, mod)
    return decls


def _lib_locals(fn_node) -> set[str]:
    """Names assigned from native.load()/load_state() within a function."""
    out = set(_LIB_NAMES)
    for a in walk_in(fn_node, ast.Assign):
        if isinstance(a.value, ast.Call):
            cn = call_name(a.value) or ""
            if cn.endswith(("native.load", "native.load_state")) or cn in (
                "load", "load_state"
            ):
                for t in a.targets:
                    out.update(assigned_names(t))
    return out


@rule("FFI001", SEV_ERROR)
def ffi_contract(project: Project):
    """ctypes bindings: argtypes+restype declared in pairs, pointer args
    carry a capacity channel, int status returns are consumed, and no
    call through a native handle hits an undeclared name."""
    decls = _collect_declarations(project)

    for name, d in sorted(decls.items()):
        if d.argtypes is None or d.restype == "<unset>":
            missing = "restype" if d.restype == "<unset>" else "argtypes"
            line = d.argtypes_line or d.restype_line
            yield Finding(
                rule="FFI001", severity=SEV_ERROR, path=d.rel, line=line,
                message=(
                    f"foreign function `{name}` declares "
                    f"{'argtypes' if missing == 'restype' else 'restype'} "
                    f"but not {missing} — partial bindings marshal through "
                    "default int conversion"
                ),
            )
            continue
        mod = project.module(d.rel)
        ptr_aliases = _pointer_aliases(mod) if mod else set()
        if isinstance(d.argtypes, (ast.List, ast.Tuple)):
            kinds = [
                _classify_argtype(e, ptr_aliases) for e in d.argtypes.elts
            ]
            if "ptr" in kinds and "int" not in kinds:
                ctx = mod.context_of(d.argtypes) if mod else "<module>"
                yield Finding(
                    rule="FFI001", severity=SEV_ERROR, path=d.rel,
                    line=d.argtypes_line, context=ctx,
                    message=(
                        f"foreign function `{name}` takes pointer arguments "
                        "but no integer capacity/length argument — an "
                        "out-buffer pass with no bound (bytes_lens_join bug "
                        "class)"
                    ),
                )

    # call-site checks
    for mod in project.modules:
        lib_locals_cache: dict[ast.AST, set[str]] = {}
        for call in mod.walk(ast.Call):
            func = call.func
            if not (
                isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
            ):
                continue
            recv, fname = func.value.id, func.attr
            fn_node = enclosing(mod, call, ast.FunctionDef, ast.AsyncFunctionDef)
            if fn_node is not None and fn_node not in lib_locals_cache:
                lib_locals_cache[fn_node] = _lib_locals(fn_node)
            handles = lib_locals_cache.get(fn_node, _LIB_NAMES)
            if recv not in handles:
                continue
            ctx = mod.context_of(call)
            if fname not in decls:
                if fname in ("argtypes", "restype"):
                    continue
                if project.partial:
                    # declarations are cross-file (native/load.py binds
                    # what ops/ calls); a path-subset run can't judge
                    # them — same contract as the stale-span skip
                    continue
                yield Finding(
                    rule="FFI001", severity=SEV_ERROR, path=mod.rel,
                    line=call.lineno, context=ctx,
                    message=(
                        f"call `{recv}.{fname}(...)` has no argtypes/restype "
                        "declaration anywhere in the tree — undeclared "
                        "foreign call"
                    ),
                )
                continue
            d = decls[fname]
            if _is_int_restype(d.restype):
                parent = mod.parents.get(call)
                if isinstance(parent, ast.Expr):
                    yield Finding(
                        rule="FFI001", severity=SEV_ERROR, path=mod.rel,
                        line=call.lineno, context=ctx,
                        message=(
                            f"`{recv}.{fname}(...)` returns an integer "
                            "status but the result is discarded — overflow/"
                            "race signals vanish"
                        ),
                    )
