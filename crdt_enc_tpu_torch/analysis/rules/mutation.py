"""MUT001 — every tracked-state write bumps the ``_mut`` epoch first.

The plane cache (``parallel/accel.py``), the warm tier
(``serve/warm.py``), and the continuation stamps all validate cached
planes with ``entry.token != state._mut`` — a state mutation that does
not bump the epoch silently revalidates stale planes.  This rule makes
the invalidation law static:

* a class is *tracked* when it declares ``_mut`` (class body or
  ``__init__``); its tracked attrs are its other declared fields;
* any method writing a tracked attr — directly (``self.entries[...] =``,
  ``self.clock = ...``), through a mutator call (``self.entries.pop()``,
  ``self.deferred.setdefault(...)``), or through a one-level local alias
  (``e = self.entries; e.add(...)``, incl. aliases obtained via
  ``self.A[...]``/``.get()``/``.setdefault()``) — must be *dominated* by
  an unconditional ``self._mut`` bump: a top-level bump statement before
  the first write on every path.  A bump that only happens on one
  branch is flagged as such;
* private helpers may rely on their callers: a writing helper is clean
  when every intra-class call site is itself bump-dominated (fixpoint
  over the intra-class call graph); public mutators must self-protect;
* ``__init__``/``__post_init__``/``__setstate__`` construct, they don't
  mutate published state — exempt.  Fresh locals built from the class
  constructor (``s = ORSet()``, ``cls()``) are exempt receivers:
  nothing can hold a stale plane for an object that didn't exist;
* module-level functions (the columnar fold/writeback paths) that write
  tracked attrs on a parameter must bump ``<recv>._mut`` in the same
  function.
"""

from __future__ import annotations

import ast

from ..astutil import dotted, functions
from ..engine import SEV_ERROR, Finding, Project, rule

#: method tails that mutate their receiver in place
_MUTATOR_TAILS = {
    "add", "append", "extend", "insert", "remove", "discard", "pop",
    "popitem", "clear", "update", "setdefault", "apply", "merge",
    "reset_remove",
}
#: calls whose result aliases INTO the receiver's contents
_ALIAS_TAILS = {"get", "setdefault"}
_EXEMPT_METHODS = {"__init__", "__post_init__", "__new__", "__setstate__"}


def _class_methods(mod, cls: ast.ClassDef):
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _declares_mut(mod, cls: ast.ClassDef) -> bool:
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if node.target.id == "_mut":
                return True
        elif isinstance(node, ast.Assign):
            if any(isinstance(t, ast.Name) and t.id == "_mut" for t in node.targets):
                return True
    for m in _class_methods(mod, cls):
        if m.name in ("__init__", "__post_init__"):
            for n in ast.walk(m):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.ctx, (ast.Store,))
                    and n.attr == "_mut"
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                ):
                    return True
    return False


def _tracked_attrs(mod, cls: ast.ClassDef) -> set[str]:
    attrs: set[str] = set()
    for node in cls.body:
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            attrs.add(node.target.id)
    for m in _class_methods(mod, cls):
        if m.name in ("__init__", "__post_init__"):
            for n in ast.walk(m):
                if (
                    isinstance(n, ast.Attribute)
                    and isinstance(n.ctx, ast.Store)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                ):
                    attrs.add(n.attr)
    attrs.discard("_mut")
    return {a for a in attrs if not a.startswith("__")}


class _Event:
    """One bump / write / helper-call inside a method, positioned by its
    top-level statement index and whether any enclosing statement can
    branch (If/For/While/Try) — With doesn't branch and doesn't count."""

    __slots__ = ("kind", "line", "index", "conditional", "detail")

    def __init__(self, kind, line, index, conditional, detail=""):
        self.kind = kind
        self.line = line
        self.index = index
        self.conditional = conditional
        self.detail = detail


def _attr_write_name(target: ast.AST, recv: str) -> str | None:
    """The attr of ``<recv>.A`` / ``<recv>.A[...]`` stores, else None."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Slice)):
        node = node.value if isinstance(node, ast.Subscript) else node
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == recv
    ):
        return node.attr
    return None


def _method_events(method, tracked: set[str], method_names: set[str]):
    """Scan one method body for bump/write/helper-call events."""
    events: list[_Event] = []
    aliases: dict[str, str] = {}  # local name -> tracked attr it aliases

    def scan(stmts, index_base, conditional):
        for i, stmt in enumerate(stmts):
            idx = index_base if index_base is not None else i
            scan_stmt(stmt, idx, conditional)

    def scan_stmt(stmt, idx, conditional):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign, ast.Delete)):
            targets = (
                stmt.targets
                if isinstance(stmt, (ast.Assign, ast.Delete))
                else [stmt.target]
            )
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                    and t.attr == "_mut"
                ):
                    events.append(_Event("bump", stmt.lineno, idx, conditional))
                    continue
                a = _attr_write_name(t, "self")
                if a in tracked:
                    events.append(
                        _Event("write", stmt.lineno, idx, conditional, f"self.{a}")
                    )
                    continue
                if isinstance(t, ast.Name) and t.id in aliases:
                    # plain rebinding of the alias name isn't a write,
                    # but subscript stores through it are
                    pass
                sub = _subscript_base_name(t)
                if sub in aliases:
                    events.append(
                        _Event(
                            "write", stmt.lineno, idx, conditional,
                            f"self.{aliases[sub]} (via alias {sub})",
                        )
                    )
            # alias creation: x = self.A / self.A[...] / self.A.get(...)
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                t0 = stmt.targets[0]
                if isinstance(t0, ast.Name):
                    a = _alias_source(stmt.value, tracked, aliases)
                    if a is not None:
                        aliases[t0.id] = a
                    elif t0.id in aliases:
                        del aliases[t0.id]
        for call in _own_calls(stmt):
            name = dotted(call.func)
            if name is None:
                continue
            parts = name.split(".")
            if parts[0] == "self" and len(parts) == 2 and parts[1] in method_names:
                events.append(
                    _Event("helper", call.lineno, idx, conditional, parts[1])
                )
            elif parts[-1] in _MUTATOR_TAILS:
                base = parts[:-1]
                if len(base) >= 2 and base[0] == "self" and base[1] in tracked:
                    events.append(
                        _Event(
                            "write", call.lineno, idx, conditional,
                            f"self.{base[1]}.{parts[-1]}()",
                        )
                    )
                elif len(base) == 1 and base[0] in aliases:
                    events.append(
                        _Event(
                            "write", call.lineno, idx, conditional,
                            f"self.{aliases[base[0]]}.{parts[-1]}() "
                            f"(via alias {base[0]})",
                        )
                    )
        for child, cond in _sub_blocks(stmt):
            scan(child, idx, conditional or cond)

    scan(method.body, None, False)
    return events


def _subscript_base_name(target: ast.AST) -> str | None:
    if isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name):
        return target.value.id
    return None


def _alias_source(value: ast.AST, tracked: set[str], aliases: dict) -> str | None:
    node = value
    if isinstance(node, ast.Call):
        name = dotted(node.func)
        if name:
            parts = name.split(".")
            if (
                len(parts) == 3
                and parts[0] == "self"
                and parts[1] in tracked
                and parts[2] in _ALIAS_TAILS
            ):
                return parts[1]
        return None
    if isinstance(node, ast.Subscript):
        node = node.value
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and node.attr in tracked
    ):
        return node.attr
    return None


def _own_calls(stmt):
    """Calls in the statement's OWN expressions — nested block bodies
    are scanned separately (with their branch flag) via _sub_blocks."""
    if isinstance(stmt, (ast.If, ast.While)):
        exprs = [stmt.test]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        exprs = [stmt.iter]
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        exprs = [i.context_expr for i in stmt.items]
    elif isinstance(stmt, ast.Try):
        exprs = []
    elif isinstance(stmt, ast.Match):
        exprs = [stmt.subject]
    else:
        exprs = [stmt]
    for e in exprs:
        for n in ast.walk(e):
            if isinstance(n, ast.Call):
                yield n


def _sub_blocks(stmt):
    """(child statement list, introduces_branch) pairs for compound
    statements."""
    if isinstance(stmt, ast.If):
        yield stmt.body, True
        yield stmt.orelse, True
    elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
        yield stmt.body, True
        yield stmt.orelse, True
    elif isinstance(stmt, ast.Try):
        yield stmt.body, True
        for h in stmt.handlers:
            yield h.body, True
        yield stmt.orelse, True
        yield stmt.finalbody, False
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        yield stmt.body, False
    elif isinstance(stmt, ast.Match):
        for case in stmt.cases:
            yield case.body, True


def _first_unconditional_bump(events) -> int | None:
    """Line of the earliest bump on the unconditional path.  Both a
    qualifying bump and any write are on straight-line segments, so
    textual order IS execution order between them."""
    lines = [e.line for e in events if e.kind == "bump" and not e.conditional]
    return min(lines) if lines else None


def _has_any_bump(events) -> bool:
    return any(e.kind == "bump" for e in events)


@rule("MUT001", SEV_ERROR)
def mut_epoch_bumped(project: Project):
    """Methods writing tracked CRDT state attrs must bump the `_mut`
    epoch unconditionally before the first write; columnar writeback
    functions must bump `<recv>._mut` for non-fresh receivers."""
    all_tracked_attrs: set[str] = set()
    tracked_class_names: set[str] = set()
    per_class: list[tuple] = []
    for mod in project.modules:
        for cls in mod.walk(ast.ClassDef):
            if not _declares_mut(mod, cls):
                continue
            tracked = _tracked_attrs(mod, cls)
            if not tracked:
                continue
            tracked_class_names.add(cls.name)
            all_tracked_attrs |= tracked
            per_class.append((mod, cls, tracked))

    for mod, cls, tracked in per_class:
        methods = list(_class_methods(mod, cls))
        method_names = {m.name for m in methods}
        events_by_method = {
            m.name: _method_events(m, tracked, method_names)
            for m in methods
            if m.name not in _EXEMPT_METHODS
        }
        # fixpoint: a method "writes" when it has a direct write or an
        # un-dominated call to a writing method
        writing: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, events in events_by_method.items():
                if name in writing:
                    continue
                bump_line = _first_unconditional_bump(events)
                for e in events:
                    is_write = e.kind == "write" or (
                        e.kind == "helper" and e.detail in writing
                    )
                    if not is_write:
                        continue
                    if bump_line is None or bump_line >= e.line:
                        writing.add(name)
                        changed = True
                        break
        for m in methods:
            if m.name in _EXEMPT_METHODS or m.name not in writing:
                continue
            if m.name.startswith("_"):
                # a private writing helper is its callers' obligation;
                # each un-dominated intra-class call site is already
                # flagged at the caller (which joined `writing`)
                callers = [
                    n
                    for n, evs in events_by_method.items()
                    if any(e.kind == "helper" and e.detail == m.name for e in evs)
                ]
                if callers:
                    continue
            events = events_by_method[m.name]
            first = next(
                (
                    e
                    for e in events
                    if e.kind == "write"
                    or (e.kind == "helper" and e.detail in writing)
                ),
                None,
            )
            if first is None:
                continue
            if _has_any_bump(events):
                how = (
                    "bumps `_mut` on one branch only / after the write — "
                    "the bump must dominate every write"
                )
            else:
                how = "never bumps `_mut`"
            yield Finding(
                rule="MUT001",
                severity=SEV_ERROR,
                path=mod.rel,
                line=first.line,
                context=f"{cls.name}.{m.name}",
                message=(
                    f"writes tracked state ({first.detail or 'tracked attr'}) "
                    f"but {how}; stale planes in the warm tier / plane "
                    "cache would revalidate"
                ),
            )

    if not all_tracked_attrs:
        return
    # module-level writeback paths: <recv>.<tracked attr> stores need a
    # <recv>._mut bump in the same function unless <recv> is fresh
    for mod in project.modules:
        for fn in functions(mod):
            cls_parent = mod.parents.get(fn)
            if isinstance(cls_parent, ast.ClassDef):
                continue  # methods handled (or untracked classes exempt)
            fresh: set[str] = set()
            bumped: set[str] = set()
            writes: list[tuple[str, str, int]] = []
            for n in ast.walk(fn):
                if isinstance(n, ast.Assign):
                    if (
                        len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and isinstance(n.value, ast.Call)
                    ):
                        cname = dotted(n.value.func) or ""
                        tail = cname.rsplit(".", 1)[-1]
                        if tail in tracked_class_names or cname == "cls":
                            fresh.add(n.targets[0].id)
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                    for t in targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id not in ("self", "cls")
                        ):
                            if t.attr == "_mut":
                                bumped.add(t.value.id)
                            elif t.attr in all_tracked_attrs:
                                writes.append((t.value.id, t.attr, t.lineno))
            for recv, attr, line in writes:
                if recv in fresh or recv in bumped:
                    continue
                yield Finding(
                    rule="MUT001",
                    severity=SEV_ERROR,
                    path=mod.rel,
                    line=line,
                    context=mod.context_of(fn),
                    message=(
                        f"writeback to `{recv}.{attr}` without bumping "
                        f"`{recv}._mut` — the warm tier / plane cache "
                        "key on the epoch and would serve stale planes"
                    ),
                )
