"""LCK001 — lock-consistency for thread-shared class state.

Two checks, both on classes/functions that hold real ``threading``
locks (asyncio locks are cooperative and excluded — awaiting under
``async with`` is normal):

* **guarded-field consistency**: an attribute *written* under
  ``with self._lock:`` somewhere in a class is part of that lock's
  protected invariant — every other access (read or write) of it in
  any method must also hold the lock.  ``__init__``/``__post_init__``
  are exempt (construction happens-before publication), as are
  accesses inside the lock's own ``with`` regions;
* **await-under-lock**: an ``await`` anywhere inside a ``with`` on a
  known threading lock parks the event loop while holding a lock
  worker threads contend on — a deadlock-by-design.  Known locks are
  class attrs (``self._lock = threading.Lock()``), module globals, and
  function locals, classified by constructor spelling.
"""

from __future__ import annotations

import ast

from ..astutil import dotted, functions, walk_in
from ..effects import effect_index, lock_ctor_kind
from ..engine import SEV_ERROR, Finding, Project, rule
from .mutation import _MUTATOR_TAILS

_EXEMPT = {"__init__", "__post_init__", "__new__", "__setstate__"}


def _with_lock_regions(fn, lock_names: set[str]):
    """With/AsyncWith nodes whose context expr is one of lock_names
    (dotted spellings, e.g. ``self._lock`` or ``_PATCH_LOCK``)."""
    for w in walk_in(fn, ast.With, ast.AsyncWith):
        for item in w.items:
            expr = item.context_expr
            # `with lock:` or `with lock.acquire_timeout(..)` styles —
            # only the bare-name/attr form is a lock region
            name = dotted(expr)
            if name in lock_names:
                yield w, name


def _under(mod, node, region) -> bool:
    cur = mod.parents.get(node)
    while cur is not None:
        if cur is region:
            return True
        cur = mod.parents.get(cur)
    return False


@rule("LCK001", SEV_ERROR)
def lock_consistency(project: Project):
    """Fields written under a class's threading lock must be accessed
    under it everywhere; never await while holding a threading lock."""
    idx = effect_index(project)
    for mod in project.modules:
        mi = idx.mods.get(mod.rel)
        if mi is None:
            continue
        module_locks = {n for n, k in mi.mod_locks.items() if k == "threading"}
        for cls in mod.walk(ast.ClassDef):
            lock_attrs = {
                a
                for a, k in mi.class_locks.get(cls.name, {}).items()
                if k == "threading"
            }
            if not lock_attrs:
                continue
            methods = [
                n
                for n in cls.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            ]
            for lock in sorted(lock_attrs):
                lname = f"self.{lock}"
                # pass 1: the lock's protected field set = attrs written
                # under any `with self.<lock>:` region
                guarded: set[str] = set()
                regions_by_method: dict[str, list] = {}
                for m in methods:
                    regions = [w for w, _ in _with_lock_regions(m, {lname})]
                    regions_by_method[m.name] = regions
                    for region in regions:
                        for a in walk_in(region, ast.Attribute):
                            if (
                                isinstance(a.ctx, (ast.Store, ast.Del))
                                and isinstance(a.value, ast.Name)
                                and a.value.id == "self"
                                and a.attr != lock
                            ):
                                guarded.add(a.attr)
                        # in-place mutation counts as a write too:
                        # `self.items.append(x)` under the lock makes
                        # `items` part of the protected invariant
                        for c in walk_in(region, ast.Call):
                            name = dotted(c.func) or ""
                            parts = name.split(".")
                            if (
                                len(parts) == 3
                                and parts[0] == "self"
                                and parts[1] != lock
                                and parts[2] in _MUTATOR_TAILS
                            ):
                                guarded.add(parts[1])
                if not guarded:
                    continue
                # pass 2: every other access of a guarded field must
                # hold the lock
                for m in methods:
                    if m.name in _EXEMPT:
                        continue
                    regions = regions_by_method.get(m.name, [])
                    reported: set[str] = set()
                    for a in walk_in(m, ast.Attribute):
                        if (
                            not isinstance(a.value, ast.Name)
                            or a.value.id != "self"
                            or a.attr not in guarded
                            or a.attr in reported
                        ):
                            continue
                        if any(_under(mod, a, r) for r in regions):
                            continue
                        reported.add(a.attr)
                        yield Finding(
                            rule="LCK001",
                            severity=SEV_ERROR,
                            path=mod.rel,
                            line=a.lineno,
                            context=f"{cls.name}.{m.name}",
                            message=(
                                f"`self.{a.attr}` is written under "
                                f"`{lname}` elsewhere but accessed here "
                                "without it — a thread-reachable path "
                                "sees torn state"
                            ),
                        )
        # await-under-lock: any function, any known threading lock
        for fn in functions(mod):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            cls_parent = mod.parents.get(fn)
            cls_lock_names = set()
            if isinstance(cls_parent, ast.ClassDef):
                cls_lock_names = {
                    f"self.{a}"
                    for a, k in mi.class_locks.get(cls_parent.name, {}).items()
                    if k == "threading"
                }
            local_locks = set()
            for n in walk_in(fn, ast.Assign):
                if isinstance(n.value, ast.Call) and lock_ctor_kind(n.value) == "threading":
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            local_locks.add(t.id)
            known = module_locks | cls_lock_names | local_locks
            if not known:
                continue
            for region, name in _with_lock_regions(fn, known):
                if isinstance(region, ast.AsyncWith):
                    continue  # async with => asyncio lock, not these
                for aw in walk_in(region, ast.Await):
                    yield Finding(
                        rule="LCK001",
                        severity=SEV_ERROR,
                        path=mod.rel,
                        line=aw.lineno,
                        context=mod.context_of(aw),
                        message=(
                            f"await while holding threading lock "
                            f"`{name}` — parks the event loop with the "
                            "lock held; worker threads deadlock on it"
                        ),
                    )
                    break
