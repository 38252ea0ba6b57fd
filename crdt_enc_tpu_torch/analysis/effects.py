"""Interprocedural effect inference over the shared :class:`Project` ASTs.

One pass builds a project-wide call graph keyed per *definition node*
(a bare name resolves to the local def that shadows it, else the
module-level def, else a project-unique global; ``m.f()`` resolves to
``f`` of the module ``m`` names, whether bound by ``import m`` or by
``from pkg import m`` — so ``cuda_build.load`` and ``native.load`` are
two functions, not one ambiguous ``load``; two or more same-named
candidates are never guessed between — the call is recorded as
*unresolved* and reported honestly, not silently dropped).
A fixpoint over that graph then propagates per-function effect sets:

``blocks``
    file/socket I/O, ``time.sleep``, ``subprocess``, native and CUDA FFI
    calls through the known lib-handle spellings (a kernel launch is
    one), ``lock.acquire()`` on a known ``threading`` lock, blocking
    ``queue.Queue`` get/put, and a host wait on the card:
    ``torch.cuda.synchronize()`` and ``.synchronize()`` on a stream or
    an event.  ``.cpu()``, ``.item()`` and ``.numpy()`` are not seeds:
    on a host tensor they are free, and ``ast`` cannot tell a host
    tensor from a device one, so seeding them would drown every host
    path in findings.
``wall_clock``
    ``time.time``/``monotonic``/``perf_counter``, ``datetime.now``.
``rng``
    module-level ``random.*``, zero-arg ``random.Random()``,
    ``uuid4``/``uuid1``, ``os.urandom``, ``secrets.*``, ``np.random.*``.
``awaits``
    the function body contains an ``await`` (not propagated: awaiting a
    coroutine is the caller's own, lexical property).
``mutates``
    stores to ``self.<attr>``/``cls.<attr>``; propagated only across
    same-instance (``self.``/``cls.``) call edges so a method inherits
    the write set of the helpers it drives on the *same* object.

Every propagated effect carries provenance: the first call edge that
introduced it, linked transitively so :meth:`EffectIndex.chain` can
print the concrete call path from any function down to the direct
origin.  Laundering seams are modelled on the edge, not the node:
``asyncio.to_thread(fn, ...)`` / ``loop.run_in_executor(ex, fn, ...)``
and the ingest producer-pool entry points drop the ``blocks`` effect
across that edge (the work happens off-loop) while still propagating
``wall_clock``/``rng`` — moving a clock read to a worker thread does
not make it deterministic.

Deliberate modelling decisions (kept honest in ``--effects`` output):

* ``with lock:`` is **not** a blocks effect — bounded critical sections
  (telemetry counters, registry guards) would otherwise poison every
  caller.  A bare ``.acquire()`` on a known threading lock *is*;
  ``await`` while holding a lock is LCK001's job.
* Unresolved calls (dynamic, or ambiguous between 2+ same-named defs)
  do **not** widen to all-effects; they are recorded per function and
  surfaced by ``--effects`` and the JSON dump so a reader can see
  exactly where the analysis is blind.
* A seed line may carry ``# lint: effect-ok=<kind>[,<kind>] (reason)``
  to sanction the *origin* — for amortized one-shot sites (the memoized
  native ``make`` build) where baselining every transitive caller would
  bury the signal.  Sanctioned origins are recorded on the function and
  shown by ``--effects``, never silently dropped.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from .astutil import call_name, dotted
from .engine import Project, ModuleInfo

KIND_BLOCKS = "blocks"
KIND_WALL = "wall_clock"
KIND_RNG = "rng"
KIND_AWAITS = "awaits"
KIND_MUTATES = "mutates"

ALL_KINDS = (KIND_BLOCKS, KIND_WALL, KIND_RNG, KIND_AWAITS, KIND_MUTATES)

#: native FFI handle spellings (mirrors rules/ffi.py's receiver set)
_LIB_NAMES = {"lib", "slib", "state_lib", "_state_lib", "_lib"}

#: full dotted-name seeds
_BLOCKS_EXACT = {
    "time.sleep": "time.sleep",
    "os.system": "os.system",
    "open": "open",
    "socket.create_connection": "socket.create_connection",
    "urllib.request.urlopen": "urllib.request.urlopen",
    "os.remove": "os file op",
    "os.rename": "os file op",
    "os.replace": "os file op",
    "os.unlink": "os file op",
    "os.makedirs": "os file op",
    "os.rmdir": "os file op",
    "os.listdir": "os file op",
    "os.scandir": "os file op",
    "os.stat": "os file op",
    "os.fsync": "os file op",
    "os.fdopen": "os file op",
}
_BLOCKS_PREFIXES = ("subprocess.", "shutil.")
#: attribute-tail seeds: pathlib I/O and the host's waits on the card
#: (``torch.cuda.synchronize``, ``stream.synchronize``,
#: ``event.synchronize``)
_BLOCKS_TAILS = {
    "synchronize": "CUDA synchronize (host waits for the card)",
    "read_text": "pathlib read",
    "write_text": "pathlib write",
    "read_bytes": "pathlib read",
    "write_bytes": "pathlib write",
}

_WALL_EXACT = {
    "time.time",
    "time.monotonic",
    "time.perf_counter",
    "time.time_ns",
    "time.monotonic_ns",
    "time.perf_counter_ns",
}
_WALL_TAILS = {
    # datetime.datetime.now / from datetime import datetime; datetime.now()
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "date.today",
}

_RNG_EXACT = {
    "os.urandom",
    "uuid.uuid4",
    "uuid.uuid1",
}
_RNG_PREFIXES = ("secrets.", "random.", "np.random.", "numpy.random.")
_RNG_TAILS = {"uuid4", "uuid1"}

#: launder seams: calls that run their callable argument off the event
#: loop.  Maps dotted-name tail -> positional index of the callable.
_LAUNDER_ARG = {"to_thread": 0, "run_in_executor": 1}
#: named seams whose *implementation* is the sanctioned producer pool —
#: blocks effects do not propagate across a call to them (the blocking
#: work runs on pool threads; the entry point itself stays loop-safe).
_LAUNDER_CALLEES = {"run_ingest_pipeline", "run_striped_ingest_pipeline"}

_LOCK_CTORS = {
    "threading.Lock": "threading",
    "threading.RLock": "threading",
    "threading.Semaphore": "threading",
    "threading.BoundedSemaphore": "threading",
    "threading.Condition": "threading",
    "asyncio.Lock": "asyncio",
    "asyncio.Semaphore": "asyncio",
    "asyncio.Condition": "asyncio",
    "queue.Queue": "queue",
    "queue.SimpleQueue": "queue",
    "queue.LifoQueue": "queue",
    "queue.PriorityQueue": "queue",
}

_MAX_UNRESOLVED = 32  # per function, keeps the dump bounded

_EFFECT_OK_RE = re.compile(r"#\s*lint:\s*effect-ok=([a-z_]+(?:\s*,\s*[a-z_]+)*)")


def _effect_ok_lines(mod: "ModuleInfo") -> dict[int, set[str]]:
    """line -> sanctioned effect kinds (``# lint: effect-ok=blocks``)."""
    out: dict[int, set[str]] = {}
    for i, line in enumerate(mod.lines, start=1):
        m = _EFFECT_OK_RE.search(line)
        if m:
            out[i] = {k.strip() for k in m.group(1).split(",")}
    return out


def lock_ctor_kind(call: ast.Call) -> str | None:
    """``"threading"`` / ``"asyncio"`` / ``"queue"`` for a known lock or
    queue constructor call, else None.  Exact dotted spellings only —
    the repo idiom is always module-qualified."""
    name = call_name(call)
    return _LOCK_CTORS.get(name) if name else None


@dataclasses.dataclass
class Prov:
    """One provenance link: where an effect entered this function."""

    rel: str
    line: int
    desc: str  # human description of this link (direct origin or call)
    via: str | None = None  # callee FuncInfo key when propagated
    laundered: bool = False  # edge crossed a to_thread-style seam


@dataclasses.dataclass
class Unresolved:
    """A call edge the resolver declined to guess at (reported, not
    silently dropped)."""

    rel: str
    line: int
    desc: str


class FuncInfo:
    """Per-definition effect record (key = ``rel::qualname``)."""

    def __init__(self, mod: ModuleInfo, node, cls_name: str | None):
        self.mod = mod
        self.node = node
        self.qualname = mod.qualname[node]
        self.key = f"{mod.rel}::{self.qualname}"
        self.name = node.name
        self.cls = cls_name
        self.is_async = isinstance(node, ast.AsyncFunctionDef)
        #: (kind, origin) -> first-won provenance
        self.effects: dict[tuple[str, str], Prov] = {}
        self.unresolved: list[Unresolved] = []
        #: (kind, line, desc) seeds waived by an effect-ok pragma
        self.sanctioned: list[tuple[str, int, str]] = []
        #: outgoing edges: (callee_key, line, self_edge, laundered)
        self.calls: list[tuple[str, int, bool, bool]] = []
        #: nested defs by bare name (for local-shadow resolution)
        self.nested: dict[str, "FuncInfo"] = {}

    def effect_kinds(self) -> set[str]:
        return {k for (k, _o) in self.effects}

    def origins(self, kind: str) -> list[str]:
        return sorted(o for (k, o) in self.effects if k == kind)


def _seed(name: str | None) -> tuple[str, str] | None:
    """(kind, origin) when the dotted call name is a direct effect seed."""
    if name is None:
        return None
    tail = name.rsplit(".", 1)[-1]
    if name in _BLOCKS_EXACT:
        return (KIND_BLOCKS, name)
    if any(name.startswith(p) for p in _BLOCKS_PREFIXES):
        return (KIND_BLOCKS, name)
    if tail in _BLOCKS_TAILS and name != tail:
        return (KIND_BLOCKS, tail)
    if name in _WALL_EXACT:
        return (KIND_WALL, name)
    if any(name.endswith(t) for t in _WALL_TAILS):
        return (KIND_WALL, name)
    if name in _RNG_EXACT or tail in _RNG_TAILS:
        return (KIND_RNG, f"{tail}" if tail in _RNG_TAILS else name)
    if any(name.startswith(p) for p in _RNG_PREFIXES):
        # random.Random(seed) is a *seeded* constructor, handled by the
        # caller (zero-arg check); everything else under random./secrets.
        return (KIND_RNG, name)
    return None


class _ModIndex:
    """Per-module name-resolution context, built once."""

    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.dotted = _module_dotted(mod.rel)
        self.pkg = self.dotted.rsplit(".", 1)[0] if "." in self.dotted else ""
        #: local alias -> ("from", src_module, src_name) | ("mod", module)
        self.imports: dict[str, tuple] = {}
        self.top_defs: dict[str, FuncInfo] = {}
        #: class name -> method name -> FuncInfo
        self.classes: dict[str, dict[str, FuncInfo]] = {}
        self.mod_locks: dict[str, str] = {}  # global name -> lock kind
        #: class name -> attr -> lock kind (self.X = threading.Lock())
        self.class_locks: dict[str, dict[str, str]] = {}

    def resolve_import_module(self, node: ast.ImportFrom) -> str:
        if node.level == 0:
            return node.module or ""
        parts = self.dotted.split(".")
        # level=1 strips the module's own name, each extra level one pkg
        base = parts[: len(parts) - node.level]
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base)


def _module_dotted(rel: str) -> str:
    p = rel[:-3] if rel.endswith(".py") else rel
    if p.endswith("/__init__"):
        p = p[: -len("/__init__")]
    return p.replace("/", ".")


class EffectIndex:
    """Project-wide call graph + per-function propagated effect sets."""

    def __init__(self, project: Project):
        self.project = project
        self.funcs: dict[str, FuncInfo] = {}
        self.mods: dict[str, _ModIndex] = {}  # rel -> index
        self.by_dotted: dict[str, _ModIndex] = {}
        self.by_name: dict[str, list[FuncInfo]] = {}
        for mod in project.modules:
            self._index_module(mod)
        for mi in self.mods.values():
            self._scan_module(mi)
        self._propagate()

    # ------------------------------------------------------ construction

    def _index_module(self, mod: ModuleInfo) -> None:
        mi = _ModIndex(mod)
        self.mods[mod.rel] = mi
        self.by_dotted[mi.dotted] = mi
        for node in mod.tree.body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    mi.imports[local] = ("mod", alias.name if alias.asname else alias.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                src = mi.resolve_import_module(node)
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    mi.imports[alias.asname or alias.name] = ("from", src, alias.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                value = node.value
                if isinstance(value, ast.Call):
                    kind = lock_ctor_kind(value)
                    if kind:
                        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                        for t in targets:
                            if isinstance(t, ast.Name):
                                mi.mod_locks[t.id] = kind
        # every def in the file, nested included, gets a FuncInfo
        for node in mod.walk(ast.FunctionDef, ast.AsyncFunctionDef):
            from .astutil import enclosing

            cls_node = enclosing(mod, node, ast.ClassDef)
            # only treat it as a method when the class is the *direct*
            # def parent (a def nested inside a method is not a method)
            direct = mod.parents.get(node)
            cls_name = cls_node.name if (cls_node is not None and direct is cls_node) else None
            fi = FuncInfo(mod, node, cls_name)
            self.funcs[fi.key] = fi
            self.by_name.setdefault(fi.name, []).append(fi)
            parent_fn = enclosing(mod, node, ast.FunctionDef, ast.AsyncFunctionDef)
            if parent_fn is not None:
                pkey = f"{mod.rel}::{mod.qualname[parent_fn]}"
                pfi = self.funcs.get(pkey)
                if pfi is not None:
                    pfi.nested[fi.name] = fi
            if cls_name is not None:
                mi.classes.setdefault(cls_name, {})[fi.name] = fi
            elif direct is mod.tree:
                mi.top_defs[fi.name] = fi
        # class lock attrs: self.X = threading.Lock() anywhere in a method
        for cls_name, methods in mi.classes.items():
            attrs: dict[str, str] = {}
            for fi in methods.values():
                for n in ast.walk(fi.node):
                    if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                        kind = lock_ctor_kind(n.value)
                        if not kind:
                            continue
                        for t in n.targets:
                            if (
                                isinstance(t, ast.Attribute)
                                and isinstance(t.value, ast.Name)
                                and t.value.id in ("self", "cls")
                            ):
                                attrs[t.attr] = kind
            if attrs:
                mi.class_locks[cls_name] = attrs

    # ---------------------------------------------------------- scanning

    def _scan_module(self, mi: _ModIndex) -> None:
        ok_lines = _effect_ok_lines(mi.mod)
        buckets = self._bucket_nodes(mi.mod.tree)
        for fi in self.funcs.values():
            if fi.mod is mi.mod:
                self._scan_func(mi, fi, ok_lines, buckets.get(fi.node, ()))

    @staticmethod
    def _bucket_nodes(tree) -> dict:
        """One DFS assigning every node to its innermost enclosing def
        (excluding nested def/class subtrees, which open their own
        buckets; lambdas stay in-line).  Replaces a per-function body
        walk — the module tree is traversed exactly once."""
        buckets: dict[ast.AST, list] = {}
        defs = (ast.FunctionDef, ast.AsyncFunctionDef)
        stack: list[tuple[ast.AST, ast.AST | None]] = [(tree, None)]
        while stack:
            node, fn = stack.pop()
            if isinstance(node, defs):
                buckets[node] = []
                for c in node.body:
                    stack.append((c, node))
                continue
            if isinstance(node, ast.ClassDef):
                for c in node.body:
                    stack.append((c, None))
                continue
            if fn is not None:
                buckets[fn].append(node)
            for c in ast.iter_child_nodes(node):
                stack.append((c, fn))
        return buckets

    def _scan_func(
        self, mi: _ModIndex, fi: FuncInfo, ok_lines: dict[int, set[str]],
        nodes,
    ) -> None:
        rel = mi.mod.rel
        local_locks: dict[str, str] = {}
        cls_locks = mi.class_locks.get(fi.cls, {}) if fi.cls else {}

        def add(kind: str, origin: str, line: int, desc: str) -> None:
            if kind in ok_lines.get(line, ()):
                fi.sanctioned.append((kind, line, desc))
                return
            fi.effects.setdefault((kind, origin), Prov(rel, line, desc))

        for n in nodes:
            if isinstance(n, ast.Await):
                add(KIND_AWAITS, "await", n.lineno, "await expression")
            elif isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Delete)):
                targets = (
                    n.targets
                    if isinstance(n, (ast.Assign, ast.Delete))
                    else [n.target]
                )
                for t in targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id in ("self", "cls")
                    ):
                        add(KIND_MUTATES, t.attr, t.lineno, f"writes self.{t.attr}")
                value = getattr(n, "value", None)
                if isinstance(value, ast.Call):
                    kind = lock_ctor_kind(value)
                    if kind:
                        for t in targets:
                            if isinstance(t, ast.Name):
                                local_locks[t.id] = kind
            if not isinstance(n, ast.Call):
                continue
            name = call_name(n)
            # launder seams: resolve the callable argument as an edge
            # that drops blocks but still carries wall_clock/rng
            tail = name.rsplit(".", 1)[-1] if name else None
            if tail in _LAUNDER_ARG:
                idx = _LAUNDER_ARG[tail]
                if len(n.args) > idx:
                    target = n.args[idx]
                    if isinstance(target, ast.Call):  # partial(fn, ...)
                        tname = call_name(target)
                        if tname and tname.rsplit(".", 1)[-1] == "partial" and target.args:
                            target = target.args[0]
                    tdot = dotted(target)
                    if tdot is not None:
                        self._resolve_edge(mi, fi, tdot, n.lineno, laundered=True)
                continue
            if name is None:
                fi.unresolved.append(
                    Unresolved(rel, n.lineno, "dynamic call (non-name callee)")
                )
                continue
            seed = _seed(name)
            if seed is None and "." not in name:
                imp = mi.imports.get(name)
                if imp is not None and imp[0] == "from" and imp[1]:
                    # canonicalise `from time import monotonic` so bare
                    # spellings hit the same seed tables
                    seed = _seed(f"{imp[1]}.{imp[2]}")
            if seed is not None:
                kind, origin = seed
                # random.Random(seed) is seeded — only the zero-arg
                # constructor draws entropy from the OS
                if origin.endswith("random.Random") and (n.args or n.keywords):
                    continue
                add(kind, origin, n.lineno, f"call to {name}")
                continue
            parts = name.split(".")
            base = ".".join(parts[:-1])
            if len(parts) >= 2 and parts[-2] in _LIB_NAMES:
                add(KIND_BLOCKS, f"ffi:{name}", n.lineno, f"native FFI call {name}()")
                continue
            if parts[-1] == "acquire" and len(parts) >= 2:
                kind = self._lock_kind_of(mi, fi, base, local_locks, cls_locks)
                if kind == "threading":
                    add(KIND_BLOCKS, f"acquire:{base}", n.lineno, f"{base}.acquire()")
                continue
            if parts[-1] in ("get", "put") and len(parts) >= 2:
                kind = self._lock_kind_of(mi, fi, base, local_locks, cls_locks)
                if kind == "queue":
                    add(
                        KIND_BLOCKS,
                        f"queue:{base}.{parts[-1]}",
                        n.lineno,
                        f"blocking {base}.{parts[-1]}()",
                    )
                    continue
            self._resolve_edge(mi, fi, name, n.lineno, laundered=False)

    def _lock_kind_of(
        self,
        mi: _ModIndex,
        fi: FuncInfo,
        base: str,
        local_locks: dict[str, str],
        cls_locks: dict[str, str],
    ) -> str | None:
        if base in local_locks:
            return local_locks[base]
        if base in mi.mod_locks:
            return mi.mod_locks[base]
        if base.startswith(("self.", "cls.")):
            attr = base.split(".", 1)[1]
            if "." not in attr and attr in cls_locks:
                return cls_locks[attr]
        return None

    # -------------------------------------------------------- resolution

    def _resolve_edge(
        self, mi: _ModIndex, fi: FuncInfo, name: str, line: int, *, laundered: bool
    ) -> None:
        rel = mi.mod.rel
        parts = name.split(".")
        if len(parts) == 1:
            n = parts[0]
            if n in _LAUNDER_CALLEES:
                laundered = True
            target = fi.nested.get(n) or mi.top_defs.get(n)
            if target is None and n in mi.imports:
                target = self._resolve_import(mi.imports[n])
                if target is None and mi.imports[n][0] == "from":
                    # imported class: constructor edge to its __init__
                    target = self._resolve_class_method(mi.imports[n], "__init__")
            if target is None and n in mi.classes:
                target = mi.classes[n].get("__init__")
            if target is None:
                cands = self.by_name.get(n, [])
                if len(cands) == 1:
                    target = cands[0]
                elif len(cands) >= 2:
                    if len(fi.unresolved) < _MAX_UNRESOLVED:
                        fi.unresolved.append(
                            Unresolved(
                                rel,
                                line,
                                f"ambiguous: {len(cands)} defs named '{n}'",
                            )
                        )
                    return
                else:
                    return  # external (builtin/stdlib): silent by design
            fi.calls.append((target.key, line, False, laundered))
            return
        # attribute call
        head, tail = parts[0], parts[-1]
        if tail in _LAUNDER_CALLEES:
            laundered = True
        if head in ("self", "cls") and len(parts) == 2 and fi.cls:
            methods = mi.classes.get(fi.cls, {})
            target = methods.get(tail)
            if target is not None:
                fi.calls.append((target.key, line, True, laundered))
                return
            # fall through: inherited / mixin method -> tail fallback
        if len(parts) == 2 and head in mi.classes:
            target = mi.classes[head].get(tail)
            if target is not None:
                fi.calls.append((target.key, line, False, laundered))
                return
        imp = mi.imports.get(head)
        if imp is not None:
            # the module the alias names: `import m` or a submodule
            # bound by `from pkg import m`
            tgt_mi = self.by_dotted.get(
                imp[1] if imp[0] == "mod" else f"{imp[1]}.{imp[2]}"
            )
            if tgt_mi is not None:
                if len(parts) == 2:
                    target = tgt_mi.top_defs.get(tail)
                    if target is not None:
                        fi.calls.append((target.key, line, False, laundered))
                        return
                elif len(parts) == 3 and parts[1] in tgt_mi.classes:
                    target = tgt_mi.classes[parts[1]].get(tail)
                    if target is not None:
                        fi.calls.append((target.key, line, False, laundered))
                        return
            elif imp[0] == "from" and len(parts) == 2:
                target = self._resolve_class_method((imp[0], imp[1], imp[2]), tail)
                if target is not None:
                    fi.calls.append((target.key, line, False, laundered))
                    return
        # bounded dynamic dispatch: a method name unique project-wide
        # resolves (keyed per definition); 2+ candidates widen
        # honestly into the unresolved list
        cands = self.by_name.get(tail, [])
        if len(cands) == 1:
            fi.calls.append((cands[0].key, line, False, laundered))
        elif len(cands) >= 2:
            if len(fi.unresolved) < _MAX_UNRESOLVED:
                fi.unresolved.append(
                    Unresolved(
                        rel,
                        line,
                        f"ambiguous: {len(cands)} defs named '{tail}' "
                        f"(call spelled {name})",
                    )
                )
        # 0 candidates: external attribute (dict.get, list.append, ...)

    def _resolve_import(self, imp: tuple) -> FuncInfo | None:
        if imp[0] != "from":
            return None
        src_mi = self.by_dotted.get(imp[1])
        if src_mi is None:
            return None
        return src_mi.top_defs.get(imp[2])

    def _resolve_class_method(self, imp: tuple, method: str) -> FuncInfo | None:
        if imp[0] != "from":
            return None
        src_mi = self.by_dotted.get(imp[1])
        if src_mi is None:
            return None
        methods = src_mi.classes.get(imp[2])
        return methods.get(method) if methods else None

    # ------------------------------------------------------- propagation

    def _propagate(self) -> None:
        callers: dict[str, list[tuple[str, int, bool, bool]]] = {}
        for fi in self.funcs.values():
            for callee_key, line, self_edge, laundered in fi.calls:
                callers.setdefault(callee_key, []).append(
                    (fi.key, line, self_edge, laundered)
                )
        work = [fi.key for fi in self.funcs.values() if fi.effects]
        while work:
            key = work.pop()
            callee = self.funcs[key]
            for caller_key, line, self_edge, laundered in callers.get(key, ()):
                caller = self.funcs[caller_key]
                changed = False
                for (kind, origin), _prov in callee.effects.items():
                    if kind == KIND_AWAITS:
                        continue
                    if kind == KIND_BLOCKS and laundered:
                        continue
                    if kind == KIND_MUTATES and not self_edge:
                        continue
                    ek = (kind, origin)
                    if ek not in caller.effects:
                        caller.effects[ek] = Prov(
                            caller.mod.rel,
                            line,
                            f"call to {callee.qualname}",
                            via=key,
                            laundered=laundered,
                        )
                        changed = True
                if changed:
                    work.append(caller_key)

    # ------------------------------------------------------------ lookup

    def func_for_node(self, mod: ModuleInfo, node) -> FuncInfo | None:
        return self.funcs.get(f"{mod.rel}::{mod.qualname[node]}")

    def lookup(self, qualname: str) -> list[FuncInfo]:
        """All functions whose key ends with ``qualname`` (so both
        ``ORSet.apply`` and ``models/orset.py::ORSet.apply`` match)."""
        exact = [fi for fi in self.funcs.values() if fi.key == qualname]
        if exact:
            return exact
        out = []
        for fi in self.funcs.values():
            if fi.qualname == qualname or fi.key.endswith(qualname):
                out.append(fi)
        return sorted(out, key=lambda f: f.key)

    def chain(self, key: str, kind: str, origin: str) -> list[str]:
        """The provenance call path for one effect, caller-first, ending
        at the direct origin line."""
        out: list[str] = []
        seen: set[str] = set()
        k: str | None = key
        while k and k not in seen:
            seen.add(k)
            fi = self.funcs.get(k)
            if fi is None:
                break
            prov = fi.effects.get((kind, origin))
            if prov is None:
                break
            if prov.via:
                seam = " [off-loop seam]" if prov.laundered else ""
                out.append(f"{prov.rel}:{prov.line} {fi.qualname} -> {prov.desc[8:]}{seam}")
                k = prov.via
            else:
                out.append(f"{prov.rel}:{prov.line} {fi.qualname}: {prov.desc}")
                k = None
        return out

    def class_threading_locks(self, mod: ModuleInfo, cls_name: str) -> dict[str, str]:
        mi = self.mods.get(mod.rel)
        if mi is None:
            return {}
        return {
            a: k
            for a, k in mi.class_locks.get(cls_name, {}).items()
            if k == "threading"
        }


def effect_index(project: Project) -> EffectIndex:
    """Build (once) and cache the effect index on the project."""
    idx = getattr(project, "_effect_index", None)
    if idx is None:
        idx = EffectIndex(project)
        project._effect_index = idx
    return idx
