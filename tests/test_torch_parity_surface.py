"""The port's public surface against the JAX package's, parsed with ``ast``
(nothing is imported).

Two claims make "the port does what the JAX package does" checkable:

* every ``CRDT_*`` environment variable the JAX package names (a string
  constant ``"CRDT_..."`` in its code) is named in the port's code too;
* every public module-level function, class and constant of a JAX module,
  every public method and dataclass field of its public classes, has a
  counterpart of the same name in the port module of the same relative
  path, and each counterpart function takes at least the JAX parameters.

The exceptions are :data:`ALLOWLIST` (what the port leaves out) and
:data:`COUNTERPARTS` (what it names differently), one line each: the
JAX ``file:line``, the symbol, and the reason.  Every entry must still be
needed and must point at its JAX definition, and ROADMAP.md's "Left out"
paragraph names every left-out symbol.
"""

from __future__ import annotations

import ast
import functools
import pathlib
import re

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "crdt_enc_tpu"
PORT = ROOT / "crdt_enc_tpu_torch"

# (JAX file:line, symbol, reason).  A symbol is a module path, a name, a
# ``Class.member``, ``name(param)``, or ``env:CRDT_...``.
ALLOWLIST = [
    ("ops/pallas_fold.py:1", "ops/pallas_fold.py", "Pallas kernel K1/K2: the port's is CUDA (csrc/orset_fold.cu, ops/orset_fold_cuda.py)"),
    ("ops/pallas_lww.py:1", "ops/pallas_lww.py", "Pallas kernel K5: the port's is CUDA (csrc/lww_fold.cu, ops/lww_fold_cuda.py)"),
    ("ops/pallas_merge.py:1", "ops/pallas_merge.py", "Pallas kernels K3/K4: the port's are CUDA (csrc/orset_merge.cu, ops/orset_merge_cuda.py)"),
    ("analysis/rules/jit.py:1", "analysis/rules/jit.py", "lints jax.jit call sites; the port has no jax.jit to lint"),
    ("__init__.py:36", "enable_compilation_cache", "XLA's persistent compilation cache; eager PyTorch compiles nothing per shape"),
    ("__init__.py:52", "env:CRDT_ENC_TPU_COMPILE_CACHE", "the directory of enable_compilation_cache"),
    ("parallel/accel.py:114", "env:CRDT_JIT_CACHE", "turns on enable_compilation_cache"),
    ("parallel/accel.py:98", "env:CRDT_BUCKET_VOCAB", "bucket_vocab's switch"),
    ("parallel/accel.py:76", "TpuAccelerator.__init__(bucket_vocab)", "vocabulary padding that bounds XLA recompiles; nothing recompiles per shape here"),
    ("parallel/accel.py:76", "TpuAccelerator.__init__(map_fold_impl)", "picks the XLA or numpy map scatter; the port's map fold follows min_device_batch"),
    ("sim/population.py:61", "PopulationSubstrate.__init__(bucket_vocab)", "passed through to bucket_vocab"),
    ("obs/runtime.py:68", "track_recompiles", "counts XLA backend compiles (jax_compiles); nothing compiles per shape here"),
    ("obs/runtime.py:83", "ensure_recompile_tracking", "XLA recompile tracking"),
    ("obs/runtime.py:108", "recompile_count", "XLA recompile tracking"),
    ("ops/map_columnar.py:206", "crdtmap_fold_host(fold_impl)", "map_fold_impl's switch"),
    ("ops/map_device.py:36", "crdtmap_scatter_phase(num_keys)", "a jit static argument; the port reads the sizes off its tensors"),
    ("ops/map_device.py:36", "crdtmap_scatter_phase(num_pairs)", "a jit static argument"),
    ("ops/map_device.py:36", "crdtmap_scatter_phase(num_replicas)", "a jit static argument"),
    ("ops/map_device.py:36", "crdtmap_scatter_phase(axis_name)", "a shard_map axis; the port's mesh combines shards itself"),
    ("ops/lww.py:109", "lww_fold_into(impl)", "picks an XLA or Pallas route; the port has one CUDA kernel"),
    ("ops/lww.py:109", "lww_fold_into(tile_cap)", "a Pallas tile size"),
    ("ops/lww.py:109", "lww_fold_into(interpret)", "Pallas interpret mode; CPU tensors take the plain version"),
    ("ops/lww.py:109", "lww_fold_into(limbs)", "the x64-off limb split of timestamps; the port folds int64"),
    ("ops/orset.py:42", "orset_fold(sort_segments)", "an XLA sort-or-scatter choice"),
    ("ops/orset.py:42", "orset_fold(impl)", "picks an XLA or Pallas route; the port has one CUDA kernel"),
    ("ops/orset.py:42", "orset_fold(small_counters)", "an XLA int16 narrowing"),
    ("ops/orset.py:328", "orset_plane_diff_tenants", "vmap twin of orset_plane_diff; the port's orset_plane_diff takes the tenant axis itself"),
    ("ops/orset.py:339", "orset_plane_diff_rows", "one tenant's gather at a static size; the port's is orset_plane_diff_rows_tenants"),
    ("ops/orset.py:407", "orset_merge_many(impl)", "picks an XLA or Pallas route; the port has one CUDA kernel"),
    ("ops/counters.py:17", "sum_wide", "the x64-off advisory sum; the port sums int64"),
    ("ops/counters.py:34", "SORTED_MIN_ROWS", "an XLA sort-or-scatter threshold"),
    ("ops/stream.py:309", "orset_fold_stream(impl)", "picks an XLA or Pallas route"),
    ("ops/stream.py:309", "orset_fold_stream(small_counters)", "an XLA int16 narrowing"),
    ("ops/stream.py:309", "orset_fold_stream(tile_cap)", "a Pallas tile size"),
    ("ops/stream.py:309", "orset_fold_stream(h2d_lookahead)", "XLA's donated-buffer lookahead; the port overlaps uploads on a side stream"),
    ("parallel/mesh.py:175", "orset_fold_sharded(tile_cap)", "a Pallas tile size"),
    ("parallel/mesh.py:175", "orset_fold_sharded(interpret)", "Pallas interpret mode"),
    ("parallel/mesh.py:261", "sharded_fold_cap", "the Pallas tile cap of a shard"),
    ("parallel/mesh.py:339", "sharded_stream_fold_step(impl)", "picks an XLA or Pallas route"),
    ("parallel/mesh.py:339", "sharded_stream_fold_step(tile_cap)", "a Pallas tile size"),
    ("parallel/mesh.py:339", "sharded_stream_fold_step(interpret)", "Pallas interpret mode"),
    ("parallel/mesh.py:574", "tenant_fold_steps", "jit-compiled shard_map steps; the port's service folds each shard's bucket directly"),
    ("parallel/mesh.py:598", "tenant_diff_step", "a jit-compiled shard_map step"),
    ("parallel/session.py:67", "FORCE_PALLAS_STREAM", "forces the Pallas stream route"),
]

# (JAX file:line, JAX symbol, the port's name, reason)
COUNTERPARTS = [
    ("parallel/accel.py:64", "TpuAccelerator", "TorchAccelerator", "the accelerator on the card"),
    ("analysis/rules/obs.py:61", "device_put_accounted", "upload_accounted", "OBS001 checks torch uploads, not jax.device_put"),
]

_ENV = re.compile(r"CRDT_[A-Z0-9_]+\Z")


def _params(fn) -> tuple[list[str], bool]:
    a = fn.args
    names = [x.arg for x in (*a.posonlyargs, *a.args, *a.kwonlyargs)]
    return [n for n in names if n not in ("self", "cls")], a.kwarg is not None


def _is_dataclass(cls: ast.ClassDef) -> bool:
    for d in cls.decorator_list:
        t = d.func if isinstance(d, ast.Call) else d
        if getattr(t, "attr", getattr(t, "id", "")) == "dataclass":
            return True
    return False


def _public(name: str) -> bool:
    return not name.startswith("_")


def _members(cls: ast.ClassDef) -> dict:
    out = {}
    for b in cls.body:
        if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(b.name) or b.name == "__init__":
                out[b.name] = ("def", b.lineno, _params(b))
        elif (isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name)
              and _is_dataclass(cls) and _public(b.target.id)):
            out[b.target.id] = ("field", b.lineno, None)
    return out


def surface(path: pathlib.Path) -> dict:
    """name -> (kind, line, detail) for a module's top level: ``def``
    (params), ``class`` (members), ``const`` (an UPPER_CASE assignment),
    ``name`` (any other binding, imports included)."""
    out: dict = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = ("def", node.lineno, _params(node))
        elif isinstance(node, ast.ClassDef):
            out[node.name] = ("class", node.lineno, _members(node))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    kind = "const" if t.id.isupper() else "name"
                    out.setdefault(t.id, (kind, node.lineno, None))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                name = (alias.asname or alias.name).split(".")[0]
                out.setdefault(name, ("name", node.lineno, None))
    return out


@functools.lru_cache(maxsize=None)
def env_names(root: pathlib.Path) -> dict:
    """``CRDT_*`` string constants in code (docstrings excluded) ->
    (file, line) of the first one."""
    found: dict = {}
    for path in sorted(root.rglob("*.py")):
        tree = ast.parse(path.read_text())
        docs = {
            id(n.value) for n in ast.walk(tree)
            if isinstance(n, ast.Expr) and isinstance(n.value, ast.Constant)
        }
        for n in ast.walk(tree):
            if (isinstance(n, ast.Constant) and isinstance(n.value, str)
                    and _ENV.match(n.value) and id(n) not in docs):
                found.setdefault(
                    n.value, (str(path.relative_to(root)), n.lineno))
    return found


@functools.lru_cache(maxsize=None)
def module_gaps(rel: str) -> list[tuple[str, int]]:
    """(symbol, JAX line) the port's module lacks, before the lists."""
    jpath, ppath = JAX / rel, PORT / rel
    if not ppath.exists():
        return [(rel, 1)]
    theirs, ours = surface(jpath), surface(ppath)
    renamed = {j: p for _, j, p, _ in COUNTERPARTS}
    gaps = []
    for name, (kind, line, detail) in theirs.items():
        if kind == "name" or not _public(name):
            continue
        mine = ours.get(renamed.get(name, name))
        if mine is None:
            gaps.append((name, line))
            continue
        mkind, _, mdetail = mine
        if kind == "def" and mkind == "def":
            have, star = mdetail
            gaps += [(f"{name}({p})", line) for p in detail[0]
                     if p not in have and not star]
        elif kind == "class":
            if mkind != "class":
                gaps.append((name, line))
                continue
            for m, (k, mline, mdet) in detail.items():
                other = mdetail.get(m)
                if other is None or (k == "field") != (other[0] == "field"):
                    gaps.append((f"{name}.{m}", mline))
                elif k == "def":
                    have, star = other[2]
                    gaps += [(f"{name}.{m}({p})", mline) for p in mdet[0]
                             if p not in have and not star]
    return gaps


JAX_MODULES = sorted(
    str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
)
JAX_ENV = env_names(JAX)
ALLOWED = {sym: (where, why) for where, sym, why in ALLOWLIST}


def test_the_lists_have_one_line_per_entry_with_a_reason():
    syms = [sym for _, sym, _ in ALLOWLIST]
    assert len(syms) == len(set(syms))
    for where, sym, why in ALLOWLIST:
        assert re.fullmatch(r"[\w/]+\.py:\d+", where), where
        assert why.strip(), sym
    for where, jsym, psym, why in COUNTERPARTS:
        assert re.fullmatch(r"[\w/]+\.py:\d+", where), where
        assert why.strip() and psym != jsym


@pytest.mark.parametrize("name", sorted(JAX_ENV))
def test_every_jax_environment_variable_is_read_by_the_port(name):
    if f"env:{name}" in ALLOWED:
        return
    port = env_names(PORT)
    assert name in port, (
        f"{name} ({JAX_ENV[name][0]}:{JAX_ENV[name][1]}) is read by the "
        "JAX package and by nothing in the port")


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_jax_symbol_has_a_port_counterpart(rel):
    missing = [
        f"{rel}:{line} {sym}" for sym, line in module_gaps(rel)
        if sym not in ALLOWED and rel not in ALLOWED
    ]
    assert not missing, "the port lacks: " + ", ".join(missing)


def test_every_allowlist_entry_is_needed_and_points_at_the_jax_code():
    gaps = {}
    for rel in JAX_MODULES:
        for sym, line in module_gaps(rel):
            gaps[(rel, sym)] = line
    for where, sym, _ in ALLOWLIST:
        rel, line = where.rsplit(":", 1)
        line = int(line)
        if sym.startswith("env:"):
            name = sym[4:]
            assert JAX_ENV.get(name) == (rel, line), (sym, JAX_ENV.get(name))
            assert name not in env_names(PORT), f"{sym} is read by the port now"
        elif sym == rel:
            assert (rel, rel) in gaps and line == 1, f"{rel} has a twin now"
        else:
            assert gaps.get((rel, sym)) == line, (
                f"{where} {sym}: no such gap (the port has it now, or the "
                "line is wrong)")
    for where, jsym, psym, _ in COUNTERPARTS:
        rel, line = where.rsplit(":", 1)
        kind, jline, _ = surface(JAX / rel)[jsym]
        assert jline == int(line)
        assert psym in surface(PORT / rel), psym
        assert jsym not in surface(PORT / rel), f"{jsym} exists in the port"


def test_roadmap_left_out_names_every_allowlisted_symbol():
    text = (ROOT / "ROADMAP.md").read_text()
    start = text.index("**Left out of those copies on purpose.**")
    left_out = text[start:text.index("\n### ", start)]
    for _, sym, _ in ALLOWLIST:
        base = sym.removeprefix("env:")
        base = re.split(r"[.(]", base.rsplit("/", 1)[-1])[0]
        if sym.endswith(")"):
            base = sym[sym.index("(") + 1:-1]
        if sym.endswith(".py"):
            base = sym.rsplit("/", 1)[-1]
        assert base in left_out, f"ROADMAP's Left out does not name {base}"
