"""The port's static-analysis engine (crdt_enc_tpu_torch/analysis/).

The JAX package's tests/test_static_analysis.py case for case, on fixtures
laid out as the port's tree (``crdt_enc_tpu_torch/...``): per-rule
positive (seeded violation caught) and negative (compliant code passes)
fixtures, the pragma/baseline suppression round-trips, the ``--json``
schema golden, the CLI's exit codes and path contract.  Where a JAX rule
is written against JAX the case becomes its twin's: OBS001 reads the
torch uploads (``.to(<device>)``, ``.cuda()``, ``torch.tensor(...,
device=)``, ``copy_`` from host data), and the JIT001/JIT002 cases show
that the twin has no such rule (the port has no ``jax.jit``).

Then what is the twin's own: a parity test per shared rule (one fixture
tree under ``crdt_enc_tpu/`` for the JAX engine and under
``crdt_enc_tpu_torch/`` for the twin, the same findings and chains), the
OBS001 pair (``jax.device_put`` against ``.to(device)``), firing tests on
copies of live port files, the live tree clean under its baseline, and
the CLI run with ``jax`` and ``crdt_enc_tpu`` blocked from import.

Fixtures are parsed, never executed.  The live tree is parsed once per
module (the ``live`` fixture).
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import textwrap
import time

import pytest

from crdt_enc_tpu.analysis import Project as JProject
from crdt_enc_tpu.analysis import run as jrun
from crdt_enc_tpu_torch.analysis import (
    Baseline,
    Project,
    all_rules,
    run,
    unsuppressed_errors,
)
from crdt_enc_tpu_torch.analysis.baseline import parse_toml
from crdt_enc_tpu_torch.analysis.cli import BASELINE_REL
from crdt_enc_tpu_torch.analysis.cli import main as cli_main
from crdt_enc_tpu_torch.analysis.rules.spans import DOC_REL

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "crdt_enc_tpu_torch"

REGISTRY_DOC = textwrap.dedent(
    """\
    # registry fixture

    ## Span registry

    | name | where |
    |---|---|
    | `phase.x` | fixture |
    | `stream.h2d` | fixture |

    ## Counter & gauge registry

    | name | where |
    |---|---|
    | `h2d_bytes` | fixture |
    | `events_dropped` | obs-internal |
    """
)
#: a registry with no stream.* proof row, for fixtures that emit nothing
QUIET_REGISTRY = "## Span registry\n\n| `events_dropped` | internal |\n"


def write(root: pathlib.Path, rel: str, src: str) -> pathlib.Path:
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return path


def analyze(tmp_path, src, rules, *, rel=f"{PKG}/fixture.py",
            registry=True, baseline_text=None):
    """Write a one-file fixture project and run the selected rules."""
    write(tmp_path, rel, src)
    if registry:
        write(tmp_path, DOC_REL, REGISTRY_DOC)
    baseline = None
    if baseline_text is not None:
        baseline = Baseline.load(write(tmp_path, BASELINE_REL, baseline_text))
    # scan (not explicit paths): fixtures must exercise the FULL run
    # semantics, including project-global checks a partial run skips
    return run(Project(tmp_path), rules, baseline), baseline


def errors_of(findings):
    return unsuppressed_errors(findings)


# ------------------------------------------------------------------ FFI001


def test_ffi_partial_binding_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        def _bind(lib):
            lib.half_bound.argtypes = [u8p, ctypes.c_uint64]
        """,
        ["FFI001"],
    )
    msgs = [f.message for f in errors_of(findings)]
    assert any("half_bound" in m and "not restype" in m for m in msgs)


def test_ffi_pointer_without_capacity_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        def _bind(lib):
            lib.unbounded_fill.argtypes = [u8p, u8p]
            lib.unbounded_fill.restype = None
        """,
        ["FFI001"],
    )
    assert any(
        "capacity" in f.message and "unbounded_fill" in f.message
        for f in errors_of(findings)
    )


def test_ffi_discarded_status_and_undeclared_call_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import ctypes
        from . import native
        u8p = ctypes.POINTER(ctypes.c_uint8)
        def _bind(lib):
            lib.checked_fn.argtypes = [u8p, ctypes.c_uint64]
            lib.checked_fn.restype = ctypes.c_int64
        def use():
            lib = native.load()
            lib.checked_fn(None, 0)      # status discarded
            lib.never_declared(None)     # undeclared foreign call
        """,
        ["FFI001"],
    )
    msgs = [f.message for f in errors_of(findings)]
    assert any("discarded" in m for m in msgs)
    assert any("never_declared" in m and "undeclared" in m for m in msgs)


def test_ffi_clean_binding_passes(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import ctypes
        from . import native
        u8p = ctypes.POINTER(ctypes.c_uint8)
        def _bind(lib):
            lib.good_fn.argtypes = [u8p, ctypes.c_uint64]
            lib.good_fn.restype = ctypes.c_int64
        def use():
            lib = native.load()
            rc = lib.good_fn(None, 0)
            if rc != 0:
                raise RuntimeError("native failure")
        """,
        ["FFI001"],
    )
    assert errors_of(findings) == []


def test_ffi_loop_getattr_binding_resolved(tmp_path):
    # the _bind loop form: for name in (...): fn = getattr(lib, name)
    findings, _ = analyze(
        tmp_path,
        """
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)
        def _bind(lib):
            for name in ("enc_a", "enc_b"):
                fn = getattr(lib, name)
                fn.argtypes = [u8p, ctypes.c_uint64]
                fn.restype = None
        """,
        ["FFI001"],
    )
    assert errors_of(findings) == []


# --------------------------------------------------------- JIT001 / JIT002
#
# The JAX package's twelve jit cases.  The port has no jax.jit and eager
# PyTorch compiles nothing per shape, so the twin registers neither rule:
# each case still trips (or passes) the JAX engine as its own test says,
# and gives the twin nothing to report and no rule to select.

JIT_CASES = {
    "traced_branch": (1, {"a.py": """
        import jax
        @jax.jit
        def f(x, y):
            if x > 0:
                return y
            return -y
        """}),
    "static_and_shape_branches": (0, {"a.py": """
        import jax
        from functools import partial
        @partial(jax.jit, static_argnames=("mode",))
        def f(x, mode, y=None):
            if mode == "fast":
                x = x * 2
            if y is None:
                y = x
            if x.shape[0] > 8:
                y = y + 1
            if len(x) > 4:
                y = y - 1
            while y.ndim > 2:
                y = y.sum(0)
            return x + y
        """}),
    "static_value_derived": (1, {"a.py": """
        import jax
        from functools import partial
        @partial(jax.jit, static_argnames=("num_values",))
        def fold(col, num_values):
            return col
        def caller(col):
            return fold(col, num_values=int(col.max()) + 1)
        """}),
    "direct_call_decorator_form": (2, {"a.py": """
        import jax
        @jax.jit(static_argnums=(1,))
        def fold(col, n):
            if col > 0:
                return col
            return -col
        def caller(col):
            return fold(col, int(col.max()))
        """}),
    "static_quantized_and_literal": (0, {"a.py": """
        import jax
        from functools import partial

        def _bucket(n, floor=8):
            return max(floor, 1 << (n - 1).bit_length())

        @partial(jax.jit, static_argnames=("num_members", "num_replicas"))
        def fold(col, num_members, num_replicas):
            return col

        def caller(col, R):
            E = _bucket(len(col))
            fold(col, E, num_replicas=R)
            return fold(col, 128, num_replicas=col.shape[1])
        """}),
    "static_forwarded_through_wrapper": (1, {"a.py": """
        import jax
        from functools import partial

        def _bucket(n, floor=8):
            return max(floor, 1 << (n - 1).bit_length())

        @partial(jax.jit, static_argnames=("cap",))
        def fold(col, cap):
            return col

        def helper(col, n):
            return fold(col, cap=n)

        def bad(col):
            return helper(col, int(col.max()))

        def good(col):
            return helper(col, _bucket(len(col)))
        """}),
    "static_instance_attr_provenance": (1, {"a.py": """
        import jax
        from functools import partial

        def _bucket(n, floor=8):
            return max(floor, 1 << (n - 1).bit_length())

        @partial(jax.jit, static_argnames=("cap",))
        def fold(col, cap):
            return col

        class Bad:
            def __init__(self, col):
                self.raw_max = int(col.max())
            def go(self, col):
                return fold(col, cap=self.raw_max)

        class Good:
            def __init__(self, col, mp):
                self.cap = _bucket(len(col))
                self.cap = -(-self.cap // mp) * mp
                self.lim = 128
            def go(self, col):
                return fold(col, cap=self.cap) + fold(col, cap=self.lim)
        """}),
    "cross_module_name_collision": (0, {
        "a.py": """
            import jax
            from functools import partial
            @partial(jax.jit, static_argnames=("n",))
            def fold(col, n):
                return col
            """,
        "b.py": """
            def fold(items, label):
                return [label + i for i in items]
            def use(data, tag):
                return fold(data, tag.upper())
            """}),
    "same_named_wrappers_keep_own_param_orders": (1, {
        "a.py": """
            import jax
            from functools import partial
            @partial(jax.jit, static_argnames=("cap",))
            def jfold(col, cap):
                return col
            def fold(x, cap):
                return jfold(x, cap=cap)
            def use_a(col):
                return fold(col, 64)
            """,
        "b.py": """
            import jax
            from functools import partial
            @partial(jax.jit, static_argnames=("n",))
            def jfold2(col, n):
                return col
            def fold(a, b, c):
                return jfold2(a, n=c)
            def benign(col):
                return fold(col, int(col.max()), 8)
            def guilty(col):
                return fold(col, 1, int(col.max()))
            """}),
    "same_named_jitted_defs_resolve_locally": (1, {
        "a.py": """
            import jax
            from functools import partial
            @partial(jax.jit, static_argnames=("n",))
            def fold(col, n):
                return col
            def use_a(col):
                return fold(col, int(col.max()))
            """,
        "b.py": """
            import jax
            from functools import partial
            @partial(jax.jit, static_argnames=("mode",))
            def fold(data, mode):
                return data
            """,
        "c.py": """
            def use_c(col):
                return fold(col, int(col.max()))
            """}),
    "static_self_referential_local_rebind": (0, {"a.py": """
        import jax
        from functools import partial

        def _bucket(n, floor=8):
            return max(floor, 1 << (n - 1).bit_length())

        @partial(jax.jit, static_argnames=("cap",))
        def fold(col, cap):
            return col

        def caller(col, mp):
            E = _bucket(len(col))
            E = -(-E // mp) * mp
            return fold(col, cap=E)
        """}),
    "star_unpacked_positions_not_guessed": (1, {"a.py": """
        import jax
        from functools import partial
        @partial(jax.jit, static_argnames=("n",))
        def fold(a, n):
            return a
        def caller(col, planes):
            fold(*planes, int(col.max()))
            return fold(*planes, n=int(col.max()))
        """}),
}


@pytest.mark.parametrize("case", sorted(JIT_CASES))
def test_jit_case_has_no_twin_rule(tmp_path, case):
    n_jax, files = JIT_CASES[case]
    jroot, root = tmp_path / "jax", tmp_path / "port"
    write(jroot, "docs/observability.md", QUIET_REGISTRY)
    write(root, DOC_REL, QUIET_REGISTRY)
    for name, src in files.items():
        write(jroot, f"crdt_enc_tpu/{name}", src)
        write(root, f"{PKG}/{name}", src)
    jerrs = errors_of(jrun(JProject(jroot), ["JIT001", "JIT002"], None))
    assert len(jerrs) == n_jax
    assert not {"JIT001", "JIT002"} & set(all_rules())
    assert run(Project(root), None, None) == []
    with pytest.raises(KeyError):
        run(Project(root), ["JIT002"], None)


# ------------------------------------------------------------------ EXC001


def test_exc_silent_native_fallback_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        from .. import native
        def fast(buf):
            try:
                lib = native.load()
                return lib.decode(buf)
            except Exception:
                return None
        """,
        ["EXC001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1 and "silently disable" in errs[0].message


def test_exc_logged_or_reraising_fallback_passes(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import logging
        from .. import native
        logger = logging.getLogger(__name__)

        def _warn_no_native(e):
            logger.warning("native unavailable: %r", e)

        def fast(buf):
            try:
                lib = native.load()
                return lib.decode(buf)
            except Exception as e:
                _warn_no_native(e)
                return None

        def strict(buf):
            try:
                return native.load().decode(buf)
            except Exception as e:
                raise RuntimeError("decode failed") from e

        def unrelated(buf):
            try:
                return int(buf)
            except Exception:
                return None   # no native fast path in the try body
        """,
        ["EXC001"],
    )
    assert errors_of(findings) == []


@pytest.mark.parametrize("spelling", [
    "from .ops.orset_fold_cuda import orset_fold_cuda as fold\n"
    "def go(*a):\n    try:\n        return fold(*a)\n",
    "from .ops import orset_merge_cuda\n"
    "def go(*a):\n    try:\n        return orset_merge_cuda.orset_merge_many_cuda(*a)\n",
    "from .ops.lww_fold_cuda import lww_fold_cuda\n"
    "def go(*a):\n    try:\n        return lww_fold_cuda(*a)\n",
    "from .ops import cuda_build\n"
    "def go(*a):\n    try:\n        return cuda_build.load('orset_fold')\n",
    "def go(lib, *a):\n    try:\n        return lib.orset_fold_launch(*a)\n",
])
def test_exc_cuda_fast_paths_are_roots(tmp_path, spelling):
    """A broad except around a kernel wrapper, the build module or a
    call through a library handle is a silent fallback from the card."""
    src = spelling + "    except Exception:\n        return None\n"
    findings, _ = analyze(tmp_path, src, ["EXC001"])
    assert len(errors_of(findings)) == 1
    loud = src.replace("        return None\n", "        raise\n")
    findings, _ = analyze(tmp_path, loud, ["EXC001"])
    assert errors_of(findings) == []


# ------------------------------------------------------------------ THR001


def test_thread_discipline_caught_and_baseline_pinned(tmp_path):
    src = """
        import threading
        def spawn():
            t1 = threading.Thread(target=print)
            t2 = threading.Thread(target=print)
            return t1, t2
    """
    findings, _ = analyze(tmp_path, src, ["THR001"])
    assert len(errors_of(findings)) == 2

    # a max=1 baseline pin absorbs ONE site; the second still surfaces
    findings, baseline = analyze(
        tmp_path, src, ["THR001"],
        baseline_text=f"""
        [[suppress]]
        rule = "THR001"
        path = "{PKG}/fixture.py"
        context = "spawn"
        reason = "fixture: one sanctioned site"
        max = 1
        """,
    )
    assert len(errors_of(findings)) == 1
    assert baseline.stale_entries() == []


def test_thread_from_import_alias_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        from threading import Thread
        def spawn():
            return Thread(target=print)
        """,
        ["THR001"],
    )
    assert len(errors_of(findings)) == 1


def test_thread_module_alias_caught(tmp_path):
    """`import threading as thr; thr.Thread(...)` must not bypass the
    discipline."""
    findings, _ = analyze(
        tmp_path,
        """
        import threading as thr
        def spawn():
            return thr.Thread(target=print)
        """,
        ["THR001"],
    )
    assert len(errors_of(findings)) == 1


def test_thread_pools_and_locks_are_not_bare_threads(tmp_path):
    """An executor, a lock or a thread-local is no bare Thread."""
    findings, _ = analyze(
        tmp_path,
        """
        import threading
        from concurrent.futures import ThreadPoolExecutor
        _LOCK = threading.Lock()
        _LOCAL = threading.local()
        def fan_out(fn, items):
            with ThreadPoolExecutor(4) as pool:
                return list(pool.map(fn, items))
        """,
        ["THR001"],
    )
    assert findings == []


# ------------------------------------------------------------------ SPN001


def test_span_unregistered_name_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        from .utils import trace
        def work():
            with trace.span("phase.x"):
                trace.add("not.in.registry", 1)
            with trace.span("stream.h2d"):
                trace.add("h2d_bytes", 1)
        """,
        ["SPN001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1 and "not.in.registry" in errs[0].message


def test_span_stale_stream_proof_is_error(tmp_path):
    # registry registers stream.h2d but the fixture never emits it
    findings, _ = analyze(
        tmp_path,
        """
        from .utils import trace
        def work():
            trace.add("h2d_bytes", 4)
            with trace.span("phase.x"):
                pass
        """,
        ["SPN001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1
    assert "stream.h2d" in errs[0].message and errs[0].path == DOC_REL


def test_span_fstring_name_is_warning_not_error(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        from .utils import trace
        def work(k):
            trace.add("h2d_bytes", 1)
            with trace.span("phase.x"):
                trace.add(f"chunk.{k}", 1)
            with trace.span("stream.h2d"):
                pass
        """,
        ["SPN001"],
    )
    assert errors_of(findings) == []
    warns = [f for f in findings if f.severity == "warning"]
    assert any("f-string" in f.message for f in warns)


def test_span_qualified_receiver_spelling_matched(tmp_path):
    """The qualified spelling `obs.record.add(...)` hits the same matcher
    as `trace.add(...)`."""
    findings, _ = analyze(
        tmp_path,
        """
        from . import obs
        def work():
            obs.record.add("not.in.registry", 1)
            obs.record.add("h2d_bytes", 1)
            with obs.record.span("phase.x"):
                pass
            with obs.record.span("stream.h2d"):
                pass
        """,
        ["SPN001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1 and "not.in.registry" in errs[0].message


def test_span_registry_is_the_ports_own_file(tmp_path):
    """The twin reads crdt_enc_tpu_torch/analysis/observability.md: a
    registry under docs/ (the JAX package's) does not count."""
    write(tmp_path, "docs/observability.md", REGISTRY_DOC)
    findings, _ = analyze(
        tmp_path,
        "from .utils import trace\ntrace.add('h2d_bytes', 1)\n",
        ["SPN001"], registry=False,
    )
    (f,) = errors_of(findings)
    assert f.path == DOC_REL and "missing" in f.message


# ------------------------------------------------------------------ OBS001


def test_obs_unaccounted_upload_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import torch
        def upload(x, device):
            return torch.from_numpy(x).to(device)
        """,
        ["OBS001"],
    )
    assert len(errors_of(findings)) == 1


def test_obs_accounted_upload_passes(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import torch
        from .utils import trace
        def upload(x, device):
            trace.add("h2d_bytes", x.nbytes)
            return torch.from_numpy(x).to(device)
        """,
        ["OBS001"],
    )
    assert errors_of(findings) == []


def test_obs_other_upload_spellings_need_accounting_too(tmp_path):
    """``.cuda()``, a constructor with a device, ``copy_`` from host data
    and ``.to(device=...)`` of a parameter are uploads as well."""
    findings, _ = analyze(
        tmp_path,
        """
        import numpy as np
        import torch
        def a(x):
            return x.cuda()
        def b(xs, dev):
            return torch.tensor(xs, dtype=torch.int64, device=dev)
        def c(dst, arr):
            dst.copy_(torch.from_numpy(arr), non_blocking=True)
        def d(x, dev):
            return x.to(device=dev, dtype=torch.int64)
        def e(n):
            h = np.zeros(n)
            return torch.from_numpy(h).to("cuda:0")
        """,
        ["OBS001"],
    )
    assert [f.context for f in errors_of(findings)] == ["a", "b", "c", "d", "e"]


def test_obs_module_level_upload_needs_module_level_accounting(tmp_path):
    """Accounting inside an unrelated function must not excuse a
    module-level transfer; module-level accounting does."""
    findings, _ = analyze(
        tmp_path,
        """
        import numpy as np
        import torch
        from .utils import trace
        _ZERO = torch.from_numpy(np.zeros(4)).to("cuda")
        def unrelated():
            trace.add("h2d_bytes", 0)
        """,
        ["OBS001"],
    )
    assert len(errors_of(findings)) == 1

    findings, _ = analyze(
        tmp_path,
        """
        import numpy as np
        import torch
        from .utils import trace
        trace.add("h2d_bytes", 32)
        _ZERO = torch.from_numpy(np.zeros(4)).to("cuda")
        """,
        ["OBS001"],
    )
    assert errors_of(findings) == []


def test_obs_unaccounted_as_tensor_with_device_caught(tmp_path):
    """``torch.as_tensor(x, device=dev)`` on host data IS an upload; a
    ``np.asarray`` or a ``torch.as_tensor`` with no device never leaves
    the host and must not be flagged."""
    findings, _ = analyze(
        tmp_path,
        """
        import numpy as np
        import torch
        def to_device(x, dev):
            return torch.as_tensor(x, device=dev)
        def host_only(x):
            return np.asarray(x), torch.as_tensor(x), torch.tensor(x, device="cpu")
        """,
        ["OBS001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1 and errs[0].context == "to_device"


def test_obs_dtype_moves_and_device_allocations_exempt(tmp_path):
    """A ``.to(dtype)``, a ``.to("cpu")`` download and an allocation on the
    device move no host data to the card."""
    findings, _ = analyze(
        tmp_path,
        """
        import torch
        def kernel_side(x, like, dev):
            a = x.to(torch.int32)
            b = x.to(dtype=torch.int64)
            c = x.to(like.dtype)
            d = x.to("cpu", torch.int32)
            e = torch.zeros(8, dtype=torch.int32, device=dev)
            f = torch.arange(8, device=dev)
            return a, b, c, d, e, f
        """,
        ["OBS001"],
    )
    assert errors_of(findings) == []


def test_obs_closure_accounts_in_its_own_body(tmp_path):
    """A closure that uploads is its own function: the enclosing
    function's accounting does not cover it (the innermost def holds the
    upload), and a closure's dtype move is no upload at all."""
    findings, _ = analyze(
        tmp_path,
        """
        import numpy as np
        import torch
        from .utils import trace
        def outer(xs, dev):
            trace.add("h2d_bytes", sum(x.nbytes for x in xs))
            def up(x):
                return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            def cast(t):
                return t.to(torch.int64)
            return [cast(up(x)) for x in xs]
        def counted(xs, dev):
            def up(x):
                trace.add("h2d_bytes", x.nbytes)
                return torch.from_numpy(x).to(dev)
            return [up(x) for x in xs]
        """,
        ["OBS001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1 and errs[0].context == "outer.up"


def test_obs_scope_excludes_tests(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import torch
        def upload(x, device):
            return torch.from_numpy(x).to(device)
        """,
        ["OBS001"],
        rel="tests/fixture.py",
    )
    assert errors_of(findings) == []


# ------------------------------------------------------------------ SEC001


def test_sec_key_in_log_and_exception_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import logging
        logger = logging.getLogger(__name__)
        def unwrap(key, blob):
            logger.warning("unwrap failed for key %r", key)
            material = bytes(key)
            raise ValueError(f"bad key material: {material}")
        """,
        ["SEC001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 2
    assert any("log call" in f.message for f in errs)
    assert any("exception message" in f.message for f in errs)


def test_sec_public_facts_about_secrets_pass(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import logging
        logger = logging.getLogger(__name__)
        def unwrap(key, blob):
            if len(key) != 32:
                raise ValueError(f"invalid key length {len(key)}")
            logger.info("unwrapping with key_id %s", key.key_id)
            rc = decrypt(key, blob)          # status code: taint blocked
            logger.debug("decrypt rc=%d", rc)
            return rc
        """,
        ["SEC001"],
    )
    assert errors_of(findings) == []


def test_sec_taint_in_trace_meta_caught(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        from .utils import trace
        def seal(passphrase, data):
            with trace.span("phase.x", meta=passphrase):
                return data
        """,
        ["SEC001"],
    )
    assert len(errors_of(findings)) == 1


def test_sec_nonassign_binding_forms_are_sources(tmp_path):
    """Secrets bound via for targets, annotated assignment, or with-as
    must taint like a plain assignment."""
    findings, _ = analyze(
        tmp_path,
        """
        import logging
        logger = logging.getLogger(__name__)
        def rotate(ring, lockbox, storage):
            for key in ring:
                logger.warning("rotating %r", key)
            passphrase: bytes = storage.load()
            logger.warning("loaded %r", passphrase)
            with lockbox.open() as key_material:
                logger.warning("opened %r", key_material)
        """,
        ["SEC001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 3
    hit = " ".join(f.message for f in errs)
    assert "key" in hit and "passphrase" in hit and "key_material" in hit


def test_sec_loop_carried_taint_reaches_fixpoint(tmp_path):
    """A taint chain assembled against source order still converges; a
    value derived through a non-identity call stays clean."""
    findings, _ = analyze(
        tmp_path,
        """
        import logging
        logger = logging.getLogger(__name__)
        def drain(key_material, chunks):
            out = b""
            for c in chunks:
                out = buf
                buf = bytes(key_material)
            logger.warning("drained %r", out)
            rc = checksum(key_material)
            logger.debug("checksum rc=%d", rc)
        """,
        ["SEC001"],
    )
    errs = errors_of(findings)
    assert len(errs) == 1
    assert "`out`" in errs[0].message and "log call" in errs[0].message


# ----------------------------------------------------- pragma suppression


def test_pragma_same_line_and_line_above_roundtrip(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import threading
        def spawn():
            t = threading.Thread(target=print)  # lint: disable=THR001
            # lint: disable=THR001
            u = threading.Thread(target=print)
            return t, u
        """,
        ["THR001"],
    )
    assert errors_of(findings) == []
    assert [f.suppressed for f in findings] == ["pragma", "pragma"]


def test_pragma_wrong_rule_does_not_suppress(tmp_path):
    findings, _ = analyze(
        tmp_path,
        """
        import threading
        def spawn():
            return threading.Thread(target=print)  # lint: disable=OBS001
        """,
        ["THR001"],
    )
    assert len(errors_of(findings)) == 1


# ----------------------------------------------------------- baseline file


def test_baseline_contains_and_stale_detection(tmp_path):
    src = """
        import threading
        def spawn():
            return threading.Thread(target=print)
    """
    findings, baseline = analyze(
        tmp_path, src, ["THR001"],
        baseline_text=f"""
        [[suppress]]
        rule = "THR001"
        path = "{PKG}/fixture.py"
        contains = "bare threading.Thread"
        reason = "fixture"

        [[suppress]]
        rule = "THR001"
        path = "{PKG}/gone.py"
        reason = "this file no longer exists"
        """,
    )
    assert errors_of(findings) == []
    stale = baseline.stale_entries()
    assert len(stale) == 1 and stale[0].path == f"{PKG}/gone.py"


def test_baseline_toml_subset_rejects_garbage():
    with pytest.raises(ValueError):
        parse_toml("[[suppress]]\nrule = [1, 2]\n")
    with pytest.raises(ValueError):
        parse_toml("[badtable]\n")
    entries = parse_toml(
        '# comment\n[[suppress]]\nrule = "X"\nmax = 2\n'
    )
    assert entries == [{"rule": "X", "max": 2}]


def test_baseline_hash_inside_quoted_reason_survives():
    entries = parse_toml(
        '[[suppress]]\nrule = "X"\nreason = "see ticket #5"  # trailing\n'
    )
    assert entries == [{"rule": "X", "reason": "see ticket #5"}]


def test_baseline_unknown_key_rejected(tmp_path):
    """A typo'd narrowing key (`contain` for `contains`) must error, not
    silently widen the suppression to the whole file."""
    bp = tmp_path / "b.toml"
    bp.write_text(
        '[[suppress]]\nrule = "X"\npath = "a.py"\nreason = "r"\n'
        'contain = "oops"\n'
    )
    with pytest.raises(ValueError, match="unknown key"):
        Baseline.load(bp)


# ------------------------------------------------------------- CLI surface


def test_cli_json_schema_golden(tmp_path, capsys):
    write(tmp_path, f"{PKG}/mod.py",
          "import threading\n"
          "def spawn():\n"
          "    return threading.Thread(target=print)\n")
    write(tmp_path, DOC_REL, REGISTRY_DOC)
    rc = cli_main(["--json", "--rule", "THR001", "--root", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert set(out) == {
        "version", "root", "elapsed_s", "rules", "findings",
        "stale_baseline", "summary",
    }
    assert out["version"] == 2 and out["rules"] == ["THR001"]
    (finding,) = out["findings"]
    assert set(finding) == {
        "rule", "severity", "path", "line", "message", "context",
        "suppressed", "chain",
    }
    assert finding["rule"] == "THR001" and finding["suppressed"] is None
    assert set(out["summary"]) == {
        "files", "errors", "warnings", "suppressed",
    }


def test_cli_unknown_rule_is_usage_error(capsys):
    assert cli_main(["--rule", "NOPE999", "--root", str(REPO)]) == 2


def test_cli_path_subset_skips_project_global_checks(capsys):
    """A single-file run must not report stream.* proof spans as
    unemitted or unrelated baseline entries as stale."""
    rc = cli_main(
        ["--diff-baseline", "--root", str(REPO),
         str(REPO / PKG / "utils" / "codec.py")]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "STALE" not in out and "stream." not in out


def test_cli_path_subset_skips_cross_file_ffi_declarations(capsys):
    """ops/native_decode.py calls native handles whose declarations live
    in native/__init__.py — a path-subset run that cannot see them must
    not report undeclared foreign calls."""
    rc = cli_main(
        ["--root", str(REPO), str(REPO / PKG / "ops" / "native_decode.py")]
    )
    out = capsys.readouterr().out
    assert rc == 0
    assert "undeclared foreign call" not in out


def test_cli_out_of_scope_paths_skipped_not_linted(capsys):
    """Explicit paths under exempt trees (tests/ seeds violations on
    purpose, and chip_smoke.py drives the package) are skipped with a
    note."""
    rc = cli_main(
        ["--root", str(REPO), str(REPO / "tests" / "test_obs.py"),
         str(REPO / "chip_smoke.py")]
    )
    captured = capsys.readouterr()
    assert rc == 0
    assert "outside the analysis scope" in captured.err
    assert "0 error(s)" in captured.out

    # mixed list: the in-scope file is still analyzed
    rc = cli_main(
        ["--root", str(REPO),
         str(REPO / "tests" / "test_obs.py"),
         str(REPO / PKG / "utils" / "codec.py")]
    )
    captured = capsys.readouterr()
    assert rc == 0
    assert "1 files" in captured.out


def test_cli_directory_arg_expands_to_in_scope_files(tmp_path, capsys):
    """A directory argument means every in-scope file under it."""
    write(tmp_path, f"{PKG}/ops/bad.py", """
        import threading
        def f():
            threading.Thread(target=print).start()
        """)
    rc = cli_main(
        ["--root", str(tmp_path), "--no-baseline", "--rule", "THR001",
         str(tmp_path / PKG)]
    )
    captured = capsys.readouterr()
    assert rc == 1
    assert "THR001" in captured.out and "1 files" in captured.out
    assert "outside the analysis scope" not in captured.err

    # a directory wholly outside the scan scope still skips with a note
    write(tmp_path, "tests/test_x.py", "x = 1\n")
    rc = cli_main(
        ["--root", str(tmp_path), "--no-baseline", "--rule", "THR001",
         str(tmp_path / "tests")]
    )
    captured = capsys.readouterr()
    assert rc == 0
    assert "contains no in-scope files" in captured.err
    assert "0 files" in captured.out


def test_engine_non_utf8_file_degrades_to_finding(tmp_path):
    """One undecodable file becomes an ENG000 finding; every other file
    is still analyzed."""
    write(tmp_path, DOC_REL, REGISTRY_DOC)
    write(tmp_path, f"{PKG}/ok.py", "x = 1\n")
    (tmp_path / PKG / "bad.py").write_bytes(b"# caf\xe9\nx = 1\n")
    project = Project(tmp_path)
    findings = run(project, ["THR001"], None)
    eng = [f for f in findings if f.rule == "ENG000"]
    assert len(eng) == 1 and "UTF-8" in eng[0].message
    assert any(m.rel == f"{PKG}/ok.py" for m in project.modules)


def test_cli_bad_paths_are_usage_errors(tmp_path, capsys):
    assert cli_main(["--root", str(REPO), "/tmp/does-not-exist-xyz.py"]) == 2
    outside = tmp_path / "outside.py"
    outside.write_text("x = 1\n")
    assert cli_main(["--root", str(REPO), str(outside)]) == 2


def test_cli_root_without_the_package_is_usage_error(tmp_path, capsys):
    """A root that holds no crdt_enc_tpu_torch/ must say 'pass --root',
    not limp into an empty clean run."""
    assert cli_main(["--root", str(tmp_path)]) == 2
    assert "--root" in capsys.readouterr().err


def test_cli_list_rules_names_all_ten(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    rules = {line.split()[0] for line in out.splitlines()}
    assert rules == {
        "FFI001", "EXC001", "THR001", "SPN001", "OBS001", "SEC001",
        "ASY001", "DET001", "MUT001", "LCK001",
    }


# ------------------------------------------------------- live port tree


@pytest.fixture(scope="module")
def live():
    """The live port tree, parsed once, every rule run against its
    baseline: (project, findings, baseline)."""
    project = Project(REPO)
    baseline = Baseline.load(REPO / BASELINE_REL)
    return project, run(project, None, baseline), baseline


def test_live_port_tree_clean_under_its_baseline(live):
    """No unsuppressed finding (error or warning) and no stale entry."""
    _project, findings, baseline = live
    assert [f.render() for f in findings if f.suppressed is None] == []
    assert baseline.stale_entries() == []


def test_live_baseline_entries_are_pinned_and_reasoned(live):
    """Every entry has a reason and absorbs exactly its pinned ``max``;
    each suppressed finding carries its channel."""
    _project, findings, baseline = live
    for e in baseline.entries:
        assert len(e.reason) > 40, e
        assert e.matched == e.max, (e.rule, e.path, e.context)
    by_channel = {}
    for f in findings:
        by_channel.setdefault(f.suppressed, []).append(f.rule)
    assert set(by_channel) == {"baseline", "pragma"}
    assert len(by_channel["baseline"]) == sum(e.max for e in baseline.entries)
    assert sorted(by_channel["pragma"]) == ["OBS001", "OBS001"]


def test_live_pragmas_carry_reasons():
    """Every disable and effect-ok pragma in the package says why, in
    parentheses after the rule or kind."""
    pragma = re.compile(r"#\s*lint:\s*(disable|effect-ok)=[A-Za-z0-9_,]+(.*)$")
    seen = 0
    for path in sorted((REPO / PKG).rglob("*.py")):
        if "analysis" in path.relative_to(REPO / PKG).parts:
            continue  # the engine's own docs spell the pragma out
        for line in path.read_text().splitlines():
            m = pragma.search(line)
            if m:
                seen += 1
                assert re.match(r"\s*\(.{10,}\)", m.group(2)), line
    assert seen == 9  # 2 OBS001 disables + 7 build seeds sanctioned


def test_live_registry_lists_exactly_what_the_port_emits(live):
    """The port's registry rows are the literal names the package emits
    (plus the obs-internal ``events_dropped``), no more and no fewer."""
    from crdt_enc_tpu_torch.analysis.astutil import const_str
    from crdt_enc_tpu_torch.analysis.rules.spans import (
        _INTERNAL,
        _is_obs_call,
        registry_names,
    )
    import ast

    project, _findings, _baseline = live
    emitted = set()
    for mod in project.modules:
        for call in mod.walk(ast.Call):
            if _is_obs_call(call.func) and call.args:
                name = const_str(call.args[0])
                assert name is not None, (mod.rel, call.lineno)
                emitted.add(name)
    assert set(registry_names(project)) == emitted | _INTERNAL
    assert {"map_rows_birth", "cuda_builds", "build.native"} <= emitted


def test_live_cli_clean_within_budget():
    """The whole twin runs clean (exit 0 under --diff-baseline) inside
    20 s: the port's tree is larger than the JAX package's, whose gate
    is 10 s."""
    t0 = time.monotonic()
    rc = cli_main(["--diff-baseline", "--root", str(REPO)])
    elapsed = time.monotonic() - t0
    assert rc == 0
    assert elapsed < 20.0, f"analyzer took {elapsed:.1f}s (budget 20s)"


@pytest.mark.parametrize("rule_id", ["SPN001", "THR001"])
def test_single_rule_runs_clean(rule_id, capsys):
    """The span registry and the thread discipline, each alone over the
    live tree (the JAX package's old per-lint scripts' contract)."""
    assert cli_main(["--rule", rule_id, "--diff-baseline",
                     "--root", str(REPO)]) == 0


BLOCKER = (
    "import sys, runpy\n"
    "class Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        top = name.split('.')[0]\n"
    "        if top in ('jax', 'jaxlib', 'crdt_enc_tpu'):\n"
    "            raise ImportError('blocked: ' + name)\n"
    "        return None\n"
    "sys.meta_path.insert(0, Block())\n"
    "for mod in [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'crdt_enc_tpu')]:\n"
    "    del sys.modules[mod]\n"
    "try:\n"
    "    import jax\n"
    "except ImportError:\n"
    "    pass\n"
    "else:\n"
    "    sys.exit(9)\n"
    "sys.argv = ['analyze', *sys.argv[1:]]\n"
    "runpy.run_module('crdt_enc_tpu_torch.tools.analyze', run_name='__main__')\n"
)


@pytest.mark.parametrize("tree,rc", [("live", 0), ("seeded", 1)])
def test_the_twin_runs_without_jax(tmp_path, tree, rc):
    """The CLI in a process where ``import jax`` and ``import
    crdt_enc_tpu`` raise: exit 0 on the live tree, 1 on a seeded
    fixture."""
    root = REPO
    if tree == "seeded":
        root = tmp_path
        write(root, f"{PKG}/mod.py",
              "import threading\ndef f():\n    threading.Thread().start()\n")
        write(root, DOC_REL, QUIET_REGISTRY)
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, "--diff-baseline", "--root", str(root)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == rc, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "blocked" not in proc.stderr


# ------------------------------------------- parity with the JAX engine

PARITY_REGISTRY = textwrap.dedent(
    """\
    ## Span registry

    | `phase.x` | fixture |
    | `stream.h2d` | fixture |
    | `unused.row` | fixture |

    ## Counter & gauge registry

    | `h2d_bytes` | fixture |
    """
)

#: one fixture tree, written under each engine's package prefix; every
#: shared rule fires in it and stays quiet at a compliant twin site
PARITY_TREE = {
    "serve/m.py": """\
        import asyncio
        import time

        def decode():
            time.sleep(1)

        def io():
            with open("x") as f:
                return f.read()

        async def cycle():
            decode()
            await asyncio.to_thread(io)

        async def clean():
            await asyncio.to_thread(decode)
        """,
    "core/seal.py": """\
        async def seal(self):
            # lint: sync-section-begin
            d = self._data
            await self.storage.put(d)
            # lint: sync-section-end
            return d

        async def ok(self):
            # lint: sync-section-begin
            d = sorted(self._data)
            # lint: sync-section-end
            await self.storage.put(d)
        """,
    "sim/m.py": """\
        import random
        import time
        import uuid

        def stamp():
            return time.time()

        def lane():
            return stamp() + 1

        def roll():
            return random.random()

        def fresh():
            return uuid.uuid4()

        def seeded(seed):
            return random.Random(seed)
        """,
    "serve/daemon.py": """\
        import os

        def jitter():
            return os.urandom(4)
        """,
    "ops/exc.py": """\
        import logging
        from .. import native
        logger = logging.getLogger(__name__)

        def fast(buf):
            try:
                return native.load().decode(buf)
            except Exception:
                return None

        def loud(buf):
            try:
                return native.load().decode(buf)
            except Exception as e:
                logger.warning("native decode failed: %r", e)
                raise
        """,
    "native/bind.py": """\
        import ctypes
        u8p = ctypes.POINTER(ctypes.c_uint8)

        def _bind(lib):
            lib.half.argtypes = [u8p, ctypes.c_uint64]
            lib.fill.argtypes = [u8p, u8p]
            lib.fill.restype = None
            lib.status.argtypes = [u8p, ctypes.c_uint64]
            lib.status.restype = ctypes.c_int64

        def use(lib):
            lib.status(None, 0)
            rc = lib.status(None, 0)
            lib.nowhere(rc)
        """,
    "obs/box.py": """\
        import asyncio
        import threading

        _LOCK = threading.Lock()

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []

            def put(self, x):
                with self._lock:
                    self._items.append(x)

            def peek(self):
                return self._items[-1]

            def safe(self):
                with self._lock:
                    return list(self._items)

        async def bad():
            with _LOCK:
                await asyncio.sleep(0)
        """,
    "models/state.py": """\
        from dataclasses import dataclass, field

        @dataclass
        class State:
            entries: dict = field(default_factory=dict)
            clock: dict = field(default_factory=dict)
            _mut: int = field(default=0, compare=False, repr=False)

            def never(self, k, v):
                self.entries[k] = v

            def one_branch(self, k, v):
                if k in self.entries:
                    self._mut += 1
                self.entries[k] = v

            def good(self, k, v):
                self._mut += 1
                self._store(k, v)

            def _store(self, k, v):
                self.entries[k] = v

        def writeback(state, clock):
            state.clock = clock

        def fresh(clock):
            s = State()
            s.clock = clock
            return s
        """,
    "backends/keys.py": """\
        import logging
        logger = logging.getLogger(__name__)

        def unwrap(key, blob):
            logger.warning("unwrap failed for key %r", key)
            if len(key) != 32:
                raise ValueError(f"bad length {len(key)}")
            return blob
        """,
    "utils/spans.py": """\
        from . import trace

        def work(k):
            with trace.span("phase.x"):
                trace.add("not.registered", 1)
                trace.add(f"chunk.{k}", 1)
            with trace.span("stream.h2d"):
                trace.add("h2d_bytes", k)
        """,
    "ops/threads.py": """\
        import threading

        def spawn():
            t = threading.Thread(target=print)
            u = threading.Thread(target=print)  # lint: disable=THR001
            return t, u
        """,
}

SHARED_RULES = ["ASY001", "DET001", "EXC001", "FFI001", "LCK001", "MUT001",
                "SEC001", "SPN001", "THR001"]


def _norm(findings, prefix: str, doc: str) -> list:
    def strip(text: str) -> str:
        return text.replace(doc, "<registry>").replace(prefix, "")

    return sorted(
        (f.rule, f.severity, strip(f.path), f.line, f.context,
         f.suppressed, tuple(strip(link) for link in f.chain or ()))
        for f in findings
    )


@pytest.fixture(scope="module")
def parity_trees(tmp_path_factory):
    """The parity tree parsed by each engine: (JAX project, twin project)."""
    jroot = tmp_path_factory.mktemp("parity_jax")
    root = tmp_path_factory.mktemp("parity_port")
    write(jroot, "docs/observability.md", PARITY_REGISTRY)
    write(root, DOC_REL, PARITY_REGISTRY)
    for rel, src in PARITY_TREE.items():
        write(jroot, f"crdt_enc_tpu/{rel}", src)
        write(root, f"{PKG}/{rel}", src)
    return JProject(jroot), Project(root)


@pytest.mark.parametrize("rule_id", SHARED_RULES)
def test_parity_with_the_jax_engine(parity_trees, rule_id):
    """The same (rule, severity, path after the prefix, line, context,
    channel) findings and the same chains from both engines, and the rule
    fires at least once."""
    jproject, project = parity_trees
    theirs = _norm(jrun(jproject, [rule_id], None), "crdt_enc_tpu/",
                   "docs/observability.md")
    ours = _norm(run(project, [rule_id], None), f"{PKG}/", DOC_REL)
    assert ours == theirs
    assert any(row[5] is None and row[1] == "error" for row in ours)


OBS_PAIR = {
    "jax": ("""\
        import jax
        from .utils import trace

        def upload(x):
            {count}
            return jax.device_put(x)
        """, "crdt_enc_tpu", "docs/observability.md"),
    "torch": ("""\
        import torch
        from .utils import trace

        def upload(x):
            {count}
            return torch.from_numpy(x).to("cuda")
        """, PKG, DOC_REL),
}


@pytest.mark.parametrize("counted", [False, True])
def test_obs_pair_device_put_and_to_device(tmp_path, counted):
    """OBS001 on ``jax.device_put`` in the JAX engine and on
    ``.to(device)`` in the twin: both fire without ``h2d_bytes`` and both
    stay quiet with it, at the same line and context."""
    count = 'trace.add("h2d_bytes", x.nbytes)' if counted else "pass"
    out = {}
    for engine, (src, prefix, doc) in OBS_PAIR.items():
        root = tmp_path / engine
        write(root, doc, REGISTRY_DOC)
        write(root, f"{prefix}/up.py", src.replace("{count}", count))
        proj_cls, run_fn = (
            (JProject, jrun) if engine == "jax" else (Project, run))
        out[engine] = _norm(run_fn(proj_cls(root), ["OBS001"], None),
                            f"{prefix}/", doc)
    assert out["jax"] == out["torch"]
    assert len(out["torch"]) == (0 if counted else 1)
    if not counted:
        assert out["torch"][0][2:5] == ("up.py", 6, "upload")


# --------------------------------------- firing on copies of live files


def _copy_live(root: pathlib.Path, rel: str, edit=None) -> str:
    src = (REPO / PKG / rel).read_text()
    if edit is not None:
        new = edit(src)
        assert new != src, f"the edit did not apply to {rel}"
        src = new
    path = root / PKG / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return src


def _wrap_fold_in_broad_except(src: str) -> str:
    return src.replace(
        "        return orset_fold_cuda(*args, **kw)\n",
        "        try:\n"
        "            return orset_fold_cuda(*args, **kw)\n"
        "        except Exception:\n"
        "            return orset_fold_plain(*args, **kw)\n",
    )


@pytest.mark.parametrize("edited", [False, True])
def test_exc_fires_on_a_broad_except_around_orset_fold_cuda(tmp_path, edited):
    """A copy of the live ``ops/orset.py`` is clean; wrapping its K2
    call in a silent broad except is an EXC001 error there."""
    _copy_live(tmp_path, "ops/orset.py",
               _wrap_fold_in_broad_except if edited else None)
    errs = errors_of(run(Project(tmp_path), ["EXC001"], None))
    if not edited:
        assert errs == []
    else:
        (f,) = errs
        assert f.path == f"{PKG}/ops/orset.py" and f.context == "orset_fold"


def _drop_one_bump(src: str) -> str:
    return src.replace("        self._mut += 1\n", "", 1)


@pytest.mark.parametrize("edited", [False, True])
def test_mut_fires_when_a_bump_is_removed_from_models_orset(tmp_path, edited):
    """A copy of the live ``models/orset.py`` keeps the epoch law; with
    its first ``_mut`` bump removed, MUT001 names that method."""
    _copy_live(tmp_path, "models/orset.py", _drop_one_bump if edited else None)
    errs = errors_of(run(Project(tmp_path), ["MUT001"], None))
    if not edited:
        assert errs == []
    else:
        (f,) = errs
        assert f.context.startswith("ORSet.") and "never bumps" in f.message


FOLDING_SERVICE = """\
    from ..ops.orset import orset_fold


    async def cycle(planes, rows, E, R):
        return orset_fold(*planes, *rows, num_members=E, num_replicas=R)
    """

K2_FILES = ("ops/orset.py", "ops/orset_fold_cuda.py", "ops/cuda_build.py",
            "native/__init__.py")


def _strip_effect_ok(src: str) -> str:
    return re.sub(r"  # lint: effect-ok=blocks \([^)]*\)", "", src)


@pytest.mark.parametrize("pragmas", ["stripped", "kept"])
def test_asy_reaches_the_nvcc_build_from_an_async_fold(tmp_path, pragmas):
    """Copies of the live K2 path (``ops/orset.py`` → ``orset_fold_cuda``
    → ``cuda_build.load`` → ``build``) and of ``native/__init__.py``,
    whose own ``load`` made the name ambiguous, under an ``async def``
    that folds: ``cuda_build.load`` resolves through ``from . import
    cuda_build``, so without the effect-ok pragmas ASY001 reaches the
    ``subprocess.Popen`` of the ``nvcc`` build; with them the build is
    sanctioned and only the launch itself is left."""
    for rel in K2_FILES:
        edit = None
        if pragmas == "stripped" and rel == "ops/cuda_build.py":
            edit = _strip_effect_ok
        _copy_live(tmp_path, rel, edit)
    write(tmp_path, f"{PKG}/serve/fold.py", FOLDING_SERVICE)
    errs = errors_of(run(Project(tmp_path), ["ASY001"], None))
    origins = {f.message.split("`")[1]: f for f in errs}
    assert "ffi:lib.orset_fold_launch" in origins
    if pragmas == "kept":
        assert "subprocess.Popen" not in origins
    else:
        f = origins["subprocess.Popen"]
        assert f.context == "cycle"
        assert f.chain[-1].endswith("build: call to subprocess.Popen")
        assert any("_lib -> load" in link for link in f.chain)


def test_the_jax_resolver_is_blind_to_the_same_build(tmp_path):
    """The JAX engine on the same copies (under ``crdt_enc_tpu/``) leaves
    ``cuda_build.load`` ambiguous between the two ``load`` defs and never
    reaches the ``nvcc`` build: the blindness the twin repairs."""
    from crdt_enc_tpu.analysis.effects import effect_index

    for rel in K2_FILES:
        src = _strip_effect_ok((REPO / PKG / rel).read_text())
        write(tmp_path, f"crdt_enc_tpu/{rel}", src)
    write(tmp_path, "crdt_enc_tpu/serve/fold.py", FOLDING_SERVICE)
    idx = effect_index(JProject(tmp_path))
    (fi,) = idx.lookup("serve/fold.py::cycle")
    assert "subprocess.Popen" not in fi.origins("blocks")
    (lib,) = idx.lookup("orset_fold_cuda.py::_lib")
    assert any("ambiguous" in u.desc and "'load'" in u.desc
               for u in lib.unresolved)


# -------------------------------- the repairs the twin's rules surfaced


def test_note_build_records_literal_names():
    """SPN001's repair of ``obs/runtime.py``: the build counters and
    spans are literal names, and an unknown library kind raises."""
    from crdt_enc_tpu_torch.obs import runtime
    from crdt_enc_tpu_torch.utils import trace

    trace.reset()
    try:
        runtime.note_build("cuda", 0.5, 3)
        runtime.note_build("native", 0.25)
        snap = trace.snapshot()
        assert snap["counters"]["cuda_builds"] == 3
        assert snap["counters"]["native_builds"] == 1
        assert {"build.cuda", "build.native"} <= set(snap["spans"])
        assert runtime.build_count() == 4
        with pytest.raises(ValueError, match="unknown library kind"):
            runtime.note_build("xla", 1.0)
    finally:
        trace.reset()


def test_cuda_build_records_literal_names(monkeypatch, tmp_path):
    """SPN001's repair of the build counter: a CUDA build records
    ``cuda_builds`` and ``build.cuda`` by literal name, writes each
    library through a temporary file named for its process and thread,
    and a second build of the same sources records nothing."""
    import os
    import threading

    from crdt_enc_tpu_torch.obs import runtime
    from crdt_enc_tpu_torch.ops import cuda_build
    from crdt_enc_tpu_torch.utils import trace

    outs = []

    class Nvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            out = pathlib.Path(cmd[cmd.index("-o") + 1])
            out.write_bytes(b"")
            outs.append(out.name)

        def communicate(self):
            return "", None

    monkeypatch.setattr(cuda_build, "BUILD", tmp_path)
    monkeypatch.setattr(cuda_build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", Nvcc)
    names = ("orset_fold", "lww_fold")
    trace.reset()
    try:
        cuda_build.build(names)
        snap = trace.snapshot()
        assert snap["counters"]["cuda_builds"] == 2
        assert "build.cuda" in snap["spans"]
        assert runtime.build_count() == 2
        tag = f".{os.getpid()}.{threading.get_ident()}.tmp"
        assert [o.endswith(tag) for o in outs] == [True, True]
        assert all(cuda_build.lib_path(n).exists() for n in names)
        assert cuda_build.build(names) == 0.0
        assert runtime.build_count() == 2
    finally:
        trace.reset()


def test_map_session_counts_its_rows_by_literal_name():
    """SPN001's repair of ``parallel/session.py``: the CrdtMap session's
    four row counters are literal names again, and together they count
    every row it fed."""
    import random

    import crdt_enc_tpu_torch.models as P
    from crdt_enc_tpu_torch.utils import trace
    from tests.test_torch_catalogue import map_history, map_script_from
    from tests.test_torch_map_columnar import (
        accel,
        payloads_from_streams,
        session_fold,
    )

    _oracle, streams = map_history(P, map_script_from(random.Random(41), 4, 40))
    trace.reset()
    try:
        session = session_fold(accel("host"), P.CrdtMap(child=b"orset"),
                               payloads_from_streams(streams))
        counters = trace.snapshot()["counters"]
        fams = [counters["map_rows_birth"], counters["map_rows_child_add"],
                counters["map_rows_child_rm"], counters["map_rows_key_rm"]]
        assert sum(fams) == session.rows_fed > 0
    finally:
        trace.reset()
