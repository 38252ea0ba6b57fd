"""The twin's interprocedural effect engine (crdt_enc_tpu_torch/analysis/
effects.py) and the four rule families built on it (ASY001, DET001,
MUT001, LCK001).

The JAX package's tests/test_effects_analysis.py case for case on the
port's layout: the engine's seed tables, propagation, laundering seams,
honest widening and the ``effect-ok`` pragma; per-rule positive/negative
fixture pairs; the ``--effects``/``--expect-json-version`` CLI surface and
the partial-run contract; and the runtime checks of what the rules guard
(the ``_mut`` epochs of the port's CrdtMap and LWWMap, the fold
writeback's bump, ``Core.open`` loading the native libraries off the
loop).  Then the twin's own: the module-attribute resolution that sees
``cuda_build.load`` through ``from . import cuda_build``, torch's
synchronize seeds in place of ``block_until_ready``/``device_put``, the
CUDA warm-up in ``Core.open`` that the build's effect-ok pragmas rest
on, and the build timer rooted in ``obs/``.

Fixtures are parsed, never executed.
"""

from __future__ import annotations

import asyncio
import json
import pathlib
import textwrap
import threading
import uuid

import numpy as np
import pytest
import torch

from crdt_enc_tpu.analysis import Project as JProject
from crdt_enc_tpu.analysis.effects import effect_index as j_effect_index
from crdt_enc_tpu_torch.analysis import Project, run, unsuppressed_errors
from crdt_enc_tpu_torch.analysis.cli import main as cli_main
from crdt_enc_tpu_torch.analysis.effects import (
    KIND_BLOCKS,
    KIND_RNG,
    KIND_WALL,
    effect_index,
)
from crdt_enc_tpu_torch.analysis.rules.spans import DOC_REL

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = "crdt_enc_tpu_torch"


def project_of(tmp_path, files: dict) -> Project:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return Project(tmp_path)


def errors_of(tmp_path, files, rules):
    findings = run(project_of(tmp_path, files), rules, None)
    return unsuppressed_errors(findings)


def one_func(idx, qualname):
    (fi,) = idx.lookup(qualname)
    return fi


# ----------------------------------------------------- effect engine


def test_direct_seeds_classified(tmp_path):
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            import os
            import time

            def sleeper():
                time.sleep(1)

            def clocky():
                return time.time()

            def dicey():
                return os.urandom(8)
            """,
    }))
    assert one_func(idx, "sleeper").effect_kinds() == {KIND_BLOCKS}
    assert one_func(idx, "clocky").effect_kinds() == {KIND_WALL}
    assert one_func(idx, "dicey").effect_kinds() == {KIND_RNG}


def test_propagation_builds_provenance_chain(tmp_path):
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            import time

            def leaf():
                time.sleep(1)

            def mid():
                leaf()

            def top():
                mid()
            """,
    }))
    top = one_func(idx, "top")
    assert KIND_BLOCKS in top.effect_kinds()
    chain = idx.chain(top.key, KIND_BLOCKS, "time.sleep")
    # caller-first: top -> mid, mid -> leaf, leaf: the sleep itself
    assert len(chain) == 3
    assert "top" in chain[0] and "mid" in chain[1] and "time.sleep" in chain[2]


def test_awaits_effect_does_not_propagate(tmp_path):
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            import asyncio

            async def inner():
                await asyncio.sleep(0)

            def outer():
                return inner()
            """,
    }))
    assert "awaits" in one_func(idx, "inner").effect_kinds()
    assert "awaits" not in one_func(idx, "outer").effect_kinds()


def test_to_thread_and_executor_launder_blocks(tmp_path):
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            import asyncio
            import functools
            import time

            def work():
                time.sleep(1)

            async def laundered():
                await asyncio.to_thread(work)

            async def laundered_partial(loop):
                await loop.run_in_executor(None, functools.partial(work))

            async def guilty():
                work()
            """,
    }))
    assert KIND_BLOCKS not in one_func(idx, "laundered").effect_kinds()
    assert KIND_BLOCKS not in one_func(idx, "laundered_partial").effect_kinds()
    assert KIND_BLOCKS in one_func(idx, "guilty").effect_kinds()


def test_ambiguous_and_dynamic_calls_widen_honestly(tmp_path):
    """2+ same-named defs and non-name callees are recorded as
    unresolved — never resolved by guess, never silently dropped."""
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/a.py": """\
            import time

            def helper():
                time.sleep(1)
            """,
        f"{PKG}/b.py": """\
            def helper():
                return 2
            """,
        f"{PKG}/c.py": """\
            def caller(obj):
                obj.helper()

            def dyn(fns):
                fns[0]()
            """,
    }))
    caller = one_func(idx, "caller")
    assert KIND_BLOCKS not in caller.effect_kinds()
    assert any("ambiguous" in u.desc for u in caller.unresolved)
    dyn = one_func(idx, "dyn")
    assert any("dynamic call" in u.desc for u in dyn.unresolved)
    assert not dyn.effect_kinds()


def test_effect_ok_pragma_sanctions_that_line_only(tmp_path):
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            def build():
                with open("x", "w") as f:  # lint: effect-ok=blocks (one-shot)
                    f.write("y")

            def plain():
                with open("x") as f:
                    return f.read()
            """,
    }))
    build = one_func(idx, "build")
    assert KIND_BLOCKS not in build.effect_kinds()
    assert [(k, d) for k, _ln, d in build.sanctioned] == [
        (KIND_BLOCKS, "call to open")
    ]
    assert KIND_BLOCKS in one_func(idx, "plain").effect_kinds()


MODULE_ATTR_TREE = {
    "native/__init__.py": """\
        import subprocess

        def load():
            subprocess.run(["c++"])
        """,
    "ops/cuda_build.py": """\
        import subprocess

        def load(name):
            subprocess.Popen(["nvcc", name])
        """,
    "ops/wrapper.py": """\
        from . import cuda_build

        def _lib():
            return cuda_build.load("orset_fold")
        """,
}


def test_module_attribute_resolves_through_from_import(tmp_path):
    """``from . import cuda_build; cuda_build.load()`` names one function
    although two defs are called ``load``: the twin follows the import to
    the module, where the JAX resolver records an ambiguity and loses the
    ``nvcc`` build behind it."""
    idx = effect_index(project_of(tmp_path / "port", {
        f"{PKG}/{rel}": src for rel, src in MODULE_ATTR_TREE.items()}))
    lib = one_func(idx, "wrapper.py::_lib")
    assert lib.origins(KIND_BLOCKS) == ["subprocess.Popen"]
    assert not lib.unresolved
    jidx = j_effect_index(JProject(project_of(tmp_path / "jax", {
        f"crdt_enc_tpu/{rel}": src
        for rel, src in MODULE_ATTR_TREE.items()}).root))
    (jlib,) = jidx.lookup("wrapper.py::_lib")
    assert jlib.origins("blocks") == []
    assert any("ambiguous: 2 defs named 'load'" in u.desc
               for u in jlib.unresolved)


def test_torch_synchronize_seeds_and_host_reads_do_not(tmp_path):
    """A host wait on the card blocks (``torch.cuda.synchronize``,
    ``.synchronize()`` on a stream or an event); ``.cpu()``, ``.item()``
    and ``.numpy()`` are no seeds, and neither are JAX's
    ``block_until_ready`` and ``device_put``."""
    idx = effect_index(project_of(tmp_path, {
        f"{PKG}/m.py": """\
            import torch

            def sync_all():
                torch.cuda.synchronize()

            def sync_stream(stream):
                stream.synchronize()

            def sync_event(done):
                done.synchronize()

            def pull(t):
                return t.cpu().numpy(), t.item()

            def jaxish(x, jax):
                return jax.device_put(x).block_until_ready()
            """,
    }))
    for name in ("sync_all", "sync_stream", "sync_event"):
        assert one_func(idx, name).origins(KIND_BLOCKS) == ["synchronize"]
    assert not one_func(idx, "pull").effect_kinds()
    assert not one_func(idx, "jaxish").effect_kinds()


# ------------------------------------------------------------- ASY001


def test_asy_blocking_in_async_caught_with_chain(tmp_path):
    errors = errors_of(tmp_path, {
        f"{PKG}/serve/m.py": """\
            import time

            def decode():
                time.sleep(1)

            async def cycle():
                decode()
            """,
    }, ["ASY001"])
    (f,) = errors
    assert "time.sleep" in f.message and f.context == "cycle"
    assert f.chain and "decode" in f.chain[0]


def test_asy_to_thread_seam_passes(tmp_path):
    assert not errors_of(tmp_path, {
        f"{PKG}/serve/m.py": """\
            import asyncio
            import time

            def decode():
                time.sleep(1)

            async def cycle():
                await asyncio.to_thread(decode)
            """,
    }, ["ASY001"])


def test_asy_out_of_scope_async_passes(tmp_path):
    assert not errors_of(tmp_path, {
        f"{PKG}/utils/m.py": """\
            import time

            async def helper():
                time.sleep(1)
            """,
        # the JAX package's tree is no scope of the twin
        "crdt_enc_tpu/serve/m.py": """\
            import time

            async def cycle():
                time.sleep(1)
            """,
    }, ["ASY001"])


def test_asy_sync_section_await_caught(tmp_path):
    src = """\
        async def seal(self):
            # lint: sync-section-begin
            d = self._data
            await self.storage.put(d)
            # lint: sync-section-end
            return d
        """
    (f,) = errors_of(tmp_path, {f"{PKG}/core/m.py": src}, ["ASY001"])
    assert "sync section" in f.message and f.line == 4


def test_asy_sync_section_clean_and_unterminated(tmp_path):
    assert not errors_of(tmp_path, {
        f"{PKG}/core/ok.py": """\
            async def seal(self):
                # lint: sync-section-begin
                d = self._data
                cut = sorted(d)
                # lint: sync-section-end
                await self.storage.put(cut)
            """,
    }, ["ASY001"])
    (f,) = errors_of(tmp_path, {
        f"{PKG}/core/bad.py": """\
            async def seal(self):
                # lint: sync-section-begin
                d = self._data
                return d
            """,
    }, ["ASY001"])
    assert "without a matching" in f.message


# ------------------------------------------------------------- DET001


def test_det_wall_clock_on_sim_surface_caught(tmp_path):
    (f,) = errors_of(tmp_path, {
        f"{PKG}/sim/m.py": """\
            import time

            def stamp():
                return time.time()
            """,
    }, ["DET001"])
    assert "wall_clock" in f.message and "time.time" in f.message


def test_det_daemon_module_is_a_surface(tmp_path):
    (f,) = errors_of(tmp_path, {
        f"{PKG}/serve/daemon.py": """\
            import random

            def roll():
                return random.random()
            """,
    }, ["DET001"])
    assert "rng" in f.message


def test_det_seeded_seams_pass(tmp_path):
    """uuid4 rides the ContextVar dispatch seam; a clock= parameter is a
    dynamic call; seeded Random(seed) is not an rng effect; a clock read
    whose direct origin is under obs/ is telemetry."""
    assert not errors_of(tmp_path, {
        f"{PKG}/sim/m.py": """\
            import random
            import uuid

            from ..obs import runtime

            def fresh_id():
                return uuid.uuid4()

            def step(clock):
                return clock()

            def rng_for(seed):
                return random.Random(seed)

            def timed():
                return runtime.wall_clock()
            """,
        f"{PKG}/obs/runtime.py": """\
            import time

            def wall_clock():
                return time.perf_counter()
            """,
    }, ["DET001"])


# ------------------------------------------------------------- MUT001


def test_mut_unbumped_and_one_branch_caught(tmp_path):
    errors = errors_of(tmp_path, {
        f"{PKG}/m.py": """\
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
            """,
    }, ["MUT001"])
    by_ctx = {f.context: f for f in errors}
    assert set(by_ctx) == {"State.never", "State.one_branch"}
    assert "never bumps" in by_ctx["State.never"].message
    assert "one branch" in by_ctx["State.one_branch"].message


def test_mut_dominating_bump_and_alias_write_semantics(tmp_path):
    errors = errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            from dataclasses import dataclass, field

            @dataclass
            class State:
                entries: dict = field(default_factory=dict)
                _mut: int = field(default=0, compare=False, repr=False)

                def good(self, k, v):
                    self._mut += 1
                    if v:
                        self.entries[k] = v

                def via_alias(self, k):
                    e = self.entries
                    e.pop(k, None)
            """,
    }, ["MUT001"])
    assert [f.context for f in errors] == ["State.via_alias"]
    assert "alias" in errors[0].message


def test_mut_private_helper_obligation_moves_to_callers(tmp_path):
    assert not errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            from dataclasses import dataclass, field

            @dataclass
            class State:
                entries: dict = field(default_factory=dict)
                _mut: int = field(default=0, compare=False, repr=False)

                def apply(self, k, v):
                    self._mut += 1
                    self._store(k, v)

                def _store(self, k, v):
                    self.entries[k] = v
            """,
    }, ["MUT001"])


def test_mut_module_writeback_needs_bump_unless_fresh(tmp_path):
    errors = errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            from dataclasses import dataclass, field

            @dataclass
            class State:
                entries: dict = field(default_factory=dict)
                clock: dict = field(default_factory=dict)
                _mut: int = field(default=0, compare=False, repr=False)

            def writeback(state, clock):
                state.clock = clock

            def writeback_bumped(state, clock):
                state._mut += 1
                state.clock = clock

            def fresh_build(clock):
                s = State()
                s.clock = clock
                return s
            """,
    }, ["MUT001"])
    (f,) = errors
    assert f.context == "writeback" and "state._mut" in f.message


# ------------------------------------------------------------- LCK001


def test_lck_unlocked_access_of_guarded_field_caught(tmp_path):
    (f,) = errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []

                def put(self, x):
                    with self._lock:
                        self._items.append(x)

                def peek(self):
                    return self._items[-1]
            """,
    }, ["LCK001"])
    assert f.context == "Box.peek" and "_items" in f.message


def test_lck_consistent_locking_passes(tmp_path):
    assert not errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            import threading

            class Box:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._items = []

                def put(self, x):
                    with self._lock:
                        self._items.append(x)

                def peek(self):
                    with self._lock:
                        return self._items[-1]
            """,
    }, ["LCK001"])


def test_lck_await_under_threading_lock_caught(tmp_path):
    errors = errors_of(tmp_path, {
        f"{PKG}/m.py": """\
            import asyncio
            import threading

            _LOCK = threading.Lock()

            async def bad():
                with _LOCK:
                    await asyncio.sleep(0)

            async def fine(lock: asyncio.Lock):
                async with lock:
                    await asyncio.sleep(0)
            """,
    }, ["LCK001"])
    (f,) = errors
    assert f.context == "bad" and "parks the event loop" in f.message


# ---------------------------------------------------------------- CLI


_REGISTRY_DOC = textwrap.dedent(
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


def _mini_checkout(tmp_path, src):
    (tmp_path / PKG).mkdir()
    (tmp_path / PKG / "mod.py").write_text(textwrap.dedent(src))
    (tmp_path / DOC_REL).parent.mkdir(parents=True)
    (tmp_path / DOC_REL).write_text(_REGISTRY_DOC)


def test_cli_effects_dump_text(tmp_path, capsys):
    _mini_checkout(tmp_path, """\
        import time

        def leaf():
            time.sleep(1)

        async def top():
            leaf()
        """)
    assert cli_main(["--effects", "top", "--root", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "async def top" in out
    assert "blocks: time.sleep" in out
    assert "via" in out


def test_cli_effects_json_schema(tmp_path, capsys):
    _mini_checkout(tmp_path, """\
        import time

        def leaf(fns):
            fns[0]()
            return time.time()
        """)
    rc = cli_main(["--effects", "leaf", "--json", "--root", str(tmp_path)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["version"] == 2
    (fn,) = out["functions"]
    assert set(fn) == {
        "key", "qualname", "async", "effects", "unresolved", "sanctioned",
    }
    (eff,) = fn["effects"]
    assert eff["kind"] == "wall_clock" and eff["chain"]
    assert fn["unresolved"][0]["desc"].startswith("dynamic call")


def test_cli_effects_unknown_qualname_is_usage_error(tmp_path, capsys):
    _mini_checkout(tmp_path, "def f():\n    pass\n")
    assert cli_main(["--effects", "nope.missing", "--root", str(tmp_path)]) == 2
    assert "no function matching" in capsys.readouterr().err


def test_cli_expect_json_version_pins_consumers(tmp_path, capsys):
    _mini_checkout(tmp_path, "def f():\n    pass\n")
    args = ["--json", "--rule", "THR001", "--root", str(tmp_path)]
    assert cli_main(["--expect-json-version", "1", *args]) == 2
    assert "schema version mismatch" in capsys.readouterr().err
    assert cli_main(["--expect-json-version", "2", *args]) == 0


def test_cli_partial_run_new_rules_no_spurious_findings(capsys):
    """The path-subset contract extends to the effect families: a
    single-file run on a live module exits clean."""
    rc = cli_main([
        "--rule", "ASY001", "--rule", "DET001", "--rule", "MUT001",
        "--rule", "LCK001", "--diff-baseline",
        str(REPO / PKG / "models" / "orset.py"),
        "--root", str(REPO),
    ])
    assert rc == 0
    assert "0 error(s)" in capsys.readouterr().out


# ---------------------------------------------- the live tree's effects


@pytest.fixture(scope="module")
def live_idx():
    return effect_index(Project(REPO))


def test_live_k2_launch_chain_from_the_service_cycle(live_idx):
    """``--effects FoldService._run_cycle`` shows the K2 launch: the
    cycle reaches ``lib.orset_fold_launch`` through the bucket fold and
    ``orset_fold_cuda``; the ``nvcc`` build behind ``cuda_build.load`` is
    sanctioned at its seeds, not an effect of the cycle."""
    fi = one_func(live_idx, "FoldService._run_cycle")
    chain = live_idx.chain(fi.key, KIND_BLOCKS, "ffi:lib.orset_fold_launch")
    assert "FoldService._fold_orset_bucket" in chain[1]
    assert chain[-1].endswith("_launch: native FFI call lib.orset_fold_launch()")
    blocks = fi.origins(KIND_BLOCKS)
    assert "subprocess.Popen" not in blocks and "subprocess.run" not in blocks
    build = one_func(live_idx, "ops/cuda_build.py::_build")
    assert sorted(d for _k, _ln, d in build.sanctioned) == [
        "call to os.replace", "call to subprocess.Popen"]
    lib = one_func(live_idx, "orset_fold_cuda.py::_lib")
    assert not [u for u in lib.unresolved if "'load'" in u.desc]


def test_live_build_timer_reaches_the_sim_opens(live_idx):
    """Core.open reaches the CUDA build's wall timer through its off-loop
    warm-up, so DET001 reports it at the simulator's three opens; the
    port's baseline holds one entry for each, pinned to one finding."""
    from crdt_enc_tpu_torch.analysis.baseline import Baseline
    from crdt_enc_tpu_torch.analysis.rules.determinism import (
        _direct_origin_rel,
    )

    fi = one_func(live_idx, "SimRunner._open")
    assert "time.perf_counter" in fi.origins(KIND_WALL)
    assert _direct_origin_rel(live_idx, fi.key, KIND_WALL,
                              "time.perf_counter") == (
        f"{PKG}/ops/cuda_build.py")
    baseline = Baseline.load(REPO / PKG / "analysis" / "baseline.toml")
    timer = [e for e in baseline.entries
             if e.rule == "DET001" and "build.cuda" in e.reason]
    assert sorted(e.context for e in timer) == [
        "SimRunner._check_oracle", "SimRunner._check_warm_cold.one",
        "SimRunner._open"]
    assert {(e.path, e.max) for e in timer} == {(f"{PKG}/sim/runner.py", 1)}


# ---------------------------------- runtime checks of what the rules guard


def test_crdtmap_mut_epoch_bumps_on_apply_and_merge():
    from crdt_enc_tpu_torch.models import CrdtMap
    from crdt_enc_tpu_torch.models.orset import AddOp

    actor = uuid.UUID(int=1).bytes
    m = CrdtMap(child=b"orset")
    before = m._mut
    op = m.update_ctx(actor, "k", lambda child, dot: AddOp("v", dot))
    assert m._mut == before  # deriving an op must NOT mutate
    m.apply(op)
    assert m._mut > before
    other = CrdtMap(child=b"orset")
    other.apply(other.update_ctx(uuid.UUID(int=2).bytes, "k2",
                                 lambda child, dot: AddOp("w", dot)))
    mid = m._mut
    m.merge(other)
    assert m._mut > mid


def test_lwwmap_mut_epoch_bumps_on_apply_and_merge():
    from crdt_enc_tpu_torch.models.lwwmap import LWWMap

    a, b = LWWMap(), LWWMap()
    actor = uuid.UUID(int=1).bytes
    before = a._mut
    a.apply(a.put("k", 1, actor, "v"))
    assert a._mut > before
    b.apply(b.put("k", 2, actor, "w"))
    mid = a._mut
    a.merge(b)
    assert a._mut > mid
    # the epoch is bookkeeping, not state: equal maps stay equal
    assert a == LWWMap.from_obj(a.to_obj())


def test_crdtmap_fold_writeback_bumps_epoch():
    from crdt_enc_tpu_torch.models import CrdtMap, canonical_bytes
    from crdt_enc_tpu_torch.models.orset import AddOp
    from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
    from crdt_enc_tpu_torch.utils import codec

    actor = uuid.UUID(int=1).bytes
    proto = CrdtMap(child=b"orset")
    oracle = CrdtMap(child=b"orset")
    ops = []
    for i in range(3):
        op = oracle.update_ctx(actor, f"k{i}",
                               lambda child, dot: AddOp("v", dot))
        oracle.apply(op)
        ops.append(op)
    payloads = [codec.pack([proto.op_to_obj(op) for op in ops])]
    folded = CrdtMap(child=b"orset")
    before = folded._mut
    ok = TorchAccelerator(device="cpu", min_device_batch=1).fold_payloads(
        folded, payloads, actors_hint=[actor]
    )
    assert ok
    assert folded._mut > before, "fold writeback must invalidate caches"
    assert canonical_bytes(folded) == canonical_bytes(oracle)


def test_orset_fresh_fold_native_self_bumps():
    from crdt_enc_tpu_torch.models import ORSet
    from crdt_enc_tpu_torch.ops.columnar import (
        KIND_ADD,
        Vocab,
        _orset_fresh_fold_native,
    )

    members = Vocab(["m0", "m1"])
    replicas = Vocab([uuid.UUID(int=1).bytes])
    folded = _orset_fresh_fold_native(
        ORSet(),
        np.array([KIND_ADD, KIND_ADD], np.int8),
        np.array([0, 1], np.int64),
        np.array([0, 0], np.int64),
        np.array([1, 2], np.int64),
        members, replicas,
        np.zeros(1, np.int64),
    )
    assert folded is not None
    assert folded._mut > 0, "native writeback must self-protect the epoch"


def _open_opts(accel):
    from crdt_enc_tpu_torch import (
        IdentityCryptor,
        MemoryRemote,
        MemoryStorage,
        OpenOptions,
        PlainKeyCryptor,
        gcounter_adapter,
    )
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    return OpenOptions(
        storage=MemoryStorage(MemoryRemote()),
        cryptor=IdentityCryptor(),
        key_cryptor=PlainKeyCryptor(),
        adapter=gcounter_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=True,
        accelerator=accel,
    )


def _card_accel():
    """The host reference with a card's device: Core.open reads the
    device alone, and nothing else it does folds."""
    from crdt_enc_tpu_torch import HostAccelerator

    accel = HostAccelerator()
    accel.device = torch.device("cuda")
    return accel


def _recording(monkeypatch, module, name, calls, real=None):
    def fn(*a, **kw):
        calls.append((name, threading.current_thread()))
        return real(*a, **kw) if real is not None else None

    monkeypatch.setattr(module, name, fn)


def test_core_open_loads_native_off_loop(monkeypatch):
    """Both native libraries load in a worker thread before the first
    pack, so their one-shot build never runs on the event loop (the
    effect-ok pragmas of ``native._compile`` rest on this)."""
    from crdt_enc_tpu_torch import Core, TorchAccelerator, native

    calls = []
    _recording(monkeypatch, native, "load", calls, native.load)
    _recording(monkeypatch, native, "load_state", calls, native.load_state)

    async def go():
        loop_thread = threading.current_thread()
        await Core.open(_open_opts(TorchAccelerator(device="cpu")))
        return loop_thread

    loop_thread = asyncio.run(go())
    assert [n for n, _t in calls[:2]] == ["load", "load_state"]
    assert all(t is not loop_thread for _n, t in calls[:2])


@pytest.mark.parametrize("card", [False, True])
def test_core_open_warms_the_cuda_kernels_off_loop(monkeypatch, card):
    """For an accelerator on a card, Core.open builds and loads the CUDA
    kernels in a worker thread (the effect-ok pragmas of
    the CUDA build rest on this); a CPU accelerator builds none."""
    from crdt_enc_tpu_torch import Core, TorchAccelerator
    from crdt_enc_tpu_torch.ops import cuda_build

    calls = []
    _recording(monkeypatch, cuda_build, "warm", calls)

    async def go():
        loop_thread = threading.current_thread()
        accel = _card_accel() if card else TorchAccelerator(device="cpu")
        await Core.open(_open_opts(accel))
        return loop_thread

    loop_thread = asyncio.run(go())
    if card:
        ((name, thread),) = calls
        assert name == "warm" and thread is not loop_thread
    else:
        assert calls == []


@pytest.mark.parametrize("loader", ["native", "cuda"])
def test_core_open_raises_when_a_build_fails(monkeypatch, loader):
    """The port's departure from the JAX package's ``native.warm``, which
    swallows a failed build: a build that fails raises out of Core.open,
    and nothing falls back."""
    from crdt_enc_tpu_torch import Core, TorchAccelerator, native
    from crdt_enc_tpu_torch.ops import cuda_build

    def boom(*a, **kw):
        raise RuntimeError("no compiler on this box")

    if loader == "native":
        monkeypatch.setattr(native, "load", boom)
        accel = TorchAccelerator(device="cpu")
    else:
        monkeypatch.setattr(cuda_build, "_libs", {})
        monkeypatch.setattr(cuda_build, "_build", boom)
        accel = _card_accel()
    with pytest.raises(RuntimeError, match="no compiler"):
        asyncio.run(Core.open(_open_opts(accel)))


def _stub_cuda_build(monkeypatch, calls, delay=0.0):
    """Empty ``cuda_build``'s library cache and record its builds and
    loads in ``calls`` instead of running ``nvcc`` and ``dlopen``."""
    import ctypes
    import time

    from crdt_enc_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "_libs", {})

    def build(names):
        calls.append(("build", tuple(names)))
        time.sleep(delay)  # a window for the other threads to race into
        return 0.0

    def dlopen(path):
        calls.append(("load", pathlib.Path(path).name.split("-")[0][3:]))
        return object()

    monkeypatch.setattr(cuda_build, "_build", build)
    monkeypatch.setattr(ctypes, "CDLL", dlopen)
    return cuda_build


def test_cuda_build_warm_builds_all_at_once_then_loads_each(monkeypatch):
    """One parallel build of what is missing, then a load of each; once
    they are loaded, a warm-up and a load are dict checks."""
    calls = []
    cuda_build = _stub_cuda_build(monkeypatch, calls)
    cuda_build.warm()
    assert calls == [("build", cuda_build.SOURCES)] + [
        ("load", n) for n in cuda_build.SOURCES]
    calls.clear()
    cuda_build.warm()
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    assert calls == []


def test_cuda_build_warm_from_many_threads_builds_and_loads_once(monkeypatch):
    """Cores that open together each warm the kernels in their own worker
    thread: they wait for one build of all three and one load of each."""
    calls = []
    cuda_build = _stub_cuda_build(monkeypatch, calls, delay=0.05)
    start = threading.Barrier(8)
    errors = []

    def worker(fn):
        try:
            start.wait()
            fn()
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(cuda_build.warm,))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert calls == [("build", cuda_build.SOURCES)] + [
        ("load", n) for n in cuda_build.SOURCES]
    assert set(cuda_build._libs) == set(cuda_build.SOURCES)
