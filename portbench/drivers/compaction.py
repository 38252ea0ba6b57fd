"""Driver ``compaction``: fresh replicas compacting one shared remote.

The remote is an ``FsStorage`` directory under ``$TMPDIR``: the synced
local folder a crdt-enc deployment keeps.  Set-up writes the
configuration's op files into it with the port's ``Core`` writer (each
file fsynced and linked as the writer publishes it; reads then come from
the page cache), then, where the traffic asks for snapshots, has that
many other replicas each compact a copy holding the version-1 files of
its share of the actors (``actor % stride == i``) and moves their
snapshots into the remote.  One untimed compaction on the card warms the
libraries and the kernels; it runs over an in-memory mirror of the same
blobs, since a staged copy of the folder costs as much as the
compaction itself, and the sealers have already run the folder's code.

The window repeats: stage a fresh copy of the folder (hard links, since
the port publishes a file once and never rewrites it and GC only
unlinks), then time ``Core.open`` -> ``Core.compact()`` of a fresh
replica on it, sampling host RSS from the benchmark's own thread.
Staging, reading back and freeing happen outside the walls.
"""

from __future__ import annotations

import asyncio
import gc
import os
import shutil
import time

import numpy as np

from .. import gen, port
from ..host import RssSampler
from ..reference import orset as ref_orset
from ..reference import sealed

# the checks that catch a broken compaction (portbench/tests): the
# control raises every one of CONTROL_CHECKS above its limit, and each
# planted fault at least one of FAULT_CHECKS
CONTROL_CHECKS = ("snap_cells_off", "snap_clock_off", "mem_cells_off",
                  "files_left")
FAULT_CHECKS = ("snap_cells_off", "mem_cells_off")


def _columns(config: dict, seed: int):
    s = config["shape"]
    return gen.columns(seed, s["replicas"], s["members"], s["ops_per_actor"],
                       s["rm_every"], s["rm_back"])


def _snapshots(traffic: dict) -> tuple:
    return traffic["snapshots"], traffic.get("snapshot_stride", 16)


def stated(config: dict, traffic: dict) -> dict:
    """The work the configuration and the traffic imply, for every seed."""
    return gen.counts(config["shape"], *_snapshots(traffic))


def _measure(cols, config: dict, traffic: dict) -> dict:
    s = config["shape"]
    return gen.measured_counts(cols, s["replicas"], s["ops_per_file"],
                               *_snapshots(traffic))


def measured(config: dict, traffic: dict, seed: int) -> dict:
    """The same numbers counted from the work generated for ``seed``."""
    return _measure(_columns(config, seed), config, traffic)


class FsRemote:
    """The remote folder under ``$TMPDIR``, its snapshot sides and the
    staged copies the window compacts."""

    def __init__(self, root: str):
        self.root = root
        self.base = os.path.join(root, "remote")
        self._n = 0

    def storage(self, remote, local: str):
        from crdt_enc_tpu_torch import FsStorage

        return FsStorage(os.path.join(self.root, local), remote)

    def side(self):
        self._n += 1
        path = os.path.join(self.root, f"snap{self._n}")
        shutil.copytree(self.base, path)
        return path

    def adopt_snapshot(self, side) -> bytes:
        os.makedirs(os.path.join(self.base, "states"), exist_ok=True)
        (name,) = os.listdir(os.path.join(side, "states"))
        shutil.move(os.path.join(side, "states", name),
                    os.path.join(self.base, "states", name))
        shutil.rmtree(side)
        with open(os.path.join(self.base, "states", name), "rb") as f:
            return f.read()

    def metas(self) -> dict:
        d = os.path.join(self.base, "meta")
        out = {}
        for n in os.listdir(d):
            with open(os.path.join(d, n), "rb") as f:
                out[n] = f.read()
        return out

    def stage(self, i: int):
        run_dir = os.path.join(self.root, f"run{i}")
        remote = os.path.join(run_dir, "remote")
        for d, _, names in os.walk(self.base):
            out = os.path.join(remote, os.path.relpath(d, self.base))
            os.makedirs(out, exist_ok=True)
            for n in names:
                os.link(os.path.join(d, n), os.path.join(out, n))
        return remote, run_dir

    @staticmethod
    def states(remote) -> list:
        out = []
        d = os.path.join(remote, "states")
        for n in sorted(os.listdir(d)):
            with open(os.path.join(d, n), "rb") as f:
                out.append(f.read())
        return out

    @staticmethod
    def ops_left(remote) -> int:
        return sum(len(ns) for _, _, ns in os.walk(os.path.join(remote, "ops")))

    @staticmethod
    def drop(run_dir) -> None:
        shutil.rmtree(run_dir)



async def _build_remote(be, files: list, key: bytes, snapshots: int,
                        stride: int, batch: int, split: dict):
    """Write the remote folder; return the warm-up's in-memory mirror of
    the same blobs."""
    from crdt_enc_tpu_torch import (Core, HostAccelerator, MemoryRemote,
                                    MemoryStorage)

    t = time.perf_counter()
    writer = await Core.open(port.options(be.storage(be.base, "writer"),
                                          HostAccelerator(), key))
    sides = [be.side() for _ in range(snapshots)]
    main = be.storage(be.base, "writer")
    side_st = [be.storage(s, "writer") for s in sides]
    mirror = MemoryStorage(MemoryRemote())
    for b in range(0, len(files), batch):
        part = files[b:b + batch]
        blobs = await asyncio.gather(*(writer._seal(ops) for *_, ops in part))
        stores = []
        for (ai, ab, v, _), blob in zip(part, blobs):
            stores.append(main.store_ops(ab, v, blob))
            stores.append(mirror.store_ops(ab, v, blob))
            if v == 1 and ai % stride < snapshots:
                stores.append(side_st[ai % stride].store_ops(ab, v, blob))
        await asyncio.gather(*stores)
    split["remote_write_s"] = time.perf_counter() - t
    t = time.perf_counter()
    for i, s in enumerate(sides):
        sealer = await Core.open(port.options(be.storage(s, f"sealer{i}"),
                                              HostAccelerator(), key))
        await sealer.compact()
        await mirror.store_state(be.adopt_snapshot(s))
    mirror.remote.metas.update(be.metas())
    split["snapshot_compactions_s"] = time.perf_counter() - t
    return mirror.remote


def _merge_shape(cols, R: int, opf: int, S: int, stride: int) -> dict | None:
    """The dense stack the state merge is handed: S snapshots over the
    members live in them and the actors they cover (the replica's own
    empty state is not counted)."""
    if S < 1:
        return None
    kind, member, actor, counter = cols
    covered = (actor % stride < S) & (np.arange(len(actor)) % (
        len(actor) // R) < opf)
    part = ref_orset.fold((kind[covered], member[covered], actor[covered],
                           counter[covered]), R)
    cells = part["entries"] >> ref_orset.SHIFT
    return {"S": S, "E": int(len(np.unique(cells // R))),
            "R": int(len(np.unique(actor[covered])))}


async def _compact(storage, accel, key: bytes):
    from crdt_enc_tpu_torch import Core

    core = await Core.open(port.options(storage, accel, key))
    await core.compact()
    return core


def run(ctx) -> dict:
    import torch

    from crdt_enc_tpu_torch import MemoryStorage
    from crdt_enc_tpu_torch.utils import trace

    cfg, tr = ctx.config, ctx.traffic
    shape, widths = cfg["shape"], cfg["widths"]
    R, n = shape["replicas"], shape["ops_per_actor"]
    opf = shape["ops_per_file"]
    S, stride = _snapshots(tr)
    split: dict = {}

    t = time.perf_counter()
    cols = _columns(cfg, ctx.seed)
    actors = gen.actor_ids(ctx.seed, R)
    key = bytes(gen.rng_for(ctx.seed, 3).integers(0, 256, 32, dtype="u1"))
    files = gen.files(cols, actors, n, opf)
    ctx.check_counts(_measure(cols, cfg, tr), {**cfg["counts"], **tr["counts"]})
    split["generate_s"] = time.perf_counter() - t

    port.pin_widths(widths)
    be = FsRemote(ctx.scratch_dir())
    mirror = asyncio.run(_build_remote(be, files, key, S, stride,
                                       tr.get("write_batch", 1024), split))
    del files
    t = time.perf_counter()
    accel = port.card_accelerator(widths, ctx.device)
    split["library_load_s"] = time.perf_counter() - t  # the rest load in open

    def one(i: int):
        t0 = time.perf_counter()
        remote, handle = be.stage(i)
        storage = ctx.plant(be.storage(remote, f"local{i}"))
        staged = time.perf_counter() - t0
        gc.collect()
        with RssSampler() as rss:
            c0, t0 = time.process_time(), time.perf_counter()
            core = asyncio.run(_compact(storage, accel, key))
            wall = time.perf_counter() - t0
        cpus.append(time.process_time() - c0)
        return remote, handle, core, wall, rss.growth, staged

    cpus: list = []
    t = time.perf_counter()
    core = asyncio.run(_compact(MemoryStorage(mirror), accel, key))
    del core, mirror
    gc.collect()
    split["warmup_compaction_s"] = time.perf_counter() - t
    ctx.setup_done(split)

    walls, growths, staging, blobs = [], [], [], []
    ops_left = extra_states = failed = 0
    # the in-memory state judged: one of the first two compactions, drawn
    # from the seed (the last one, if the window holds fewer), kept as
    # arrays so that no large object graph slows the collector meanwhile
    index = {a: i for i, a in enumerate(actors)}
    mem_state, mem_at = None, int(ctx.rng(5).integers(0, 2))
    trace.reset()
    with ctx.fault_scope(), ctx.window() as win:
        i = 0
        while win.open():
            try:
                remote, handle, core, wall, growth, staged = one(i)
            except Exception as e:  # a failed compaction fails the run
                ctx.log(f"compaction {i} raised {type(e).__name__}: {e}")
                failed += 1
                i += 1
                continue
            walls.append(wall)
            growths.append(growth)
            staging.append(staged)
            states = be.states(remote)
            extra_states += abs(len(states) - 1)
            blobs.append(states[-1] if states else b"")
            ops_left += be.ops_left(remote)
            if i <= mem_at:
                mem_state = ref_orset.encode(core.with_state(port.plain_state),
                                             index, R)
            del core
            be.drop(handle)
            gc.collect()
            i += 1
    snap = trace.snapshot()
    memory_peak = torch.cuda.max_memory_allocated() if ctx.on_card else 0
    del accel
    gc.collect()
    ctx.log(f"window: {len(walls)} compactions, walls "
            f"{[round(w, 4) for w in walls]} s, RSS growth "
            f"{[round(g / 1e6, 1) for g in growths]} MB, staging "
            f"{[round(s, 3) for s in staging]} s, process CPU "
            f"{[round(c, 3) for c in cpus]} s")

    # the reference, once the window has closed and the program is freed
    t = time.perf_counter()
    ref = ref_orset.fold(cols, R)
    # each number is one the control moves: a snapshot that does not open
    # and a compaction that raised count every reference cell as off
    checks = {"snap_cells_off": 0, "snap_clock_off": 0}
    sample = ctx.rng(6).choice(len(blobs), min(2, len(blobs)), replace=False)
    for k in sorted(sample.tolist()):
        try:
            state_obj, cursor, _ = sealed.open_snapshot(blobs[k], key,
                                                        port.DATA_VERSION)
        except sealed.BadBlob as e:
            ctx.log(f"snapshot of compaction {k} does not open: {e}")
            state_obj, cursor = None, {}
        j = ref_orset.judge(ref, ref_orset.encode(state_obj, index, R))
        checks["snap_cells_off"] += j["cells_off"]
        checks["snap_clock_off"] += j["clock_off"] + ref_orset.clock_off(
            np.full(R, -(-n // opf)), cursor, index)
    checks["snap_cells_off"] += (failed + (0 if walls else 1)) * len(ref["entries"])
    j = ref_orset.judge(ref, mem_state)
    checks["mem_cells_off"] = j["cells_off"] + j["clock_off"]
    # what the GC should have removed: op files and superseded snapshots
    checks["files_left"] = ops_left + extra_states
    ctx.log(f"reference: {time.perf_counter() - t:.2f} s for "
            f"{len(sample)} sampled snapshots of {len(blobs)} and the "
            f"in-memory state of compaction {min(mem_at, len(walls) - 1)}")

    return {
        "end_to_end": {
            "compact_rss_mb": max(growths) / 1e6 if growths else None,
        },
        "walls": walls,
        "work": [cfg["counts"]["ops"]] * len(walls),
        "attempted": len(walls) + failed,
        "failed": failed,
        "checks": checks,
        "limits": {k: 0 for k in checks},
        "memory_peak_bytes": memory_peak,
        "units": len(walls),
        "spans": snap["spans"],
        "counters": snap["counters"],
        "shapes": {"merge": _merge_shape(cols, R, opf, S, stride)},
    }
