#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crdt_enc_tpu_torch) on one card.

The main workloads are BASELINE configs 3 and 4 at full width: the OR-Set
compaction path (1,000,000 add/remove ops over 10,000 replicas and 4,096
members, made from a seed by a copy of bench.py's ``gen_columns``: about
10% removes, dead removes as ``actor = R`` sentinel rows) and the LWW-map
fold (1,000,000 writes over 1,000,000 keys and 10,000 actors, a copy of
benchmarks/suite.py's config-4 generator), beside configs 1 and 2
(G-Counter 4 x 1k, PN-Counter 1k x 100k).  Phases:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every CUDA kernel from the sources in the checkout, with each
   kernel's registers, shared memory and spills from ``-Xptxas -v``;
3. OR-Set kernels against their plain PyTorch versions on the card at
   config-3 width (torch.equal: the planes are int32, the tolerance is
   exact) — both entries of the bucketed fold (``orset_scatter``, with and
   without the clock; ``orset_fold_cuda``) into empty planes, a second
   batch folded on top with ``retire_rm`` both ways, a hot-member and a
   hot-cell batch (half the rows on one member, on one cell), and the
   S = 8 merge of eight folded slices;
4. the OR-Set slice end to end: ``TorchAccelerator().fold_ops`` over the
   1M op objects and ``merge_states`` over eight folded slices, each
   byte-equal (canonical bytes) to the port's host loop, with every
   kernel's launch count read from that run alone (the fold entry exactly
   once, the merge at least once; the raw scatter is not on that path);
5. OR-Set times: median of 7 CUDA-event-timed single calls per kernel,
   its plain version and, for the raw scatter, ``scatter_reduce_(...,
   "amax")`` as the library yardstick, beside the least time the card
   allows (the fold timed into two distinct zero planes); for both fold
   entries also the per-call time over 20 back-to-back calls, the device
   time of each pass (torch.profiler), the host's enqueue time per call,
   and the skewed batches;
6. the LWW kernel against ``lww_fold_plain`` (torch.equal on every output)
   at config 4, on a heavy-tie batch with padding rows, on saturated
   timestamps and on 2^23 config-4 rows (past what the grid keeps in
   registers), each with ``num_values`` given and None, on both routes
   (shared-memory tile, global table) and in both modes (one packed word
   a key, two words) forced, and
   ``lww_fold_into(fold(first half), second half) == fold(whole)``;
7. LWW and counters end to end: ``fold_ops`` over the 1M config-4
   ``LWWOp`` objects, then a 200k tie-and-delete batch into that state,
   then configs 1 and 2, each byte-equal to the host loop, with the LWW
   kernel's launches read from the LWW run alone;
8. LWW times: the kernel (one launch) and its plain version on every
   batch, beside the bound; at config 4 and on the heavy-tie batch, per
   route and mode, the single call, the per-call time over 20 back-to-back calls,
   the host's enqueue time and the device time per launch; and the device
   time of a launch with no rows at the full grid (the barriers' cost);
9. K3's shape: 1M rows folded into empty planes at E = 4,096,
   R = 261,000 (where the TPU package leaves its ablk layout for
   ``_fold_wide``) by both entries and by the plain versions, compared
   plane for plane, with the device-memory peak and the fold's time;
10. compaction end to end: the config-3 rows as ~30k op files (48 ops a
   file, each within one actor, dense versions), sealed by the port's own
   ``Core`` into an encrypted ``FsStorage`` remote under the temporary
   directory, plus 8 snapshots sealed by 8 other replicas over the
   version-1 files of half the actors; ``Core.compact()`` from a fresh
   replica with ``TorchAccelerator`` (the snapshot merge launches K4
   once, the op files fold through ``fold_payloads`` and K2 once) and
   with ``HostAccelerator`` on a byte-identical copy; the two states
   byte-equal, and a third replica reads the compacted remote back; the
   wall of each compaction and its spans and counters;
then the kernels line and the result line.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
card.  Without a CUDA device, or without the package beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import uuid

import numpy as np

N_ROWS, N_REPLICAS, N_MEMBERS = 1_000_000, 10_000, 4096
SEED, SEED2 = 7, 8
MERGE_S = 8
REPS = 7

# BASELINE config 4 (benchmarks/suite.py bench_lwwmap) and the batches the
# LWW kernel is held against its plain version on
LWW_N, LWW_K, LWW_R, LWW_V, LWW_SEED = 1_000_000, 1_000_000, 10_000, 100, 4
TIE_N, TIE_K, TIE_R, TIE_V = 1_000_000, 1000, 16, 4
SAT_K = 100_000
PAST_N = 1 << 23  # config-4 rows past the grid's register residency
# the LWW kernel's routes, forced through its threshold, and its modes,
# forced through the widest word it packs
LWW_ROUTES = {"shared": 2**31 - 1, "global": 0}
LWW_MODES = {"one word": 64, "two words": 0}
LWW_PATHS = [(r, m) for r in LWW_ROUTES for m in LWW_MODES]
TIE_BATCH_N, TIE_BATCH_KEYS = 200_000, 50_000
HI31 = (1 << 31) - 1
# BASELINE configs 1 and 2 (benchmarks/suite.py bench_gcounter / _pncounter)
GC_N, GC_R = 1000, 4
PN_N, PN_R = 100_000, 1000
# phase 10: op files of the compaction remote and the snapshots beside them
COMPACT_OPS_PER_FILE = 48
COMPACT_SNAPSHOTS = 8
COMPACT_WRITE_BATCH = 1024
# K3's shape: 2·Ep·Rp = 2·4096·262,144 = 2^31 overflows the TPU ablk
# layout's int32 keys, so the JAX package folds it with _fold_wide
K3_E, K3_R, K3_SEED = 4096, 261_000, 9

# peak device-memory rates (NVIDIA data sheets); float32 outside the
# tensor cores is the table's nearest rate for the kernels' int32 ALU work
H100_SXM_BYTES_PER_S = 3.35e12
H100_PCIE_BYTES_PER_S = 2.0e12
H100_NVL_BYTES_PER_S = 3.9e12
CUDA_CORE_OPS_PER_S = 67e12


def gen_columns(N: int, R: int, E: int, seed: int = 7):
    """Vectorized op-stream generator (a copy of bench.py's): per-actor
    sequential add dots, ~10% removes whose horizon is the actor's
    add-count so far; removes before the actor ever added become
    ``actor = R`` sentinel rows."""
    rng = np.random.default_rng(seed)
    kind = (rng.random(N) < 0.10).astype(np.int8)
    member = rng.integers(0, E, N, dtype=np.int32)
    actor = rng.integers(0, R, N, dtype=np.int32)
    is_add = kind == 0
    order = np.argsort(actor, kind="stable")
    s_actor = actor[order]
    s_isadd = is_add[order].astype(np.int64)
    cum = np.cumsum(s_isadd)
    starts = np.searchsorted(s_actor, np.arange(R))
    first = np.minimum(starts, N - 1)
    base = np.where(starts < N, cum[first] - s_isadd[first], 0)
    within = cum - base[s_actor]
    counter = np.empty(N, np.int64)
    counter[order] = within
    counter = counter.astype(np.int32)
    dead_rm = (~is_add) & (counter == 0)
    actor = np.where(dead_rm, R, actor).astype(np.int32)
    return kind, member, actor, counter


def actor_ids(R: int) -> list:
    return [uuid.UUID(int=a + 1).bytes for a in range(R)]


def ops_from_columns(kind, member, actor, counter, actors: list):
    """Op objects for the rows, skipping sentinel rows: members are ints,
    actors 16-byte ids."""
    from crdt_enc_tpu_torch import AddOp, RmOp
    from crdt_enc_tpu_torch.models.vclock import Dot, VClock

    R = len(actors)
    ops = []
    for k, m, a, c in zip(kind.tolist(), member.tolist(), actor.tolist(),
                          counter.tolist()):
        if a >= R:
            continue
        if k == 0:
            ops.append(AddOp(m, Dot(actors[a], c)))
        else:
            ops.append(RmOp(m, VClock({actors[a]: c})))
    return ops


def device_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import torch

    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        return out[0]
    return f"{torch.cuda.get_device_name(0)}, power limit unavailable (no nvidia-smi)"


def fs_type(path: str) -> str:
    """The filesystem type of the mount holding ``path`` (/proc/mounts)."""
    best, kind = "", "unknown filesystem"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                parts = line.split()
                mnt = parts[1]
                if path.startswith(mnt.rstrip("/") + "/") and len(mnt) > len(best):
                    best, kind = mnt, f"{parts[2]} at {mnt}"
    except OSError:
        pass
    return kind


def memory_rate(name: str) -> float:
    if "PCIe" in name:
        return H100_PCIE_BYTES_PER_S
    if "NVL" in name:
        return H100_NVL_BYTES_PER_S
    return H100_SXM_BYTES_PER_S


def max_abs_err(ref, got) -> int:
    return max(int((r.long() - g.long()).abs().max()) if r.numel() else 0
               for r, g in zip(ref, got))


def check_equal(what: str, ref, got, errs: dict, key: str) -> None:
    import torch

    same = all(r.dtype == g.dtype and torch.equal(r, g)
               for r, g in zip(ref, got))
    err = 0 if same else max(max_abs_err(ref, got), 1)
    errs[key] = max(errs.get(key, 0), err)
    print(f"  {what}: equal={same} max_abs_err={err}", flush=True)
    if not same:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")


def skewed_columns(cols, R: int, seed: int = 3) -> dict:
    """name -> config-3 columns with half the rows bent onto one member
    (member 3) or onto one cell (member 5, actor 7; sentinel rows stay
    sentinels)."""
    kind, member, actor, counter = cols
    half = np.random.default_rng(seed).random(len(kind)) < 0.5
    hot_cell_actor = np.where(half & (actor < R), 7, actor).astype(np.int32)
    return {
        "hot member": (kind, np.where(half, 3, member).astype(np.int32),
                       actor, counter),
        "hot cell": (kind, np.where(half, 5, member).astype(np.int32),
                     hot_cell_actor, counter),
    }


def check_entries(label: str, dev, E: int, R: int, errs: dict, planes=None,
                  retire_rm: bool = True):
    """Both entries of the bucketed fold against their plain versions on
    one batch: the raw scatter (with the clock it raises) and the fold
    (into empty planes unless ``planes`` is given).  Returns the fold."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F

    kw = dict(num_members=E, num_replicas=R)
    if planes is None:
        z = torch.zeros((E, R), dtype=torch.int32, device=dev[0].device)
        planes = (torch.zeros(R, dtype=torch.int32, device=z.device), z, z)
    ref = P.orset_scatter_plain(*dev, **kw)
    check_equal(f"orset_scatter ({label})", ref,
                F.orset_scatter(*dev, **kw), errs, "orset_scatter")
    clock = planes[0].clone()
    got = F.orset_scatter(*dev, **kw, clock=clock)
    check_equal(f"orset_scatter with clock ({label})",
                (*ref, P.orset_fold_clock_plain(planes[0], ref[0])),
                (*got, clock), errs, "orset_scatter")
    del ref, got
    ref = P.orset_fold_plain(*planes, *dev, **kw, retire_rm=retire_rm)
    got = F.orset_fold_cuda(*planes, *dev, **kw, retire_rm=retire_rm)
    check_equal(f"orset_fold ({label}, retire_rm={retire_rm})", ref, got,
                errs, "orset_fold")
    del ref
    return got


def phase_kernels(cols, cols2, E: int, R: int, device):
    """Each kernel against its plain version at the given width.  Returns
    (max_abs_err per kernel, the fold inputs, the S-way merge stacks, the
    skewed batches on the card)."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    errs: dict = {}
    dev = [torch.from_numpy(x).to(device) for x in cols]
    z = torch.zeros((E, R), dtype=torch.int32, device=device)
    clock0 = torch.zeros(R, dtype=torch.int32, device=device)

    fold1 = check_entries("seed 7, empty planes", dev, E, R, errs)
    dev2 = [torch.from_numpy(x).to(device) for x in cols2]
    for retire in (True, False):
        check_entries("seed 8 onto seed 7", dev2, E, R, errs, planes=fold1,
                      retire_rm=retire)
        # the dispatch the accelerator calls
        ref = P.orset_fold_plain(*fold1, *dev2, num_members=E, num_replicas=R,
                                 retire_rm=retire)
        got = P.orset_fold(*fold1, *dev2, num_members=E, num_replicas=R,
                           retire_rm=retire)
        check_equal(f"ops.orset.orset_fold (seed 8 onto seed 7, "
                    f"retire_rm={retire})", ref, got, errs, "orset_fold")
        del ref, got
    del dev2
    skewed = {}
    for name, skew in skewed_columns(cols, R).items():
        skewed[name] = [torch.from_numpy(x).to(device) for x in skew]
        check_entries(name, skewed[name], E, R, errs)

    # S disjoint contiguous slices of the rows, each folded into empty planes
    N = len(cols[0])
    bounds = np.linspace(0, N, MERGE_S + 1).astype(int)
    states = [P.orset_fold(clock0, z, z, *(x[lo:hi] for x in dev),
                           num_members=E, num_replicas=R)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    stacks = [torch.stack([s[i] for s in states]) for i in range(3)]
    del states
    got = M.orset_merge_many_cuda(*stacks)
    ref = P.orset_merge_many_tree(*stacks)
    check_equal(f"merge (S={MERGE_S})", ref, got, errs, "orset_merge_many")
    del got, ref
    return errs, (clock0, z, dev, fold1), stacks, skewed


def phase_end_to_end(cols, E: int, R: int, device):
    """The slice through its entry points: fold_ops over the op objects and
    merge_states over eight folded slices, each held byte for byte against
    the port's host loop.  Returns the launch counts of this run.  (Each
    125k-op slice is sparse against the 41M-cell planes, so its fold_ops
    takes the host route, as in the JAX package.)"""
    from crdt_enc_tpu_torch import HostAccelerator, ORSet, TorchAccelerator
    from crdt_enc_tpu_torch import canonical_bytes
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M
    from crdt_enc_tpu_torch.utils import trace

    actors = actor_ids(R)
    N = len(cols[0])
    bounds = np.linspace(0, N, MERGE_S + 1).astype(int)
    t0 = time.perf_counter()
    slices = [ops_from_columns(*(x[lo:hi] for x in cols), actors)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    ops = [op for sl in slices for op in sl]
    print(f"  {len(ops)} op objects built in {time.perf_counter() - t0:.2f}s",
          flush=True)
    accel = TorchAccelerator(device=device)

    for counts in (F.launches, M.launches):
        for k in counts:
            counts[k] = 0
    trace.reset()
    t0 = time.perf_counter()
    folded = accel.fold_ops(ORSet(), ops)
    fold_s = time.perf_counter() - t0
    snap = trace.snapshot()
    parts = [accel.fold_ops(ORSet(), sl) for sl in slices]
    t0 = time.perf_counter()
    merged = accel.merge_states(ORSet.from_obj(parts[0].to_obj()),
                                [ORSet.from_obj(p.to_obj()) for p in parts[1:]])
    merge_s = time.perf_counter() - t0
    launches = {**F.launches, **M.launches}
    merge_snap = trace.snapshot()

    print(f"  fold_ops wall {fold_s:.3f}s; merge_states wall {merge_s:.3f}s",
          flush=True)
    for name, v in sorted(snap["spans"].items()):
        print(f"    span {name}: {v['seconds'] * 1e3:.1f} ms x{v['count']}")
    print(f"    h2d_bytes {snap['counters'].get('h2d_bytes', 0)}")
    for name, v in sorted(merge_snap["spans"].items()):
        if name.startswith("merge."):
            print(f"    span {name}: {v['seconds'] * 1e3:.1f} ms x{v['count']}")
    print(f"  launches on the slice path: {launches}", flush=True)

    t0 = time.perf_counter()
    host = HostAccelerator().fold_ops(ORSet(), ops)
    host_fold_s = time.perf_counter() - t0
    fb, hb = canonical_bytes(folded), canonical_bytes(host)
    print(f"  fold_ops bytes equal to host loop: {fb == hb} "
          f"({len(fb)} bytes; host loop {host_fold_s:.2f}s)", flush=True)
    if fb != hb:
        raise AssertionError("fold_ops disagrees with the host loop")
    host_m = HostAccelerator().merge_states(
        ORSet.from_obj(parts[0].to_obj()),
        [ORSet.from_obj(p.to_obj()) for p in parts[1:]])
    mb, hmb = canonical_bytes(merged), canonical_bytes(host_m)
    print(f"  merge_states bytes equal to host loop: {mb == hmb} "
          f"({len(mb)} bytes)", flush=True)
    if mb != hmb:
        raise AssertionError("merge_states disagrees with the host loop")
    if launches["orset_fold"] != 1 or launches["orset_merge_many"] == 0:
        raise AssertionError("the slice path did not launch the fold entry "
                             f"once and the merge: {launches}")
    return launches


def time_ms(fn) -> float:
    """Median of REPS CUDA-event-timed calls, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_stream_ms(fn, calls: int = 20) -> float:
    """Per-call time of ``calls`` back-to-back calls between two CUDA
    events (the host enqueues ahead while the card works), after a warm-up
    call: the card's throughput where a single call's event window also
    holds the host's enqueue time."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def host_enqueue_ms(fn, calls: int = 20) -> float:
    """Host time to enqueue one call, back to back with no synchronize (the
    card's queue absorbs them)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return enqueue


def phase_times(fold_inputs, stacks, skewed, E: int, R: int, rate: float):
    """Kernel, plain and library times at the config-3 shape, with each
    function's bound from the bytes it must move (every input read once,
    every output written once) and the int32 operations it does; the
    device time of each pass; the skewed batches."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    clock0, z, dev, fold1 = fold_inputs
    z2 = torch.zeros_like(z)  # add0 and rm0 distinct, as the bound counts
    kind, member, actor, counter = dev
    N = kind.shape[0]
    S = stacks[1].shape[0]
    kw = dict(num_members=E, num_replicas=R)

    # the library yardstick: one scatter_reduce_ into a zeroed flat target
    # (row masks and segment ids precomputed, outside the timing); like
    # K1, it computes the two planes and no clock
    valid = (actor < R)
    is_rm = (kind == 1) & valid
    seg = (member.long() * R + actor.long().clamp(max=R - 1))
    seg2 = torch.where(is_rm, seg + E * R, seg)
    vals = torch.where(((kind == 0) | is_rm) & valid, counter,
                       torch.zeros_like(counter))

    def library_scatter():
        return torch.zeros(2 * E * R, dtype=torch.int32, device=kind.device
                           ).scatter_reduce_(0, seg2, vals, reduce="amax")

    cells = E * R
    rows = {
        "orset_scatter": dict(
            kernel=lambda: F.orset_scatter(*dev, **kw),
            plain=lambda: P.orset_scatter_plain(*dev, **kw),
            library=library_scatter,
            bytes=13 * N + 2 * cells * 4,
            ops=3 * N),
        "orset_fold": dict(
            kernel=lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw),
            plain=lambda: P.orset_fold_plain(clock0, z, z2, *dev, **kw),
            library=None,
            bytes=4 * cells * 4 + 13 * N + 2 * R * 4,
            ops=8 * cells + 3 * N),
        "orset_merge_many": dict(
            kernel=lambda: M.orset_merge_many_cuda(*stacks),
            plain=lambda: P.orset_merge_many_tree(*stacks),
            library=None,
            bytes=(S + 1) * 2 * cells * 4 + 3 * S * R * 4,
            ops=12 * (S - 1) * cells),
    }
    out = {}
    for name, r in rows.items():
        ms = time_ms(r["kernel"])
        plain_ms = time_ms(r["plain"])
        lib_ms = time_ms(r["library"]) if r["library"] else None
        bytes_ms = r["bytes"] / rate * 1e3
        ops_ms = r["ops"] / CUDA_CORE_OPS_PER_S * 1e3
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        lib = f"{lib_ms:.4f}" if lib_ms is not None else "n/a"
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib} ms, bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}: {r['bytes'] / 1e6:.1f} MB)", flush=True)
        if name != "orset_merge_many":
            out[name]["back_to_back_ms"] = time_stream_ms(r["kernel"])
            line = (f"    per call over 20 back-to-back calls: kernel "
                    f"{out[name]['back_to_back_ms']:.4f} ms")
            if r["library"]:
                out[name]["library_back_to_back_ms"] = time_stream_ms(
                    r["library"])
                line += (f", library "
                         f"{out[name]['library_back_to_back_ms']:.4f} ms")
            print(line, flush=True)

    scatter_clock_ms = time_ms(
        lambda: F.orset_scatter(*dev, **kw, clock=clock0.clone()))
    out["orset_scatter"]["with_clock_ms"] = scatter_clock_ms
    print(f"  orset_scatter raising a clock too: {scatter_clock_ms:.4f} ms",
          flush=True)
    print("    device time per call: " + device_breakdown(
        lambda: F.orset_scatter(*dev, **kw)), flush=True)
    print("  orset_fold device time per call: " + device_breakdown(
        lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw)), flush=True)
    same_ms = time_ms(lambda: F.orset_fold_cuda(clock0, z, z, *dev, **kw))
    out["orset_fold"]["one_zero_plane_as_add0_and_rm0_ms"] = same_ms
    print(f"  orset_fold with one zero plane as add0 and rm0 (read once; how "
          f"earlier runs timed the fold): {same_ms:.4f} ms", flush=True)
    for name, r in rows.items():
        if name == "orset_merge_many":
            continue
        enqueue = host_enqueue_ms(r["kernel"])
        out[name]["host_enqueue_ms"] = enqueue
        line = f"  {name} host enqueue time per call: {enqueue:.4f} ms"
        if r["library"]:
            lib_enqueue = host_enqueue_ms(r["library"])
            out[name]["library_host_enqueue_ms"] = lib_enqueue
            line += f" (library {lib_enqueue:.4f} ms)"
        print(line, flush=True)
    prior_ms = time_ms(lambda: F.orset_fold_cuda(*fold1, *dev, **kw))
    out["orset_fold"]["onto_prior_state_ms"] = prior_ms
    print(f"  orset_fold onto the seed-7 state (distinct add0 and rm0 "
          f"planes): {prior_ms:.4f} ms", flush=True)
    for name, sk in skewed.items():
        fold_ms = time_ms(lambda: F.orset_fold_cuda(clock0, z, z2, *sk, **kw))
        scatter_ms = time_ms(lambda: F.orset_scatter(*sk, **kw))
        out["orset_fold"][name.replace(" ", "_") + "_ms"] = fold_ms
        out["orset_scatter"][name.replace(" ", "_") + "_ms"] = scatter_ms
        print(f"  {name}: orset_fold {fold_ms:.4f} ms, orset_scatter "
              f"{scatter_ms:.4f} ms", flush=True)
        print("    orset_fold device time per call: " + device_breakdown(
            lambda: F.orset_fold_cuda(clock0, z, z2, *sk, **kw)), flush=True)
    return out


# ---- LWW map and counters (BASELINE configs 4, 1 and 2) --------------------


def running_count(group: np.ndarray, n_groups: int) -> np.ndarray:
    """1-based running occurrence count per group id, in row order (a copy
    of benchmarks/suite.py's)."""
    n = len(group)
    order = np.argsort(group, kind="stable")
    g = group[order]
    cum = np.arange(1, n + 1, dtype=np.int64)
    base = np.searchsorted(g, np.arange(n_groups))[g]
    out = np.empty(n, np.int64)
    out[order] = cum - base
    return out.astype(np.int32)


def gen_lww(N: int, K: int, R: int, seed: int = LWW_SEED):
    """Config-4 writes (a copy of benchmarks/suite.py's generator): keys
    uniform over K, timestamps uniform in [1, 2^40), values in [0, 100)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, K, N, dtype=np.int32)
    ts = rng.integers(1, 1 << 40, N, dtype=np.int64)
    actor = rng.integers(0, R, N, dtype=np.int32)
    value = rng.integers(0, 100, N, dtype=np.int32)
    return key, ts, actor, value


def lww_batches():
    """name -> (int32 columns key, ts_hi, ts_lo, actor, value; K; V)."""
    from crdt_enc_tpu_torch.ops.lww import ts_split

    key, ts, actor, value = gen_lww(LWW_N, LWW_K, LWW_R)
    out = {"config 4": ((key, *ts_split(ts), actor, value), LWW_K, LWW_V)}
    rng = np.random.default_rng(5)
    key = rng.integers(0, TIE_K, TIE_N, dtype=np.int32)
    key = np.where(rng.random(TIE_N) < 0.05, TIE_K, key).astype(np.int32)
    hi, lo = ts_split(rng.integers(0, 4, TIE_N))
    out["heavy ties, 5% padding"] = (
        (key, hi, lo, rng.integers(0, TIE_R, TIE_N, dtype=np.int32),
         rng.integers(0, TIE_V, TIE_N, dtype=np.int32)), TIE_K, TIE_V)
    rng = np.random.default_rng(6)
    n = LWW_N
    hi = np.where(rng.random(n) < 0.5, HI31 - rng.integers(0, 4, n),
                  rng.integers(0, HI31, n, endpoint=True)).astype(np.int32)
    out["saturated ts_lo, ts_hi to 2^31-1"] = (
        (rng.integers(0, SAT_K, n, dtype=np.int32), hi,
         np.full(n, HI31, np.int32),
         rng.integers(0, LWW_R, n, dtype=np.int32),
         rng.integers(0, LWW_V, n, dtype=np.int32)), SAT_K, LWW_V)
    key, ts, actor, value = gen_lww(PAST_N, LWW_K, LWW_R, seed=10)
    out["2^23 rows, past register residency"] = (
        (key, *ts_split(ts), actor, value), LWW_K, LWW_V)
    return out


@contextlib.contextmanager
def lww_path(route: str, mode: str):
    """Force the LWW kernel's route (through its threshold) and mode
    (through the widest word it packs; data whose widths do not fit take
    two words either way)."""
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    saved = LC.SHARED_KEYS_MAX, LC.PACK_BITS
    LC.SHARED_KEYS_MAX, LC.PACK_BITS = LWW_ROUTES[route], LWW_MODES[mode]
    try:
        yield
    finally:
        LC.SHARED_KEYS_MAX, LC.PACK_BITS = saved


def phase_lww_kernels(device):
    """The LWW kernel against ``lww_fold_plain`` on every batch, in both
    modes and on both routes, and the incremental fold against the whole.
    Returns (max_abs_err per kernel, name -> (device columns, K, V))."""
    import torch

    from crdt_enc_tpu_torch.ops import lww as L
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    errs: dict = {}
    batches = {}
    for name, (cols, K, V) in lww_batches().items():
        dev = [torch.from_numpy(x).to(device) for x in cols]
        default = "shared" if LC.lww_tile(K) else "global"
        for nv in (V, None):
            ref = L.lww_fold_plain(*dev, num_keys=K, num_values=nv)
            for route, mode in LWW_PATHS:
                with lww_path(route, mode):
                    geo = LC.plan(len(cols[0]), K, dev[0].device)
                    got = LC.lww_fold_cuda(*dev, num_keys=K, num_values=nv)
                check_equal(
                    f"lww_fold ({name}, N={len(cols[0])}, K={K}, "
                    f"num_values={nv}, route={route}"
                    f"{' (its default)' if route == default else ''}, "
                    f"{mode}; "
                    f"{geo.blocks} blocks x {LC.THREADS} threads x "
                    f"{geo.rows_per_thread} rows, {geo.chunks} chunks, "
                    f"{geo.tile_keys} tile keys)", ref, got, errs, "lww_fold")
                del got
            del ref
        h = len(cols[0]) // 2
        whole = LC.lww_fold_cuda(*dev, num_keys=K, num_values=V)
        into = L.lww_fold_into(
            LC.lww_fold_cuda(*(x[:h] for x in dev), num_keys=K, num_values=V),
            *(x[h:] for x in dev), num_keys=K, num_values=V)
        check_equal(f"lww_fold_into(fold(first half), second half) == "
                    f"fold(whole) ({name})", whole, into, errs, "lww_fold")
        print(f"    {int(whole[4].sum())} of {K} keys present", flush=True)
        batches[name] = (dev, K, V)
    return errs, batches


def lww_tie_ops(entries: dict, actors: list, n: int, seed: int = 12):
    """A batch that collides with a populated state: keys drawn from the
    first TIE_BATCH_KEYS of its entries (about four rows a key), each row's
    timestamp within one tick of the entry's, its actor and value the
    entry's half the time each, a quarter of the rows deletes, and a tenth
    of the rows on keys the state does not hold."""
    from crdt_enc_tpu_torch import LWWOp

    rng = np.random.default_rng(seed)
    keys = list(entries)[:TIE_BATCH_KEYS]
    cols = zip(rng.integers(0, len(keys), n).tolist(),
               rng.integers(-1, 2, n).tolist(),
               (rng.random(n) < 0.5).tolist(), (rng.random(n) < 0.5).tolist(),
               (rng.random(n) < 0.25).tolist(), (rng.random(n) < 0.1).tolist(),
               rng.integers(0, 16, n).tolist(), rng.integers(0, 100, n).tolist())
    ops = []
    for i, dts, same_a, same_v, delete, fresh, a, v in cols:
        k = keys[i]
        ts0, a0, v0, tomb0 = entries[k]
        if fresh:
            k, ts0 = f"fresh{i % 1000}", 1 << 30
        actor = a0 if same_a and not fresh else actors[a]
        ts = max(ts0 + dts, 0)
        if delete:
            ops.append(LWWOp(k, ts, actor, None, True))
        else:
            val = v0 if same_v and not tomb0 and not fresh else v
            ops.append(LWWOp(k, ts, actor, val))
    return ops


def print_fold(label: str, wall_s: float, snap: dict) -> None:
    print(f"  {label}: fold_ops wall {wall_s:.4f}s", flush=True)
    for name, v in sorted(snap["spans"].items()):
        print(f"    span {name}: {v['seconds'] * 1e3:.2f} ms x{v['count']}")
    print(f"    h2d_bytes {snap['counters'].get('h2d_bytes', 0)}", flush=True)


def compare_bytes(label: str, got, host) -> None:
    from crdt_enc_tpu_torch import canonical_bytes

    gb, hb = canonical_bytes(got), canonical_bytes(host)
    print(f"  {label}: bytes equal to host loop: {gb == hb} ({len(gb)} bytes)",
          flush=True)
    if gb != hb:
        raise AssertionError(f"{label}: fold_ops disagrees with the host loop")


def timed_fold(accel, state, ops):
    from crdt_enc_tpu_torch.utils import trace

    trace.reset()
    t0 = time.perf_counter()
    out = accel.fold_ops(state, ops)
    return out, time.perf_counter() - t0, trace.snapshot()


def phase_lww_end_to_end(device):
    """The LWW-map path through ``fold_ops``: config 4 into an empty state,
    then a tie-and-delete batch into that state, each held byte for byte
    against the port's host loop.  Returns the LWW kernel's launches in
    these two folds."""
    from crdt_enc_tpu_torch import HostAccelerator, LWWMap, LWWOp, TorchAccelerator
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    key, ts, actor, value = gen_lww(LWW_N, LWW_K, LWW_R)
    actors = actor_ids(LWW_R)
    t0 = time.perf_counter()
    ops = [LWWOp(k, t, actors[a], v) for k, t, a, v in zip(
        key.tolist(), ts.tolist(), actor.tolist(), value.tolist())]
    print(f"  {len(ops)} LWWOp objects built in {time.perf_counter() - t0:.2f}s",
          flush=True)
    accel = TorchAccelerator(device=device)

    LC.launches["lww_fold"] = 0
    state, wall, snap = timed_fold(accel, LWWMap(), ops)
    launches_cfg4 = LC.launches["lww_fold"]
    print_fold("config 4 (1M writes, empty state)", wall, snap)
    t0 = time.perf_counter()
    host = HostAccelerator().fold_ops(LWWMap(), ops)
    print(f"    host loop {time.perf_counter() - t0:.2f}s; "
          f"{len(host.entries)} entries; state._mut {state._mut}", flush=True)
    compare_bytes("config 4", state, host)

    ties = lww_tie_ops(host.entries, actors, TIE_BATCH_N)
    LC.launches["lww_fold"] = 0
    state, wall, snap = timed_fold(accel, state, ties)
    launches_ties = LC.launches["lww_fold"]
    print_fold(f"tie batch ({len(ties)} ops, 25% deletes, into the config-4 "
               "state)", wall, snap)
    host = HostAccelerator().fold_ops(host, ties)
    print(f"    {sum(e[3] for e in host.entries.values())} tombstones; "
          f"state._mut {state._mut}", flush=True)
    compare_bytes("tie batch", state, host)
    print(f"  lww_fold launches: {launches_cfg4} (config 4), {launches_ties} "
          "(tie batch)", flush=True)
    if launches_cfg4 == 0 or launches_ties == 0:
        raise AssertionError("lww_fold never launched on the LWW path")
    return launches_cfg4 + launches_ties


def phase_counters_end_to_end(device):
    """Configs 1 and 2 through ``fold_ops`` (plain PyTorch on the card: the
    JAX package folds counters in XLA, with no Pallas kernel), into an empty
    state and again (a full replay) into the folded state."""
    from crdt_enc_tpu_torch import (
        Dot, GCounter, HostAccelerator, PNCounter, TorchAccelerator,
    )

    accel = TorchAccelerator(device=device, min_device_batch=1)
    rng = np.random.default_rng(1)
    actor = rng.integers(0, GC_R, GC_N, dtype=np.int32)
    counter = running_count(actor, GC_R)
    actors = actor_ids(GC_R)
    g_ops = [Dot(actors[a], c) for a, c in zip(actor.tolist(), counter.tolist())]
    rng = np.random.default_rng(2)
    actor = rng.integers(0, PN_R, PN_N, dtype=np.int32)
    sign = (rng.random(PN_N) < 0.3).astype(np.int8)
    counter = running_count(actor * 2 + sign, PN_R * 2)
    actors = actor_ids(PN_R)
    pn_ops = [(s, Dot(actors[a], c)) for a, s, c in zip(
        actor.tolist(), sign.tolist(), counter.tolist())]
    for label, cls, ops in (
        (f"config 1 (G-Counter, {GC_R} replicas, {GC_N} ops)", GCounter, g_ops),
        (f"config 2 (PN-Counter, {PN_R} replicas, {PN_N} ops)", PNCounter,
         pn_ops),
    ):
        accel.fold_ops(cls(), ops[:10])  # first-call set-up, untimed
        state, wall, snap = timed_fold(accel, cls(), ops)
        print_fold(label, wall, snap)
        t0 = time.perf_counter()
        host = HostAccelerator().fold_ops(cls(), ops)
        print(f"    host loop {time.perf_counter() - t0:.4f}s; read() "
              f"{state.read()}", flush=True)
        compare_bytes(label, state, host)
        state, wall, snap = timed_fold(accel, state, ops)
        print_fold(label + ", replayed into the folded state", wall, snap)
        compare_bytes(label + " replayed", state,
                      HostAccelerator().fold_ops(host, ops))


def device_times(fn, calls: int = 5) -> dict | str:
    """Mean device µs per launch of each CUDA kernel and memset of ``fn``,
    from torch.profiler's CUPTI trace, by kernel name (averaged over the
    launches the trace recorded, which may be fewer than were made); a
    "not measured" string where the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for evt in prof.key_averages():
            dev_us = getattr(evt, "device_time_total",
                             getattr(evt, "cuda_time_total", 0))
            if dev_us > 0:
                key = evt.key.replace("(anonymous namespace)::", "")
                key = key.split("(")[0].removeprefix("void ")
                out[key[:40]] = dev_us / max(evt.count, 1)
        return out or "not measured (no device time traced)"
    except Exception as exc:  # the profiler is a diagnostic only
        return f"not measured ({type(exc).__name__}: {exc})"


def device_breakdown(fn, calls: int = 5) -> str:
    """``device_times`` as one line."""
    got = device_times(fn, calls)
    if isinstance(got, str):
        return got
    return "; ".join(f"{k} {us:.1f} us" for k, us in got.items())


def lww_path_times(dev, K: int, V: int) -> dict:
    """The LWW kernel on one batch with each route and mode forced: the
    single call, the per-call time over 20 back-to-back calls, the host's
    enqueue time per call, the device time per launch and the launch
    geometry."""
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    out = {}
    for route, mode in LWW_PATHS:
        with lww_path(route, mode):
            def fn():
                return LC.lww_fold_cuda(*dev, num_keys=K, num_values=V)

            geo = LC.plan(dev[0].shape[0], K, dev[0].device)
            r = out[f"{route}, {mode}"] = dict(
                ms=time_ms(fn), back_to_back_ms=time_stream_ms(fn),
                host_enqueue_ms=host_enqueue_ms(fn), device_us=device_times(fn),
                geometry=geo._asdict())
        dev_us = r["device_us"]
        if not isinstance(dev_us, str):
            dev_us = "; ".join(f"{k} {us:.2f} us" for k, us in dev_us.items())
        print(f"    route {route}, {mode}: single call {r['ms']:.4f} ms, back to back "
              f"{r['back_to_back_ms']:.4f} ms, host enqueue "
              f"{r['host_enqueue_ms']:.4f} ms; device {dev_us} "
              f"({geo.blocks} blocks, {geo.rows_per_thread} rows a thread, "
              f"{geo.chunks} chunks, {geo.tile_keys} tile keys)", flush=True)
    return out


def lww_barrier_probe(device) -> dict:
    """Device time of a launch with no rows and four keys, on one block
    and at each route's full grid: the difference is what the three grid
    barriers cost across the whole grid (and the wider launch)."""
    import torch

    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    empty = [torch.empty(0, dtype=torch.int32, device=device)] * 5
    out = {}
    for route, tile in (("global", 0), ("shared", 4)):
        sms, per_sm = LC.occupancy(empty[0].device, tile)
        one = LC.lww_geometry(0, 4, tile, sms, per_sm)
        for geo in (one, one._replace(blocks=sms * per_sm)):
            label = f"{route} route, {geo.blocks} blocks"
            out[label] = device_times(lambda g=geo: LC.launch(empty, 4, g),
                                      calls=20)
            print(f"    empty launch, {label}: {out[label]}", flush=True)
    return out


def phase_lww_times(batches: dict, rate: float):
    """The LWW kernel (one launch) and its plain version on each batch,
    beside the bound; at config 4 and on the heavy-tie batch the times of
    each route; at config 4 also without ``num_values`` and pass 1 alone
    through ``scatter_reduce_`` as a yardstick; the barrier probe.
    Returns config 4's row of the kernels line."""
    import torch

    from crdt_enc_tpu_torch.ops import lww as L
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC

    out = None
    for name, (dev, K, V) in batches.items():
        N = dev[0].shape[0]
        ms = time_ms(lambda: LC.lww_fold_cuda(*dev, num_keys=K, num_values=V))
        plain_ms = time_ms(lambda: L.lww_fold_plain(*dev, num_keys=K,
                                                    num_values=V))
        nbytes = 20 * N + 17 * K
        bytes_ms = nbytes / rate * 1e3
        ops_ms = 4 * N / CUDA_CORE_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        default = "shared" if LC.lww_tile(K) else "global"
        print(f"  lww_fold ({name}, num_values={V}, default route {default}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
        if out is not None:
            slug = re.sub(r"[^a-z0-9]+", "_", name.lower()).strip("_")
            out[f"{slug}_ms"] = ms
            out[f"{slug}_plain_ms"] = plain_ms
            out[f"{slug}_bound_ms"] = bound_ms
            if K == TIE_K:
                out[f"{slug}_routes"] = lww_path_times(dev, K, V)
            continue
        routes = lww_path_times(dev, K, V)
        out = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   default_route=default,
                   back_to_back_ms=routes[f"{default}, one word"]
                   ["back_to_back_ms"],
                   host_enqueue_ms=routes[f"{default}, one word"]
                   ["host_enqueue_ms"],
                   device_us=routes[f"{default}, one word"]["device_us"],
                   routes=routes)
        out["unpacked_ms"] = time_ms(lambda: LC.lww_fold_cuda(*dev, num_keys=K))
        out["plain_unpacked_ms"] = time_ms(
            lambda: L.lww_fold_plain(*dev, num_keys=K))
        key, hi, lo = dev[:3]
        packed_ts = ((hi.long() << 31) | lo.long()) + 1
        idx = key.long()
        out["pass1_scatter_reduce_ms"] = time_ms(
            lambda: torch.zeros(K, dtype=torch.int64, device=key.device
                                ).scatter_reduce_(0, idx, packed_ts,
                                                  reduce="amax"))
        print(f"    num_values=None: kernel {out['unpacked_ms']:.4f} ms, plain "
              f"{out['plain_unpacked_ms']:.4f} ms", flush=True)
        print(f"    pass 1 alone as scatter_reduce_(amax) of the packed "
              f"timestamp (no library call computes the whole winner): "
              f"{out['pass1_scatter_reduce_ms']:.4f} ms", flush=True)
        print("    device time per launch: " + device_breakdown(
            lambda: LC.lww_fold_cuda(*dev, num_keys=K, num_values=V)),
            flush=True)
    out["barrier_probe_us"] = lww_barrier_probe(batches["config 4"][0][0].device)
    return out


def phase_k3(device, rate: float):
    """1M rows into empty planes at K3's shape, by both entries and by
    their plain versions; the planes compared with torch.equal.  Returns
    (max_abs_err per entry, the times and the memory peak)."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F

    E, R, N = K3_E, K3_R, N_ROWS
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"  device memory in use before: "
          f"{torch.cuda.memory_allocated() / 1e9:.3f} GB", flush=True)
    cols = gen_columns(N, R, E, K3_SEED)
    dev = [torch.from_numpy(x).to(device) for x in cols]
    clock0 = torch.zeros(R, dtype=torch.int32, device=device)
    z = torch.zeros((E, R), dtype=torch.int32, device=device)
    kw = dict(num_members=E, num_replicas=R)
    errs: dict = {}
    for retire in (True, False):
        got = F.orset_fold_cuda(clock0, z, z, *dev, **kw, retire_rm=retire)
        ref = P.orset_fold_plain(clock0, z, z, *dev, **kw, retire_rm=retire)
        check_equal(f"orset_fold at E={E}, R={R}, N={N}, retire_rm={retire}",
                    ref, got, errs, "orset_fold")
        print(f"    {int((got[1] > 0).sum())} live add cells, "
              f"{int((got[2] > 0).sum())} live horizons", flush=True)
        del ref, got
    ref = P.orset_scatter_plain(*dev, **kw)
    got = F.orset_scatter(*dev, **kw)
    check_equal(f"orset_scatter at E={E}, R={R}, N={N}", ref, got, errs,
                "orset_scatter")
    del ref, got
    peak = torch.cuda.max_memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"    peak device memory {peak / 1e9:.3f} GB of {total / 1e9:.1f} GB",
          flush=True)
    if peak > 0.9 * total:
        raise AssertionError("K3 check peaked too close to the card's memory")
    z2 = torch.zeros_like(z)  # add0 and rm0 distinct, as the bound counts
    fold_ms = time_ms(lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw))
    plain_ms = time_ms(lambda: P.orset_fold_plain(clock0, z, z2, *dev, **kw))
    same_ms = time_ms(lambda: F.orset_fold_cuda(clock0, z, z, *dev, **kw))
    nbytes = 2 * (2 * E * R * 4) + 13 * N + 2 * 4 * R
    bound_ms = nbytes / rate * 1e3
    print(f"  orset_fold at K3's shape: {fold_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"(bench.py bytes model: {nbytes / 1e9:.3f} GB); with one zero "
          f"plane as add0 and rm0 (how earlier runs timed it): {same_ms:.4f} ms",
          flush=True)
    print("    device time per call: " + device_breakdown(
        lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw), calls=2),
        flush=True)
    return errs, dict(E=E, R=R, N=N, fold_ms=fold_ms, fold_plain_ms=plain_ms,
                      one_zero_plane_as_add0_and_rm0_ms=same_ms,
                      bound_ms=bound_ms, peak_bytes=peak,
                      match=max(errs.values()) == 0)


# ---- compaction end to end (phase 10) --------------------------------------


def compaction_files(cols, actors: list) -> list:
    """Config-3 rows as op files (the bench.py e2e pattern): live rows
    grouped by actor, up to COMPACT_OPS_PER_FILE ops a file within one
    actor, dense versions per actor.  Returns ``(actor index, actor id,
    version, ops)`` per file, ops in their wire form."""
    kind, member, actor, counter = cols
    R = len(actors)
    live = actor < R
    order = np.argsort(actor[live], kind="stable")
    k_l, m_l = kind[live][order].tolist(), member[live][order].tolist()
    a_l, c_l = actor[live][order], counter[live][order].tolist()
    bounds = np.flatnonzero(np.diff(a_l)) + 1
    starts = np.concatenate([[0], bounds]).tolist()
    ends = np.concatenate([bounds, [len(a_l)]]).tolist()
    a_l = a_l.tolist()
    out = []
    for s, e in zip(starts, ends):
        ai = a_l[s]
        ab = actors[ai]
        for v, lo in enumerate(range(s, e, COMPACT_OPS_PER_FILE), start=1):
            hi = min(lo + COMPACT_OPS_PER_FILE, e)
            out.append((ai, ab, v, [
                [0, m_l[t], [ab, c_l[t]]] if k_l[t] == 0
                else [1, m_l[t], {ab: c_l[t]}]
                for t in range(lo, hi)
            ]))
    return out


def compaction_options(root, local: str, remote, accel):
    from crdt_enc_tpu_torch import (
        FsStorage, OpenOptions, PlainKeyCryptor, XChaChaCryptor, orset_adapter,
    )

    version = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
    return OpenOptions(
        storage=FsStorage(os.path.join(root, local), str(remote)),
        cryptor=XChaChaCryptor(), key_cryptor=PlainKeyCryptor(),
        adapter=orset_adapter(), supported_data_versions=(version,),
        current_data_version=version, create=True, accelerator=accel,
    )


async def build_compaction_remote(root: str, files: list) -> dict:
    """The encrypted fs remote the compaction reads, written by the port's
    own ``Core``: every op file sealed by one writer (``_seal``) and stored
    under ``remote/``, plus COMPACT_SNAPSHOTS snapshots sealed by other
    replicas.  Snapshot i comes from a copy of the initialized remote
    (meta and key) holding the version-1 files of the actors with
    ``actor % 16 == i``: a replica compacts the copy and its snapshot
    moves into ``remote/states``.  So the compaction merges S snapshots
    (a quarter of the rows) and folds the op files past their cursors."""
    import asyncio

    from crdt_enc_tpu_torch import Core, FsStorage, HostAccelerator

    base = os.path.join(root, "base")
    remote = os.path.join(root, "remote")
    writer = await Core.open(compaction_options(root, "writer", base,
                                                HostAccelerator()))
    shutil.copytree(base, remote)
    copies = [os.path.join(root, f"snap{i}") for i in range(COMPACT_SNAPSHOTS)]
    for c in copies:
        shutil.copytree(base, c)
    main = FsStorage(os.path.join(root, "store"), remote)
    side = [FsStorage(os.path.join(root, "store"), c) for c in copies]
    n_bytes = 0
    # a batch of files at a time: the seals' encrypts and the stores'
    # writes and fsyncs overlap in FsStorage's thread pool
    for b in range(0, len(files), COMPACT_WRITE_BATCH):
        batch = files[b : b + COMPACT_WRITE_BATCH]
        blobs = await asyncio.gather(*(writer._seal(ops) for *_, ops in batch))
        stores = []
        for (ai, ab, v, _), blob in zip(batch, blobs):
            n_bytes += len(blob)
            stores.append(main.store_ops(ab, v, blob))
            if v == 1 and ai % 16 < COMPACT_SNAPSHOTS:
                stores.append(side[ai % 16].store_ops(ab, v, blob))
        await asyncio.gather(*stores)
    covered = 0
    os.makedirs(os.path.join(remote, "states"), exist_ok=True)
    for i, c in enumerate(copies):
        replica = await Core.open(compaction_options(root, f"sealer{i}", c,
                                                     HostAccelerator()))
        await replica.compact()
        covered += sum(replica.info().next_op_versions.counters.values())
        (name,) = os.listdir(os.path.join(c, "states"))
        shutil.move(os.path.join(c, "states", name),
                    os.path.join(remote, "states", name))
        shutil.rmtree(c)
    shutil.rmtree(base)
    return dict(remote=remote, op_files=len(files), op_bytes=n_bytes,
                ops=sum(len(ops) for *_, ops in files),
                files_in_snapshots=covered)


async def timed_compaction(root: str, local: str, remote: str, accel):
    """Open a fresh replica on ``remote`` and compact it.  Returns the
    core, the wall seconds from open and the trace snapshot."""
    from crdt_enc_tpu_torch import Core
    from crdt_enc_tpu_torch.utils import trace

    trace.reset()
    t0 = time.perf_counter()
    core = await Core.open(compaction_options(root, local, remote, accel))
    await core.compact()
    wall = time.perf_counter() - t0
    return core, wall, trace.snapshot()


COMPACTION_SPANS = (
    "states.list", "states.load", "states.decrypt_decode", "states.merge",
    "merge.planes", "merge.device", "merge.writeback", "ops.list", "ops.load",
    "ops.bulk_unwrap", "ops.bulk_decrypt", "ops.bulk_fold", "fold.decode",
    "fold.vocab", "fold.planes", "fold.device", "fold.writeback",
    "compact.ingest", "compact.seal", "compact.write", "compact.gc",
)


def print_compaction(label: str, wall: float, snap: dict) -> None:
    print(f"  {label}: compaction wall {wall:.3f}s (Core.open to the end of "
          "compact())", flush=True)
    spans = snap["spans"]
    for name in COMPACTION_SPANS + tuple(sorted(set(spans) - set(COMPACTION_SPANS))):
        if name in spans:
            v = spans[name]
            print(f"    span {name}: {v['seconds'] * 1e3:.1f} ms x{v['count']}")
    print("    counters: " + ", ".join(
        f"{k} {v}" for k, v in sorted(snap["counters"].items())), flush=True)


def phase_compaction(cols, E: int, R: int, device, root: str) -> dict:
    """``Core.compact()`` over an encrypted fs remote at config 3, once
    with ``TorchAccelerator`` and once with ``HostAccelerator`` on a
    byte-identical copy; the states compared byte for byte, then read back
    by a fresh replica.  Returns the launches of the device compaction."""
    import asyncio

    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator
    from crdt_enc_tpu_torch import canonical_bytes
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    actors = actor_ids(R)
    t0 = time.perf_counter()
    files = compaction_files(cols, actors)
    remote = asyncio.run(build_compaction_remote(root, files))
    del files
    print(f"  remote built in {time.perf_counter() - t0:.1f}s under {root}: "
          f"{remote['op_files']} op files, {remote['ops']} ops, "
          f"{remote['op_bytes']} bytes sealed; {COMPACT_SNAPSHOTS} snapshots "
          f"covering {remote['files_in_snapshots']} files", flush=True)
    host_remote = os.path.join(root, "remote_host")
    shutil.copytree(remote["remote"], host_remote)

    for counts in (F.launches, M.launches, LC.launches):
        for k in counts:
            counts[k] = 0
    card, wall, snap = asyncio.run(timed_compaction(
        root, "card", remote["remote"], TorchAccelerator(device=device)))
    launches = {**F.launches, **M.launches, **LC.launches}
    print_compaction(f"TorchAccelerator ({device})", wall, snap)
    print(f"    launches in this compaction: {launches}", flush=True)
    host, host_wall, host_snap = asyncio.run(timed_compaction(
        root, "host", host_remote, HostAccelerator()))
    print_compaction("HostAccelerator (host loop)", host_wall, host_snap)

    cb, hb = card.with_state(canonical_bytes), host.with_state(canonical_bytes)
    print(f"  compacted state bytes equal to the host loop's: {cb == hb} "
          f"({len(cb)} bytes; cursors equal: "
          f"{card.info().next_op_versions == host.info().next_op_versions})",
          flush=True)
    if cb != hb or card.info().next_op_versions != host.info().next_op_versions:
        raise AssertionError("the device compaction disagrees with the host loop")

    async def reopen():
        from crdt_enc_tpu_torch import Core

        t0 = time.perf_counter()
        fresh = await Core.open(compaction_options(
            root, "fresh", remote["remote"], HostAccelerator()))
        await fresh.read_remote()
        names = await fresh.storage.list_state_names()
        actors_left = await fresh.storage.list_op_actors()
        return fresh, time.perf_counter() - t0, names, actors_left

    fresh, read_s, names, actors_left = asyncio.run(reopen())
    fb = fresh.with_state(canonical_bytes)
    print(f"  a fresh replica reads the compacted remote back in {read_s:.2f}s: "
          f"bytes equal {fb == cb}; {len(names)} snapshot, {len(actors_left)} "
          "op logs left", flush=True)
    if fb != cb or len(names) != 1 or actors_left:
        raise AssertionError("the compacted remote does not read back")
    if launches["orset_fold"] != 1 or launches["orset_merge_many"] != 1:
        raise AssertionError(
            f"the compaction did not launch the fold and the merge once: {launches}")
    return dict(launches=launches, wall_s=wall, host_wall_s=host_wall,
                reopen_s=read_s, spans={k: v["seconds"] for k, v in
                                        snap["spans"].items()},
                counters=snap["counters"], remote={k: v for k, v in
                                                    remote.items() if k != "remote"})


# name -> (source, file:line of the TPU kernel's pallas_call, the Pallas
# functions it stands for).  Both OR-Set entries run the bucketed kernels
# of csrc/orset_fold.cu and differ in the range kernel's epilogue; K3
# (_fold_wide) has K2's contract over (E, R) past the ablk layout's int32
# keys, which the same kernels cover with int64 cell indices (phase 9).
KERNELS = {
    "orset_scatter": ("crdt_enc_tpu_torch/csrc/orset_fold.cu",
                      "crdt_enc_tpu/ops/pallas_fold.py:628",
                      "K1 orset_scatter_pallas"),
    "orset_fold": ("crdt_enc_tpu_torch/csrc/orset_fold.cu",
                   "crdt_enc_tpu/ops/pallas_fold.py:830",
                   "K2 orset_fold_pallas_fused; K3 _fold_wide "
                   "(crdt_enc_tpu/ops/pallas_fold.py:259)"),
    "orset_merge_many": ("crdt_enc_tpu_torch/csrc/orset_merge.cu",
                         "crdt_enc_tpu/ops/pallas_merge.py:111",
                         "K4 orset_merge_many_pallas"),
    "lww_fold": ("crdt_enc_tpu_torch/csrc/lww_fold.cu",
                 "crdt_enc_tpu/ops/pallas_lww.py:332",
                 "K5 lww_fold_pallas -> _lww_fold_pallas_impl"),
}


def print_build_log() -> None:
    """Each kernel's registers, shared memory and spills, from
    ``-Xptxas -v``."""
    from crdt_enc_tpu_torch.ops import cuda_build

    # the bool template argument of each source's kernels
    labels = {"lww_fold": ("<global route>", "<shared route>")}
    for src, log in sorted(cuda_build.build_log.items()):
        kernel = "?"
        no, yes = labels.get(src, ("<raw>", "<fold>"))
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                kernel = next(iter(re.findall(r"(?<=\d)([a-z_]+_kernel)", m[1])),
                              m[1])
                if "ILb1E" in m[1]:
                    kernel += yes
                elif "ILb0E" in m[1]:
                    kernel += no
            elif "registers" in line or "spill" in line:
                print(f"  {src} {kernel}: {line.split(':', 1)[-1].strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crdt_enc_tpu_torch.ops import cuda_build

    t_start = time.perf_counter()
    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    name = torch.cuda.get_device_name(0)
    print("== 1. device", flush=True)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    print("== 2. build", flush=True)
    build_s = cuda_build.build()
    print(f"  kernels built in {build_s:.2f}s", flush=True)
    print_build_log()

    print(f"== 3. kernels against plain (N={N}, E={E}, R={R}, S={MERGE_S})",
          flush=True)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, SEED)
    cols2 = gen_columns(N, R, E, SEED2)
    print(f"  columns generated in {time.perf_counter() - t0:.2f}s "
          f"({int((cols[2] >= R).sum())} sentinel rows)", flush=True)
    errs, fold_inputs, stacks, skewed = phase_kernels(cols, cols2, E, R,
                                                      "cuda")

    print("== 4. the slice end to end", flush=True)
    launches = phase_end_to_end(cols, E, R, "cuda")

    print("== 5. times (median of 7, CUDA events)", flush=True)
    rate = memory_rate(name)
    times = phase_times(fold_inputs, stacks, skewed, E, R, rate)
    del fold_inputs, stacks, skewed

    print(f"== 6. LWW kernel against plain (config 4: N={LWW_N}, K={LWW_K}, "
          f"R={LWW_R}, V={LWW_V}; heavy ties; saturated; {PAST_N} rows; "
          f"both routes, both modes)", flush=True)
    lww_errs, lww_dev = phase_lww_kernels("cuda")
    errs.update(lww_errs)

    print("== 7. LWW and counters end to end", flush=True)
    launches["lww_fold"] = phase_lww_end_to_end("cuda")
    phase_counters_end_to_end("cuda")

    print("== 8. LWW times (median of 7, CUDA events; device times per launch "
          "from torch.profiler)", flush=True)
    times["lww_fold"] = phase_lww_times(lww_dev, rate)
    del lww_dev

    print(f"== 9. K3's shape (E={K3_E}, R={K3_R}, N={N_ROWS})", flush=True)
    k3_errs, k3 = phase_k3("cuda", rate)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 10. compaction end to end (config 3: N={N}, R={R}, E={E}, "
          f"{COMPACT_OPS_PER_FILE} ops a file, S={COMPACT_SNAPSHOTS} "
          "snapshots; encrypted FsStorage)", flush=True)
    print(device_line(), flush=True)
    root = tempfile.mkdtemp(prefix="crdt-compaction-")
    print(f"  remote under {root} ({fs_type(root)})", flush=True)
    try:
        compaction = phase_compaction(cols, E, R, "cuda", root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    kernels = []
    for kname, (source, replaces, pallas) in KERNELS.items():
        entry = {
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "pallas": pallas,
            "launches": launches[kname],
            "max_abs_err": errs[kname], "match": errs[kname] == 0,
            **times[kname],
        }
        if kname in k3_errs:
            entry["max_abs_err"] = max(entry["max_abs_err"], k3_errs[kname])
            entry["match"] = entry["max_abs_err"] == 0
        if kname == "orset_fold":
            entry["k3"] = k3
        entry["compaction_launches"] = compaction["launches"][kname]
        kernels.append(entry)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"compaction": compaction}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
