#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crdt_enc_tpu_torch) on one card.

The workload is BASELINE config 3, the OR-Set compaction main path:
1,000,000 add/remove ops over 10,000 replicas and 4,096 members, made
from a seed by a copy of bench.py's ``gen_columns`` (about 10% removes,
dead removes as ``actor = R`` sentinel rows).  Phases:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every CUDA kernel of the path from the sources in the checkout;
3. kernels: each kernel against its plain PyTorch version on the card at
   config-3 width (torch.equal: the planes are int32, the tolerance is
   exact) — the fold into empty planes, a second batch folded on top with
   ``retire_rm`` both ways, and the S = 8 merge of eight folded slices;
4. the slice end to end: ``TorchAccelerator().fold_ops`` over the 1M op
   objects and ``merge_states`` over eight folded slices, each byte-equal
   (canonical bytes) to the port's host loop, with every kernel's launch
   count read from that run alone;
5. times: median of 7 CUDA-event-timed runs per kernel, its plain version
   and, for the scatter, ``scatter_reduce_(..., "amax")`` as the library
   yardstick, beside the least time the card's memory rate allows;
6. the kernels line, then the result line.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
card.  Without a CUDA device, or without the package beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import uuid

import numpy as np

N_ROWS, N_REPLICAS, N_MEMBERS = 1_000_000, 10_000, 4096
SEED, SEED2 = 7, 8
MERGE_S = 8
REPS = 7

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

    err = max_abs_err(ref, got)
    errs[key] = max(errs.get(key, 0), err)
    same = all(torch.equal(r, g) for r, g in zip(ref, got))
    print(f"  {what}: equal={same} max_abs_err={err}", flush=True)
    if not same:
        raise AssertionError(f"{what}: kernel disagrees with its plain version")


def phase_kernels(cols, cols2, E: int, R: int, device):
    """Each kernel against its plain version at the given width.  Returns
    (max_abs_err per kernel, the fold outputs, the S-way merge stacks)."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    errs: dict = {}
    dev = [torch.from_numpy(x).to(device) for x in cols]
    z = torch.zeros((E, R), dtype=torch.int32, device=device)
    clock0 = torch.zeros(R, dtype=torch.int32, device=device)

    clock = clock0.clone()
    got = F.orset_scatter(*dev, num_members=E, num_replicas=R, clock=clock)
    ref = P.orset_scatter_plain(*dev, num_members=E, num_replicas=R)
    check_equal("scatter (seed 7, empty planes)", ref, got, errs, "orset_scatter")
    ref_fold = P.orset_fold_plain(clock0, z, z, *dev, num_members=E, num_replicas=R)
    check_equal("scatter clock", ref_fold[:1], (clock,), errs, "orset_scatter")
    tail = F.orset_fold_tail(clock0, clock, z, z, *got)
    check_equal("tail (seed 7)", ref_fold[1:], tail, errs, "orset_fold_tail")
    fold1 = P.orset_fold(clock0, z, z, *dev, num_members=E, num_replicas=R)
    check_equal("fold (seed 7)", ref_fold, fold1, errs, "orset_fold_tail")
    del got, ref, tail, ref_fold

    dev2 = [torch.from_numpy(x).to(device) for x in cols2]
    for retire in (True, False):
        kw = dict(num_members=E, num_replicas=R, retire_rm=retire)
        ref = P.orset_fold_plain(*fold1, *dev2, **kw)
        got = P.orset_fold(*fold1, *dev2, **kw)
        check_equal(f"fold (seed 8 onto seed 7, retire_rm={retire})", ref, got,
                    errs, "orset_fold_tail")
        # the same fold, kernel by kernel
        clock = fold1[0].clone()
        add_new, rm_new = F.orset_scatter(*dev2, num_members=E, num_replicas=R,
                                          clock=clock)
        check_equal(f"  scatter clock (retire_rm={retire})", ref[:1], (clock,),
                    errs, "orset_scatter")
        tail = F.orset_fold_tail(fold1[0], clock, fold1[1], fold1[2], add_new,
                                 rm_new, retire_rm=retire)
        check_equal(f"  tail (retire_rm={retire})", ref[1:], tail, errs,
                    "orset_fold_tail")
        del ref, got, add_new, rm_new, tail
    del dev2

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
    return errs, (clock0, z, dev, fold1), stacks


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
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the slice path: {missing}")
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


def phase_times(fold_inputs, stacks, E: int, R: int, rate: float):
    """Kernel, plain and library times at the config-3 shape, with each
    function's bound from the bytes it must move (every input read once,
    every output written once) and the int32 operations it does."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    clock0, z, dev, fold1 = fold_inputs
    kind, member, actor, counter = dev
    N = kind.shape[0]
    S = stacks[1].shape[0]
    kw = dict(num_members=E, num_replicas=R)
    clock = clock0.clone()
    add_new, rm_new = F.orset_scatter(*dev, **kw, clock=clock)

    # the library yardstick: one scatter_reduce_ into a zeroed flat target
    # (row masks and segment ids precomputed, outside the timing)
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
            kernel=lambda: F.orset_scatter(*dev, **kw, clock=clock0.clone()),
            plain=lambda: P.orset_scatter_plain(*dev, **kw),
            library=library_scatter,
            bytes=13 * N + 2 * cells * 4 + 2 * R * 4,
            ops=3 * N),
        "orset_fold_tail": dict(
            kernel=lambda: F.orset_fold_tail(clock0, clock, z, z, add_new, rm_new),
            plain=lambda: P.orset_fold_tail_plain(clock0, clock, z, z, add_new,
                                                  rm_new),
            library=None,
            bytes=6 * cells * 4 + 2 * R * 4,
            ops=8 * cells),
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

    # where the scatter's time goes: the two zeroed planes alone, and the
    # scatter without the clock update
    zeros_ms = time_ms(lambda: (torch.zeros((E, R), dtype=torch.int32, device=kind.device),
                                torch.zeros((E, R), dtype=torch.int32, device=kind.device)))
    noclock_ms = time_ms(lambda: F.orset_scatter(*dev, **kw))
    print(f"  orset_scatter breakdown: zero fill {zeros_ms:.4f} ms, "
          f"without the clock {noclock_ms:.4f} ms", flush=True)

    # the whole dense fold, against bench.py's bytes model of it
    fold_ms = time_ms(lambda: P.orset_fold(clock0, z, z, *dev, **kw))
    fold_plain_ms = time_ms(lambda: P.orset_fold_plain(clock0, z, z, *dev, **kw))
    fold_bytes = 2 * (2 * cells * 4) + 13 * N + 2 * 4 * R
    print(f"  fold (scatter + tail): {fold_ms:.4f} ms, plain {fold_plain_ms:.4f} ms, "
          f"bound {fold_bytes / rate * 1e3:.4f} ms ({fold_bytes / 1e6:.1f} MB)",
          flush=True)
    return out


KERNELS = {
    "orset_scatter": ("crdt_enc_tpu_torch/csrc/orset_fold.cu",
                      "crdt_enc_tpu/ops/pallas_fold.py:628"),
    "orset_fold_tail": ("crdt_enc_tpu_torch/csrc/orset_fold.cu",
                        "crdt_enc_tpu/ops/pallas_fold.py:830"),
    "orset_merge_many": ("crdt_enc_tpu_torch/csrc/orset_merge.cu",
                         "crdt_enc_tpu/ops/pallas_merge.py:111"),
}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crdt_enc_tpu_torch.ops import cuda_build

    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    name = torch.cuda.get_device_name(0)
    print("== 1. device", flush=True)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    print("== 2. build", flush=True)
    build_s = cuda_build.build()
    print(f"  kernels built in {build_s:.2f}s", flush=True)
    for src, log in sorted(cuda_build.build_log.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    print(f"== 3. kernels against plain (N={N}, E={E}, R={R}, S={MERGE_S})",
          flush=True)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, SEED)
    cols2 = gen_columns(N, R, E, SEED2)
    print(f"  columns generated in {time.perf_counter() - t0:.2f}s "
          f"({int((cols[2] >= R).sum())} sentinel rows)", flush=True)
    errs, fold_inputs, stacks = phase_kernels(cols, cols2, E, R, "cuda")

    print("== 4. the slice end to end", flush=True)
    launches = phase_end_to_end(cols, E, R, "cuda")

    print("== 5. times (median of 7, CUDA events)", flush=True)
    rate = memory_rate(name)
    times = phase_times(fold_inputs, stacks, E, R, rate)

    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": errs[kname], "match": errs[kname] == 0,
            **times[kname],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
