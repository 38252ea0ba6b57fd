#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crdt_enc_tpu_torch) on one card.

The main workloads are BASELINE configs 3 and 4 at full width: the OR-Set
compaction path (1,000,000 add/remove ops over 10,000 replicas and 4,096
members, made from a seed by a copy of bench.py's ``gen_columns``: about
10% removes, dead removes as ``actor = R`` sentinel rows) and the LWW-map
fold (1,000,000 writes over 1,000,000 keys and 10,000 actors, a copy of
benchmarks/suite.py's config-4 generator), beside configs 1 and 2
(G-Counter 4 x 1k, PN-Counter 1k x 100k), and BASELINE config 5 (200k
OR-Set ops over 100k replicas and 1,024 members), the sparse regime.
Phases:

1. device: the card's name and power limit, as nvidia-smi reports them;
2. build: every CUDA kernel from the sources in the checkout, with each
   kernel's registers, shared memory and spills from ``-Xptxas -v``, then
   the two native libraries (``native/``: crypto, codec and io; and the
   state library ``statebuild.cpp``, built against this interpreter's
   headers), each with its build time;
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
   once) and with ``HostAccelerator`` on a byte-identical copy; the two states
   byte-equal, and a third replica reads the compacted remote back; the
   wall of each compaction and its spans and counters.  The compaction
   takes the reference's pipelined route (bounded op chunks read,
   unwrapped and decrypted by a producer task, folded through a fold
   session); the phase prints the session's mode, the producer width, the
   ``ops.chunk_*`` and ``session.*`` spans and the host RSS sampled over
   each compaction (before, peak, growth), and holds the fold kernel's
   launches to that mode (none in HOST_REDUCE).  Each compaction ends by
   sealing its local checkpoint (``checkpoint.save``, inside the wall):
   the phase prints its format and size, then reopens the device replica
   from its own local directory, which must open from the checkpoint with
   the cold state's bytes and fold nothing more;
11. the stream route past 2^22 rows: 10,485,760 config-3-width rows
   (2.5 x ``STREAM_CHUNK_ROWS``) through ``TorchAccelerator().fold_payloads``
   (in-memory op-file payloads) and ``fold_ops`` (op objects), each three
   fold launches, both states equal to one fold launch over all rows and
   to the plain fold on the CPU; peak device memory, chunk count, wall;
12. fold sessions: phase 10's op files as in-memory payloads through
   ``OrsetFoldSession`` in BUFFER, HOST_REDUCE and DEVICE_STREAM (forced
   through the module constants), each byte-equal to the host loop, the
   DEVICE_STREAM fold launches equal to its chunk count; then
   ``fold_encrypted_stream`` over the same payloads encrypted;
13. config 5 in the sparse regime: its ~86k op files (up to 48 ops a file
   within one actor) through a BUFFER fold session (whose finish runs the
   native fresh sparse fold), ``fold_encrypted_stream``, ``fold_payloads``
   (which must fold, not decline), ``fold_ops`` and ``Core.compact()`` of
   a fresh replica over an encrypted ``MemoryStorage`` remote (in memory
   so the phase does not time ~86k file reads); each state byte-equal to
   the host loop's with no fold kernel launched; the compaction's
   checkpoint must be packed from the fold's stashed rows and reopen warm;
14. the plane cache and incremental compaction with deltas (a: three
   config-3 batches into one state; b: phase 10's remote after 1% tails,
   with a delta consumer; c: the cache through ``Core.compact()`` at
   E = 4,096, R = 1,000);
15. the rest of the catalogue, each byte-equal to the host loop on a
   byte-identical copy and read back by a third replica: (a) the shared
   tag index (CrdtMap<orset>) at config 3's width — 500,000 ops (half its
   backlog) over 10,000 actors, 1,024 keys of 8 tags, 16 writers a key —
   compacted from
   an encrypted ``MemoryStorage`` through ``MapFoldSession`` (no chunk
   declined, the scatter phase on the card; rows per family, card memory
   peak, both walls); (b) the LWW register: config 4's writes as op files
   of one register through ``fold_payloads`` (exactly one ``lww_fold``
   launch) and ``Core.compact()``, then K5 at K = 1 against its plain
   version on both routes and in both modes, with its times; (c) 16 MVReg
   snapshots of 2,048 pairs through ``merge_states`` (the blocked
   dominance filter on the card; its block and card memory peak),
   ``Core.compact()`` and ``fold_payloads``; (d) G-Set, SeqList,
   MerkleReg and the no-op type through ``Core.compact()``, no launch;
16. the multi-tenant fold service (``FoldService``): K2 through the
   tenant layout (the tenants' planes side by side as ``(E_b, T·R_b)``,
   padding rows at ``actor = T·R_b``) against its plain version at the
   fleets' bucket shapes, then fleet (a), 2,048 tenants at bench.py
   --e2e-multitenant's shape (384 ops over 4 replicas and 64 members,
   24-op files; 1/8 G-Counters, 8 oversize solo spills, 8 decoder
   declines, 16 empty, 16 with 3 snapshots), and fleet (b), one bucket at
   the cells cap (16 tenants of 1,024 members x 1,024 replicas, 32,768
   ops), as encrypted in-memory remotes in three byte-identical copies:
   three service cycles (all ops; a 10% tail, served from the warm tier
   with deltas cut on the card; quiet), against the sequential solo
   ``compact()`` loop with ``TorchAccelerator`` and with the host loop.
   Each OR-Set bucket of cycle 1 launches K2 once; every tenant equals
   the host loop's bytes each cycle; each cycle-2 delta equals the host
   dict walk's; ``read_strong`` on 8 tenants equals the host loop's
   strong read; the quiet cycle launches, uploads and builds nothing.
   Per cycle: wall, tenant p50/p99, ops/s, launches, ``h2d_bytes``, card
   memory peak and the card's idle share (torch.profiler);
17. the fleet daemon: (a) a ``FleetDaemon`` over phase 16's fleets (a) and
   (b) in two byte-identical copies, one of ``TorchAccelerator`` tenants
   and one of ``HostAccelerator`` tenants (whose buckets fold with the
   plain versions on the host), batch 256 and ``seal_empty=False``; 16
   plain OR-Set tenants refuse their op listing for six cycles, back off,
   park in the quarantine ring and return once healed.  It cycles until
   every other tenant with ops has sealed, appends phase 16's 10% tails,
   cycles until the backlog is zero and through one quiet cycle, then
   drains.  Each cycle: both copies schedule, poll, back off and
   quarantine the same tenants and seal the same bytes; K2 launches once
   per OR-Set bucket the planner made plus once per solo spill, K4 once
   per snapshot tenant's first compaction; nothing builds after cycle 1.
   After the drain every tenant reopens warm with equal bytes, and
   ``/healthz`` of the card daemon's live server shows the quarantine and
   the recovery.  Per cycle: wall, tenants compacted and polled, ops
   folded, tenant p50/p99, K2/K4 launches, ``h2d_bytes``, the card's idle
   share and the daemon's gauges; the drain's wall.  (b) ``python -m
   crdt_enc_tpu_torch.tools.daemon run`` in process over 8 encrypted
   FsStorage tenants at fleet (a)'s shape (3 cycles, a live endpoint on an
   ephemeral port): exit 0, K2 launched, each tenant reopened warm and
   equal to a host-loop ``compact()`` of a copy of its remote;
then the kernels line and the result line.  Phase 5 also times the merge
at the compaction's own shape (S = 9, E = 4,096, R = 5,000) against its
plain version, and phases 5 and 9 give the merge and K3's shape their
back-to-back and host-enqueue times.

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
import threading
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
# the S-way merge at the compaction's shape: phase 10 merges 9 states
# (its replica's empty one and 8 snapshots) over 4,096 members and the
# 5,000 actors the snapshots saw
K4_S, K4_R, K4_SEED = 9, 5000, 12
# phase 11: 2.5 x STREAM_CHUNK_ROWS config-3-width rows, as op files of
# STREAM_FILE_OPS ops
STREAM_N, STREAM_SEED, STREAM_FILE_OPS = 10_485_760, 11, 1024
# phase 12: op files fed to a session per chunk
SESSION_FEED_FILES = 2048
# phase 13: BASELINE config 5 (benchmarks/suite.py bench_streaming, bench.py
# e2e): 200k ops over 100k replicas and 1,024 members, up to 48 ops a file
# within one actor, from gen_columns' seed 5
CFG5_N, CFG5_R, CFG5_E, CFG5_SEED = 200_000, 100_000, 1024, 5
# phase 14: the plane cache's three config-3 batches (the first is phase
# 3's), and the incremental compaction's 1% tails (10,000 ops a round, as
# COMPACT_OPS_PER_FILE-op files)
CACHE_SEEDS = (SEED, SEED2, 13)
TAIL_OPS, TAIL_SEED = 10_000, 14
# phase 14c: the plane cache through Core.compact() where the dense route
# takes the tails: config 3's 4,096 members over config 2's 1,000
# replicas (E*R = 4,096,000 cells, below SPARSE_MIN_CELLS = 2^22), a
# 100,000-op history (config 2's count) and 1% tails
CC_E, CC_R, CC_N, CC_SEED = 4096, PN_R, PN_N, 15
CC_TAIL_OPS, CC_ROUNDS, CC_TAIL_SEED = 1_000, 4, 16

# phase 15: the rest of the catalogue at config 3's fleet and backlog.
# (a) the shared tag index (examples/tags_map.py): CrdtMap<orset> ops over
# 10,000 actors, 1,024 keys of 8 tags, each key written by a fixed group of
# 16 actors; every MAP_BEYOND-th key remove defers for good.  Half config
# 3's 1M-op backlog: the host-loop reference applies ~70 us an op (70.3 s
# for 1M ops on the H100 machine's host), which alone would take the phase
# past its share of the script's time
MAP_N, MAP_R, MAP_K, MAP_TAGS, MAP_GROUP = N_ROWS // 2, N_REPLICAS, 1024, 8, 16
MAP_BEYOND, MAP_SEED = 500, 17
# (c) 16 MVReg snapshots of 2,048 (clock, value) pairs in all over 10,000
# actors, 8 actors a clock (the host loop's pairwise merge is O(V^2))
MV_S, MV_V, MV_R, MV_CLOCK, MV_SEED = 16, 2048, N_REPLICAS, 8, 18
# (d) the host-by-design types' small histories
OTHER_SEED = 19

# phase 16: the multi-tenant fold service.  Fleet (a) at bench.py
# --e2e-multitenant's per-tenant shape (384 ops over 4 replicas and 64
# members, 24-op files), 2,048 tenants: 1/8 G-Counters, 8 oversize
# OR-Sets past the bucket row cap (solo spills), 8 whose remove contexts
# name an actor the decoder does not know (it declines; the Python
# columns take them), 16 empty and 16 with 3 snapshots beside their op
# files (K4 in their ingest).  Fleet (b): one bucket at the cells cap, 16
# tenants of 1,024 members x 1,024 replicas and 32,768 ops.  Cycle 2 adds
# a 10% tail of op files to every tenant with ops; cycle 3 is quiet.
FLEET_T, FLEET_N, FLEET_R, FLEET_E, FLEET_OPF = 2048, 384, 4, 64, 24
FLEET_GC, FLEET_BIG, FLEET_BIG_N = FLEET_T // 8, 8, 40_000
FLEET_DECLINE, FLEET_EMPTY, FLEET_SNAP, FLEET_SNAPSHOTS = 8, 16, 16, 3
CAP_T, CAP_E, CAP_R, CAP_N = 16, 1024, 1024, 32_768
SERVE_TAIL_PCT, SERVE_SEED, SERVE_STRONG = 10, 23, 8
# phase 17: the fleet daemon over phase 16's fleets (a) and (b) in two
# byte-identical copies (the card's and the host reference's), with
# DAEMON_FLAKY plain OR-Set tenants whose op listing fails for the first
# DAEMON_OUTAGE cycles.  The default DaemonConfig (batch 256,
# seal_empty=False) but for the quarantine ring: a tenant parks after 3
# failures and one parked tenant is re-probed every cycle (the default
# ring re-probes one tenant every 16 cycles, so 16 tenants parked in one
# cycle would take 256 cycles to return), and the admission gate's
# per-tenant estimate, which is the fleet's mean plane bytes (the default
# estimate, 1 MiB a tenant, admits 256 tenants under the warm tier's
# 256 MiB).  The entry point runs CLI_T FsStorage tenants at fleet (a)'s
# shape for CLI_CYCLES cycles.  Once the daemon settles, every
# DAEMON_SOLO_EVERY-th tenant, every tenant of a special class and every
# flaky tenant of the card's copy is held against a host-loop compact()
# of a copy of its remote, independent of the service and the daemon.
DAEMON_FLAKY, DAEMON_OUTAGE, DAEMON_MAX_CYCLES = 16, 6, 40
DAEMON_SOLO_EVERY = 8
DAEMON_QUARANTINE_AFTER, DAEMON_PROBE_EVERY = 3, 1
CLI_T, CLI_CYCLES, CLI_SEED = 8, 3, 29

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


_LOOP = None


def run_async(coro):
    """Run ``coro`` to its end on the script's one event loop: phase 14
    compacts again with phase 10's cores, whose storages' semaphores are
    bound to the loop they first waited on."""
    import asyncio

    global _LOOP
    if _LOOP is None:
        _LOOP = asyncio.new_event_loop()
    return _LOOP.run_until_complete(coro)


def close_loop() -> None:
    """Stop the script's event loop and its worker threads."""
    global _LOOP
    if _LOOP is not None:
        _LOOP.run_until_complete(_LOOP.shutdown_default_executor())
        _LOOP.close()
        _LOOP = None


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
    b2b_ms = time_stream_ms(lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw),
                            calls=10)
    enqueue_ms = host_enqueue_ms(
        lambda: F.orset_fold_cuda(clock0, z, z2, *dev, **kw), calls=10)
    print(f"    per call over 10 back-to-back calls {b2b_ms:.4f} ms; host "
          f"enqueue time per call {enqueue_ms:.4f} ms", flush=True)
    return errs, dict(E=E, R=R, N=N, fold_ms=fold_ms, fold_plain_ms=plain_ms,
                      one_zero_plane_as_add0_and_rm0_ms=same_ms,
                      back_to_back_ms=b2b_ms, host_enqueue_ms=enqueue_ms,
                      bound_ms=bound_ms, peak_bytes=peak,
                      match=max(errs.values()) == 0)


def phase_k4_compaction_shape(device, rate: float):
    """The S-way merge at the compaction's shape (S = K4_S states over
    E = 4,096 members and R = K4_R actors, each the fold of a disjoint
    slice of config-3-width rows): the kernel against the plain tree
    (torch.equal), its single-call, back-to-back and host-enqueue times,
    the plain time and the bound.  Returns (max_abs_err, the times)."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    E, R, S = N_MEMBERS, K4_R, K4_S
    cols = gen_columns(N_ROWS, R, E, K4_SEED)
    dev = [torch.from_numpy(x).to(device) for x in cols]
    z = torch.zeros((E, R), dtype=torch.int32, device=device)
    clock0 = torch.zeros(R, dtype=torch.int32, device=device)
    bounds = np.linspace(0, N_ROWS, S + 1).astype(int)
    states = [P.orset_fold(clock0, z, z, *(x[lo:hi] for x in dev),
                           num_members=E, num_replicas=R)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    stacks = [torch.stack([st[i] for st in states]) for i in range(3)]
    del states, dev
    errs: dict = {}
    check_equal(f"merge at the compaction's shape (S={S}, E={E}, R={R})",
                P.orset_merge_many_tree(*stacks),
                M.orset_merge_many_cuda(*stacks), errs, "orset_merge_many")
    cells = E * R
    nbytes = (S + 1) * 2 * cells * 4 + 3 * S * R * 4
    bytes_ms = nbytes / rate * 1e3
    ops_ms = 12 * (S - 1) * cells / CUDA_CORE_OPS_PER_S * 1e3
    out = dict(S=S, E=E, R=R,
               ms=time_ms(lambda: M.orset_merge_many_cuda(*stacks)),
               plain_ms=time_ms(lambda: P.orset_merge_many_tree(*stacks)),
               back_to_back_ms=time_stream_ms(
                   lambda: M.orset_merge_many_cuda(*stacks)),
               host_enqueue_ms=host_enqueue_ms(
                   lambda: M.orset_merge_many_cuda(*stacks)),
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"  orset_merge_many at S={S}, E={E}, R={R}: kernel "
          f"{out['ms']:.4f} ms, back to back {out['back_to_back_ms']:.4f} ms, "
          f"host enqueue {out['host_enqueue_ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"(bytes: {nbytes / 1e6:.1f} MB)", flush=True)
    return errs["orset_merge_many"], out


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


def compaction_options(root, local: str, remote, accel, **kw):
    from crdt_enc_tpu_torch import (
        FsStorage, OpenOptions, PlainKeyCryptor, XChaChaCryptor, orset_adapter,
    )

    version = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
    return OpenOptions(
        storage=FsStorage(os.path.join(root, local), str(remote)),
        cryptor=XChaChaCryptor(), key_cryptor=PlainKeyCryptor(),
        adapter=orset_adapter(), supported_data_versions=(version,),
        current_data_version=version, accelerator=accel,
        **{"create": True, **kw},
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
    "merge.planes", "merge.device", "merge.writeback", "ops.list",
    "ops.chunk_read", "ops.chunk_unwrap", "ops.chunk_decrypt", "ops.chunk_fold",
    "ops.session_finish", "session.decode", "session.remap",
    "session.host_reduce", "session.device_fold", "session.combine",
    "session.device_finish", "session.sparse_fold", "session.writeback",
    "ops.load",
    "ops.bulk_unwrap", "ops.bulk_decrypt", "ops.bulk_fold", "fold.decode",
    "fold.vocab", "fold.planes", "fold.device", "fold.writeback",
    "compact.ingest", "compact.seal", "compact.write", "delta.plan",
    "delta.verify", "delta.seal", "compact.gc", "checkpoint.save",
    "checkpoint.load", "checkpoint.verify",
)


def rss_bytes() -> int | None:
    """This process's resident set in bytes, from ``/proc/self/statm``
    (else ``VmRSS`` in ``/proc/self/status``); None where neither is
    reported."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


class RssSampler:
    """Samples the resident set every ``interval`` seconds on a thread
    while the block runs: ``before`` is the resident set at entry,
    ``peak`` the largest sample (both None where the kernel reports
    none).  The growth ``peak - before`` is the block's own host memory,
    apart from what earlier phases left resident."""

    def __init__(self, interval: float = 0.005):
        self.interval = interval
        self.before = self.peak = None
        self.samples = 0
        self._stop = threading.Event()
        self._thread = None

    def _sample(self) -> None:
        rss = rss_bytes()
        if rss is not None:
            self.samples += 1
            self.peak = rss if self.peak is None else max(self.peak, rss)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            self._sample()

    def __enter__(self):
        self.before = rss_bytes()
        self._sample()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()
        return False

    def line(self) -> str:
        if self.before is None or self.peak is None:
            return "host RSS not reported by this kernel"
        return (f"host RSS before {self.before / 1e9:.3f} GB, peak "
                f"{self.peak / 1e9:.3f} GB, growth "
                f"{(self.peak - self.before) / 1e9:.3f} GB ({self.samples} "
                f"samples every {self.interval * 1e3:.0f} ms)")

    def fields(self, prefix: str) -> dict:
        if self.before is None or self.peak is None:
            return {}
        return {f"{prefix}rss_before_bytes": self.before,
                f"{prefix}rss_peak_bytes": self.peak,
                f"{prefix}rss_growth_bytes": self.peak - self.before}


def session_launches(accel, session) -> int:
    """The fold launches a finished OR-Set session's mode implies:
    none in HOST_REDUCE, one per chunk in DEVICE_STREAM, and in BUFFER
    the accelerator's whole-batch fold at finish (none in the sparse
    regime, one per ``STREAM_CHUNK_ROWS`` rows otherwise)."""
    if session.mode == "host_reduce":
        return 0
    if session.mode == "device_stream":
        return session.device_chunks
    E, R, n = len(session.members), len(session.replicas), session.rows_fed
    if n == 0 or accel._use_sparse(E, R, n):
        return 0
    return -(-n // accel.STREAM_CHUNK_ROWS)


class SessionProbe:
    """Wraps an accelerator's ``open_fold_session`` to keep the sessions
    it opens, so a run can report the mode each took."""

    def __init__(self, accel):
        self.sessions: list = []
        self._open = accel.open_fold_session
        accel.open_fold_session = self

    def __call__(self, state, actors_hint=()):
        session = self._open(state, actors_hint)
        self.sessions.append(session)
        return session


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
    if snap.get("gauges"):
        print("    gauges: " + ", ".join(
            f"{k} {v}" for k, v in sorted(snap["gauges"].items())), flush=True)


def checkpoint_format(core) -> str:
    """The format of the checkpoint ``core`` sealed last, read back from
    its local slot."""

    from crdt_enc_tpu_torch.core import core as core_mod

    async def read():
        raw = await core.storage.load_local_checkpoint()
        return None if raw is None else (await core._open_sealed(raw))[b"fmt"]

    fmt = run_async(read())
    return {core_mod.CHECKPOINT_FMT_ORSET: "orset columnar",
            core_mod.CHECKPOINT_FMT_OBJ: "adapter object",
            None: "none sealed"}.get(fmt, f"unknown {fmt!r}")


def warm_reopen(make_options, sealer, cold_bytes: bytes) -> dict:
    """Reopen a compacted replica from its own local state: it must open
    from its checkpoint, with the sealer's state bytes, and a read of the
    remote must fold nothing more.  Prints the sealer's checkpoint and the
    reopen's spans; returns its walls and sizes."""

    from crdt_enc_tpu_torch import Core, canonical_bytes
    from crdt_enc_tpu_torch.utils import trace

    fmt = checkpoint_format(sealer)

    async def reopen():
        trace.reset()
        t0 = time.perf_counter()
        core = await Core.open(make_options())
        t_open = time.perf_counter() - t0
        await core.read_remote()
        return core, t_open, time.perf_counter() - t0, trace.snapshot()

    core, open_s, read_s, snap = run_async(reopen())
    wb = core.with_state(canonical_bytes)
    spans = {k: v["seconds"] for k, v in snap["spans"].items()}
    folded = (snap["counters"].get("ops_folded", 0)
              + snap["counters"].get("op_files_bulk_folded", 0))
    print(f"  warm reopen from the checkpoint ({fmt}): opened_from_checkpoint "
          f"{core.opened_from_checkpoint} (fallback "
          f"{core.checkpoint_fallback_reason}); open {open_s:.3f}s, open and "
          f"read_remote {read_s:.3f}s; checkpoint.load "
          f"{spans.get('checkpoint.load', 0) * 1e3:.1f} ms, checkpoint.verify "
          f"{spans.get('checkpoint.verify', 0) * 1e3:.1f} ms; bytes equal to "
          f"the cold state's: {wb == cold_bytes}; {folded} files or ops "
          "folded after it", flush=True)
    if not core.opened_from_checkpoint or wb != cold_bytes or folded:
        raise AssertionError("the warm reopen did not restore the compacted "
                             "state from its checkpoint")
    return dict(format=fmt, open_s=open_s, open_read_s=read_s,
                checkpoint_load_s=spans.get("checkpoint.load"),
                checkpoint_verify_s=spans.get("checkpoint.verify"))


def phase_compaction(files, E: int, R: int, device, root: str) -> dict:
    """``Core.compact()`` over an encrypted fs remote at config 3, once
    with ``TorchAccelerator`` and once with ``HostAccelerator`` on a
    byte-identical copy; the states compared byte for byte, then read back
    by a fresh replica.  The device compaction takes the pipelined route;
    its fold launches must match the mode its session reports.  Returns
    the launches of the device compaction, the mode and the walls, and
    the live replicas phase 14 compacts again: the device and host
    compactors, the device accelerator and its session probe, and the two
    remotes."""

    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator
    from crdt_enc_tpu_torch import canonical_bytes

    t0 = time.perf_counter()
    remote = run_async(build_compaction_remote(root, files))
    print(f"  remote built in {time.perf_counter() - t0:.1f}s under {root}: "
          f"{remote['op_files']} op files, {remote['ops']} ops, "
          f"{remote['op_bytes']} bytes sealed; {COMPACT_SNAPSHOTS} snapshots "
          f"covering {remote['files_in_snapshots']} files", flush=True)
    host_remote = os.path.join(root, "remote_host")
    shutil.copytree(remote["remote"], host_remote)

    accel = TorchAccelerator(device=device)
    probe = SessionProbe(accel)
    reset_launches()
    with RssSampler() as rss:
        card, wall, snap = run_async(timed_compaction(
            root, "card", remote["remote"], accel))
    launches = read_launches()
    print_compaction(f"TorchAccelerator ({device})", wall, snap)
    print(f"    launches in this compaction: {launches}", flush=True)
    if len(probe.sessions) != 1:
        raise AssertionError(f"the compaction opened {len(probe.sessions)} "
                             "fold sessions, not one: not the pipelined route")
    session = probe.sessions[0]
    print(f"    pipelined route: fold session mode {session.mode}, "
          f"{session.rows_fed} rows fed, {session.device_chunks} device "
          f"chunks; stream_producers "
          f"{snap.get('gauges', {}).get('stream_producers')}; "
          f"{rss.line()}", flush=True)
    expected_fold = session_launches(accel, session)
    print(f"    checkpoint sealed by the compaction: {checkpoint_format(card)}, "
          f"{snap['counters'].get('checkpoint_bytes')} bytes, checkpoint.save "
          f"{snap['spans'].get('checkpoint.save', {}).get('seconds', 0) * 1e3:.1f}"
          " ms (part of the compaction wall)", flush=True)
    with RssSampler() as host_rss:
        host, host_wall, host_snap = run_async(timed_compaction(
            root, "host", host_remote, HostAccelerator()))
    print_compaction("HostAccelerator (host loop)", host_wall, host_snap)
    print(f"    {host_rss.line()}", flush=True)

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

    fresh, read_s, names, actors_left = run_async(reopen())
    fb = fresh.with_state(canonical_bytes)
    print(f"  a fresh replica reads the compacted remote back in {read_s:.2f}s "
          f"(the cold open): bytes equal {fb == cb}; {len(names)} snapshot, "
          f"{len(actors_left)} op logs left", flush=True)
    if fb != cb or len(names) != 1 or actors_left:
        raise AssertionError("the compacted remote does not read back")
    warm = warm_reopen(lambda: compaction_options(root, "card", remote["remote"],
                                                  accel), card, cb)
    if (launches["orset_fold"] != expected_fold
            or launches["orset_merge_many"] != 1):
        raise AssertionError(
            f"the compaction's launches {launches} do not match its session "
            f"mode {session.mode} (fold {expected_fold}) and one merge")
    live = dict(card=card, host=host, accel=accel, probe=probe,
                remote=remote["remote"], host_remote=host_remote)
    return dict(launches=launches, wall_s=wall, host_wall_s=host_wall,
                reopen_s=read_s, warm=warm, session_mode=session.mode,
                session_rows=session.rows_fed,
                stream_producers=snap.get("gauges", {}).get("stream_producers"),
                **rss.fields(""), **host_rss.fields("host_"),
                spans={k: v["seconds"] for k, v in snap["spans"].items()},
                counters=snap["counters"], gauges=snap.get("gauges", {}),
                remote={k: v for k, v in remote.items() if k != "remote"}), live


# ---- the stream route past 2^22 rows (phase 11) ----------------------------


def op_file_payloads(cols, actors: list, ops_per_file: int) -> list:
    """The live rows as op-file payloads, in row order, ``ops_per_file``
    ops a file, built with numpy: each op ``[kind, member, [actor,
    counter]]`` (add) or ``[kind, member, {actor: counter}]`` (remove) in
    msgpack with fixed-width ints (member uint16, counter uint32; valid
    msgpack the decoder reads, one wire span per member), a file an
    array16 of its ops.  Returns memoryviews of one buffer."""
    kind, member, actor, counter = cols
    R = len(actors)
    live = actor < R
    k, m, a, c = kind[live], member[live], actor[live], counter[live]
    n = len(k)
    rec = np.empty((n, 29), np.uint8)
    rec[:, 0] = 0x93
    rec[:, 1] = k
    rec[:, 2] = 0xCD
    rec[:, 3:5] = m.astype(">u2").view(np.uint8).reshape(n, 2)
    rec[:, 5] = np.where(k == 0, 0x92, 0x81)
    rec[:, 6] = 0xC4
    rec[:, 7] = 0x10
    rec[:, 8:24] = np.frombuffer(b"".join(actors), np.uint8).reshape(R, 16)[a]
    rec[:, 24] = 0xCE
    rec[:, 25:29] = c.astype(">u4").view(np.uint8).reshape(n, 4)
    parts, bounds = [], [0]
    for lo in range(0, n, ops_per_file):
        hi = min(lo + ops_per_file, n)
        cnt = hi - lo
        head = bytes([0x90 | cnt]) if cnt < 16 else bytes([0xDC, cnt >> 8, cnt & 0xFF])
        parts.append(head)
        parts.append(rec[lo:hi].tobytes())
        bounds.append(bounds[-1] + len(head) + 29 * cnt)
    view = memoryview(b"".join(parts))
    return [view[bounds[i] : bounds[i + 1]] for i in range(len(bounds) - 1)]


def planes_bytes(planes, E: int, actors: list) -> bytes:
    """Canonical bytes of the OR-Set whose planes these are (members are
    the ints 0..E-1, replicas the actor ids)."""
    from crdt_enc_tpu_torch import canonical_bytes
    from crdt_enc_tpu_torch.ops.columnar import Vocab, orset_planes_to_state

    clock, add, rm = (x.cpu().numpy() for x in planes)
    return canonical_bytes(orset_planes_to_state(
        clock, add, rm, Vocab(range(E)), Vocab(actors)))


def phase_stream(device) -> dict:
    """STREAM_N config-3-width rows, 2.5 x ``STREAM_CHUNK_ROWS``, through
    ``TorchAccelerator().fold_payloads`` and ``fold_ops``: each three fold
    launches (the counts reset just before each route and read just
    after), each state equal to one fold launch over all rows and to the
    plain fold on the CPU.  Returns the launches, walls and peaks."""
    import torch

    from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F

    E, R, N = N_MEMBERS, N_REPLICAS, STREAM_N
    actors = actor_ids(R)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, STREAM_SEED)
    payloads = op_file_payloads(cols, actors, STREAM_FILE_OPS)
    live = int((cols[2] < R).sum())
    print(f"  {N} rows ({live} live) as {len(payloads)} op-file payloads in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    accel = TorchAccelerator(device=device)
    chunks = -(-live // accel.STREAM_CHUNK_ROWS)
    out: dict = {"N": N, "live_rows": live, "chunk_rows": accel.STREAM_CHUNK_ROWS,
                 "chunks": chunks}
    states = {}

    def route(name, fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        F.launches["orset_fold"] = 0
        t0 = time.perf_counter()
        state = fn()
        wall = time.perf_counter() - t0
        n = F.launches["orset_fold"]
        peak = torch.cuda.max_memory_allocated()
        out[name] = dict(launches=n, wall_s=wall, peak_device_bytes=peak)
        states[name] = canonical_bytes(state)
        print(f"  {name}: {n} orset_fold launches for {chunks} chunks of "
              f"{accel.STREAM_CHUNK_ROWS} rows; wall {wall:.2f}s; peak device "
              f"memory {peak / 1e9:.3f} GB", flush=True)
        if n != chunks:
            raise AssertionError(f"{name}: {n} launches, not one per chunk")

    def by_payloads():
        state = ORSet()
        if not accel.fold_payloads(state, payloads, actors_hint=actors):
            raise AssertionError("fold_payloads declined past STREAM_CHUNK_ROWS")
        return state

    route("fold_payloads", by_payloads)
    del payloads
    t0 = time.perf_counter()
    ops = ops_from_columns(*cols, actors)
    print(f"  {len(ops)} op objects built in {time.perf_counter() - t0:.1f}s",
          flush=True)
    route("fold_ops", lambda: accel.fold_ops(ORSet(), ops))
    del ops

    F.launches["orset_fold"] = 0
    dev = [torch.from_numpy(x).to(device) for x in cols]
    z = [torch.zeros(R, dtype=torch.int32, device=device),
         torch.zeros((E, R), dtype=torch.int32, device=device),
         torch.zeros((E, R), dtype=torch.int32, device=device)]
    one = F.orset_fold_cuda(*z, *dev, num_members=E, num_replicas=R)
    one_bytes = planes_bytes(one, E, actors)
    del one, dev, z
    t0 = time.perf_counter()
    cpu = [torch.from_numpy(x) for x in cols]
    plain = P.orset_fold_plain(torch.zeros(R, dtype=torch.int32),
                               torch.zeros((E, R), dtype=torch.int32),
                               torch.zeros((E, R), dtype=torch.int32), *cpu,
                               num_members=E, num_replicas=R)
    plain_bytes = planes_bytes(plain, E, actors)
    print(f"  one fold launch over all {N} rows: {F.launches['orset_fold']} "
          f"launch; plain fold on the CPU in {time.perf_counter() - t0:.1f}s",
          flush=True)
    same = (states["fold_payloads"] == states["fold_ops"] == one_bytes
            == plain_bytes)
    print(f"  states equal (fold_payloads, fold_ops, one launch, plain on the "
          f"CPU): {same} ({len(one_bytes)} bytes)", flush=True)
    if not same:
        raise AssertionError("the stream route disagrees with the whole fold")
    out["state_bytes"] = len(one_bytes)
    return out


# ---- fold sessions (phase 12) -----------------------------------------------


SESSION_MODES = {
    "buffer": {"BUFFER_BYTES": 1 << 62},
    "host_reduce": {"BUFFER_BYTES": 0},
    "device_stream": {"BUFFER_BYTES": 0, "HOST_PLANE_CELLS": -1},
}


def phase_sessions(files, actors: list, device) -> dict:
    """Phase 10's op files as in-memory payloads, fed SESSION_FEED_FILES at
    a time through ``OrsetFoldSession`` in each mode (forced through the
    module constants), each byte-equal to the host loop, the fold
    launches of each mode read from its run alone; then
    ``fold_encrypted_stream`` over the same payloads encrypted."""
    import secrets

    from crdt_enc_tpu_torch import (
        HostAccelerator, ORSet, TorchAccelerator, canonical_bytes, orset_adapter,
    )
    from crdt_enc_tpu_torch.backends.xchacha import encrypt_blob
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.parallel import session as PS
    from crdt_enc_tpu_torch.utils import codec, trace

    t0 = time.perf_counter()
    payloads = [codec.pack(ops) for *_, ops in files]
    adapter = orset_adapter()
    ops = [adapter.op_from_obj(o) for *_, wire in files for o in wire]
    t1 = time.perf_counter()
    host = canonical_bytes(HostAccelerator().fold_ops(ORSet(), ops))
    host_s = time.perf_counter() - t1
    del ops
    print(f"  {len(payloads)} payloads packed in {t1 - t0:.1f}s; host loop "
          f"{host_s:.2f}s ({len(host)} bytes)", flush=True)
    accel = TorchAccelerator(device=device)
    out: dict = {"host_loop_s": host_s}
    for mode, patch in SESSION_MODES.items():
        saved = {k: getattr(PS, k) for k in patch}
        for k, v in patch.items():
            setattr(PS, k, v)
        try:
            trace.reset()
            F.launches["orset_fold"] = 0
            t0 = time.perf_counter()
            session = accel.open_fold_session(ORSet(), actors_hint=actors)
            for lo in range(0, len(payloads), SESSION_FEED_FILES):
                session.feed(payloads[lo : lo + SESSION_FEED_FILES])
            got = canonical_bytes(session.finish())
            wall = time.perf_counter() - t0
            n = F.launches["orset_fold"]
        finally:
            for k, v in saved.items():
                setattr(PS, k, v)
        spans = {k: v["seconds"] for k, v in trace.snapshot()["spans"].items()
                 if k.startswith(("session.", "fold.", "stream."))}
        expected = session_launches(accel, session)
        out[mode] = dict(wall_s=wall, launches=n, rows=session.rows_fed,
                         device_chunks=session.device_chunks, spans=spans)
        print(f"  {mode}: session mode {session.mode}, wall {wall:.3f}s, "
              f"{n} orset_fold launches ({session.device_chunks} device "
              f"chunks), bytes equal to the host loop: {got == host}",
              flush=True)
        for k, v in sorted(spans.items()):
            print(f"    span {k}: {v * 1e3:.1f} ms", flush=True)
        if session.mode != mode or got != host or n != expected:
            raise AssertionError(f"session mode {mode}: mode {session.mode}, "
                                 f"bytes equal {got == host}, launches {n} "
                                 f"(expected {expected})")
    key = secrets.token_bytes(32)
    blobs = [encrypt_blob(key, p) for p in payloads]
    trace.reset()
    F.launches["orset_fold"] = 0
    t0 = time.perf_counter()
    state = ORSet()
    if not accel.fold_encrypted_stream(state, key, blobs, actors_hint=actors):
        raise AssertionError("fold_encrypted_stream declined")
    wall = time.perf_counter() - t0
    got = canonical_bytes(state)
    snap = trace.snapshot()
    out["fold_encrypted_stream"] = dict(
        wall_s=wall, launches=F.launches["orset_fold"],
        stream_producers=snap["gauges"].get("stream_producers"),
        spans={k: v["seconds"] for k, v in snap["spans"].items()})
    print(f"  fold_encrypted_stream over {len(blobs)} encrypted payloads: wall "
          f"{wall:.3f}s, {snap['gauges'].get('stream_producers')} producers, "
          f"bytes equal to the host loop: {got == host}", flush=True)
    for k, v in sorted(snap["spans"].items()):
        print(f"    span {k}: {v['seconds'] * 1e3:.1f} ms x{v['count']}",
              flush=True)
    if got != host:
        raise AssertionError("fold_encrypted_stream disagrees with the host loop")
    return out


# ---- config 5: the sparse regime (phase 13) --------------------------------


def catalogue_options(storage, adapter, accel):
    from crdt_enc_tpu_torch import OpenOptions, PlainKeyCryptor, XChaChaCryptor

    version = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=adapter,
        supported_data_versions=(version,), current_data_version=version,
        create=True, accelerator=accel,
    )


async def seal_remote(files: list, adapter):
    """An encrypted in-memory remote holding ``files`` — ``(actor id,
    version, ops in wire form)`` — every file sealed by one writer
    ``Core`` under its actor and version."""
    import asyncio

    from crdt_enc_tpu_torch import Core, HostAccelerator, MemoryRemote, MemoryStorage

    remote = MemoryRemote()
    writer = await Core.open(catalogue_options(MemoryStorage(remote), adapter,
                                               HostAccelerator()))
    store = MemoryStorage(remote)
    for b in range(0, len(files), COMPACT_WRITE_BATCH):
        batch = files[b : b + COMPACT_WRITE_BATCH]
        blobs = await asyncio.gather(*(writer._seal(ops) for *_, ops in batch))
        await asyncio.gather(*(store.store_ops(ab, v, blob)
                               for (ab, v, _), blob in zip(batch, blobs)))
    return remote


def config5_options(storage, accel):
    from crdt_enc_tpu_torch import orset_adapter

    return catalogue_options(storage, orset_adapter(), accel)


def build_config5_remote(files: list):
    """An encrypted in-memory remote holding the op files, every file
    sealed by one writer ``Core`` (``_seal``) under its actor and
    version."""
    from crdt_enc_tpu_torch import orset_adapter

    return seal_remote([(ab, v, ops) for _, ab, v, ops in files],
                       orset_adapter())


def phase_config5(device) -> dict:
    """BASELINE config 5 at full width, in the sparse regime (E·R = 102.4M
    cells against 64 x 200k rows): the op files through a fold session
    (BUFFER, its finish the native fresh sparse fold), through
    ``fold_encrypted_stream``, through ``fold_payloads`` (which must fold,
    not decline), through ``fold_ops`` (all four the vectorized host
    sparse fold), and ``Core.compact()`` of a fresh
    replica over an encrypted in-memory remote, whose checkpoint must be
    packed from the fold's stashed rows and reopen warm.  Each state
    byte-equal to the host loop's; the fold kernels' launches are read
    from each route alone and must be 0."""
    import secrets

    from crdt_enc_tpu_torch import (
        Core, HostAccelerator, MemoryStorage, ORSet, TorchAccelerator,
        canonical_bytes, orset_adapter,
    )
    from crdt_enc_tpu_torch.backends.xchacha import encrypt_blob
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M
    from crdt_enc_tpu_torch.utils import codec, trace

    N, R, E = CFG5_N, CFG5_R, CFG5_E
    actors = actor_ids(R)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, CFG5_SEED)
    files = compaction_files(cols, actors)
    payloads = [codec.pack(ops) for *_, ops in files]
    adapter = orset_adapter()
    ops = [adapter.op_from_obj(o) for *_, wire in files for o in wire]
    t1 = time.perf_counter()
    host = canonical_bytes(HostAccelerator().fold_ops(ORSet(), ops))
    host_s = time.perf_counter() - t1
    print(f"  {len(files)} op files of {len(ops)} ops ({int((cols[2] < R).sum())}"
          f" live rows) built in {t1 - t0:.1f}s; host loop {host_s:.2f}s "
          f"({len(host)} bytes)", flush=True)
    out: dict = {"N": N, "R": R, "E": E, "op_files": len(files),
                 "ops": len(ops), "host_loop_s": host_s, "state_bytes": len(host)}
    counts = (F.launches, M.launches, LC.launches)

    def route(name, fn):
        for c in counts:
            for k in c:
                c[k] = 0
        trace.reset()
        with RssSampler() as rss:
            t0 = time.perf_counter()
            got = fn()
            wall = time.perf_counter() - t0
        snap = trace.snapshot()
        launches = {k: v for c in counts for k, v in c.items()}
        spans = {k: v["seconds"] for k, v in snap["spans"].items()}
        out[name] = dict(wall_s=wall, launches=launches, spans=spans,
                         counters=snap["counters"], **rss.fields(""))
        same = canonical_bytes(got) == host
        print(f"  {name}: wall {wall:.3f}s; bytes equal to the host loop: "
              f"{same}; launches {launches}; {rss.line()}", flush=True)
        for k, v in sorted(spans.items()):
            print(f"    span {k}: {v * 1e3:.1f} ms x{snap['spans'][k]['count']}",
                  flush=True)
        if snap["counters"]:
            print("    counters: " + ", ".join(
                f"{k} {v}" for k, v in sorted(snap["counters"].items())),
                flush=True)
        if not same or any(launches.values()):
            raise AssertionError(f"config 5 {name}: bytes equal {same}, "
                                 f"launches {launches}")
        return snap

    accel = TorchAccelerator(device=device)

    def session_route():
        session = accel.open_fold_session(ORSet(), actors_hint=actors)
        for lo in range(0, len(payloads), SESSION_FEED_FILES):
            session.feed(payloads[lo : lo + SESSION_FEED_FILES])
        if session.mode != "buffer":
            raise AssertionError(f"config 5 session left BUFFER: {session.mode}")
        return session.finish()

    snap = route("session", session_route)
    if "session.sparse_fold" not in snap["spans"]:
        raise AssertionError("the session's finish did not take the native "
                             "sparse fold")

    key = secrets.token_bytes(32)
    blobs = [encrypt_blob(key, p) for p in payloads]

    def stream_route():
        state = ORSet()
        if not accel.fold_encrypted_stream(state, key, blobs, actors_hint=actors):
            raise AssertionError("fold_encrypted_stream declined config 5")
        return state

    route("fold_encrypted_stream", stream_route)
    del blobs

    def payloads_route():
        state = ORSet()
        if accel.fold_payloads(state, payloads, actors_hint=actors) is not True:
            raise AssertionError("fold_payloads declined config 5")
        return state

    route("fold_payloads", payloads_route)
    snap = route("fold_ops", lambda: accel.fold_ops(ORSet(), list(ops)))
    if "session.sparse_fold" not in snap["spans"]:
        raise AssertionError("fold_ops did not take the native sparse fold")
    del ops

    t0 = time.perf_counter()
    remote = run_async(build_config5_remote(files))
    print(f"  encrypted in-memory remote of {len(files)} op files sealed in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    storage = MemoryStorage(remote)
    compactor = {}

    def compaction_route():
        async def go():
            core = await Core.open(config5_options(storage, accel))
            await core.compact()
            return core

        compactor["core"] = run_async(go())
        return compactor["core"].with_state(lambda s: ORSet.from_obj(s.to_obj()))

    snap = route("Core.compact()", compaction_route)
    print(f"    checkpoint sealed: {checkpoint_format(compactor['core'])}, "
          f"{snap['counters'].get('checkpoint_bytes')} bytes, packed from the "
          f"fold's rows: {snap['counters'].get('checkpoint_from_rows', 0) == 1}",
          flush=True)
    if snap["counters"].get("checkpoint_from_rows") != 1:
        raise AssertionError("the compaction's checkpoint was not packed from "
                             "the fold's stashed rows")

    async def cold():
        t0 = time.perf_counter()
        core = await Core.open(config5_options(MemoryStorage(remote),
                                               HostAccelerator()))
        await core.read_remote()
        return core, time.perf_counter() - t0

    fresh, cold_s = run_async(cold())
    same = fresh.with_state(canonical_bytes) == host
    print(f"  cold open of a fresh replica over the compacted remote: "
          f"{cold_s:.3f}s, bytes equal to the host loop: {same}", flush=True)
    if not same:
        raise AssertionError("config 5: the compacted remote does not read back")
    out["cold_open_s"] = cold_s
    out["warm"] = warm_reopen(lambda: config5_options(storage, accel),
                              compactor["core"], host)
    return out


# ---- the plane cache and incremental compaction (phase 14) -----------------


def fresh_batch(seed: int, E: int, R: int, offset: int):
    """A config-3 batch from ``gen_columns(seed)`` with every live counter
    raised by ``offset``: dots past the clock of a state folded from the
    earlier batches (removes keep their horizons over the batch's own
    adds)."""
    kind, member, actor, counter = gen_columns(N_ROWS, R, E, seed)
    live = actor < R
    counter = np.where(live, counter + offset, counter).astype(np.int32)
    return kind, member, actor, counter


def reset_launches() -> None:
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    for counts in (F.launches, M.launches, LC.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    return {**F.launches, **M.launches, **LC.launches}


def phase_plane_cache(E: int, R: int, device) -> dict:
    """Part (a): three config-3 batches of fresh dots folded into one
    state through ``fold_ops`` and through ``fold_payloads``, with one host
    ``apply`` between rounds 2 and 3.  Round 2 must start from the planes
    the card kept (one fold launch, no ``fold.planes`` or ``fold.vocab``
    span, ``h2d_bytes`` the op columns' 13 bytes a row); round 3 must
    upload the planes again (the apply expired the cache).  Every state
    is byte-equal to the host loop's after each round."""
    import torch

    from crdt_enc_tpu_torch import (
        AddOp, HostAccelerator, ORSet, TorchAccelerator, canonical_bytes,
    )
    from crdt_enc_tpu_torch.models.vclock import Dot
    from crdt_enc_tpu_torch.utils import trace

    actors = actor_ids(R)
    plane_bytes = 4 * (R + 2 * E * R)
    t0 = time.perf_counter()
    batches, offset, side_op = [], 0, None
    for k, seed in enumerate(CACHE_SEEDS):
        if k == 2:
            # the host apply between rounds 2 and 3: one fresh dot
            offset += 1
            side_op = AddOp(0, Dot(actors[0], offset))
        cols = fresh_batch(seed, E, R, offset)
        offset = int(cols[3][cols[2] < R].max())
        batches.append(dict(
            rows=int((cols[2] < R).sum()),
            ops=ops_from_columns(*cols, actors),
            payloads=op_file_payloads(cols, actors, COMPACT_OPS_PER_FILE)))
    host = ORSet()
    host_bytes = []
    for k, b in enumerate(batches):
        if k == 2:
            host.apply(side_op)
        HostAccelerator().fold_ops(host, list(b["ops"]))
        host_bytes.append(canonical_bytes(host))
    del host
    print(f"  {len(batches)} batches of fresh dots ({[b['rows'] for b in batches]}"
          f" rows) built and folded by the host loop in "
          f"{time.perf_counter() - t0:.1f}s; the state planes are "
          f"{plane_bytes} bytes", flush=True)

    out = {"plane_bytes": plane_bytes}
    for route in ("fold_ops", "fold_payloads"):
        accel = TorchAccelerator(device=device)
        state = ORSet()
        rounds = []
        route_launches = {}
        for k, b in enumerate(batches):
            if k == 2:
                state.apply(side_op)
                print(f"  {route}: one host apply; the cache entry is "
                      f"{'live' if accel._plane_cache_for(state) else 'expired'}",
                      flush=True)
            reset_launches()
            trace.reset()
            t0 = time.perf_counter()
            if route == "fold_ops":
                accel.fold_ops(state, b["ops"])
            elif not accel.fold_payloads(state, b["payloads"],
                                         actors_hint=actors):
                raise AssertionError("fold_payloads declined a config-3 batch")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            snap = trace.snapshot()
            launches = read_launches()
            for kname, n in launches.items():
                route_launches[kname] = route_launches.get(kname, 0) + n
            held = torch.cuda.memory_allocated()
            spans = snap["spans"]
            h2d = snap["counters"].get("h2d_bytes", 0)
            same = canonical_bytes(state) == host_bytes[k]
            print(f"  {route} round {k + 1}: wall {wall:.3f}s; h2d_bytes "
                  f"{h2d} (op columns {13 * b['rows']}); {launches['orset_fold']}"
                  f" fold launch(es); card memory held after the round "
                  f"{held} bytes; bytes equal to the host loop: {same}",
                  flush=True)
            for name, v in sorted(spans.items()):
                print(f"    span {name}: {v['seconds'] * 1e3:.1f} ms "
                      f"x{v['count']}")
            hit = "fold.planes" not in spans and "fold.vocab" not in spans
            expect_hit = k == 1
            if (not same or launches["orset_fold"] != 1 or hit != expect_hit
                    or accel._plane_cache is None
                    or (expect_hit and h2d != 13 * b["rows"])
                    or (not expect_hit and h2d < plane_bytes)):
                raise AssertionError(
                    f"plane cache, {route} round {k + 1}: hit {hit} (expected "
                    f"{expect_hit}), h2d_bytes {h2d}, launches {launches}, "
                    f"bytes equal {same}")
            rounds.append(dict(
                wall_s=wall, h2d_bytes=h2d, op_column_bytes=13 * b["rows"],
                hit=hit, launches=launches, card_bytes_held=held,
                spans={n: v["seconds"] for n, v in spans.items()}))
        out[route] = dict(rounds=rounds, launches=route_launches)
        del accel, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def compactor_clocks(cols, files, R: int):
    """Phase 10's per-actor add clock (max add counter) and next op-file
    version: where phase 14's tail files continue each actor."""
    kind, _, actor, counter = cols
    clock = np.zeros(R, np.int64)
    adds = (actor < R) & (kind == 0)
    np.maximum.at(clock, actor[adds], counter[adds])
    version = np.ones(R, np.int64)
    for ai, _, v, _ in files:
        version[ai] = max(version[ai], v + 1)
    return clock, version


def tail_files(rng, clock, version, actors: list, E: int, n_ops: int) -> list:
    """``n_ops`` tail ops as files of up to COMPACT_OPS_PER_FILE ops, one
    file each for distinct actors at their next versions: adds with fresh
    dots, ~10% removes whose horizon is the actor's clock.  Advances
    ``clock`` and ``version``; files as ``compaction_files`` gives them."""
    n_files = -(-n_ops // COMPACT_OPS_PER_FILE)
    files, left = [], n_ops
    for ai in rng.choice(len(actors), n_files, replace=False).tolist():
        k = min(COMPACT_OPS_PER_FILE, left)
        left -= k
        ab = actors[ai]
        ops = []
        for m, is_rm in zip(rng.integers(0, E, k).tolist(),
                            (rng.random(k) < 0.10).tolist()):
            if is_rm and clock[ai]:
                ops.append([1, m, {ab: int(clock[ai])}])
            else:
                clock[ai] += 1
                ops.append([0, m, [ab, int(clock[ai])]])
        files.append((ai, ab, int(version[ai]), ops))
        version[ai] += 1
    return files


def phase_incremental(live: dict, clock, version, E: int, R: int, device,
                      root: str, first: dict) -> dict:
    """Part (b): phase 10's compaction is round 1 (it sealed the first
    delta base).  A consumer opens cold over the remote, beside a control
    consumer with ``delta=False``; then twice a 1% tail (TAIL_OPS ops, one
    file each for ~210 actors at their next versions) lands in both phase
    10 remotes, the long-lived device compactor and the host-loop one
    compact again, and both consumers read.  The tail must take the sparse
    route; every compactor and consumer state is byte-equal; the consumer
    follows the delta chain with no fallback; the sealed delta parses and
    carries the watermark of the compactor's cursor matrix."""
    import asyncio

    import torch

    from crdt_enc_tpu_torch import Core, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.delta import parse_delta_obj
    from crdt_enc_tpu_torch.obs.replication import stability_watermark
    from crdt_enc_tpu_torch.utils import trace

    card, host, accel, probe = (live[k] for k in
                                ("card", "host", "accel", "probe"))
    actors = actor_ids(R)
    rng = np.random.default_rng(TAIL_SEED)
    snap_dir = os.path.join(live["remote"], "states")

    def spans_ms(snap, names):
        return {n: snap["spans"][n]["seconds"] for n in names
                if n in snap["spans"]}

    async def timed(coro_fn):
        trace.reset()
        t0 = time.perf_counter()
        result = await coro_fn()
        return result, time.perf_counter() - t0, trace.snapshot()

    async def run() -> dict:
        out = {"round1": {
            "compaction_wall_s": first["wall_s"],
            "host_compaction_wall_s": first["host_wall_s"],
            "delta_plan_s": first["spans"].get("delta.plan"),
            "delta_base_bytes": first["gauges"].get("delta_base_bytes")}}
        print(f"  round 1 = phase 10: compaction wall {first['wall_s']:.3f}s, "
              f"delta.plan {first['spans'].get('delta.plan', 0) * 1e3:.1f} ms "
              f"(the first seal packs the delta base: "
              f"{first['gauges'].get('delta_base_bytes')} bytes)", flush=True)
        consumer, c_wall, c_snap = await timed(lambda: _open_read(
            root, "consumer", live["remote"], TorchAccelerator(device=device)))
        control, s_wall, s_snap = await timed(lambda: _open_read(
            root, "control", live["remote"], TorchAccelerator(device=device),
            delta=False))
        (snap_name,) = os.listdir(snap_dir)
        print(f"  consumers open cold after round 1: delta consumer "
              f"{c_wall:.3f}s, control (delta=False) {s_wall:.3f}s; the "
              f"snapshot is {os.path.getsize(os.path.join(snap_dir, snap_name))}"
              " bytes", flush=True)
        out["consumers_cold_open_s"] = dict(delta=c_wall, control=s_wall)
        prev_name = snap_name
        for rnd in (2, 3):
            files = tail_files(rng, clock, version, actors, E, TAIL_OPS)
            blobs = await asyncio.gather(*(card._seal(ops)
                                           for *_, ops in files))
            await asyncio.gather(*(
                s.store_ops(ab, v, blob)
                for (_, ab, v, _), blob in zip(files, blobs)
                for s in (card.storage, host.storage)))
            n_ops = sum(len(ops) for *_, ops in files)
            n_sessions = len(probe.sessions)
            reset_launches()
            _, wall, snap = await timed(card.compact)
            torch.cuda.synchronize()
            launches = read_launches()
            if len(probe.sessions) != n_sessions + 1:
                raise AssertionError("the tail did not take the fold session")
            session = probe.sessions[-1]
            Es, Rs, n = (len(session.members), len(session.replicas),
                         session.rows_fed)
            sparse = accel._use_sparse(Es, Rs, n)
            print(f"  round {rnd}: {len(files)} tail files, {n_ops} ops; "
                  f"device compaction wall {wall:.3f}s; session mode "
                  f"{session.mode}, {n} rows; _use_sparse(E={Es}, R={Rs}, "
                  f"rows={n}) = {sparse} (E*R = {Es * Rs} cells >= "
                  f"SPARSE_MIN_CELLS {accel.SPARSE_MIN_CELLS} and > "
                  f"SPARSE_CELLS_PER_ROW {accel.SPARSE_CELLS_PER_ROW} * rows);"
                  f" launches {launches}", flush=True)
            print_compaction(f"round {rnd} TorchAccelerator ({device})", wall,
                             snap)
            if (session.mode != "buffer" or not sparse
                    or launches["orset_fold"] or "fold.device" in snap["spans"]):
                raise AssertionError(f"round {rnd}: the tail did not take the "
                                     "sparse route")
            _, h_wall, h_snap = await timed(host.compact)
            print_compaction(f"round {rnd} HostAccelerator (host loop)",
                             h_wall, h_snap)
            _, cd_wall, cd_snap = await timed(consumer.read_remote)
            _, cs_wall, cs_snap = await timed(control.read_remote)
            (snap_name,) = os.listdir(snap_dir)
            snap_size = os.path.getsize(os.path.join(snap_dir, snap_name))
            cc = cd_snap["counters"]
            print(f"  round {rnd} consumer: read_remote {cd_wall:.3f}s, "
                  f"delta.read "
                  f"{cd_snap['spans'].get('delta.read', {}).get('seconds', 0) * 1e3:.1f}"
                  f" ms, delta_bytes_read {cc.get('delta_bytes_read')}, "
                  f"delta_applied {cc.get('delta_applied')}, delta_fallbacks "
                  f"{cc.get('delta_fallbacks', 0)}, delta_chain_length "
                  f"{cd_snap.get('gauges', {}).get('delta_chain_length')}; "
                  f"control: read_remote {cs_wall:.3f}s, states.load "
                  f"{cs_snap['spans'].get('states.load', {}).get('seconds', 0) * 1e3:.1f}"
                  f" ms, snapshot bytes read {snap_size}", flush=True)
            got = {k: c.with_state(canonical_bytes) for k, c in (
                ("card", card), ("host", host), ("consumer", consumer),
                ("control", control))}
            equal = len(set(got.values())) == 1
            cursors = {str(c.info().next_op_versions.counters == card.info(
            ).next_op_versions.counters) for c in (host, consumer, control)}
            deltas = await card.storage.load_deltas([(card.actor_id, 1)])
            rec = parse_delta_obj(await card._open_sealed(deltas[-1][2]))
            d = card._data
            union = d.next_op_versions.copy()
            for c in d.cursor_matrix.values():
                union.merge(c)
            wm = stability_watermark(card.actor_id, d.next_op_versions,
                                     d.cursor_matrix, union)
            print(f"  round {rnd}: states byte-equal (device, host, consumer,"
                  f" control): {equal} ({len(got['card'])} bytes; cursors "
                  f"equal {cursors == {'True'}}); delta v{deltas[-1][1]} "
                  f"{len(deltas[-1][2])} bytes: base {rec.base_name[:12]}.. "
                  f"== previous snapshot {rec.base_name == prev_name}, new == "
                  f"this snapshot {rec.new_name == snap_name}, watermark of "
                  f"{len(rec.watermark)} actors (empty: no producer publishes a "
                  f"cursor) == stability_watermark of the "
                  f"compactor's {len(d.cursor_matrix)}-row cursor matrix "
                  f"{rec.watermark == wm}", flush=True)
            # config 3's producers write op files and never compact, so
            # none publishes a cursor: with more than one silent replica
            # the watermark is empty on both sides (the CPU tests hold the
            # non-empty branches against the JAX function)
            if (not equal or cursors != {"True"}
                    or cc.get("delta_applied") != 1
                    or cc.get("delta_fallbacks", 0)
                    or "states.load" in cd_snap["spans"]
                    or rec.base_name != prev_name or rec.new_name != snap_name
                    or rec.watermark != wm
                    or len(rec.watermark) != 0 or len(wm) != 0):
                raise AssertionError(f"incremental round {rnd} failed its checks")
            prev_name = snap_name
            out[f"round{rnd}"] = dict(
                tail_files=len(files), tail_ops=n_ops, launches=launches,
                session_mode=session.mode, sparse=dict(
                    E=Es, R=Rs, rows=n, sparse=sparse),
                compaction_wall_s=wall, host_compaction_wall_s=h_wall,
                spans=spans_ms(snap, ("delta.plan", "delta.verify",
                                      "delta.seal", "compact.ingest",
                                      "compact.seal", "compact.write",
                                      "compact.gc", "checkpoint.save")),
                host_spans=spans_ms(h_snap, ("delta.plan", "delta.verify",
                                             "delta.seal")),
                counters={k: v for k, v in snap["counters"].items()
                          if k.startswith("delta_")},
                delta_file_bytes=len(deltas[-1][2]),
                consumer=dict(read_s=cd_wall, spans=spans_ms(
                    cd_snap, ("delta.read", "states.load")), counters={
                    k: v for k, v in cc.items() if k.startswith("delta_")}),
                control=dict(read_s=cs_wall, snapshot_bytes=snap_size,
                             spans=spans_ms(cs_snap, ("states.load",
                                                      "states.merge"))),
                watermark_actors=len(rec.watermark))
        return out

    return run_async(run())


def phase_cache_compaction(device, root: str) -> dict:
    """Part (c): the plane cache through ``Core.compact()`` at a shape
    where the tails fold on the dense route.  Three compactors open on
    byte-identical copies of one encrypted fs remote (CC_N ops over
    CC_E members and CC_R replicas): a long-lived device ``Core`` whose
    accelerator keeps its planes between compactions, the same with the
    cache entry dropped before each compaction (every fold builds and
    uploads its planes), and the host loop.  Then CC_ROUNDS times a 1%
    tail lands in all three and each compacts again.  Each compaction
    must fold on the dense route with one launch on both device
    compactors (the BUFFER session, or ``fold_ops`` for a tail below
    BULK_MIN_FILES files); the warm one must hit on every tail round (no ``fold.planes`` or
    ``fold.vocab`` span) and the cold one never; all three states are
    byte-equal after every round."""
    import asyncio

    import torch

    from crdt_enc_tpu_torch import (
        Core, HostAccelerator, TorchAccelerator, canonical_bytes,
    )
    from crdt_enc_tpu_torch.utils import trace

    E, R = CC_E, CC_R
    actors = actor_ids(R)
    cols = gen_columns(CC_N, R, E, CC_SEED)
    files = compaction_files(cols, actors)
    clock, version = compactor_clocks(cols, files, R)
    base = os.path.join(root, "cc_remote")
    names = ("warm", "cold", "host")
    fold_spans = ("ops.session_finish", "fold.vocab", "fold.planes",
                  "fold.device", "fold.writeback", "compact.ingest",
                  "compact.seal", "delta.plan", "delta.verify", "delta.seal")

    async def run() -> dict:
        t0 = time.perf_counter()
        writer = await Core.open(compaction_options(root, "cc_writer", base,
                                                    HostAccelerator()))
        for b in range(0, len(files), COMPACT_WRITE_BATCH):
            batch = files[b : b + COMPACT_WRITE_BATCH]
            blobs = await asyncio.gather(*(writer._seal(ops)
                                           for *_, ops in batch))
            await asyncio.gather(*(
                writer.storage.store_ops(ab, v, blob)
                for (_, ab, v, _), blob in zip(batch, blobs)))
        for n in names:
            shutil.copytree(base, f"{base}_{n}")
        print(f"  remote built in {time.perf_counter() - t0:.1f}s: "
              f"{len(files)} op files, {CC_N} ops over E={E} members and "
              f"R={R} replicas (E*R = {E * R} cells), copied for the warm, "
              "cold and host-loop compactors", flush=True)
        accels = {"warm": TorchAccelerator(device=device),
                  "cold": TorchAccelerator(device=device),
                  "host": HostAccelerator()}
        probes = {n: SessionProbe(accels[n]) for n in ("warm", "cold")}
        cores = {n: await Core.open(compaction_options(
            root, f"cc_{n}", f"{base}_{n}", accels[n])) for n in names}
        rng = np.random.default_rng(CC_TAIL_SEED)
        rounds = []
        for rnd in range(1, CC_ROUNDS + 2):
            if rnd > 1:
                tail = tail_files(rng, clock, version, actors, E, CC_TAIL_OPS)
                blobs = await asyncio.gather(*(writer._seal(ops)
                                               for *_, ops in tail))
                await asyncio.gather(*(
                    c.storage.store_ops(ab, v, blob)
                    for (_, ab, v, _), blob in zip(tail, blobs)
                    for c in cores.values()))
            row = {}
            for n in names:
                if n == "cold":
                    accels[n]._plane_cache = None
                reset_launches()
                trace.reset()
                t0 = time.perf_counter()
                await cores[n].compact()
                if n != "host":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                snap = trace.snapshot()
                spans = snap["spans"]
                launches = read_launches()
                entry = dict(
                    wall_s=wall, launches=launches,
                    h2d_bytes=snap["counters"].get("h2d_bytes", 0),
                    spans={k: spans[k]["seconds"] for k in fold_spans
                           if k in spans})
                if n != "host":
                    # a tail of fewer than BULK_MIN_FILES files folds per op
                    # through fold_ops, a larger one through the session;
                    # both end in the accelerator's cached dense fold
                    session = probes[n].sessions[-1]
                    route = (session.mode if session.rows_fed else "fold_ops")
                    hit = ("fold.device" in spans and "fold.planes" not in spans
                           and "fold.vocab" not in spans)
                    entry.update(
                        hit=hit, route=route,
                        rows=session.rows_fed or snap["counters"].get(
                            "ops_folded", 0),
                        card_bytes_held=torch.cuda.memory_allocated())
                    expect_hit = n == "warm" and rnd > 1
                    if (route not in ("buffer", "fold_ops")
                            or hit != expect_hit
                            or launches["orset_fold"] != 1):
                        raise AssertionError(
                            f"cache compaction round {rnd}, {n}: route "
                            f"{route}, hit {hit} (expected {expect_hit}), "
                            f"launches {launches}")
                row[n] = entry
            got = {n: c.with_state(canonical_bytes) for n, c in cores.items()}
            equal = len(set(got.values())) == 1
            print(f"  round {rnd}: {row['warm']['rows']} rows through "
                  f"{row['warm']['route']}; wall warm "
                  f"{row['warm']['wall_s']:.3f}s (hit {row['warm']['hit']}, "
                  f"h2d_bytes {row['warm']['h2d_bytes']}), cold "
                  f"{row['cold']['wall_s']:.3f}s (h2d_bytes "
                  f"{row['cold']['h2d_bytes']}), host loop "
                  f"{row['host']['wall_s']:.3f}s; states byte-equal {equal} "
                  f"({len(got['warm'])} bytes)", flush=True)
            for n in ("warm", "cold"):
                print(f"    {n}: " + ", ".join(
                    f"{k} {v * 1e3:.1f} ms"
                    for k, v in row[n]["spans"].items()), flush=True)
            if not equal:
                raise AssertionError(f"cache compaction round {rnd}: states "
                                     "differ")
            rounds.append(row)
        tails = rounds[1:]
        hits = sum(r["warm"]["hit"] for r in tails)
        out = dict(E=E, R=R, ops=CC_N, tail_ops=CC_TAIL_OPS, rounds=rounds,
                   hit_rate=hits / len(tails),
                   tail_wall_s={n: sum(r[n]["wall_s"] for r in tails)
                                for n in names},
                   launches={k: sum(r[n]["launches"][k] for r in rounds
                                    for n in ("warm", "cold"))
                             for k in KERNELS})
        print(f"  tail rounds: warm hit rate {out['hit_rate']:.2f}; summed "
              f"walls warm {out['tail_wall_s']['warm']:.3f}s, cold "
              f"{out['tail_wall_s']['cold']:.3f}s, host loop "
              f"{out['tail_wall_s']['host']:.3f}s", flush=True)
        return out

    return run_async(run())


async def _open_read(root: str, local: str, remote: str, accel, **kw):
    from crdt_enc_tpu_torch import Core

    core = await Core.open(compaction_options(root, local, remote, accel, **kw))
    await core.read_remote()
    return core


# ---- the rest of the catalogue (phase 15) ----------------------------------


def copy_memory_remote(remote):
    """A byte-identical copy of an in-memory remote (the files are
    immutable bytes; only the directories are copied)."""
    from crdt_enc_tpu_torch import MemoryRemote

    return MemoryRemote(
        metas=dict(remote.metas), states=dict(remote.states),
        ops={a: dict(v) for a, v in remote.ops.items()},
        deltas={a: dict(v) for a, v in remote.deltas.items()})


def actor_files(streams: dict, per_file: int = COMPACT_OPS_PER_FILE) -> list:
    """Per-actor op streams (wire form) as op files of up to ``per_file``
    ops within one actor, dense versions from 1."""
    out = []
    for ab in sorted(streams):
        ops = streams[ab]
        for v, lo in enumerate(range(0, len(ops), per_file), start=1):
            out.append((ab, v, ops[lo : lo + per_file]))
    return out


def map_history(seed: int = MAP_SEED) -> tuple:
    """Phase 15a's CrdtMap<orset> history in wire form: MAP_N ops over
    MAP_K keys and MAP_R actors, each key written by a fixed group of
    MAP_GROUP actors (a key remove's context then names at most that
    many).  A step picks a key, an actor of its group and an op: a tag
    add (~88%), a tag remove citing the tag's observed dots under a fresh
    map dot (~10%), or a key remove with the key's observed births
    (~2%).  A remover has observed the births of its group's actors that
    sort before it (and its own): the host loop replays the op files actor
    by actor in that order, so each such remove fires when it arrives
    (a context naming later actors would defer until they replay, and the
    loop's per-op flush of pending removes would go quadratic).  Every
    MAP_BEYOND-th key remove cites one dot past its actor's last, so it
    defers for good.  Returns (per-actor streams, the number of each op
    kind)."""
    rng = np.random.default_rng(seed)
    actors = actor_ids(MAP_R)
    perm = rng.permutation(MAP_R)
    groups = [sorted(int(perm[(k * MAP_GROUP + j) % MAP_R])
                     for j in range(MAP_GROUP)) for k in range(MAP_K)]
    keys = [f"key{k:04d}" for k in range(MAP_K)]
    tags = [f"tag{t}" for t in range(MAP_TAGS)]
    counter = [0] * MAP_R
    births = [dict() for _ in range(MAP_K)]  # actor index -> max counter
    entries = {}  # (key, tag) -> {actor index: counter}
    streams = {actors[a]: [] for a in range(MAP_R)}
    kinds = {"tag add": 0, "tag remove": 0, "key remove": 0,
             "key remove, deferred": 0}
    n_key_rm = 0
    ks = rng.integers(0, MAP_K, MAP_N).tolist()
    js = rng.integers(0, MAP_GROUP, MAP_N).tolist()
    ts = rng.integers(0, MAP_TAGS, MAP_N).tolist()
    us = rng.random(MAP_N).tolist()
    for k, j, t, u in zip(ks, js, ts, us):
        a = groups[k][j]
        ab = actors[a]
        if u >= 0.98:
            ctx = {b: c for b, c in births[k].items() if b <= a}
            if ctx:
                n_key_rm += 1
                beyond = n_key_rm % MAP_BEYOND == 0
                wire_ctx = {actors[b]: c for b, c in ctx.items()}
                if beyond:
                    wire_ctx[ab] = counter[a] + MAP_N
                    kinds["key remove, deferred"] += 1
                else:
                    kinds["key remove"] += 1
                    for b, c in ctx.items():
                        if births[k].get(b, 0) <= c:
                            births[k].pop(b, None)
                    for tt in range(MAP_TAGS):
                        e = entries.get((k, tt))
                        if e:
                            for b, c in ctx.items():
                                if e.get(b, 0) <= c:
                                    e.pop(b, None)
                streams[ab].append([1, wire_ctx, [keys[k]]])
                continue
        counter[a] += 1
        c = counter[a]
        e = entries.setdefault((k, t), {})
        if 0.88 <= u < 0.98 and e:
            child = [1, tags[t], {actors[b]: cc for b, cc in e.items()}]
            e.clear()
            kinds["tag remove"] += 1
        else:
            child = [0, tags[t], [ab, c]]
            e[a] = c
            kinds["tag add"] += 1
        births[k][a] = c
        streams[ab].append([0, [ab, c], keys[k], child])
    return {ab: s for ab, s in streams.items() if s}, kinds


def timed_catalogue_compaction(remote, adapter, accel) -> tuple:
    """A fresh replica over ``remote`` compacts it.  Returns the core,
    the wall from ``Core.open``, the trace snapshot and the launches."""
    from crdt_enc_tpu_torch import Core, MemoryStorage
    from crdt_enc_tpu_torch.utils import trace

    async def go():
        core = await Core.open(catalogue_options(MemoryStorage(remote), adapter,
                                                 accel))
        await core.compact()
        return core

    reset_launches()
    trace.reset()
    t0 = time.perf_counter()
    core = run_async(go())
    wall = time.perf_counter() - t0
    return core, wall, trace.snapshot(), read_launches()


def read_back(remote, adapter) -> bytes:
    """A third replica (host loop) reads the compacted remote."""
    from crdt_enc_tpu_torch import Core, HostAccelerator, MemoryStorage, canonical_bytes

    async def go():
        core = await Core.open(catalogue_options(MemoryStorage(remote), adapter,
                                                 HostAccelerator()))
        await core.read_remote()
        return core.with_state(canonical_bytes)

    return run_async(go())


def compare_catalogue(label: str, dev_bytes: bytes, host_bytes: bytes,
                      back: bytes) -> None:
    print(f"  {label}: bytes equal to the host loop: {dev_bytes == host_bytes} "
          f"({len(dev_bytes)} bytes); read back: {back == dev_bytes}", flush=True)
    if dev_bytes != host_bytes or back != dev_bytes:
        raise AssertionError(f"{label}: the device compaction disagrees with "
                             "the host loop or does not read back")


def phase_catalogue_map(device) -> dict:
    """15a: the shared tag index (CrdtMap<orset>) at config 3's width,
    compacted from an encrypted in-memory remote by a device ``Core`` —
    the pipelined route through ``MapFoldSession``, its finish's scatter
    phase on the card — and by the host loop on a byte-identical copy."""
    import torch

    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.core.adapters import map_adapter

    t0 = time.perf_counter()
    streams, kinds = map_history()
    files = actor_files(streams)
    n_ops = sum(len(s) for s in streams.values())
    t1 = time.perf_counter()
    remote = run_async(seal_remote(files, map_adapter()))
    host_remote = copy_memory_remote(remote)
    print(f"  {n_ops} ops ({kinds}) from {len(streams)} actors over {MAP_K} "
          f"keys x {MAP_TAGS} tags, groups of {MAP_GROUP}, built in "
          f"{t1 - t0:.1f}s; {len(files)} op files sealed in "
          f"{time.perf_counter() - t1:.1f}s", flush=True)
    out = {"ops": n_ops, "kinds": kinds, "op_files": len(files),
           "actors": len(streams), "keys": MAP_K, "tags": MAP_TAGS}
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    dev, wall, snap, launches = timed_catalogue_compaction(
        remote, map_adapter(), TorchAccelerator(device=device))
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    print_compaction("device Core.compact()", wall, snap)
    c = snap["counters"]
    declined = c.get("session_declined_chunks", 0)
    rows = {f: c.get(f"map_rows_{f}", 0)
            for f in ("birth", "child_add", "child_rm", "key_rm")}
    on_card = "map.scatter_device" in snap["spans"]
    print(f"    session: MapFoldSession (scatter phase on the card: {on_card}); "
          f"declined chunks {declined}; rows fed {rows}; card memory peak "
          f"{peak if peak is None else f'{peak / 1e9:.3f} GB'}; launches "
          f"{launches}", flush=True)
    if (declined or not on_card or "session.map_fold" not in snap["spans"]
            or c.get("op_files_bulk_folded") != len(files)):
        raise AssertionError(f"15a: the map compaction left the session's "
                             f"device route (declined {declined}, scatter on "
                             f"the card {on_card})")
    host, host_wall, host_snap, _ = timed_catalogue_compaction(
        host_remote, map_adapter(), HostAccelerator())
    print_compaction("host-loop Core.compact()", host_wall, host_snap)
    dev_bytes = dev.with_state(canonical_bytes)
    deferred = dev.with_state(lambda s: len(s.deferred))
    compare_catalogue("15a map", dev_bytes, host.with_state(canonical_bytes),
                      read_back(remote, map_adapter()))
    print(f"    {dev.with_state(lambda s: len(s.births))} live keys, "
          f"{deferred} removes deferred", flush=True)
    out.update(wall_s=wall, host_wall_s=host_wall, peak_card_bytes=peak,
               declined_chunks=declined, rows=rows, launches=launches,
               spans={k: v["seconds"] for k, v in snap["spans"].items()},
               host_spans={k: v["seconds"]
                           for k, v in host_snap["spans"].items()},
               state_bytes=len(dev_bytes), deferred=deferred)
    return out


def lwwreg_columns(device):
    """Config 4's generator at one key: (ts, actor, value) rows, the
    register's op files, and the kernel's int32 columns on ``device``."""
    import torch

    from crdt_enc_tpu_torch.ops.lww import ts_split

    key, ts, actor, value = gen_lww(LWW_N, 1, LWW_R)
    actors = actor_ids(LWW_R)
    streams: dict = {}
    for t, a, v in zip(ts.tolist(), actor.tolist(), value.tolist()):
        streams.setdefault(actors[a], []).append([t, actors[a], v])
    cols = [torch.from_numpy(x).to(device)
            for x in (key, *ts_split(ts), actor, value)]
    return streams, cols


def phase_catalogue_lwwreg(device, rate: float) -> dict:
    """15b: the LWW register's bulk fold — config 4's 1,000,000 writes as op
    files of one register — through ``fold_payloads`` (exactly one
    ``lww_fold`` launch, at one key) and ``Core.compact()``, each
    byte-equal to the host loop; then K5 at K = 1 against its plain
    version on both routes and in both modes, with its times."""
    import torch

    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.core.adapters import lwwreg_adapter
    from crdt_enc_tpu_torch.models import LWWReg
    from crdt_enc_tpu_torch.ops import lww as L
    from crdt_enc_tpu_torch.ops import lww_fold_cuda as LC
    from crdt_enc_tpu_torch.utils import codec, trace

    streams, cols = lwwreg_columns(device)
    files = actor_files(streams)
    payloads = [codec.pack(ops) for *_, ops in files]
    t0 = time.perf_counter()
    host = LWWReg()
    for s in streams.values():
        for o in s:
            host.apply(o)
    host_s = time.perf_counter() - t0
    host_bytes = canonical_bytes(host)
    out: dict = {"writes": LWW_N, "op_files": len(files), "host_loop_s": host_s}
    accel = TorchAccelerator(device=device)
    state = LWWReg()
    reset_launches()
    trace.reset()
    t0 = time.perf_counter()
    ok = accel.fold_payloads(state, payloads)
    wall = time.perf_counter() - t0
    launches = read_launches()
    snap = trace.snapshot()
    same = canonical_bytes(state) == host_bytes
    print(f"  fold_payloads: {len(payloads)} payloads, wall {wall:.3f}s (host "
          f"loop {host_s:.3f}s); bytes equal to the host loop: {same}; "
          f"launches {launches}; spans " + ", ".join(
              f"{k} {v['seconds'] * 1e3:.1f} ms"
              for k, v in sorted(snap["spans"].items())), flush=True)
    # one launch on the card (a CPU dry run takes the plain version)
    one = int(device.type == "cuda")
    if not ok or not same or launches["lww_fold"] != one:
        raise AssertionError(f"15b fold_payloads: folded {ok}, bytes equal "
                             f"{same}, lww_fold launches {launches['lww_fold']}")
    out["fold_payloads"] = dict(wall_s=wall, launches=launches)

    remote = run_async(seal_remote(files, lwwreg_adapter()))
    host_remote = copy_memory_remote(remote)
    dev, cwall, csnap, claunches = timed_catalogue_compaction(
        remote, lwwreg_adapter(), accel)
    print_compaction("device Core.compact()", cwall, csnap)
    print(f"    launches {claunches}", flush=True)
    hcore, hwall, hsnap, _ = timed_catalogue_compaction(
        host_remote, lwwreg_adapter(), HostAccelerator())
    print_compaction("host-loop Core.compact()", hwall, hsnap)
    compare_catalogue("15b LWW register", dev.with_state(canonical_bytes),
                      hcore.with_state(canonical_bytes),
                      read_back(remote, lwwreg_adapter()))
    if dev.with_state(canonical_bytes) != host_bytes or claunches["lww_fold"] != one:
        raise AssertionError("15b Core.compact(): not the fold's bytes or not "
                             "one lww_fold launch")
    out["compaction"] = dict(wall_s=cwall, host_wall_s=hwall,
                             launches=claunches)

    errs: dict = {}
    V = LWW_V
    for nv in (V, None):
        ref = L.lww_fold_plain(*cols, num_keys=1, num_values=nv)
        for route, mode in LWW_PATHS:
            with lww_path(route, mode):
                geo = LC.plan(LWW_N, 1, cols[0].device)
                got = LC.lww_fold_cuda(*cols, num_keys=1, num_values=nv)
            check_equal(f"lww_fold at K = 1 (N={LWW_N}, num_values={nv}, "
                        f"route={route}, {mode}; {geo.blocks} blocks, "
                        f"{geo.tile_keys} tile keys)", ref, got, errs,
                        "lww_fold")
    N = LWW_N
    ms = time_ms(lambda: LC.lww_fold_cuda(*cols, num_keys=1, num_values=V))
    plain_ms = time_ms(lambda: L.lww_fold_plain(*cols, num_keys=1,
                                                num_values=V))
    nbytes = 20 * N + 17
    bytes_ms = nbytes / rate * 1e3
    ops_ms = 4 * N / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"  lww_fold at K = 1: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)
    out["one_key"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by="bytes" if bytes_ms >= ops_ms
                          else "operations",
                          routes=lww_path_times(cols, 1, V))
    out["max_abs_err"] = errs["lww_fold"]
    return out


def mvreg_snapshots(seed: int = MV_SEED) -> tuple:
    """MV_S register snapshots over MV_R actors holding MV_V (clock, value)
    pairs in all, each clock naming MV_CLOCK actors drawn at random.  The
    first snapshot's writes are all fresh clocks; each later snapshot's
    are half fresh and half successors — the clock of a fresh write of an
    earlier snapshot, not used before, with one counter raised — so the
    merge keeps MV_V minus the successors' count.  Within a snapshot no
    clock dominates another (random supports), so each is an anti-chain
    as per-op apply builds it.  Returns (snapshots, their write ops)."""
    from crdt_enc_tpu_torch.models import MVReg, MVRegOp, VClock

    rng = np.random.default_rng(seed)
    actors = actor_ids(MV_R)
    unused: list = []  # fresh clocks no successor has raised yet
    snaps, ops = [], []
    per = MV_V // MV_S
    for s in range(MV_S):
        reg = MVReg()
        fresh = []
        for j in range(per):
            if s and j % 2:
                clock = dict(unused.pop(int(rng.integers(len(unused)))))
                a = list(clock)[int(rng.integers(len(clock)))]
                clock[a] += int(rng.integers(1, 5))
            else:
                ix = rng.choice(MV_R, MV_CLOCK, replace=False)
                clock = {actors[int(i)]: int(c) for i, c in
                         zip(ix, rng.integers(1, 1000, MV_CLOCK))}
                fresh.append(clock)
            op = MVRegOp(VClock(dict(clock)), f"v{s}-{j}")
            ops.append(op)
            reg.apply(op)
        unused += fresh
        snaps.append(reg)
    return snaps, ops


def phase_catalogue_mvreg(device) -> dict:
    """15c: MV_S MVReg snapshots merged by ``merge_states`` (the dominance
    filter on the card, blocked) and by ``Core.compact()`` over an
    encrypted in-memory remote holding them, and ``fold_payloads`` of
    their write ops; each byte-equal to the host loop."""
    import torch

    from crdt_enc_tpu_torch import (
        Core, HostAccelerator, MemoryRemote, MemoryStorage, TorchAccelerator,
        canonical_bytes,
    )
    from crdt_enc_tpu_torch.core.adapters import mvreg_adapter
    from crdt_enc_tpu_torch.models import MVReg
    from crdt_enc_tpu_torch.ops.mvreg import dominance_block
    from crdt_enc_tpu_torch.utils import codec, trace

    snaps, ops = mvreg_snapshots()
    V = sum(len(s.vals) for s in snaps)

    def copies():
        return [MVReg.from_obj(s.to_obj()) for s in snaps]

    t0 = time.perf_counter()
    first, *rest = copies()
    host = HostAccelerator().merge_states(first, rest)
    host_s = time.perf_counter() - t0
    host_bytes = canonical_bytes(host)
    R = len({a for s in snaps for c, _ in s.vals for a in c.counters})
    block = dominance_block(V, R)
    accel = TorchAccelerator(device=device)
    first, *rest = copies()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    trace.reset()
    t0 = time.perf_counter()
    got = accel.merge_states(first, rest)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else None
    snap = trace.snapshot()
    same = canonical_bytes(got) == host_bytes
    print(f"  merge_states: {MV_S} snapshots, V = {V} pairs over R = {R} "
          f"actors -> {len(got.vals)} kept; wall {wall:.3f}s (host loop "
          f"{host_s:.3f}s); filter block {block} rows ({block * V * R} "
          f"booleans a comparison); card memory peak "
          f"{peak if peak is None else f'{peak / 1e9:.3f} GB'}; bytes equal to "
          f"the host loop: {same}; spans " + ", ".join(
              f"{k} {v['seconds'] * 1e3:.1f} ms"
              for k, v in sorted(snap["spans"].items())), flush=True)
    if not same or "merge.device" not in snap["spans"]:
        raise AssertionError("15c merge_states: not the host loop's bytes or "
                             "not the device filter")
    out = {"snapshots": MV_S, "V": V, "R": R, "kept": len(got.vals),
           "merge": dict(wall_s=wall, host_loop_s=host_s, block=block,
                         peak_card_bytes=peak)}

    remote = MemoryRemote()
    by_value = {op.value: op for op in ops}

    async def seal_all():
        per = MV_V // MV_S
        for i in range(MV_S):
            core = await Core.open(catalogue_options(
                MemoryStorage(remote), mvreg_adapter(), HostAccelerator()))
            await core.apply_ops([by_value[f"v{i}-{j}"] for j in range(per)])
            await core._compact_seal()

    run_async(seal_all())
    host_remote = copy_memory_remote(remote)
    dev, cwall, csnap, _ = timed_catalogue_compaction(remote, mvreg_adapter(),
                                                      accel)
    print_compaction("device Core.compact()", cwall, csnap)
    hcore, hwall, hsnap, _ = timed_catalogue_compaction(
        host_remote, mvreg_adapter(), HostAccelerator())
    print_compaction("host-loop Core.compact()", hwall, hsnap)
    compare_catalogue("15c MVReg", dev.with_state(canonical_bytes),
                      hcore.with_state(canonical_bytes),
                      read_back(remote, mvreg_adapter()))
    if (dev.with_state(canonical_bytes) != host_bytes
            or csnap["counters"].get("states_merged") != MV_S
            or "merge.device" not in csnap["spans"]):
        raise AssertionError("15c Core.compact(): not merge_states' bytes or "
                             "not the device merge of every snapshot")
    out["compaction"] = dict(wall_s=cwall, host_wall_s=hwall)

    payloads = [codec.pack([[op.clock.to_obj(), op.value]
                            for op in ops[i : i + COMPACT_OPS_PER_FILE]])
                for i in range(0, len(ops), COMPACT_OPS_PER_FILE)]
    t0 = time.perf_counter()
    host_fold = HostAccelerator().fold_ops(MVReg(), list(ops))
    fold_host_s = time.perf_counter() - t0
    state = MVReg()
    trace.reset()
    t0 = time.perf_counter()
    ok = accel.fold_payloads(state, payloads)
    fwall = time.perf_counter() - t0
    same = canonical_bytes(state) == canonical_bytes(host_fold) == host_bytes
    print(f"  fold_payloads: {len(ops)} write ops in {len(payloads)} payloads, "
          f"wall {fwall:.3f}s (host loop {fold_host_s:.3f}s); bytes equal to "
          f"the host loop and the merge: {same}", flush=True)
    if not ok or not same or "merge.device" not in trace.snapshot()["spans"]:
        raise AssertionError("15c fold_payloads: declined, not the host loop's "
                             "bytes, or not the device filter")
    out["fold_payloads"] = dict(wall_s=fwall, host_loop_s=fold_host_s,
                                ops=len(ops))
    return out


def other_histories() -> dict:
    """15d: a small history for each host-by-design type (and the no-op
    type), built on the port's models: adapter factory name -> per-actor
    streams in wire form."""
    from crdt_enc_tpu_torch.models import MerkleReg, SeqList

    rng = np.random.default_rng(OTHER_SEED)
    actors = actor_ids(8)
    out = {}
    out["gset_adapter"] = {a: [[int(rng.integers(1000)), f"m{i}"][i % 2]
                               for i in range(60)] for a in actors}
    lst, reg = SeqList(), MerkleReg()
    ls, ms = {a: [] for a in actors}, {a: [] for a in actors}
    for i in range(480):
        a = actors[i % 8]
        if i % 5 == 4 and len(lst):
            op = lst.delete_ctx(int(rng.integers(len(lst))))
        else:
            op = lst.insert_ctx(a, int(rng.integers(len(lst) + 1)), i)
        lst.apply(op)
        ls[a].append(op.to_obj())
        node = reg.write_ctx(int(rng.integers(50)))
        if i % 3:
            reg.apply(node)
        ms[a].append(node.to_obj())
    out["list_adapter"] = ls
    out["merklereg_adapter"] = ms
    out["empty_adapter"] = {a: [None] * 20 for a in actors}
    return out


def phase_catalogue_others(device) -> dict:
    """15d: G-Set, SeqList, MerkleReg and the no-op type compacted by a
    device ``Core`` (the host bulk routes of ``fold_payloads``) and by the
    host loop on a copy: byte-equal, no kernel launched."""
    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.core import adapters

    out = {}
    for name, streams in other_histories().items():
        adapter = getattr(adapters, name)
        files = actor_files(streams, 4)
        remote = run_async(seal_remote(files, adapter()))
        host_remote = copy_memory_remote(remote)
        dev, wall, snap, launches = timed_catalogue_compaction(
            remote, adapter(), TorchAccelerator(device=device))
        host, hwall, _, _ = timed_catalogue_compaction(
            host_remote, adapter(), HostAccelerator())
        label = f"15d {name.removesuffix('_adapter')}"
        print(f"  {label}: {len(files)} op files; device compaction "
              f"{wall:.3f}s, host loop {hwall:.3f}s; launches {launches}",
              flush=True)
        compare_catalogue(label, dev.with_state(canonical_bytes),
                          host.with_state(canonical_bytes),
                          read_back(remote, adapter()))
        if any(launches.values()):
            raise AssertionError(f"{label}: a kernel launched")
        out[name.removesuffix("_adapter")] = dict(
            op_files=len(files), wall_s=wall, host_wall_s=hwall,
            launches=launches)
    return out


def phase_catalogue(device, rate: float) -> dict:
    """Phase 15: the rest of the catalogue through ``Core.compact()`` and the
    accelerator's entry points (15a-d)."""
    import torch

    device = torch.device(device)
    out = {}
    print(f"  15a. CrdtMap<orset> (R={MAP_R}, {MAP_K} keys x {MAP_TAGS} tags, "
          f"N={MAP_N}; encrypted MemoryStorage)", flush=True)
    out["map"] = phase_catalogue_map(device)
    gc.collect()
    print(f"  15b. LWW register (config 4: N={LWW_N}, R={LWW_R}, V={LWW_V}, "
          "one key)", flush=True)
    out["lwwreg"] = phase_catalogue_lwwreg(device, rate)
    gc.collect()
    print(f"  15c. MVReg (S={MV_S} snapshots, V={MV_V} pairs, R={MV_R}, "
          f"{MV_CLOCK} actors a clock)", flush=True)
    out["mvreg"] = phase_catalogue_mvreg(device)
    gc.collect()
    print("  15d. G-Set, SeqList, MerkleReg, empty", flush=True)
    out["others"] = phase_catalogue_others(device)
    return out


# ---- the multi-tenant fold service (phase 16) -----------------------------


def serve_orset_files(N: int, R: int, E: int, seed: int, actors: list,
                      opf: int = FLEET_OPF) -> list:
    """One tenant's OR-Set op files in wire form, bench.py
    --e2e-multitenant's layout: ``gen_columns`` rows (sentinel rows
    dropped) grouped by actor, up to ``opf`` ops a file within one actor,
    dense versions from 1."""
    kind, member, actor, counter = gen_columns(N, R, E, seed)
    live = actor < R
    order = np.argsort(actor[live], kind="stable")
    streams: dict = {}
    for k, m, a, c in zip(kind[live][order].tolist(),
                          member[live][order].tolist(),
                          actor[live][order].tolist(),
                          counter[live][order].tolist()):
        ab = actors[a]
        streams.setdefault(ab, []).append(
            [0, m, [ab, c]] if k == 0 else [1, m, {ab: c}])
    return actor_files(streams, opf)


def serve_gcounter_files(N: int, R: int, seed: int, actors: list) -> list:
    """One G-Counter tenant's op files: N increments over R actors, each
    actor's dots dense from 1."""
    rng = np.random.default_rng(seed)
    who = rng.integers(0, R, N)
    streams: dict = {}
    for a in who.tolist():
        ops = streams.setdefault(actors[a], [])
        ops.append([actors[a], len(ops) + 1])
    return actor_files(streams, FLEET_OPF)


def serve_fleet_spec() -> list:
    """(label, kind, files, snapshots) per tenant; ``files`` in wire form,
    ``snapshots`` a list of (sealer, state obj, cursor obj)."""
    from crdt_enc_tpu_torch import ORSet
    from crdt_enc_tpu_torch.models.orset import op_from_obj

    actors = actor_ids(FLEET_R)
    spec = []
    seed = SERVE_SEED * 10_000
    n_gc = FLEET_GC
    n_orset = FLEET_T - n_gc - FLEET_BIG - FLEET_DECLINE - FLEET_EMPTY
    for t in range(n_orset):
        seed += 1
        files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E, seed, actors)
        snaps = []
        if t < FLEET_SNAP:
            # snapshots sealed by other replicas: each folds the first
            # half of one actor's files, the cursor naming them
            for i in range(FLEET_SNAPSHOTS):
                ab = actors[i]
                mine = [f for f in files if f[0] == ab]
                mine = mine[: max(1, len(mine) // 2)]
                st = ORSet()
                for _, _, ops in mine:
                    for o in ops:
                        st.apply(op_from_obj(o))
                snaps.append((uuid.UUID(int=(1 << 100) + t * 8 + i).bytes,
                              st.to_obj(), {ab: mine[-1][1]}))
        spec.append(("snapshots" if snaps else "orset", "orset", files,
                     snaps))
    for t in range(n_gc):
        seed += 1
        spec.append(("gcounter", "gcounter",
                     serve_gcounter_files(FLEET_N, FLEET_R, seed, actors), []))
    for t in range(FLEET_BIG):
        seed += 1
        spec.append(("oversize", "orset", serve_orset_files(
            FLEET_BIG_N, FLEET_R, FLEET_E, seed, actors), []))
    foreign = uuid.UUID(int=(1 << 120) + 1).bytes
    for t in range(FLEET_DECLINE):
        seed += 1
        files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E, seed, actors)
        # a remove whose context names an actor the decoder's table (the
        # listing plus the state's actors) does not hold: it declines
        ab, v, ops = files[0]
        files[0] = (ab, v, ops + [[1, 7, {foreign: 3}]])
        spec.append(("decline", "orset", files, []))
    for t in range(FLEET_EMPTY):
        spec.append(("empty", "orset", [], []))
    cap_actors = actor_ids(CAP_R)
    for t in range(CAP_T):
        seed += 1
        spec.append(("cells_cap", "orset", serve_orset_files(
            CAP_N, CAP_R, CAP_E, seed, cap_actors), []))
    return spec


async def seal_fleet(spec: list) -> tuple:
    """Every tenant's encrypted in-memory remote (one template writer's
    key and metadata, copied into each remote), its head files and
    snapshots stored, and its tail (the last SERVE_TAIL_PCT% of its
    files) sealed but held back: ``(remotes, tails)``, ``tails[t]`` a
    list of (actor, version, blob)."""
    import asyncio

    from crdt_enc_tpu_torch import (
        Core,
        HostAccelerator,
        MemoryRemote,
        MemoryStorage,
        orset_adapter,
    )

    template = MemoryRemote()
    writer = await Core.open(catalogue_options(
        MemoryStorage(template), orset_adapter(), HostAccelerator()))
    remotes, tails = [], []
    for label, kind, files, snaps in spec:
        remote = MemoryRemote(metas=dict(template.metas))
        store = MemoryStorage(remote)
        n_tail = max(1, len(files) * SERVE_TAIL_PCT // 100) if files else 0
        blobs = []
        for b in range(0, len(files), COMPACT_WRITE_BATCH):
            batch = files[b : b + COMPACT_WRITE_BATCH]
            blobs += await asyncio.gather(*(writer._seal(ops)
                                            for *_, ops in batch))
        head = len(files) - n_tail
        await asyncio.gather(*(store.store_ops(ab, v, blob) for (ab, v, _),
                               blob in zip(files[:head], blobs[:head])))
        for sealer, st, cursor in snaps:
            await store.store_state(await writer._seal([st, cursor, sealer]))
        remotes.append(remote)
        tails.append([(ab, v, blob) for (ab, v, _), blob in
                      zip(files[head:], blobs[head:])])
    return remotes, tails


def serve_open(remotes: list, spec: list, accel, strong: set) -> list:
    """One open ``Core`` per tenant remote; the tenants in ``strong`` pin
    their membership to themselves (``MembershipPolicy(expected=())``),
    so their stable prefix is everything they folded."""
    from crdt_enc_tpu_torch import (
        Core,
        MemoryStorage,
        gcounter_adapter,
        orset_adapter,
    )
    from crdt_enc_tpu_torch.read import MembershipPolicy

    async def go():
        cores = []
        for t, (remote, (_, kind, _, _)) in enumerate(zip(remotes, spec)):
            adapter = orset_adapter() if kind == "orset" else \
                gcounter_adapter()
            opts = catalogue_options(MemoryStorage(remote), adapter, accel)
            if t in strong:
                opts.membership = MembershipPolicy(expected=())
            cores.append(await Core.open(opts))
        return cores

    return run_async(go())


def profiled(fn, device: str):
    """``fn()`` once, with the card's busy time from torch.profiler's CUDA
    trace (kernels, copies, memsets summed).  Returns ``(result, wall s,
    busy s or None)``; None where the trace holds no device time or on
    the CPU."""
    import torch

    if device != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    try:
        for evt in prof.key_averages():
            busy_us += getattr(evt, "self_device_time_total",
                               getattr(evt, "self_cuda_time_total", 0))
    except Exception:  # the profiler is a diagnostic only
        busy_us = 0.0
    return out, wall, (busy_us / 1e6 if busy_us > 0 else None)


def nearest_rank_ms(samples: list, q: float) -> float | None:
    if not samples:
        return None
    s = sorted(samples)
    return s[max(0, int(np.ceil(q * len(s))) - 1)] * 1e3


def serve_numbers(wall: float, busy, ops: int, latencies: list,
                  snap: dict, launches: dict, peak) -> dict:
    return {
        "wall_s": wall,
        "ops": ops,
        "ops_per_s": ops / wall if wall > 0 else None,
        "p50_ms": nearest_rank_ms(latencies, 0.50),
        "p99_ms": nearest_rank_ms(latencies, 0.99),
        "launches": launches,
        "h2d_bytes": snap["counters"].get("h2d_bytes", 0),
        "card_peak_bytes": peak,
        "device_busy_s": busy,
        "idle_share": None if busy is None else max(0.0, 1 - busy / wall),
    }


def print_serve(label: str, n: dict) -> None:
    idle = ("not measured" if n["idle_share"] is None
            else f"{100 * n['idle_share']:.2f}%")
    p50 = "-" if n["p50_ms"] is None else f"{n['p50_ms']:.1f}"
    p99 = "-" if n["p99_ms"] is None else f"{n['p99_ms']:.1f}"
    rate = "-" if n["ops_per_s"] is None else f"{n['ops_per_s']:.0f}"
    peak = ("-" if n["card_peak_bytes"] is None
            else f"{n['card_peak_bytes'] / 1e9:.3f} GB")
    print(f"  {label}: wall {n['wall_s']:.3f} s, {n['ops']} ops, {rate} ops/s, "
          f"tenant p50 {p50} ms p99 {p99} ms, launches "
          f"{ {k: v for k, v in n['launches'].items() if v} }, h2d "
          f"{n['h2d_bytes']} B, card peak {peak}, card idle {idle}",
          flush=True)


def check_tenant_layout(device: str, rate: float) -> tuple:
    """K2 through the tenant layout against its plain version at the
    fleets' bucket shapes (live remove horizons in ``rm0``, padding rows
    at ``actor == R_b`` in every tenant but the last, dummy slots):
    ``(max_abs_err, times)``."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P

    err, out = 0, {}
    for label, (T, E, R, N) in {
        "fleet_a_bucket": (1024, FLEET_E, 8, 512),
        "cells_cap": (CAP_T, CAP_E, CAP_R, CAP_N),
    }.items():
        rng = np.random.default_rng(T + E)
        hi = 1 << 20
        clock0 = rng.integers(0, hi, (T, R)).astype(np.int32)
        add0 = np.where(rng.random((T, E, R)) < 0.2,
                        rng.integers(1, hi, (T, E, R)), 0)
        add0 = np.minimum(add0, clock0[:, None, :])
        # live remove horizons past the clock: the retire path of the fold
        rm0 = np.where(rng.random((T, E, R)) < 0.1,
                       rng.integers(1, 2 * hi, (T, E, R)), 0)
        add0 = np.where(add0 > rm0, add0, 0).astype(np.int32)
        rm0 = np.where(rm0 > clock0[:, None, :], rm0, 0).astype(np.int32)
        kind = (rng.random((T, N)) < 0.1).astype(np.int8)
        member = rng.integers(0, E, (T, N)).astype(np.int32)
        actor = rng.integers(0, R, (T, N)).astype(np.int32)
        counter = rng.integers(1, 2 * hi, (T, N)).astype(np.int32)
        pad = rng.random((T, N)) < 0.2
        pad[-1] = False
        actor[pad] = R
        counter[pad] = 4 * hi
        # the last two slots are dummy slots: zero planes, all padding
        clock0[-2:], add0[-2:], rm0[-2:] = 0, 0, 0
        actor[-2:] = R
        cpu = [torch.from_numpy(x) for x in
               (clock0, add0, rm0, kind, member, actor, counter)]
        want = P.orset_fold_tenants_plain(*cpu, num_members=E,
                                          num_replicas=R)
        dev = [x.to(device) for x in cpu]
        got = P.orset_fold_tenants(*dev, num_members=E, num_replicas=R)
        e = max(max_abs_err(w, g.cpu()) for w, g in zip(want, got))
        err = max(err, e)
        entry = {"T": T, "E": E, "R": R, "N": N, "max_abs_err": e}
        if device == "cuda":
            entry["ms"] = time_ms(lambda: P.orset_fold_tenants(
                *dev, num_members=E, num_replicas=R))
            entry["plain_ms"] = time_ms(lambda: P.orset_fold_tenants_plain(
                *dev, num_members=E, num_replicas=R))
            moved = 4 * T * R * 2 + 4 * T * E * R * 4 + 13 * T * N
            entry["bound_ms"] = moved / rate * 1e3
        out[label] = entry
        print(f"  K2 tenant layout {label} (T={T}, E={E}, R={R}, N={N}): "
              f"max_abs_err {e}"
              + (f", {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f} ms, "
                 f"bound {entry['bound_ms']:.3f} ms)" if "ms" in entry else ""),
              flush=True)
        del cpu, dev, got, want
    return err, out


def phase_serve(device: str, rate: float) -> dict:
    """Phase 16: the port's FoldService over fleets (a) and (b), three
    cycles, every tenant held byte-equal to the host loop's solo
    ``compact()`` on a byte-identical copy, beside the sequential solo
    loop with ``TorchAccelerator``."""
    import torch

    from crdt_enc_tpu_torch import (
        HostAccelerator,
        MemoryStorage,
        TorchAccelerator,
        canonical_bytes,
    )
    from crdt_enc_tpu_torch.obs import runtime as obs_runtime
    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.serve import FoldService
    from crdt_enc_tpu_torch.serve import service as service_mod
    from crdt_enc_tpu_torch.utils import trace

    out: dict = {}
    err, out["tenant_layout"] = check_tenant_layout(device, rate)
    out["max_abs_err"] = err
    if err:
        raise AssertionError("the tenant-layout fold disagrees with its plain "
                             f"version (max_abs_err {err})")
    t0 = time.perf_counter()
    spec = serve_fleet_spec()
    remotes, tails = run_async(seal_fleet(spec))
    labels = [s[0] for s in spec]
    n_ops = [sum(len(f[2]) for f in files) for _, _, files, _ in spec]
    print(f"  {len(spec)} tenants ({ {k: labels.count(k) for k in dict.fromkeys(labels)} }), "
          f"{sum(n_ops)} ops, {sum(len(f) for *_, f, _ in spec)} op files, "
          f"sealed in {time.perf_counter() - t0:.1f} s", flush=True)
    strong = {i for i, l in enumerate(labels) if l == "orset"}
    strong = set(sorted(strong)[:SERVE_STRONG])
    copies = {arm: [copy_memory_remote(r) for r in remotes]
              for arm in ("serve", "torch", "host")}
    del remotes
    t0 = time.perf_counter()
    served = serve_open(copies["serve"], spec, TorchAccelerator(device),
                        strong)
    solo_dev = serve_open(copies["torch"], spec, TorchAccelerator(device),
                          set())
    solo_host = serve_open(copies["host"], spec, HostAccelerator(), strong)
    print(f"  {3 * len(spec)} cores opened in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # ops folded per cycle: the head, then the tail
    head_ops, tail_ops = [], []
    for (_, _, files, _), t in zip(spec, tails):
        n_tail = sum(len(ops) for (ab, v, ops) in files[len(files) - len(t):]) \
            if t else 0
        tail_ops.append(n_tail)
        head_ops.append(sum(len(ops) for *_, ops in files) - n_tail)
    del spec
    gc.collect()

    service = FoldService(served)
    layout_calls = [0]
    real_layout = P.orset_fold_tenant_layout
    plans = []  # what the planner returned this cycle: (buckets, solo)
    real_plan = service_mod.plan_buckets

    def counting_layout(*args, **kw):
        layout_calls[0] += 1
        return real_layout(*args, **kw)

    def recording_plan(*args, **kw):
        plan = real_plan(*args, **kw)
        plans.append(plan)
        return plan

    P.orset_fold_tenant_layout = counting_layout
    service_mod.plan_buckets = recording_plan
    builds_after_first = None
    try:
        for cycle in (1, 2, 3):
            if cycle == 2:
                async def add_tails():
                    for arm in copies.values():
                        for i, t in enumerate(tails):
                            store = MemoryStorage(arm[i])
                            for ab, v, blob in t:
                                await store.store_ops(ab, v, blob)
                run_async(add_tails())
            ops = sum(head_ops) if cycle == 1 else (
                sum(tail_ops) if cycle == 2 else 0)
            reset_launches()
            layout_calls[0] = 0
            plans.clear()
            trace.reset()
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
            builds0 = obs_runtime.build_count()
            results, wall, busy = profiled(
                lambda: run_async(service.run_cycle()), device)
            snap = trace.snapshot()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() if device == "cuda" \
                else None
            lat = [r.latency_s for r in results if r.sealed]
            n = serve_numbers(wall, busy, ops, lat, snap, launches, peak)
            paths = {}
            for r in results:
                paths[r.path] = paths.get(r.path, 0) + 1
            n["paths"] = paths
            n["orset_bucket_folds"] = layout_calls[0]
            n["builds"] = obs_runtime.build_count() - builds0
            n["counters"] = {k: snap["counters"].get(k, 0) for k in (
                "serve_warm_hits", "serve_warm_misses", "delta_device_cuts",
                "delta_files_sealed", "serve_noop_cycles", "serve_solo_spills",
                "serve_continuations", "op_files_loaded")}
            n["spans_s"] = {k: round(v["seconds"], 4) for k, v in
                            snap["spans"].items() if k.startswith("serve.")
                            or k.startswith("delta.")}
            errors = [r.error for r in results if r.error]
            print_serve(f"cycle {cycle} service", n)
            print(f"    paths {paths}; bucket folds {layout_calls[0]}; "
                  f"builds {n['builds']}; {n['counters']}", flush=True)
            print(f"    spans {n['spans_s']}", flush=True)
            if errors:
                raise AssertionError(f"cycle {cycle}: tenant errors {errors[:3]}")
            if cycle == 1:
                # one K2 launch per OR-Set bucket the planner made, one per
                # tenant it spilled to the solo path (one launch each at
                # the oversize tenants' size)
                (buckets, solo), = plans
                orset_buckets = sum(b.kind == "orset" for b in buckets)
                n["orset_buckets"] = orset_buckets
                if layout_calls[0] != orset_buckets or \
                        len(solo) != labels.count("oversize"):
                    raise AssertionError(
                        f"cycle 1: {layout_calls[0]} bucket folds for "
                        f"{orset_buckets} OR-Set buckets, {len(solo)} spills "
                        f"for {labels.count('oversize')} oversize tenants")
            if cycle == 1 and device == "cuda":
                want = orset_buckets + len(solo)
                if launches["orset_fold"] != want:
                    raise AssertionError(
                        f"cycle 1: {launches['orset_fold']} orset_fold launches, "
                        f"expected one per OR-Set bucket ({orset_buckets}) "
                        f"plus one per solo spill ({len(solo)})")
                if launches["orset_merge_many"] != labels.count("snapshots"):
                    raise AssertionError(
                        f"cycle 1: {launches['orset_merge_many']} K4 launches, "
                        f"expected {labels.count('snapshots')}")
            if cycle == 1:
                builds_after_first = obs_runtime.build_count()
            if cycle == 3:
                if set(paths) != {"empty"} or n["counters"][
                        "serve_noop_cycles"] != len(results):
                    raise AssertionError(f"cycle 3 is not quiet: {paths}")
                if any(launches.values()) or n["h2d_bytes"]:
                    raise AssertionError("cycle 3 launched or uploaded")
                if obs_runtime.build_count() != builds_after_first:
                    raise AssertionError("a quiet cycle built a library")
            out[f"cycle{cycle}"] = n
            if cycle < 3:
                for arm, cores, accel_label in (
                        ("torch", solo_dev, "TorchAccelerator"),
                        ("host", solo_host, "HostAccelerator")):
                    reset_launches()
                    trace.reset()
                    lat = []

                    async def loop(cores=cores, lat=lat):
                        t_start = time.perf_counter()
                        for c in cores:
                            await c.compact()
                            lat.append(time.perf_counter() - t_start)

                    _, wall, busy = profiled(
                        lambda: run_async(loop()),
                        device if arm == "torch" else "cpu")
                    sn = serve_numbers(wall, busy, ops, lat, trace.snapshot(),
                                       read_launches(), None)
                    print_serve(f"cycle {cycle} solo loop, {accel_label}", sn)
                    out[f"cycle{cycle}_solo_{arm}"] = sn
            # every tenant equal to the host loop's solo compaction
            for i, (a, h) in enumerate(zip(served, solo_host)):
                if a.with_state(canonical_bytes) != h.with_state(canonical_bytes):
                    raise AssertionError(f"cycle {cycle}: tenant {i} "
                                         f"({labels[i]}) differs from the host loop")
                if cycle < 3 and solo_dev[i].with_state(canonical_bytes) != \
                        h.with_state(canonical_bytes):
                    raise AssertionError(f"cycle {cycle}: tenant {i}: the solo "
                                         "TorchAccelerator loop differs")
            if cycle == 2:
                out["delta_checked"] = run_async(compare_deltas(
                    served, solo_host, labels))
            print(f"    cycle {cycle}: {len(served)} tenants byte-equal to the "
                  "host loop", flush=True)
        reads = run_async(strong_reads(service, served, solo_host, strong))
        out["strong_reads"] = reads
        print(f"  read_strong on {reads} tenants equals the host loop's strong "
              "read", flush=True)
    finally:
        P.orset_fold_tenant_layout = real_layout
        service_mod.plan_buckets = real_plan
        service.close()
    return out


async def compare_deltas(served, solo_host, labels) -> int:
    """Each served OR-Set tenant's cycle-2 delta equals the host loop's
    (the host dict walk), the snapshot names aside (they address
    ciphertexts).  Returns the number of deltas compared."""
    from crdt_enc_tpu_torch.utils import codec

    async def deltas(core):
        out = []
        for a in sorted(await core.storage.list_delta_actors()):
            for _, v, raw in await core.storage.load_deltas([(a, 1)]):
                obj = await core._open_sealed(raw)
                out.append((v, codec.pack(obj[b"d"])))
        return out

    n = 0
    for i, (a, h) in enumerate(zip(served, solo_host)):
        if labels[i] == "gcounter":
            continue
        da, dh = await deltas(a), await deltas(h)
        if da != dh:
            raise AssertionError(f"tenant {i} ({labels[i]}): the device-cut "
                                 "delta differs from the host dict walk")
        n += len(da)
    return n


async def strong_reads(service, served, solo_host, strong) -> int:
    for i in sorted(strong):
        got = await service.read_strong(served[i])
        want = await solo_host[i].read(linearizable=True)
        if got.obj != want.obj or got.consistency != "strong":
            raise AssertionError(f"tenant {i}: read_strong differs from the "
                                 "host loop's strong read")
        if not got.obj.get(b"e"):
            raise AssertionError(f"tenant {i}: the strong read is empty")
    return len(strong)


# ---- the fleet daemon (phase 17) -------------------------------------------


def flaky_storage_class():
    """An in-memory storage whose op listing fails while ``broken``: the
    storage outage the daemon's backoff and quarantine exist for."""
    from crdt_enc_tpu_torch import MemoryStorage

    class FlakyStorage(MemoryStorage):
        broken = False

        async def list_op_actors(self):
            if self.broken:
                raise OSError("injected outage")
            return await super().list_op_actors()

    return FlakyStorage


def daemon_open(remotes: list, kinds: list, accel, flaky: set) -> tuple:
    """One open ``Core`` per tenant remote (``kinds``: "orset" or
    "gcounter"; the tenants in ``flaky`` behind
    :func:`flaky_storage_class`): ``(cores, storages)``."""
    from crdt_enc_tpu_torch import (
        Core,
        MemoryStorage,
        gcounter_adapter,
        orset_adapter,
    )

    flaky_cls = flaky_storage_class()

    async def go():
        cores, stores = [], []
        for t, (remote, kind) in enumerate(zip(remotes, kinds)):
            adapter = orset_adapter() if kind == "orset" else \
                gcounter_adapter()
            store = (flaky_cls if t in flaky else MemoryStorage)(remote)
            cores.append(await Core.open(catalogue_options(store, adapter,
                                                           accel)))
            stores.append(store)
        return cores, stores

    return run_async(go())


def capture_service(daemon) -> list:
    """Record every ``FoldService.run_cycle`` the daemon makes: a list of
    result lists, appended per service cycle."""
    got = []
    real = daemon.service.run_cycle

    async def run_cycle(tenants=None):
        results = await real(tenants)
        got.append(results)
        return results

    daemon.service.run_cycle = run_cycle
    return got


def fleet_plane_bytes() -> list:
    """Each tenant's int32 planes (clock, add, rm) at its full width."""
    n_a = FLEET_T - FLEET_EMPTY
    return [4 * (FLEET_R + 2 * FLEET_E * FLEET_R)] * n_a + [0] * FLEET_EMPTY \
        + [4 * (CAP_R + 2 * CAP_E * CAP_R)] * CAP_T


def daemon_cfg():
    from crdt_enc_tpu_torch.serve import DaemonConfig

    planes = fleet_plane_bytes()
    return DaemonConfig(quarantine_after=DAEMON_QUARANTINE_AFTER,
                        quarantine_probe_every=DAEMON_PROBE_EVERY,
                        tenant_cost_bytes=-(-sum(planes) // len(planes)))


def outcomes(report: dict) -> dict:
    """tid -> outcome, the fold path left out (a spilled tenant folds
    ``solo`` on the card and ``perop`` on the host reference)."""
    return {tid: ("sealed" if r["outcome"] == "sealed" else
                  "error" if r["outcome"] == "error" else
                  "polled" if r["outcome"] == "polled" else "visited")
            for tid, r in report["results"].items()}


def daemon_entries(daemon) -> list:
    return [(tid, e.state, e.failures, e.eligible_at, e.last_sealed,
             e.quarantined_at) for tid in daemon.tenant_ids
            for e in [daemon.entry(tid)]]


def healthz_daemon(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                timeout=10) as resp:
        return json.loads(resp.read())["daemon"]


def phase_daemon(device: str) -> dict:
    """Phase 17a: a ``FleetDaemon`` over the card's copy of phase 16's
    fleet and one over the host reference's copy, cycle by cycle: the
    same schedule, the same bytes, K2 once per planned OR-Set bucket and
    solo spill, K4 once per snapshot tenant's first compaction; a sample
    of the card's tenants equal to host-loop ``compact()`` of copies of
    their remotes once the daemon settles."""
    from crdt_enc_tpu_torch import (
        Core,
        HostAccelerator,
        MemoryStorage,
        TorchAccelerator,
        canonical_bytes,
        gcounter_adapter,
        orset_adapter,
    )
    from crdt_enc_tpu_torch.obs import runtime as obs_runtime
    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.serve import FleetDaemon
    from crdt_enc_tpu_torch.serve import service as service_mod
    from crdt_enc_tpu_torch.serve.daemon import ACTIVE
    from crdt_enc_tpu_torch.utils import trace

    cfg = daemon_cfg()
    out: dict = {"config": {
        "batch": cfg.batch, "seal_empty": cfg.serve.seal_empty,
        "quarantine_after": cfg.quarantine_after,
        "quarantine_probe_every": cfg.quarantine_probe_every,
        "tenant_cost_bytes": cfg.tenant_cost_bytes,
        "flaky": DAEMON_FLAKY, "outage_cycles": DAEMON_OUTAGE}}
    t0 = time.perf_counter()
    spec = serve_fleet_spec()
    remotes, tails = run_async(seal_fleet(spec))
    labels = [s[0] for s in spec]
    orset_plain = [i for i, l in enumerate(labels) if l == "orset"]
    flaky = set(orset_plain[-DAEMON_FLAKY:])
    with_ops = {i for i, (_, _, files, _) in enumerate(spec) if files}
    snapshot_tenants = {i for i, l in enumerate(labels) if l == "snapshots"}
    kinds = [kind for _, kind, _, _ in spec]
    ops_per = [sum(len(f[2]) for f in files) for _, _, files, _ in spec]
    del spec
    copies = {arm: [copy_memory_remote(r) for r in remotes]
              for arm in ("card", "host")}
    sample = sorted({i for i in range(len(labels))
                     if i % DAEMON_SOLO_EVERY == 0}
                    | {i for i, l in enumerate(labels)
                       if l not in ("orset", "gcounter")} | flaky)
    solo = {i: copy_memory_remote(remotes[i]) for i in sample}
    del remotes
    accels = {"card": TorchAccelerator(device), "host": HostAccelerator()}
    fleet = {arm: daemon_open(copies[arm], kinds, accels[arm], flaky)
             for arm in ("card", "host")}
    print(f"  {len(labels)} tenants x 2 copies opened in "
          f"{time.perf_counter() - t0:.1f} s ({sum(ops_per)} ops; flaky "
          f"tenants {sorted(flaky)[:3]}...)", flush=True)
    gc.collect()
    daemons = {"card": FleetDaemon(fleet["card"][0], daemon_cfg(),
                                   live_port=0),
               "host": FleetDaemon(fleet["host"][0], daemon_cfg())}
    served = capture_service(daemons["card"])
    live_port = daemons["card"].service.live.port
    tid_index = {f"t{i}": i for i in range(len(labels))}

    layout_calls = [0]
    real_layout = P.orset_fold_tenant_layout
    plans = []
    real_plan = service_mod.plan_buckets

    def counting_layout(*args, **kw):
        layout_calls[0] += 1
        return real_layout(*args, **kw)

    def recording_plan(*args, **kw):
        plan = real_plan(*args, **kw)
        plans.append(plan)
        return plan

    def set_broken(flag: bool) -> None:
        for arm in fleet:
            for t in flaky:
                fleet[arm][1][t].broken = flag

    P.orset_fold_tenant_layout = counting_layout
    service_mod.plan_buckets = recording_plan
    cycles = []
    compacted_once: set = set()
    health_quarantined = None
    tails_added_at = quiet_cycle = None
    set_broken(True)
    try:
        for cycle in range(1, DAEMON_MAX_CYCLES + 1):
            if cycle == DAEMON_OUTAGE + 1:
                set_broken(False)
            # -- the card's cycle: counts from 0 just before, read just after
            reset_launches()
            layout_calls[0] = 0
            plans.clear()
            served.clear()
            trace.reset()
            builds0 = obs_runtime.build_count()
            report, wall, busy = profiled(
                lambda: run_async(daemons["card"].run_cycle()), device)
            launches = read_launches()
            snap = trace.snapshot()
            card_plans = list(plans)
            card_layout = layout_calls[0]
            results = [r for rs in served for r in rs]
            # -- the host reference's cycle
            t_host = time.perf_counter()
            host_report = run_async(daemons["host"].run_cycle())
            host_wall = time.perf_counter() - t_host
            builds = obs_runtime.build_count() - builds0
            # -- the same schedule, the same bytes
            if host_report["selected"] != report["selected"] or \
                    outcomes(host_report) != outcomes(report):
                raise AssertionError(f"daemon cycle {cycle}: the card and the "
                                     "host reference scheduled differently")
            if daemon_entries(daemons["card"]) != daemon_entries(daemons["host"]):
                raise AssertionError(f"daemon cycle {cycle}: tenant entries "
                                     "differ between the copies")
            sealed = [tid for tid, r in report["results"].items()
                      if r["outcome"] == "sealed"]
            for tid in sealed:
                i = tid_index[tid]
                if fleet["card"][0][i].with_state(canonical_bytes) != \
                        fleet["host"][0][i].with_state(canonical_bytes):
                    raise AssertionError(f"daemon cycle {cycle}: tenant {tid} "
                                         f"({labels[i]}) differs from the host "
                                         "reference")
            # -- K2 once per planned OR-Set bucket and solo spill, K4 once
            # per snapshot tenant's first compaction
            orset_buckets = sum(b.kind == "orset" for bs, _ in card_plans
                                for b in bs)
            spills = sum(len(solo) for _, solo in card_plans)
            first = {tid_index[tid] for tid, r in report["results"].items()
                     if r["outcome"] not in ("polled", "error")} - compacted_once
            compacted_once |= first
            want_k4 = len(first & snapshot_tenants)
            if card_layout != orset_buckets:
                raise AssertionError(f"daemon cycle {cycle}: {card_layout} "
                                     f"bucket folds for {orset_buckets} OR-Set "
                                     "buckets")
            if device == "cuda":
                if launches["orset_fold"] != orset_buckets + spills:
                    raise AssertionError(
                        f"daemon cycle {cycle}: {launches['orset_fold']} "
                        f"orset_fold launches, expected {orset_buckets} "
                        f"buckets + {spills} solo spills")
                if launches["orset_merge_many"] != want_k4:
                    raise AssertionError(
                        f"daemon cycle {cycle}: {launches['orset_merge_many']} "
                        f"K4 launches, expected {want_k4} snapshot tenants")
            if cycle > 1 and builds:
                raise AssertionError(f"daemon cycle {cycle} built {builds} "
                                     "libraries")
            h = daemons["card"].health()
            n = serve_numbers(wall, busy, sum(r.rows for r in results),
                              [r.latency_s for r in results if r.sealed],
                              snap, launches, None)
            n.update({
                "cycle": cycle,
                "host_wall_s": host_wall,
                "compacted": len(report["selected"]),
                "polled": sum(r["outcome"] == "polled"
                              for r in report["results"].values()),
                "sealed": len(sealed),
                "errors": sum(r["outcome"] == "error"
                              for r in report["results"].values()),
                "orset_buckets": orset_buckets, "solo_spills": spills,
                "k4_expected": want_k4, "builds": builds,
                "states": report["states"],
                "gauges": {k: v for k, v in snap["gauges"].items()
                           if k.startswith("daemon_")},
                "counters": {k: v for k, v in snap["counters"].items()
                             if k.startswith("daemon_")},
                "spans_s": {k: round(v["seconds"], 4) for k, v in
                            snap["spans"].items() if k.startswith("daemon.")},
            })
            cycles.append(n)
            idle = ("not measured" if n["idle_share"] is None
                    else f"{100 * n['idle_share']:.2f}%")
            p50 = "-" if n["p50_ms"] is None else f"{n['p50_ms']:.1f}"
            p99 = "-" if n["p99_ms"] is None else f"{n['p99_ms']:.1f}"
            print(f"  cycle {cycle}: wall {wall:.3f} s (host reference "
                  f"{host_wall:.3f} s), compacted {n['compacted']}, polled "
                  f"{n['polled']}, sealed {n['sealed']}, errors {n['errors']}, "
                  f"{n['ops']} ops folded, tenant p50 {p50} ms p99 {p99} ms, "
                  f"K2 {launches['orset_fold']} ({orset_buckets} buckets + "
                  f"{spills} spills), K4 {launches['orset_merge_many']}, h2d "
                  f"{n['h2d_bytes']} B, card idle {idle}, states "
                  f"{report['states']}, gauges {n['gauges']}", flush=True)
            if h["quarantined"] == DAEMON_FLAKY and health_quarantined is None:
                health_quarantined = healthz_daemon(live_port)
                print(f"    /healthz daemon section: {health_quarantined}",
                      flush=True)
            if cycle == quiet_cycle:
                if n["ops"] or launches["orset_fold"] or \
                        launches["orset_merge_many"]:
                    raise AssertionError("the quiet daemon cycle folded or "
                                         "launched")
                break
            entries = [daemons["card"].entry(f"t{i}")
                       for i in range(len(labels))]
            if tails_added_at is None:
                if all(entries[i].last_sealed >= 0 for i in with_ops - flaky):
                    async def add_tails():
                        for arm in copies.values():
                            for i, t in enumerate(tails):
                                store = MemoryStorage(arm[i])
                                for ab, v, blob in t:
                                    await store.store_ops(ab, v, blob)
                    run_async(add_tails())
                    tails_added_at = cycle
                    print(f"    every tenant with ops but the flaky ones has "
                          f"sealed: 10% tails appended after cycle {cycle}",
                          flush=True)
            elif all(e.state == ACTIVE for e in entries) and all(
                    entries[i].last_sealed > tails_added_at for i in with_ops) \
                    and not any(
                        (c.last_replication_status or {}).get(
                            "backlog", {}).get("files", 1)
                        for c in fleet["card"][0]):
                quiet_cycle = cycle + 1  # the backlog is zero: one quiet cycle
        else:
            raise AssertionError(f"the daemon did not settle within "
                                 f"{DAEMON_MAX_CYCLES} cycles")
        if health_quarantined is None:
            raise AssertionError("the flaky tenants were never all quarantined")
        health_recovered = healthz_daemon(live_port)
        print(f"    /healthz daemon section before the drain: "
              f"{health_recovered}", flush=True)
        if health_recovered["quarantined"] or health_recovered["active"] != \
                len(labels):
            raise AssertionError("the quarantined tenants did not recover")
        for i, (a, b) in enumerate(zip(fleet["card"][0], fleet["host"][0])):
            if a.with_state(canonical_bytes) != b.with_state(canonical_bytes):
                raise AssertionError(f"tenant {i} ({labels[i]}) differs from "
                                     "the host reference after the daemon run")

        async def solo_check():
            # the tails land in the solo copies too; a fresh host-loop
            # replica then compacts each one, with no service or daemon
            t_s = time.perf_counter()
            for i in sample:
                store = MemoryStorage(solo[i])
                for ab, v, blob in tails[i]:
                    await store.store_ops(ab, v, blob)
                adapter = orset_adapter() if kinds[i] == "orset" else \
                    gcounter_adapter()
                ref = await Core.open(catalogue_options(store, adapter,
                                                        HostAccelerator()))
                await ref.compact()
                if ref.with_state(canonical_bytes) != \
                        fleet["card"][0][i].with_state(canonical_bytes):
                    raise AssertionError(
                        f"tenant {i} ({labels[i]}) differs from a host-loop "
                        "compact() of a copy of its remote")
            return time.perf_counter() - t_s

        solo_wall = run_async(solo_check())
        print(f"  {len(sample)} tenants of the card's copy (every "
              f"{DAEMON_SOLO_EVERY}th, every special class, every flaky one) "
              f"equal to a host-loop compact() of a copy of their remotes "
              f"({solo_wall:.1f} s)", flush=True)
        t_drain = time.perf_counter()
        errs = run_async(daemons["card"].drain())
        drain_wall = time.perf_counter() - t_drain
        errs_host = run_async(daemons["host"].drain())
        if errs or errs_host:
            raise AssertionError(f"drain checkpoint failures: {errs} {errs_host}")
        print(f"  drain: {drain_wall:.3f} s ({len(labels)} checkpoints)",
              flush=True)

        async def reopen_all():
            t_r = time.perf_counter()
            for i, (core, store) in enumerate(zip(*fleet["card"])):
                again = await Core.open(catalogue_options(
                    store, core.adapter, accels["card"]))
                if not again.opened_from_checkpoint or again.with_state(
                        canonical_bytes) != core.with_state(canonical_bytes):
                    raise AssertionError(
                        f"tenant {i} ({labels[i]}): the warm reopen after the "
                        f"drain differs ({again.checkpoint_fallback_reason})")
            return time.perf_counter() - t_r

        reopen_wall = run_async(reopen_all())
        print(f"  {len(labels)} tenants reopened warm from the drain's "
              f"checkpoints in {reopen_wall:.1f} s, bytes equal", flush=True)
    finally:
        P.orset_fold_tenant_layout = real_layout
        service_mod.plan_buckets = real_plan
        for d in daemons.values():
            if d.state != "drained":
                d.service.close()
    out.update({
        "tenants": len(labels), "cycles": cycles,
        "tails_after_cycle": tails_added_at, "quiet_cycle": quiet_cycle,
        "healthz_quarantined": health_quarantined,
        "healthz_recovered": health_recovered,
        "solo_checked": len(sample), "solo_check_s": solo_wall,
        "drain_s": drain_wall, "reopen_warm_s": reopen_wall,
        "launches": {k: sum(c["launches"][k] for c in cycles)
                     for k in KERNELS},
    })
    return out


def phase_daemon_cli(device: str, root: str) -> dict:
    """Phase 17b: ``python -m crdt_enc_tpu_torch.tools.daemon run`` in
    process over CLI_T encrypted FsStorage tenants at fleet (a)'s shape,
    each then reopened warm by a host-loop core and equal to a host-loop
    ``compact()`` of a copy of its remote."""
    import asyncio

    from crdt_enc_tpu_torch import Core, FsStorage, HostAccelerator, \
        canonical_bytes
    from crdt_enc_tpu_torch.tools import daemon as daemon_cli

    base = os.path.join(root, "daemon_cli")
    actors = actor_ids(FLEET_R)
    t0 = time.perf_counter()

    async def write():
        for t in range(CLI_T):
            remote = os.path.join(base, f"r{t}")
            writer = await Core.open(compaction_options(
                base, f"w{t}", remote, HostAccelerator()))
            files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E,
                                      CLI_SEED * 100 + t, actors)
            blobs = await asyncio.gather(*(writer._seal(ops)
                                           for *_, ops in files))
            store = FsStorage(os.path.join(base, f"w{t}"), remote)
            await asyncio.gather(*(store.store_ops(ab, v, blob) for
                                   (ab, v, _), blob in zip(files, blobs)))
            shutil.copytree(remote, os.path.join(base, f"h{t}"))

    run_async(write())
    print(f"  {CLI_T} FsStorage tenants written under {base} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    argv = ["run", "--device", device, "--cycles", str(CLI_CYCLES),
            "--port", "0", "--interval", "0"]
    for t in range(CLI_T):
        argv += ["--tenant",
                 f"{os.path.join(base, f'l{t}')}={os.path.join(base, f'r{t}')}"]
    reset_launches()
    t0 = time.perf_counter()
    rc = daemon_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = read_launches()
    print(f"  tools.daemon run: exit {rc} in {wall:.2f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if rc != 0:
        raise AssertionError(f"tools.daemon run exited {rc}")
    if device == "cuda" and launches["orset_fold"] < 1:
        raise AssertionError("tools.daemon run launched no orset_fold")

    async def check():
        for t in range(CLI_T):
            served = await Core.open(compaction_options(
                base, f"l{t}", os.path.join(base, f"r{t}"), HostAccelerator(),
                create=False))
            host = await Core.open(compaction_options(
                base, f"hl{t}", os.path.join(base, f"h{t}"),
                HostAccelerator()))
            await host.compact()
            if not served.opened_from_checkpoint:
                raise AssertionError(f"CLI tenant {t} did not reopen warm")
            if served.with_state(canonical_bytes) != host.with_state(
                    canonical_bytes):
                raise AssertionError(f"CLI tenant {t} differs from the host "
                                     "loop's compact()")

    run_async(check())
    print(f"  {CLI_T} tenants reopened warm, each equal to a host-loop "
          "compact() of a copy", flush=True)
    return {"tenants": CLI_T, "cycles": CLI_CYCLES, "exit": rc,
            "wall_s": wall, "launches": launches}


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
    from crdt_enc_tpu_torch import native

    for label, load in (("native library (crypto, codec, io)", native.load),
                        ("state library (statebuild.cpp)", native.load_state)):
        t0 = time.perf_counter()
        load()
        print(f"  {label} built and loaded in {time.perf_counter() - t0:.2f}s",
              flush=True)

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
    gc.collect()
    torch.cuda.empty_cache()
    k4_err, k4_shape = phase_k4_compaction_shape("cuda", rate)
    errs["orset_merge_many"] = max(errs["orset_merge_many"], k4_err)
    times["orset_merge_many"]["compaction_shape"] = k4_shape

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

    root = tempfile.mkdtemp(prefix="crdt-compaction-")
    try:
        return run_from_phase_10(root, cols, cols2, launches, errs, times,
                                 k3_errs, k3, name, t_start)
    finally:
        close_loop()
        shutil.rmtree(root, ignore_errors=True)


def run_from_phase_10(root, cols, cols2, launches, errs, times, k3_errs, k3,
                      name, t_start) -> int:
    """Phases 10 to 17 and the closing lines.  Phase 10's compaction remote
    lives under ``root`` until phase 14 has compacted it twice more."""
    import torch

    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    print(f"== 10. compaction end to end (config 3: N={N}, R={R}, E={E}, "
          f"{COMPACT_OPS_PER_FILE} ops a file, S={COMPACT_SNAPSHOTS} "
          "snapshots; encrypted FsStorage)", flush=True)
    print(device_line(), flush=True)
    print(f"  remote under {root} ({fs_type(root)})", flush=True)
    files = compaction_files(cols, actor_ids(R))
    clock, version = compactor_clocks(cols, files, R)
    compaction, live = phase_compaction(files, E, R, "cuda", root)
    del cols, cols2
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 11. the stream route past 2^22 rows (N={STREAM_N}, E={E}, "
          f"R={R})", flush=True)
    print(device_line(), flush=True)
    stream = phase_stream("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 12. fold sessions ({len(files)} op files of phase 10, "
          f"{SESSION_FEED_FILES} a feed)", flush=True)
    print(device_line(), flush=True)
    sessions = phase_sessions(files, actor_ids(R), "cuda")
    del files
    gc.collect()

    print(f"== 13. config 5 in the sparse regime (N={CFG5_N}, R={CFG5_R}, "
          f"E={CFG5_E}, {COMPACT_OPS_PER_FILE} ops a file; encrypted "
          "MemoryStorage)", flush=True)
    print(device_line(), flush=True)
    config5 = phase_config5("cuda")
    gc.collect()

    print(f"== 14. the plane cache at config-3 width ({len(CACHE_SEEDS)} "
          f"batches of fresh dots, N={N} each) and incremental compaction "
          f"with deltas ({TAIL_OPS}-op tails over phase 10's remote)",
          flush=True)
    print(device_line(), flush=True)
    plane_cache = phase_plane_cache(E, R, "cuda")
    reset_launches()
    incremental = phase_incremental(live, clock, version, E, R, "cuda", root,
                                    compaction)
    inc_launches = {k: sum(incremental[f"round{r}"]["launches"][k]
                           for r in (2, 3)) for k in KERNELS}
    print(f"  launches over rounds 2 and 3 (device compactions only): "
          f"{inc_launches}", flush=True)
    del live
    gc.collect()
    print(f"== 14c. the plane cache through Core.compact() (E={CC_E}, "
          f"R={CC_R}, N={CC_N}; {CC_ROUNDS} tails of {CC_TAIL_OPS} ops; "
          "encrypted FsStorage)", flush=True)
    print(device_line(), flush=True)
    cache_compaction = phase_cache_compaction("cuda", root)
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 15. the rest of the catalogue (CrdtMap<orset> N={MAP_N}, "
          f"R={MAP_R}; LWW register N={LWW_N}; MVReg S={MV_S}, V={MV_V}; "
          "G-Set, SeqList, MerkleReg, empty; encrypted MemoryStorage)",
          flush=True)
    print(device_line(), flush=True)
    catalogue = phase_catalogue("cuda", memory_rate(name))
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 16. the multi-tenant fold service ({FLEET_T} tenants of "
          f"{FLEET_N} ops, R={FLEET_R}, E={FLEET_E}, {FLEET_OPF}-op files; "
          f"{CAP_T} tenants at the cells cap, E={CAP_E}, R={CAP_R}, "
          f"N={CAP_N}; three cycles; encrypted MemoryStorage)", flush=True)
    print(device_line(), flush=True)
    serve = phase_serve("cuda", memory_rate(name))
    errs["orset_fold"] = max(errs["orset_fold"], serve["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()

    print(f"== 17. the fleet daemon (FleetDaemon over phase 16's {FLEET_T} + "
          f"{CAP_T} tenants, the card's copy and the host reference's; "
          f"{DAEMON_FLAKY} tenants down for {DAEMON_OUTAGE} cycles; then "
          f"tools.daemon run over {CLI_T} FsStorage tenants)", flush=True)
    print(device_line(), flush=True)
    daemon = phase_daemon("cuda")
    gc.collect()
    daemon["cli"] = phase_daemon_cli("cuda", root)

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
            entry["stream_launches"] = {
                r: stream[r]["launches"] for r in ("fold_payloads", "fold_ops")}
            entry["session_launches"] = sessions["device_stream"]["launches"]
        entry["compaction_launches"] = compaction["launches"][kname]
        entry["incremental_launches"] = {
            "plane_cache_fold_ops": plane_cache["fold_ops"]["launches"][kname],
            "plane_cache_fold_payloads":
                plane_cache["fold_payloads"]["launches"][kname],
            "compaction_rounds_2_3": inc_launches[kname],
            "plane_cache_compaction": cache_compaction["launches"][kname]}
        entry["config5_launches"] = {
            r: config5[r]["launches"][kname]
            for r in ("session", "fold_encrypted_stream", "fold_payloads",
                      "fold_ops", "Core.compact()")}
        entry["catalogue_launches"] = {
            "map_compaction": catalogue["map"]["launches"][kname],
            "lwwreg_fold_payloads":
                catalogue["lwwreg"]["fold_payloads"]["launches"][kname],
            "lwwreg_compaction":
                catalogue["lwwreg"]["compaction"]["launches"][kname],
            "gset_list_merklereg_empty": sum(
                o["launches"][kname] for o in catalogue["others"].values())}
        if kname == "lww_fold":
            entry["one_key"] = catalogue["lwwreg"]["one_key"]
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       catalogue["lwwreg"]["max_abs_err"])
            entry["match"] = entry["max_abs_err"] == 0
        entry["serve_launches"] = {
            f"cycle{c}": serve[f"cycle{c}"]["launches"][kname]
            for c in (1, 2, 3)}
        entry["daemon_launches"] = {
            "fleet": daemon["launches"][kname],
            "per_cycle": [c["launches"][kname] for c in daemon["cycles"]],
            "cli": daemon["cli"]["launches"][kname]}
        if kname == "orset_fold":
            entry["serving"] = {
                "route": "tenant layout: (E_b, T*R_b) planes, padding at "
                         "actor = T*R_b, one launch per OR-Set bucket",
                "tenant_layout": serve["tenant_layout"],
                "bucket_folds": {f"cycle{c}": serve[f"cycle{c}"][
                    "orset_bucket_folds"] for c in (1, 2, 3)}}
        kernels.append(entry)
    print(f"chip_smoke wall {time.perf_counter() - t_start:.1f}s", flush=True)
    print(json.dumps({"compaction": compaction}), flush=True)
    print(json.dumps({"stream": stream, "sessions": sessions}), flush=True)
    print(json.dumps({"config5": config5}), flush=True)
    print(json.dumps({"incremental": {
        "plane_cache": plane_cache, "compaction": incremental,
        "plane_cache_compaction": cache_compaction}}), flush=True)
    print(json.dumps({"catalogue": catalogue}), flush=True)
    print(json.dumps({"serve": serve}), flush=True)
    print(json.dumps({"daemon": daemon}), flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
