#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (crdt_enc_tpu_torch) on one card.

The main workloads are BASELINE configs 3 and 4 at full width: the OR-Set
compaction path (1,000,000 add/remove ops over 10,000 replicas and 4,096
members, made from a seed by the port bench's ``gen_columns``, which
equals bench.py's: about 10% removes, dead removes as ``actor = R``
sentinel rows) and the LWW-map
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
   and the skewed batches; then the merge and the stacking kernel
   (``orset_stack_cells``) at the compaction's shape, S = 9, E = 4,096,
   R = 5,000: the stacks rebuilt from all the merge stacks' cells equal
   them, and from STACK_CELLS of those cells equal the plain version on
   the card, with both times and the bound (the zero fill's bytes and 8
   bytes a cell);
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
11. the stream route past 2^22 rows: 5,242,880 config-3-width rows
   (1.25 x ``STREAM_CHUNK_ROWS``) through ``TorchAccelerator().fold_payloads``
   (in-memory op-file payloads) and ``fold_ops`` (op objects), each two
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
   tag index (CrdtMap<orset>) at config 3's width — 125,000 ops (an
   eighth of its backlog) over 10,000 actors, 1,024 keys of 8 tags, 16 writers a key —
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
   fleets' bucket shapes, then fleet (a), 512 tenants at bench.py
   --e2e-multitenant's shape (384 ops over 4 replicas and 64 members,
   24-op files; 1/8 G-Counters, 2 oversize solo spills, 2 decoder
   declines, 4 empty, 4 with 3 snapshots; 2,048 until phase 23 joined,
   1,024 until phase 24 did),
   and fleet (b), one bucket at
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
18. the adversarial simulator (``crdt_enc_tpu_torch.sim``), whose odd
   replicas, ``service`` steps and ``daemon`` steps fold on the card
   while even replicas, the oracle refold and fsck stay on the host
   reference: (a) the fleet-scale schedule (seed 42, 8 replicas x 500
   steps, every fault class) twice on the card and once on the CPU
   (plain versions): ok, every fault class fired, a service cycle, three
   equal fingerprints, K2 launched in the card run; (b) 32 all-vocabulary
   schedules (4 replicas x 100 steps, deltas, daemon and strong reads) at
   P = 8 through one ``PopulationSubstrate(device="cuda")``: no
   violation, 24 refills, every fault class fired, the first four equal
   to their serial card runs and all 32 fingerprints equal to the same
   population on the CPU; (c) bench.py's simulator shape (8 replicas x
   250 steps, 4 serial schedules and 16 at P = 8) on the card, again
   under torch.profiler for the card's idle share, and on the CPU:
   schedules/s, steps/s, launches, ``h2d_bytes``; (d) ``tools.sim
   replay tests/data/sim`` and ``tools.daemon selftest --device cuda`` in
   process, each exit 0, the selftest launching K2;
19. the operator's read side, the migration tools and the device-decode
   experiment: (a) phase 10's config-3 op files, encrypted, through
   ``TorchAccelerator.fold_encrypted_stream`` (the port's own chunking and
   producer count) with events on, recorded through ``MetricsSink``,
   byte-equal to the host loop; ``obs_report export-trace --check-overlap
   stream.ingest:stream.reduce`` exits 0 (chunk k+1's ingest started
   inside chunk k's reduce), then ``report``, ``prom``, ``gap``; (b)
   ``diff`` against a second run; (c) four ``Core``s on the card, each
   compacting its own replica of one encrypted FsStorage remote (one
   tenant of phase 16's shape) later in its history, each with its own
   sink file: ``obs_report fleet`` exits 0 and its stable watermark is the
   pointwise min of the four cursors; (d) a ``FoldService`` over phase
   16's mix at 256 tenants, three cycles with the sink on: ``slo`` exits
   0, ``gap`` on cycle 1 names its critical path; (e) ``gap`` and
   ``trend`` over BENCH_LOCAL.jsonl and ``fleet`` over the committed
   device files, equal to the committed goldens; (f) ``simcov`` over
   phase 18's co-fire matrix; (g) ``export_reference`` (log mode) of a
   64-writer MVReg history (32 files x 8 ops each) to the reference
   format, ``import_reference --compact --device cuda`` into an encrypted
   FsStorage remote and the same import with ``HostAccelerator``, equal
   canonical states; exported back and imported again, the same bytes;
   (h) bench.py's device-decode shape (200,000 add ops, 100,000 actors,
   48 ops a file): the device arm on the card, the host vectorized arm
   and the native decoder, equal columns, ``h2d_bytes`` equal to the
   upload, each arm's time; a fold session with ``CRDT_DEVICE_DECODE``
   on and off, equal state bytes;
20. the static-analysis twin over the checkout: ``python3 -m
   crdt_enc_tpu_torch.tools.analyze --diff-baseline --json
   --expect-json-version 2`` as a subprocess from the repo root must exit
   0 (no unsuppressed error, no stale baseline entry); one line with the
   files, the errors, warnings and suppressed findings per rule, the stale
   entries and the analyzer's elapsed seconds, and the K2 launch's chain
   from ``--effects FoldService._run_cycle`` beside K2's host enqueue time
   (phase 5) and the kernels' ``nvcc`` build wall (phase 2), the two
   numbers its baseline entry rests on; the machine has no JAX, so the run
   also shows the twin imports none;
21. the mesh on shards of the card (``phase_mesh``: sharded ops at
   config-3 width, a (2, 2) compaction, a (2, 1) service and daemon, an
   NCCL group of one);
22. the consumer replica: (a) the RFC 7748, 8032, 5869 and 8439 vectors
   of tests/test_torch_x25519_keys.py through the port's hand-written
   X25519, Ed25519, HKDF-SHA256 and native ChaCha20-Poly1305, with neither
   ``cryptography`` nor JAX loaded; (b) phase 10's op files and 8
   snapshots sealed into an encrypted in-memory remote whose keys the
   ``X25519KeyCryptor`` seals to three writer identities and a consumer's,
   then a consumer with ``checkpoint_on_read=True`` on the card and one
   with the host loop on a byte-identical copy: the first read (the
   snapshot merge launches K4 once, one reseal), a quiet poll (no
   reseal, no launch), a 10,000-op tail (one reseal), a warm reopen from
   that checkpoint, each step byte-equal across the two, and an identity
   outside the roster refused; (c) ``fold_payload_stream`` over
   ``decrypt_blobs_chunked`` of the same op files in 8 chunks and
   ``fold_payloads`` over them opened in one batch, each byte-equal to the
   host loop's state, with K2's launches on the dense route;
23. the bench entry points: ``crdt_enc_tpu_torch.bench``'s ten modes (the
   config-3 fold, streaming, device decode, multitenant and its (2, 1)
   mesh arm on shards of the card, daemon, idle cycle, warm open, delta,
   strong read, and the simulator serial and at P = 2), the five
   ``benchmarks.suite`` configs, ``benchmarks.compaction_e2e`` (its
   children in process) and ``benchmarks.streaming_phases``, in process
   at their ``--smoke`` sizes with ``--device cuda``: each prints one
   record on the card (``backend`` "cuda", the card's name) with every
   byte-equality gate true and a roofline share under 100% where it
   reports one, appended to one ``--record`` file, over which ``python3
   -m crdt_enc_tpu_torch.tools.obs_report trend`` exits 0; the kernel
   launches per entry come from its record;
24. the settings surface: (a) config 5's op files through ``fold_payloads``
   of ``TorchAccelerator(sparse_device=True)`` (the COO fold on the card)
   and of the default accelerator (the native host fold), byte-equal, both
   walls and the card's peak memory, no fold kernel launched; (b) an
   encrypted ``FsStorage`` remote compacted twice (a tail between) by a
   card ``Core`` and a host-loop ``Core`` under ``CRDT_REPL_SAMPLE=0
   CRDT_DELTA=0``: no ``repl.status`` span, no delta file, equal states,
   against a card control under the defaults that samples and seals a
   delta; (c) phase 19 (d)'s 256 tenants through one ``FoldService``
   cycle at the defaults and one at ``ServeConfig(producers=2,
   io_width=4)``: equal paths, rows and states and the same K2 launches;
   (d) a ``FleetDaemon(interval_auto=True)`` over 16 of them on an
   injected clock: ``next_interval`` goes from ``interval_max_s`` to
   ``interval_min_s`` while every tenant misses the freshness target
   (``CRDT_SLO_FRESHNESS_LAG=-1``) and back once the window has passed;
then the kernels line and the result line.  Phase 5 also times the merge
at the compaction's own shape (S = 9, E = 4,096, R = 5,000) against its
plain version, and phases 5 and 9 give the merge and K3's shape their
back-to-back and host-enqueue times.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one
card.  A run that stalls past ``WATCHDOG_S`` (1,180 s, just under the
1,200 s a run may take) prints every thread's stack, removes its
temporary directory and exits nonzero.  ``python3 chip_smoke.py
--stall-loop SECONDS`` runs only phase 18 (b)'s serial-equality check,
again and again, and dumps the stacks of a pass that stalls; ``python3
chip_smoke.py --consumer`` runs phases 1, 2 and 22 alone, ``python3
chip_smoke.py --settings`` phases 1, 2 and 24 (its last line is phase
24's JSON), and ``python3 chip_smoke.py --bench`` phases 1–9 and 23 (its
last line is phase 23's JSON, after the kernels line).  Without a CUDA device, or without the package beside it, it exits
nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import faulthandler
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

# the package beside this script: its bench's workload generators and the
# card's memory rates are the ones every phase below uses
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from crdt_enc_tpu_torch.bench import (  # noqa: E402
    actor_bytes_table,
    gen_columns,
    peak_bytes_per_s,
)

N_ROWS, N_REPLICAS, N_MEMBERS = 1_000_000, 10_000, 4096
# seconds after which a stalled run dumps its threads' stacks and exits:
# just under the 1,200 s a run may take
WATCHDOG_S = 1_180
# the directories a stalled run removes before it exits
_CLEANUP_DIRS: list[str] = []
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
# the cells the nine states of a config-3 compaction hold (the benchmark's
# orset3-merge8: eight snapshots of 625 actors and the replica's own)
STACK_CELLS = 215_000
# phase 11: 1.25 x STREAM_CHUNK_ROWS config-3-width rows (two chunks, the
# second partial), as op files of STREAM_FILE_OPS ops; cut from 2.5 x when
# phase 22 joined and from 1.5 x when phase 24 did, to keep the script
# inside its time limit
STREAM_N, STREAM_SEED, STREAM_FILE_OPS = 5_242_880, 11, 1024
# phase 12: op files fed to a session per chunk
SESSION_FEED_FILES = 2048
# phase 13: BASELINE config 5 (benchmarks/suite.py bench_streaming, bench.py
# e2e): 200k ops over 100k replicas and 1,024 members, up to 48 ops a file
# within one actor, from gen_columns' seed 5
CFG5_N, CFG5_R, CFG5_E, CFG5_SEED = 200_000, 100_000, 1024, 5
# phase 14: the plane cache's three config-3 batches (the first is phase
# 3's), and the incremental compaction's 1% tails (10,000 ops a round, as
# COMPACT_OPS_PER_FILE-op files) in TAIL_ROUNDS rounds after phase 10's
# (one since phase 24 joined, two before; tests/test_torch_delta.py holds
# longer chains on the CPU)
CACHE_SEEDS = (SEED, SEED2, 13)
TAIL_OPS, TAIL_SEED, TAIL_ROUNDS = 10_000, 14, (2,)
# phase 14c: the plane cache through Core.compact() where the dense route
# takes the tails: config 3's 4,096 members over config 2's 1,000
# replicas (E*R = 4,096,000 cells, below SPARSE_MIN_CELLS = 2^22), a
# 100,000-op history (config 2's count) and 1% tails
CC_E, CC_R, CC_N, CC_SEED = 4096, PN_R, PN_N, 15
CC_TAIL_OPS, CC_ROUNDS, CC_TAIL_SEED = 1_000, 4, 16

# phase 15: the rest of the catalogue at config 3's fleet and backlog.
# (a) the shared tag index (examples/tags_map.py): CrdtMap<orset> ops over
# 10,000 actors, 1,024 keys of 8 tags, each key written by a fixed group of
# 16 actors; every MAP_BEYOND-th key remove defers for good.  A quarter of
# config 3's 1M-op backlog: the host-loop reference applies ~70 us an op
# (70.3 s for 1M ops on the H100 machine's host), which alone would take
# the phase past its share of the script's time (half until phase 22
# joined, a quarter until phase 24 did)
MAP_N, MAP_R, MAP_K, MAP_TAGS, MAP_GROUP = N_ROWS // 8, N_REPLICAS, 1024, 8, 16
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
# phases 16 and 17 run fleet (a) at 1/SERVE_SCALE of that mix (512
# tenants: 64 G-Counters, 2 oversize, 2 declines, 4 empty, 4 with
# snapshots); cut from the whole mix when phase 23 joined (since the
# bench's --e2e-multitenant and --e2e-daemon modes measure fleets at the
# JAX bench's full size) and from half of it when phase 24 did
SERVE_SCALE = 4
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
# phase 18: the adversarial simulator at the JAX package's own acceptance
# sizes: the fleet-scale schedule (seed 42, 8 replicas x 500 steps, every
# fault class; tests/test_simulation.py), the 32-schedule all-vocabulary
# population at P = 8 (4 replicas x 100 steps, 6 members;
# tests/test_population.py) and bench.py's simulator shape (8 replicas x
# 250 steps, seeds 0-3 serial and 0-15 at P = 8).
SIM_FLEET = (42, 8, 500)
SIM_POP_N, SIM_POP_P, SIM_POP_R, SIM_POP_STEPS, SIM_POP_MEMBERS = \
    32, 8, 4, 100, 6
SIM_BENCH_R, SIM_BENCH_STEPS, SIM_BENCH_SERIAL, SIM_BENCH_POP = 8, 250, 4, 16
# phase 19: (c) OBS_FLEET_DEVICES cores over one tenant of phase 16's shape;
# (d) phase 16's mix at 1/OBS_SCALE of its size (256 tenants: 32
# G-Counters, 2 with 3 snapshots, 1 oversize, 1 decline, 2 empty); (g) the
# reference example's MVReg<_, Uuid> as MIG_ACTORS writers x MIG_FILES op
# files x MIG_OPS ops, written in MIG_GROUPS turns a round (256 files a
# writer took 303 s on the card's machine, ~3 ms an exported and ~7 ms an
# imported file on its 9p root, so the depth is cut to 32); (h) bench.py's
# device_decode_exp shape (bench.py:541): DD_N add ops over DD_R actors,
# DD_OPF ops a file, each arm's best of DD_ITERS, the session fed DD_CHUNKS
# packed chunks
OBS_FLEET_DEVICES, OBS_FLEET_SEED, OBS_SCALE = 4, 37, 8
MIG_ACTORS, MIG_FILES, MIG_OPS, MIG_GROUPS, MIG_SEED = 64, 32, 8, 8, 31
DD_N, DD_R, DD_OPF, DD_ITERS, DD_SEED, DD_CHUNKS = \
    200_000, 100_000, 48, 5, 7, 8

# float32 outside the tensor cores is the table's nearest peak rate for the
# kernels' int32 ALU work; the memory rates are the bench's
# (crdt_enc_tpu_torch.bench.peak_bytes_per_s)
CUDA_CORE_OPS_PER_S = 67e12


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

    actors = actor_bytes_table(R)
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
    actors = actor_bytes_table(LWW_R)
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
    actors = actor_bytes_table(GC_R)
    g_ops = [Dot(actors[a], c) for a, c in zip(actor.tolist(), counter.tolist())]
    rng = np.random.default_rng(2)
    actor = rng.integers(0, PN_R, PN_N, dtype=np.int32)
    sign = (rng.random(PN_N) < 0.3).astype(np.int8)
    counter = running_count(actor * 2 + sign, PN_R * 2)
    actors = actor_bytes_table(PN_R)
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
    stack_err, stack = phase_stack_cells(stacks, rate)
    return errs["orset_merge_many"], out, stack_err, stack


def phase_stack_cells(stacks, rate: float):
    """The stacking kernel at the compaction's shape, on the K4 stacks of
    ``phase_k4_compaction_shape``: rebuilt from all their cells, the stacks
    equal them exactly; from STACK_CELLS of those cells (drawn from the
    seed, the count a config-3 compaction's nine states hold) the kernel
    equals the plain version on the card bit for bit.  Its single-call,
    back-to-back and host-enqueue times, the plain time and the bound
    (the zero fill's bytes and 8 bytes a cell).  Returns (max_abs_err,
    the times)."""
    import torch

    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_merge_cuda as M

    _, adds, rms = stacks
    S, E, R = adds.shape
    rows, counts = [], []
    for stack in (adds, rms):
        for s in range(S):
            flat = stack[s].reshape(-1)
            idx = torch.nonzero(flat).squeeze(1)
            rows.append(torch.stack([idx.int(), flat[idx]], 1))
            counts.append(len(idx))
    cells = torch.cat(rows).contiguous()
    offsets = torch.tensor([0, *np.cumsum(counts).tolist()],
                           dtype=torch.int64, device=adds.device)
    del rows
    errs: dict = {}
    check_equal(f"stacks from all {len(cells)} cells of the merge's stacks "
                f"(S={S}, E={E}, R={R})", (adds, rms),
                P.orset_stack_cells(cells, offsets, S, E, R), errs,
                "orset_stack_cells")
    gen = torch.Generator(device=adds.device).manual_seed(K4_SEED)
    keep = torch.randperm(len(cells), generator=gen,
                          device=adds.device)[:STACK_CELLS].sort().values
    few, few_offsets = cells[keep].contiguous(), torch.searchsorted(keep,
                                                                    offsets)
    check_equal(f"stacks from {len(few)} of those cells",
                P.orset_stack_cells_plain(few, few_offsets, S, E, R),
                M.orset_stack_cells_cuda(few, few_offsets, S, E, R), errs,
                "orset_stack_cells")

    def kernel():
        return M.orset_stack_cells_cuda(few, few_offsets, S, E, R)

    nbytes = 2 * S * E * R * 4 + 8 * len(few) + 8 * (2 * S + 1)
    out = dict(S=S, E=E, R=R, cells=len(few), all_cells=len(cells),
               ms=time_ms(kernel),
               plain_ms=time_ms(lambda: P.orset_stack_cells_plain(
                   few, few_offsets, S, E, R)),
               all_cells_ms=time_ms(lambda: M.orset_stack_cells_cuda(
                   cells, offsets, S, E, R)),
               back_to_back_ms=time_stream_ms(kernel),
               host_enqueue_ms=host_enqueue_ms(kernel),
               bound_ms=nbytes / rate * 1e3, bound_by="bytes")
    print(f"  orset_stack_cells at S={S}, E={E}, R={R}, {len(few)} cells: "
          f"kernel {out['ms']:.4f} ms ({len(cells)} cells "
          f"{out['all_cells_ms']:.4f} ms), back to back "
          f"{out['back_to_back_ms']:.4f} ms, host enqueue "
          f"{out['host_enqueue_ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"bound {out['bound_ms']:.4f} ms (bytes: {nbytes / 1e6:.1f} MB)",
          flush=True)
    return errs["orset_stack_cells"], out


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
            or launches["orset_merge_many"] != 1
            or launches["orset_stack_cells"] != 1):
        raise AssertionError(
            f"the compaction's launches {launches} do not match its session "
            f"mode {session.mode} (fold {expected_fold}) and one merge of "
            "stacks built from the states' cells")
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
    """STREAM_N config-3-width rows, 1.25 x ``STREAM_CHUNK_ROWS``, through
    ``TorchAccelerator().fold_payloads`` and ``fold_ops``: each one fold
    launch a chunk (the counts reset just before each route and read just
    after), each state equal to one fold launch over all rows and to the
    plain fold on the CPU.  Returns the launches, walls and peaks."""
    import torch

    from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops import orset_fold_cuda as F

    E, R, N = N_MEMBERS, N_REPLICAS, STREAM_N
    actors = actor_bytes_table(R)
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
    actors = actor_bytes_table(R)
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

    actors = actor_bytes_table(R)
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
    consumer with ``delta=False``; then in each of TAIL_ROUNDS a 1% tail
    (TAIL_OPS ops, one file each for ~210 actors at their next versions)
    lands in both phase
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
    actors = actor_bytes_table(R)
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
        for rnd in TAIL_ROUNDS:
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
    actors = actor_bytes_table(R)
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
    actors = actor_bytes_table(MAP_R)
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
    actors = actor_bytes_table(LWW_R)
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
    actors = actor_bytes_table(MV_R)
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
    actors = actor_bytes_table(8)
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


def serve_fleet_spec(scale: int = 1, cap: bool = True) -> list:
    """(label, kind, files, snapshots) per tenant; ``files`` in wire form,
    ``snapshots`` a list of (sealer, state obj, cursor obj).  ``scale``
    divides every class's count (phase 19's mix); ``cap`` adds fleet (b),
    the tenants at the cells cap."""
    from crdt_enc_tpu_torch import ORSet
    from crdt_enc_tpu_torch.models.orset import op_from_obj

    actors = actor_bytes_table(FLEET_R)
    spec = []
    seed = SERVE_SEED * 10_000
    n_gc, n_big, n_decline, n_empty, n_snap = (
        n if scale == 1 else max(1, n // scale)
        for n in (FLEET_GC, FLEET_BIG, FLEET_DECLINE, FLEET_EMPTY,
                  FLEET_SNAP))
    n_orset = FLEET_T // scale - n_gc - n_big - n_decline - n_empty
    for t in range(n_orset):
        seed += 1
        files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E, seed, actors)
        snaps = []
        if t < n_snap:
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
    for t in range(n_big):
        seed += 1
        spec.append(("oversize", "orset", serve_orset_files(
            FLEET_BIG_N, FLEET_R, FLEET_E, seed, actors), []))
    foreign = uuid.UUID(int=(1 << 120) + 1).bytes
    for t in range(n_decline):
        seed += 1
        files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E, seed, actors)
        # a remove whose context names an actor the decoder's table (the
        # listing plus the state's actors) does not hold: it declines
        ab, v, ops = files[0]
        files[0] = (ab, v, ops + [[1, 7, {foreign: 3}]])
        spec.append(("decline", "orset", files, []))
    for t in range(n_empty):
        spec.append(("empty", "orset", [], []))
    cap_actors = actor_bytes_table(CAP_R)
    for t in range(CAP_T if cap else 0):
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
    spec = serve_fleet_spec(scale=SERVE_SCALE)
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
    n_empty = FLEET_EMPTY // SERVE_SCALE
    n_a = FLEET_T // SERVE_SCALE - n_empty
    return [4 * (FLEET_R + 2 * FLEET_E * FLEET_R)] * n_a + [0] * n_empty \
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
    spec = serve_fleet_spec(scale=SERVE_SCALE)
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
    actors = actor_bytes_table(FLEET_R)
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


def sim_counters() -> dict:
    from crdt_enc_tpu_torch.utils import trace

    return dict(trace.snapshot()["counters"])


def sim_run(label: str, fn, device: str, *, profile: bool = False) -> dict:
    """``fn()`` once with the kernel counts zeroed before and read after
    (and, with ``profile``, the card's busy time from torch.profiler):
    ``{"out", "wall_s", "launches", "h2d_bytes", "device_busy_s",
    "idle_share"}``."""
    before = sim_counters().get("h2d_bytes", 0)
    reset_launches()
    if profile:
        out, wall, busy = profiled(fn, device)
    else:
        t0 = time.perf_counter()
        out = fn()
        wall, busy = time.perf_counter() - t0, None
    launches = read_launches()
    run = {"out": out, "wall_s": wall, "launches": launches,
           "h2d_bytes": sim_counters().get("h2d_bytes", 0) - before,
           "device_busy_s": busy,
           "idle_share": None if busy is None else max(0.0, 1 - busy / wall)}
    print(f"  {label}: {wall:.2f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }, h2d "
          f"{run['h2d_bytes']} B"
          + ("" if busy is None else
             f", card busy {busy:.3f} s, idle share {run['idle_share']:.4f}"),
          flush=True)
    return run


def sim_fired(results) -> set:
    return {k for r in results for k, v in r.fault_stats.items() if v}


def sim_numbers(run: dict, results) -> dict:
    steps = sum(r.steps_run for r in results)
    return {"schedules": len(results), "steps": steps,
            "wall_s": run["wall_s"],
            "schedules_per_s": len(results) / run["wall_s"],
            "steps_per_s": steps / run["wall_s"],
            "launches": run["launches"], "h2d_bytes": run["h2d_bytes"],
            "device_busy_s": run["device_busy_s"],
            "idle_share": run["idle_share"]}


def phase_sim(device: str) -> dict:
    """Phase 18: the adversarial simulator with its device replicas, its
    service and its daemon folding on ``device``, held against the same
    histories folded with the kernels' plain versions on the CPU.

    (a) the fleet-scale schedule twice on the device and once on the CPU:
    ok, every fault class fired, a service cycle ran, three equal
    fingerprints, K2 launched in the first device run; (b) the
    32-schedule population at P = 8 through one device substrate: no
    violation, 24 refills, every fault class fired, serial equality of
    the first four on the device, and every fingerprint equal to the same
    population through a CPU substrate; (c) bench.py's shape, serial and
    at P = 8, on the device (timed, then again under torch.profiler for
    the idle share) and on the CPU; (d) ``tools.sim replay`` of the
    committed fixtures and ``tools.daemon selftest`` in process."""
    import logging

    from crdt_enc_tpu_torch.sim import (
        CoFireMatrix,
        FaultConfig,
        PopulationReport,
        PopulationSubstrate,
        generate,
        run_population,
        run_schedule,
        verify_serial_equality,
    )
    from crdt_enc_tpu_torch.tools import daemon as daemon_cli
    from crdt_enc_tpu_torch.tools import sim as sim_cli

    # the quarantine warnings of torn reads are the faults doing their
    # work: counted in the results, not logged a line each
    log = logging.getLogger("crdt_enc_tpu_torch")
    level = log.level
    log.setLevel(logging.ERROR)
    out: dict = {}
    try:
        faults = FaultConfig.all_faults()
        seed, n, steps = SIM_FLEET
        fleet = generate(seed, n, steps, faults)
        card = sim_run(f"(a) fleet {n}x{steps} on {device}",
                       lambda: run_schedule(fleet, device=device), device)
        again = sim_run(f"(a) fleet again on {device}",
                        lambda: run_schedule(fleet, device=device), device)
        plain = sim_run("(a) fleet on cpu (plain versions)",
                        lambda: run_schedule(fleet, device="cpu"), "cpu")
        res = card["out"]
        for r in (res, again["out"], plain["out"]):
            if not r.ok:
                raise AssertionError(f"fleet schedule violated: {r.violation}")
        missing = set(FaultConfig.CLASSES) - sim_fired([res])
        if missing:
            raise AssertionError(f"fault classes never fired: {missing}")
        if res.service_cycles < 1:
            raise AssertionError("no service cycle in the fleet schedule")
        fps = {res.fingerprint, again["out"].fingerprint,
               plain["out"].fingerprint}
        if len(fps) != 1:
            raise AssertionError(f"fleet fingerprints differ: {fps}")
        if device == "cuda" and card["launches"]["orset_fold"] < 1:
            raise AssertionError("the fleet schedule launched no orset_fold")
        out["fleet"] = {
            "seed": seed, "replicas": n, "steps": steps,
            "fingerprint": res.fingerprint,
            "fault_stats": dict(res.fault_stats),
            "checks": res.checks_run, "service_cycles": res.service_cycles,
            "quarantined": res.quarantined,
            "transient": res.transient_missing_key,
            "device": sim_numbers(card, [res]),
            "device_again": sim_numbers(again, [again["out"]]),
            "cpu": sim_numbers(plain, [plain["out"]])}
        print(f"  (a) ok, fingerprint {res.fingerprint[:16]} on both runs and "
              f"the CPU, faults {dict(res.fault_stats)}, "
              f"{res.service_cycles} service cycles, {res.checks_run} checks",
              flush=True)

        def population(dev):
            scheds = [generate(s, SIM_POP_R, SIM_POP_STEPS, faults,
                               members=SIM_POP_MEMBERS, deltas=True,
                               daemon=True, strong_reads=True)
                      for s in range(SIM_POP_N)]
            sub = PopulationSubstrate(dev)
            try:
                return run_population(scheds, population=SIM_POP_P,
                                      substrate=sub)
            finally:
                sub.close()

        pop = sim_run(f"(b) population {SIM_POP_N} at P={SIM_POP_P} on "
                      f"{device}", lambda: population(device), device)
        pop_cpu = sim_run("(b) population on cpu", lambda: population("cpu"),
                          "cpu")
        rep = pop["out"]
        if rep.violations:
            raise AssertionError(f"population violations: "
                                 f"{[(s.seed, r.violation) for s, r in rep.violations]}")
        if rep.refills != SIM_POP_N - SIM_POP_P:
            raise AssertionError(f"population refills {rep.refills}")
        missing = set(FaultConfig.CLASSES) - sim_fired(rep.results)
        if missing:
            raise AssertionError(f"population: classes never fired {missing}")
        sample = PopulationReport(schedules=rep.schedules[:4],
                                  results=rep.results[:4])
        problems = verify_serial_equality(sample, device=device)
        if problems:
            raise AssertionError(f"serial equality: {problems}")
        differ = [s.seed for s, a, b in zip(rep.schedules, rep.results,
                                             pop_cpu["out"].results)
                  if a.fingerprint != b.fingerprint]
        if differ:
            raise AssertionError(f"population fingerprints differ from the "
                                 f"CPU's for seeds {differ}")
        out["population"] = {
            "schedules": SIM_POP_N, "lanes": SIM_POP_P,
            "refills": rep.refills,
            "strong_reads": sum(r.strong_reads for r in rep.results),
            "strong_timeouts": sum(r.strong_timeouts for r in rep.results),
            "daemon_cycles": sum(r.daemon_cycles for r in rep.results),
            "service_cycles": sum(r.service_cycles for r in rep.results),
            "device": sim_numbers(pop, rep.results),
            "cpu": sim_numbers(pop_cpu, pop_cpu["out"].results)}
        # the fault x vocabulary co-fire matrix of (a) and (b), which
        # phase 19 renders with obs_report simcov
        coverage = CoFireMatrix()
        coverage.record(fleet, res)
        for s, r in zip(rep.schedules, rep.results):
            coverage.record(s, r)
        out["coverage"] = coverage.to_obj()
        print(f"  (b) no violation, {rep.refills} refills, serial equality "
              f"on 4, {SIM_POP_N} fingerprints equal to the CPU's; "
              f"{out['population']['strong_reads']} strong reads, "
              f"{out['population']['daemon_cycles']} daemon cycles",
              flush=True)

        def bench(dev, lanes):
            if lanes == 1:
                return [run_schedule(generate(s, SIM_BENCH_R, SIM_BENCH_STEPS,
                                              faults), device=dev)
                        for s in range(SIM_BENCH_SERIAL)]
            return run_population(
                [generate(s, SIM_BENCH_R, SIM_BENCH_STEPS, faults)
                 for s in range(SIM_BENCH_POP)],
                population=lanes, device=dev).results

        print(device_line(), flush=True)
        thr = {}
        for mode, lanes in (("serial", 1), (f"p{SIM_POP_P}", SIM_POP_P)):
            runs = {}
            for dev, prof in ((device, False), (device, True), ("cpu", False)):
                key = dev + ("_profiled" if prof else "")
                runs[key] = sim_run(
                    f"(c) {mode} {SIM_BENCH_R}x{SIM_BENCH_STEPS} on {key}",
                    lambda dev=dev: bench(dev, lanes), dev, profile=prof)
                bad = [r.violation for r in runs[key]["out"] if not r.ok]
                if bad:
                    raise AssertionError(f"bench schedules violated: {bad}")
            fps = {tuple(r.fingerprint for r in v["out"])
                   for v in runs.values()}
            if len(fps) != 1:
                raise AssertionError(f"(c) {mode}: fingerprints differ")
            thr[mode] = {k: sim_numbers(v, v["out"]) for k, v in runs.items()}
            d = thr[mode][device]
            print(f"  (c) {mode}: {d['schedules_per_s']:.3f} schedules/s, "
                  f"{d['steps_per_s']:.1f} steps/s on {device}; "
                  f"{thr[mode]['cpu']['schedules_per_s']:.3f} schedules/s "
                  "on cpu", flush=True)
        out["throughput"] = thr

        fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "data", "sim")
        replay = sim_run("(d) tools.sim replay tests/data/sim",
                         lambda: sim_cli.main(["replay", "--device", device,
                                               fixtures]), device)
        if replay["out"] != 0:
            raise AssertionError(f"tools.sim replay exited {replay['out']}")
        selftest = sim_run("(d) tools.daemon selftest",
                           lambda: daemon_cli.main(["selftest", "--device",
                                                    device]), device)
        if selftest["out"] != 0:
            raise AssertionError(f"selftest exited {selftest['out']}")
        if device == "cuda" and selftest["launches"]["orset_fold"] < 1:
            raise AssertionError("the selftest launched no orset_fold")
        out["replay"] = {"exit": replay["out"], "wall_s": replay["wall_s"],
                         "launches": replay["launches"]}
        out["selftest"] = {"exit": selftest["out"],
                           "wall_s": selftest["wall_s"],
                           "launches": selftest["launches"]}
    finally:
        log.setLevel(level)
    return out


# ---- phase 19: the operator's read side, migration, device decode ----------


def captured(fn) -> tuple:
    """``fn()`` (an entry point's ``main``) with its output captured:
    ``(exit code, stdout, stderr)``."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn()
    return rc, out.getvalue(), err.getvalue()


def obs_cli(argv: list) -> tuple:
    """``python -m crdt_enc_tpu_torch.tools.obs_report ARGV`` in process."""
    from crdt_enc_tpu_torch.tools import obs_report

    return captured(lambda: obs_report.main(list(argv)))


def expect_cli(label: str, argv: list, rc: int = 0, show: bool = True) -> str:
    """Run ``obs_report ARGV``; fail unless it exits ``rc``.  Prints the
    output indented (or its line count) and returns it."""
    got, out, err = obs_cli(argv)
    if got != rc:
        raise AssertionError(f"obs_report {' '.join(argv[:1])} ({label}) "
                             f"exited {got}, expected {rc}: {err.strip()}")
    if show:
        for line in out.rstrip("\n").splitlines():
            print(f"    {line}", flush=True)
    else:
        print(f"    ({len(out.splitlines())} lines)", flush=True)
    return out


def obs_stream_run(label: str, accel, key, blobs, actors, host: bytes,
                   path: str) -> dict:
    """(a): one recorded ``fold_encrypted_stream`` with events on, written
    through ``MetricsSink`` to ``path``; the state byte-equal to the host
    loop's.  Returns the session mode, launches, wall and spans."""
    from crdt_enc_tpu_torch import ORSet, canonical_bytes
    from crdt_enc_tpu_torch.obs import sink as obs_sink
    from crdt_enc_tpu_torch.utils import trace

    sessions = []
    real_open = accel.open_fold_session

    def capture(*args, **kw):
        s = real_open(*args, **kw)
        sessions.append(s)
        return s

    accel.open_fold_session = capture
    trace.reset()
    trace.enable_events()
    reset_launches()
    state = ORSet()
    try:
        t0 = time.perf_counter()
        if not accel.fold_encrypted_stream(state, key, blobs,
                                           actors_hint=actors):
            raise AssertionError(f"{label}: fold_encrypted_stream declined")
        wall = time.perf_counter() - t0
        launches = read_launches()
        rec = obs_sink.MetricsSink(path).write(
            label, meta={"wall_s": wall, "mode": sessions[0].mode})
    finally:
        trace.enable_events(False)
        del accel.open_fold_session
    same = canonical_bytes(state) == host
    print(f"  {label}: session mode {sessions[0].mode}, "
          f"{rec['gauges'].get('stream_producers')} producers, wall "
          f"{wall:.3f} s, launches { {k: v for k, v in launches.items() if v} }"
          f", {len(rec.get('events', ()))} events, bytes equal to the host "
          f"loop: {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: state differs from the host loop")
    return {"mode": sessions[0].mode, "wall_s": wall, "launches": launches,
            "events": len(rec.get("events", ())),
            "producers": rec["gauges"].get("stream_producers"),
            "spans_s": {k: v["seconds"] for k, v in rec["spans"].items()}}


def phase_obs_stream(device: str, root: str) -> dict:
    """(a) and (b): phase 10's config-3 op files, encrypted, through
    ``TorchAccelerator.fold_encrypted_stream`` twice with events on, each
    run a sink record; the overlap proof, report, prom, gap and diff."""
    import secrets

    from crdt_enc_tpu_torch import (
        HostAccelerator, ORSet, TorchAccelerator, canonical_bytes,
        orset_adapter,
    )
    from crdt_enc_tpu_torch.backends.xchacha import encrypt_blob
    from crdt_enc_tpu_torch.obs import attribution, sink as obs_sink
    from crdt_enc_tpu_torch.utils import codec

    t0 = time.perf_counter()
    actors = actor_bytes_table(N_REPLICAS)
    files = compaction_files(gen_columns(N_ROWS, N_REPLICAS, N_MEMBERS, SEED),
                             actors)
    n_ops = sum(len(f[3]) for f in files)
    key = secrets.token_bytes(32)
    blobs = [encrypt_blob(key, codec.pack(ops)) for *_, ops in files]
    adapter = orset_adapter()
    ops = [adapter.op_from_obj(o) for *_, wire in files for o in wire]
    del files
    t1 = time.perf_counter()
    host = canonical_bytes(HostAccelerator().fold_ops(ORSet(), ops))
    host_s = time.perf_counter() - t1
    del ops
    print(f"  (a) {len(blobs)} encrypted op files, {n_ops} ops (phase 10's "
          f"files) made in {t1 - t0:.1f} s; host loop {host_s:.2f} s",
          flush=True)
    accel = TorchAccelerator(device)
    paths = [os.path.join(root, f"obs_stream_{i}.jsonl") for i in (1, 2)]
    runs = [obs_stream_run(f"(a) stream run {i + 1}", accel, key, blobs,
                           sorted(actors), host, p)
            for i, p in enumerate(paths)]
    a = runs[0]
    trace_path = os.path.join(root, "obs_stream_trace.json")
    print("  (a) obs_report export-trace --check-overlap "
          "stream.ingest:stream.reduce", flush=True)
    overlap_out = expect_cli("overlap", [
        "export-trace", paths[0], "-o", trace_path,
        "--check-overlap", "stream.ingest:stream.reduce"])
    print("  (a) obs_report report", flush=True)
    expect_cli("report", ["report", paths[0]])
    prom = expect_cli("prom", ["prom", paths[0]], show=False)
    print("  (a) obs_report gap", flush=True)
    expect_cli("gap", ["gap", paths[0]])
    rec = obs_sink.read_records(paths[0])[-1]
    report = attribution.from_record(rec)
    print(f"  (b) obs_report diff run 1 -> run 2", flush=True)
    expect_cli("diff", ["diff", paths[0], paths[1]])
    return {"ops": n_ops, "files": len(blobs), "host_loop_s": host_s,
            "runs": runs, "overlap": overlap_out.strip().splitlines()[-1],
            "prom_lines": len(prom.splitlines()),
            "stages_s": {k: v["seconds"] for k, v in report["stages"].items()},
            "critical_path": report["critical_path"],
            "wall_s_events": report["wall_s"],
            "overlap_x": report.get("overlap_x"),
            "overlapped_chunks": report.get("overlapped_chunks"),
            "launches": {k: sum(r["launches"][k] for r in runs)
                         for k in runs[0]["launches"]}}


def phase_obs_fleet(device: str, root: str) -> dict:
    """(c): four port ``Core``s on ``device`` as four devices, each
    compacting its own replica of one encrypted FsStorage remote (one
    tenant of phase 16's shape) at a later point of its history and
    writing its own sink file; ``obs_report fleet`` over the four."""
    import asyncio

    from crdt_enc_tpu_torch import Core, FsStorage, HostAccelerator, \
        TorchAccelerator
    from crdt_enc_tpu_torch.obs import sink as obs_sink

    base = os.path.join(root, "obs_fleet")
    remote = os.path.join(base, "remote")
    actors = actor_bytes_table(FLEET_R)
    files = serve_orset_files(FLEET_N, FLEET_R, FLEET_E, OBS_FLEET_SEED,
                              actors)
    # staged in version order, so every stage leaves each actor's log dense
    files.sort(key=lambda f: (f[1], f[0]))
    parts = np.array_split(np.arange(len(files)), OBS_FLEET_DEVICES)
    paths = [os.path.join(base, f"device{i}.jsonl")
             for i in range(OBS_FLEET_DEVICES)]
    reset_launches()

    async def go():
        writer = await Core.open(compaction_options(base, "writer", remote,
                                                    HostAccelerator()))
        store = FsStorage(os.path.join(base, "writer"), remote)
        cores, expect = [], []
        seen: dict = {}
        for i, part in enumerate(parts):
            batch = [files[j] for j in part.tolist()]
            blobs = await asyncio.gather(*(writer._seal(ops)
                                           for *_, ops in batch))
            for (ab, v, _), blob in zip(batch, blobs):
                await store.store_ops(ab, v, blob)
                seen[ab] = max(seen.get(ab, 0), v)
            expect.append(dict(seen))
            obs_sink.configure(paths[i])
            try:
                c = await Core.open(compaction_options(
                    base, f"device{i}", remote, TorchAccelerator(device)))
                await c.compact()
            finally:
                obs_sink.configure(None)
            cores.append(c)
        return cores, expect

    t0 = time.perf_counter()
    cores, expect = run_async(go())
    wall = time.perf_counter() - t0
    launches = read_launches()
    clocks = [c.info().next_op_versions for c in cores]
    for c, want in zip(clocks, expect):
        if dict(c.counters) != want:
            raise AssertionError("a device's cursor is not the history it "
                                 "was given")
    watermark = {}
    for a in set().union(*(c.counters for c in clocks)):
        lo = min(c.get(a) for c in clocks)
        if lo:
            watermark[a.hex()] = lo
    print(f"  (c) {len(files)} op files ({FLEET_N} ops) over "
          f"{OBS_FLEET_DEVICES} devices, compacted in {wall:.2f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print("  (c) obs_report fleet", flush=True)
    expect_cli("fleet", ["fleet", *paths])
    rc, out, err = obs_cli(["fleet", "--json", *paths])
    rep = json.loads(out)
    [rem] = rep["remotes"]
    same = rem["stable_watermark"] == dict(sorted(watermark.items()))
    print(f"  (c) fleet watermark {sum(rem['stable_watermark'].values())} "
          f"versions over {len(rem['stable_watermark'])} actors; equal to "
          f"the pointwise min of the four cursors: {same}", flush=True)
    if rc != 0 or not same or rep["n_devices"] != OBS_FLEET_DEVICES:
        raise AssertionError(f"fleet report: exit {rc}, watermark "
                             f"{rem['stable_watermark']} != {watermark}")
    return {"devices": OBS_FLEET_DEVICES, "ops": FLEET_N,
            "files": len(files), "wall_s": wall, "launches": launches,
            "watermark": rem["stable_watermark"], "lag": rem["lag"],
            "converged": rem["converged"]}


def phase_obs_service(device: str, root: str) -> dict:
    """(d): a ``FoldService`` over phase 16's mix at 1/OBS_SCALE of its
    size, three cycles (all ops, 10% tails, quiet) with the sink on;
    ``obs_report slo`` over the file and ``gap`` on cycle 1's record."""
    from crdt_enc_tpu_torch import MemoryStorage, TorchAccelerator
    from crdt_enc_tpu_torch.obs import sink as obs_sink
    from crdt_enc_tpu_torch.serve import FoldService
    from crdt_enc_tpu_torch.utils import trace

    t0 = time.perf_counter()
    spec = serve_fleet_spec(scale=OBS_SCALE, cap=False)
    labels = [s[0] for s in spec]
    remotes, tails = run_async(seal_fleet(spec))
    cores = serve_open(remotes, spec, TorchAccelerator(device), set())
    print(f"  (d) {len(spec)} tenants "
          f"({ {k: labels.count(k) for k in dict.fromkeys(labels)} }) sealed "
          f"and opened in {time.perf_counter() - t0:.1f} s", flush=True)
    del spec
    path = os.path.join(root, "obs_service.jsonl")
    service = FoldService(cores)
    cycles = []
    reset_launches()
    obs_sink.configure(path)
    try:
        for cycle in (1, 2, 3):
            if cycle == 2:
                async def add_tails():
                    for remote, t in zip(remotes, tails):
                        store = MemoryStorage(remote)
                        for ab, v, blob in t:
                            await store.store_ops(ab, v, blob)
                run_async(add_tails())
            trace.reset()
            t1 = time.perf_counter()
            results = run_async(service.run_cycle())
            wall = time.perf_counter() - t1
            errors = [r.error for r in results if r.error]
            if errors:
                raise AssertionError(f"(d) cycle {cycle}: tenant errors "
                                     f"{errors[:3]}")
            sealed = sum(1 for r in results if r.sealed)
            cycles.append({"wall_s": wall, "sealed": sealed})
            print(f"  (d) cycle {cycle}: {wall:.3f} s, {sealed} tenants "
                  "sealed", flush=True)
    finally:
        obs_sink.configure(None)
        service.close()
    launches = read_launches()
    print(f"  (d) launches over the three cycles "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    print("  (d) obs_report slo", flush=True)
    expect_cli("slo", ["slo", path])
    print("  (d) obs_report gap on cycle 1's record", flush=True)
    gap = expect_cli("gap", ["gap", path, "--label", "serve_cycle",
                             "--index", "0"])
    critical = next(ln for ln in gap.splitlines()
                    if ln.startswith("critical path:"))
    print(f"  (d) cycle 1 {critical}", flush=True)
    return {"tenants": len(labels), "cycles": cycles, "launches": launches,
            "critical_path": critical.split(":", 1)[1].strip(),
            "records": len(open(path).read().splitlines())}


def phase_obs_committed(sim: dict, root: str) -> dict:
    """(e) the committed records and goldens, (f) simcov over phase 18's
    co-fire matrix."""
    from crdt_enc_tpu_torch.sim import CoFireMatrix

    here = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(here, "tests", "data")
    bench = os.path.join(here, "BENCH_LOCAL.jsonl")
    print("  (e) obs_report gap BENCH_LOCAL.jsonl (streaming record)",
          flush=True)
    gap = expect_cli("gap", ["gap", bench, "--metric",
                             "orset_e2e_streaming_ops_per_sec"])
    with open(os.path.join(data, "obs_gap_golden.txt")) as f:
        gap_golden = gap == f.read()
    trend = expect_cli("trend", ["trend", bench], show=False)
    fleet = expect_cli("fleet golden", [
        "fleet", os.path.join(data, "fleet_device_a.jsonl"),
        os.path.join(data, "fleet_device_b.jsonl")], show=False)
    with open(os.path.join(data, "obs_fleet_golden.txt")) as f:
        fleet_golden = fleet == f.read()
    print(f"  (e) gap equals tests/data/obs_gap_golden.txt: {gap_golden}; "
          f"trend {len(trend.splitlines())} lines; fleet equals "
          f"tests/data/obs_fleet_golden.txt: {fleet_golden}", flush=True)
    if not (gap_golden and fleet_golden):
        raise AssertionError("a committed golden does not match")
    path = os.path.join(root, "obs_simcov.json")
    CoFireMatrix.from_obj(sim["coverage"]).dump(path)
    print(f"  (f) obs_report simcov over phase 18's matrix "
          f"({sim['coverage']['runs']} runs)", flush=True)
    expect_cli("simcov", ["simcov", path])
    return {"gap_golden": gap_golden, "fleet_golden": fleet_golden,
            "trend_lines": len(trend.splitlines()),
            "simcov_runs": sim["coverage"]["runs"]}


def migration_history() -> list:
    """(g)'s source history, the reference example's ``MVReg<_, Uuid>``
    (examples/test/src/main.rs:12-26 of chpio/crdt-enc): MIG_ACTORS
    writers, MIG_FILES op files each of MIG_OPS register writes.  In each
    round every writer writes one file; the writers take turns in
    MIG_GROUPS groups, a group's writers concurrently, each having read
    the register as the previous group left it — so a write carries that
    read's clock plus its own counter (``write_ctx``), and MIG_ACTORS /
    MIG_GROUPS concurrent values survive a round.  Values are uuids.
    ``(actor, version, ops in wire form)`` per file."""
    from crdt_enc_tpu_torch.models.vclock import VClock

    rng = np.random.default_rng(MIG_SEED)
    actors = [uuid.UUID(int=(1 << 110) + a).bytes for a in range(MIG_ACTORS)]
    width = MIG_ACTORS // MIG_GROUPS
    seen: dict = {}
    out = []
    for v in range(1, MIG_FILES + 1):
        for g in range(0, MIG_ACTORS, width):
            read = dict(seen)
            for ab in actors[g : g + width]:
                clock = dict(read)
                ops = []
                for _ in range(MIG_OPS):
                    clock[ab] = clock.get(ab, 0) + 1
                    value = uuid.UUID(int=int(rng.integers(0, 2**63))).bytes
                    ops.append([VClock(dict(clock)).to_obj(), value])
                seen[ab] = clock[ab]
                out.append((ab, v, ops))
    return out


def phase_obs_migration(device: str, root: str) -> dict:
    """(g): a port replica's MVReg history exported to the reference
    format (log mode), ``import_reference --compact`` into an encrypted
    FsStorage remote on the card (the entry point, in process) and into a
    second with ``HostAccelerator``; the canonical states equal, then
    exported back (state mode) and imported again with the same bytes."""
    import asyncio
    import secrets

    from crdt_enc_tpu_torch import (
        Core, FsStorage, HostAccelerator, MemoryRemote, MemoryStorage,
        OpenOptions, PlainKeyCryptor, TorchAccelerator, XChaChaCryptor,
        canonical_bytes,
    )
    from crdt_enc_tpu_torch.core.adapters import mvreg_adapter
    from crdt_enc_tpu_torch.tools import export_reference, import_reference
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    base = os.path.join(root, "migration")
    key = secrets.token_bytes(32)
    data_version = uuid.UUID("11111111-2222-3333-4444-555555555555").bytes

    def opts(storage, accel):
        return OpenOptions(
            storage=storage, cryptor=XChaChaCryptor(),
            key_cryptor=PlainKeyCryptor(), adapter=mvreg_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=True,
            accelerator=accel)

    def fs(name, remote):
        return FsStorage(os.path.join(base, name), os.path.join(base, remote))

    t0 = time.perf_counter()
    history = migration_history()
    n_ops = sum(len(ops) for *_, ops in history)

    async def source():
        remote = MemoryRemote()
        src = await Core.open(opts(MemoryStorage(remote), HostAccelerator()))
        for lo in range(0, len(history), COMPACT_WRITE_BATCH):
            batch = history[lo : lo + COMPACT_WRITE_BATCH]
            blobs = await asyncio.gather(*(src._seal(ops)
                                           for *_, ops in batch))
            for (ab, v, _), blob in zip(batch, blobs):
                await src.storage.store_ops(ab, v, blob)
        return src

    src = run_async(source())
    made = time.perf_counter() - t0
    t0 = time.perf_counter()
    stats = run_async(export_reference.export_reference_log(
        src, os.path.join(base, "ref"), key, data_version))
    export_s = time.perf_counter() - t0
    print(f"  (g) {n_ops} MVReg ops in {len(history)} files over "
          f"{MIG_ACTORS} actors sealed in {made:.1f} s; export_reference "
          f"(log mode) wrote {stats.op_files} reference files in "
          f"{export_s:.2f} s", flush=True)
    if (stats.actors, stats.op_files, stats.ops) != (
            MIG_ACTORS, len(history), n_ops):
        raise AssertionError(f"export stats {stats}")
    del history
    reset_launches()
    t0 = time.perf_counter()
    rc, text, _ = captured(lambda: import_reference.main([
        os.path.join(base, "ref"), os.path.join(base, "card_local"),
        os.path.join(base, "card_remote"), "--key-hex", key.hex(),
        "--compact", "--device", device]))
    card_s = time.perf_counter() - t0
    launches = read_launches()
    if rc != 0:
        raise AssertionError(f"import_reference exited {rc}")

    async def host_import():
        dest = await Core.open(opts(fs("host_local", "host_remote"),
                                    HostAccelerator()))
        await import_reference.import_reference_remote(
            os.path.join(base, "ref"), dest, key, compact=True)
        return dest

    t0 = time.perf_counter()
    host = run_async(host_import())
    host_s = time.perf_counter() - t0

    async def read(name, remote, accel):
        c = await Core.open(opts(fs(name, remote), accel))
        await c.read_remote()
        return c

    card = run_async(read("card_reader", "card_remote",
                          TorchAccelerator(device)))
    card_bytes = card.with_state(canonical_bytes)
    host_bytes = host.with_state(canonical_bytes)
    print(f"  (g) import_reference --compact --device {device}: "
          f"{text.strip()}; wall {card_s:.2f} s; HostAccelerator import "
          f"{host_s:.2f} s; canonical states equal: "
          f"{card_bytes == host_bytes} ({len(card_bytes)} bytes)", flush=True)
    if card_bytes != host_bytes:
        raise AssertionError("the card's import differs from the host's")
    t0 = time.perf_counter()
    back = run_async(export_reference.export_reference_state(
        card, os.path.join(base, "back"), key, data_version))

    async def reimport():
        dest = await Core.open(opts(fs("again_local", "again_remote"),
                                    TorchAccelerator(device)))
        await import_reference.import_reference_remote(
            os.path.join(base, "back"), dest, key, compact=True)
        return dest.with_state(canonical_bytes)

    again = run_async(reimport())
    round_s = time.perf_counter() - t0
    print(f"  (g) exported back (state mode, {back.ops} ops) and imported "
          f"again in {round_s:.2f} s: same bytes {again == card_bytes}",
          flush=True)
    if again != card_bytes:
        raise AssertionError("the round trip changed the state")
    return {"actors": MIG_ACTORS, "files": stats.op_files, "ops": n_ops,
            "export_s": export_s, "card_import_s": card_s,
            "host_import_s": host_s, "round_trip_s": round_s,
            "state_bytes": len(card_bytes), "launches": launches}


def phase_obs_device_decode(device: str) -> dict:
    """(h): bench.py's device_decode_exp shape (bench.py:541) on the card:
    the device arm, the host vectorized arm and the native decoder, equal
    columns, ``h2d_bytes`` equal to the upload, each arm's best of
    DD_ITERS; then a fold session fed the corpus as packed chunks with
    the gate on and off, equal state bytes."""
    import secrets

    from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.backends.xchacha import (
        decrypt_blobs_packed, encrypt_blob,
    )
    from crdt_enc_tpu_torch.ops import device_decode as DD
    from crdt_enc_tpu_torch.ops.native_decode import decode_orset_payload_batch
    from crdt_enc_tpu_torch.utils import codec, trace

    rng = np.random.default_rng(DD_SEED)
    actors = sorted(rng.bytes(16) for _ in range(DD_R))
    payloads = []
    for lo in range(0, DD_N, DD_OPF):
        n = min(DD_OPF, DD_N - lo)
        member = rng.integers(0, 128, n).tolist()
        who = rng.integers(0, DD_R, n).tolist()
        ctr = rng.integers(1, 128, n).tolist()
        payloads.append(codec.pack([[0, m, [actors[a], c]]
                                    for m, a, c in zip(member, who, ctr)]))
    offs = np.zeros(len(payloads) + 1, np.uint64)
    np.cumsum([len(p) for p in payloads], out=offs[1:])
    buf = np.frombuffer(b"".join(payloads), np.uint8)
    packed = (buf, offs)
    trace.reset()
    dev = DD.decode_adds_device(packed, actors, device)
    h2d = trace.snapshot()["counters"].get("h2d_bytes", 0)
    host = DD.decode_adds_host(packed, actors)
    native = decode_orset_payload_batch(list(payloads), actors)
    if dev is None or host is None or native is None:
        raise AssertionError("an arm declined the all-adds corpus")
    for name, arm in (("host", host), ("native", native)):
        if not all(np.array_equal(np.asarray(arm[i]), np.asarray(dev[i]))
                   for i in (0, 2, 3)):
            raise AssertionError(f"device decode columns differ from {name}")
        members = [arm[4][i] for i in np.asarray(arm[1]).tolist()]
        if members != [dev[4][i] for i in dev[1].tolist()]:
            raise AssertionError(f"device decode members differ from {name}")
    upload = buf.nbytes + DD_N * 8
    if device == "cuda" and h2d != upload:
        raise AssertionError(f"h2d_bytes {h2d} != the upload {upload}")

    def best(fn):
        t = float("inf")
        for _ in range(DD_ITERS):
            t0 = time.perf_counter()
            if fn() is None:
                raise AssertionError("an arm declined")
            t = min(t, time.perf_counter() - t0)
        return t

    arms = {"device": best(lambda: DD.decode_adds_device(packed, actors,
                                                         device)),
            "host_vectorized": best(lambda: DD.decode_adds_host(packed,
                                                                actors)),
            "native": best(lambda: decode_orset_payload_batch(list(payloads),
                                                              actors))}
    print(f"  (h) {len(payloads)} payloads, {DD_N} add ops, R={DD_R}: three "
          f"arms equal; h2d_bytes {h2d} (upload {upload}); best of "
          f"{DD_ITERS}: " + ", ".join(f"{k} {v * 1e3:.2f} ms"
                                      for k, v in arms.items()), flush=True)
    print(device_line(), flush=True)
    key = secrets.token_bytes(32)
    blobs = [encrypt_blob(key, p) for p in payloads]
    step = -(-len(blobs) // DD_CHUNKS)
    states, spans = {}, {}
    saved = os.environ.get("CRDT_DEVICE_DECODE")
    reset_launches()
    try:
        for gate in ("0", "1"):
            os.environ["CRDT_DEVICE_DECODE"] = gate
            trace.reset()
            accel = TorchAccelerator(device)
            session = accel.open_fold_session(ORSet(), actors_hint=actors)
            t0 = time.perf_counter()
            for lo in range(0, len(blobs), step):
                part = decrypt_blobs_packed(key, blobs[lo : lo + step])
                session.reduce_chunk(session.decode_chunk_parts([part]))
            states[gate] = canonical_bytes(session.finish())
            spans[gate] = {k: v["count"] for k, v in
                           trace.snapshot()["spans"].items()
                           if k in ("device.decode", "session.decode")}
            spans[gate]["wall_s"] = time.perf_counter() - t0
    finally:
        if saved is None:
            os.environ.pop("CRDT_DEVICE_DECODE", None)
        else:
            os.environ["CRDT_DEVICE_DECODE"] = saved
    launches = read_launches()
    same = states["1"] == states["0"]
    print(f"  (h) fold session, gate off {spans['0']}, gate on {spans['1']}: "
          f"state bytes equal {same}", flush=True)
    if not same or spans["1"].get("device.decode") != DD_CHUNKS:
        raise AssertionError("the gated session differs, or its chunks did "
                             "not decode on the device")
    return {"files": len(payloads), "ops": DD_N, "replicas": DD_R,
            "arms_s": arms, "h2d_bytes": h2d, "upload_bytes": upload,
            "device_vs_native_x": arms["device"] / arms["native"],
            "session": spans, "launches": launches}


def phase_obs(device: str, root: str, sim: dict) -> dict:
    """Phase 19 (module docs): (a)–(h), each step failing the run when it
    fails; the kernel counts zeroed before the phase and read after."""
    import logging

    reset_launches()
    t0 = time.perf_counter()
    out: dict = {}
    out["stream"] = phase_obs_stream(device, root)
    gc.collect()
    out["fleet"] = phase_obs_fleet(device, root)
    out["service"] = phase_obs_service(device, root)
    out["committed"] = phase_obs_committed(sim, root)
    log = logging.getLogger("crdt_enc_tpu_torch")
    level = log.level
    log.setLevel(logging.ERROR)  # the importer's per-remote notices
    try:
        out["migration"] = phase_obs_migration(device, root)
    finally:
        log.setLevel(level)
    out["device_decode"] = phase_obs_device_decode(device)
    parts = ("stream", "fleet", "service", "migration", "device_decode")
    out["launches"] = {k: sum(out[p]["launches"][k] for p in parts)
                       for k in KERNELS}
    out["wall_s"] = time.perf_counter() - t0
    print(f"  phase 19 launches {out['launches']}; wall "
          f"{out['wall_s']:.1f} s", flush=True)
    if device == "cuda" and (out["launches"]["orset_fold"] < 1
                             or out["launches"]["orset_merge_many"] < 1):
        raise AssertionError("phase 19 launched no orset_fold or no "
                             "orset_merge_many")
    return out


# name -> (source, file:line of the TPU kernel's pallas_call, the Pallas
# functions it stands for).  Both OR-Set entries run the bucketed kernels
# of csrc/orset_fold.cu and differ in the range kernel's epilogue; K3
# (_fold_wide) has K2's contract over (E, R) past the ablk layout's int32
# keys, which the same kernels cover with int64 cell indices (phase 9).
# ---- the mesh on the card (phase 21) ---------------------------------------
# (a) at config 3 on meshes of four shards of the one card; (b) an
# encrypted in-memory remote at config-3 width and 1/MESH_DEPTH of phase
# 10's rows (phase 10's fs remote is compacted by then, and a fresh one
# on the machine's 9p root took 48.6 s to write 10,000 files at 1/8
# depth); (c) phase 19 (d)'s 256-tenant mix on a (2, 1) mesh; (d) an
# NCCL group of one process.
MESH_SHAPES = ((4, 1), (2, 2), (1, 4))
MESH_REPS, MESH_DEPTH, MESH_DAEMON_CYCLES = 5, 4, 6


def card_mesh(shape, device: str = "cuda"):
    """A (dp, mp) mesh of dp·mp shards of one device (cuda:0 on the
    card; ``"cpu"`` in a dry run)."""
    import torch

    from crdt_enc_tpu_torch.parallel import make_mesh

    dp, mp = shape
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    return make_mesh(shape, devices=[dev] * (dp * mp))


def expect_launches(label: str, device: str, got: dict, want: dict) -> None:
    """The card's launch counts must be ``want`` (a dry run on the CPU
    launches nothing)."""
    if device == "cuda" and got != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")


def median_ms(fn, reps: int = MESH_REPS) -> float:
    """Median of ``reps`` CUDA-event-timed calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def counted(fn) -> tuple:
    """``fn()`` and the kernel launches it made: (result, launches)."""
    reset_launches()
    out = fn()
    return out, {k: v for k, v in read_launches().items() if v}


def mesh_check(label: str, refs: dict, got, errs: dict, key: str) -> None:
    """``got`` against each reference of ``refs``, exactly."""
    for name, ref in refs.items():
        check_equal(f"{label} vs {name}", ref, got, errs, key)


def phase_mesh_ops(errs: dict, device: str) -> dict:
    """21 (a): each sharded function at its config's width on the card's
    meshes, against the unsharded kernel and the plain version; the
    per-shard launches and the median of MESH_REPS calls beside the
    unsharded kernel's, in the same run."""
    import torch

    from crdt_enc_tpu_torch.ops import lww as L
    from crdt_enc_tpu_torch.ops import orset as P
    from crdt_enc_tpu_torch.ops.counters import gcounter_fold, pncounter_fold
    from crdt_enc_tpu_torch.ops.lww_fold_cuda import lww_fold_cuda
    from crdt_enc_tpu_torch.ops.mvreg import mvreg_dominance_keep
    from crdt_enc_tpu_torch.ops.orset_fold_cuda import orset_fold_cuda
    from crdt_enc_tpu_torch.ops.orset_merge_cuda import orset_merge_many_cuda
    from crdt_enc_tpu_torch.parallel import mesh as pmesh

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    out: dict = {"fold": {}, "merge": {}}
    z = torch.zeros((E, R), dtype=torch.int32, device=dev)
    clock0 = torch.zeros(R, dtype=torch.int32, device=dev)
    rows7 = [torch.from_numpy(x).to(dev) for x in gen_columns(N, R, E, SEED)]
    rows8 = [torch.from_numpy(x).to(dev) for x in gen_columns(N, R, E, SEED2)]
    base = orset_fold_cuda(clock0, z, z, *rows7, num_members=E,
                           num_replicas=R)
    for retire in (True, False):
        kw = dict(num_members=E, num_replicas=R, retire_rm=retire)
        refs = {"orset_fold_cuda": orset_fold_cuda(*base, *rows8, **kw),
                "orset_fold_plain": P.orset_fold_plain(*base, *rows8, **kw)}
        flat_ms = median_ms(lambda: orset_fold_cuda(*base, *rows8, **kw))
        for shape in MESH_SHAPES:
            mesh = card_mesh(shape, device)
            got, launches = counted(lambda: pmesh.orset_fold_sharded(
                mesh, *base, *rows8, retire_rm=retire))
            mesh_check(f"(a) orset_fold_sharded {shape} retire_rm={retire}",
                       refs, got, errs, "orset_scatter")
            expect_launches(f"(a) orset_fold_sharded {shape}", device,
                            launches, {"orset_scatter": shape[0] * shape[1]})
            ms = median_ms(lambda: pmesh.orset_fold_sharded(
                mesh, *base, *rows8, retire_rm=retire))
            out["fold"][f"{shape[0]}x{shape[1]} retire_rm={retire}"] = {
                "launches": launches, "ms": ms, "unsharded_ms": flat_ms}
            print(f"    per-shard launches {launches}; median {ms:.3f} ms "
                  f"against orset_fold_cuda {flat_ms:.3f} ms", flush=True)
            del got
        del refs
    # phase 3's S folded slices, merged pairwise on the mesh
    bounds = np.linspace(0, N, MERGE_S + 1).astype(int)
    states = [orset_fold_cuda(clock0, z, z, *(x[lo:hi] for x in rows7),
                              num_members=E, num_replicas=R)
              for lo, hi in zip(bounds[:-1], bounds[1:])]
    stacks = [torch.stack([s[i] for s in states]) for i in range(3)]
    refs = {"orset_merge_many_cuda": orset_merge_many_cuda(*stacks),
            "orset_merge_many_tree": P.orset_merge_many_tree(*stacks)}
    flat_ms = median_ms(lambda: orset_merge_many_cuda(*stacks))
    for shape in MESH_SHAPES:
        mesh = card_mesh(shape, device)

        def merge():
            acc = states[0]
            for s in states[1:]:
                acc = pmesh.orset_merge_sharded(mesh, *acc, *s)
            return acc

        got, launches = counted(merge)
        mesh_check(f"(a) orset_merge_sharded {shape}, S={MERGE_S}", refs,
                   got, errs, "orset_merge_many")
        ms = median_ms(merge)
        out["merge"][f"{shape[0]}x{shape[1]}"] = {
            "launches": launches, "ms": ms, "unsharded_ms": flat_ms}
        print(f"    launches {launches} (elementwise, plain PyTorch); median "
              f"{ms:.3f} ms against orset_merge_many_cuda {flat_ms:.3f} ms",
              flush=True)
    del states, stacks, refs, rows7, rows8, base, z
    torch.cuda.empty_cache()

    # configs 1 and 2: the counters (plain PyTorch in either package)
    counter_errs: dict = {}
    rng = np.random.default_rng(1)
    actor = rng.integers(0, GC_R, GC_N, dtype=np.int32)
    gc = [torch.from_numpy(x).to(dev)
          for x in (actor, running_count(actor, GC_R))]
    rng = np.random.default_rng(2)
    actor = rng.integers(0, PN_R, PN_N, dtype=np.int32)
    sign = (rng.random(PN_N) < 0.3).astype(np.int8)
    pn = [torch.from_numpy(x).to(dev)
          for x in (sign, actor, running_count(actor * 2 + sign, PN_R * 2))]
    for shape in MESH_SHAPES:
        mesh = card_mesh(shape, device)
        c0 = torch.zeros(GC_R, dtype=torch.int32, device=dev)
        got = pmesh.gcounter_fold_sharded(mesh, c0, *gc)
        ref = gcounter_fold(c0, *gc, num_replicas=GC_R)
        mesh_check(f"(a) gcounter_fold_sharded {shape} (config 1)",
                   {"gcounter_fold": ref}, got, counter_errs, "counters")
        p0 = torch.zeros(PN_R, dtype=torch.int32, device=dev)
        got = pmesh.pncounter_fold_sharded(mesh, p0, p0, *pn)
        ref = pncounter_fold(p0, p0, *pn, num_replicas=PN_R)
        mesh_check(f"(a) pncounter_fold_sharded {shape} (config 2)",
                   {"pncounter_fold": ref}, got, counter_errs, "counters")

    # config 4 on (4, 1): K5 once per dp shard
    key, ts, actor, value = gen_lww(LWW_N, LWW_K, LWW_R)
    hi, lo = L.ts_split(ts)
    lww = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
           for x in (key, hi, lo, actor, value)]
    refs = {"lww_fold_cuda": lww_fold_cuda(*lww, num_keys=LWW_K),
            "lww_fold_plain": L.lww_fold_plain(*lww, num_keys=LWW_K)}
    mesh = card_mesh((4, 1), device)
    got, launches = counted(lambda: pmesh.lww_fold_sharded(
        mesh, *lww, num_keys=LWW_K))
    mesh_check("(a) lww_fold_sharded (4, 1) (config 4)", refs, got, errs,
               "lww_fold")
    expect_launches("(a) lww_fold_sharded", device, launches, {"lww_fold": 4})
    ms = median_ms(lambda: pmesh.lww_fold_sharded(mesh, *lww,
                                                  num_keys=LWW_K))
    flat_ms = median_ms(lambda: lww_fold_cuda(*lww, num_keys=LWW_K))
    out["lww"] = {"launches": launches, "ms": ms, "unsharded_ms": flat_ms}
    print(f"    per-shard launches {launches}; median {ms:.3f} ms against "
          f"lww_fold_cuda {flat_ms:.3f} ms", flush=True)
    del lww, refs, got

    # phase 15 (c)'s V = 2,048 MVReg candidates on (4, 1)
    snaps, _ = mvreg_snapshots()
    pairs = [p for s in snaps for p in s.vals]
    index: dict = {}
    clocks = np.zeros((len(pairs), MV_R), np.int64)
    for i, (c, _) in enumerate(pairs):
        for a, n in c.counters.items():
            clocks[i, index.setdefault(a, len(index))] = n
    clocks = torch.from_numpy(clocks[:, :len(index)].copy()).to(dev)
    valid = torch.ones(len(pairs), dtype=torch.bool, device=dev)
    ref = mvreg_dominance_keep(clocks, valid)
    got = pmesh.mvreg_keep_sharded(mesh, clocks, valid)
    same = torch.equal(ref, got)
    print(f"  (a) mvreg_keep_sharded (4, 1), V={len(pairs)}: equal={same}, "
          f"{int(got.sum())} kept", flush=True)
    if not same:
        raise AssertionError("(a) mvreg_keep_sharded disagrees")
    out["mvreg"] = {"V": len(pairs), "kept": int(got.sum()),
                    "ms": median_ms(lambda: pmesh.mvreg_keep_sharded(
                        mesh, clocks, valid), reps=3),
                    "unsharded_ms": median_ms(lambda: mvreg_dominance_keep(
                        clocks, valid), reps=3)}
    print(f"    median {out['mvreg']['ms']:.3f} ms against "
          f"mvreg_dominance_keep {out['mvreg']['unsharded_ms']:.3f} ms",
          flush=True)
    del clocks
    torch.cuda.empty_cache()
    return out


def phase_mesh_compaction(device: str) -> dict:
    """21 (b): ``Core.compact()`` of an encrypted in-memory remote at
    config-3 width (phase 10's op-file layout at 1/MESH_DEPTH of its
    rows) with a (2, 2) mesh accelerator, which streams through the
    sharded DEVICE_STREAM (the session leaves BUFFER at its first chunk),
    against the host loop on a byte-identical copy."""
    from crdt_enc_tpu_torch import HostAccelerator, TorchAccelerator
    from crdt_enc_tpu_torch import canonical_bytes, orset_adapter
    from crdt_enc_tpu_torch.parallel import session as psession

    E, R = N_MEMBERS, N_REPLICAS
    files = compaction_files(gen_columns(N_ROWS // MESH_DEPTH, R, E, SEED),
                             actor_bytes_table(R))
    t0 = time.perf_counter()
    remote = run_async(seal_remote([f[1:] for f in files], orset_adapter()))
    host_remote = copy_memory_remote(remote)
    n_ops = sum(len(f[3]) for f in files)
    print(f"  (b) remote sealed in {time.perf_counter() - t0:.1f} s: "
          f"{len(files)} op files, {n_ops} ops", flush=True)
    accel = TorchAccelerator(mesh=card_mesh((2, 2), device))
    probe = SessionProbe(accel)
    saved = psession.BUFFER_BYTES
    psession.BUFFER_BYTES = 0
    try:
        card, wall, snap, launches = timed_catalogue_compaction(
            remote, orset_adapter(), accel)
    finally:
        psession.BUFFER_BYTES = saved
    session = probe.sessions[0]
    print_compaction("TorchAccelerator(mesh=(2, 2) on one device)", wall,
                     snap)
    per_chunk = launches["orset_fold"] / max(session.device_chunks, 1)
    print(f"    session {session.mode}, {session.device_chunks} chunks, "
          f"{per_chunk:g} K2 launches a chunk, h2d_bytes "
          f"{snap['counters'].get('h2d_bytes', 0)}; launches {launches}",
          flush=True)
    if session.mode != "device_stream" or (device == "cuda"
                                           and per_chunk != 4):
        raise AssertionError("(b) the mesh compaction did not stream through "
                             "the sharded fold, one K2 launch a shard")
    host, host_wall, _, _ = timed_catalogue_compaction(
        host_remote, orset_adapter(), HostAccelerator())
    cb, hb = card.with_state(canonical_bytes), host.with_state(canonical_bytes)
    same = cb == hb and card.info().next_op_versions == \
        host.info().next_op_versions
    print(f"  (b) bytes and cursors equal to the host loop's: {same} "
          f"(host loop {host_wall:.3f} s)", flush=True)
    if not same:
        raise AssertionError("(b) the mesh compaction disagrees with the "
                             "host loop")
    return {"wall_s": wall, "host_wall_s": host_wall, "launches": launches,
            "chunks": session.device_chunks, "rows": session.rows_fed,
            "h2d_bytes": snap["counters"].get("h2d_bytes", 0),
            "op_files": len(files), "ops": n_ops}


def tenant_bytes(cores) -> list:
    from crdt_enc_tpu_torch import canonical_bytes

    return [(c.with_state(canonical_bytes), c.info().next_op_versions)
            for c in cores]


def phase_mesh_serving(device: str) -> dict:
    """21 (c): phase 19 (d)'s 256-tenant mix served by a (2, 1) mesh
    service and by the unsharded service for two cycles (the second after
    10% tails: device-cut deltas), tenant for tenant equal; then a
    ``FleetDaemon`` on the mesh against the unsharded daemon, cycle for
    cycle; then ``tools.daemon selftest --mesh dp=2 --device cuda``."""
    import contextlib
    import io

    from crdt_enc_tpu_torch import MemoryStorage, TorchAccelerator
    from crdt_enc_tpu_torch.serve import DaemonConfig, FleetDaemon, FoldService
    from crdt_enc_tpu_torch.tools import daemon as daemon_cli
    from crdt_enc_tpu_torch.utils import trace

    t0 = time.perf_counter()
    spec = serve_fleet_spec(scale=OBS_SCALE, cap=False)
    remotes, tails = run_async(seal_fleet(spec))
    copies = {k: [copy_memory_remote(r) for r in remotes]
              for k in ("flat", "mesh", "dflat", "dmesh")}
    cores = {k: serve_open(v, spec, TorchAccelerator(device), set())
             for k, v in copies.items()}
    print(f"  (c) {len(spec)} tenants sealed and opened four times in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    mesh = card_mesh((2, 1), device)
    services = {"flat": FoldService(cores["flat"]),
                "mesh": FoldService(cores["mesh"], mesh=mesh)}
    cycles = []
    for cycle in (1, 2):
        if cycle == 2:
            async def add_tails():
                for k in copies:
                    for remote, tail in zip(copies[k], tails):
                        store = MemoryStorage(remote)
                        for ab, v, blob in tail:
                            await store.store_ops(ab, v, blob)
            run_async(add_tails())
        row = {}
        for k, svc in services.items():
            trace.reset()
            reset_launches()
            t1 = time.perf_counter()
            results = run_async(svc.run_cycle())
            snap = trace.snapshot()
            row[k] = {"wall_s": time.perf_counter() - t1,
                      "launches": {n: v for n, v in read_launches().items()
                                   if v},
                      "paths": [r.path for r in results],
                      "serve_sharded_folds": snap["counters"].get(
                          "serve_sharded_folds", 0),
                      "delta_device_cuts": snap["counters"].get(
                          "delta_device_cuts", 0),
                      "serve.shard_ms": snap["spans"].get(
                          "serve.shard", {}).get("seconds", 0) * 1e3}
        same = tenant_bytes(cores["mesh"]) == tenant_bytes(cores["flat"]) \
            and row["mesh"]["paths"] == row["flat"]["paths"]
        print(f"  (c) cycle {cycle}: mesh {row['mesh']['wall_s']:.3f} s "
              f"(serve.shard {row['mesh']['serve.shard_ms']:.1f} ms, "
              f"serve_sharded_folds {row['mesh']['serve_sharded_folds']}, "
              f"launches {row['mesh']['launches']}, device cuts "
              f"{row['mesh']['delta_device_cuts']}), unsharded "
              f"{row['flat']['wall_s']:.3f} s (launches "
              f"{row['flat']['launches']}); every tenant equal: {same}",
              flush=True)
        if not same or not row["mesh"]["serve_sharded_folds"]:
            raise AssertionError(f"(c) cycle {cycle}: the mesh service "
                                 "disagrees with the unsharded one")
        cycles.append(row)
    for svc in services.values():
        svc.close()
    cfg = DaemonConfig(tenant_cost_bytes=1 << 16)
    daemons = {"dflat": FleetDaemon(cores["dflat"], cfg),
               "dmesh": FleetDaemon(cores["dmesh"], cfg, mesh=mesh)}
    daemon_cycles, daemon_launches = 0, {}
    for _ in range(MESH_DAEMON_CYCLES):
        reports = {}
        for k, d in daemons.items():
            reports[k], launched = counted(lambda d=d: run_async(
                d.run_cycle()))
            if k == "dmesh":
                for n, v in launched.items():
                    daemon_launches[n] = daemon_launches.get(n, 0) + v
        if outcomes(reports["dmesh"]) != outcomes(reports["dflat"]) or \
                reports["dmesh"]["selected"] != reports["dflat"]["selected"]:
            raise AssertionError("(c) the mesh daemon's cycle differs")
        daemon_cycles += 1
        if not reports["dmesh"]["selected"]:
            break
    same = tenant_bytes(cores["dmesh"]) == tenant_bytes(cores["dflat"])
    for d in daemons.values():
        run_async(d.drain())
    print(f"  (c) FleetDaemon(mesh=(2, 1)) and FleetDaemon() over "
          f"{daemon_cycles} cycles: schedules equal, every tenant equal: "
          f"{same}; the mesh daemon's launches {daemon_launches}",
          flush=True)
    if not same:
        raise AssertionError("(c) the mesh daemon's tenants differ")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = daemon_cli.main(["selftest", "--device", device, "--mesh",
                              "dp=2"])
    print(f"  (c) tools.daemon selftest --mesh dp=2 --device {device}: exit "
          f"{rc}: "
          f"{err.getvalue().strip()}", flush=True)
    if device == "cuda" and (rc != 2 or "found 1" not in err.getvalue()):
        raise AssertionError("(c) selftest --mesh dp=2 on one card must "
                             "exit 2 naming the one device")
    return {"tenants": len(spec), "cycles": cycles,
            "daemon": {"cycles": daemon_cycles, "launches": daemon_launches},
            "selftest_rc": rc}


def phase_mesh_distributed(errs: dict) -> dict:
    """21 (d): ``distributed.initialize()`` from WORLD_SIZE=1, RANK=0 and
    a free localhost port (an NCCL group on cuda:0), the process mesh,
    ``global_op_batch`` and the sharded fold, whose dp combine's
    cross-process leg is an NCCL ``all_reduce(MAX)``; the group is
    destroyed at the end."""
    import socket

    import torch
    import torch.distributed as dist

    from crdt_enc_tpu_torch.ops.orset_fold_cuda import orset_fold_cuda
    from crdt_enc_tpu_torch.parallel import distributed
    from crdt_enc_tpu_torch.parallel import mesh as pmesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
           "WORLD_SIZE": "1", "RANK": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reduces = []
    real = dist.all_reduce

    def all_reduce(tensor, *a, **kw):
        reduces.append(tensor.device.type)
        return real(tensor, *a, **kw)

    try:
        import datetime

        ok = distributed.initialize(timeout=datetime.timedelta(seconds=120))
        backend = dist.get_backend()
        mesh = distributed.make_multihost_mesh()
        E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
        cols = gen_columns(N, R, E, SEED)
        dist.all_reduce = all_reduce
        batch = distributed.global_op_batch(mesh, *cols, num_replicas=R)
        planes = distributed.replicate(
            mesh, np.zeros(R, np.int32), np.zeros((E, R), np.int32),
            np.zeros((E, R), np.int32))
        got, launches = counted(lambda: pmesh.orset_fold_sharded(
            mesh, *planes, *batch))
        torch.cuda.synchronize()
        n_reduces = len(reduces)
        ref = orset_fold_cuda(*planes, *(torch.from_numpy(x).cuda()
                                         for x in cols),
                              num_members=E, num_replicas=R)
        check_equal("(d) global_op_batch -> orset_fold_sharded on the NCCL "
                    "mesh vs orset_fold_cuda", ref, got, errs, "orset_scatter")
        ms = median_ms(lambda: pmesh.orset_fold_sharded(mesh, *planes,
                                                         *batch))
    finally:
        dist.all_reduce = real
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"  (d) initialize() -> {ok}, backend {backend}, mesh {mesh}; "
          f"NCCL all_reduce calls on {sorted(set(reduces))}: {n_reduces} "
          f"in the batch and the checked fold (launches {launches}); the "
          f"fold's median {ms:.3f} ms; group destroyed", flush=True)
    if backend != "nccl" or n_reduces != 4 or set(reduces) != {"cuda"}:
        raise AssertionError("(d) the NCCL all_reduce did not run as the "
                             "batch and the fold's dp combine")
    return {"backend": backend, "all_reduce_calls": n_reduces,
            "launches": launches, "mesh": repr(mesh), "fold_ms": ms}


def phase_mesh(device: str = "cuda") -> dict:
    """Phase 21: the mesh layer on the card (a)-(d), each part's kernel
    launches counted from 0.  ``device="cpu"`` is the dry run: the plain
    versions, no launch counts, no NCCL part."""
    errs: dict = {}
    t0 = time.perf_counter()
    print("  (a) sharded ops on meshes of four shards of one device",
          flush=True)
    ops = phase_mesh_ops(errs, device)
    print(device_line(), flush=True)
    compaction = phase_mesh_compaction(device)
    print(device_line(), flush=True)
    serving = phase_mesh_serving(device)
    print(device_line(), flush=True)
    dist_part = phase_mesh_distributed(errs) if device == "cuda" else {}
    wall = time.perf_counter() - t0
    print(f"  phase 21 wall {wall:.1f} s", flush=True)
    launches = {k: 0 for k in read_launches()}
    for part in (ops["fold"], ops["merge"]):
        for v in part.values():
            for k, n in v["launches"].items():
                launches[k] += n
    for k, n in ops["lww"]["launches"].items():
        launches[k] += n
    for src in (compaction["launches"], serving["daemon"]["launches"],
                *(c["mesh"]["launches"] for c in serving["cycles"]),
                dist_part.get("launches", {})):
        for k, n in src.items():
            launches[k] += n
    return {"ops": ops, "compaction": compaction, "serving": serving,
            "distributed": dist_part, "errs": errs, "launches": launches,
            "wall_s": wall}


# ---- the consumer replica (phase 22) -----------------------------------------

# phase 22: the consumer replica at config-3 width.  Phase 10's op files
# and COMPACT_SNAPSHOTS snapshots in an encrypted in-memory remote whose
# keys the X25519 cryptor seals to a roster of three writer identities and
# the consumer's; a TAIL_OPS-op tail; then fold_payload_stream over the
# same op files in CONSUMER_CHUNKS chunks
CONSUMER_SEED, CONSUMER_CHUNKS = 41, 8
X25519_TESTS = os.path.join("tests", "test_torch_x25519_keys.py")
CONSUMER_HEADER = (
    f"== 22. the consumer replica (config 3: N={N_ROWS}, R={N_REPLICAS}, "
    f"E={N_MEMBERS}, {COMPACT_SNAPSHOTS} snapshots, X25519 key cryptor, "
    f"checkpoint_on_read; a {TAIL_OPS}-op tail) and fold_payload_stream in "
    f"{CONSUMER_CHUNKS} chunks; the RFC 7748/8032/5869/8439 vectors")


def x25519_vectors() -> dict:
    """22 (a): the RFC 7748, 8032, 5869 and 8439 vectors of
    tests/test_torch_x25519_keys.py, run in process through its own test
    functions (that file imports neither JAX nor ``cryptography``)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        X25519_TESTS)
    spec = importlib.util.spec_from_file_location("x25519_vectors", path)
    T = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(T)
    checks = [
        *((T.test_rfc7748_single_step_vectors, v) for v in T.X25519_VECTORS),
        *((T.test_rfc7748_iterated_vectors, (n,))
          for n in sorted(T.X25519_ITERATED)),
        (T.test_rfc7748_diffie_hellman, ()),
        (T.test_x25519_rejects_an_all_zero_shared_secret, ()),
        *((T.test_rfc8032_vectors, v) for v in T.ED25519_VECTORS),
        (T.test_ed25519_verify_rejects_non_canonical_s_and_bad_points, ()),
        *((T.test_rfc5869_vectors, v) for v in T.HKDF_VECTORS),
        (T.test_hkdf_salt_none_is_32_zero_bytes, ()),
        (T.test_rfc8439_aead_vector_through_the_native_export, ()),
    ]
    t0 = time.perf_counter()
    for fn, args in checks:
        fn(*args)
    wall = time.perf_counter() - t0
    out = {"checks": len(checks), "wall_s": wall,
           "cryptography_loaded": "cryptography" in sys.modules,
           "jax_loaded": "jax" in sys.modules}
    print(f"  (a) {len(checks)} RFC vector checks passed in {wall:.2f} s "
          f"(cryptography imported: {out['cryptography_loaded']}, jax "
          f"imported: {out['jax_loaded']})", flush=True)
    if out["cryptography_loaded"] or out["jax_loaded"]:
        raise AssertionError("the vectors ran beside cryptography or JAX")
    return out


def x25519_options(storage, priv: bytes, roster: list, accel, **kw):
    from crdt_enc_tpu_torch import (
        OpenOptions, X25519KeyCryptor, XChaChaCryptor, orset_adapter,
    )

    version = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
    return OpenOptions(
        storage=storage, cryptor=XChaChaCryptor(),
        key_cryptor=X25519KeyCryptor(priv, roster), adapter=orset_adapter(),
        supported_data_versions=(version,), current_data_version=version,
        create=True, accelerator=accel, **kw,
    )


def seeded_identities(rng, n: int) -> list:
    """``n`` identities as (64-byte private bundle, public bundle), the
    private halves drawn from ``rng``."""
    from crdt_enc_tpu_torch import X25519KeyCryptor

    out = []
    for _ in range(n):
        priv = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
        out.append((priv, X25519KeyCryptor(priv).public_identity))
    return out


async def seal_consumer_remote(files: list, ids: list, roster: list):
    """The consumer's in-memory remote: writer ``ids[0]`` creates the key
    (sealed to ``roster``) and seals every op file; snapshot i comes from
    a copy holding the version-1 files of the actors with ``actor % 16 ==
    i``, compacted by writer ``ids[1 + i % 2]`` (phase 10's layout).
    Returns the op-file writer and the remote."""
    import asyncio

    from crdt_enc_tpu_torch import (
        Core, HostAccelerator, MemoryRemote, MemoryStorage,
    )

    base = MemoryRemote()
    writer = await Core.open(x25519_options(MemoryStorage(base), ids[0][0],
                                            roster, HostAccelerator()))
    remote = copy_memory_remote(base)
    side = [copy_memory_remote(base) for _ in range(COMPACT_SNAPSHOTS)]
    main = MemoryStorage(remote)
    side_st = [MemoryStorage(r) for r in side]
    for b in range(0, len(files), COMPACT_WRITE_BATCH):
        batch = files[b : b + COMPACT_WRITE_BATCH]
        blobs = await asyncio.gather(*(writer._seal(ops) for *_, ops in batch))
        stores = []
        for (ai, ab, v, _), blob in zip(batch, blobs):
            stores.append(main.store_ops(ab, v, blob))
            if v == 1 and ai % 16 < COMPACT_SNAPSHOTS:
                stores.append(side_st[ai % 16].store_ops(ab, v, blob))
        await asyncio.gather(*stores)
    for i, r in enumerate(side):
        sealer = await Core.open(x25519_options(
            MemoryStorage(r), ids[1 + i % 2][0], roster, HostAccelerator()))
        await sealer.compact()
        (name,) = r.states
        remote.states[name] = r.states[name]
    return writer, remote


def consumer_read(core_or_opts) -> tuple:
    """``Core.open`` (when given options) and one ``read_remote()``: the
    core, the wall, the trace snapshot and the launches, each counted from
    0 just before."""
    from crdt_enc_tpu_torch import Core
    from crdt_enc_tpu_torch.utils import trace

    async def go():
        core = core_or_opts
        if not hasattr(core, "read_remote"):
            core = await Core.open(core_or_opts)
        await core.read_remote()
        return core

    reset_launches()
    trace.reset()
    t0 = time.perf_counter()
    core = run_async(go())
    wall = time.perf_counter() - t0
    return core, wall, trace.snapshot(), read_launches()


def span_s(snap: dict, name: str) -> float:
    return snap["spans"].get(name, {}).get("seconds", 0.0)


def span_n(snap: dict, name: str) -> int:
    return snap["spans"].get(name, {}).get("count", 0)


def phase_consumer_remote(files: list, cols, E: int, R: int,
                          device: str) -> dict:
    """22 (b): a consumer replica (``checkpoint_on_read=True``) on the card
    and one with the host loop on a byte-identical copy, step by step."""
    from crdt_enc_tpu_torch import HostAccelerator, MemoryStorage
    from crdt_enc_tpu_torch import TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.backends import NotARecipient
    from crdt_enc_tpu_torch.core.core import CoreError

    rng = np.random.default_rng(CONSUMER_SEED)
    ids = seeded_identities(rng, 5)  # three writers, the consumer, outsider
    roster = [pub for _, pub in ids[:4]]
    consumer_priv, outsider_priv = ids[3][0], ids[4][0]
    t0 = time.perf_counter()
    writer, remote = run_async(seal_consumer_remote(files, ids, roster))
    host_remote = copy_memory_remote(remote)
    n_ops = sum(len(f[3]) for f in files)
    seal_s = time.perf_counter() - t0
    print(f"  (b) remote sealed in {seal_s:.1f} s: {len(files)} op files, "
          f"{n_ops} ops, {len(remote.states)} snapshots; keys sealed to "
          f"{len(roster)} X25519 identities", flush=True)

    accel = TorchAccelerator(device=device)
    probe = SessionProbe(accel)
    card_store, host_store = MemoryStorage(remote), MemoryStorage(host_remote)

    def card_opts():
        return x25519_options(card_store, consumer_priv, roster, accel,
                              checkpoint_on_read=True)

    def host_opts():
        return x25519_options(host_store, consumer_priv, roster,
                              HostAccelerator(), checkpoint_on_read=True)

    steps: dict = {}

    def check(step: str, card, host, wall, host_wall, snap, launches,
              saves: int, sessions_before: int) -> bytes:
        cb = card.with_state(canonical_bytes)
        hb = host.with_state(canonical_bytes)
        same = cb == hb and card.info().next_op_versions == \
            host.info().next_op_versions
        session = (probe.sessions[-1]
                   if len(probe.sessions) > sessions_before else None)
        want_fold = 0 if session is None else session_launches(accel, session)
        got_saves = span_n(snap, "checkpoint.save")
        steps[step] = dict(
            wall_s=wall, host_wall_s=host_wall, launches=launches,
            checkpoint_saves=got_saves,
            checkpoint_save_s=span_s(snap, "checkpoint.save"),
            checkpoint_bytes=snap["counters"].get("checkpoint_bytes", 0),
            session_mode=None if session is None else session.mode,
            session_rows=None if session is None else session.rows_fed,
            spans={k: v["seconds"] for k, v in snap["spans"].items()},
            counters=snap["counters"])
        print(f"  (b) {step}: card {wall:.3f} s, host loop {host_wall:.3f} s; "
              f"session {steps[step]['session_mode']}; checkpoint.save "
              f"x{got_saves} ({steps[step]['checkpoint_save_s'] * 1e3:.1f} ms, "
              f"{steps[step]['checkpoint_bytes']} bytes); launches "
              f"{launches}; bytes and cursors equal to the host loop's: "
              f"{same}", flush=True)
        if not same or got_saves != saves or (
                device == "cuda" and launches["orset_fold"] != want_fold):
            raise AssertionError(
                f"(b) {step}: equal {same}, checkpoint saves {got_saves} "
                f"(expected {saves}), K2 {launches['orset_fold']} (expected "
                f"{want_fold})")
        return cb

    n = len(probe.sessions)
    with RssSampler() as rss:
        card, wall, snap, launches = consumer_read(card_opts())
    host, host_wall, _, _ = consumer_read(host_opts())
    first = check("read 1 (open, merge, fold)", card, host, wall, host_wall,
                  snap, launches, 1, n)
    if device == "cuda" and launches["orset_merge_many"] != 1:
        raise AssertionError(f"(b) the snapshot merge launched K4 "
                             f"{launches['orset_merge_many']} times, not once")
    steps["read 1 (open, merge, fold)"].update(rss.fields(""))
    for k, v in sorted(snap["spans"].items()):
        print(f"    span {k}: {v['seconds'] * 1e3:.1f} ms x{v['count']}",
              flush=True)
    print(f"    {rss.line()}", flush=True)

    n = len(probe.sessions)
    _, wall, snap, launches = consumer_read(card)
    _, host_wall, _, _ = consumer_read(host)
    check("read 2 (quiet)", card, host, wall, host_wall, snap, launches, 0, n)
    if any(launches.values()):
        raise AssertionError(f"(b) the quiet poll launched {launches}")

    clock, version = compactor_clocks(cols, files, R)
    tail = tail_files(rng, clock, version, actor_bytes_table(R), E, TAIL_OPS)

    async def write_tail():
        import asyncio

        blobs = await asyncio.gather(*(writer._seal(ops) for *_, ops in tail))
        await asyncio.gather(*(
            st.store_ops(ab, v, blob)
            for (_, ab, v, _), blob in zip(tail, blobs)
            for st in (MemoryStorage(remote), MemoryStorage(host_remote))))

    run_async(write_tail())
    n = len(probe.sessions)
    _, wall, snap, launches = consumer_read(card)
    _, host_wall, _, _ = consumer_read(host)
    after_tail = check(f"read 3 ({TAIL_OPS}-op tail)", card, host, wall,
                       host_wall, snap, launches, 1, n)

    warm, wall, snap, launches = consumer_read(card_opts())
    wb = warm.with_state(canonical_bytes)
    folded = (snap["counters"].get("ops_folded", 0)
              + snap["counters"].get("op_files_bulk_folded", 0))
    steps["warm reopen"] = dict(
        wall_s=wall, launches=launches, folded=folded,
        opened_from_checkpoint=warm.opened_from_checkpoint,
        checkpoint_saves=span_n(snap, "checkpoint.save"),
        checkpoint_load_s=span_s(snap, "checkpoint.load"),
        checkpoint_verify_s=span_s(snap, "checkpoint.verify"))
    print(f"  (b) warm reopen and a read: {wall:.3f} s, opened_from_checkpoint "
          f"{warm.opened_from_checkpoint} (fallback "
          f"{warm.checkpoint_fallback_reason}); checkpoint.load "
          f"{steps['warm reopen']['checkpoint_load_s'] * 1e3:.1f} ms; bytes "
          f"equal to read 3's: {wb == after_tail}; {folded} folded, "
          f"checkpoint.save x{steps['warm reopen']['checkpoint_saves']}, "
          f"launches {launches}", flush=True)
    if (not warm.opened_from_checkpoint or wb != after_tail or folded
            or steps["warm reopen"]["checkpoint_saves"] or any(
                launches.values())):
        raise AssertionError("(b) the consumer did not reopen warm from the "
                             "checkpoint its read resealed")

    async def outsider():
        from crdt_enc_tpu_torch import Core

        try:
            await Core.open(x25519_options(
                MemoryStorage(copy_memory_remote(host_remote)), outsider_priv,
                roster, HostAccelerator()))
        except (NotARecipient, CoreError) as e:
            return type(e).__name__
        return None

    refused = run_async(outsider())
    print(f"  (b) an identity outside the roster: {refused}", flush=True)
    if refused is None:
        raise AssertionError("(b) an identity outside the roster opened the "
                             "remote")
    total = {k: sum(s["launches"][k] for s in steps.values())
             for k in read_launches()}
    return {"steps": steps, "outsider": refused, "seal_s": seal_s,
            "op_files": len(files), "ops": n_ops, "tail_ops": TAIL_OPS,
            "snapshots": COMPACT_SNAPSHOTS, "launches": total,
            "first_bytes": first}


def phase_consumer_stream(files: list, E: int, R: int, device: str,
                          host_bytes: bytes) -> dict:
    """22 (c): ``fold_payload_stream`` over ``decrypt_blobs_chunked`` of
    the op files in CONSUMER_CHUNKS chunks, then ``fold_payloads`` over
    the same blobs opened in one batch; each state byte-equal to the host
    loop's (the consumer's first read in (b), the same op files)."""
    from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.backends import xchacha
    from crdt_enc_tpu_torch.utils import codec, trace

    rng = np.random.default_rng(CONSUMER_SEED + 1)
    key = rng.integers(0, 256, 32, dtype=np.uint8).tobytes()
    t0 = time.perf_counter()
    blobs = [xchacha.encrypt_blob(key, codec.pack(ops)) for *_, ops in files]
    n_rows = sum(len(f[3]) for f in files)
    actors = actor_bytes_table(R)
    print(f"  (c) {len(blobs)} op files encrypted in "
          f"{time.perf_counter() - t0:.1f} s ({n_rows} rows)", flush=True)
    accel = TorchAccelerator(device=device)
    route = ("sparse (native host fold)" if accel._use_sparse(E, R, n_rows)
             else "dense (K2)")
    want = 0 if route.startswith("sparse") else -(-n_rows //
                                                   accel.STREAM_CHUNK_ROWS)
    out: dict = {"route": route, "rows": n_rows, "files": len(blobs),
                 "chunks": CONSUMER_CHUNKS}
    for label in ("fold_payload_stream", "fold_payloads"):
        reset_launches()
        trace.reset()
        t0 = time.perf_counter()
        state = ORSet()
        if label == "fold_payload_stream":
            ok = accel.fold_payload_stream(
                state, xchacha.decrypt_blobs_chunked(
                    key, blobs, n_chunks=CONSUMER_CHUNKS), actors_hint=actors)
        else:
            with trace.span("stream.decrypt"):
                clears = xchacha.decrypt_blobs(key, blobs)
            ok = accel.fold_payloads(state, clears, actors_hint=actors)
            del clears
        wall = time.perf_counter() - t0
        launches = read_launches()
        snap = trace.snapshot()
        got = canonical_bytes(state)
        spans = {k: (v["seconds"], v["count"])
                 for k, v in snap["spans"].items()}
        out[label] = dict(wall_s=wall, launches=launches, spans=spans,
                          h2d_bytes=snap["counters"].get("h2d_bytes", 0))
        print(f"  (c) {label}: wall {wall:.3f} s, route {route}, launches "
              f"{launches}, bytes equal to the host loop's: "
              f"{got == host_bytes}", flush=True)
        for k, (sec, cnt) in sorted(spans.items()):
            print(f"    span {k}: {sec * 1e3:.1f} ms x{cnt}", flush=True)
        if not ok or got != host_bytes or (
                device == "cuda" and launches["orset_fold"] != want):
            raise AssertionError(
                f"(c) {label}: folded {ok}, equal {got == host_bytes}, K2 "
                f"{launches['orset_fold']} (expected {want} on the {route} "
                "route)")
        del state
    out["stream_over_fold_payloads"] = (out["fold_payload_stream"]["wall_s"]
                                        / out["fold_payloads"]["wall_s"])
    print(f"  (c) the stream's wall / fold_payloads' wall (decrypt "
          f"included in both): {out['stream_over_fold_payloads']:.3f}",
          flush=True)
    return out


def phase_consumer(device: str = "cuda") -> dict:
    """Phase 22: (a) the RFC vectors, (b) the consumer replica, (c) the
    payload stream.  Each part's kernel launches counted from 0."""
    E, R = N_MEMBERS, N_REPLICAS
    t0 = time.perf_counter()
    vectors = x25519_vectors()
    cols = gen_columns(N_ROWS, R, E, SEED)
    files = compaction_files(cols, actor_bytes_table(R))
    print(f"  {len(files)} op files made in {time.perf_counter() - t0:.1f} s",
          flush=True)
    remote = phase_consumer_remote(files, cols, E, R, device)
    del cols
    print(device_line(), flush=True)
    stream = phase_consumer_stream(files, E, R, device,
                                   remote.pop("first_bytes"))
    wall = time.perf_counter() - t0
    launches = {k: remote["launches"][k]
                + stream["fold_payload_stream"]["launches"][k]
                + stream["fold_payloads"]["launches"][k]
                for k in remote["launches"]}
    print(f"  phase 22 wall {wall:.1f} s; launches {launches}", flush=True)
    return {"vectors": vectors, "remote": remote, "stream": stream,
            "launches": launches, "wall_s": wall}


# phase 23: the port's bench entry points (crdt_enc_tpu_torch.bench and
# .benchmarks) in process at their --smoke sizes, each mode's and config's
# one record checked and appended to one --record file, over which
# obs_report trend must run; the gate fields each must hold true
BENCH_RUNS = (
    ("default", [], ("full_batch_equal",)),
    ("e2e-streaming", ["--e2e-streaming", "--producers", "1,2"],
     ("full_batch_equal",)),
    ("device-decode", ["--device-decode"], ("columns_equal",)),
    ("e2e-multitenant", ["--e2e-multitenant"], ("byte_identical",)),
    ("e2e-multitenant-mesh", ["--e2e-multitenant", "--mesh", "dp=2"],
     ("byte_identical",)),
    ("e2e-daemon", ["--e2e-daemon"], ("byte_identical",)),
    ("e2e-idle-cycle", ["--e2e-idle-cycle"], ("byte_identical",)),
    ("e2e-warm-open", ["--e2e-warm-open"],
     ("byte_identical", "opened_from_checkpoint")),
    ("e2e-delta", ["--e2e-delta"], ("byte_identical",)),
    ("e2e-strong-read", ["--e2e-strong-read"], ("byte_identical",)),
    ("sim", ["--sim"], ()),
    ("sim-population", ["--sim", "--population", "2"],
     ("serial_equivalent",)),
)
BENCH_HEADER = (
    "== 23. the bench entry points (crdt_enc_tpu_torch.bench's ten modes, "
    "benchmarks.suite's five configs, compaction_e2e, streaming_phases) at "
    "--smoke on the card, one --record file, obs_report trend over it")


def stdout_text(fn, argv: list) -> tuple:
    """``fn(argv)`` with its standard output captured: ``(exit code,
    text)``; standard error passes through."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def stdout_lines(fn, argv: list) -> tuple:
    """``fn(argv)``'s exit code and its JSON lines."""
    rc, text = stdout_text(fn, argv)
    return rc, [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def check_bench_record(label: str, rec: dict, gates, device: str,
                       name: str | None) -> None:
    """A bench record measured on ``device`` (the card's ``name``), every
    gate true, a roofline share under 100% where one is reported."""
    problems = []
    if rec.get("backend") != device:
        problems.append(f"backend {rec.get('backend')!r}")
    if name is not None and rec.get("device_name") != name:
        problems.append(f"device_name {rec.get('device_name')!r}")
    for g in gates:
        if rec.get(g) is not True:
            problems.append(f"{g} {rec.get(g)!r}")
    pct = rec.get("pct_hbm_peak")
    if pct is not None and not pct < 100.0:
        problems.append(f"pct_hbm_peak {pct}")
    if problems:
        raise AssertionError(f"phase 23 {label}: {', '.join(problems)}")


def phase_bench(device: str, root: str) -> dict:
    """Phase 23 (module docs): every bench mode, every suite config,
    compaction_e2e (its children in process: at this size the process
    split measures nothing) and streaming_phases, each checked, then
    ``obs_report trend`` over their records.  Kernel launches per entry
    come from each record (counted from 0 by the bench itself)."""
    import torch

    from crdt_enc_tpu_torch import bench
    from crdt_enc_tpu_torch.benchmarks import (
        compaction_e2e,
        streaming_phases,
        suite,
    )
    from crdt_enc_tpu_torch.tools import obs_report

    name = torch.cuda.get_device_name(0) if device == "cuda" else None
    path = os.path.join(root, "bench_records.jsonl")
    record = ["--device", device, "--record", path]
    out = {"runs": {}, "launches": {k: 0 for k in KERNELS}}
    t_all = time.perf_counter()

    def note(label: str, rec: dict, t0: float) -> None:
        wall = time.perf_counter() - t0
        out["runs"][label] = {
            "metric": rec["metric"], "config": rec.get("config"),
            "value": rec["value"], "unit": rec.get("unit"),
            "wall_s": round(wall, 3), "launches": rec["launches"],
            **{k: v for k, v in rec.items()
               if k in ("pct_hbm_peak", "method", "device_ms", "library_ms")
               or k.endswith("_spread_pct")}}
        for k in out["launches"]:
            out["launches"][k] += rec["launches"].get(k, 0)
        print(f"  {label}: {rec['metric']} = {rec['value']} "
              f"{rec.get('unit', '')} in {wall:.1f} s; launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }",
              flush=True)

    for label, flags, gates in BENCH_RUNS:
        t0 = time.perf_counter()
        rc, lines = stdout_lines(bench.main, flags + ["--smoke"] + record)
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"phase 23 {label}: exit {rc}, "
                                 f"{len(lines)} lines")
        check_bench_record(label, lines[0], gates, device, name)
        note(label, lines[0], t0)
    for i in range(1, 6):
        t0 = time.perf_counter()
        rc, lines = stdout_lines(suite.main, ["--smoke", "--iters", "1",
                                              "--config", str(i)] + record)
        if rc != 0 or len(lines) != 2 or not lines[-1]["all_byte_equal"]:
            raise AssertionError(f"phase 23 suite config {i}: exit {rc}")
        check_bench_record(f"suite config {i}", lines[0], ("byte_equal",),
                           device, name)
        note(f"suite-config-{i}", lines[0], t0)

    def child(args: list) -> str:
        rc_, lines_ = stdout_lines(compaction_e2e.main, args)
        if rc_ != 0:
            raise AssertionError(f"phase 23 compaction_e2e child {args[:1]}")
        return json.dumps(lines_[-1])

    t0 = time.perf_counter()
    spawn = compaction_e2e._child
    compaction_e2e._child = child
    try:
        rc, lines = stdout_lines(compaction_e2e.main, ["--smoke"] + record)
    finally:
        compaction_e2e._child = spawn
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"phase 23 compaction_e2e: exit {rc}")
    check_bench_record("compaction_e2e", lines[0], ("byte_equal",), device,
                       name)
    note("compaction_e2e", lines[0], t0)
    t0 = time.perf_counter()
    rc, lines = stdout_lines(streaming_phases.main, ["--smoke"] + record)
    if rc != 0 or len(lines) != 1:
        raise AssertionError(f"phase 23 streaming_phases: exit {rc}")
    check_bench_record("streaming_phases", lines[0], ("byte_equal",), device,
                       name)
    note("streaming_phases", lines[0], t0)
    with open(path) as f:
        n_records = sum(1 for ln in f if ln.strip())
    want = len(BENCH_RUNS) + 5 + 2
    if n_records != want:
        raise AssertionError(f"phase 23: {n_records} records, want {want}")
    rc, text = stdout_text(obs_report.main, ["trend", path])
    if rc != 0:
        raise AssertionError(f"phase 23: obs_report trend exited {rc}")
    out["trend_configs"] = sum(1 for ln in text.splitlines()
                               if ln.startswith("# "))
    out["records"] = n_records
    out["wall_s"] = round(time.perf_counter() - t_all, 2)
    print(f"  obs_report trend over {n_records} records: "
          f"{out['trend_configs']} configs, exit 0", flush=True)
    print(f"  phase 23 wall {out['wall_s']:.1f} s; launches "
          f"{out['launches']}", flush=True)
    return out


# ---- phase 24: the settings surface -----------------------------------------

SETTINGS_HEADER = (
    f"== 24. settings: (a) sparse_device at config 5 (N={CFG5_N}, "
    f"R={CFG5_R}, E={CFG5_E}); (b) an encrypted FsStorage compaction under "
    "CRDT_REPL_SAMPLE=0 CRDT_DELTA=0; (c) a FoldService cycle at "
    "ServeConfig(producers=2, io_width=4); (d) a burn-paced FleetDaemon")
# (b): a config-3-shaped remote cut to a few hundred op files, its last
# SETTINGS_TAIL_PCT% held back as the second compaction's tail
SETTINGS_FS_N, SETTINGS_FS_R, SETTINGS_FS_E = 24_000, 500, 512
SETTINGS_TAIL_PCT = 10
# (d): the daemon's tenants (the first of (c)'s fleet) and its pacing
SETTINGS_DAEMON_T = 16
SETTINGS_INTERVAL = dict(interval_min_s=0.05, interval_max_s=8.0,
                         burn_window_s=30.0)


@contextlib.contextmanager
def environ(**values):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_settings_coo(device: str) -> dict:
    """(a): config 5's op files through ``fold_payloads`` of a
    ``TorchAccelerator(sparse_device=True)`` (the COO fold on the card)
    and of the default accelerator (the native host fold), byte-equal,
    with both walls, the card's peak memory over the COO route, no fold
    kernel launched, and ``orset_fold_coo`` alone timed with CUDA events
    on the route's own inputs against the host fold alone."""
    import torch

    from crdt_enc_tpu_torch import ORSet, TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.ops.columnar import (
        Vocab,
        orset_fold_sparse_host,
        vclock_to_dense,
    )
    from crdt_enc_tpu_torch.ops.orset import orset_fold_coo
    from crdt_enc_tpu_torch.utils import codec, trace

    N, R, E = CFG5_N, CFG5_R, CFG5_E
    actors = actor_bytes_table(R)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, CFG5_SEED)
    files = compaction_files(cols, actors)
    payloads = [codec.pack(ops) for *_, ops in files]
    print(f"  (a) {len(files)} op files built in "
          f"{time.perf_counter() - t0:.1f} s; 2*E*R = {2 * E * R} "
          f"(< 2^31: {2 * E * R < 2**31})", flush=True)
    out: dict = {"N": N, "R": R, "E": E, "op_files": len(files)}

    def route(label, accel):
        reset_launches()
        trace.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = ORSet()
        t1 = time.perf_counter()
        if accel.fold_payloads(state, payloads, actors_hint=actors) is not True:
            raise AssertionError(f"(a) {label}: fold_payloads declined")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        snap = trace.snapshot()
        launches = read_launches()
        r = {"wall_s": wall,
             "peak_mb": (torch.cuda.max_memory_allocated() - base) / 1e6,
             "spans": {k: v["seconds"] for k, v in snap["spans"].items()},
             "h2d_bytes": snap["counters"].get("h2d_bytes", 0),
             "launches": launches}
        print(f"  (a) {label}: wall {wall * 1e3:.1f} ms, card peak "
              f"{r['peak_mb']:.1f} MB over the route, h2d "
              f"{r['h2d_bytes']} B, launches "
              f"{ {k: v for k, v in launches.items() if v} }", flush=True)
        for k, v in sorted(r["spans"].items()):
            print(f"    span {k}: {v * 1e3:.2f} ms", flush=True)
        return state, r

    # each route twice: the first COO call also pays the first use of
    # torch's sort and scatter kernels on the card
    states = {}
    for run in ("first", "warm"):
        for label, key, accel in (
            ("native host fold", "host_fold", TorchAccelerator(device=device)),
            ("COO fold on the card", "coo_fold",
             TorchAccelerator(device=device, sparse_device=True)),
        ):
            states[key], r = route(f"{label} ({run})", accel)
            out[key if run == "first" else f"{key}_warm"] = r
        host_bytes = canonical_bytes(states["host_fold"])
        same = canonical_bytes(states["coo_fold"]) == host_bytes
        print(f"  (a) bytes equal: {same} ({len(host_bytes)} bytes)",
              flush=True)
        if not same:
            raise AssertionError("(a) the COO fold differs from the host "
                                 "fold")
    for run in ("", "_warm"):
        coo, host = out["coo_fold" + run], out["host_fold" + run]
        if "fold.coo" not in coo["spans"] or "fold.coo" in host["spans"]:
            raise AssertionError("(a) the routes did not take their folds")
        if device == "cuda" and not coo["h2d_bytes"]:
            raise AssertionError("(a) the COO fold uploaded nothing to the "
                                 "card")
        if any(coo["launches"].values()) or any(host["launches"].values()):
            raise AssertionError("(a) a fold kernel launched in the sparse "
                                 "regime")
    # the two folds alone, on the route's own columns
    kind, member, actor, counter = cols
    members, replicas = Vocab(range(E)), Vocab(actors)
    clock0 = vclock_to_dense(ORSet().clock, replicas)
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for a in (clock0, kind, member, actor, counter)]

    def coo_call():
        return orset_fold_coo(*dev, num_members=E, num_replicas=R)

    t1 = time.perf_counter()
    orset_fold_sparse_host(ORSet(), kind, member, actor, counter,
                           Vocab(range(E)), Vocab(actors))
    out["host_fold_alone_ms"] = (time.perf_counter() - t1) * 1e3
    out["coo_alone_ms"] = time_ms(coo_call) if device == "cuda" else None
    print(f"  (a) alone: orset_fold_coo {out['coo_alone_ms']} ms (CUDA "
          f"events, median of {REPS}; the {N}-row batch's sort and run "
          f"ends) against the native host fold "
          f"{out['host_fold_alone_ms']:.2f} ms (one call, host clock)",
          flush=True)
    del dev, payloads, files, cols
    return out


def settings_fs_files():
    """(b)'s op files: config-3-shaped rows at SETTINGS_FS_* over their
    own actors, as (actor index, actor id, version, ops)."""
    actors = actor_bytes_table(SETTINGS_FS_R)
    cols = gen_columns(SETTINGS_FS_N, SETTINGS_FS_R, SETTINGS_FS_E, SEED)
    return compaction_files(cols, actors)


def remote_files(remote: str) -> dict:
    """relative path -> bytes of every file under ``remote``."""
    out = {}
    for d, _, names in os.walk(remote):
        for n in names:
            p = os.path.join(d, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, remote)] = f.read()
    return out


def phase_settings_fs(device: str, root: str) -> dict:
    """(b): one encrypted FsStorage remote, copied three ways with one
    compactor identity: a card ``Core`` and a host-loop ``Core`` compact
    it under ``CRDT_REPL_SAMPLE=0 CRDT_DELTA=0``, then again after a
    tail; neither takes a ``repl.status`` span or writes a delta file,
    and their states equal.  A card ``Core`` under the defaults (the
    control) takes the sample and seals a delta on the same rounds, so
    the switches are what made the difference."""
    import asyncio

    from crdt_enc_tpu_torch import (
        Core,
        FsStorage,
        HostAccelerator,
        TorchAccelerator,
        canonical_bytes,
    )
    from crdt_enc_tpu_torch.utils import trace

    base = os.path.join(root, "settings")
    t0 = time.perf_counter()
    files = settings_fs_files()
    n_tail = max(1, len(files) * SETTINGS_TAIL_PCT // 100)
    head, tail = files[:-n_tail], files[-n_tail:]

    async def build():
        writer = await Core.open(compaction_options(
            base, "writer", os.path.join(base, "remote"), HostAccelerator()))
        blobs = await asyncio.gather(*(writer._seal(ops)
                                       for *_, ops in files))
        store = FsStorage(os.path.join(base, "store"),
                          os.path.join(base, "remote"))
        await asyncio.gather(*(store.store_ops(ab, v, blob) for
                               (_, ab, v, _), blob in
                               zip(head, blobs[:len(head)])))
        # the compactor's identity, copied with the remote
        await Core.open(compaction_options(base, "ident",
                                           os.path.join(base, "remote"),
                                           HostAccelerator()))
        return [(ab, v, blob) for (_, ab, v, _), blob in
                zip(tail, blobs[len(head):])]

    tail_blobs = run_async(build())
    variants = ("card", "host", "control")
    for v in variants:
        shutil.copytree(os.path.join(base, "remote"),
                        os.path.join(base, f"remote-{v}"))
        shutil.copytree(os.path.join(base, "ident"),
                        os.path.join(base, f"local-{v}"))
    print(f"  (b) {len(head)} + {len(tail)} op files "
          f"({SETTINGS_FS_N} rows, R={SETTINGS_FS_R}, E={SETTINGS_FS_E}) "
          f"sealed and copied in {time.perf_counter() - t0:.1f} s", flush=True)

    def compact_twice(v: str, accel) -> tuple:
        remote = os.path.join(base, f"remote-{v}")

        async def go():
            trace.reset()
            t1 = time.perf_counter()
            core = await Core.open(compaction_options(
                base, f"local-{v}", remote, accel, create=False))
            await core.compact()
            store = FsStorage(os.path.join(base, f"local-{v}"), remote)
            for ab, ver, blob in tail_blobs:
                await store.store_ops(ab, ver, blob)
            await core.compact()
            return core, time.perf_counter() - t1

        reset_launches()
        core, wall = run_async(go())
        snap = trace.snapshot()
        deltas = [p for p in remote_files(remote) if p.startswith("deltas")]
        r = {"wall_s": wall, "deltas": len(deltas),
             "repl_status": snap["spans"].get("repl.status", {}).get(
                 "count", 0),
             "delta_files_sealed": snap["counters"].get(
                 "delta_files_sealed", 0),
             "launches": read_launches()}
        print(f"  (b) {v}: two compactions {wall:.2f} s, repl.status spans "
              f"{r['repl_status']}, delta files {r['deltas']}, launches "
              f"{ {k: n for k, n in r['launches'].items() if n} }", flush=True)
        return core.with_state(canonical_bytes), r

    out: dict = {"op_files": len(files), "tail_files": len(tail)}
    with environ(CRDT_REPL_SAMPLE="0", CRDT_DELTA="0"):
        card, out["card"] = compact_twice("card", TorchAccelerator(device))
        host, out["host"] = compact_twice("host", HostAccelerator())
    control, out["control"] = compact_twice("control",
                                            TorchAccelerator(device))
    for v in ("card", "host"):
        if out[v]["repl_status"] or out[v]["deltas"]:
            raise AssertionError(f"(b) {v}: the switches did not act: "
                                 f"{out[v]}")
    if not (out["control"]["repl_status"] and out["control"]["deltas"]):
        raise AssertionError(f"(b) the control sealed no delta or took no "
                             f"sample: {out['control']}")
    if not card == host == control:
        raise AssertionError("(b) the compacted states differ")

    async def read_back():
        core = await Core.open(compaction_options(
            base, "reader", os.path.join(base, "remote-card"),
            HostAccelerator()))
        await core.read_remote()
        return core.with_state(canonical_bytes)

    if run_async(read_back()) != host:
        raise AssertionError("(b) the card's remote does not read back")
    print(f"  (b) card = host loop = control ({len(host)} bytes); the card's "
          "remote reads back", flush=True)
    shutil.rmtree(base, ignore_errors=True)
    return out


def phase_settings_serve(device: str) -> dict:
    """(c) and (d): phase 19 (d)'s 256-tenant mix sealed once and copied;
    one ``FoldService`` cycle at the defaults and one at
    ``ServeConfig(producers=2, io_width=4)``, each tenant's state equal
    across the two, with the same K2 launches; then a
    ``FleetDaemon(interval_auto=True)`` over SETTINGS_DAEMON_T of the
    configured tenants on an injected clock, its ``next_interval`` driven
    from ``interval_max_s`` to ``interval_min_s`` by a freshness target
    every tenant misses (``CRDT_SLO_FRESHNESS_LAG=-1``), and back once
    the target is met and the window has passed."""
    from crdt_enc_tpu_torch import TorchAccelerator, canonical_bytes
    from crdt_enc_tpu_torch.serve import (
        DaemonConfig,
        FleetDaemon,
        FoldService,
        ServeConfig,
    )
    from crdt_enc_tpu_torch.utils import trace

    t0 = time.perf_counter()
    spec = serve_fleet_spec(scale=OBS_SCALE, cap=False)
    remotes, _ = run_async(seal_fleet(spec))
    cfg = ServeConfig(producers=2, io_width=4)
    fleets = {
        "default": serve_open(remotes, spec, TorchAccelerator(device), set()),
        "configured": serve_open([copy_memory_remote(r) for r in remotes],
                                 spec, TorchAccelerator(device), set()),
    }
    print(f"  (c) {len(spec)} tenants sealed and opened twice in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    out: dict = {"tenants": len(spec)}
    results = {}
    for label, config in (("default", ServeConfig()), ("configured", cfg)):
        service = FoldService(fleets[label], config)
        reset_launches()
        trace.reset()
        t1 = time.perf_counter()
        try:
            results[label] = run_async(service.run_cycle())
        finally:
            service.close()
        wall = time.perf_counter() - t1
        snap = trace.snapshot()
        launches = read_launches()
        errors = [r.error for r in results[label] if r.error]
        out[label] = {
            "wall_s": wall, "launches": launches,
            "stream_producers": snap["gauges"].get("stream_producers"),
            "sealed": sum(1 for r in results[label] if r.sealed),
            "errors": len(errors)}
        print(f"  (c) {label}: cycle {wall:.3f} s, "
              f"{out[label]['sealed']} sealed, decode producers "
              f"{out[label]['stream_producers']}, launches "
              f"{ {k: n for k, n in launches.items() if n} }", flush=True)
        if errors:
            raise AssertionError(f"(c) {label}: tenant errors {errors[:3]}")
    d, c = out["default"], out["configured"]
    if c["stream_producers"] != 2:
        raise AssertionError("(c) the decode fan-out did not take "
                             "producers=2")
    if c["launches"] != d["launches"] or (
            device == "cuda" and not c["launches"]["orset_fold"]):
        raise AssertionError(f"(c) launches differ: {d['launches']} against "
                             f"{c['launches']}")
    paths = [[(r.path, r.rows, r.sealed) for r in results[k]]
             for k in ("default", "configured")]
    states = [[core.with_state(canonical_bytes) for core in fleets[k]]
              for k in ("default", "configured")]
    if paths[0] != paths[1] or states[0] != states[1]:
        raise AssertionError("(c) the configured cycle's tenants differ from "
                             "the default cycle's")
    print(f"  (c) every tenant's path, rows and state equal; K2 "
          f"{c['launches']['orset_fold']} launches in each cycle", flush=True)

    clock = [0.0]
    daemon = FleetDaemon(
        fleets["configured"][:SETTINGS_DAEMON_T],
        DaemonConfig(interval_auto=True, **SETTINGS_INTERVAL),
        clock=lambda: clock[0])
    seq = [daemon.next_interval()]
    with environ(CRDT_SLO_FRESHNESS_LAG="-1"):
        for step in (1.0, 2.0):
            clock[0] = step
            run_async(daemon.run_cycle())
            seq.append(daemon.next_interval())
    clock[0] = 2.0 + 2 * SETTINGS_INTERVAL["burn_window_s"]
    run_async(daemon.run_cycle())
    seq.append(daemon.next_interval())
    run_async(daemon.drain())
    lo, hi = (SETTINGS_INTERVAL["interval_min_s"],
              SETTINGS_INTERVAL["interval_max_s"])
    print(f"  (d) next_interval: {seq} (max {hi}, min {lo})", flush=True)
    if not (abs(seq[0] - hi) < 1e-9 and all(abs(s - lo) < 1e-9
                                            for s in seq[1:3])
            and abs(seq[3] - hi) < 1e-9):
        raise AssertionError(f"(d) the burn did not pace the daemon: {seq}")
    out["daemon_intervals"] = seq
    return out


def phase_settings(device: str, root: str) -> dict:
    """Phase 24 (module docs): (a) to (d)."""
    t0 = time.perf_counter()
    out = {"coo": phase_settings_coo(device)}
    gc.collect()
    out["fs"] = phase_settings_fs(device, root)
    out["serve"] = phase_settings_serve(device)
    out["wall_s"] = round(time.perf_counter() - t0, 2)
    print(f"  phase 24 wall {out['wall_s']:.1f} s", flush=True)
    return out


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
    "orset_stack_cells": ("crdt_enc_tpu_torch/csrc/orset_merge.cu",
                          "crdt_enc_tpu/parallel/accel.py:1380",
                          "none: the JAX merge stacks dense host planes "
                          "(np.stack) before K4"),
    "lww_fold": ("crdt_enc_tpu_torch/csrc/lww_fold.cu",
                 "crdt_enc_tpu/ops/pallas_lww.py:332",
                 "K5 lww_fold_pallas -> _lww_fold_pallas_impl"),
}


def analyze_cli(*args: str) -> dict:
    """``python3 -m crdt_enc_tpu_torch.tools.analyze ... --json`` from the
    repo root; its JSON output.  A non-zero exit raises."""
    cmd = [sys.executable, "-m", "crdt_enc_tpu_torch.tools.analyze", *args,
           "--json"]
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        print(proc.stdout[-8000:], proc.stderr[-8000:], sep="\n", flush=True)
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}")
    return json.loads(proc.stdout)


def phase_analysis(k2_enqueue_ms: float, build_s: float) -> dict:
    """Phase 20 (module docs): the analyzer over the checkout, then the
    effect chain from the fold service's cycle to K2's launch."""
    t0 = time.perf_counter()
    run = analyze_cli("--diff-baseline", "--expect-json-version", "2")
    wall = time.perf_counter() - t0
    per_rule = {r: {"errors": 0, "warnings": 0, "suppressed": 0}
                for r in run["rules"]}
    for f in run["findings"]:
        row = per_rule.setdefault(
            f["rule"], {"errors": 0, "warnings": 0, "suppressed": 0})
        if f["suppressed"] is not None:
            row["suppressed"] += 1
        elif f["severity"] == "error":
            row["errors"] += 1
        else:
            row["warnings"] += 1
    summary = run["summary"]
    if summary["errors"] or run["stale_baseline"]:
        raise AssertionError(f"analysis: {summary['errors']} errors, "
                             f"{len(run['stale_baseline'])} stale entries")
    eff = analyze_cli("--effects", "FoldService._run_cycle")
    (fn,) = eff["functions"]
    k2 = [e["chain"] for e in fn["effects"]
          if (e["kind"], e["origin"]) == ("blocks", "ffi:lib.orset_fold_launch")]
    if len(k2) != 1:
        raise AssertionError("no effect chain from FoldService._run_cycle to "
                             "lib.orset_fold_launch")
    out = {
        "files": summary["files"], "errors": summary["errors"],
        "warnings": summary["warnings"], "suppressed": summary["suppressed"],
        "per_rule": per_rule, "stale": len(run["stale_baseline"]),
        "elapsed_s": run["elapsed_s"], "subprocess_wall_s": wall,
        "k2_chain": k2[0], "k2_host_enqueue_ms": k2_enqueue_ms,
        "nvcc_build_s": build_s,
    }
    print(f"  phase 20: {json.dumps(out)}", flush=True)
    return out


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


_T0 = time.perf_counter()


def header(text: str, **kw) -> None:
    """A phase's header line, with the seconds since the script started."""
    print(f"{text} [t={time.perf_counter() - _T0:.1f} s]", **kw)


def start_watchdog() -> None:
    """A stalled run prints every thread's stack, removes
    ``_CLEANUP_DIRS`` and exits nonzero at ``WATCHDOG_S`` instead of dying
    silently at the limit.  faulthandler's own timer, 10 s later, dumps
    and exits even if the stall holds the GIL."""

    def fire():
        time.sleep(WATCHDOG_S)
        print(f"chip_smoke: stalled past {WATCHDOG_S} s; every thread's "
              "stack follows", file=sys.stderr, flush=True)
        faulthandler.dump_traceback(all_threads=True)
        for d in _CLEANUP_DIRS:
            shutil.rmtree(d, ignore_errors=True)
        os._exit(3)

    threading.Thread(target=fire, name="watchdog", daemon=True).start()
    faulthandler.dump_traceback_later(WATCHDOG_S + 10, exit=True)


def main(bench_only: bool = False) -> int:
    """Every phase, or with ``bench_only`` phases 1–9 and 23 (``python3
    chip_smoke.py --bench``)."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from crdt_enc_tpu_torch.ops import cuda_build

    start_watchdog()
    t_start = time.perf_counter()
    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    name = torch.cuda.get_device_name(0)
    header("== 1. device", flush=True)
    print(device_line(), flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    header("== 2. build", flush=True)
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

    header(f"== 3. kernels against plain (N={N}, E={E}, R={R}, S={MERGE_S})",
          flush=True)
    t0 = time.perf_counter()
    cols = gen_columns(N, R, E, SEED)
    cols2 = gen_columns(N, R, E, SEED2)
    print(f"  columns generated in {time.perf_counter() - t0:.2f}s "
          f"({int((cols[2] >= R).sum())} sentinel rows)", flush=True)
    errs, fold_inputs, stacks, skewed = phase_kernels(cols, cols2, E, R,
                                                      "cuda")

    header("== 4. the slice end to end", flush=True)
    launches = phase_end_to_end(cols, E, R, "cuda")

    header("== 5. times (median of 7, CUDA events)", flush=True)
    rate = peak_bytes_per_s(name)
    times = phase_times(fold_inputs, stacks, skewed, E, R, rate)
    del fold_inputs, stacks, skewed
    gc.collect()
    torch.cuda.empty_cache()
    k4_err, k4_shape, stack_err, stack = phase_k4_compaction_shape("cuda",
                                                                   rate)
    errs["orset_merge_many"] = max(errs["orset_merge_many"], k4_err)
    times["orset_merge_many"]["compaction_shape"] = k4_shape
    errs["orset_stack_cells"] = stack_err
    times["orset_stack_cells"] = stack

    header(f"== 6. LWW kernel against plain (config 4: N={LWW_N}, K={LWW_K}, "
          f"R={LWW_R}, V={LWW_V}; heavy ties; saturated; {PAST_N} rows; "
          f"both routes, both modes)", flush=True)
    lww_errs, lww_dev = phase_lww_kernels("cuda")
    errs.update(lww_errs)

    header("== 7. LWW and counters end to end", flush=True)
    launches["lww_fold"] = phase_lww_end_to_end("cuda")
    phase_counters_end_to_end("cuda")

    header("== 8. LWW times (median of 7, CUDA events; device times per launch "
          "from torch.profiler)", flush=True)
    times["lww_fold"] = phase_lww_times(lww_dev, rate)
    del lww_dev

    header(f"== 9. K3's shape (E={K3_E}, R={K3_R}, N={N_ROWS})", flush=True)
    k3_errs, k3 = phase_k3("cuda", rate)
    gc.collect()
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="crdt-compaction-")
    _CLEANUP_DIRS.append(root)
    try:
        if bench_only:
            del cols, cols2
            gc.collect()
            torch.cuda.empty_cache()
            header(BENCH_HEADER, flush=True)
            print(device_line(), flush=True)
            bench = phase_bench("cuda", root)
            kernels = [kernel_entry(k, launches, errs, times, k3_errs, k3)
                       | {"bench_launches": {
                           label: run["launches"][k]
                           for label, run in bench["runs"].items()}}
                       for k in KERNELS]
            print(f"chip_smoke --bench wall "
                  f"{time.perf_counter() - t_start:.1f}s", flush=True)
            print(device_line(), flush=True)
            print(json.dumps({"kernels": kernels}), flush=True)
            print(json.dumps({"bench": bench}), flush=True)
            return 0
        return run_from_phase_10(root, cols, cols2, launches, errs, times,
                                 k3_errs, k3, name, t_start, build_s)
    finally:
        close_loop()
        shutil.rmtree(root, ignore_errors=True)


def kernel_entry(kname: str, launches: dict, errs: dict, times: dict,
                 k3_errs: dict, k3: dict) -> dict:
    """A kernel's entry of the kernels line from phases 1–9: its route,
    source, the TPU kernel it replaces, phase 4's launches, its error
    against the plain version and its times."""
    source, replaces, pallas = KERNELS[kname]
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
    return entry


def run_from_phase_10(root, cols, cols2, launches, errs, times, k3_errs, k3,
                      name, t_start, build_s) -> int:
    """Phases 10 to 24 and the closing lines.  Phase 10's compaction remote
    lives under ``root`` until phase 14 has compacted it once more."""
    import torch

    E, R, N = N_MEMBERS, N_REPLICAS, N_ROWS
    header(f"== 10. compaction end to end (config 3: N={N}, R={R}, E={E}, "
          f"{COMPACT_OPS_PER_FILE} ops a file, S={COMPACT_SNAPSHOTS} "
          "snapshots; encrypted FsStorage)", flush=True)
    print(device_line(), flush=True)
    print(f"  remote under {root} ({fs_type(root)})", flush=True)
    files = compaction_files(cols, actor_bytes_table(R))
    clock, version = compactor_clocks(cols, files, R)
    compaction, live = phase_compaction(files, E, R, "cuda", root)
    del cols, cols2
    gc.collect()
    torch.cuda.empty_cache()

    header(f"== 11. the stream route past 2^22 rows (N={STREAM_N}, E={E}, "
          f"R={R})", flush=True)
    print(device_line(), flush=True)
    stream = phase_stream("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    header(f"== 12. fold sessions ({len(files)} op files of phase 10, "
          f"{SESSION_FEED_FILES} a feed)", flush=True)
    print(device_line(), flush=True)
    sessions = phase_sessions(files, actor_bytes_table(R), "cuda")
    del files
    gc.collect()

    header(f"== 13. config 5 in the sparse regime (N={CFG5_N}, R={CFG5_R}, "
          f"E={CFG5_E}, {COMPACT_OPS_PER_FILE} ops a file; encrypted "
          "MemoryStorage)", flush=True)
    print(device_line(), flush=True)
    config5 = phase_config5("cuda")
    gc.collect()

    header(f"== 14. the plane cache at config-3 width ({len(CACHE_SEEDS)} "
          f"batches of fresh dots, N={N} each) and incremental compaction "
          f"with deltas ({TAIL_OPS}-op tails over phase 10's remote)",
          flush=True)
    print(device_line(), flush=True)
    plane_cache = phase_plane_cache(E, R, "cuda")
    reset_launches()
    incremental = phase_incremental(live, clock, version, E, R, "cuda", root,
                                    compaction)
    inc_launches = {k: sum(incremental[f"round{r}"]["launches"][k]
                           for r in TAIL_ROUNDS) for k in KERNELS}
    print(f"  launches over the tail rounds {TAIL_ROUNDS} (device "
          f"compactions only): {inc_launches}", flush=True)
    del live
    gc.collect()
    header(f"== 14c. the plane cache through Core.compact() (E={CC_E}, "
          f"R={CC_R}, N={CC_N}; {CC_ROUNDS} tails of {CC_TAIL_OPS} ops; "
          "encrypted FsStorage)", flush=True)
    print(device_line(), flush=True)
    cache_compaction = phase_cache_compaction("cuda", root)
    gc.collect()
    torch.cuda.empty_cache()

    header(f"== 15. the rest of the catalogue (CrdtMap<orset> N={MAP_N}, "
          f"R={MAP_R}; LWW register N={LWW_N}; MVReg S={MV_S}, V={MV_V}; "
          "G-Set, SeqList, MerkleReg, empty; encrypted MemoryStorage)",
          flush=True)
    print(device_line(), flush=True)
    catalogue = phase_catalogue("cuda", peak_bytes_per_s(name))
    gc.collect()
    torch.cuda.empty_cache()

    header(f"== 16. the multi-tenant fold service ({FLEET_T // SERVE_SCALE} "
          f"tenants of "
          f"{FLEET_N} ops, R={FLEET_R}, E={FLEET_E}, {FLEET_OPF}-op files; "
          f"{CAP_T} tenants at the cells cap, E={CAP_E}, R={CAP_R}, "
          f"N={CAP_N}; three cycles; encrypted MemoryStorage)", flush=True)
    print(device_line(), flush=True)
    serve = phase_serve("cuda", peak_bytes_per_s(name))
    errs["orset_fold"] = max(errs["orset_fold"], serve["max_abs_err"])
    gc.collect()
    torch.cuda.empty_cache()

    header(f"== 17. the fleet daemon (FleetDaemon over phase 16's "
          f"{FLEET_T // SERVE_SCALE} + "
          f"{CAP_T} tenants, the card's copy and the host reference's; "
          f"{DAEMON_FLAKY} tenants down for {DAEMON_OUTAGE} cycles; then "
          f"tools.daemon run over {CLI_T} FsStorage tenants)", flush=True)
    print(device_line(), flush=True)
    daemon = phase_daemon("cuda")
    gc.collect()
    daemon["cli"] = phase_daemon_cli("cuda", root)

    header(f"== 18. the adversarial simulator (fleet {SIM_FLEET[1]} replicas x "
          f"{SIM_FLEET[2]} steps; {SIM_POP_N} schedules at P={SIM_POP_P}; "
          f"bench shape {SIM_BENCH_R}x{SIM_BENCH_STEPS}; tools.sim replay, "
          "tools.daemon selftest)", flush=True)
    print(device_line(), flush=True)
    t0 = time.perf_counter()
    sim = phase_sim("cuda")
    sim["wall_s"] = time.perf_counter() - t0
    print(f"  phase 18 wall {sim['wall_s']:.1f} s", flush=True)

    header(f"== 19. the operator's read side (obs_report over the card's own "
          f"records: a config-3 stream, {OBS_FLEET_DEVICES} devices, a "
          f"{FLEET_T // OBS_SCALE}-tenant service, the committed goldens, "
          f"simcov), the reference migration ({MIG_ACTORS} x {MIG_FILES} x "
          f"{MIG_OPS} MVReg ops) and the device decode (N={DD_N}, R={DD_R})",
          flush=True)
    print(device_line(), flush=True)
    obs = phase_obs("cuda", root, sim)
    gc.collect()
    torch.cuda.empty_cache()

    header("== 20. the static-analysis twin (crdt_enc_tpu_torch.tools.analyze "
          "--diff-baseline over the checkout; the K2 launch's effect chain)",
          flush=True)
    analysis = phase_analysis(times["orset_fold"]["host_enqueue_ms"], build_s)

    header(f"== 21. the mesh on the card (sharded ops at config-3 width on "
          f"{', '.join(f'({a}, {b})' for a, b in MESH_SHAPES)} shards of "
          f"cuda:0; Core.compact() on a (2, 2) mesh at 1/{MESH_DEPTH} of "
          f"config 3's rows, in memory; a (2, 1) mesh FoldService and FleetDaemon over "
          f"{FLEET_T // OBS_SCALE} tenants; an NCCL group of one)",
          flush=True)
    print(device_line(), flush=True)
    mesh = phase_mesh("cuda")
    for k, v in mesh["errs"].items():
        if k in errs:
            errs[k] = max(errs[k], v)
    gc.collect()
    torch.cuda.empty_cache()

    header(CONSUMER_HEADER, flush=True)
    print(device_line(), flush=True)
    consumer = phase_consumer("cuda")
    gc.collect()
    torch.cuda.empty_cache()

    header(BENCH_HEADER, flush=True)
    print(device_line(), flush=True)
    bench = phase_bench("cuda", root)
    gc.collect()
    torch.cuda.empty_cache()

    header(SETTINGS_HEADER, flush=True)
    print(device_line(), flush=True)
    settings = phase_settings("cuda", root)
    gc.collect()
    torch.cuda.empty_cache()

    kernels = []
    for kname in KERNELS:
        entry = kernel_entry(kname, launches, errs, times, k3_errs, k3)
        if kname == "orset_fold":
            entry["stream_launches"] = {
                r: stream[r]["launches"] for r in ("fold_payloads", "fold_ops")}
            entry["session_launches"] = sessions["device_stream"]["launches"]
        entry["compaction_launches"] = compaction["launches"][kname]
        entry["incremental_launches"] = {
            "plane_cache_fold_ops": plane_cache["fold_ops"]["launches"][kname],
            "plane_cache_fold_payloads":
                plane_cache["fold_payloads"]["launches"][kname],
            "compaction_tail_rounds": inc_launches[kname],
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
        entry["sim_launches"] = {
            "fleet": sim["fleet"]["device"]["launches"][kname],
            "population": sim["population"]["device"]["launches"][kname],
            "bench_serial": sim["throughput"]["serial"]["cuda"]["launches"][
                kname],
            f"bench_p{SIM_POP_P}": sim["throughput"][f"p{SIM_POP_P}"]["cuda"][
                "launches"][kname],
            "replay": sim["replay"]["launches"][kname],
            "selftest": sim["selftest"]["launches"][kname]}
        entry["obs_launches"] = {
            part: obs[part]["launches"][kname]
            for part in ("stream", "fleet", "service", "migration",
                         "device_decode")}
        entry["mesh_launches"] = mesh["launches"][kname]
        entry["consumer_launches"] = {
            **{step: s["launches"][kname]
               for step, s in consumer["remote"]["steps"].items()},
            **{route: consumer["stream"][route]["launches"][kname]
               for route in ("fold_payload_stream", "fold_payloads")}}
        entry["bench_launches"] = {
            label: run["launches"][kname]
            for label, run in bench["runs"].items()}
        entry["settings_launches"] = {
            "coo_fold_payloads": settings["coo"]["coo_fold"]["launches"][
                kname],
            "fs_compactions": settings["fs"]["card"]["launches"][kname],
            "serve_default": settings["serve"]["default"]["launches"][kname],
            "serve_configured": settings["serve"]["configured"]["launches"][
                kname]}
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
    print(json.dumps({"sim": sim}), flush=True)
    print(json.dumps({"obs": obs}), flush=True)
    print(json.dumps({"analysis": analysis}), flush=True)
    print(json.dumps({"mesh": {k: v for k, v in mesh.items()
                               if k != "errs"}}), flush=True)
    print(json.dumps({"consumer": consumer}), flush=True)
    print(json.dumps({"bench": bench}), flush=True)
    print(json.dumps({"settings": settings}), flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


def stall_loop(budget_s: float) -> int:
    """``python3 chip_smoke.py --stall-loop SECONDS``: phase 18 (b)'s
    serial-equality check of the first four population schedules, on
    the card, again and again for ``budget_s`` seconds.  A pass that
    takes over 90 s prints every thread's stack and exits nonzero; the
    last line counts the passes and their walls."""
    import logging

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crdt_enc_tpu_torch import native
    from crdt_enc_tpu_torch.ops import cuda_build
    from crdt_enc_tpu_torch.sim import (
        FaultConfig,
        PopulationReport,
        PopulationSubstrate,
        generate,
        run_population,
        verify_serial_equality,
    )

    logging.getLogger("crdt_enc_tpu_torch").setLevel(logging.ERROR)
    t_all = time.perf_counter()
    print(device_line(), flush=True)
    cuda_build.warm()
    native.load()
    native.load_state()
    faults = FaultConfig.all_faults()
    scheds = [generate(s, SIM_POP_R, SIM_POP_STEPS, faults,
                       members=SIM_POP_MEMBERS, deltas=True, daemon=True,
                       strong_reads=True) for s in range(SIM_POP_N)]
    sub = PopulationSubstrate("cuda")
    try:
        rep = run_population(scheds, population=SIM_POP_P, substrate=sub)
    finally:
        sub.close()
    sample = PopulationReport(schedules=rep.schedules[:4],
                              results=rep.results[:4])
    walls = []
    while time.perf_counter() - t_all < budget_s:
        faulthandler.dump_traceback_later(90, exit=True)
        t0 = time.perf_counter()
        problems = verify_serial_equality(sample, device="cuda")
        faulthandler.cancel_dump_traceback_later()
        walls.append(time.perf_counter() - t0)
        if problems:
            raise AssertionError(f"serial equality: {problems}")
        if len(walls) % 100 == 0:
            print(f"  pass {len(walls)}: max {max(walls):.3f} s", flush=True)
    print(json.dumps({"stall_loop": {
        "passes": len(walls), "max_s": max(walls),
        "mean_s": statistics.mean(walls), "wall_s": time.perf_counter() - t_all}}),
        flush=True)
    return 0


def consumer_only() -> int:
    """``python3 chip_smoke.py --consumer``: phases 1, 2 and 22 alone, the
    consumer replica's quick check on the card; its last line is the
    phase's JSON, not the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from crdt_enc_tpu_torch import native
    from crdt_enc_tpu_torch.ops import cuda_build

    start_watchdog()
    t0 = time.perf_counter()
    print(device_line(), flush=True)
    print(f"  kernels built in {cuda_build.build():.2f}s", flush=True)
    native.load()
    native.load_state()
    header(CONSUMER_HEADER, flush=True)
    try:
        consumer = phase_consumer("cuda")
    finally:
        close_loop()
    print(f"chip_smoke --consumer wall {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"consumer": consumer}), flush=True)
    return 0


def settings_only() -> int:
    """``python3 chip_smoke.py --settings``: phases 1, 2 and 24 alone; its
    last line is the phase's JSON, not the result line."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from crdt_enc_tpu_torch import native
    from crdt_enc_tpu_torch.ops import cuda_build

    start_watchdog()
    t0 = time.perf_counter()
    print(device_line(), flush=True)
    print(f"  kernels built in {cuda_build.build():.2f}s", flush=True)
    native.load()
    native.load_state()
    root = tempfile.mkdtemp(prefix="crdt-settings-")
    _CLEANUP_DIRS.append(root)
    header(SETTINGS_HEADER, flush=True)
    try:
        settings = phase_settings("cuda", root)
    finally:
        close_loop()
        shutil.rmtree(root, ignore_errors=True)
    print(f"chip_smoke --settings wall {time.perf_counter() - t0:.1f}s",
          flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"settings": settings}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--stall-loop"]:
        sys.exit(stall_loop(float(sys.argv[2])))
    if sys.argv[1:2] == ["--consumer"]:
        sys.exit(consumer_only())
    if sys.argv[1:2] == ["--settings"]:
        sys.exit(settings_only())
    sys.exit(main(bench_only=sys.argv[1:2] == ["--bench"]))
