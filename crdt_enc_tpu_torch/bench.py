"""The port's bench: BASELINE config 3's fold and the end-to-end modes.

The twin of the JAX package's root ``bench.py``, on the port
(``crdt_enc_tpu_torch``) and one CUDA card.  Run it as::

    python3 -m crdt_enc_tpu_torch.bench [--smoke] [--device cuda|cpu]
        [--record PATH] [MODE]

with MODE one of ``--e2e-streaming [--producers N,N,...]``,
``--e2e-warm-open``, ``--e2e-delta``, ``--e2e-multitenant [--tenants N]
[--mesh dp=N[,mp=M]]``, ``--e2e-idle-cycle``, ``--e2e-daemon [--tenants
N]``, ``--e2e-strong-read``, ``--sim [--replicas N] [--steps M]
[--faults all|none|cls,...] [--population P]`` or ``--device-decode``;
none runs the default mode, the config-3 fold (1M add/remove ops over
10,000 replicas and 4,096 members).  Each mode prints ONE JSON line with
the JAX bench's ``metric``, ``config`` and record fields, plus the card:
``backend`` ("cuda" or "cpu"), ``device_name``, ``power_limit_w`` (from
``nvidia-smi``) and ``device_count``; ``launches`` counts the port's
kernel launches over the mode's run.  Diagnostics go to stderr.

**The card is required** unless ``--device cpu`` is given (``--smoke``
only shrinks the sizes).  Without a card the bench prints one JSON line
with ``"value": null`` and ``"error": "cuda_unavailable"`` and exits 3.
A kernel that fails to build raises.  The ``host_*`` arms are the host
loop by design, and their fields say so.

**Records.**  Only ``--record PATH`` writes anything: each mode appends
its full record (the printed line, a timestamp, the workload's shape and
the registry snapshots) to PATH, which ``python3 -m
crdt_enc_tpu_torch.tools.obs_report trend PATH`` and ``gap PATH``
read.  A mode whose byte-equality gate fails prints its line, records
nothing and exits 1.  ``vs_baseline`` is the same-run host loop, unless
the port's own pin file (``benchmarks/pinned_baselines.json`` under this
package, written by ``python3 -m
crdt_enc_tpu_torch.benchmarks.pin_baselines``) holds the config at the
same shape.

**Timing.**  Device times come from CUDA events around back-to-back
calls after a warm-up, or end in a synchronize; a record's ``method``
names which.  Host walls are ``time.perf_counter`` spans.  Host samples
spread by tens of percent between runs, so every record keeps the raw
samples and their spread (``host_samples_s``, ``host_spread_pct``;
``device_samples_ms``, ``device_spread_pct`` for an arm timed by CUDA
events; ``{arm}_samples_s``, ``{arm}_spread_pct`` for an arm's host
walls, such as ``overlapped`` or ``serve``).

Env knobs (the JAX bench's): BENCH_OPS (1,000,000), BENCH_REPLICAS
(10,000), BENCH_MEMBERS (4096), BENCH_HOST_OPS (100,000), BENCH_ITERS
(3), BENCH_CHAIN (20 calls back to back), BENCH_ROUNDS (2),
BENCH_HOST_RUNS (5); each mode's own knobs are in its docstring.  The
JAX bench's BENCH_FULL_CHECK is not kept: the full-batch check is a gate
and always runs.
"""

from __future__ import annotations

import asyncio
import copy
import datetime
import json
import math
import os
import platform
import shutil
import subprocess
import sys
import tempfile
import time
import uuid
from collections import Counter

import numpy as np

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


# ------------------------------------------------------------- arguments


def flag_value(argv: list, flag: str, default=None):
    """The word after ``flag`` in ``argv``, else ``default``."""
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{flag} wants a value")
    return argv[i + 1]


def flag_int(argv: list, flag: str, default: int) -> int:
    """``--flag N`` (a positive count), else ``default``."""
    raw = flag_value(argv, flag)
    if raw is None:
        return default
    try:
        n = int(raw)
    except ValueError:
        raise SystemExit(f"{flag} wants N, got {raw!r}")
    if n <= 0:
        raise SystemExit(f"{flag} wants a positive count")
    return n


def producers_arg(argv: list) -> list:
    """The ``--producers`` sweep: ``N`` or ``N,N,...``; [1] without it."""
    raw = flag_value(argv, "--producers")
    if raw is None:
        return [1]
    try:
        ns = [int(x) for x in raw.split(",") if x.strip()]
    except ValueError:
        raise SystemExit(f"--producers wants N or N,N,... got {raw!r}")
    if not ns or any(n <= 0 for n in ns):
        raise SystemExit("--producers wants a positive count list")
    return ns


def mesh_arg(argv: list):
    """``--mesh dp=N[,mp=M]`` → ``(dp, mp)``, else None."""
    raw = flag_value(argv, "--mesh")
    if raw is None:
        return None
    from .parallel.mesh import parse_mesh_spec

    try:
        return parse_mesh_spec(raw)
    except ValueError as e:
        raise SystemExit(f"--mesh: {e} (got {raw!r})")


# ---------------------------------------------------------------- device


def _fail_unavailable(metric: str, unit: str) -> None:
    """No card and no ``--device cpu``: one diagnostic JSON line, exit 3,
    nothing recorded."""
    import torch

    print(json.dumps({
        "metric": metric, "value": None, "unit": unit, "vs_baseline": None,
        "error": "cuda_unavailable", "device": "cuda",
        "torch": torch.__version__,
    }), flush=True)
    raise SystemExit(3)


def acquire_device(argv: list, metric: str, unit: str):
    """The mode's ``torch.device``: ``--device cuda`` (the default) needs a
    card, ``--device cpu`` runs the plain versions on the host."""
    import torch

    name = flag_value(argv, "--device", "cuda")
    if name not in ("cuda", "cpu"):
        raise SystemExit(f"--device wants cuda or cpu, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        _fail_unavailable(metric, unit)
    return torch.device(name)


def smi_line() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card."""
    smi = shutil.which("nvidia-smi")
    if not smi:
        return None
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def device_info(device) -> dict:
    """The card a record was measured on: backend, name, power limit in
    watts (None where nvidia-smi cannot say) and device count."""
    import torch

    if device.type == "cuda":
        line = smi_line()
        power = None
        if line and "," in line:
            try:
                power = float(line.rsplit(",", 1)[1].strip().split()[0])
            except (ValueError, IndexError):
                power = None
        return {"backend": "cuda",
                "device_name": torch.cuda.get_device_name(device),
                "power_limit_w": power,
                "device_count": torch.cuda.device_count()}
    return {"backend": "cpu",
            "device_name": platform.processor() or platform.machine(),
            "power_limit_w": None, "device_count": 1}


def force_completion(device) -> None:
    """Every queued kernel has finished (a no-op on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_kernels(device) -> None:
    """Build (or load) the CUDA kernels and the native libraries before
    anything is timed; a failed build raises."""
    from . import native

    native.load()
    native.load_state()
    if device.type == "cuda":
        from .ops import cuda_build

        cuda_build.warm()


def reset_launches() -> None:
    from .ops import lww_fold_cuda, orset_fold_cuda, orset_merge_cuda

    for counts in (orset_fold_cuda.launches, orset_merge_cuda.launches,
                   lww_fold_cuda.launches):
        for k in counts:
            counts[k] = 0


def read_launches() -> dict:
    """Kernel launches per wrapper since :func:`reset_launches`."""
    from .ops import lww_fold_cuda, orset_fold_cuda, orset_merge_cuda

    return {**orset_fold_cuda.launches, **orset_merge_cuda.launches,
            **lww_fold_cuda.launches}


# --------------------------------------------------------------- records


def now_iso() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat(
        timespec="seconds")


def append_record(argv: list, rec: dict) -> None:
    """Append ``rec`` to the ``--record PATH`` file; without the flag,
    write nothing."""
    path = flag_value(argv, "--record")
    if path is None:
        return
    line = json.dumps(rec)  # serialize before touching the file
    with open(path, "a") as f:
        f.write(line + "\n")


def finish(argv: list, result: dict, device, ok: bool, why: str, *,
           launches: dict | None = None, **extra) -> dict:
    """Print the mode's one line; refuse to record (exit 1) unless the
    gates held; else append the full record where ``--record`` says.
    ``launches`` (default: the counts since the mode's reset) are the
    kernel launches of the measured run."""
    result.update(device_info(device))
    result["launches"] = read_launches() if launches is None else launches
    print(json.dumps(result), flush=True)
    if not ok:
        log(f"FAILED: {why} — refusing to record")
        raise SystemExit(1)
    append_record(argv, {**result, "ts": now_iso(),
                         "host_cpus": os.cpu_count(), **extra})
    return result


# ------------------------------------------------------- host protocol

# Host samples spread by tens of percent between runs: host baselines are
# the MEDIAN of BENCH_HOST_RUNS passes with the raw samples recorded.
HOST_RUNS = int(os.environ.get("BENCH_HOST_RUNS", 5))


def host_median(run_once, n: int = 0):
    """Median-of-n host baseline.  ``run_once`` returns (seconds, payload);
    returns (median_seconds, sorted_samples, first_payload)."""
    n = n or HOST_RUNS
    runs = [run_once() for _ in range(n)]
    times = sorted(t for t, _ in runs)
    return times[n // 2], times, runs[0][1]


def spread_fields(name: str, times: list) -> dict:
    """``{name}_samples_s`` (sorted) and ``{name}_spread_pct``, (max −
    min) / median: the record fields of an arm's repeated passes."""
    times = sorted(times)
    med = times[len(times) // 2]
    return {f"{name}_samples_s": [round(t, 4) for t in times],
            f"{name}_spread_pct":
                round(100.0 * (times[-1] - times[0]) / med, 1)
                if med > 0 else None}


def host_stats(times: list) -> dict:
    """The protocol's reporting fields for the host loop's samples."""
    return spread_fields("host", times)


def device_stats(times: list) -> dict:
    """The device arm's samples (ms) and their spread, as for the host."""
    times = sorted(times)
    med = times[len(times) // 2]
    return dict(
        device_samples_ms=[round(t * 1e3, 4) for t in times],
        device_spread_pct=round(100.0 * (times[-1] - times[0]) / med, 1)
        if med > 0 else None,
    )


# The port's own pinned host baselines: another host's numbers are never
# read (the JAX package's pin file is not).
PINNED_PATH = os.path.join(PACKAGE_DIR, "benchmarks", "pinned_baselines.json")


def load_pinned(config: str, shape: dict):
    """The pinned host record for ``config``, or None when absent or
    measured at another shape."""
    try:
        with open(PINNED_PATH) as f:
            pins = json.load(f)
    except (OSError, ValueError):
        return None
    rec = pins.get(config)
    if not rec or rec.get("shape") != shape:
        return None
    return rec


def pinned_ratio_fields(config: str, shape: dict, device_rate: float,
                        same_run_ratio: float) -> dict:
    """``vs_baseline``: the pinned ratio when a matching pin exists, the
    same-run ratio otherwise, with both recorded."""
    rec = load_pinned(config, shape)
    out = {"vs_same_run_host": round(same_run_ratio, 2)}
    if rec:
        raw = device_rate / rec["host_rate"]
        out["vs_pinned_baseline"] = round(raw, 2)
        out["pinned_host_rate"] = rec["host_rate"]
        out["pinned_machine"] = rec.get("machine")
        out["vs_baseline"] = out["vs_pinned_baseline"]
    else:
        raw = same_run_ratio
        out["vs_baseline"] = round(same_run_ratio, 2)
    out["_ratio_raw"] = raw  # full precision for the suite's geomean
    return out


# -------------------------------------------------------------- roofline

# peak device-memory rates (NVIDIA data sheets): the roofline every
# device time is checked against.  A fold whose bytes model over its time
# exceeds the rate is impossible — a timing that measured the enqueue —
# and the measurement is refused.
H100_SXM_BYTES_PER_S = 3.35e12
H100_PCIE_BYTES_PER_S = 2.0e12
H100_NVL_BYTES_PER_S = 3.9e12

# the dtypes the bytes model counts: the port's planes are int32 (E, R),
# its op columns an int8 kind and int32 member, actor and counter
PLANE_DTYPE = "int32"
ROW_BYTES = 1 + 4 + 4 + 4


def peak_bytes_per_s(device_name: str) -> float:
    if "PCIe" in device_name:
        return H100_PCIE_BYTES_PER_S
    if "NVL" in device_name:
        return H100_NVL_BYTES_PER_S
    return H100_SXM_BYTES_PER_S


def orset_fold_bytes_model(N: int, E: int, R: int) -> int:
    """Bytes ANY implementation of the dense OR-Set fold must touch: read
    and write both (E, R) int32 planes, the op columns, the clock."""
    return 2 * (2 * E * R * 4) + ROW_BYTES * N + 2 * 4 * R


def roofline_pct(bytes_model: float, t_dev: float, device):
    """% of the card's memory rate implied by touching ``bytes_model``
    bytes in ``t_dev`` seconds; None off CUDA."""
    if device.type != "cuda" or t_dev <= 0:
        return None
    import torch

    rate = peak_bytes_per_s(torch.cuda.get_device_name(device))
    return round(100.0 * bytes_model / t_dev / rate, 1)


def time_back_to_back(fn, device, chain: int, iters: int) -> list:
    """Per-call seconds of ``fn``: after one warm-up call, ``iters``
    samples, each ``chain`` calls back to back between two CUDA events
    (on the CPU, between two host clock reads)."""
    import torch

    fn()
    force_completion(device)
    samples = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end) / 1e3 / chain)
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                fn()
            samples.append((time.perf_counter() - t0) / chain)
    return samples


def timing_method(device) -> str:
    return ("cuda_events_back_to_back" if device.type == "cuda"
            else "host_clock_back_to_back")


# ------------------------------------------------------------ workloads


def gen_columns(N: int, R: int, E: int, seed: int = 7):
    """Vectorized op-stream generator (the JAX bench's, byte for byte):
    per-actor sequential add dots, ~10% removes whose horizon is the
    actor's add-count so far; removes before the actor ever added become
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
    actor = np.where(dead_rm, R, actor)
    return kind, member, actor, counter


def actor_bytes_table(R: int) -> list:
    """R actor ids whose byte order equals their index order."""
    return [uuid.UUID(int=i + 1).bytes for i in range(R)]


def host_fold(kind, member, actor, counter, R: int):
    """The single-core baseline: the port's host ORSet applied op by op."""
    from .models.orset import AddOp, ORSet, RmOp
    from .models.vclock import Dot, VClock

    state = ORSet()
    t0 = time.perf_counter()
    for k, m, a, c in zip(kind.tolist(), member.tolist(), actor.tolist(),
                          counter.tolist()):
        if a >= R:
            continue
        if k == 0:
            state.apply(AddOp(m, Dot(a, c)))
        else:
            state.apply(RmOp(m, VClock({a: c})))
    return state, time.perf_counter() - t0


def tenant_files(N: int, R: int, E: int, OPF: int, seed: int) -> list:
    """One tenant's (actor, version, ops) op files (config-3-shaped adds
    and removes over R actors, up to OPF ops a file within one actor,
    dense versions per actor): the JAX bench's layout."""
    actors = actor_bytes_table(R)
    kind, member, actor, counter = gen_columns(N, R, E, seed=seed)
    return files_from_columns(kind, member, actor, counter, actors, OPF)


def files_from_columns(kind, member, actor, counter, actors: list,
                       OPF: int) -> list:
    R = len(actors)
    live = actor < R
    order = np.argsort(actor[live], kind="stable")
    k_l, m_l = kind[live][order], member[live][order]
    a_l, c_l = actor[live][order], counter[live][order]
    i, n = 0, len(k_l)
    versions: dict = {}
    out = []
    while i < n:
        j = min(i + OPF, n)
        j = i + int(np.searchsorted(a_l[i:j], a_l[i], side="right"))
        ab = actors[int(a_l[i])]
        ops = []
        for t in range(i, j):
            if k_l[t] == 0:
                ops.append([0, int(m_l[t]), [ab, int(c_l[t])]])
            else:
                ops.append([1, int(m_l[t]), {ab: int(c_l[t])}])
        v = versions.get(ab, 0) + 1
        versions[ab] = v
        out.append((ab, v, ops))
        i = j
    return out


def orset_options(storage, device, *, create: bool = True,
                  cryptor=None, **kw):
    """``OpenOptions`` of an encrypted OR-Set replica on ``device``."""
    from .backends import PlainKeyCryptor, XChaChaCryptor
    from .core.adapters import orset_adapter
    from .core.core import OpenOptions
    from .parallel.accel import TorchAccelerator
    from .utils.versions import DEFAULT_DATA_VERSION_1

    if "accelerator" not in kw:
        kw["accelerator"] = TorchAccelerator(device=device)
    return OpenOptions(
        storage=storage,
        cryptor=cryptor if cryptor is not None else XChaChaCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create, **kw,
    )


def nearest_rank(vals: list, frac: float):
    """THE nearest-rank quantile (ceil(frac·n)-th smallest)."""
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, math.ceil(frac * len(s)) - 1))]


def quantiles_ms(samples_s: list) -> dict:
    """Exact nearest-rank p50/p99 and max of a latency sample, in ms."""
    return {
        "p50_ms": round(nearest_rank(samples_s, 0.50) * 1e3, 2),
        "p99_ms": round(nearest_rank(samples_s, 0.99) * 1e3, 2),
        "max_ms": round(max(samples_s) * 1e3, 2),
    }


def timed_host(fn) -> float:
    """The wall of one end-to-end pass."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ------------------------------------------------------ --e2e-streaming


def e2e_streaming(argv: list, smoke: bool) -> dict:
    """BASELINE config 5 end to end: encrypted op-file blobs in, the
    byte-identical OR-Set state out, through the overlapped pipeline
    (``TorchAccelerator.fold_encrypted_stream``: N producer threads
    decrypt and decode upcoming chunks while this thread folds the
    current one) against the non-overlapped front end (one decrypt batch,
    then the decode, then the fold) on the same workload.  ``--producers
    1,2,4`` sweeps the fan-out; the sequential pass and every N are
    byte-checked against the host loop (each blob decrypted on its own,
    its ops folded one by one through ``HostAccelerator``).  Every pass
    is a host wall (at the full size the session reduces on the host:
    HOST_REDUCE), so the samples are ``overlapped_*`` and
    ``sequential_*``, not ``device_*``.

    Env knobs: BENCH_E2E_OPS (200,000), BENCH_E2E_REPLICAS (100,000),
    BENCH_E2E_MEMBERS (1024), BENCH_E2E_OPF (48), BENCH_E2E_CHUNKS (8),
    BENCH_E2E_ITERS (3)."""
    import secrets

    metric, unit = "orset_e2e_streaming_ops_per_sec", "ops/s"
    N = int(os.environ.get("BENCH_E2E_OPS", 10_000 if smoke else 200_000))
    R = int(os.environ.get("BENCH_E2E_REPLICAS", 500 if smoke else 100_000))
    E = int(os.environ.get("BENCH_E2E_MEMBERS", 128 if smoke else 1024))
    OPF = int(os.environ.get("BENCH_E2E_OPF", 48))
    N_CHUNKS = int(os.environ.get("BENCH_E2E_CHUNKS", 8))
    ITERS = int(os.environ.get("BENCH_E2E_ITERS", 3))
    device = acquire_device(argv, metric, unit)
    producer_list = producers_arg(argv)

    from .backends.xchacha import decrypt_blob, decrypt_blobs_packed
    from .benchmarks.suite import _build_encrypted_files
    from .core.adapters import HostAccelerator, orset_adapter
    from .models import ORSet
    from .obs import attribution
    from .parallel.accel import TorchAccelerator
    from .utils import codec, trace

    warm_kernels(device)
    key = secrets.token_bytes(32)
    payloads, plain, _headers, actors = _build_encrypted_files(
        N, R, E, OPF, key, n_headers=0)
    total_ops = sum(len(codec.unpack(p)) for p in plain)
    accel = TorchAccelerator(device=device)
    actors_sorted = sorted(actors)
    log(f"e2e_streaming: device {device}; {len(payloads)} files, "
        f"{total_ops} ops, R={R} E={E}")
    reset_launches()

    def sequential():
        state = ORSet()
        session = accel.open_fold_session(state, actors_hint=actors_sorted)
        packed = decrypt_blobs_packed(key, payloads)
        session.reduce_chunk(session.decode_chunk(packed))
        session.finish()
        return state

    def overlapped(n_producers: int):
        state = ORSet()
        ok = accel.fold_encrypted_stream(
            state, key, payloads, actors_hint=actors_sorted,
            n_chunks=N_CHUNKS, n_producers=n_producers)
        assert ok, "the accelerator declined the streaming fold"
        return state

    def host_loop():
        op_from_obj = orset_adapter().op_from_obj
        ops = [op_from_obj(o) for blob in payloads
               for o in codec.unpack(decrypt_blob(key, blob))]
        return HostAccelerator().fold_ops(ORSet(), ops)

    host_bytes = codec.pack(host_loop().to_obj())
    # warm-up and the sequential front end's gate
    sequential_equal = codec.pack(sequential().to_obj()) == host_bytes
    log(f"e2e: sequential equal to the host loop: {sequential_equal}")
    seq_samples = [timed_host(sequential) for _ in range(ITERS)]
    t_seq = min(seq_samples)
    sweep, raw_times, raw_samples = {}, {}, {}
    full_batch_equal = sequential_equal
    for n_prod in producer_list:
        equal = codec.pack(overlapped(n_prod).to_obj()) == host_bytes
        full_batch_equal = full_batch_equal and equal
        t_best, obs_snapshot, stage_marginals, samples = (
            float("inf"), {}, {}, [])
        for _ in range(ITERS):
            trace.reset()
            t = timed_host(lambda: overlapped(n_prod))
            samples.append(t)
            if t < t_best:
                t_best = t
                obs_snapshot = trace.snapshot()
                stage_marginals = {
                    name: round(v["seconds"], 4)
                    for name, v in obs_snapshot["spans"].items()
                    if name.startswith(("stream.", "session."))}
        trace.reset()
        raw_times[str(n_prod)] = t_best
        raw_samples[str(n_prod)] = samples
        sweep[str(n_prod)] = {
            "e2e_s": round(t_best, 4),
            "ops_per_sec": round(total_ops / t_best, 1),
            "speedup_vs_sequential": round(t_seq / t_best, 2),
            "full_batch_equal": bool(equal),
            "stage_marginals_s": stage_marginals,
            "samples_s": [round(t, 4) for t in sorted(samples)],
            "obs": obs_snapshot,
        }
        log(f"e2e[N={n_prod}]: overlapped {t_best:.3f}s vs sequential "
            f"{t_seq:.3f}s, equal {equal}")
    best_n = min(raw_times, key=raw_times.get)
    t_ovl = raw_times[best_n]
    gap_report = attribution.attribute_cycle(
        sweep[best_n]["obs"], pipeline="streaming", wall_s=t_ovl,
        ops=total_ops)
    shape = {"N": N, "R": R, "E": E, "ops_per_file": OPF,
             "files": len(payloads), "n_chunks": N_CHUNKS,
             "total_ops": total_ops}
    result = {
        "metric": metric, "config": "mixed_streaming_100k_e2e",
        "value": round(total_ops / t_ovl, 1), "unit": unit,
        "e2e_overlapped_s": round(t_ovl, 4),
        "e2e_sequential_s": round(t_seq, 4),
        "overlap_speedup": sweep[best_n]["speedup_vs_sequential"],
        "producers_best": int(best_n),
        "producer_sweep": {n: {k: v for k, v in rec.items() if k != "obs"}
                           for n, rec in sweep.items()},
        "stage_marginals_s": sweep[best_n]["stage_marginals_s"],
        "gap_report": gap_report,
        "full_batch_equal": bool(full_batch_equal),
        "sequential_equal": bool(sequential_equal),
        "method": "host_wall_end_to_end",
        # the best width's overlapped passes and the sequential ones
        **spread_fields("overlapped", raw_samples[best_n]),
        **spread_fields("sequential", seq_samples),
        "shape": shape,
    }
    if "1" in raw_times and best_n != "1":
        result["producer_speedup_vs_1"] = round(raw_times["1"] / t_ovl, 2)
    return finish(argv, result, device, full_batch_equal,
                  "a streamed state diverged from the host loop",
                  producer_sweep_obs={n: r["obs"] for n, r in sweep.items()},
                  obs=sweep[best_n]["obs"])


# ------------------------------------------------------- --device-decode


def device_decode_exp(argv: list, smoke: bool) -> dict:
    """The device-decode experiment (``ops/device_decode.py``): decode the
    fixed-stride add-op framing (a) on the device, (b) with the same
    vectorized extraction in numpy on the host (the control arm) and (c)
    through the native decoder (the incumbent).  All three give the same
    columns; the record names the fastest.

    Env knobs: BENCH_DD_OPS (200,000), BENCH_DD_REPLICAS (100,000),
    BENCH_DD_OPF (48), BENCH_DD_ITERS (5)."""
    import secrets

    metric, unit = "orset_device_decode_ops_per_sec", "ops/s"
    N = int(os.environ.get("BENCH_DD_OPS", 10_000 if smoke else 200_000))
    R = int(os.environ.get("BENCH_DD_REPLICAS", 500 if smoke else 100_000))
    OPF = int(os.environ.get("BENCH_DD_OPF", 48))
    ITERS = int(os.environ.get("BENCH_DD_ITERS", 5))
    device = acquire_device(argv, metric, unit)

    from .ops.device_decode import decode_adds_device, decode_adds_host
    from .ops.native_decode import decode_orset_payload_batch
    from .utils import codec

    warm_kernels(device)
    rng = np.random.default_rng(7)
    actors = sorted(secrets.token_bytes(16) for _ in range(R))
    payloads = []
    for lo in range(0, N, OPF):
        ops = [[0, int(rng.integers(0, 128)),
                [actors[int(rng.integers(0, R))], int(rng.integers(1, 128))]]
               for _ in range(min(OPF, N - lo))]
        payloads.append(codec.pack(ops))
    offs = np.zeros(len(payloads) + 1, np.uint64)
    np.cumsum(np.array([len(p) for p in payloads], np.uint64), out=offs[1:])
    packed = (np.frombuffer(b"".join(payloads), np.uint8), offs)
    log(f"device_decode: device {device}; {len(payloads)} payloads, "
        f"{N} add ops, R={R}")
    reset_launches()

    def device_arm():
        out = decode_adds_device(packed, actors, device=device)
        force_completion(device)
        return out

    dd = device_arm()
    assert dd is not None, "an all-adds corpus must take the device path"
    equal = True
    dd_cols = [np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)
               for x in dd[:4]]
    for name, got in (("host_vectorized", decode_adds_host(packed, actors)),
                      ("native", decode_orset_payload_batch(list(payloads),
                                                            actors))):
        if got is None:
            equal = False
            continue
        cols = [np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)
                for x in got[:4]]
        same = all(np.array_equal(cols[i], dd_cols[i]) for i in (0, 2, 3))
        # member identity through the resolved objects (intern orders
        # differ between the arms)
        same = same and [got[4][int(i)] for i in cols[1][:64].tolist()] == \
            [dd[4][int(i)] for i in dd_cols[1][:64].tolist()]
        log(f"columns[{name}] equal to the device arm's: {same}")
        equal = equal and same

    def best(fn):
        ts = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            assert fn() is not None
            ts.append(time.perf_counter() - t0)
        return min(ts), ts

    t_dev, s_dev = best(device_arm)
    t_host, s_host = best(lambda: decode_adds_host(packed, actors))
    t_native, _ = best(lambda: decode_orset_payload_batch(list(payloads),
                                                          actors))
    arms = {"device": t_dev, "host_vectorized": t_host, "native": t_native}
    winner = min(arms, key=arms.get)
    result = {
        "metric": metric, "config": f"device_decode_adds_{N // 1000}k",
        "value": round(N / arms[winner], 1), "unit": unit,
        "winner": winner,
        "arms_s": {k: round(v, 5) for k, v in arms.items()},
        "device_vs_native_x": round(t_dev / t_native, 2),
        "columns_equal": bool(equal),
        "method": "host_wall_ending_in_synchronize",
        **spread_fields("device_arm", s_dev),
        **spread_fields("host_vectorized", s_host),
        "shape": {"N": N, "R": R, "ops_per_file": OPF,
                  "files": len(payloads)},
    }
    return finish(argv, result, device, equal,
                  "the decode arms gave different columns")


# ---------------------------------------------------- --e2e-multitenant


def e2e_multitenant(argv: list, smoke: bool) -> dict:
    """The multi-tenant fold service (``serve.FoldService``) against the
    sequential per-tenant solo ``Core.compact()`` loop.  T tenants, each
    its own encrypted in-memory remote of config-3-shaped op files; one
    copy is compacted tenant by tenant, another through ONE service
    cycle.  Every tenant's bytes must match (else exit 1).  A second
    cycle over a ~10% tail measures the warm tier.  ``--mesh dp=N[,mp=M]``
    adds the sharded arm: the same fleet through a mesh-backed service
    over shards of the card (of the CPU under ``--device cpu``), recorded
    under its own metric and config.

    Env knobs: BENCH_MT_TENANTS (256; ``--tenants N`` overrides),
    BENCH_MT_OPS (384), BENCH_MT_REPLICAS (4), BENCH_MT_MEMBERS (64),
    BENCH_MT_OPF (24), BENCH_MT_TAIL_PCT (10), BENCH_MT_ITERS (3)."""
    metric, unit = "orset_multitenant_agg_ops_per_sec", "ops/s"
    T = flag_int(argv, "--tenants", int(os.environ.get(
        "BENCH_MT_TENANTS", 16 if smoke else 256)))
    N = int(os.environ.get("BENCH_MT_OPS", 96 if smoke else 384))
    R = int(os.environ.get("BENCH_MT_REPLICAS", 4))
    E = int(os.environ.get("BENCH_MT_MEMBERS", 64))
    OPF = int(os.environ.get("BENCH_MT_OPF", 24))
    TAIL_PCT = float(os.environ.get("BENCH_MT_TAIL_PCT", 10.0))
    ITERS = max(1, int(os.environ.get("BENCH_MT_ITERS", 1 if smoke else 3)))
    mesh_shape = mesh_arg(argv)
    device = acquire_device(argv, metric, unit)

    import torch

    from .backends import MemoryRemote, MemoryStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .obs import attribution
    from .serve import FoldService
    from .utils import trace

    warm_kernels(device)
    mesh = None
    if mesh_shape is not None:
        from .parallel.mesh import make_mesh

        dp_m, mp_m = mesh_shape
        shard = torch.device("cuda:0") if device.type == "cuda" else device
        mesh = make_mesh(mesh_shape, devices=[shard] * (dp_m * mp_m))

    def opts(storage):
        return orset_options(storage, device)

    async def build():
        remotes, tails, total_ops = [], [], 0
        for t in range(T):
            files = tenant_files(N, R, E, OPF, seed=100 + t)
            n_tail = max(1, int(len(files) * TAIL_PCT / 100.0))
            head, tail = files[:-n_tail], files[-n_tail:]
            remote = MemoryRemote()
            writer = await Core.open(opts(MemoryStorage(remote)))
            for ab, v, ops in head:
                await writer.storage.store_ops(ab, v, await writer._seal(ops))
            total_ops += sum(len(ops) for _, _, ops in head)
            remotes.append(remote)
            tails.append([(ab, v, await writer._seal(ops), len(ops))
                          for ab, v, ops in tail])
        return remotes, tails, total_ops

    remotes, tails, total_ops = asyncio.run(build())
    log(f"e2e_multitenant: device {device}; {T} tenants, {total_ops} head "
        f"ops, R={R}/tenant E={E}/tenant")

    async def fleet():
        return [await Core.open(opts(MemoryStorage(copy.deepcopy(r))))
                for r in remotes]

    def count_paths(results) -> dict:
        paths: dict = {}
        for r in results:
            paths[r.path] = paths.get(r.path, 0) + 1
        return paths

    async def measure():
        # warm-up on throwaway copies: the kernels and the native
        # libraries load here, so the measured passes build nothing
        await FoldService(await fleet()).run_cycle()
        for r in remotes[:min(8, T)]:
            await (await Core.open(opts(MemoryStorage(copy.deepcopy(r))))
                   ).compact()
        if mesh is not None:
            await FoldService(await fleet(), mesh=mesh).run_cycle()
        reset_launches()
        out = {"t_seq": float("inf"), "t_serve": float("inf"),
               "t_shard": float("inf"), "equal": True, "seq_samples": [],
               "serve_samples": [], "shard_samples": []}
        for _ in range(ITERS):
            solo_cores, served_cores = await fleet(), await fleet()
            trace.reset()
            lat = []
            t0 = time.perf_counter()
            for c in solo_cores:
                await c.compact()
                lat.append(time.perf_counter() - t0)
            t = time.perf_counter() - t0
            out["seq_samples"].append(t)
            if t < out["t_seq"]:
                out.update(t_seq=t, seq_lat=lat, obs_seq=trace.snapshot())
            svc = FoldService(served_cores)
            trace.reset()
            t0 = time.perf_counter()
            results = await svc.run_cycle()
            t = time.perf_counter() - t0
            out["serve_samples"].append(t)
            errors = [(i, r.error) for i, r in enumerate(results) if r.error]
            assert not errors, f"service tenant errors: {errors[:3]}"
            out["equal"] = out["equal"] and all(
                a.with_state(canonical_bytes) == b.with_state(canonical_bytes)
                for a, b in zip(solo_cores, served_cores))
            if t < out["t_serve"]:
                out.update(t_serve=t, serve_lat=[r.latency_s for r in results],
                           obs_serve=trace.snapshot(),
                           paths=count_paths(results), service=svc,
                           warm_fleet=served_cores)
            if mesh is not None:
                shard_cores = await fleet()
                svc_m = FoldService(shard_cores, mesh=mesh)
                trace.reset()
                t0 = time.perf_counter()
                results_m = await svc_m.run_cycle()
                t = time.perf_counter() - t0
                out["shard_samples"].append(t)
                errors = [(i, r.error) for i, r in enumerate(results_m)
                          if r.error]
                assert not errors, f"sharded tenant errors: {errors[:3]}"
                out["equal"] = out["equal"] and all(
                    a.with_state(canonical_bytes)
                    == b.with_state(canonical_bytes)
                    for a, b in zip(solo_cores, shard_cores))
                if t < out["t_shard"]:
                    out.update(t_shard=t,
                               shard_lat=[r.latency_s for r in results_m],
                               obs_shard=trace.snapshot(),
                               shard_paths=count_paths(results_m))
        # the warm cycle: the tails land on the best pass's fleet
        n_tail_ops = 0
        for core, tail in zip(out["warm_fleet"], tails):
            for ab, v, blob, n_ops in tail:
                await core.storage.store_ops(ab, v, blob)
                n_tail_ops += n_ops
        trace.reset()
        t0 = time.perf_counter()
        results2 = await out["service"].run_cycle()
        out["t_warm"] = time.perf_counter() - t0
        out["warm_hits"] = trace.snapshot()["counters"].get(
            "serve_warm_hits", 0)
        out["n_tail_ops"] = n_tail_ops
        assert all(r.error is None for r in results2)
        return out

    m = asyncio.run(measure())
    gap_report = attribution.attribute_cycle(
        m["obs_serve"], pipeline="serve", wall_s=m["t_serve"], ops=total_ops)

    def builds(snap) -> int:
        counters = (snap or {}).get("counters", {})
        return int(counters.get("cuda_builds", 0)
                   + counters.get("native_builds", 0))

    result = {
        "metric": metric, "config": f"multitenant_{T}t",
        "value": round(total_ops / m["t_serve"], 1), "unit": unit,
        "vs_baseline": round(m["t_seq"] / m["t_serve"], 2),
        "sequential_agg_ops_per_sec": round(total_ops / m["t_seq"], 1),
        "service_cycle_s": round(m["t_serve"], 4),
        "sequential_s": round(m["t_seq"], 4),
        "tenant_latency": quantiles_ms(m["serve_lat"]),
        "sequential_tenant_latency": quantiles_ms(m["seq_lat"]),
        "fold_paths": m["paths"],
        "gap_report": gap_report,
        "warm_cycle": {
            "tail_ops": m["n_tail_ops"],
            "cycle_s": round(m["t_warm"], 4),
            "ops_per_sec": round(m["n_tail_ops"] / m["t_warm"], 1),
            "warm_hits": m["warm_hits"],
        },
        "byte_identical": bool(m["equal"]),
        "method": "host_wall_end_to_end",
        # the service's passes beside the solo loop's, both host walls
        **spread_fields("serve", m["serve_samples"]),
        **spread_fields("sequential", m["seq_samples"]),
        # steady-state library builds in the measured passes: zero is the
        # contract (the port's twin of the JAX bench's compile counts)
        "build_counts": {
            "sequential": builds(m.get("obs_seq")),
            "service": builds(m.get("obs_serve")),
            **({"sharded": builds(m.get("obs_shard"))} if mesh else {}),
        },
        "shape": {"tenants": T, "ops_per_tenant": N, "replicas": R,
                  "members": E, "ops_per_file": OPF,
                  "total_ops": total_ops, "iters": ITERS},
    }
    if mesh is not None:
        result.update({
            "metric": "orset_multitenant_sharded_agg_ops_per_sec",
            "config": f"multitenant_{T}t_mesh{dp_m}x{mp_m}",
            "value": round(total_ops / m["t_shard"], 1),
            "single_chip_agg_ops_per_sec": round(total_ops / m["t_serve"], 1),
            "sharded": {
                "mesh": {"dp": dp_m, "mp": mp_m},
                "cycle_s": round(m["t_shard"], 4),
                "agg_ops_per_sec": round(total_ops / m["t_shard"], 1),
                "vs_single_chip": round(m["t_serve"] / m["t_shard"], 2),
                "tenant_latency": quantiles_ms(m["shard_lat"]),
                "fold_paths": m["shard_paths"],
            },
        })
    return finish(argv, result, device, m["equal"],
                  "per-tenant states diverged",
                  obs=m["obs_serve"], obs_sequential=m["obs_seq"],
                  **({"obs_sharded": m["obs_shard"]} if mesh else {}))


# ----------------------------------------------------------- daemon fleet


def daemon_fleet_shape(smoke: bool, argv: list = ()):
    """The --e2e-daemon workload shape (env knobs BENCH_DMN_*)."""
    T = flag_int(list(argv), "--tenants", int(os.environ.get(
        "BENCH_DMN_TENANTS", 16 if smoke else 256)))
    N = int(os.environ.get("BENCH_DMN_OPS", 96 if smoke else 256))
    R = int(os.environ.get("BENCH_DMN_REPLICAS", 4))
    E = int(os.environ.get("BENCH_DMN_MEMBERS", 64))
    OPF = int(os.environ.get("BENCH_DMN_OPF", 24))
    CYCLES = int(os.environ.get("BENCH_DMN_CYCLES", 4 if smoke else 6))
    return T, N, R, E, OPF, CYCLES


async def daemon_build_remotes(opts_fn, n_tenants, N, R, E, OPF, seed0):
    """``n_tenants`` encrypted remotes and their head op counts; the ~10%
    burst tails come back sealed, to land in a live tenant mid-run."""
    from .backends import MemoryRemote, MemoryStorage
    from .core.core import Core

    remotes, bursts, head_ops = [], [], []
    for t in range(n_tenants):
        files = tenant_files(N, R, E, OPF, seed=seed0 + t)
        n_tail = max(1, math.ceil(len(files) * 0.1))
        head, tail = files[:-n_tail], files[-n_tail:]
        remote = MemoryRemote()
        writer = await Core.open(opts_fn(MemoryStorage(remote)))
        for ab, v, ops in head:
            await writer.storage.store_ops(ab, v, await writer._seal(ops))
        head_ops.append(sum(len(ops) for _, _, ops in head))
        bursts.append([(ab, v, await writer._seal(ops), len(ops))
                       for ab, v, ops in tail])
        remotes.append(remote)
    return remotes, bursts, head_ops


def e2e_daemon_host(runs: int = 0) -> dict:
    """The daemon family's host baseline (``pin_baselines`` config 6):
    sequential solo ``Core.compact()`` on ``HostAccelerator`` over the
    default daemon fleet's head shape, median-of-N on fresh copies."""
    from .backends import MemoryStorage
    from .core.core import Core
    from .core.adapters import HostAccelerator

    T, N, R, E, OPF, _ = daemon_fleet_shape(smoke=False)

    def opts(storage):
        return orset_options(storage, None, accelerator=HostAccelerator())

    remotes, _bursts, head_ops = asyncio.run(
        daemon_build_remotes(opts, T, N, R, E, OPF, 500))
    total_ops = sum(head_ops)

    def run_once():
        async def one():
            cores = [await Core.open(opts(MemoryStorage(copy.deepcopy(r))))
                     for r in remotes]
            t0 = time.perf_counter()
            for c in cores:
                await c.compact()
            return time.perf_counter() - t0

        return asyncio.run(one()), None

    median_s, times, _ = host_median(run_once, runs)
    return {"config": f"daemon_{T}t", "host_rate": total_ops / median_s,
            "n_ops": total_ops,
            "shape": {"tenants": T, "ops_per_tenant": N, "replicas": R,
                      "members": E, "ops_per_file": OPF},
            "median_s": median_s, **host_stats(times)}


def e2e_daemon(argv: list, smoke: bool) -> dict:
    """The ``FleetDaemon`` under churn: T encrypted tenants, CYCLES
    supervised cycles; T/8 join mid-run, T/4 take a ~10% burst, T/8 are
    evicted with a final checkpoint.  The record is aggregate ops/s, the
    p99 freshness lag and seal latency.  After the drain every tenant's
    remote is refolded by a fresh solo ``Core.compact()`` on a copy; any
    divergence refuses the record.

    Env knobs: BENCH_DMN_TENANTS (256; ``--tenants N`` overrides),
    BENCH_DMN_OPS (256), BENCH_DMN_REPLICAS (4), BENCH_DMN_MEMBERS (64),
    BENCH_DMN_OPF (24), BENCH_DMN_CYCLES (6)."""
    metric, unit = "daemon_e2e_agg_ops_per_sec", "ops/s"
    T, N, R, E, OPF, CYCLES = daemon_fleet_shape(smoke, argv)
    JOIN, BURST = max(1, T // 8), max(1, T // 4)
    LEAVE = 0 if T == 1 else max(1, T // 8)
    device = acquire_device(argv, metric, unit)

    from .backends import MemoryStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .serve import DaemonConfig, FleetDaemon, ServeConfig
    from .utils import trace

    warm_kernels(device)

    def opts(storage):
        return orset_options(storage, device)

    async def scenario():
        remotes, bursts, head_ops = await daemon_build_remotes(
            opts, T + JOIN, N, R, E, OPF, 500)
        log(f"e2e_daemon: device {device}; {T} tenants (+{JOIN} join, "
            f"-{LEAVE} evict, {BURST} burst), {sum(head_ops[:T])} head ops")
        cores = [await Core.open(opts(MemoryStorage(r))) for r in remotes[:T]]
        cfg = DaemonConfig(
            interval_s=0.0, batch=T + JOIN, max_idle_cycles=CYCLES + 10,
            # admission sized to the fleet the scenario admits: the
            # default gate at 1 MiB a tenant refuses joiners past 256
            admission_bytes=(T + JOIN + 1) << 20,
            serve=ServeConfig(seal_empty=False))
        daemon = FleetDaemon(cores, cfg, seed=7)
        warm = [await Core.open(opts(MemoryStorage(copy.deepcopy(r))))
                for r in remotes[:min(8, T)]]
        await daemon.service.run_cycle(warm)
        del warm
        reset_launches()
        total_ops = sum(head_ops[:T])
        seal_lat, fresh_lag, cycle_walls = [], [], []
        churn = {"joined": 0, "evicted": 0, "burst_tenants": 0,
                 "burst_ops": 0}
        trace.reset()
        t0 = time.perf_counter()
        for c in range(CYCLES):
            if c == 1:
                for j in range(JOIN):
                    core = await Core.open(opts(MemoryStorage(remotes[T + j])))
                    await daemon.admit(core)
                    cores.append(core)
                    total_ops += head_ops[T + j]
                    churn["joined"] += 1
            if c == 2:
                for t in range(BURST):
                    idx = (LEAVE + t) % T
                    for ab, v, blob, n_ops in bursts[idx]:
                        await cores[idx].storage.store_ops(ab, v, blob)
                        total_ops += n_ops
                        churn["burst_ops"] += n_ops
                    churn["burst_tenants"] += 1
            if c == 3:
                for t in range(LEAVE):
                    await daemon.evict(f"t{t}")
                    churn["evicted"] += 1
            tc = time.perf_counter()
            report = await daemon.run_cycle()
            cycle_walls.append(time.perf_counter() - tc)
            for res in report["results"].values():
                if res.get("latency_s") is not None:
                    seal_lat.append(res["latency_s"])
            for tid in daemon.tenant_ids:
                status = daemon.entry(tid).status()
                if status is not None:
                    fresh_lag.append(
                        float(status["divergence"]["watermark_lag"]))
        wall = time.perf_counter() - t0
        obs = trace.snapshot()
        await daemon.drain()
        launches = read_launches()
        diverged = []
        for i, core in enumerate(cores):
            solo = await Core.open(opts(MemoryStorage(
                copy.deepcopy(remotes[i]))))
            await solo.compact()
            if solo.with_state(canonical_bytes) != core.with_state(
                    canonical_bytes):
                diverged.append(i)
        return (wall, total_ops, seal_lat, fresh_lag, churn, obs, diverged,
                daemon.health(), cycle_walls, launches)

    (wall, total_ops, seal_lat, fresh_lag, churn, obs, diverged, health,
     cycle_walls, launches) = asyncio.run(scenario())
    q = nearest_rank
    pin_shape = {"tenants": T, "ops_per_tenant": N, "replicas": R,
                 "members": E, "ops_per_file": OPF}
    result = {
        "metric": metric, "config": f"daemon_{T}t",
        "value": round(total_ops / wall, 1), "unit": unit,
        "cycles": CYCLES, "wall_s": round(wall, 4), "total_ops": total_ops,
        "cycle_walls_s": [round(t, 4) for t in cycle_walls],
        "seal_latency": quantiles_ms(seal_lat) if seal_lat else {},
        "freshness_lag_versions": {
            "p50": q(fresh_lag, 0.50), "p99": q(fresh_lag, 0.99),
            "max": max(fresh_lag)} if fresh_lag else {},
        "churn": churn,
        "daemon": {k: health[k] for k in
                   ("cycles", "tenants", "quarantined", "degraded")},
        "byte_identical": not diverged,
        "method": "host_wall_end_to_end",
        "shape": {**pin_shape, "cycles": CYCLES, "join": JOIN,
                  "leave": LEAVE, "burst": BURST},
    }
    pin = load_pinned(f"daemon_{T}t", pin_shape)
    if pin:
        result["vs_pinned_baseline"] = round(
            result["value"] / pin["host_rate"], 2)
        result["pinned_host_rate"] = pin["host_rate"]
        result["vs_baseline"] = result["vs_pinned_baseline"]
    # the cycles' launches, not the solo guard's
    return finish(argv, result, device, not diverged,
                  f"tenants {diverged[:5]} diverged from solo compact()",
                  launches=launches, obs=obs)


# ------------------------------------------------------- --e2e-idle-cycle


def e2e_idle_cycle(argv: list, smoke: bool) -> dict:
    """The O(tail) steady state: a T-tenant fleet (the daemon shape,
    BENCH_DMN_* knobs) folded once, then served at active fractions 100%,
    10% and 1% (one new op file per active tenant a cycle) under two
    arms: ``continuation`` (the default ``ServeConfig``: warm planes,
    quiet tenants no-op, deltas cut on the device) and ``full_refold``
    (``ServeConfig(warm=False, noop_skip=False)``: every cycle re-seals
    every tenant from its state).  The value is the 1%-active cycle-wall
    ratio full_refold / continuation.  Each row carries ``cuda_builds``
    (the JAX bench's ``jax_compiles``), ``h2d_bytes``,
    ``serve_noop_cycles``, ``delta_device_cuts`` and ``delta_base_bytes``
    over its measured window.  Every tenant of both arms must byte-match a
    fresh solo ``Core.compact()`` (else exit 1).

    Env knobs: the BENCH_DMN_* shape, BENCH_IDLE_CYCLES (3)."""
    metric, unit = "idle_cycle_speedup", "x_at_1pct_active"
    T, N, R, E, OPF, _ = daemon_fleet_shape(smoke, argv)
    FRACTIONS = (1.0, 0.1, 0.01)
    CYC = int(os.environ.get("BENCH_IDLE_CYCLES", 2 if smoke else 3))
    device = acquire_device(argv, metric, unit)

    from .backends import MemoryRemote, MemoryStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .serve import FoldService, ServeConfig
    from .utils import trace

    warm_kernels(device)

    def opts(storage):
        return orset_options(storage, device, delta=True)

    need_drip = len(FRACTIONS) * (CYC + 1)

    async def build():
        drip_ab = actor_bytes_table(R + 1)[R]
        remotes, drips = [], []
        for t in range(T):
            files = tenant_files(N, R, E, OPF, seed=900 + t)
            n_tail, got = 0, 0
            while got < need_drip and n_tail < len(files) - 1:
                n_tail += 1
                got += len(files[-n_tail][2])
            n_tail = max(n_tail, min(len(files) - 1, len(files) // 3))
            head, tail = files[:-n_tail], files[-n_tail:]
            tail_ops = [op for _ab, _v, ops in tail for op in ops]
            if len(tail_ops) < need_drip or not head:
                raise SystemExit(
                    f"shape too small: tenant {t} has {len(tail_ops)} tail "
                    f"ops for a {need_drip}-file drip schedule")
            step = len(tail_ops) / need_drip
            cuts = [round(i * step) for i in range(need_drip + 1)]
            remote = MemoryRemote()
            writer = await Core.open(opts(MemoryStorage(remote)))
            for ab, v, ops in head:
                await writer.storage.store_ops(ab, v, await writer._seal(ops))
            drips.append([
                (drip_ab, i + 1,
                 await writer._seal(tail_ops[cuts[i]:cuts[i + 1]]))
                for i in range(need_drip)])
            remotes.append(remote)
        return remotes, drips

    remotes, drips = asyncio.run(build())
    log(f"e2e_idle_cycle: device {device}; {T} tenants, {CYC} "
        f"cycles/fraction, fractions {FRACTIONS}")

    async def run_arm(arm: str):
        cfg = (ServeConfig() if arm == "continuation"
               else ServeConfig(warm=False, noop_skip=False))
        arm_remotes = [copy.deepcopy(r) for r in remotes]
        cores = [await Core.open(opts(MemoryStorage(r))) for r in arm_remotes]
        service = FoldService(cores, cfg)
        await service.run_cycle()
        await service.run_cycle()
        drip_pos = [0] * T
        rows, obs_1pct = [], None
        launches = Counter()
        for frac in FRACTIONS:
            n_active = max(1, round(T * frac))

            async def drip_actives():
                for t in range(n_active):
                    ab, v, blob = drips[t][drip_pos[t]]
                    drip_pos[t] += 1
                    await cores[t].storage.store_ops(ab, v, blob)

            await drip_actives()
            await service.run_cycle()
            trace.reset()
            reset_launches()
            walls = []
            for _c in range(CYC):
                await drip_actives()
                t0 = time.perf_counter()
                await service.run_cycle()
                walls.append(time.perf_counter() - t0)
            snap = trace.snapshot()
            counters, gauges = snap["counters"], snap["gauges"]
            tq = time.perf_counter()
            await service.run_cycle()
            quiet_wall = time.perf_counter() - tq
            launches.update(read_launches())
            rows.append({
                "active_fraction": frac, "active_tenants": n_active,
                "wall_per_cycle_s": round(sorted(walls)[len(walls) // 2], 5),
                "wall_samples_s": [round(w, 5) for w in walls],
                "quiet_cycle_s": round(quiet_wall, 5),
                "per_quiet_tenant_us": round(quiet_wall / T * 1e6, 2),
                "cuda_builds": counters.get("cuda_builds", 0),
                "h2d_bytes": counters.get("h2d_bytes", 0),
                "serve_noop_cycles": counters.get("serve_noop_cycles", 0),
                "delta_device_cuts": counters.get("delta_device_cuts", 0),
                "delta_base_bytes": gauges.get("delta_base_bytes"),
            })
            if frac == 0.01 and arm == "continuation":
                obs_1pct = snap
        for t in range(T):
            while drip_pos[t] < need_drip:
                ab, v, blob = drips[t][drip_pos[t]]
                drip_pos[t] += 1
                await cores[t].storage.store_ops(ab, v, blob)
        await service.run_cycle()
        diverged = []
        for i, core in enumerate(cores):
            solo = await Core.open(opts(MemoryStorage(
                copy.deepcopy(arm_remotes[i]))))
            await solo.compact()
            if solo.with_state(canonical_bytes) != core.with_state(
                    canonical_bytes):
                diverged.append(i)
        service.close()
        return rows, diverged, obs_1pct, dict(launches)

    async def scenario():
        cont, div_c, obs_1pct, l_c = await run_arm("continuation")
        full, div_f, _, l_f = await run_arm("full_refold")
        return cont, full, div_c + div_f, obs_1pct, Counter(l_c) + Counter(l_f)

    cont, full, diverged, obs_1pct, launches = asyncio.run(scenario())
    by_frac = {r["active_fraction"]: r for r in full}
    result = {
        "metric": metric, "config": f"idle_{T}t",
        "value": round(by_frac[0.01]["wall_per_cycle_s"]
                       / max(cont[-1]["wall_per_cycle_s"], 1e-9), 2),
        "unit": unit, "continuation": cont, "full_refold": full,
        "byte_identical": not diverged,
        "method": "host_wall_end_to_end",
        "shape": {"tenants": T, "ops_per_tenant": N, "replicas": R,
                  "members": E, "ops_per_file": OPF, "cycles": CYC},
    }
    # the measured windows' launches, not the solo guard's
    return finish(argv, result, device, not diverged,
                  f"tenants {sorted(set(diverged))[:5]} diverged from solo "
                  "compact()",
                  launches={k: launches.get(k, 0) for k in read_launches()},
                  obs=obs_1pct)


# ------------------------------------------------------- --e2e-warm-open


def e2e_warm_open(argv: list, smoke: bool) -> dict:
    """Cold open against the checkpointed (warm) open of a config-5-shaped
    remote with a 1% op tail.  A real ``FsStorage`` remote takes N sealed
    op files; replica A reads it all and seals its checkpoint; a 1% tail
    lands; then a fresh replica refolds everything (cold) and A reopens
    from its checkpoint and folds only the tail (warm).  The two states
    must be byte-equal and A must open warm (else exit 1).  A two-round
    compaction sample checks the device plane cache: round 2 uploads no
    full-state planes.

    Env knobs: BENCH_WARM_OPS (1,000,000), BENCH_WARM_REPLICAS (10,000),
    BENCH_WARM_MEMBERS (1024), BENCH_WARM_OPF (48), BENCH_WARM_TAIL_PCT
    (1.0)."""
    metric, unit = "orset_e2e_warm_open_speedup", "x"
    N = int(os.environ.get("BENCH_WARM_OPS", 20_000 if smoke else 1_000_000))
    R = int(os.environ.get("BENCH_WARM_REPLICAS", 200 if smoke else 10_000))
    E = int(os.environ.get("BENCH_WARM_MEMBERS", 128 if smoke else 1024))
    OPF = int(os.environ.get("BENCH_WARM_OPF", 48))
    TAIL_PCT = float(os.environ.get("BENCH_WARM_TAIL_PCT", 1.0))
    device = acquire_device(argv, metric, unit)

    from .backends import FsStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .utils import trace

    warm_kernels(device)
    kind, member, actor, counter = gen_columns(N, R, E, seed=11)
    actors = actor_bytes_table(R)
    files = files_from_columns(kind, member, actor, counter, actors, OPF)
    total_ops = sum(len(ops) for _, _, ops in files)
    last_file_idx = {}
    for idx, (ab, _v, _) in enumerate(files):
        last_file_idx[ab] = idx
    target_ops = max(1, int(total_ops * TAIL_PCT / 100.0))
    tail_idx: set = set()
    n_tail_ops = 0
    for ab in actors:
        idx = last_file_idx.get(ab)
        if idx is None:
            continue
        tail_idx.add(idx)
        n_tail_ops += len(files[idx][2])
        if n_tail_ops >= target_ops:
            break
    prefix = [f for i, f in enumerate(files) if i not in tail_idx]
    tail = [f for i, f in enumerate(files) if i in tail_idx]
    tmp = tempfile.mkdtemp(prefix="crdt-warm-open-")
    remote = os.path.join(tmp, "remote")
    log(f"e2e_warm_open: device {device}; {len(files)} files ({len(tail)} "
        f"tail), {total_ops} ops ({n_tail_ops} tail), R={R} E={E}")

    def opts(storage, create):
        return orset_options(storage, device, create=create)

    async def build_and_measure():
        core_a = await Core.open(opts(FsStorage(os.path.join(tmp, "localA"),
                                                remote), create=True))

        async def store_files(batch):
            sem = asyncio.Semaphore(64)

            async def one(ab, v, ops):
                async with sem:
                    blob = await core_a._seal(ops)
                    await core_a.storage.store_ops(ab, v, blob)

            await asyncio.gather(*(one(*f) for f in batch))

        t0 = time.perf_counter()
        for i in range(0, len(prefix), 2048):
            await store_files(prefix[i:i + 2048])
        t_build = time.perf_counter() - t0
        reset_launches()
        t0 = time.perf_counter()
        await core_a.read_remote()
        t_first = time.perf_counter() - t0
        trace.reset()
        await core_a.save_checkpoint()
        ck_bytes = trace.snapshot()["counters"].get("checkpoint_bytes", 0)
        await store_files(tail)
        trace.reset()
        t0 = time.perf_counter()
        core_cold = await Core.open(opts(
            FsStorage(os.path.join(tmp, "localB"), remote), create=True))
        await core_cold.read_remote()
        t_cold = time.perf_counter() - t0
        obs_cold = trace.snapshot()
        trace.reset()
        t0 = time.perf_counter()
        core_warm = await Core.open(opts(
            FsStorage(os.path.join(tmp, "localA"), remote), create=False))
        warm_hit = core_warm.opened_from_checkpoint
        await core_warm.read_remote()
        t_warm = time.perf_counter() - t0
        obs_warm = trace.snapshot()
        equal = core_cold.with_state(canonical_bytes) == \
            core_warm.with_state(canonical_bytes)
        return (t_build, t_first, t_cold, t_warm, warm_hit, equal, obs_cold,
                obs_warm, core_warm.checkpoint_fallback_reason, ck_bytes)

    try:
        (t_build, t_first, t_cold, t_warm, warm_hit, equal, obs_cold,
         obs_warm, fallback, ck_bytes) = asyncio.run(build_and_measure())
        plane_proof = asyncio.run(plane_reuse_rounds(device))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = {
        "metric": metric,
        "config": f"warm_open_{N}ops_{R}r_{TAIL_PCT:g}pct_tail",
        "value": round(t_cold / t_warm, 2), "unit": unit,
        "cold_open_s": round(t_cold, 4), "warm_open_s": round(t_warm, 4),
        "first_fold_s": round(t_first, 4), "build_s": round(t_build, 1),
        "opened_from_checkpoint": bool(warm_hit),
        "checkpoint_fallback_reason": fallback,
        "byte_identical": bool(equal), "checkpoint_bytes": ck_bytes,
        "plane_reuse": {k: v for k, v in plane_proof.items() if k != "obs"},
        "method": "host_wall_end_to_end",
        "shape": {"N": N, "R": R, "E": E, "ops_per_file": OPF,
                  "files": len(files), "tail_files": len(tail),
                  "tail_ops": n_tail_ops, "total_ops": total_ops},
    }
    return finish(argv, result, device, bool(warm_hit and equal),
                  f"warm_hit={warm_hit} (fallback: {fallback}) "
                  f"byte_identical={equal}",
                  obs_cold=obs_cold, obs_warm=obs_warm,
                  obs_plane_reuse=plane_proof.get("obs"))


async def plane_reuse_rounds(device) -> dict:
    """Two compaction rounds in one process on a small dense workload:
    round 1 uploads the full state planes (``h2d_bytes``), round 2 hits
    the accelerator's device plane cache and uploads only its rows."""
    from .backends import IdentityCryptor, MemoryRemote, MemoryStorage
    from .core.core import Core
    from .parallel.accel import TorchAccelerator
    from .utils import trace

    remote = MemoryRemote()
    reader = await Core.open(orset_options(
        MemoryStorage(remote), device, cryptor=IdentityCryptor(),
        accelerator=TorchAccelerator(device=device, min_device_batch=1)))
    writer = await Core.open(orset_options(
        MemoryStorage(remote), device, cryptor=IdentityCryptor()))

    async def write(n, tag):
        for i in range(n):
            await writer.apply_ops([writer.with_state(
                lambda s: s.add_ctx(writer.actor_id, b"%s-%d" % (tag, i)))])

    rounds = {}
    for rd in (1, 2):
        await write(60, b"r%d" % rd)
        trace.reset()
        await reader.compact()
        snap = trace.snapshot()
        rounds[rd] = {"h2d_bytes": snap["counters"].get("h2d_bytes", 0),
                      "obs": snap}
    return {
        "round1_h2d_bytes": rounds[1]["h2d_bytes"],
        "round2_h2d_bytes": rounds[2]["h2d_bytes"],
        "round2_full_state_reupload": rounds[2]["h2d_bytes"]
        >= rounds[1]["h2d_bytes"] > 0,
        "obs": rounds[2]["obs"],
    }


# ----------------------------------------------------------- --e2e-delta


class CountingStorage:
    """A storage wrapper that counts every remote payload byte the core
    reads (states, op files, deltas); everything else forwards."""

    def __init__(self, inner):
        self._inner = inner
        self.bytes_read = 0
        self.files_read = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def _count(self, loaded):
        for item in loaded:
            self.bytes_read += len(item[-1])
            self.files_read += 1
        return loaded

    async def load_states(self, names):
        return self._count(await self._inner.load_states(names))

    async def load_ops(self, wanted):
        return self._count(await self._inner.load_ops(wanted))

    async def load_deltas(self, wanted):
        return self._count(await self._inner.load_deltas(wanted))

    async def iter_op_chunks(self, wanted, max_bytes=None):
        kw = {} if max_bytes is None else {"max_bytes": max_bytes}
        async for chunk in self._inner.iter_op_chunks(wanted, **kw):
            yield self._count(chunk)


def e2e_delta(argv: list, smoke: bool) -> dict:
    """Remote bytes read by an incremental consumer, the delta-chain path
    against the full-snapshot path, on one ``FsStorage`` remote.  A
    producer builds and compacts it (a snapshot and a delta a round); two
    consumers track it, A with delta replication on, B with it off.  Each
    round lands a ~1% op tail before the producer compacts again.  The
    three states must be byte-equal and A must apply a chain every round
    (else exit 1).

    Env knobs: BENCH_DELTA_OPS (200,000), BENCH_DELTA_REPLICAS (2,000),
    BENCH_DELTA_MEMBERS (512), BENCH_DELTA_OPF (48), BENCH_DELTA_ROUNDS
    (5), BENCH_DELTA_TAIL_PCT (1.0)."""
    metric, unit = "orset_e2e_delta_bytes_reduction", "x"
    N = int(os.environ.get("BENCH_DELTA_OPS", 6_000 if smoke else 200_000))
    R = int(os.environ.get("BENCH_DELTA_REPLICAS", 60 if smoke else 2_000))
    E = int(os.environ.get("BENCH_DELTA_MEMBERS", 64 if smoke else 512))
    OPF = int(os.environ.get("BENCH_DELTA_OPF", 48))
    ROUNDS = int(os.environ.get("BENCH_DELTA_ROUNDS", 2 if smoke else 5))
    TAIL_PCT = float(os.environ.get("BENCH_DELTA_TAIL_PCT", 1.0))
    device = acquire_device(argv, metric, unit)

    from .backends import FsStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .utils import trace

    warm_kernels(device)
    kind, member, actor, counter = gen_columns(N, R, E, seed=23)
    actors = actor_bytes_table(R)
    prefix = files_from_columns(kind, member, actor, counter, actors, OPF)
    versions: dict = {}
    for ab, v, _ops in prefix:
        versions[ab] = v

    def tail_round():
        """One round's incremental tail, continuing each actor's log."""
        target = max(1, int(N * TAIL_PCT / 100.0))
        got, batch = 0, []
        for ab in actors:
            if got >= target:
                break
            v = versions.get(ab, 0) + 1
            versions[ab] = v
            ops = [[0, int((v * 37 + t) % E), [ab, 1_000_000 + v * OPF + t]]
                   for t in range(min(OPF, target - got))]
            got += len(ops)
            batch.append((ab, v, ops))
        return batch

    tmp = tempfile.mkdtemp(prefix="crdt-e2e-delta-")
    remote = os.path.join(tmp, "remote")
    log(f"e2e_delta: device {device}; {len(prefix)} files, {N} ops, R={R} "
        f"E={E} rounds={ROUNDS} tail={TAIL_PCT:g}%")

    def opts(storage, create, delta=True):
        return orset_options(storage, device, create=create, delta=delta)

    async def build_and_measure():
        producer = await Core.open(opts(
            FsStorage(os.path.join(tmp, "localP"), remote), create=True))

        async def store_files(batch):
            sem = asyncio.Semaphore(64)

            async def one(ab, v, ops):
                async with sem:
                    blob = await producer._seal(ops)
                    await producer.storage.store_ops(ab, v, blob)

            await asyncio.gather(*(one(*f) for f in batch))

        t0 = time.perf_counter()
        for i in range(0, len(prefix), 2048):
            await store_files(prefix[i:i + 2048])
        t_build = time.perf_counter() - t0
        await producer.compact()
        storage_a = CountingStorage(FsStorage(os.path.join(tmp, "localA"),
                                              remote))
        storage_b = CountingStorage(FsStorage(os.path.join(tmp, "localB"),
                                              remote))
        c_delta = await Core.open(opts(storage_a, create=True))
        c_snap = await Core.open(opts(storage_b, create=True, delta=False))
        await c_delta.read_remote()
        await c_snap.read_remote()
        storage_a.bytes_read = storage_a.files_read = 0
        storage_b.bytes_read = storage_b.files_read = 0
        trace.reset()
        reset_launches()
        t_delta = t_snap = 0.0
        for _ in range(ROUNDS):
            await store_files(tail_round())
            await producer.compact()
            t0 = time.perf_counter()
            await c_delta.read_remote()
            t_delta += time.perf_counter() - t0
            t0 = time.perf_counter()
            await c_snap.read_remote()
            t_snap += time.perf_counter() - t0
        obs = trace.snapshot()
        pa = producer.with_state(canonical_bytes)
        equal = (c_delta.with_state(canonical_bytes) == pa
                 and c_snap.with_state(canonical_bytes) == pa)
        return (t_build, t_delta, t_snap, equal, storage_a.bytes_read,
                storage_b.bytes_read, storage_a.files_read,
                storage_b.files_read, obs)

    try:
        (t_build, t_delta, t_snap, equal, bytes_delta, bytes_snap,
         files_delta, files_snap, obs) = asyncio.run(build_and_measure())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counters = obs.get("counters", {})
    applied = counters.get("delta_applied", 0)
    reduction = bytes_snap / bytes_delta if bytes_delta else float("inf")
    result = {
        "metric": metric,
        "config": f"delta_{N}ops_{R}r_{ROUNDS}x{TAIL_PCT:g}pct_tail",
        "value": round(reduction, 2), "unit": unit,
        "bytes_read_delta_path": int(bytes_delta),
        "bytes_read_snapshot_path": int(bytes_snap),
        "files_read_delta_path": int(files_delta),
        "files_read_snapshot_path": int(files_snap),
        "read_wall_delta_s": round(t_delta, 4),
        "read_wall_snapshot_s": round(t_snap, 4),
        "build_s": round(t_build, 1),
        "deltas_applied": int(applied),
        "deltas_sealed": int(counters.get("delta_files_sealed", 0)),
        "delta_bytes_sealed": int(counters.get("delta_bytes_sealed", 0)),
        "delta_fallbacks": int(counters.get("delta_fallbacks", 0)),
        "byte_identical": bool(equal),
        "method": "host_wall_end_to_end",
        "shape": {"N": N, "R": R, "E": E, "ops_per_file": OPF,
                  "rounds": ROUNDS, "tail_pct": TAIL_PCT},
    }
    return finish(argv, result, device, bool(equal and applied >= ROUNDS),
                  f"byte_identical={equal} chains_applied={applied}/{ROUNDS}",
                  obs=obs)


# ----------------------------------------------------- --e2e-strong-read


def e2e_strong_read(argv: list, smoke: bool) -> dict:
    """Linearizable point reads at the stability watermark under producer
    churn.  R producer replicas and one reader share an encrypted
    in-memory remote; each round every producer seals a wave of op files
    and, on a staggered cadence, compacts (publishing its cursor); the
    reader interleaves eventual reads with strong reads
    (``Core.read(linearizable=True)``), sampling the watermark lag, plus
    an untimed ``max_lag=0`` refusal probe.  The final strong read must be
    byte-identical to an oracle fold of exactly the cut it names (else
    exit 1).  The replicas' accelerators run on ``--device``.

    Env knobs: BENCH_SR_PRODUCERS (4), BENCH_SR_ROUNDS (6), BENCH_SR_WAVE
    (24), BENCH_SR_READS (6), BENCH_SR_PUB_EVERY (2)."""
    metric, unit = "strong_read_e2e_reads_per_sec", "reads/s"
    R = int(os.environ.get("BENCH_SR_PRODUCERS", 2 if smoke else 4))
    ROUNDS = int(os.environ.get("BENCH_SR_ROUNDS", 2 if smoke else 6))
    WAVE = int(os.environ.get("BENCH_SR_WAVE", 8 if smoke else 24))
    READS = int(os.environ.get("BENCH_SR_READS", 2 if smoke else 6))
    PUB_EVERY = int(os.environ.get("BENCH_SR_PUB_EVERY", 2))
    device = acquire_device(argv, metric, unit)

    from .backends import MemoryRemote, MemoryStorage
    from .core.core import Core
    from .models import canonical_bytes
    from .models.orset import ORSet
    from .read.stable import StalenessError
    from .sim.linearize import oracle_fold

    warm_kernels(device)

    def opts(storage):
        return orset_options(storage, device)

    async def scenario():
        remote = MemoryRemote()
        producers = [await Core.open(opts(MemoryStorage(remote)))
                     for _ in range(R)]
        reader = await Core.open(opts(MemoryStorage(remote)))
        reset_launches()
        oplog: dict = {}
        total_ops, refusals = 0, 0
        strong_s, eventual_s, lag_samples = [], [], []
        t0 = time.perf_counter()
        for rnd in range(ROUNDS):
            for pi, p in enumerate(producers):
                for w in range(WAVE):
                    member = f"m{pi}-{rnd}-{w}".encode()
                    ops = await p.update(
                        lambda s, a=p.actor_id, m=member: s.add_ctx(a, m))
                    oplog[(p.actor_id, p._local_meta.last_op_version)] = [
                        op.to_obj() for op in ops]
                    total_ops += 1
                if (rnd + pi) % PUB_EVERY == 0:
                    await p.compact()
            for _ in range(READS):
                te = time.perf_counter()
                await reader.read_remote()
                await reader.read()
                eventual_s.append(time.perf_counter() - te)
                ts = time.perf_counter()
                res = await reader.read(linearizable=True)
                strong_s.append(time.perf_counter() - ts)
                lag_samples.append(res.view.lag)
                try:
                    await reader.read(linearizable=True, max_lag=0,
                                      refresh=False)
                except StalenessError:
                    refusals += 1
        for p in producers:
            await p.compact()
            await reader.read_remote()
        res = await reader.read(linearizable=True)
        wall = time.perf_counter() - t0
        lag_samples.append(res.view.lag)
        oracle, missing = oracle_fold(oplog, res.cursor)
        identical = (not missing and canonical_bytes(ORSet.from_obj(res.obj))
                     == canonical_bytes(oracle))
        covered = sum(res.cursor.counters.values())
        return (wall, total_ops, covered, strong_s, eventual_s, lag_samples,
                refusals, identical)

    (wall, total_ops, covered, strong_s, eventual_s, lag_samples, refusals,
     identical) = asyncio.run(scenario())
    q = nearest_rank
    result = {
        "metric": metric, "config": f"strongread_{R}p",
        "value": round(len(strong_s) / sum(strong_s), 1), "unit": unit,
        "reads_strong": len(strong_s), "reads_eventual": len(eventual_s),
        "refusals": refusals,
        "strong_ms": quantiles_ms(strong_s),
        "eventual_ms": quantiles_ms(eventual_s),
        "watermark_lag_versions": {
            "p50": q(lag_samples, 0.50), "p99": q(lag_samples, 0.99),
            "max": max(lag_samples)},
        "total_ops": total_ops, "final_covered_versions": covered,
        "wall_s": round(wall, 3), "byte_identical": identical,
        "method": "host_wall_end_to_end",
        "shape": {"producers": R, "rounds": ROUNDS, "wave": WAVE,
                  "reads_per_round": READS, "pub_every": PUB_EVERY},
    }
    return finish(argv, result, device, identical,
                  "the final strong read diverges from the oracle fold of "
                  "its own cut")


# ------------------------------------------------------------------ --sim


def bench_sim(argv: list, smoke: bool) -> dict:
    """Adversarial-simulator throughput: schedules a second over seeded
    runs.  The odd replicas, service and daemon steps fold on
    ``--device`` (the card unless ``--device cpu``, as ``tools.sim``).
    The run refuses to record if any schedule violates an invariant.
    ``--population P`` runs P schedules at once through one substrate
    (config suffix ``_pP``); after the clock stops every schedule is re-run
    serially and any divergent fingerprint refuses the record.

    Flags: ``--replicas N`` (8), ``--steps M`` (250), ``--faults
    all|none|cls,cls`` (all), ``--population P``; BENCH_SIM_SEEDS (4
    serial; 2·P population)."""
    import logging

    metric, unit = "sim_schedules_per_sec", "schedules/s"
    replicas = flag_int(argv, "--replicas", 4 if smoke else 8)
    steps = flag_int(argv, "--steps", 50 if smoke else 250)
    population = flag_int(argv, "--population", 0)
    spec = flag_value(argv, "--faults", "all")
    device = acquire_device(argv, metric, unit)

    from .sim import generate, run_population, run_schedule
    from .sim import verify_serial_equality
    from .tools.sim import _build_faults

    faults = _build_faults(spec)
    n_seeds = int(os.environ.get(
        "BENCH_SIM_SEEDS",
        (2 if smoke else 4) if population < 2 else 2 * population))
    warm_kernels(device)
    reset_launches()
    totals: Counter = Counter()
    total_steps = total_checks = quarantined = 0
    report, problems = None, []
    # the quarantine warnings are the schedules' point: quiet for the run
    pkg_log = logging.getLogger("crdt_enc_tpu_torch")
    level = pkg_log.level
    pkg_log.setLevel(logging.ERROR)
    try:
        t0 = time.perf_counter()
        if population > 1:
            schedules = [generate(seed, replicas, steps, faults)
                         for seed in range(n_seeds)]
            report = run_population(schedules, population=population,
                                    device=device.type)
            results = list(zip(schedules, report.results))
        else:
            results = []
            for seed in range(n_seeds):
                schedule = generate(seed, replicas, steps, faults)
                results.append((schedule, run_schedule(schedule,
                                                       device=device.type)))
        wall = time.perf_counter() - t0
        launches = read_launches()
        if report is not None:
            problems = verify_serial_equality(report, device=device.type)
    finally:
        pkg_log.setLevel(level)
    for schedule, res in results:
        if not res.ok:
            raise SystemExit(
                f"sim seed {schedule.seed} violated an invariant: "
                f"{res.violation} — a broken protocol has no throughput "
                "to record")
        totals.update(res.fault_stats)
        total_steps += res.steps_run
        total_checks += res.checks_run
        quarantined += res.quarantined
    suffix = f"_p{population}" if population > 1 else ""
    result = {
        "metric": metric, "config": f"sim_{replicas}r_{steps}s_{spec}{suffix}",
        "value": round(n_seeds / wall, 3), "unit": unit,
        "steps_per_sec": round(total_steps / wall, 1),
        "schedules": n_seeds, "replicas": replicas, "steps": steps,
        "faults": spec, "faults_survived": dict(sorted(totals.items())),
        "faults_survived_total": sum(totals.values()),
        "ingest_quarantined": quarantined, "quiescence_checks": total_checks,
        "violations": 0, "wall_s": round(wall, 3),
        "fingerprints": [res.fingerprint for _, res in results],
        "method": "host_wall_end_to_end",
    }
    if population > 1:
        result["population"] = population
        result["serial_equivalent"] = not problems
    # the timed runs' launches, not the serial re-run's
    return finish(argv, result, device, not problems,
                  "the population diverged from its serial twins: "
                  + "; ".join(problems), launches=launches)


# ---------------------------------------------------------- default mode


def fold_mode(argv: list, smoke: bool) -> dict:
    """BASELINE config 3's fold: 1M add/remove ops over 10,000 replicas
    and 4,096 members folded into empty planes on the card.  Routes: K2
    (``orset_fold_cuda``, the whole fold in one launch) and K1
    (``orset_scatter``) plus the PyTorch tail; ``scatter_reduce_`` (the
    plain fold, ``ops.orset.orset_fold_plain``) is the library yardstick,
    timed and checked but not a route.  Every route is byte-checked
    against the per-op host loop on a 20,000-row subsample and at the full
    batch against the vectorized host fold (itself tied to the host loop
    on the subsample).  Any route or the library call diverging, or a
    time implying more than the card's memory rate on the bytes model,
    refuses the record (exit 1).
    Device times: CUDA events around BENCH_CHAIN calls back to back,
    BENCH_ITERS samples per round, BENCH_ROUNDS rounds interleaved across
    routes; the value is the best route's fastest sample."""
    metric, unit = "orset_compaction_fold_ops_per_sec", "ops/s"
    N = int(os.environ.get("BENCH_OPS", 50_000 if smoke else 1_000_000))
    R = int(os.environ.get("BENCH_REPLICAS", 500 if smoke else 10_000))
    E = int(os.environ.get("BENCH_MEMBERS", 256 if smoke else 4096))
    N_HOST = min(N, int(os.environ.get("BENCH_HOST_OPS",
                                       20_000 if smoke else 100_000)))
    ITERS = int(os.environ.get("BENCH_ITERS", 3))
    CHAIN = int(os.environ.get("BENCH_CHAIN", 20))
    ROUNDS = int(os.environ.get("BENCH_ROUNDS", 2))
    device = acquire_device(argv, metric, unit)

    import torch

    from .models import ORSet
    from .ops.columnar import Vocab, orset_fold_sparse_host
    from .ops.columnar import orset_planes_to_state
    from .ops.orset import orset_fold_plain, orset_fold_tail_plain
    from .ops.orset_fold_cuda import orset_fold_cuda, orset_scatter
    from .utils import codec, trace

    warm_kernels(device)
    log(f"device: {device}; N={N} R={R} E={E}")
    kind, member, actor, counter = gen_columns(N, R, E)

    def k2_fused(c, a, r, *rows):
        return orset_fold_cuda(c, a, r, *rows, num_members=E, num_replicas=R)

    def k1_scatter_torch_tail(c, a, r, *rows):
        clock = c.clone()
        add_new, rm_new = orset_scatter(*rows, num_members=E, num_replicas=R,
                                        clock=clock)
        add, rm = orset_fold_tail_plain(c, clock, a, r, add_new, rm_new)
        return clock, add, rm

    def library_scatter_reduce(c, a, r, *rows):
        return orset_fold_plain(c, a, r, *rows, num_members=E,
                                num_replicas=R)

    routes = {"k2_fused": k2_fused,
              "k1_scatter_torch_tail": k1_scatter_torch_tail}
    library = {"library_scatter_reduce": library_scatter_reduce}

    def on_device(*arrays):
        if device.type == "cuda":
            n = sum(x.nbytes for x in arrays)
            trace.add("h2d_bytes", n)
            trace.add("h2d_pageable_bytes", n)
        return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
                for x in arrays]

    def zero_planes():
        return on_device(np.zeros(R, np.int32), np.zeros((E, R), np.int32),
                         np.zeros((E, R), np.int32))

    mem_v, rep_v = Vocab(range(E)), Vocab(range(R))

    def state_bytes(planes) -> bytes:
        ck, ad, rm = (p.cpu().numpy() for p in planes)
        return codec.pack(orset_planes_to_state(ck, ad, rm, mem_v, rep_v)
                          .to_obj())

    n_chk = min(N, 20_000)
    h_state, _ = host_fold(kind[:n_chk], member[:n_chk], actor[:n_chk],
                           counter[:n_chk], R)
    h_bytes = codec.pack(h_state.to_obj())
    sub_rows = on_device(kind[:n_chk], member[:n_chk], actor[:n_chk],
                         counter[:n_chk])
    diverged = []
    for name, fn in {**routes, **library}.items():
        ok = state_bytes(fn(*zero_planes(), *sub_rows)) == h_bytes
        log(f"byte-equality[{name}] (n={n_chk}): {'OK' if ok else 'MISMATCH'}")
        if not ok:
            diverged.append(name)
    del sub_rows

    args = zero_planes() + on_device(kind, member, actor, counter)
    sub_sparse = orset_fold_sparse_host(
        ORSet(), kind[:n_chk], member[:n_chk], actor[:n_chk],
        counter[:n_chk], mem_v, rep_v)
    if codec.pack(sub_sparse.to_obj()) != h_bytes:
        raise SystemExit("the vectorized host fold diverged from the "
                         "per-op host loop on the subsample")
    full_bytes = codec.pack(orset_fold_sparse_host(
        ORSet(), kind, member, actor, counter, mem_v, rep_v).to_obj())
    ref = None
    for name, fn in {**routes, **library}.items():
        out = fn(*args)
        if ref is None:
            ok = state_bytes(out) == full_bytes
            ref = out if ok else None
        else:
            ok = all(torch.equal(x, y) for x, y in zip(out, ref))
        log(f"full-batch byte-equality[{name}] (N={N}): "
            f"{'OK' if ok else 'MISMATCH'}")
        if not ok and name not in diverged:
            diverged.append(name)
    del ref

    def host_once():
        state, t = host_fold(kind[:N_HOST], member[:N_HOST], actor[:N_HOST],
                             counter[:N_HOST], R)
        return t, state

    t_host, host_times, _ = host_median(host_once)
    host_rate = N_HOST / t_host
    log(f"host: {N_HOST} ops, median of {len(host_times)}: {t_host:.3f}s")

    reset_launches()
    samples = {n: [] for n in {**routes, **library}}
    for _rd in range(ROUNDS):
        for name, fn in {**routes, **library}.items():
            samples[name].extend(time_back_to_back(
                lambda fn=fn: fn(*args), device, CHAIN, ITERS))
    launches = read_launches()
    bytes_model = orset_fold_bytes_model(N, E, R)
    times = {n: min(ts) for n, ts in samples.items()}
    pcts = {n: roofline_pct(bytes_model, t, device) for n, t in times.items()}
    over = {n: p for n, p in pcts.items() if p is not None and p > 100.0}
    best = min(routes, key=lambda n: times[n])
    t_dev = times[best]
    rate = N / t_dev
    ratio = pinned_ratio_fields(
        "orset_10kx1M", {"N": N, "R": R, "E": E, "n_host": N_HOST},
        rate, rate / host_rate)
    ratio.pop("_ratio_raw", None)
    lib_t = times.get("library_scatter_reduce")
    result = {
        "metric": metric, "value": round(rate, 1), "unit": unit, **ratio,
        "method": timing_method(device),
        "best_variant": best,
        "bytes_model": bytes_model,
        "bytes_model_dtype": f"{PLANE_DTYPE} planes, {ROW_BYTES} B a row",
        "pct_hbm_peak": pcts[best],
        "pct_hbm_peak_by_route": pcts,
        "full_batch_equal": not diverged,
        "diverged": diverged,
        "device_ms": {n: round(t * 1e3, 4) for n, t in times.items()},
        "library_ms": round(lib_t * 1e3, 4) if lib_t is not None else None,
        **device_stats(samples[best]),
        "host_rate": round(host_rate, 1), **host_stats(host_times),
        "shape": {"N": N, "R": R, "E": E, "chain": CHAIN, "iters": ITERS,
                  "rounds": ROUNDS, "n_host": N_HOST},
    }
    # a divergent route, or a time faster than the card's memory rate
    # allows (a timing of the enqueue), refuses the record
    why = "; ".join(
        [f"{n} diverged from the host fold" for n in diverged]
        + [f"{n} implies {p}% of the card's memory rate" for n, p in
           over.items()])
    return finish(argv, result, device, not why, why, launches=launches,
                  device_samples_ms_all={
                      n: [round(t * 1e3, 4) for t in ts]
                      for n, ts in samples.items()})


# ------------------------------------------------------------------- main

MODES = {
    "--sim": bench_sim,
    "--e2e-strong-read": e2e_strong_read,
    "--e2e-delta": e2e_delta,
    "--e2e-streaming": e2e_streaming,
    "--device-decode": device_decode_exp,
    "--e2e-warm-open": e2e_warm_open,
    "--e2e-multitenant": e2e_multitenant,
    "--e2e-daemon": e2e_daemon,
    "--e2e-idle-cycle": e2e_idle_cycle,
}


def run(argv: list) -> dict:
    """Run the mode ``argv`` names (the default fold without one) and
    return its record; gates and a missing card raise ``SystemExit``."""
    smoke = "--smoke" in argv
    for flag, mode in MODES.items():
        if flag in argv:
            return mode(argv, smoke)
    return fold_mode(argv, smoke)


def main(argv: list | None = None) -> int:
    run(list(sys.argv[1:] if argv is None else argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
