"""The five BASELINE.json configs, the host loop against the card.

The twin of the JAX package's ``benchmarks/suite.py``.  Each config
measures the single-core host loop's fold rate (the per-op loop the
reference runs, on a capped subsample for the big configs: it is O(n),
so the rate transfers), the device fold rate and the byte equality of
the folded state against the host loop on a common subsample.

Configs 1–4 time the fold with CUDA events around BENCH_CHAIN calls
back to back after a warm-up (``method``: ``cuda_events_back_to_back``;
on ``--device cpu``, ``host_clock_back_to_back``); config 5 is the
end-to-end streaming pipeline (decrypt → decode → fold) timed on the
host clock, its state read back to the host.

Run:  python3 -m crdt_enc_tpu_torch.benchmarks.suite [--smoke]
      [--config N] [--iters N] [--device cuda|cpu] [--record PATH]

Prints one JSON line per config and a trailing summary line; without a
card and without ``--device cpu`` it prints the ``cuda_unavailable``
line and exits 3.  ``--record PATH`` appends one record per config (its
``value`` is the device rate); nothing else is written.  A config whose
state differs from the host loop's, or whose time implies more than the
card's memory rate, is printed but not recorded, and the run exits 1.

Sizes are env-tunable (SUITE_SCALE=0.1 scales every N down 10x; the
smoke scale is 0.02).  Config 1 launches nothing of the port's own, 2
likewise (both plain PyTorch), 3 launches K2 (``orset_fold_cuda``), 4
K5 (``lww_fold_cuda``), 5 K2 through the dense fold when the planes
are dense enough and none in the sparse regime.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import uuid

import numpy as np

from .. import bench as north
from ..bench import host_median, host_stats, log

CHAIN = int(os.environ.get("BENCH_CHAIN", 20))


def running_count(group: np.ndarray, n_groups: int) -> np.ndarray:
    """1-based running occurrence count per group id, in row order."""
    n = len(group)
    order = np.argsort(group, kind="stable")
    g = group[order]
    cum = np.arange(1, n + 1, dtype=np.int64)
    starts = np.searchsorted(g, np.arange(n_groups))
    within = cum - starts[g]
    out = np.empty(n, np.int64)
    out[order] = within
    return out.astype(np.int32)


def actor_bytes_table(R: int) -> list:
    """R actor ids whose byte order equals their index order."""
    return [uuid.UUID(int=i + 1).bytes for i in range(R)]


def _host_only_record(config, n_ops, shape, t_host, host_times):
    """What the pin tool needs: the config's host rate under the exact
    workload the suite runs, with raw samples."""
    return dict(
        config=config, host_only=True, n_ops=n_ops, shape=shape,
        host_rate=n_ops / t_host, median_s=t_host,
        **host_stats(host_times),
    )


def timeit_device(fn, device, iters: int, chain: int = 0):
    """Per-call device seconds of ``fn`` (CUDA events around ``chain``
    calls back to back after a warm-up): ``(best, samples, method)``."""
    samples = north.time_back_to_back(fn, device, chain or CHAIN,
                                      max(iters, 1))
    return min(samples), samples, north.timing_method(device)


def _tensors(device, *arrays):
    import torch

    from ..utils import trace

    if device.type == "cuda":
        n = sum(x.nbytes for x in arrays)
        trace.add("h2d_bytes", n)
        trace.add("h2d_pageable_bytes", n)
    return [torch.from_numpy(np.ascontiguousarray(x)).to(device)
            for x in arrays]


# --------------------------------------------------------------- config 1+2


def bench_gcounter(N: int, R: int, iters: int, device=None,
                   host_only: bool = False) -> dict:
    """Config 1: G-Counter, 4 replicas, 1k increment ops."""
    from ..models import GCounter
    from ..models.vclock import Dot
    from ..ops.counters import gcounter_fold

    rng = np.random.default_rng(1)
    actor = rng.integers(0, R, N, dtype=np.int32)
    counter = running_count(actor, R)
    actors = actor_bytes_table(R)

    def host_once():
        state = GCounter()
        t0 = time.perf_counter()
        for a, c in zip(actor.tolist(), counter.tolist()):
            state.apply(Dot(actors[a], c))
        return time.perf_counter() - t0, state

    t_host, host_times, state = host_median(host_once)
    if host_only:
        return _host_only_record(
            "gcounter_4x1k", N, dict(N=N, R=R), t_host, host_times)
    clock0, d_actor, d_counter = _tensors(device, np.zeros(R, np.int32),
                                          actor, counter)
    t_dev, samples, timing = timeit_device(
        lambda: gcounter_fold(clock0, d_actor, d_counter, num_replicas=R),
        device, iters)
    clock, total = gcounter_fold(clock0, d_actor, d_counter, num_replicas=R)
    dev_clock = {actors[i]: int(c) for i, c in enumerate(clock.cpu().tolist())
                 if c}
    equal = dev_clock == state.clock.counters and int(total) == state.read()
    return dict(
        config="gcounter_4x1k", metric="ops_folded_per_sec", N=N, R=R,
        _pin_shape=dict(N=N, R=R),
        host_rate=N / t_host, device_rate=N / t_dev, byte_equal=bool(equal),
        timing=timing, bytes_model=8 * N + 2 * 4 * R,
        **north.device_stats(samples), **host_stats(host_times),
    )


def bench_pncounter(N: int, R: int, iters: int, device=None,
                    host_only: bool = False) -> dict:
    """Config 2: PN-Counter, 1k replicas, 100k mixed inc/dec ops."""
    from ..models import PNCounter
    from ..models.vclock import Dot
    from ..ops.counters import pncounter_fold

    rng = np.random.default_rng(2)
    actor = rng.integers(0, R, N, dtype=np.int32)
    sign = (rng.random(N) < 0.3).astype(np.int8)  # ~30% decrements
    counter = running_count(actor * 2 + sign, R * 2)
    actors = actor_bytes_table(R)
    n_host = min(N, 200_000)

    def host_once():
        state = PNCounter()
        t0 = time.perf_counter()
        for a, s, c in zip(actor[:n_host].tolist(), sign[:n_host].tolist(),
                           counter[:n_host].tolist()):
            state.apply((int(s), Dot(actors[a], c)))
        return time.perf_counter() - t0, state

    t_host, host_times, state = host_median(host_once)
    if host_only:
        return _host_only_record(
            "pncounter_1kx100k", n_host, dict(N=N, R=R, n_host=n_host),
            t_host, host_times)
    p0, n0, d_sign, d_actor, d_counter = _tensors(
        device, np.zeros(R, np.int32), np.zeros(R, np.int32), sign, actor,
        counter)
    t_dev, samples, timing = timeit_device(
        lambda: pncounter_fold(p0, n0, d_sign, d_actor, d_counter,
                               num_replicas=R), device, iters)
    ps, ns, val = pncounter_fold(p0, n0, *_tensors(
        device, sign[:n_host], actor[:n_host], counter[:n_host]),
        num_replicas=R)
    dev_p = {actors[i]: int(c) for i, c in enumerate(ps.cpu().tolist()) if c}
    dev_n = {actors[i]: int(c) for i, c in enumerate(ns.cpu().tolist()) if c}
    equal = (dev_p == state.p.clock.counters
             and dev_n == state.n.clock.counters and int(val) == state.read())
    return dict(
        config="pncounter_1kx100k", metric="ops_folded_per_sec", N=N, R=R,
        _pin_shape=dict(N=N, R=R, n_host=n_host),
        host_rate=n_host / t_host, device_rate=N / t_dev,
        byte_equal=bool(equal), timing=timing, bytes_model=9 * N + 4 * 4 * R,
        **north.device_stats(samples), **host_stats(host_times),
    )


# ----------------------------------------------------------------- config 3


def bench_orset(N: int, R: int, E: int, n_host: int, iters: int,
                device=None, host_only: bool = False) -> dict:
    """Config 3 (the main path): OR-Set, 10k replicas, 1M add/remove ops,
    folded by K2 (``orset_fold_cuda``) into empty planes."""
    from ..ops.columnar import Vocab, orset_planes_to_state
    from ..ops.orset_fold_cuda import orset_fold_cuda
    from ..utils import codec

    kind, member, actor, counter = north.gen_columns(N, R, E)

    def host_once():
        state, t = north.host_fold(kind[:n_host], member[:n_host],
                                   actor[:n_host], counter[:n_host], R)
        return t, state

    if host_only:
        t_host, host_times, _ = host_median(host_once)
        return _host_only_record(
            "orset_10kx1M", n_host, dict(N=N, R=R, E=E, n_host=n_host),
            t_host, host_times)

    def planes():
        return _tensors(device, np.zeros(R, np.int32),
                        np.zeros((E, R), np.int32), np.zeros((E, R), np.int32))

    def fold(c, a, r, *rows):
        return orset_fold_cuda(c, a, r, *rows, num_members=E, num_replicas=R)

    n_chk = min(N, 20_000)
    h_state, _ = north.host_fold(kind[:n_chk], member[:n_chk],
                                 actor[:n_chk], counter[:n_chk], R)
    ck, ad, rm = fold(*planes(), *_tensors(
        device, kind[:n_chk], member[:n_chk], actor[:n_chk], counter[:n_chk]))
    t_state = orset_planes_to_state(ck.cpu().numpy(), ad.cpu().numpy(),
                                    rm.cpu().numpy(), Vocab(range(E)),
                                    Vocab(range(R)))
    equal = codec.pack(t_state.to_obj()) == codec.pack(h_state.to_obj())
    t_host, host_times, _ = host_median(host_once)
    args = planes() + _tensors(device, kind, member, actor, counter)
    t_dev, samples, timing = timeit_device(lambda: fold(*args), device, iters)
    return dict(
        config="orset_10kx1M", metric="ops_folded_per_sec", N=N, R=R, E=E,
        _pin_shape=dict(N=N, R=R, E=E, n_host=n_host),
        host_rate=n_host / t_host, device_rate=N / t_dev,
        byte_equal=bool(equal), timing=timing,
        bytes_model=north.orset_fold_bytes_model(N, E, R),
        **north.device_stats(samples), **host_stats(host_times),
    )


# ----------------------------------------------------------------- config 4


def bench_lwwmap(N: int, K_keys: int, R: int, n_host: int, iters: int,
                 device=None, host_only: bool = False) -> dict:
    """Config 4: LWW-map, 1M keys, 10k replicas, timestamped writes.  The
    timed call is ``lww_fold_into`` against a full winner table (K5 over
    the new rows, then the table merge), as the JAX suite's chain."""
    from ..models import LWWMap
    from ..models.lwwmap import LWWOp
    from ..ops.lww import lww_fold, lww_fold_into, ts_split

    rng = np.random.default_rng(4)
    key = rng.integers(0, K_keys, N, dtype=np.int32)
    ts = rng.integers(1, 1 << 40, N, dtype=np.int64)
    actor = rng.integers(0, R, N, dtype=np.int32)
    # single-byte msgpack domain, so value rank == numeric value
    value = rng.integers(0, 100, N, dtype=np.int32)
    hi, lo = ts_split(ts)
    actors = actor_bytes_table(R)

    def host_once():
        state = LWWMap()
        t0 = time.perf_counter()
        for k, t, a, v in zip(key[:n_host].tolist(), ts[:n_host].tolist(),
                              actor[:n_host].tolist(),
                              value[:n_host].tolist()):
            state.apply(LWWOp(k, t, actors[a], v))
        return time.perf_counter() - t0, state

    t_host, host_times, state = host_median(host_once)
    if host_only:
        return _host_only_record(
            "lwwmap_1Mx10k", n_host, dict(N=N, K=K_keys, R=R, n_host=n_host),
            t_host, host_times)
    args = _tensors(device, key, hi, lo, actor, value)
    n_values = int(value.max()) + 1
    table = lww_fold(*args, num_keys=K_keys, num_values=n_values)
    t_dev, samples, timing = timeit_device(
        lambda: lww_fold_into(table, *args, num_keys=K_keys,
                              num_values=n_values), device, iters)

    def sub(lo_, hi_):
        return _tensors(device, key[lo_:hi_], hi[lo_:hi_], lo[lo_:hi_],
                        actor[lo_:hi_], value[lo_:hi_])

    h2 = n_host // 2
    inc = lww_fold_into(
        lww_fold(*sub(0, h2), num_keys=K_keys, num_values=n_values),
        *sub(h2, n_host), num_keys=K_keys, num_values=n_values)
    whole = lww_fold(*sub(0, n_host), num_keys=K_keys)
    inc_equal = all(bool((a.cpu() == b.cpu()).all())
                    for a, b in zip(whole, inc))
    m_hi, m_lo, m_actor, m_value, present = (x.cpu().numpy() for x in whole)
    dev_map = LWWMap()
    dev_map.entries = {
        int(k): [(int(m_hi[k]) << 31) | int(m_lo[k]), actors[int(m_actor[k])],
                 int(m_value[k]), False]
        for k in np.flatnonzero(present)
    }
    equal = (dev_map == state) and inc_equal
    return dict(
        config="lwwmap_1Mx10k", metric="writes_folded_per_sec", N=N,
        _pin_shape=dict(N=N, K=K_keys, R=R, n_host=n_host),
        K=K_keys, R=R,
        host_rate=n_host / t_host, device_rate=N / t_dev,
        byte_equal=bool(equal), timing=timing, variant="k5_cooperative",
        bytes_model=20 * N + 2 * 20 * K_keys,
        **north.device_stats(samples), **host_stats(host_times),
    )


# ----------------------------------------------------------------- config 5


def _build_encrypted_files(N, R, E, ops_per_file, key, n_headers):
    """Columns → per-actor op files (the JAX suite's layout, payload for
    payload), sealed with the native AEAD, plus a few header-CRDT
    (Keys-style MVReg) blobs."""
    from ..backends.xchacha import encrypt_blob
    from ..models import MVReg
    from ..utils import codec

    kind, member, actor, counter = north.gen_columns(N, R, E, seed=5)
    actors = actor_bytes_table(R)
    live = actor < R
    order = np.argsort(actor[live], kind="stable")
    k_l = kind[live][order]
    m_l = member[live][order]
    a_l = actor[live][order]
    c_l = counter[live][order]
    payloads, plain_payloads = [], []
    i, n = 0, len(k_l)
    while i < n:
        j = min(i + ops_per_file, n)
        # a file stays within one actor (files are per (actor, version))
        j = i + int(np.searchsorted(a_l[i:j], a_l[i], side="right"))
        ops = []
        for t in range(i, j):
            ab = actors[int(a_l[t])]
            if k_l[t] == 0:
                ops.append([0, int(m_l[t]), [ab, int(c_l[t])]])
            else:
                ops.append([1, int(m_l[t]), {ab: int(c_l[t])}])
        raw = codec.pack(ops)
        plain_payloads.append(raw)
        payloads.append(encrypt_blob(key, raw))
        i = j
    headers = []
    for h in range(n_headers):
        reg = MVReg()
        reg.apply(reg.write_ctx(actors[h % R], [b"hdr", h]))
        headers.append(encrypt_blob(key, codec.pack(reg.to_obj())))
    return payloads, plain_payloads, headers, actors


def bench_streaming(N, R, E, ops_per_file, n_host_files, iters, device=None,
                    host_only: bool = False) -> dict:
    """Config 5: mixed header-CRDT + OR-Set, 100k replicas, streaming
    compaction with the XChaCha20-Poly1305 decrypt front end
    (``decrypt_blobs_chunked`` → ``TorchAccelerator.fold_payload_stream``)."""
    import secrets

    from ..backends.xchacha import (
        decrypt_blob,
        decrypt_blobs,
        decrypt_blobs_chunked,
    )
    from ..models import MVReg, ORSet
    from ..models.orset import AddOp, RmOp
    from ..models.vclock import Dot, VClock
    from ..parallel.accel import TorchAccelerator
    from ..utils import codec

    key = secrets.token_bytes(32)
    payloads, plain, headers, actors = _build_encrypted_files(
        N, R, E, ops_per_file, key, n_headers=max(1, len(str(N))))
    n_files = len(payloads)
    n_ops = sum(len(codec.unpack(p)) for p in plain[:n_host_files])
    log(f"  streaming: {n_files} files, {len(headers)} headers")

    def host_once():
        state = ORSet()
        t0 = time.perf_counter()
        for blob in payloads[:n_host_files]:
            for o in codec.unpack(decrypt_blob(key, blob)):
                if o[0] == 0:
                    state.apply(AddOp(o[1], Dot.from_obj(o[2])))
                else:
                    state.apply(RmOp(o[1], VClock.from_obj(o[2])))
        for h in headers:
            MVReg.from_obj(codec.unpack(decrypt_blob(key, h)))
        return time.perf_counter() - t0, state

    t_host, host_times, state = host_median(host_once)
    host_rate = n_ops / t_host
    if host_only:
        return _host_only_record(
            "mixed_streaming_100k", n_ops,
            dict(R=R, E=E, ops_per_file=ops_per_file,
                 n_host_files=n_host_files), t_host, host_times)
    accel = TorchAccelerator(device=device)
    actors_sorted = sorted(actors)

    def pipeline():
        folded = ORSet()
        chunks = decrypt_blobs_chunked(key, payloads, n_chunks=8)
        for h in decrypt_blobs(key, headers):
            MVReg.from_obj(codec.unpack(h))
        ok = accel.fold_payload_stream(folded, chunks,
                                       actors_hint=actors_sorted)
        assert ok, "the accelerator declined the bulk payload batch"
        return folded

    total_ops = sum(len(codec.unpack(p)) for p in plain)
    pipeline()  # warm-up
    samples = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        pipeline()
        samples.append(time.perf_counter() - t0)
    t_dev = min(samples)
    sub = ORSet()
    ok = accel.fold_payloads(sub, decrypt_blobs(key, payloads[:n_host_files]),
                             actors_hint=actors_sorted)
    equal = bool(ok) and codec.pack(sub.to_obj()) == codec.pack(state.to_obj())
    return dict(
        config="mixed_streaming_100k", metric="ops_streamed_per_sec",
        _pin_shape=dict(R=R, E=E, ops_per_file=ops_per_file,
                        n_host_files=n_host_files),
        N=total_ops, R=R, E=E, files=n_files,
        host_rate=host_rate, device_rate=total_ops / t_dev,
        byte_equal=bool(equal),
        # the pipeline's passes are host walls
        **north.spread_fields("pipeline", samples), **host_stats(host_times),
        # an end-to-end host pipeline (AEAD and decode dominate): the
        # memory roofline is not its bound, so no share is reported
        timing="end_to_end", bytes_model=None,
    )


# --------------------------------------------------------------------- main


def runners(scale: float, iters: int, device) -> dict:
    def S(n, lo=64):
        return max(lo, int(n * scale))

    return {
        1: lambda: bench_gcounter(S(1_000), 4, iters, device),
        2: lambda: bench_pncounter(S(100_000), min(1_000, S(1_000)), iters,
                                   device),
        3: lambda: bench_orset(
            S(1_000_000), min(10_000, S(10_000)), min(4096, S(4096)),
            n_host=S(100_000, lo=2_000), iters=iters, device=device),
        4: lambda: bench_lwwmap(
            S(1_000_000), min(1_000_000, S(1_000_000)), min(10_000, S(10_000)),
            n_host=S(50_000, lo=2_000), iters=iters, device=device),
        5: lambda: bench_streaming(
            S(200_000), min(100_000, S(100_000)), min(1024, S(1024)),
            ops_per_file=48, n_host_files=S(300, lo=20), iters=iters,
            device=device),
    }


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m crdt_enc_tpu_torch.benchmarks.suite")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--config", type=int, default=0,
                    help="run one config (1-5)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--record", default=None,
                    help="append one record per config to this file")
    args = ap.parse_args(argv)
    flags = ["--device", args.device]
    device = north.acquire_device(flags, "ops_folded_per_sec", "ops/s")
    north.warm_kernels(device)
    info = north.device_info(device)
    log(f"device: {device} ({info['device_name']})")
    scale = float(os.environ.get("SUITE_SCALE", 0.02 if args.smoke else 1.0))
    run = runners(scale, args.iters, device)
    wanted = [args.config] if args.config else sorted(run)
    results, ratios, refused = [], [], []
    for c in wanted:
        log(f"config {c}…")
        north.reset_launches()
        r = run[c]()
        launches = north.read_launches()
        bm = r.get("bytes_model")
        pct = (north.roofline_pct(bm, r["N"] / r["device_rate"], device)
               if bm else None)
        r["pct_hbm_peak"] = pct
        r["super_roofline"] = bool(pct is not None and pct > 100.0)
        r.update(north.pinned_ratio_fields(
            r["config"], r.pop("_pin_shape", None) or {},
            r["device_rate"], r["device_rate"] / r["host_rate"]))
        raw = r.pop("_ratio_raw")
        if not r["super_roofline"]:
            ratios.append(raw)
        r["host_rate"] = round(r["host_rate"], 1)
        r["device_rate"] = round(r["device_rate"], 1)
        r.update(value=r["device_rate"],
                 unit="writes/s" if c == 4 else "ops/s",
                 launches=launches, **info)
        results.append(r)
        print(json.dumps(r), flush=True)
        if r["super_roofline"] or not r["byte_equal"]:
            refused.append(c)
            log(f"FAILED: config {c} (byte_equal={r['byte_equal']}, "
                f"{pct}% of the memory rate) — not recorded")
            continue
        north.append_record(flags + (["--record", args.record]
                                     if args.record else []),
                            {**r, "ts": north.now_iso(),
                             "host_cpus": os.cpu_count(),
                             "shape": {k: r[k] for k in ("N", "R", "E", "K")
                                       if k in r}})
    summary = {
        "suite": "baseline_configs", "device": info["device_name"],
        "backend": info["backend"], "configs_run": wanted,
        "all_byte_equal": all(r["byte_equal"] for r in results),
        "geomean_speedup": round(float(np.exp(np.mean(np.log(ratios)))), 2)
        if ratios else None,
    }
    print(json.dumps(summary), flush=True)
    return 1 if refused else 0


if __name__ == "__main__":
    raise SystemExit(main())
