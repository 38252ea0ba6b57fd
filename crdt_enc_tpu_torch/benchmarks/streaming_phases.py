"""Config 5's phase budget: where the streaming compaction's wall goes.

The twin of the JAX package's ``benchmarks/streaming_phases.py``.  At
suite config 5's workload (100k replicas, ~190k ops, ~83k encrypted
files) it measures, each best of BENCH_ITERS (3):

  decrypt   — the batch AEAD open of every payload, in the pipeline's
              own form (one packed open per chunk), no decode;
  decode    — the native columnar decode of the decrypted chunks
              (``open_payload_stream().feed``), no finish;
  fold+wb   — ``finish()`` on a fed stream: the fold and the state
              writeback, split by the trace spans under it;
  e2e       — the overlapped pipeline (``decrypt_blobs_chunked`` →
              ``fold_payload_stream``).

Run:  python3 -m crdt_enc_tpu_torch.benchmarks.streaming_phases
      [--smoke] [--device cuda|cpu] [--record PATH]

Prints one JSON line; the e2e state must equal ``fold_payloads``' over
the same payloads (else exit 1).  ``--smoke`` cuts the workload to 2%.
"""

from __future__ import annotations

import argparse
import os
import secrets
import time

from .. import bench as north
from ..bench import log

ITERS = int(os.environ.get("BENCH_ITERS", 3))


def best_of(fn, iters: int = 0):
    out, best, samples = None, float("inf"), []
    for _ in range(iters or ITERS):
        t0 = time.perf_counter()
        out = fn()
        samples.append(time.perf_counter() - t0)
        best = min(best, samples[-1])
    return best, out, samples


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m crdt_enc_tpu_torch.benchmarks.streaming_phases")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--record", default=None)
    args = ap.parse_args(argv)
    flags = ["--device", args.device] + (
        ["--record", args.record] if args.record else [])
    device = north.acquire_device(flags, "mixed_streaming_100k_phases",
                                  "ops/s")

    from ..backends.xchacha import decrypt_blobs, decrypt_blobs_chunked
    from ..backends.xchacha import decrypt_blobs_packed
    from ..models import ORSet
    from ..parallel.accel import TorchAccelerator
    from ..utils import codec, trace
    from .suite import _build_encrypted_files

    north.warm_kernels(device)
    scale = 0.02 if args.smoke else 1.0
    N, R, E = int(200_000 * scale), int(100_000 * scale), max(
        64, int(1024 * scale))
    ops_per_file, n_chunks = 48, 8
    key = secrets.token_bytes(32)
    payloads, plain, _headers, actors = _build_encrypted_files(
        N, R, E, ops_per_file, key, n_headers=6)
    total_ops = sum(len(codec.unpack(p)) for p in plain)
    accel = TorchAccelerator(device=device)
    actors_sorted = sorted(actors)
    log(f"files={len(payloads)} ops={total_ops}")
    north.reset_launches()

    chunk_blobs = max(1, -(-len(payloads) // n_chunks))
    spans_b = [payloads[i:i + chunk_blobs]
               for i in range(0, len(payloads), chunk_blobs)]
    t_decrypt, packed_chunks, s_decrypt = best_of(
        lambda: [decrypt_blobs_packed(key, s) for s in spans_b])

    def decode_only():
        stream = accel.open_payload_stream(ORSet(), actors_hint=actors_sorted)
        for ch in packed_chunks:
            assert stream.feed(ch)
        return stream

    t_decode, _stream, s_decode = best_of(decode_only)

    def fold_wb():
        st = decode_only()
        trace.reset()
        t0 = time.perf_counter()
        assert st.finish()
        return time.perf_counter() - t0

    s_finish = [fold_wb() for _ in range(ITERS)]
    t_finish = min(s_finish)
    spans = {k: round(v["seconds"], 4)
             for k, v in trace.snapshot().get("spans", {}).items()}

    def pipeline():
        folded = ORSet()
        ch = decrypt_blobs_chunked(key, payloads, n_chunks=n_chunks)
        assert accel.fold_payload_stream(folded, ch,
                                         actors_hint=actors_sorted)
        return folded

    pipeline()  # warm-up
    t_e2e, folded, s_e2e = best_of(pipeline)
    whole = ORSet()
    assert accel.fold_payloads(whole, decrypt_blobs(key, payloads),
                               actors_hint=actors_sorted)
    equal = codec.pack(folded.to_obj()) == codec.pack(whole.to_obj())
    table = {
        "metric": "mixed_streaming_100k_phases",
        "config": "mixed_streaming_100k_phases",
        "value": round(total_ops / t_e2e, 1), "unit": "ops/s",
        "files": len(payloads), "ops": total_ops,
        "decrypt_s": round(t_decrypt, 4),
        "decode_s": round(t_decode, 4),
        "fold_writeback_s": round(t_finish, 4),
        "fold_spans_s": spans,
        "e2e_overlapped_s": round(t_e2e, 4),
        "e2e_rate_ops_s": round(total_ops / t_e2e, 1),
        "sum_phases_s": round(t_decrypt + t_decode + t_finish, 4),
        "samples_s": {k: [round(t, 4) for t in sorted(v)] for k, v in (
            ("decrypt", s_decrypt), ("decode", s_decode),
            ("fold_writeback", s_finish), ("e2e", s_e2e))},
        "byte_equal": bool(equal),
        "method": "host_wall_end_to_end",
        "shape": {"N": N, "R": R, "E": E, "ops_per_file": ops_per_file,
                  "n_chunks": n_chunks, "total_ops": total_ops},
    }
    north.finish(flags, table, device, equal,
                 "the stream's state differs from fold_payloads'")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
