"""The real compaction end to end over encrypted files, card against host.

The twin of the JAX package's ``benchmarks/compaction_e2e.py``: writers
populate a remote directory of sealed op files through the port's own
``Core``, then a fresh replica's ``open → read_remote → compact`` is
timed wall to wall (listing, reading, decrypting, decoding, folding,
merging, sealing the snapshot, GC), once with ``HostAccelerator`` (the
host loop) and twice with ``TorchAccelerator`` on the card (a cold
process, which loads the kernels, then a warm one), each in its own child
process on a byte-identical copy of the remote, so each peak RSS is its
own.  The three compacted states must be byte-equal (else exit 1).

``--snapshots S`` (default 8, as ``chip_smoke.py``'s phase 10; 0 is the
JAX bench's shape) has S further replicas each compact a copy of the
remote that holds one writer's op files and move the snapshot into the
remote, so the timed compaction merges S + 1 states (K4, the S-way
snapshot merge, at three or more) before it folds the op files.

Run:  python3 -m crdt_enc_tpu_torch.benchmarks.compaction_e2e
      [--writers N] [--files N] [--ops-per-file K] [--members M]
      [--snapshots S] [--device cuda|cpu] [--record PATH] [--skip-host]
      [--smoke]

Prints one JSON line (``metric`` ``compaction_e2e_ops_per_sec``; the JAX
record's ``tpu_*`` fields are ``device_*`` here) with the card, the
kernel launches of the warm card compaction and the wall of each.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from .. import bench as north
from ..bench import log

MODULE = "crdt_enc_tpu_torch.benchmarks.compaction_e2e"
REPO_ROOT = os.path.dirname(north.PACKAGE_DIR)


def _options(local: str, remote: str, accel):
    from ..backends import FsStorage

    return north.orset_options(FsStorage(local, remote), None,
                               accelerator=accel)


async def build_remote(root: Path, n_writers: int, files_per_writer: int,
                       ops_per_file: int, n_members: int,
                       n_snapshots: int) -> int:
    """Writers populate the shared remote through the port's ``Core``;
    then ``n_snapshots`` replicas each seal a snapshot of one writer's
    files into it.  Returns the op count."""
    from ..core.core import Core
    from ..core.adapters import HostAccelerator

    remote = root / "remote"
    total = 0
    actors = []
    for w in range(n_writers):
        core = await Core.open(_options(str(root / f"w{w}"), str(remote),
                                        HostAccelerator()))
        actors.append(core.actor_id)
        for _ in range(files_per_writer):
            def build(s, w=w):
                ops = []
                for j in range(ops_per_file):
                    m = (total + j * 7 + w) % n_members
                    if j % 9 == 8 and s.contains(m):
                        ops.append(s.rm_ctx(m))
                    else:
                        ops.append(s.add_ctx(core.actor_id, m))
                    s.apply(ops[-1])
                return ops

            ops = await core.update(build)
            total += len(ops)
    states = remote / "states"
    states.mkdir(exist_ok=True)
    for i in range(min(n_snapshots, n_writers)):
        side = root / f"snap{i}"
        shutil.copytree(remote, side)
        for d in (side / "ops").iterdir():
            if d.name != actors[i].hex():
                shutil.rmtree(d)
        for f in (side / "states").iterdir():
            f.unlink()
        sealer = await Core.open(_options(str(root / f"sealer{i}"), str(side),
                                          HostAccelerator()))
        await sealer.compact()
        (name,) = os.listdir(side / "states")
        shutil.move(str(side / "states" / name), str(states / name))
        shutil.rmtree(side)
    return total


async def timed_compact(local: Path, remote: Path, kind: str):
    """One timed compaction of a fresh replica: ``kind`` is ``host``
    (``HostAccelerator``), ``cuda`` or ``cpu`` (``TorchAccelerator``)."""
    from ..core.core import Core
    from ..core.adapters import HostAccelerator
    from ..models import canonical_bytes
    from ..parallel.accel import TorchAccelerator

    accel = (HostAccelerator() if kind == "host"
             else TorchAccelerator(device=kind))
    t0 = time.perf_counter()
    core = await Core.open(_options(str(local), str(remote), accel))
    await core.compact()
    wall = time.perf_counter() - t0
    return wall, core.with_state(canonical_bytes)


def compact_one(local: str, remote: str, kind: str) -> dict:
    """The child's side: one timed compaction, its peak RSS, the state's
    digest, the kernel launches and the spans."""
    import hashlib
    import resource

    from ..utils import trace

    if kind != "host":
        north.warm_kernels(__import__("torch").device(kind))
    north.reset_launches()
    trace.reset()
    wall, state_bytes = asyncio.run(timed_compact(Path(local), Path(remote),
                                                  kind))
    snap = trace.snapshot()
    return {
        "wall": wall,
        "rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "digest": hashlib.sha256(state_bytes).hexdigest(),
        "launches": north.read_launches(),
        "spans": {k: round(v["seconds"], 3)
                  for k, v in sorted(snap["spans"].items())},
        "counters": snap["counters"],
    }


def _child(args: list) -> str:
    r = subprocess.run([sys.executable, "-m", MODULE, *args], cwd=REPO_ROOT,
                       capture_output=True, text=True)
    if r.returncode != 0:
        log(r.stderr[-4000:])
        raise RuntimeError(f"child {args[:1]} failed ({r.returncode})")
    return r.stdout.strip().splitlines()[-1]


def main(argv: list | None = None) -> int:
    ap = argparse.ArgumentParser(prog=f"python3 -m {MODULE}")
    ap.add_argument("--writers", type=int, default=32)
    ap.add_argument("--files", type=int, default=64, help="files per writer")
    ap.add_argument("--ops-per-file", type=int, default=48)
    ap.add_argument("--members", type=int, default=512)
    ap.add_argument("--snapshots", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--record", default=None)
    ap.add_argument("--build-into", help=argparse.SUPPRESS)
    ap.add_argument("--compact-one", nargs=3, help=argparse.SUPPRESS,
                    metavar=("LOCAL", "REMOTE", "KIND"))
    ap.add_argument("--smoke", action="store_true",
                    help="4 writers x 8 files x 24 ops, 64 members, "
                    "2 snapshots")
    ap.add_argument("--skip-host", action="store_true",
                    help="skip the host-loop compaction; byte equality is "
                    "then cold == warm only")
    args = ap.parse_args(argv)
    if args.smoke:
        args.writers, args.files, args.ops_per_file = 4, 8, 24
        args.members, args.snapshots = 64, 2

    if args.build_into:
        print(asyncio.run(build_remote(
            Path(args.build_into), args.writers, args.files,
            args.ops_per_file, args.members, args.snapshots)))
        return 0
    if args.compact_one:
        print(json.dumps(compact_one(*args.compact_one)))
        return 0

    flags = ["--device", args.device] + (
        ["--record", args.record] if args.record else [])
    device = north.acquire_device(flags, "compaction_e2e_ops_per_sec",
                                  "ops/s")
    base = Path(tempfile.mkdtemp(prefix="compact-e2e-"))
    try:
        log(f"building remote: {args.writers} writers x {args.files} files "
            f"x {args.ops_per_file} ops, {args.snapshots} snapshots")
        # the builder holds every op object: a child, so this process's
        # children measure the compactions alone
        total = int(_child(["--build-into", str(base),
                            "--writers", str(args.writers),
                            "--files", str(args.files),
                            "--ops-per-file", str(args.ops_per_file),
                            "--members", str(args.members),
                            "--snapshots", str(args.snapshots)]))
        n_files = args.writers * args.files
        remote = base / "remote"
        for copy in ("remote-cold", "remote-warm"):
            shutil.copytree(remote, base / copy)

        def child(local: str, remote_dir: Path, kind: str) -> dict:
            return json.loads(_child(["--compact-one", str(base / local),
                                      str(remote_dir), kind]))

        host = None if args.skip_host else child("reader-host", remote,
                                                 "host")
        cold = child("reader-cold", base / "remote-cold", device.type)
        warm = child("reader-warm", base / "remote-warm", device.type)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    equal = cold["digest"] == warm["digest"] and (
        host is None or host["digest"] == cold["digest"])
    rec = {
        "metric": "compaction_e2e_ops_per_sec",
        "config": f"compaction_e2e_{n_files}f_{args.snapshots}s",
        "n_files": n_files, "n_ops": total,
        "device_wall_s": round(warm["wall"], 3),
        "device_cold_wall_s": round(cold["wall"], 3),
        "value": round(total / warm["wall"], 1), "unit": "ops/s",
        "byte_equal": bool(equal),
        "device_rss_mb": round(warm["rss_mb"], 1),
        "device_spans": warm["spans"],
        "method": "host_wall_end_to_end",
        "shape": {"writers": args.writers, "files": args.files,
                  "ops_per_file": args.ops_per_file,
                  "members": args.members, "snapshots": args.snapshots},
    }
    if host is not None:
        rec.update(host_wall_s=round(host["wall"], 3),
                   vs_baseline=round(host["wall"] / warm["wall"], 2),
                   host_rss_mb=round(host["rss_mb"], 1),
                   host_spans=host["spans"])
    north.finish(flags, rec, device, equal,
                 "the compacted states differ between the children",
                 launches=warm["launches"],
                 counters={"device": warm["counters"],
                           **({"host": host["counters"]} if host else {})})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
