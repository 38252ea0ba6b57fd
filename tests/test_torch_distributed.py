"""The port's process layer (``crdt_enc_tpu_torch/parallel/
distributed.py``) against the JAX package's, and two real gloo
processes.

In one process, process boundaries are faked through ``local_count``,
as tests/test_distributed.py does: an 8-device "pod" of 4 hosts × 2
devices puts hosts on ``dp`` and each host's devices on ``mp``, and the
assembled batch folds to the JAX package's planes.  Then this file runs
itself as the worker of two ``torch.distributed`` processes on the CPU
(gloo, rendezvous through a file in ``tmp_path``), as
tests/test_distributed_2proc.py runs two ``jax.distributed`` ones: a
sharded fold of rows split between the ranks (``all_reduce(MAX)``
across them), and the ``Core`` lifecycle over one shared remote with
mesh-backed observers on both ranks and a concurrent compaction.

    python tests/test_torch_distributed.py RANK INIT_FILE [fold|lifecycle DIR]
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:  # the worker runs this file as a script
    sys.path.insert(0, _REPO)

from crdt_enc_tpu_torch.ops import orset as O  # noqa: E402
from crdt_enc_tpu_torch.ops.lww import lww_fold  # noqa: E402
from crdt_enc_tpu_torch.parallel import distributed  # noqa: E402
from crdt_enc_tpu_torch.parallel import mesh as pmesh  # noqa: E402

CPU = torch.device("cpu")
WORKER_TIMEOUT_S = 120


def op_columns(n, R, E, seed=0):
    """Coherent per-actor dots: adds count up, removes cover what the
    actor has added (a remove with nothing to cover pads)."""
    rng = np.random.default_rng(seed)
    kind = (rng.random(n) < 0.25).astype(np.int8)
    member = rng.integers(0, E, n, dtype=np.int32)
    actor = rng.integers(0, R, n, dtype=np.int32)
    counter = np.zeros(n, np.int32)
    seen = np.zeros(R, np.int32)
    for i in range(n):
        a = actor[i]
        if kind[i] == 0:
            seen[a] += 1
            counter[i] = seen[a]
        else:
            if seen[a] == 0:
                actor[i] = R
            counter[i] = seen[a]
    return kind, member, actor, counter


def plain_fold(cols, E, R):
    z = torch.zeros
    return O.orset_fold_plain(
        z(R, dtype=torch.int32), z((E, R), dtype=torch.int32),
        z((E, R), dtype=torch.int32), *map(torch.from_numpy, cols),
        num_members=E, num_replicas=R)


# ---- one process ---------------------------------------------------------------


@pytest.fixture
def no_cluster(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)


def test_initialize_without_configuration_stays_single_process(no_cluster):
    assert distributed.initialize() is False
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("case", ["partial", "no_card", "bad_url"])
def test_initialize_with_explicit_configuration_raises(no_cluster, case,
                                                       monkeypatch):
    """A misconfigured rank dies loudly instead of running alone."""
    if case == "partial":
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="rank"):
            distributed.initialize()
    elif case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize("localhost:1", 1, 0)
    else:
        with pytest.raises(RuntimeError, match="rendezvous"):
            distributed.initialize("bogus://nowhere", 1, 0, device="cpu")
    assert not torch.distributed.is_initialized()


def test_multihost_mesh_places_hosts_on_dp():
    import jax

    from crdt_enc_tpu.parallel import distributed as jdist

    devices = [torch.device("cpu")] * 8
    mesh = distributed.make_multihost_mesh(devices, local_count=2)
    ref = jdist.make_multihost_mesh(local_count=2)
    assert mesh.shape == dict(ref.shape) == {"dp": 4, "mp": 2}
    assert [len(row) for row in mesh.devices] == [2] * 4
    assert not mesh.spans_processes
    one = distributed.make_multihost_mesh(devices)
    assert one.shape == dict(jdist.make_multihost_mesh().shape)
    with pytest.raises(ValueError, match="do not split"):
        distributed.make_multihost_mesh(devices, local_count=3)
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("rows_per_host", [None, 64])
def test_global_batch_fold_matches_the_jax_batch_fold(rows_per_host):
    """Batch assembly → sharded fold over a fake 4-host mesh, against the
    JAX package's on the same columns (93 rows: sentinel padding)."""
    from crdt_enc_tpu.parallel import distributed as jdist
    from crdt_enc_tpu.parallel import mesh as jmesh

    R, E = 4, 8
    cols = op_columns(93 if rows_per_host is None else 40, R, E, seed=3)
    kw = {} if rows_per_host is None else {"rows_per_host": rows_per_host}
    mesh = distributed.make_multihost_mesh([CPU] * 8, local_count=2)
    batch = distributed.global_op_batch(mesh, *cols, num_replicas=R, **kw)
    assert len(batch[0]) % mesh.shape["dp"] == 0
    if rows_per_host:
        assert len(batch[0]) == rows_per_host * mesh.shape["dp"]
    planes = distributed.replicate(
        mesh, np.zeros(R, np.int32), np.zeros((E, R), np.int32),
        np.zeros((E, R), np.int32))
    got = pmesh.orset_fold_sharded(mesh, *planes, *batch)
    jm = jdist.make_multihost_mesh(local_count=2)
    jbatch = jdist.global_op_batch(jm, *cols, num_replicas=R, **kw)
    jplanes = jdist.replicate(jm, *(p.numpy() for p in planes))
    ref = jmesh.orset_fold_sharded(jm, *jplanes, *jbatch)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    for g, w in zip(got, plain_fold(cols, E, R)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="cannot hold"):
        distributed.global_op_batch(mesh, *cols, num_replicas=R,
                                    rows_per_host=2)


# ---- two gloo processes --------------------------------------------------------


def _run_workers(tmp_path, mode, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(var, None)
    init = str(tmp_path / "rendezvous")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), init, mode,
             *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"rank {rank} exited {p.returncode}\nstdout:\n{out}\n"
            f"stderr:\n{err[-4000:]}")
        assert f"DIST_OK rank={rank}" in out, (rank, out, err[-4000:])


def test_two_process_fold(tmp_path):
    _run_workers(tmp_path, "fold")


def test_two_process_core_lifecycle(tmp_path):
    """Each rank writes through its own replica into one fs remote; both
    open mesh-backed observers whose folds reduce across the ranks,
    check each other's bytes and a host replica's, compact at the same
    time, and a fresh host replica reads the compacted remote back."""
    _run_workers(tmp_path, "lifecycle", str(tmp_path / "shared"))


# ---- the worker ----------------------------------------------------------------


def _worker_fold(rank: int, mesh) -> None:
    E, R, N = 16, 8, 101
    cols = op_columns(N, R, E, seed=7)
    cut = 55  # uneven halves: the row counts reduce to their max
    lo, hi = (0, cut) if rank == 0 else (cut, N)
    batch = distributed.global_op_batch(
        mesh, *(c[lo:hi] for c in cols), num_replicas=R)
    assert len(batch[0]) == cut  # padded to the larger half
    planes = distributed.replicate(
        mesh, np.zeros(R, np.int32), np.zeros((E, R), np.int32),
        np.zeros((E, R), np.int32))
    for impl in ("scatter", "fold"):
        got = pmesh.orset_fold_sharded(mesh, *planes, *batch, impl=impl)
        for g, w, name in zip(got, plain_fold(cols, E, R),
                              ("clock", "add", "rm")):
            assert torch.equal(g, w), (impl, name)
    # a gather leg: the LWW tables of both ranks merge in dp order
    rng = np.random.default_rng(11)
    Kk, n = 20, 64
    lww = [rng.integers(0, k, n).astype(np.int32)
           for k in (Kk + 1, 4, 50, 6, 30)]
    mine = [torch.from_numpy(c[rank * n // 2:(rank + 1) * n // 2])
            for c in lww]
    got = pmesh.lww_fold_sharded(mesh, *mine, num_keys=Kk)
    whole = lww_fold(*map(torch.from_numpy, lww), num_keys=Kk)
    assert all(torch.equal(g, w) for g, w in zip(got, whole))


def _worker_lifecycle(rank: int, mesh, shared: str) -> None:
    import asyncio
    from pathlib import Path

    import torch.distributed as dist

    from crdt_enc_tpu_torch import (
        Core,
        FsStorage,
        OpenOptions,
        PassphraseKeyCryptor,
        TorchAccelerator,
        XChaChaCryptor,
        orset_adapter,
    )
    from crdt_enc_tpu_torch.core.adapters import HostAccelerator
    from crdt_enc_tpu_torch.utils import codec
    from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

    root = Path(shared)
    root.mkdir(parents=True, exist_ok=True)

    async def open_replica(local, accel):
        return await Core.open(OpenOptions(
            storage=FsStorage(str(root / local), str(root / "remote")),
            cryptor=XChaChaCryptor(), key_cryptor=PassphraseKeyCryptor("pw"),
            adapter=orset_adapter(),
            supported_data_versions=(DEFAULT_DATA_VERSION_1,),
            current_data_version=DEFAULT_DATA_VERSION_1, create=True,
            accelerator=accel,
        ))

    def canon(core) -> bytes:
        return core.with_state(lambda s: codec.pack(s.to_obj()))

    async def scenario():
        # rank 0 creates the remote and its sealing key first
        if rank == 1:
            dist.barrier()
        w = await open_replica(f"w{rank}", HostAccelerator())
        if rank == 0:
            dist.barrier()
        else:
            await w.read_remote()
        for i in range(30):
            item = f"r{rank}-item{i}".encode()
            await w.update(lambda s, item=item: s.add_ctx(w.actor_id, item))
        for i in (3, 7):
            item = f"r{rank}-item{i}".encode()
            op = w.with_state(lambda s, item=item: s.rm_ctx(item))
            await w.update(lambda s, op=op: op)
        dist.barrier()
        # the observers fold on the two-process mesh, in lockstep
        accel = TorchAccelerator(min_device_batch=1, mesh=mesh)
        assert accel._mesh_active() and mesh.spans_processes
        obs = await open_replica(f"obs{rank}", accel)
        folds = []
        real = pmesh.orset_fold_sharded
        pmesh.orset_fold_sharded = lambda *a, **kw: folds.append(1) or \
            real(*a, **kw)
        try:
            await obs.read_remote()
        finally:
            pmesh.orset_fold_sharded = real
        assert folds, "the observer's fold did not take the mesh"
        obs_bytes = canon(obs)
        assert obs.with_state(lambda s: len(list(s.members()))) == 2 * 28
        (root / f"state-obs{rank}").write_bytes(obs_bytes)
        dist.barrier()
        other = (root / f"state-obs{1 - rank}").read_bytes()
        assert other == obs_bytes, "mesh observers diverged across ranks"
        host = await open_replica(f"host{rank}", HostAccelerator())
        await host.read_remote()
        assert canon(host) == obs_bytes, "host replica != mesh fold"
        await obs.compact()  # both ranks at once
        dist.barrier()
        ver = await open_replica(f"ver{rank}", HostAccelerator())
        await ver.read_remote()
        assert canon(ver) == obs_bytes, "post-compact state diverged"

    asyncio.run(scenario())


def _worker(argv) -> int:
    import torch.distributed as dist

    rank, init = int(argv[1]), argv[2]
    mode = argv[3] if len(argv) > 3 else "fold"
    assert distributed.initialize(f"file://{init}", 2, rank, device="cpu")
    assert distributed.initialize(f"file://{init}", 2, rank, device="cpu")
    try:
        mesh = distributed.make_multihost_mesh([CPU, CPU])
        assert mesh.shape == {"dp": 2, "mp": 2} and mesh.spans_processes
        if mode == "lifecycle":
            _worker_lifecycle(rank, mesh, argv[4])
        else:
            _worker_fold(rank, mesh)
    finally:
        dist.destroy_process_group()
    print(f"DIST_OK rank={rank}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv))
