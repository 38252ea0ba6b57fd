"""Multi-process execution: the rendezvous, process-aware meshes and
global op batches.

The port's counterpart of ``crdt_enc_tpu/parallel/distributed.py``.
JAX stretches one single-controller program across processes with
``jax.distributed``; PyTorch runs one process per rank, so here the
process axis is a ``torch.distributed`` group:

* :func:`initialize` — the rendezvous (``dist.init_process_group``),
  idempotent through ``dist.is_initialized()``, from explicit arguments
  or torch's standard variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``).  NCCL for a card (the default), gloo for
  ``device="cpu"``.
* :func:`make_multihost_mesh` — a ``(dp, mp)`` mesh with the processes
  on ``dp`` and each process's devices on ``mp``.  Op rows shard over
  ``dp``, so each process folds only the rows it decoded; the fold's
  cross-process collective is the max of the partial planes over dp
  (``dist.all_reduce(MAX)``), the data-parallel all-reduce shape.
* :func:`global_op_batch` — this process's rows of the globally
  dp-sharded op batch, sentinel-padded to the rows every process holds.

Typical multi-process compaction::

    distributed.initialize()                    # MASTER_ADDR, RANK, ...
    mesh = distributed.make_multihost_mesh()
    batch = distributed.global_op_batch(mesh, kind, member, actor, counter,
                                        num_replicas=R)
    clock, add, rm = pmesh.orset_fold_sharded(mesh, clock0, add0, rm0,
                                              *batch)

Several cards on one host, or several hosts, cannot be measured on a
one-card machine; tests/test_torch_distributed.py runs two gloo
processes on the CPU.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from ..ops.columnar import OrsetColumns, pad_orset_rows
from ..utils import trace
from .mesh import Mesh, _tensor, _to, cuda_devices

logger = logging.getLogger("crdt_enc_tpu_torch.distributed")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *, device: str = "cuda",
               **kwargs) -> bool:
    """Join the process group of a multi-process run.

    ``coordinator_address`` is ``host:port`` (or a ``tcp://`` or
    ``file://`` URL); the arguments default to ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  With explicit
    configuration (arguments or variables) the rendezvous is mandatory
    and a failure raises: a misconfigured rank must die loudly, not run
    alone while its peers wait.  With none at all this is a
    single-process run and returns False (PyTorch detects no cluster on
    its own).  Returns True iff the group is up after the call; safe to
    call more than once.

    ``device="cuda"`` (the default) joins with NCCL on the card
    ``LOCAL_RANK`` names (else ``rank % device_count``) and raises
    without one; ``device="cpu"`` joins with gloo.  ``kwargs`` go to
    ``dist.init_process_group`` (``timeout``, ...)."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '')}")
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if (coordinator_address is None and num_processes is None
            and process_id is None):
        logger.info("no process group configured; running single-process")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize: set the coordinator address, the process count "
            "and this process's rank (or MASTER_ADDR/MASTER_PORT, "
            "WORLD_SIZE, RANK); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    device = torch.device(device)
    if device.type == "cuda":
        local = cuda_devices()
        backend = "nccl"
        idx = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local[(process_id if idx is None else idx)
                                    % len(local)])
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize: unsupported device {device}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    return True


def make_multihost_mesh(devices=None, local_count: int | None = None) -> Mesh:
    """A ``(dp, mp)`` mesh with the processes along ``dp`` and each
    process's devices along ``mp``.

    In a process group (:func:`initialize`), ``devices`` are this
    process's own (default: its card under NCCL, the CPU under gloo) and
    the mesh spans the group's processes, one dp row each; its dp
    reductions then take a cross-process leg (``dist.all_reduce``), even
    in a group of one.  Without a group, ``devices`` (default: the
    visible cards) form ``(n // local_count, local_count)``:
    ``local_count`` fakes process boundaries for tests, and by default
    one host gives ``(1, n)``, every device on the plane axis."""
    import torch.distributed as dist

    if dist.is_initialized():
        if devices is None:
            if dist.get_backend() == "nccl":
                devices = [torch.device("cuda", torch.cuda.current_device())]
            else:
                devices = [torch.device("cpu")]
        return Mesh([list(devices)], processes=dist.get_world_size(),
                    rank=dist.get_rank(), group=dist.group.WORLD)
    devices = cuda_devices() if devices is None else list(devices)
    if local_count is None:
        local_count = len(devices)
    n = len(devices)
    if n % local_count:
        raise ValueError(f"{n} devices do not split into hosts of "
                         f"{local_count}")
    return Mesh([devices[h * local_count:(h + 1) * local_count]
                 for h in range(n // local_count)])


def _upload(mesh: Mesh, columns) -> tuple:
    """Host columns → tensors on ``mesh.home``, counted at issue where
    they cross to a card."""
    if mesh.home.type == "cuda":
        n = sum(x.nbytes for x in columns)
        trace.add("h2d_bytes", n)
        trace.add("h2d_pageable_bytes", n)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(mesh.home)
                 for x in columns)


def global_op_batch(mesh: Mesh, kind, member, actor, counter,
                    num_replicas: int, rows_per_host: int | None = None):
    """This process's part of the globally ``dp``-sharded op columns.

    Each process passes only the rows it decoded; process i's rows are
    dp shard i, so no process gathers the whole batch.  Every process
    must hold the same row count, so rows are sentinel-padded
    (``actor == num_replicas``) up to ``rows_per_host``, which defaults
    to the max over the processes (one ``dist.all_reduce(MAX)`` of the
    counts).  Without a cross-process mesh the whole batch is local: it
    pads so the row count divides dp (or fills ``rows_per_host`` per dp
    shard).  Returns ``(kind, member, actor, counter)`` tensors on
    ``mesh.home``, the form ``mesh.orset_fold_sharded`` takes."""
    cols = OrsetColumns(
        np.asarray(kind, np.int8),
        np.asarray(member, np.int32),
        np.asarray(actor, np.int32),
        np.asarray(counter, np.int32),
    )
    dp = mesh.shape["dp"]
    n_local = len(cols.kind)
    if rows_per_host is not None:
        # single-process the bucket spans every dp shard; across
        # processes it holds just this process's rows
        capacity = rows_per_host * (mesh.local_dp if mesh.spans_processes
                                    else dp)
        if capacity < n_local:
            raise ValueError(
                f"rows_per_host={rows_per_host} cannot hold {n_local} rows"
            )
    if not mesh.spans_processes:
        target = (rows_per_host * dp if rows_per_host is not None
                  else -(-n_local // dp) * dp)
        pad_orset_rows(cols, target, num_replicas)
        return _upload(mesh, (cols.kind, cols.member, cols.actor,
                              cols.counter))
    if dp != mesh.process_count:
        raise ValueError(
            f"multi-process batches need the dp axis ({dp}) to equal the "
            f"process count ({mesh.process_count}): one dp shard per "
            "process (make_multihost_mesh builds exactly this)"
        )
    if rows_per_host is None:
        import torch.distributed as dist

        count = torch.tensor([n_local], dtype=torch.int64, device=mesh.home)
        dist.all_reduce(count, op=dist.ReduceOp.MAX, group=mesh.group)
        rows_per_host = int(count.item())
    pad_orset_rows(cols, rows_per_host, num_replicas)
    # this process's shard of the global batch, counted at issue like the
    # single-process branch (each process counts its own contribution)
    return _upload(mesh, (cols.kind, cols.member, cols.actor, cols.counter))


def replicate(mesh: Mesh, *arrays):
    """Place arrays on the mesh replicated (clocks, initial planes):
    tensors on ``mesh.home``, each shard reads its part from there."""
    out = tuple(_to(_tensor(a), mesh.home) for a in arrays)
    return out if len(out) != 1 else out[0]
