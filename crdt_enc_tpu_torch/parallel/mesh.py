"""Sharded fold and merge over a ``(dp, mp)`` device mesh.

The port's counterpart of ``crdt_enc_tpu/parallel/mesh.py``.  Op rows
shard over ``dp`` (each shard folds its slice of the flattened rows) and
the state planes over ``mp`` (each shard owns a contiguous member range
of the ``(E, R)`` planes).  The fold is an elementwise-max semigroup, so
the shards combine with a max over ``dp``.

JAX's ``shard_map`` runs one program over every local device from one
process; ``torch.distributed`` runs one process per rank, and NCCL
refuses two ranks on one card.  So the mesh here is in-process:
:class:`Mesh` is a grid of ``torch.device`` s (a device may appear more
than once: ``[cpu] * 8`` in the tests, ``[cuda:0] * 4`` on one card),
each ``*_sharded`` function splits its inputs as the JAX ``in_specs``
say, runs the per-shard body on that shard's device, and combines the
shards explicitly: ``pmax``/``pmin``/``psum`` over ``dp`` are
``torch.maximum``/``minimum``/sum reductions of the dp partials, an
``all_gather`` is a concatenation in dp order.  Results come back
assembled on the mesh's first device, as JAX returns global arrays.

A mesh whose ``dp`` axis spans processes (``distributed.
make_multihost_mesh``) holds this process's dp rows only.  Under it,
every argument sharded over ``dp`` is this process's part (op rows, as
``distributed.global_op_batch`` returns them; tenant lanes; MVReg
candidates), replicated results are global (the cross-process leg of a
dp reduction is ``dist.all_reduce``, of a gather ``dist.all_gather``),
and dp-sharded results are this process's part.

On CUDA tensors every per-shard body launches the port's kernels (K1
``orset_scatter``, K2 ``orset_fold_cuda``, K5 ``lww_fold_cuda``) or
raises; the plain versions serve CPU tensors only.  The cross-shard
combines and the fold clock are plain PyTorch, as they are XLA, not
Pallas, in the JAX package.

Left out of the copy: ``sharded_fold_cap`` (it sizes a Pallas tile; the
CUDA kernels take no tile cap) and the jit step caches
``tenant_fold_steps`` / ``tenant_diff_step`` (eager PyTorch compiles
nothing: the service calls the sharded functions directly).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.columnar import KIND_ADD, pad_orset_rows
from ..ops.counters import gcounter_fold_tenants, pncounter_fold
from ..ops.lww import lww_fold, lww_table_merge
from ..ops.mvreg import dominance_block
from ..ops.orset import (
    orset_fold,
    orset_merge,
    orset_plane_diff,
    tenant_columns,
)
from ..ops.orset_fold_cuda import orset_scatter
from ..utils import trace


class Mesh:
    """A ``(dp, mp)`` grid of torch devices.

    ``devices`` is this process's rows of the grid (a list of rows, each a
    list of ``mp`` devices).  ``processes`` and ``group`` make the ``dp``
    axis span the processes of a ``torch.distributed`` group (one dp row
    block each, in rank order; ``distributed.make_multihost_mesh`` builds
    such a mesh), and then the dp reductions and gathers take a
    cross-process leg, even in a group of one.  ``shape``, ``size`` and
    ``axis_names`` describe the global mesh, as a JAX mesh's do."""

    axis_names = ("dp", "mp")

    def __init__(self, devices, *, processes: int = 1, rank: int = 0,
                 group=None):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("a mesh wants a non-empty rectangular device grid")
        self.devices = grid
        self.local_dp = len(grid)
        self.process_count = int(processes)
        self.process_index = int(rank)
        self.group = group
        self.spans_processes = group is not None or self.process_count > 1
        self.shape = {"dp": self.local_dp * self.process_count,
                      "mp": len(grid[0])}
        self.size = self.shape["dp"] * self.shape["mp"]

    @property
    def home(self) -> torch.device:
        """The device results are assembled on (shard (0, 0)'s)."""
        return self.devices[0][0]

    def __repr__(self) -> str:
        procs = (f", processes={self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh(dp={self.shape['dp']}, mp={self.shape['mp']}, "
                f"home={self.home}{procs})")


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``"dp=N[,mp=M]"`` → ``(dp, mp)``.  The one parser behind every
    ``--mesh`` flag: raises ``ValueError`` on malformed specs,
    non-positive axes, or a single-device mesh (``dp·mp < 2``: a size-1
    "mesh" would silently run the unsharded path, which a flag asking
    for sharding must never do)."""
    dp, mp = 1, 1
    for part in spec.split(","):
        k, _, v = part.partition("=")
        if k == "dp":
            dp = int(v)
        elif k == "mp":
            mp = int(v)
        else:
            raise ValueError(f"unknown mesh axis {k!r} (want dp=N[,mp=M])")
    if dp < 1 or mp < 1 or dp * mp < 2:
        raise ValueError(
            f"mesh wants positive axes and at least 2 devices, got "
            f"dp={dp},mp={mp}"
        )
    return dp, mp


def cuda_devices() -> list:
    """The visible CUDA devices; raises where there are none (a mesh
    never falls back to the CPU silently)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        raise RuntimeError(
            "no CUDA device is visible; pass devices=[torch.device('cpu')] "
            "* n to build a mesh of CPU shards"
        )
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(shape: tuple[int, int] | None = None, devices=None) -> Mesh:
    """A ``(dp, mp)`` mesh over ``devices`` (default: the visible CUDA
    devices, all on the dp axis; raises without one).  A device may be
    listed more than once: each listing is one shard."""
    devices = cuda_devices() if devices is None else list(devices)
    if shape is None:
        shape = (len(devices), 1)
    dp, mp = shape
    if dp < 1 or mp < 1 or len(devices) < dp * mp:
        raise ValueError(
            f"a ({dp}, {mp}) mesh needs {dp * mp} devices, got {len(devices)}"
        )
    return Mesh([devices[d * mp:(d + 1) * mp] for d in range(dp)])


def mesh_for_population(n_lanes: int, devices=None) -> Mesh | None:
    """The population runner's mesh (sim/population.py): schedule×tenant
    lanes ride ``dp`` and the replica planes ``mp``: dp = min(n_lanes,
    D), mp = D // dp when that divides, else a flat (D, 1).  None on a
    single device: the unsharded path is the one-device layout, and a
    size-1 mesh must not pretend otherwise."""
    devices = cuda_devices() if devices is None else list(devices)
    n_dev = len(devices)
    if n_dev < 2:
        return None
    dp = max(1, min(int(n_lanes), n_dev))
    mp = n_dev // dp if n_dev % dp == 0 else 1
    return make_mesh((dp, mp), devices=devices[: dp * mp])


# ------------------------------------------------------------- plumbing
def _tensor(x) -> torch.Tensor:
    """numpy → a CPU tensor (no copy); tensors pass through."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a host-to-card move counts ``h2d_bytes``."""
    if x.device == device:
        return x
    if x.device.type == "cpu" and device.type == "cuda":
        trace.add("h2d_bytes", x.nbytes)
    return x.to(device)


def _dist():
    import torch.distributed as dist

    return dist


def _reduce(mesh: Mesh, parts: list, op: str) -> torch.Tensor:
    """The dp reduction of one partial per local dp row (``max``,
    ``min`` or ``sum``), on the first part's device; across processes
    through ``dist.all_reduce``."""
    fn = {"max": torch.maximum, "min": torch.minimum, "sum": torch.add}[op]
    acc = parts[0]
    for p in parts[1:]:
        acc = fn(acc, p.to(acc.device))
    if mesh.spans_processes:
        dist = _dist()
        acc = acc.contiguous()
        rop = {"max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
               "sum": dist.ReduceOp.SUM}[op]
        dist.all_reduce(acc, op=rop, group=mesh.group)
    return acc


def _gather(mesh: Mesh, parts: list) -> list:
    """Every dp row's part in dp order (an ``all_gather``): this process's
    parts, and across processes the others' through ``dist.all_gather``
    (equal shapes)."""
    if not mesh.spans_processes:
        return parts
    dist = _dist()
    mine = torch.stack([p.to(parts[0].device) for p in parts])
    is_bool = mine.dtype == torch.bool
    if is_bool:  # the collectives take no bool tensors
        mine = mine.to(torch.uint8)
    out = [torch.empty_like(mine) for _ in range(mesh.process_count)]
    dist.all_gather(out, mine, group=mesh.group)
    return [p.bool() if is_bool else p
            for block in out for p in block.unbind(0)]


def _split(x: torch.Tensor, n: int) -> list:
    """``x`` cut into ``n`` equal contiguous blocks along dim 0."""
    step = x.shape[0] // n
    return [x[i * step:(i + 1) * step] for i in range(n)]


def _check_rows(what: str, n: int, dp: int, mesh: Mesh) -> None:
    if n % mesh.local_dp:
        raise ValueError(f"pad first: {what} {n} % dp {dp}")


def process_rows(mesh: Mesh, *cols):
    """This process's block of global dp-sharded columns (the columns
    themselves on a single-process mesh): process p holds rows
    ``[p·n/P, (p+1)·n/P)``, its dp shards, as a globally dp-sharded JAX
    array lays them out.  The row count must divide the global dp."""
    if not mesh.spans_processes:
        return cols
    p, P = mesh.process_index, mesh.process_count
    out = []
    for c in cols:
        n = len(c)
        if n % mesh.shape["dp"]:
            raise ValueError(f"pad first: rows {n} % dp {mesh.shape['dp']}")
        out.append(c[p * n // P:(p + 1) * n // P])
    return tuple(out)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`process_rows`: this process's block of a
    dp-sharded result concatenated with every other process's, in rank
    order (``x`` itself on a single-process mesh)."""
    if not mesh.spans_processes:
        return x
    return torch.cat(_gather(mesh, [x]))


def pad_rows_for_mesh(cols, dp: int, num_replicas: int):
    """Pad flattened op columns so the row count divides the dp axis."""
    n = len(cols.kind)
    target = ((n + dp - 1) // dp) * dp
    return pad_orset_rows(cols, target, num_replicas)


# ------------------------------------------------------------ OR-Set fold
def _rows_clock(kind, actor, counter, R: int) -> torch.Tensor:
    """The per-actor max add counter over EVERY live add row (the fold
    clock's column max, before the max with ``clock0``), zero where an
    actor has none.  Plain PyTorch on the rows' device."""
    live = (kind == KIND_ADD) & (actor >= 0) & (actor < R)
    zero = torch.zeros((), dtype=torch.int32, device=actor.device)
    clock = torch.zeros(R, dtype=torch.int32, device=actor.device)
    if actor.shape[0]:
        clock.scatter_reduce_(0, torch.where(live, actor, zero).long(),
                              torch.where(live, counter, zero),
                              reduce="amax")
    return clock


def _slice_rows(member, actor, member_lo: int, E_local: int, R: int):
    """Member-local rows of one mp shard: the member index within the
    slice (clamped) and the actor, turned into padding (``R``) for rows
    outside the slice."""
    local = member - member_lo
    in_slice = (local >= 0) & (local < E_local) & (actor < R)
    pad = torch.full((), R, dtype=torch.int32, device=actor.device)
    return (local.clamp(0, max(E_local - 1, 0)).to(torch.int32),
            torch.where(in_slice, actor, pad))


def _local_fold(clock0, add0, rm0, kind, member, actor, counter, member_lo,
                R: int, impl: str):
    """Per-shard body: fold this dp shard's rows into its member slice.

    ``add0``/``rm0`` are the shard's ``(E_local, R)`` slice; rows outside
    the slice become padding for this shard's kernel.  ``impl="scatter"``
    launches K1 (``orset_scatter``) for the raw planes and gates the adds
    against ``clock0``; ``impl="fold"`` launches K2 (``orset_fold``) with
    ``retire_rm=False`` over the slice.  Returns the shard's partial
    ``(add, rm)``; both reduce over dp with a max and then take the
    normalize tail (:func:`_fold_tail`).  The kernel's own clock would
    miss the out-of-slice rows, so the clock is computed apart
    (:func:`_rows_clock`)."""
    E_local = add0.shape[0]
    member_ix, shard_actor = _slice_rows(member, actor, member_lo, E_local, R)
    if impl == "fold":
        _, add, rm = orset_fold(
            clock0, add0, rm0, kind, member_ix, shard_actor, counter,
            num_members=E_local, num_replicas=R, retire_rm=False,
        )
        return add, rm
    add_new, rm_new = orset_scatter(
        kind, member_ix, shard_actor, counter,
        num_members=E_local, num_replicas=R,
    )
    # cell-level replay gate (≡ row gating by per-actor dot monotonicity)
    zero = torch.zeros((), dtype=torch.int32, device=add_new.device)
    return torch.where(add_new > clock0[None, :], add_new, zero), rm_new


def _fold_tail(clock, add0, rm0, add_new, rm_new, retire_rm: bool):
    """The normalize tail after the dp combine: add/rm max, add killed
    where ≤ rm, and (``retire_rm``) horizons retired where ≤ ``clock``."""
    zero = torch.zeros((), dtype=add0.dtype, device=add0.device)
    add = torch.maximum(add0, add_new)
    rm = torch.maximum(rm0, rm_new)
    add = torch.where(add > rm, add, zero)
    if retire_rm:
        rm = torch.where(rm > clock[None, :], rm, zero)
    return add, rm


def orset_fold_sharded(mesh: Mesh, clock0, add0, rm0, kind, member, actor,
                       counter, retire_rm: bool = True, impl: str = "scatter"):
    """Sharded OR-Set fold.

    Layout: op rows over ``dp`` (the row count must divide dp — pad
    first, :func:`pad_rows_for_mesh`), the planes over ``mp`` on the
    member axis (E must divide mp), the clock replicated.  Returns
    ``(clock, add, rm)`` assembled on ``mesh.home``, equal to
    ``ops.orset.orset_fold`` over all rows.

    ``impl="scatter"`` (the whole-batch fold) launches K1 once per
    shard, ``dp·mp`` launches; ``impl="fold"`` (the streaming step)
    launches K2 once per shard.  ``retire_rm=False``: partial-reduction
    mode for the sharded stream (see ``ops.orset.orset_fold``)."""
    if impl not in ("scatter", "fold"):
        raise ValueError(f"impl wants 'scatter' or 'fold', got {impl!r}")
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    clock0, add0, rm0, kind, member, actor, counter = map(
        _tensor, (clock0, add0, rm0, kind, member, actor, counter))
    E, R = add0.shape
    if len(kind) % mesh.local_dp or E % mp:
        raise ValueError(
            f"pad first: rows {len(kind)} % dp {dp} or members {E} % mp {mp}"
        )
    E_local = E // mp
    rows = [_split(c, mesh.local_dp) for c in (kind, member, actor, counter)]
    clock_parts = []
    planes = [([], []) for _ in range(mp)]
    for d in range(mesh.local_dp):
        k, m, a, c = (r[d] for r in rows)
        for s in range(mp):
            dev = mesh.devices[d][s]
            k_s, m_s, a_s, c_s = (_to(x, dev) for x in (k, m, a, c))
            lo = s * E_local
            add_p, rm_p = _local_fold(
                _to(clock0, dev), _to(add0[lo:lo + E_local], dev),
                _to(rm0[lo:lo + E_local], dev), k_s, m_s, a_s, c_s, lo, R,
                impl,
            )
            planes[s][0].append(add_p)
            planes[s][1].append(rm_p)
            if s == 0:
                clock_parts.append(_rows_clock(k_s, a_s, c_s, R))
    home = mesh.home
    clock = torch.maximum(_to(clock0, home),
                          _to(_reduce(mesh, clock_parts, "max"), home))
    adds, rms = [], []
    for s in range(mp):
        lo = s * E_local
        add_new = _reduce(mesh, planes[s][0], "max")
        rm_new = _reduce(mesh, planes[s][1], "max")
        dev = add_new.device
        add, rm = _fold_tail(_to(clock, dev), _to(add0[lo:lo + E_local], dev),
                             _to(rm0[lo:lo + E_local], dev), add_new, rm_new,
                             retire_rm)
        adds.append(_to(add, home))
        rms.append(_to(rm, home))
    return clock, torch.cat(adds), torch.cat(rms)


def orset_merge_sharded(mesh: Mesh, clock_a, add_a, rm_a, clock_b, add_b,
                        rm_b):
    """Pairwise state merge with the planes over ``mp``: elementwise, one
    ``ops.orset.orset_merge`` per member slice, no collective.  E must
    divide mp."""
    mp = mesh.shape["mp"]
    clock_a, add_a, rm_a, clock_b, add_b, rm_b = map(
        _tensor, (clock_a, add_a, rm_a, clock_b, add_b, rm_b))
    E = add_a.shape[0]
    if E % mp:
        raise ValueError(f"pad first: members {E} % mp {mp}")
    E_local = E // mp
    home = mesh.home
    clock, adds, rms = None, [], []
    for s in range(mp):
        dev = mesh.devices[0][s]
        sl = slice(s * E_local, (s + 1) * E_local)
        c, a, r = orset_merge(
            _to(clock_a, dev), _to(add_a[sl], dev), _to(rm_a[sl], dev),
            _to(clock_b, dev), _to(add_b[sl], dev), _to(rm_b[sl], dev),
        )
        clock = _to(c, home) if clock is None else clock
        adds.append(_to(a, home))
        rms.append(_to(r, home))
    return clock, torch.cat(adds), torch.cat(rms)


# ----------------------------------------------------- sharded streaming fold
def stream_sharding(mesh: Mesh):
    """The placements of the streaming fold's ``(rows, clock, planes)``:
    three ``put(x, non_blocking=False)`` functions that take a host array
    or tensor and return it on the mesh.  The in-process mesh keeps every
    value assembled on ``mesh.home`` (row chunks over ``dp``, the clock
    replicated and the planes over ``mp`` are views of it that each shard
    moves to its own device), so the three coincide.  Like
    ``jax.device_put`` they count nothing: the caller counts
    ``h2d_bytes`` at issue (``ops.stream.fold_chunks_overlapped`` does)."""

    def put(x, non_blocking: bool = False):
        t = _tensor(x)
        return t.to(mesh.home, non_blocking=non_blocking)

    return put, put, put


def sharded_stream_planes(mesh: Mesh, E_pad: int, R: int):
    """Zero-seeded accumulator planes for the sharded streaming fold:
    the clock ``(max(R, 1),)`` and the ``(E_pad, R)`` planes, made on
    ``mesh.home`` (no host buffer, so nothing crosses).  ``E_pad`` must
    divide the mp axis."""
    if E_pad % mesh.shape["mp"]:
        raise ValueError(f"pad first: members {E_pad} % mp {mesh.shape['mp']}")
    dev = mesh.home
    return (torch.zeros(max(R, 1), dtype=torch.int32, device=dev),
            torch.zeros((E_pad, R), dtype=torch.int32, device=dev),
            torch.zeros((E_pad, R), dtype=torch.int32, device=dev))


def sharded_stream_fold_step(mesh: Mesh):
    """The ``(clock, add, rm), chunk → (clock, add, rm)`` step of the
    sharded streaming fold: :func:`orset_fold_sharded` with
    ``retire_rm=False`` (partial-reduction mode: the session's finish
    retires once against the merged clock) and one K2 launch per shard.
    Eager PyTorch compiles nothing, so there is no step to cache and no
    buffer to donate."""

    def step(clock, add, rm, kind, member, actor, counter):
        return orset_fold_sharded(mesh, clock, add, rm, kind, member, actor,
                                  counter, retire_rm=False, impl="fold")

    return step


# ------------------------------------------------- sharded multi-tenant folds
def _tenant_shape(mesh: Mesh, T: int, E: int) -> None:
    dp, mp = mesh.shape["dp"], mesh.shape["mp"]
    if T % mesh.local_dp or E % mp:
        raise ValueError(
            f"pad first: tenants {T} % dp {dp} or members {E} % mp {mp}"
        )


def tenant_layout(planes: torch.Tensor) -> torch.Tensor:
    """``(T, E, R)`` → the tenant layout ``(E, T·R)``, contiguous, as the
    fold kernel takes it (a slice of the layout's own ``(T, E, R)`` view
    would reshape into a strided view of it)."""
    T, E, R = planes.shape
    return planes.permute(1, 0, 2).contiguous().view(E, T * R)


def _unlayout(plane: torch.Tensor, T: int) -> torch.Tensor:
    """The tenant layout ``(E, T·R)`` → ``(T, E, R)`` (a copy)."""
    E = plane.shape[0]
    return plane.view(E, T, -1).permute(1, 0, 2).contiguous()


def _tenant_local_fold(clock0, add0, rm0, kind, member, actor, counter,
                       member_lo: int, R: int):
    """The fold of one dp shard's tenants against one member slice, as
    one K2 launch over the tenant layout ``(E_local, T_l·R)``.

    The tenants' rows arrive whole (replicated over mp): rows outside the
    slice turn into the layout's padding for the kernel, but the clock
    sees every live add (:func:`_tenant_clock`).  K2 runs with
    ``retire_rm=False``, since its own clock would miss the out-of-slice
    rows; the caller retires against the whole clock."""
    T, E_local, _ = add0.shape
    member_ix, shard_actor = _slice_rows(member, actor, member_lo, E_local, R)
    _, add, rm = orset_fold(
        clock0.reshape(T * R), tenant_layout(add0), tenant_layout(rm0),
        kind.reshape(-1), member_ix.reshape(-1),
        tenant_columns(shard_actor, R), counter.reshape(-1),
        num_members=E_local, num_replicas=T * R, retire_rm=False,
    )
    return add, rm


def _tenant_clock(clock0, kind, actor, counter, R: int) -> torch.Tensor:
    """Per-tenant ``max(clock0, max live add counter per actor)`` over
    every row of each tenant, ``(T, R)``."""
    T = kind.shape[0]
    adds = (kind == KIND_ADD).reshape(-1)
    cols = tenant_columns(actor, R)
    live = adds & (cols < T * R)
    zero = torch.zeros((), dtype=torch.int32, device=actor.device)
    new = torch.zeros(T * R, dtype=torch.int32, device=actor.device)
    if cols.shape[0]:
        new.scatter_reduce_(0, torch.where(live, cols, zero).long(),
                            torch.where(live, counter.reshape(-1), zero),
                            reduce="amax")
    return torch.maximum(clock0, new.view(T, R))


def orset_fold_tenants_sharded(mesh: Mesh, clock0, add0, rm0, kind, member,
                               actor, counter):
    """Mesh-sharded twin of ``ops.orset.orset_fold_tenants``: the tenant
    axis over ``dp`` (T must divide dp — the planner quantizes bucket
    slots to dp multiples), each tenant's member axis over ``mp`` (E must
    divide mp), op rows replicated across mp.  One K2 launch per shard
    over that shard's tenant layout.  Returns ``(clock (T, R), add
    (T, E, R), rm)`` assembled on ``mesh.home``, equal per tenant to the
    unsharded fold."""
    mp = mesh.shape["mp"]
    clock0, add0, rm0, kind, member, actor, counter = map(
        _tensor, (clock0, add0, rm0, kind, member, actor, counter))
    T, E, R = add0.shape
    _tenant_shape(mesh, T, E)
    E_local = E // mp
    T_l = T // mesh.local_dp
    home = mesh.home
    clocks, adds, rms = [], [], []
    for d in range(mesh.local_dp):
        ts = slice(d * T_l, (d + 1) * T_l)
        dev0 = mesh.devices[d][0]
        k, m, a, c = (_to(x[ts], dev0) for x in (kind, member, actor, counter))
        clock = _tenant_clock(_to(clock0[ts], dev0), k, a, c, R)
        add_s, rm_s = [], []
        for s in range(mp):
            dev = mesh.devices[d][s]
            es = slice(s * E_local, (s + 1) * E_local)
            add, rm = _tenant_local_fold(
                _to(clock0[ts], dev), _to(add0[ts, es], dev),
                _to(rm0[ts, es], dev), _to(k, dev), _to(m, dev), _to(a, dev),
                _to(c, dev), s * E_local, R,
            )
            zero = torch.zeros((), dtype=rm.dtype, device=dev)
            rm = torch.where(rm > _to(clock, dev).reshape(1, T_l * R), rm,
                             zero)
            add_s.append(_to(_unlayout(add, T_l), home))
            rm_s.append(_to(_unlayout(rm, T_l), home))
        clocks.append(_to(clock, home))
        adds.append(torch.cat(add_s, dim=1))
        rms.append(torch.cat(rm_s, dim=1))
    return torch.cat(clocks), torch.cat(adds), torch.cat(rms)


def gcounter_fold_tenants_sharded(mesh: Mesh, clock0, actor, counter):
    """Mesh-sharded twin of ``ops.counters.gcounter_fold_tenants``:
    tenant lanes over ``dp``, the small ``(R,)`` planes shard-local.  T
    must divide dp.  Returns the ``(T, R)`` clocks on ``mesh.home``."""
    clock0, actor, counter = map(_tensor, (clock0, actor, counter))
    T, R = clock0.shape
    if T % mesh.local_dp:
        raise ValueError(f"pad first: tenants {T} % dp {mesh.shape['dp']}")
    T_l = T // mesh.local_dp
    out = []
    for d in range(mesh.local_dp):
        ts = slice(d * T_l, (d + 1) * T_l)
        dev = mesh.devices[d][0]
        out.append(_to(gcounter_fold_tenants(
            _to(clock0[ts], dev), _to(actor[ts], dev), _to(counter[ts], dev),
            num_replicas=R,
        ), mesh.home))
    return torch.cat(out)


def tenant_plane_diff_sharded(mesh: Mesh, clock_b, add_b, rm_b, clock_n,
                              add_n, rm_n):
    """Mesh-sharded twin of the tenant plane diff (``ops.orset.
    orset_plane_diff`` per tenant) for the device-cut delta: tenant lanes
    over ``dp``, member slices over ``mp`` — the layout the fold twin
    leaves the planes in.  Each cell reads one cell plus the tenant's
    clocks; only the per-tenant count crosses shards (a sum over mp).
    Returns ``(code (T, E, R) int8, count (T,) int64)``."""
    mp = mesh.shape["mp"]
    clock_b, add_b, rm_b, clock_n, add_n, rm_n = map(
        _tensor, (clock_b, add_b, rm_b, clock_n, add_n, rm_n))
    T, E, R = add_n.shape
    _tenant_shape(mesh, T, E)
    E_local = E // mp
    T_l = T // mesh.local_dp
    home = mesh.home
    codes, counts = [], []
    for d in range(mesh.local_dp):
        ts = slice(d * T_l, (d + 1) * T_l)
        code_s, count_s = [], []
        for s in range(mp):
            dev = mesh.devices[d][s]
            es = slice(s * E_local, (s + 1) * E_local)
            code, _ = orset_plane_diff(
                _to(clock_b[ts], dev).reshape(-1),
                tenant_layout(_to(add_b[ts, es], dev)),
                tenant_layout(_to(rm_b[ts, es], dev)),
                _to(clock_n[ts], dev).reshape(-1),
                tenant_layout(_to(add_n[ts, es], dev)),
                tenant_layout(_to(rm_n[ts, es], dev)),
            )
            code = _unlayout(code, T_l)
            code_s.append(_to(code, home))
            count_s.append(_to((code != 0).sum(dim=(1, 2)), home))
        codes.append(torch.cat(code_s, dim=1))
        counts.append(torch.stack(count_s).sum(dim=0))
    return torch.cat(codes), torch.cat(counts)


# -------------------------------------------------------------- counters
def pncounter_fold_sharded(mesh: Mesh, p0, n0, sign, actor, counter):
    """PN-Counter fold with op rows over ``dp`` (pad the row count to a
    dp multiple with ``actor == R`` sentinels first).  The ``(R,)``
    planes are replicated and the shards combine with one max over dp.
    Returns ``(p, n, value)``, value ``sum(p) − sum(n)`` in int64."""
    p0, n0, sign, actor, counter = map(_tensor, (p0, n0, sign, actor, counter))
    R = len(p0)
    _check_rows("rows", len(sign), mesh.shape["dp"], mesh)
    rows = [_split(c, mesh.local_dp) for c in (sign, actor, counter)]
    ps, ns = [], []
    for d in range(mesh.local_dp):
        dev = mesh.devices[d][0]
        p, n, _ = pncounter_fold(
            torch.zeros_like(_to(p0, dev)), torch.zeros_like(_to(n0, dev)),
            *(_to(r[d], dev) for r in rows), num_replicas=R,
        )
        ps.append(p)
        ns.append(n)
    home = mesh.home
    p = torch.maximum(_to(p0, home), _to(_reduce(mesh, ps, "max"), home))
    n = torch.maximum(_to(n0, home), _to(_reduce(mesh, ns, "max"), home))
    return p, n, p.sum(dtype=torch.int64) - n.sum(dtype=torch.int64)


def gcounter_fold_sharded(mesh: Mesh, clock0, actor, counter):
    """G-Counter fold over ``dp`` (see :func:`pncounter_fold_sharded`):
    ``(clock, value)``."""
    clock0, actor = _tensor(clock0), _tensor(actor)
    sign = torch.zeros(len(actor), dtype=torch.int8, device=actor.device)
    p, _, total = pncounter_fold_sharded(
        mesh, clock0, torch.zeros_like(clock0), sign, actor, counter
    )
    return p, total  # the n plane is zero, so the pn value is the sum


# ------------------------------------------------------------------ LWW
def lww_fold_sharded(mesh: Mesh, key, ts_hi, ts_lo, actor, value, *,
                     num_keys: int, num_values: int | None = None):
    """LWW-map fold with write rows over ``dp``: each shard picks its
    per-key winners (``ops.lww.lww_fold``, one K5 launch per shard on the
    card), then the ``(K,)`` winner tables gather and combine in dp order
    through ``lww_table_merge``: dense per-key state moves once, rows
    never do.  The row count must divide dp (pad with ``key ==
    num_keys`` sentinel rows)."""
    cols = tuple(map(_tensor, (key, ts_hi, ts_lo, actor, value)))
    _check_rows("rows", len(cols[0]), mesh.shape["dp"], mesh)
    rows = [_split(c, mesh.local_dp) for c in cols]
    home = mesh.home
    tables = []
    for d in range(mesh.local_dp):
        dev = mesh.devices[d][0]
        local = lww_fold(*(_to(r[d], dev) for r in rows), num_keys=num_keys,
                         num_values=num_values)
        tables.append(torch.stack([_to(x.to(torch.int32), home)
                                   for x in local]))
    g = _gather(mesh, tables)
    acc = tuple(g[0][:4]) + (g[0][4].bool(),)
    for t in g[1:]:
        acc = lww_table_merge(tuple(t[:4]) + (t[4].bool(),), acc)
    return acc


# --------------------------------------------------------------- CrdtMap
def dp_combine(mesh: Mesh):
    """The combine hook of ``ops.map_device.crdtmap_scatter_phase`` over
    ``mesh``: ``combine(fn, cols, op)`` cuts each row column into the dp
    shards, runs ``fn`` on each shard's rows on that shard's device and
    reduces the partials with ``op`` (``"max"``: the ``pmax``, ``"min"``:
    the ``pmin`` of the JAX phase) onto ``mesh.home``."""

    def combine(fn, cols, op: str):
        parts = [_split(c, mesh.local_dp) for c in cols]
        out = [fn(*(_to(p[d], mesh.devices[d][0]) for p in parts))
               for d in range(mesh.local_dp)]
        return _to(_reduce(mesh, out, op), mesh.home)

    return combine


def crdtmap_scatter_sharded(mesh: Mesh, clock0, births0, cclk0, cadd0, crm0,
                            key_of_pair, b_rows, k_rows, a_rows, r_rows, *,
                            num_groups: int):
    """Sharded CrdtMap scatter phase: the four row families over ``dp``
    (each padded to a dp multiple with ``actor == R`` sentinels), the
    key and pair planes replicated (map workloads are row-heavy and
    plane-light).  Each scatter combines across dp with a max (a min for
    the remove-group gate) inside ``ops.map_device.crdtmap_scatter_phase``
    through :func:`dp_combine`."""
    from ..ops.map_device import crdtmap_scatter_phase

    for fam in (b_rows, k_rows, a_rows, r_rows):
        if len(fam[0]) % mesh.local_dp:
            raise ValueError(
                f"pad row families to dp={mesh.shape['dp']} multiples first")
    home = mesh.home
    planes = [_to(_tensor(x), home)
              for x in (clock0, births0, cclk0, cadd0, crm0, key_of_pair)]
    rows = [_to(_tensor(x), home)
            for fam in (b_rows, k_rows, a_rows, r_rows) for x in fam]
    return crdtmap_scatter_phase(*planes, *rows, num_groups=num_groups,
                                 combine=dp_combine(mesh))


# ----------------------------------------------------------------- MVReg
def mvreg_keep_sharded(mesh: Mesh, clocks, valid):
    """Sharded MVReg dominance filter: candidate rows over ``dp`` (pad V
    to a dp multiple with invalid rows); each shard gathers the full
    candidate set (clocks, not payloads) and filters its own slice, so
    the ``O(V²R)`` compare splits V/dp ways.  The contract of
    ``ops.mvreg.mvreg_dominance_keep``."""
    clocks, valid = _tensor(clocks), _tensor(valid)
    V, R = clocks.shape
    if V % mesh.local_dp:
        raise ValueError(
            f"pad candidates {V} to a dp={mesh.shape['dp']} multiple first")
    home = mesh.home
    full_c = torch.cat(_gather(mesh, [_to(c, home) for c in
                                      _split(clocks, mesh.local_dp)]))
    full_v = torch.cat(_gather(mesh, [_to(v, home) for v in
                                      _split(valid, mesh.local_dp)]))
    keep = []
    for d, (c_slice, v_slice) in enumerate(zip(_split(clocks, mesh.local_dp),
                                               _split(valid, mesh.local_dp))):
        dev = mesh.devices[d][0]
        fc, fv = _to(full_c, dev), _to(full_v, dev)
        cs, vs = _to(c_slice, dev), _to(v_slice, dev)
        dominated = torch.zeros(cs.shape[0], dtype=torch.bool, device=dev)
        block = dominance_block(len(fc), R)
        for lo in range(0, len(fc), block):
            cj = fc[lo:lo + block, None, :]
            ge = (cj >= cs[None, :, :]).all(dim=-1)
            gt = (cj > cs[None, :, :]).any(dim=-1)
            dominated |= (ge & gt & fv[lo:lo + block, None]).any(dim=0)
        keep.append(_to(vs & ~dominated, home))
    return torch.cat(keep)
