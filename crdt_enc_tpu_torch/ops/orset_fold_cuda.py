"""The OR-Set fold on the card: one bucketed fold, hand-written in CUDA.

``csrc/orset_fold.cu`` cuts the flat cells ``member·R + actor`` into
ranges of ``C`` cells, bins the rows by range (and raises the clock),
scans the counts, places each row in its range's slots, and folds each
range in shared memory in one block, which writes every output cell once.
Two entry points share those kernels and differ in the epilogue:

* ``orset_scatter`` — the raw scatter planes (covers the TPU's
  ``orset_scatter_pallas``), optionally raising a clock seeded with
  ``clock0``;
* ``orset_fold_cuda`` — the whole fold (covers ``orset_fold_pallas_fused``
  and ``_fold_wide``): the scatter, the replay gate, the clock and the
  normalize tail; ``ops.orset.orset_fold`` runs it for CUDA tensors.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch, launches on the current stream and raises on a launch
error.  Given CPU tensors, a wrapper runs the kernels' plain version from
``ops/orset.py`` instead; given CUDA tensors it launches the kernels or
raises.  ``launches`` counts the calls per entry point that launched them.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .cuda_build import expect
from .orset import (
    common_device,
    orset_fold_clock_plain,
    orset_fold_plain,
    orset_scatter_plain,
)

launches = {"orset_scatter": 0, "orset_fold": 0}

# C = 2^RANGE_SHIFT cells per range: two int32 tiles of C cells take
# 64 KB of shared memory per block, three blocks per SM.
RANGE_SHIFT = 13
# up to this many ranges (48 KB of counters) the row passes count in
# shared memory; past it, with one global atomic per row
DENSE_RANGES_MAX = 12_288
# the largest R whose clock a bin block keeps in shared memory (48 KB)
CLOCK_SMEM_MAX = 12_288

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_LIB: ctypes.CDLL | None = None


class FoldGeometry(NamedTuple):
    cells_per_range: int  # C
    n_ranges: int  # ceil(E·R / C): one block each
    smem_bytes: int  # the add and rm tiles of one block


def fold_geometry(num_members: int, num_replicas: int) -> FoldGeometry:
    """The range cut of an ``(E, R)`` fold: ranges of ``C`` consecutive
    flat cells (the last one ragged) that cover ``E·R`` exactly.  Cells
    are Python ints here and int64 in the kernels; ranges, the grid and
    the row slots are int32, so more than 2^31 − 1 ranges raise."""
    C = 1 << RANGE_SHIFT
    n_ranges = -(-(num_members * num_replicas) // C)
    if n_ranges >= 2**31:
        raise ValueError(f"E={num_members}, R={num_replicas}: {n_ranges} "
                         "ranges exceed the int32 grid")
    return FoldGeometry(C, n_ranges, 2 * C * 4)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("orset_fold")
        lib.orset_fold_launch.argtypes = [
            _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _I32,
            _P, _P, _P, _P, _P, _P, _P, _I32, _P, _P, _P,
        ]
        lib.orset_fold_launch.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_rows(kind, member, actor, counter) -> None:
    n = kind.shape[0]
    expect(kind, "kind", torch.int8, (n,))
    for t, name in ((member, "member"), (actor, "actor"), (counter, "counter")):
        expect(t, name, torch.int32, (n,))
    if n >= 2**31:
        raise ValueError(f"{n} rows: the kernels' row slots are int32")


def _launch(entry: str, rows, E: int, R: int, *, clock0=None, clock=None,
            add0=None, rm0=None, retire_rm: bool = True, add, rm) -> None:
    """The kernels on the current stream.  ``add0 is None`` selects the
    raw epilogue (``clock``, if given, raised in place); otherwise the
    fold epilogue, which writes ``clock`` from ``clock0``."""
    kind, member, actor, counter = rows
    n = kind.shape[0]
    dev = kind.device
    geo = fold_geometry(E, R)
    # one scratch allocation: the packed rows (int64), then the int32
    # range counts with a finish ticket, and the range starts
    ints = 2 * (geo.n_ranges + 1)
    scratch = torch.empty(n + ints // 2, dtype=torch.int64, device=dev)
    packed = scratch.data_ptr()
    count = packed + 8 * n
    begin = count + 4 * (geo.n_ranges + 1)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.orset_fold_launch(
            kind.data_ptr(), member.data_ptr(), actor.data_ptr(),
            counter.data_ptr(), n, E, R,
            geo.cells_per_range.bit_length() - 1, geo.n_ranges,
            DENSE_RANGES_MAX, CLOCK_SMEM_MAX, packed, count, begin,
            ptr(clock0), ptr(clock), ptr(add0), ptr(rm0), int(retire_rm),
            add.data_ptr(), rm.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, rc, entry)
    launches[entry] += 1


def orset_scatter(kind, member, actor, counter, *, num_members: int,
                  num_replicas: int, clock=None):
    """Raw scatter planes ``(add_new, rm_new)``: per (member, actor) cell
    the max add counter and the max remove counter, 0 where no row lands.
    Padding rows (``actor >= R``) and other kinds drop out; no replay gate,
    no normalization.

    ``clock`` (optional, ``(R,)`` int32 on the same device) is raised IN
    PLACE to ``max(clock, max add counter of each actor)`` — the final
    fold clock when it enters holding ``clock0``."""
    E, R = num_members, num_replicas
    tensors = (kind, member, actor, counter)
    if clock is not None:
        tensors += (clock,)
    dev = common_device(*tensors)
    if dev.type != "cuda":
        add_new, rm_new = orset_scatter_plain(
            kind, member, actor, counter, num_members=E, num_replicas=R,
        )
        if clock is not None:
            clock.copy_(orset_fold_clock_plain(clock, add_new))
        return add_new, rm_new
    _check_rows(kind, member, actor, counter)
    if clock is not None:
        expect(clock, "clock", torch.int32, (R,))
    add_new = torch.empty((E, R), dtype=torch.int32, device=dev)
    rm_new = torch.empty((E, R), dtype=torch.int32, device=dev)
    if E and R:  # else no row is valid: no plane cell, no clock change
        _launch("orset_scatter", (kind, member, actor, counter), E, R,
                clock=clock, add=add_new, rm=rm_new)
    return add_new, rm_new


def orset_fold_cuda(clock0, add0, rm0, kind, member, actor, counter, *,
                    num_members: int, num_replicas: int,
                    retire_rm: bool = True, out=None):
    """``orset_fold`` through the bucketed kernels: the bin pass finishes
    the clock (seeded with ``clock0``), the range kernel applies the rows
    and the normalize tail and writes ``add`` and ``rm`` once.  Same
    contract and output as the plain fold; returns ``(clock, add, rm)``.

    ``out`` (optional) is a ``(clock, add, rm)`` triple of the output
    shapes, on the same device, that none of the inputs shares memory
    with; the fold writes into it and returns it instead of allocating.
    The blockwise stream ping-pongs two plane triples this way, so its
    plane memory does not grow with the chunk count."""
    E, R = num_members, num_replicas
    args = (clock0, add0, rm0, kind, member, actor, counter)
    kw = dict(num_members=E, num_replicas=R, retire_rm=retire_rm)
    dev = common_device(*args)
    if dev.type != "cuda":
        res = orset_fold_plain(*args, **kw)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    _check_rows(kind, member, actor, counter)
    expect(clock0, "clock0", torch.int32, (R,))
    expect(add0, "add0", torch.int32, (E, R))
    expect(rm0, "rm0", torch.int32, (E, R))
    if out is None:
        clock = torch.empty(R, dtype=torch.int32, device=dev)
        add = torch.empty((E, R), dtype=torch.int32, device=dev)
        rm = torch.empty((E, R), dtype=torch.int32, device=dev)
    else:
        clock, add, rm = out
        expect(clock, "out clock", torch.int32, (R,))
        expect(add, "out add", torch.int32, (E, R))
        expect(rm, "out rm", torch.int32, (E, R))
        ins = {t.data_ptr() for t in args if t.numel()}
        if any(t.numel() and t.data_ptr() in ins for t in out):
            raise ValueError("orset_fold_cuda: out shares memory with an input")
    if not (E and R):  # no row is valid: the clock stays clock0
        clock.copy_(clock0)
        return clock, add, rm
    _launch("orset_fold", (kind, member, actor, counter), E, R,
            clock0=clock0, clock=clock, add0=add0, rm0=rm0,
            retire_rm=retire_rm, add=add, rm=rm)
    return clock, add, rm
