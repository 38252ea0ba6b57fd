"""The S-way OR-Set merge on the card: one hand-written CUDA kernel.

``csrc/orset_merge.cu`` covers the TPU's ``orset_merge_many_pallas``: one
thread per ``(e, r)`` cell folds the S stacked states left to right in
registers, reading every input plane once and writing the two output
planes once.  The wrapper precomputes the running merged clock (the cummax
over S) and its predecessor, as ``pallas_merge.py`` does.

``orset_stack_cells_cuda`` builds the ``(S, E, R)`` add and remove
stacks that kernel reads from the states' cells (``ops.columnar.
orset_states_to_cells``): one zero fill, then one thread a cell.

Given CPU tensors each wrapper runs its plain version from
``ops/orset.py``; given CUDA tensors it launches the kernel or raises.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import expect
from .orset import (common_device, orset_merge_many_tree,
                    orset_stack_cells_plain)

launches = {"orset_merge_many": 0, "orset_stack_cells": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("orset_merge")
    lib.orset_merge_many_launch.argtypes = [
        _P, _P, _P, _P, _P, _I32, _I32, _I32, _P, _P, _P,
    ]
    lib.orset_merge_many_launch.restype = ctypes.c_int
    lib.orset_stack_cells_launch.argtypes = [
        _P, _P, _I64, _I32, _I32, _I32, _P, _P,
    ]
    lib.orset_stack_cells_launch.restype = ctypes.c_int
    return lib


def orset_stack_cells_cuda(cells, offsets, S: int, E: int, R: int):
    """The ``(S, E, R)`` int32 add and remove stacks of S states from their
    cells: ``cells (n, 2)`` int32 rows ``(e * R + r, counter)`` grouped by
    plane and state, ``offsets (2S + 1,)`` int64 the groups' first rows.
    Equal to ``orset_stack_cells_plain``."""
    dev = common_device(cells, offsets)
    if dev.type != "cuda":
        return orset_stack_cells_plain(cells, offsets, S, E, R)
    if S < 1:
        raise ValueError("orset_stack_cells needs at least one state")
    if E * R >= 2**31:
        raise ValueError(f"orset_stack_cells: E * R = {E * R} is past int32")
    n = cells.shape[0]
    expect(cells, "cells", torch.int32, (n, 2))
    expect(offsets, "offsets", torch.int64, (2 * S + 1,))
    if cells.data_ptr() % 8:
        raise ValueError("cells: must be 8-byte aligned")
    out = torch.empty((2, S, E, R), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.orset_stack_cells_launch(
            cells.data_ptr(), offsets.data_ptr(), n, S, E, R, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(lib, rc, "orset_stack_cells")
    launches["orset_stack_cells"] += 1
    return out[0], out[1]


def orset_merge_many_cuda(clocks, adds, rms):
    """Merge S stacked states ``clocks (S, R)``, ``adds/rms (S, E, R)``
    int32 into one ``(clock (R,), add (E, R), rm (E, R))``, equal to the
    plain tree merge."""
    dev = common_device(clocks, adds, rms)
    if dev.type != "cuda":
        return orset_merge_many_tree(clocks, adds, rms)
    S, E, R = adds.shape
    if S < 1:
        raise ValueError("orset_merge_many needs at least one state")
    expect(clocks, "clocks", torch.int32, (S, R))
    expect(adds, "adds", torch.int32, (S, E, R))
    expect(rms, "rms", torch.int32, (S, E, R))
    run = torch.cummax(clocks, dim=0).values  # (S, R) running merged clock
    prev_run = torch.cat([torch.zeros_like(run[:1]), run[:-1]]).contiguous()
    out_add = torch.empty((E, R), dtype=torch.int32, device=dev)
    out_rm = torch.empty((E, R), dtype=torch.int32, device=dev)
    if E and R:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.orset_merge_many_launch(
                clocks.data_ptr(), prev_run.data_ptr(), run.data_ptr(),
                adds.data_ptr(), rms.data_ptr(), S, E, R, out_add.data_ptr(),
                out_rm.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        cuda_build.check(lib, rc, "orset_merge_many")
        launches["orset_merge_many"] += 1
    return run[-1], out_add, out_rm
