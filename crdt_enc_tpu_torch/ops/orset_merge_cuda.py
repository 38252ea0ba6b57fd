"""The S-way OR-Set merge on the card: one hand-written CUDA kernel.

``csrc/orset_merge.cu`` covers the TPU's ``orset_merge_many_pallas``: one
thread per ``(e, r)`` cell folds the S stacked states left to right in
registers, reading every input plane once and writing the two output
planes once.  The wrapper precomputes the running merged clock (the cummax
over S) and its predecessor, as ``pallas_merge.py`` does.

Given CPU tensors the wrapper runs the plain tree merge from
``ops/orset.py``; given CUDA tensors it launches the kernel or raises.
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import expect
from .orset import common_device, orset_merge_many_tree

launches = {"orset_merge_many": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("orset_merge")
    lib.orset_merge_many_launch.argtypes = [
        _P, _P, _P, _P, _P, _I32, _I32, _I32, _P, _P, _P,
    ]
    lib.orset_merge_many_launch.restype = ctypes.c_int
    return lib


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
