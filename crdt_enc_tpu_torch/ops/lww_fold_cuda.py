"""The LWW-map winner fold on the card: one hand-written CUDA entry point.

``csrc/lww_fold.cu`` covers the TPU's ``lww_fold_pallas``: a timestamp
pass and a tie-break pass of 64-bit ``atomicMax`` into two ``(K,)``
scratch tables, then an elementwise decode into the winner table.  The
design needs no packed (actor, value) rank, so it serves ``lww_fold``
with ``num_values`` given and without it.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs and the scratch, launches on the current stream and raises on a
launch error.  Given CPU tensors it runs ``lww_fold_plain`` from
``ops/lww.py`` instead; given CUDA tensors it launches the kernel or
raises.  ``launches`` counts the entry point's launches (one per fold,
three passes each).
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import expect
from .lww import lww_fold_plain
from .orset import common_device

launches = {"lww_fold": 0}

_P = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("lww_fold")
    lib.lww_fold_launch.argtypes = [
        _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int32,
        _P, _P, _P, _P, _P, _P, _P,
    ]
    lib.lww_fold_launch.restype = ctypes.c_int
    return lib


def lww_fold_cuda(key, ts_hi, ts_lo, actor, value, *, num_keys: int,
                  num_values: int | None = None):
    """``lww_fold`` through the kernel: same contract and output as the
    plain cascade, ``(win_hi, win_lo, win_actor, win_value, present)``.
    ``num_values`` only selects the plain version's mode on CPU tensors:
    the kernel orders (actor, value) lexicographically either way."""
    args = (key, ts_hi, ts_lo, actor, value)
    dev = common_device(*args)
    if dev.type != "cuda":
        return lww_fold_plain(*args, num_keys=num_keys, num_values=num_values)
    n = key.shape[0]
    for t, name in zip(args, ("key", "ts_hi", "ts_lo", "actor", "value")):
        expect(t, name, torch.int32, (n,))
    K = num_keys
    wins = torch.empty((4, K), dtype=torch.int32, device=dev)
    present = torch.empty(K, dtype=torch.bool, device=dev)
    if K:
        scratch = torch.empty(2 * K, dtype=torch.int64, device=dev)
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.lww_fold_launch(
                *(t.data_ptr() for t in args), n, K, scratch.data_ptr(),
                *(w.data_ptr() for w in wins), present.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        cuda_build.check(lib, rc, "lww_fold")
        launches["lww_fold"] += 1
    return (*wins, present)
