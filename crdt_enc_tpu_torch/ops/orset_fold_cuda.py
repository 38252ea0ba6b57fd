"""The OR-Set fold on the card: two hand-written CUDA kernels.

``csrc/orset_fold.cu`` holds both:

* ``orset_scatter`` — the raw scatter phase (covers the TPU's
  ``orset_scatter_pallas``): one thread per row, ``atomicMax`` into the add
  or remove plane, and optionally into a clock seeded with ``clock0``;
* ``orset_fold_tail`` — the normalize tail (covers the epilogue of
  ``orset_fold_pallas_fused`` and ``orset_retire``): elementwise over
  ``(E, R)``.

``orset_fold_cuda`` chains them into the fold ``ops.orset.orset_fold``
runs for CUDA tensors.  Each wrapper checks device, dtype, shape and
contiguity, allocates its outputs, launches on the current stream and
raises on a launch error.  Given CPU tensors, a wrapper runs the kernel's
plain version from ``ops/orset.py`` instead; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts the kernel launches
per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .cuda_build import expect
from .orset import (
    common_device,
    orset_fold_clock_plain,
    orset_fold_tail_plain,
    orset_scatter_plain,
)

launches = {"orset_scatter": 0, "orset_fold_tail": 0}

_P = ctypes.c_void_p
_I32 = ctypes.c_int32


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("orset_fold")
    lib.orset_scatter_launch.argtypes = [
        _P, _P, _P, _P, ctypes.c_int64, _I32, _I32, _P, _P, _P, _P,
    ]
    lib.orset_scatter_launch.restype = ctypes.c_int
    lib.orset_fold_tail_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _I32, _I32, _I32, _P, _P, _P,
    ]
    lib.orset_fold_tail_launch.restype = ctypes.c_int
    return lib


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
    n = kind.shape[0]
    expect(kind, "kind", torch.int8, (n,))
    for t, name in ((member, "member"), (actor, "actor"), (counter, "counter")):
        expect(t, name, torch.int32, (n,))
    if clock is not None:
        expect(clock, "clock", torch.int32, (R,))
    add_new = torch.zeros((E, R), dtype=torch.int32, device=dev)
    rm_new = torch.zeros((E, R), dtype=torch.int32, device=dev)
    if n and E and R:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.orset_scatter_launch(
                kind.data_ptr(), member.data_ptr(), actor.data_ptr(),
                counter.data_ptr(), n, E, R, add_new.data_ptr(),
                rm_new.data_ptr(), None if clock is None else clock.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        cuda_build.check(lib, rc, "orset_scatter")
        launches["orset_scatter"] += 1
    return add_new, rm_new


def orset_fold_tail(clock0, clock, add0, rm0, add_new, rm_new, *,
                    retire_rm: bool = True):
    """The fold's normalize tail given the final ``clock``: replay gate
    ``add_new > clock0``, ``add = max(add0, gated)``, ``rm = max(rm0,
    rm_new)``, add killed where ≤ rm, and with ``retire_rm`` horizons
    zeroed where ≤ ``clock``.  Returns new ``(add, rm)`` planes."""
    dev = common_device(clock0, clock, add0, rm0, add_new, rm_new)
    if dev.type != "cuda":
        return orset_fold_tail_plain(
            clock0, clock, add0, rm0, add_new, rm_new, retire_rm=retire_rm
        )
    E, R = add0.shape
    for t, name in ((clock0, "clock0"), (clock, "clock")):
        expect(t, name, torch.int32, (R,))
    for t, name in ((add0, "add0"), (rm0, "rm0"), (add_new, "add_new"),
                    (rm_new, "rm_new")):
        expect(t, name, torch.int32, (E, R))
    add = torch.empty((E, R), dtype=torch.int32, device=dev)
    rm = torch.empty((E, R), dtype=torch.int32, device=dev)
    if E and R:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = lib.orset_fold_tail_launch(
                clock0.data_ptr(), clock.data_ptr(), add0.data_ptr(),
                rm0.data_ptr(), add_new.data_ptr(), rm_new.data_ptr(), E, R,
                int(retire_rm), add.data_ptr(), rm.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        cuda_build.check(lib, rc, "orset_fold_tail")
        launches["orset_fold_tail"] += 1
    return add, rm


def orset_fold_cuda(clock0, add0, rm0, kind, member, actor, counter, *,
                    num_members: int, num_replicas: int,
                    retire_rm: bool = True):
    """``orset_fold`` through the two kernels: the scatter finishes the
    clock (seeded with ``clock0``), the tail normalizes.  Same contract and
    output as the plain fold."""
    clock = clock0.clone()
    add_new, rm_new = orset_scatter(
        kind, member, actor, counter,
        num_members=num_members, num_replicas=num_replicas, clock=clock,
    )
    add, rm = orset_fold_tail(
        clock0, clock, add0, rm0, add_new, rm_new, retire_rm=retire_rm
    )
    return clock, add, rm
