"""The LWW-map winner fold on the card: one hand-written CUDA entry point.

``csrc/lww_fold.cu`` covers the TPU's ``lww_fold_pallas`` with one
cooperative, persistent launch: every block the card holds at once zeroes
the key table, loads its rows into registers once and ORs their bit
widths, then raises each key's slot, then decodes the table into the
winner table — phases apart by grid barriers.  Where the batch's
(timestamp, actor, value) widths fit 64 bits (``PACK_BITS``), one packed
word a row decides the whole order; otherwise a timestamp slot, then an
(actor, value) slot among the rows that hold it.  Neither mode needs a
packed (actor, value) rank, so the kernel serves ``lww_fold`` with
``num_values`` given and without it.

Two routes, chosen by ``lww_tile``: up to ``SHARED_KEYS_MAX`` keys, each
block folds its rows into its own copy of the table in shared memory and
merges it into the global one with one atomic a key (the hot-key route);
past it, every row goes straight to the global table in L2.
``lww_geometry`` sizes the grid (every block resident, as the grid
barriers need), the rows a thread keeps in registers and the chunks a
batch past register residency takes; it is plain Python, so the CPU tests
check it.

The wrapper checks device, dtype, shape and contiguity, allocates the
outputs and the table, launches on the current stream and raises on a
launch error.  Given CPU tensors it runs ``lww_fold_plain`` from
``ops/lww.py`` instead; given CUDA tensors it launches the kernel or
raises.  ``launches`` counts the entry point's launches (one per fold).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import torch

from . import cuda_build
from .cuda_build import expect
from .lww import lww_fold_plain
from .orset import common_device

launches = {"lww_fold": 0}

THREADS = 512  # kThreads in csrc/lww_fold.cu
ROWS_MAX = 16  # kRowsMax there: rows a thread keeps in registers per chunk
# one more block is worth it per this many keys a thread zeroes and decodes
KEYS_PER_THREAD = 16
# keys whose two slots one block keeps in shared memory: 16 bytes a key,
# 192 KB of the 227 KB a Hopper block may take
TILE_KEYS_MAX = 12_288
# up to this many keys the fold takes the shared route (the card tests
# force either route by setting it to 0 or past any K)
SHARED_KEYS_MAX = 12_288
# the widest (t, actor, value) word the one-word mode packs; past it the
# kernel raises two words a key (the card tests force that with 0)
PACK_BITS = 64

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_LIB: ctypes.CDLL | None = None
# (device index, shared route, shared bytes) -> (SMs, blocks per SM)
_occupancy: dict[tuple[int, bool, int], tuple[int, int]] = {}


class LwwGeometry(NamedTuple):
    keys_padded: int  # K rounded up to 4: the table's and outputs' length
    tile_keys: int  # keys [0, tile_keys) fold in shared memory; 0: global
    smem_bytes: int
    blocks: int
    rows_per_thread: int
    chunks: int  # ceil(N / (blocks · THREADS · rows_per_thread))


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def lww_tile(num_keys: int) -> int:
    """Keys a block folds in shared memory before the global table: all of
    them (K rounded up to 4) while K ≤ ``SHARED_KEYS_MAX``, none past it.
    A threshold above ``TILE_KEYS_MAX`` holds the first ``TILE_KEYS_MAX``
    keys there and sends the rest straight to the global table."""
    if num_keys > SHARED_KEYS_MAX:
        return 0
    return min(_ceil(num_keys, 4) * 4, TILE_KEYS_MAX)


def lww_geometry(n: int, num_keys: int, tile_keys: int, sms: int,
                 blocks_per_sm: int) -> LwwGeometry:
    """The launch for N rows over K keys on a card of ``sms`` SMs that
    holds ``blocks_per_sm`` blocks of the route's kernel on each: no more
    blocks than are resident at once, enough for the rows at ``ROWS_MAX``
    a thread and the keys at ``KEYS_PER_THREAD``; then the fewest rows a
    thread that cover N in one chunk, or ``ROWS_MAX`` and more chunks."""
    if sms < 1 or blocks_per_sm < 1:
        raise RuntimeError(f"lww_fold: the card holds no block of the kernel "
                           f"({sms} SMs x {blocks_per_sm} blocks)")
    k_pad = _ceil(num_keys, 4) * 4
    want = _ceil(max(_ceil(n, ROWS_MAX), _ceil(k_pad, KEYS_PER_THREAD)),
                 THREADS)
    blocks = max(1, min(sms * blocks_per_sm, want))
    rows = min(ROWS_MAX, max(1, _ceil(n, blocks * THREADS)))
    chunks = _ceil(n, blocks * THREADS * rows)
    return LwwGeometry(k_pad, tile_keys, 16 * tile_keys, blocks, rows, chunks)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.load("lww_fold")
        lib.lww_fold_launch.argtypes = [
            _P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I64, _I32, _I32,
            _I32, _I32, _I32, _P, _P, _P, _P,
        ]
        lib.lww_fold_launch.restype = ctypes.c_int
        lib.lww_fold_occupancy.argtypes = [
            ctypes.c_int, _I64, ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.lww_fold_occupancy.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def occupancy(device: torch.device, tile_keys: int) -> tuple[int, int]:
    """(SMs, resident blocks per SM) of the route's kernel on ``device``,
    asked of the CUDA runtime once per device and shared-memory size."""
    ck = (device.index, tile_keys > 0, 16 * tile_keys)
    got = _occupancy.get(ck)
    if got is None:
        lib = _lib()
        sms, per_sm = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = lib.lww_fold_occupancy(int(ck[1]), ck[2], ctypes.byref(sms),
                                        ctypes.byref(per_sm))
        cuda_build.check(lib, rc, "lww_fold occupancy")
        got = _occupancy[ck] = (sms.value, per_sm.value)
    return got


def plan(n: int, num_keys: int, device: torch.device) -> LwwGeometry:
    """The geometry ``lww_fold_cuda`` launches with for N rows, K keys."""
    tile = lww_tile(num_keys)
    return lww_geometry(n, num_keys, tile, *occupancy(device, tile))


def launch(cols, num_keys: int, geo: LwwGeometry):
    """One launch of the kernel with the given geometry on the current
    stream; returns the winner table.  ``lww_fold_cuda`` calls it with
    ``plan``'s geometry.  The host's time per call is most of a single
    call's time, so this stays lean: three allocations, one C call."""
    dev = cols[0].device
    K, k_pad = num_keys, geo.keys_padded
    wins = torch.empty((4, k_pad), dtype=torch.int32, device=dev)
    present = torch.empty(k_pad, dtype=torch.bool, device=dev)
    # two slots a key, then each block's OR of the widths
    table = torch.empty(2 * k_pad + 2 * geo.blocks, dtype=torch.int64,
                        device=dev)
    lib = _lib()
    switch = dev.index != torch.cuda.current_device()
    with torch.cuda.device(dev) if switch else contextlib.nullcontext():
        rc = lib.lww_fold_launch(
            *(t.data_ptr() for t in cols), cols[0].shape[0], K, k_pad,
            geo.tile_keys, geo.smem_bytes, THREADS, geo.blocks,
            geo.rows_per_thread, geo.chunks, PACK_BITS, table.data_ptr(),
            wins.data_ptr(), present.data_ptr(),
            # the current stream's handle, as PyTorch's generated kernels
            # take it (torch.cuda.current_stream builds a Stream object)
            torch._C._cuda_getCurrentRawStream(dev.index),
        )
    cuda_build.check(lib, rc, "lww_fold")
    launches["lww_fold"] += 1
    if K != k_pad:
        wins, present = wins[:, :K], present[:K]
    return (*wins.unbind(0), present)


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
    if not num_keys:
        wins = torch.empty((4, 0), dtype=torch.int32, device=dev)
        return (*wins, torch.empty(0, dtype=torch.bool, device=dev))
    if num_keys > 2**31 - 4:
        raise ValueError(f"{num_keys} keys: the kernel's key slots are int32")
    return launch(args, num_keys, plan(n, num_keys, dev))
