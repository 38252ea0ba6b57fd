"""LWW-map fold: per-key lexicographic argmax over (ts, actor, value).

The port's counterpart of ``crdt_enc_tpu/ops/lww.py``, with the same
contracts.  The host tie-break order (timestamp, then actor bytes, then
canonical value bytes — ``models/lwwmap.py``) is reproduced on the device
by *rank interning*: actors and values are sorted host-side so integer
comparison matches byte comparison.  Timestamps arrive split into hi/lo
31-bit halves (``ts_split``).

``lww_fold`` dispatches on the tensors' device: CUDA tensors go to the
hand-written kernel (``lww_fold_cuda``), CPU tensors to ``lww_fold_plain``
here — the JAX package's cascade of segment-max passes, which is also the
reference the kernel is held against on the card.  The main path never
calls it with CUDA tensors.  The winner-table merge is elementwise and
stays plain PyTorch on either device.
"""

from __future__ import annotations

import numpy as np
import torch

from .orset import _cpu_only, common_device

TS_SPLIT_BITS = 31
TS_SPLIT_MASK = (1 << TS_SPLIT_BITS) - 1


def ts_split(ts):
    """Split non-negative int timestamps (< 2^62) into (hi, lo) int32."""
    ts = np.asarray(ts, np.int64)
    if (ts < 0).any() or (ts >= (1 << 62)).any():
        raise ValueError("timestamps must be in [0, 2^62)")
    return (ts >> TS_SPLIT_BITS).astype(np.int32), (ts & TS_SPLIT_MASK).astype(
        np.int32
    )


def lww_fold_plain(key, ts_hi, ts_lo, actor, value, *, num_keys: int,
                   num_values: int | None = None):
    """``lww_fold`` as the JAX cascade, formula for formula: each pass
    keeps the rows that hold their key's maximum of one column.  With
    ``num_values`` the (actor, value) passes collapse into one over the
    packed rank ``actor·V + value``; without it, two more passes."""
    K = num_keys
    pad = (key < 0) | (key >= K)
    key_ix = torch.where(pad, torch.zeros_like(key), key).long()

    def cascade(elig, col):
        masked = torch.where(elig, col, torch.full_like(col, -1))
        m = torch.full((K,), -1, dtype=col.dtype, device=col.device)
        if col.shape[0] and K:
            m.scatter_reduce_(0, key_ix, masked, reduce="amax")
        return elig & (col == m[key_ix]), m

    elig = ~pad
    elig, m_hi = cascade(elig, ts_hi)
    elig, m_lo = cascade(elig, ts_lo)
    present = m_hi > -1
    if num_values is not None:
        _, m_av = cascade(elig, actor.long() * num_values + value)
        absent = torch.full_like(m_av, -1)
        m_actor = torch.where(present, m_av // num_values, absent).int()
        m_value = torch.where(present, m_av % num_values, absent).int()
    else:
        elig, m_actor = cascade(elig, actor)
        _, m_value = cascade(elig, value)
    return m_hi, m_lo, m_actor, m_value, present


def lww_fold(
    key: torch.Tensor,  # (N,) int32   (>= num_keys ⇒ padding row)
    ts_hi: torch.Tensor,  # (N,) int32
    ts_lo: torch.Tensor,  # (N,) int32
    actor: torch.Tensor,  # (N,) int32  rank-interned
    value: torch.Tensor,  # (N,) int32  rank-interned (tombstone included)
    *,
    num_keys: int,
    num_values: int | None = None,
):
    """Per-key winner selection.  Returns ``(win_hi, win_lo, win_actor,
    win_value, present)``: int32 ×4, −1 where a key has no row, and a bool
    ``present``.

    ``num_values``: when given, the caller guarantees every value is below
    it and ``actor·V + value`` fits int32 (the accelerator checks
    ``|actors|·V < 2^31``); the winner is the same either way.  CUDA
    tensors run the kernel (which needs no packed rank), CPU tensors the
    plain cascade."""
    args = (key, ts_hi, ts_lo, actor, value)
    kw = dict(num_keys=num_keys, num_values=num_values)
    if common_device(*args).type == "cuda":
        from .lww_fold_cuda import lww_fold_cuda

        return lww_fold_cuda(*args, **kw)
    _cpu_only(*args)
    return lww_fold_plain(*args, **kw)


def lww_table_wins(a: tuple, b: tuple):
    """Elementwise: where winner-table row ``a`` beats ``b`` — present
    beats absent; both present resolve by the (ts_hi, ts_lo, actor, value)
    lexicographic order (the host tie-break, models/lwwmap.py)."""
    a_hi, a_lo, a_ac, a_va, a_p = a
    b_hi, b_lo, b_ac, b_va, b_p = b
    gt = a_hi > b_hi
    eq = a_hi == b_hi
    gt = gt | (eq & (a_lo > b_lo))
    eq = eq & (a_lo == b_lo)
    gt = gt | (eq & (a_ac > b_ac))
    eq = eq & (a_ac == b_ac)
    gt = gt | (eq & (a_va > b_va))
    return (a_p & ~b_p) | (a_p & b_p & gt)


def lww_table_merge(a: tuple, b: tuple) -> tuple:
    """Merge two (K,)-shaped winner tables elementwise.  Ties keep ``b``,
    matching segment-max semantics where identical tuples are
    indistinguishable."""
    take_a = lww_table_wins(a, b)
    out = tuple(torch.where(take_a, x, y) for x, y in zip(a[:4], b[:4]))
    return (*out, a[4] | b[4])


def lww_fold_into(win: tuple, key, ts_hi, ts_lo, actor, value, *,
                  num_keys: int, num_values: int | None = None):
    """Incremental fold: new rows compete against an existing winner table
    ``(win_hi, win_lo, win_actor, win_value, present)``.  The new rows
    fold to their own per-key winners, which then merge with the table
    elementwise.  The tie-break is a total order, so
    ``fold_into(fold(A), B) == fold(A ++ B)``."""
    new = lww_fold(key, ts_hi, ts_lo, actor, value,
                   num_keys=num_keys, num_values=num_values)
    return lww_table_merge(new, win)
