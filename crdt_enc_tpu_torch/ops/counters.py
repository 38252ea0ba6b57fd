"""Counter folds: segment-max over replica ids, in plain PyTorch.

The port's counterpart of ``crdt_enc_tpu/ops/counters.py``, with the same
contracts.  The JAX package computes these folds in XLA, outside any
Pallas kernel, so one plain implementation serves the CPU and the card:
``scatter_reduce_(..., "amax")`` into zeroed planes, then
``max(clock0, ·)``.  The JAX sort route (``SORTED_MIN_ROWS``) tunes the
TPU, which has no fast scatter, and has no twin here.

The planes keep the dtype of the clocks they start from: int32, or int64
when a counter needs it (``ops.columnar.vclock_to_dense``).  The
``value`` scalar is an int64 sum and advisory, as on the JAX side: the
authoritative value is read host-side from the planes.
"""

from __future__ import annotations

import torch

from ..models.counters import NEG, POS
from .orset import common_device, tenant_columns


def _segment_max(seg, vals, live, n_segments: int, like):
    """Per-segment max of ``vals`` over the ``live`` rows, into zeroed
    ``(n_segments,)`` planes of ``like``'s dtype: untouched segments
    read 0 and counters ≤ 0 change nothing."""
    out = torch.zeros(n_segments, dtype=like.dtype, device=like.device)
    if seg.shape[0] and n_segments:
        zero = torch.zeros((), dtype=seg.dtype, device=seg.device)
        out.scatter_reduce_(
            0, torch.where(live, seg, zero).long(),
            torch.where(live, vals.to(like.dtype), out.new_zeros(())),
            reduce="amax",
        )
    return out


def gcounter_fold(clock0, actor, counter, *, num_replicas: int):
    """Fold increment dots into the per-replica clock.  Rows with an actor
    outside ``[0, R)`` (the ``actor == R`` padding sentinel included) drop
    out.  Returns ``(clock, value)``, value = sum(clock)."""
    common_device(clock0, actor, counter)
    R = num_replicas
    live = (actor >= 0) & (actor < R)
    clock = torch.maximum(clock0, _segment_max(actor, counter, live, R, clock0))
    return clock, clock.sum(dtype=torch.int64)


def gcounter_fold_tenants(clock0, actor, counter, *, num_replicas: int):
    """The multi-tenant G-Counter fold (the JAX package's
    ``gcounter_fold_tenants``): clocks ``(T, R)``, rows ``(T, N)`` with
    per-tenant actors (``actor == R`` pads).  One ``gcounter_fold`` over
    ``T·R`` replicas, tenant t's replica r at ``t·R + r`` (the tenant
    layout of ``ops.orset.tenant_columns``).  Returns the ``(T, R)``
    clocks."""
    T = actor.shape[0]
    R = num_replicas
    clock, _value = gcounter_fold(
        clock0.reshape(T * R), tenant_columns(actor, R), counter.reshape(-1),
        num_replicas=T * R,
    )
    return clock.view(T, R)


def pncounter_fold(p0, n0, sign, actor, counter, *, num_replicas: int):
    """Fold (sign, dot) rows into the P and N clocks.  Padding rows and
    signs outside {POS, NEG} drop out.  Returns ``(p, n, value)``."""
    common_device(p0, n0, sign, actor, counter)
    R = num_replicas
    valid = (actor >= 0) & (actor < R)
    is_neg = sign == NEG
    live = valid & ((sign == POS) | is_neg)
    # negative rows scatter into the second half of one (2R,) target
    seg = torch.where(is_neg, actor + R, actor)
    both = _segment_max(seg, counter, live, 2 * R, p0)
    p = torch.maximum(p0, both[:R])
    n = torch.maximum(n0, both[R:].to(n0.dtype))
    value = p.sum(dtype=torch.int64) - n.sum(dtype=torch.int64)
    return p, n, value


def vclock_merge(a, b):
    """Elementwise-max merge of dense vector clocks (same replica vocab)."""
    return torch.maximum(a, b)
