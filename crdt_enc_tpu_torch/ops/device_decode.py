"""Device-side op decode — the ``CRDT_DEVICE_DECODE=1`` experiment.

The port's copy of ``crdt_enc_tpu/ops/device_decode.py``.  After the
bulk AEAD the cleartext of an op-file chunk is one dense byte stream
whose canonical msgpack framing is *fixed-width* for the common op
shape, so the field extraction is a strided gather plus integer
bit-twiddling, work a card does at memory bandwidth.

Scope: the **fixed-stride add op** — the canonical encoding of
``[KIND_ADD, member, [actor16, counter]]`` with a positive-fixint
member and counter::

    0x93 0x00 <member> 0x92 0xc4 0x10 <actor · 16 bytes> <counter>

23 bytes an op, preceded per payload by the canonical array header
(fixarray or array16).  A chunk qualifies only when EVERY payload is a
pure run of such ops (validated on the host with strided numpy passes,
no Python per op); anything else returns None and the caller uses the
native host decoder.  Removes, wide counters and non-fixint members are
out of scope: the experiment measures the device's best case.

:func:`decode_adds_device` uploads the cleartext and the per-op base
column (int64, the index type of PyTorch's gather) once to ``device``
(the session's own, ``cuda`` by default), counting both in
``h2d_bytes`` as the upload is enqueued where the device is a card;
gathers member, counter and the 16 actor bytes there; builds the two
big-endian 8-byte actor lanes in int64 on the device (a lane whose top
bit is set is negative there; the host reinterprets it as uint64 with
numpy ``.view``); and brings back the four small columns.  Actor
resolution (a 128-bit search over the sorted actor table) stays on the
host, as in the JAX package.  A chunk that fails validation or names an
unknown actor declines (None); a device failure raises — nothing turns
it into a decline.  The gate :func:`device_decode_enabled` is off by
default, so the default path never runs this module.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from ..utils import trace

#: fixed-stride add-op width (bytes) — module docstring layout
OP_STRIDE = 23


def device_decode_enabled() -> bool:
    return os.environ.get("CRDT_DEVICE_DECODE", "") == "1"


def _op_bases(buf: np.ndarray, offs: np.ndarray):
    """Per-op base offsets for a packed payload buffer, or None when any
    payload is not a pure fixed-stride add run.  Vectorized: header
    classification, length validation, and the constant-byte checks all
    run as strided numpy passes."""
    n_payloads = len(offs) - 1
    if n_payloads == 0 or len(buf) == 0:
        return None
    starts = offs[:-1].astype(np.int64)
    lens = np.diff(offs).astype(np.int64)
    if (lens < 1).any():
        return None
    if len(buf) > 2**31 - 1:
        return None  # the JAX package's int32 gather bound, kept for parity
    first = buf[starts]
    fix = (first & 0xF0) == 0x90
    a16 = first == 0xDC
    if not (fix | a16).all():
        return None
    hdr = np.where(fix, 1, 3)
    if (lens < hdr).any():
        return None
    counts = np.where(fix, first & 0x0F, 0).astype(np.int64)
    if a16.any():
        i = starts[a16]
        if (i + 2 >= offs[-1]).any():
            return None
        counts[a16] = (
            buf[i + 1].astype(np.int64) << 8
        ) | buf[i + 2].astype(np.int64)
    if (lens != hdr + OP_STRIDE * counts).any():
        return None
    total = int(counts.sum())
    if total == 0:
        return None
    # grouped arange: base[i] = payload_start + hdr + 23 * (op index
    # within payload), flattened across payloads in one cumsum trick
    op_starts = np.repeat(starts + hdr, counts)
    ends = np.cumsum(counts)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        ends - counts, counts
    )
    base = op_starts + OP_STRIDE * within
    # constant-byte + fixint validation, one gather each
    if (buf[base] != 0x93).any() or (buf[base + 1] != 0x00).any():
        return None
    if (buf[base + 3] != 0x92).any() or (buf[base + 4] != 0xC4).any():
        return None
    if (buf[base + 5] != 0x10).any():
        return None
    if (buf[base + 2] > 0x7F).any() or (buf[base + 22] > 0x7F).any():
        return None
    return base


def _resolve_actors(hi: np.ndarray, lo: np.ndarray, actors_sorted: list):
    """Rows' (hi, lo) big-endian actor lanes → indices into the sorted
    16-byte actor table, or None when any actor is unknown.  Vectorized
    two-stage searchsorted (hi first, lo refines the rare hi-collision
    runs)."""
    R = len(actors_sorted)
    if R == 0:
        return None
    try:
        table = np.frombuffer(
            b"".join(actors_sorted), np.uint8
        ).reshape(R, 16)
    except (TypeError, ValueError):
        # non-bytes or non-16-byte actor ids in the table: this corpus
        # cannot resolve here — decline to the host decoder (the
        # module's contract), never crash the fold
        return None
    w = (256 ** np.arange(7, -1, -1, dtype=np.uint64)).astype(np.uint64)
    t_hi = (table[:, :8].astype(np.uint64) * w).sum(axis=1, dtype=np.uint64)
    t_lo = (table[:, 8:].astype(np.uint64) * w).sum(axis=1, dtype=np.uint64)
    idx = np.searchsorted(t_hi, hi)
    if (idx >= R).any():
        return None
    ok = t_hi[idx] == hi
    if not ok.all():
        return None
    exact = t_lo[idx] == lo
    if not exact.all():
        # hi collision (distinct actors sharing 8 leading bytes): walk
        # the tied run per affected row — rare by construction (uuid4)
        bad = np.flatnonzero(~exact)
        for r in bad.tolist():
            j = int(idx[r])
            while j < R and t_hi[j] == hi[r] and t_lo[j] != lo[r]:
                j += 1
            if j >= R or t_hi[j] != hi[r] or t_lo[j] != lo[r]:
                return None
            idx[r] = j
    return idx.astype(np.int32)


def _tensor(a: np.ndarray):
    """A CPU tensor over ``a`` without a copy.  The cleartext buffer may
    be read-only (a view of bytes); the gathers only read it."""
    import torch

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable")
        return torch.from_numpy(a)


def decode_adds_device(packed, actors_sorted: list, device=None):
    """Decode a packed cleartext chunk of fixed-stride add ops on
    ``device`` (None means ``cuda``).  ``packed`` is the ``(buffer,
    offsets)`` pair the batch decrypt emits.  Returns the 6-tuple the
    fold session's remap consumes — ``(kind, member_idx, actor_idx,
    counter, members, member_bytes)`` — or None when the chunk does not
    qualify or names an unknown actor (the caller then takes the native
    host decoder)."""
    import torch

    buf, offs = packed
    buf = np.frombuffer(buf, np.uint8) if not isinstance(
        buf, np.ndarray
    ) else buf
    base = _op_bases(buf, np.asarray(offs))
    if base is None:
        return None
    device = torch.device("cuda" if device is None else device)
    with trace.span("device.decode"):
        # one upload of the cleartext and the gather base column, counted
        # as it is enqueued
        if device.type == "cuda":
            trace.add("h2d_bytes", buf.nbytes + base.nbytes)
            trace.add("h2d_pageable_bytes", buf.nbytes + base.nbytes)
        dbuf = _tensor(buf).to(device)
        dbase = _tensor(base).to(device)
        member = dbuf[dbase + 2].to(torch.int32)
        counter = dbuf[dbase + 22].to(torch.int32)
        # the 16 actor bytes as two big-endian 8-byte lanes in int64
        # (disjoint bits, so the sum is the OR; the top byte wraps into
        # the sign bit)
        cols = 6 + torch.arange(16, device=device, dtype=torch.int64)
        actor_mat = dbuf[dbase[:, None] + cols[None, :]].to(torch.int64)
        shifts = torch.arange(56, -1, -8, device=device, dtype=torch.int64)
        lanes = torch.stack(
            ((actor_mat[:, :8] << shifts).sum(dim=1),
             (actor_mat[:, 8:] << shifts).sum(dim=1)), dim=1)
        member = member.cpu().numpy()
        counter = counter.cpu().numpy()
        lanes = lanes.cpu().numpy()
    lanes = lanes.view(np.uint64)
    actor_idx = _resolve_actors(lanes[:, 0].copy(), lanes[:, 1].copy(),
                                actors_sorted)
    if actor_idx is None:
        return None
    uniq, member_idx = np.unique(member, return_inverse=True)
    members = [int(v) for v in uniq.tolist()]
    member_bytes = [bytes([v]) for v in uniq.tolist()]
    kind = np.zeros(len(base), np.int8)
    return (
        kind, member_idx.astype(np.int32), actor_idx,
        counter.astype(np.int32), members, member_bytes,
    )


def decode_adds_host(packed, actors_sorted: list):
    """The same fixed-stride extraction with numpy on the host — the
    experiment's control arm: identical eligibility, identical output,
    no device round trip.  (The product's host path is the native
    decoder in ops/native_decode.py, which also takes the general
    framing; this arm isolates "where does the gather run" from "who
    parses msgpack".)"""
    buf, offs = packed
    buf = np.frombuffer(buf, np.uint8) if not isinstance(
        buf, np.ndarray
    ) else buf
    base = _op_bases(buf, np.asarray(offs))
    if base is None:
        return None
    member = buf[base + 2].astype(np.int32)
    counter = buf[base + 22].astype(np.int32)
    w = (256 ** np.arange(7, -1, -1, dtype=np.uint64)).astype(np.uint64)
    actor_mat = buf[base[:, None] + (6 + np.arange(16))[None, :]]
    hi = (actor_mat[:, :8].astype(np.uint64) * w).sum(
        axis=1, dtype=np.uint64
    )
    lo = (actor_mat[:, 8:].astype(np.uint64) * w).sum(
        axis=1, dtype=np.uint64
    )
    actor_idx = _resolve_actors(hi, lo, actors_sorted)
    if actor_idx is None:
        return None
    uniq, member_idx = np.unique(member, return_inverse=True)
    members = [int(v) for v in uniq.tolist()]
    member_bytes = [bytes([v]) for v in uniq.tolist()]
    kind = np.zeros(len(base), np.int8)
    return (
        kind, member_idx.astype(np.int32), actor_idx,
        counter.astype(np.int32), members, member_bytes,
    )
