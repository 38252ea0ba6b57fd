"""Batched native decode: decrypted op payloads → columnar arrays.

The port's copy of the payload decoders of
``crdt_enc_tpu/ops/native_decode.py`` over its own native library: each
payload is the msgpack body of one op file; the C++ decoder flattens every
payload into shared (kind, member-span, actor, counter) arrays, and the
member spans are interned by a native hash pass, so no per-row Python runs
on the million-op path.

The decoders return None when a payload defeats them (unknown actor,
non-canonical encoding, a counter past int32); callers then take the
per-op Python path.  A missing native library raises.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..utils import codec


def _shared_buffer_of(payloads):
    """The single object every memoryview payload slices, or None.

    The batch decrypt hands out zero-copy views of one cleartext buffer
    (``decrypt_blobs``); spotting that here lets the decoder skip
    re-joining what is already contiguous memory."""
    first = payloads[0] if payloads else None
    if type(first) is not memoryview:
        return None
    obj = first.obj
    for p in payloads:
        if type(p) is not memoryview or p.obj is not obj or not p.contiguous:
            return None
    return obj


def _payload_spans(payloads):
    """(buffer, bases, lens) of a non-empty payload list: the shared
    cleartext buffer with each view's offset, or one joined copy."""
    lens = np.fromiter((len(p) for p in payloads), np.uint64, count=len(payloads))
    big = _shared_buffer_of(payloads)
    if big is not None:
        base0 = np.frombuffer(big, np.uint8).ctypes.data
        bases = np.fromiter(
            (np.frombuffer(p, np.uint8).ctypes.data - base0 for p in payloads),
            np.uint64, count=len(payloads),
        )
    else:
        big = b"".join(payloads)
        bases = np.zeros(len(payloads), np.uint64)
        np.cumsum(lens[:-1], out=bases[1:])
    return np.frombuffer(big, np.uint8), bases, lens


def decode_orset_payload_batch(payloads: list, actors_sorted: list):
    """Decode many ORSet op payloads against a sorted actor table.

    Returns ``(kind, member_idx, actor_idx, counter, members)`` — flat
    int arrays over all payloads' rows plus the interned member-object
    list (first-appearance order) — or None to request the per-op path.
    """
    if not payloads:
        z32 = np.zeros(0, np.int32)
        return np.zeros(0, np.int8), z32, z32, z32, []
    lib = native.load()
    buf, bases, lens = _payload_spans(payloads)
    actors_flat = b"".join(actors_sorted)
    # hash index over the actor table: one probe per op instead of a
    # 17-deep binary search at 100k actors
    n_slots = 8
    while n_slots < 2 * max(len(actors_sorted), 1):
        n_slots *= 2
    slots = np.empty(n_slots, np.int32)
    ap, _a = native.in_ptr(actors_flat)
    lib.actor_hash_build(ap, len(actors_sorted),
                         slots.ctypes.data_as(native.i32p), n_slots)

    # single-pass growable decode: validates framing and emits rows in
    # one msgpack walk; the handle is freed by take (or drop)
    n_rows = np.zeros(1, np.int64)
    handle = lib.orset_decode_batch_grow(
        buf.ctypes.data_as(native.u8p), bases.ctypes.data_as(native.u64p),
        lens.ctypes.data_as(native.u64p), len(payloads),
        ap, len(actors_sorted), slots.ctypes.data_as(native.i32p), n_slots,
        n_rows.ctypes.data_as(native.i64p),
    )
    if not handle:
        return None
    taken = False
    try:
        total = int(n_rows[0])
        kind = np.zeros(total, np.int8)
        moff = np.zeros(total, np.uint64)
        mlen = np.zeros(total, np.uint64)
        actor = np.zeros(total, np.int32)
        counter = np.zeros(total, np.int32)
        taken = True  # take() frees the handle even if a copy would fail
        lib.orset_decode_take(
            handle,
            kind.ctypes.data_as(native.i8p),
            moff.ctypes.data_as(native.u64p),
            mlen.ctypes.data_as(native.u64p),
            actor.ctypes.data_as(native.i32p),
            counter.ctypes.data_as(native.i32p),
        )
    finally:
        if not taken:  # e.g. MemoryError sizing the output arrays
            lib.orset_decode_drop(handle)
    member_idx, members = intern_spans(buf, moff, mlen)
    return kind, member_idx, actor, counter, members


def intern_spans(buf: np.ndarray, off: np.ndarray, length: np.ndarray):
    """Span interning: rows → dense member indices (first-appearance
    order) + the decoded unique member objects.  One native
    open-addressing hash pass; the unique spans — a few thousand at
    most — decode through ``codec.unpack``."""
    n = len(off)
    if n == 0:
        return np.zeros(0, np.int32), []
    if (np.asarray(length) == 0).any():
        raise ValueError("empty member span")
    lib = native.load()
    cap = 1 << max(11, (2 * n - 1).bit_length())
    table = np.full(cap, -1, np.int64)
    idx = np.zeros(n, np.int32)
    uniq_off = np.zeros(n, np.uint64)
    uniq_len = np.zeros(n, np.uint64)
    off64 = np.ascontiguousarray(off, np.uint64)
    len64 = np.ascontiguousarray(length, np.uint64)
    got = lib.intern_spans_native(
        buf.ctypes.data_as(native.u8p), off64.ctypes.data_as(native.u64p),
        len64.ctypes.data_as(native.u64p), n,
        table.ctypes.data_as(native.i64p), cap,
        idx.ctypes.data_as(native.i32p),
        uniq_off.ctypes.data_as(native.u64p),
        uniq_len.ctypes.data_as(native.u64p), n,
    )
    if got < 0:  # cannot happen: table and unique capacity cover n rows
        raise RuntimeError("intern_spans_native ran out of capacity")
    mv = memoryview(np.ascontiguousarray(buf))
    members = [
        codec.unpack(mv[o : o + ln])
        for o, ln in zip(uniq_off[:got].tolist(), uniq_len[:got].tolist())
    ]
    return idx, members


def decode_counter_payload_batch(payloads: list, actors_sorted: list):
    """Decode many counter op payloads.  Returns ``(sign, actor_idx,
    counter)`` flat arrays, or None for the per-op path."""
    if not payloads:
        return np.zeros(0, np.int8), np.zeros(0, np.int32), np.zeros(0, np.int32)
    lib = native.load()
    buf, bases, lens = _payload_spans(payloads)
    actors_flat = b"".join(actors_sorted)
    ap, _a = native.in_ptr(actors_flat)
    # every op costs more than one encoded byte, so the payload bytes
    # bound the row count
    cap = max(int(lens.sum()), 1)
    sign = np.zeros(cap, np.int8)
    actor = np.zeros(cap, np.int32)
    counter = np.zeros(cap, np.int32)
    got = lib.counter_decode_batch(
        buf.ctypes.data_as(native.u8p),
        bases.ctypes.data_as(native.u64p),
        lens.ctypes.data_as(native.u64p),
        len(payloads),
        ap,
        len(actors_sorted),
        sign.ctypes.data_as(native.i8p),
        actor.ctypes.data_as(native.i32p),
        counter.ctypes.data_as(native.i32p),
    )
    if got < 0:
        return None
    return sign[:got], actor[:got], counter[:got]
