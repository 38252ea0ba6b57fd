"""Columnar encodings bridging host CRDT states and the device kernels.

The OR-Set, counter and LWW parts of ``crdt_enc_tpu/ops/columnar.py``.
The kernels consume dense tensors; states and op logs are sparse,
dict-shaped host objects.  This module owns the conversion:

* **interning**: replica UUIDs and set members become dense indices via a
  ``Vocab`` (order of first appearance; canonical output never depends on
  intern order because serialization re-sorts),
* **op columns**: a batch of OR-Set ops flattens to parallel int arrays —
  one row per add-dot or per (remove × context-actor),
* **state planes**: an ORSet becomes ``(clock[R], add[E,R], rm[E,R])``
  int32 matrices and back, losslessly; a counter's VClock a dense
  ``(R,)`` vector,
* **LWW columns**: actors and values are *rank*-interned (sorted by
  their bytes), so integer order on the device is the host's byte order.

* **sparse fold**: in the regime where the planes would be mostly zeros
  (``orset_fold_sparse_host``), the batch folds on the host by sort and
  run ends, straight into the sparse state (``orset_apply_coo``); a fold
  into an empty state runs natively (``statebuild.cpp``) and stashes its
  surviving rows for the warm-open checkpoint,
* **checkpoint rows**: an ORSet as flat int row buffers over interned
  actor and member tables (``orset_pack_checkpoint`` and its inverse).

The dict writeback of a plane, of a row batch or of a checkpoint runs
natively (``grouped_rows_dicts``); rows the pass refuses (an index out of
range) raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..models.counters import NEG, POS
from ..models.lwwmap import LWWOp
from ..models.orset import AddOp, ORSet, RmOp, op_from_obj
from ..models.vclock import Dot, VClock
from ..utils import codec, trace

KIND_ADD = 0
KIND_RM = 1


def pad_orset_rows(cols: "OrsetColumns", target: int, num_replicas: int):
    """Pad flattened op columns to ``target`` rows with sentinel no-ops
    (``actor == num_replicas`` marks padding — the single invariant every
    fold kernel keys on)."""
    n = len(cols.kind)
    padn = target - n
    if padn > 0:
        cols.kind = np.concatenate([cols.kind, np.zeros(padn, np.int8)])
        cols.member = np.concatenate([cols.member, np.zeros(padn, np.int32)])
        cols.actor = np.concatenate(
            [cols.actor, np.full(padn, num_replicas, np.int32)]
        )
        cols.counter = np.concatenate([cols.counter, np.zeros(padn, np.int32)])
    return cols


class Vocab:
    """Interning table: object → dense index (first-appearance order)."""

    __slots__ = ("items", "index")

    def __init__(self, items=()):
        self.items: list = []
        self.index: dict = {}
        for it in items:
            self.intern(it)

    def intern(self, item) -> int:
        idx = self.index.get(item)
        if idx is None:
            idx = len(self.items)
            self.index[item] = idx
            self.items.append(item)
        return idx

    def __len__(self) -> int:
        return len(self.items)


@dataclass
class OrsetColumns:
    """Flattened ORSet op batch (one row per dot / per rm-context entry)."""

    kind: np.ndarray  # int8  — KIND_ADD | KIND_RM
    member: np.ndarray  # int32 — index into members vocab
    actor: np.ndarray  # int32 — index into replicas vocab
    counter: np.ndarray  # int32 — dot counter / remove horizon
    members: Vocab = field(default_factory=Vocab)
    replicas: Vocab = field(default_factory=Vocab)


def orset_ops_to_columns(
    ops, members: Vocab | None = None, replicas: Vocab | None = None
) -> OrsetColumns:
    members = members if members is not None else Vocab()
    replicas = replicas if replicas is not None else Vocab()
    kind, member, actor, counter = [], [], [], []
    for op in ops:
        if isinstance(op, (list, tuple)):
            op = op_from_obj(op)
        if isinstance(op, AddOp):
            kind.append(KIND_ADD)
            member.append(members.intern(op.member))
            actor.append(replicas.intern(op.dot.actor))
            counter.append(op.dot.counter)
        elif isinstance(op, RmOp):
            m = members.intern(op.member)
            # sorted-actor order matches the canonical packed form
            for r, c in sorted(op.ctx.counters.items()):
                kind.append(KIND_RM)
                member.append(m)
                actor.append(replicas.intern(r))
                counter.append(c)
        else:
            raise TypeError(f"bad ORSet op {op!r}")
    return OrsetColumns(
        np.asarray(kind, np.int8),
        np.asarray(member, np.int32),
        np.asarray(actor, np.int32),
        np.asarray(counter, np.int32),
        members,
        replicas,
    )


def orset_scan_vocab(state: ORSet, members: Vocab, replicas: Vocab) -> None:
    """Grow the vocabularies with everything the state mentions, without
    building planes — the cheap first pass when densifying many states to
    a shared vocabulary.  New actors append in sorted order
    (deterministic), collected through one ``set.update`` per entry dict."""
    if not state.entries and not state.deferred and not state.clock.counters:
        return
    actor_set: set = set()
    for m, entry in state.entries.items():
        members.intern(m)
        actor_set.update(entry)
    for m, dfr in state.deferred.items():
        members.intern(m)
        actor_set.update(dfr)
    actor_set.update(state.clock.counters)
    index = replicas.index
    new = [r for r in actor_set if r not in index]
    try:
        new.sort()
    except TypeError:  # mixed-type actor ids: sort by canonical bytes
        new.sort(key=codec.pack)
    for r in new:
        replicas.intern(r)


def orset_fits_int32(state: ORSet) -> bool:
    """Whether ``state``'s counters fit the int32 planes: its clock and
    its remove horizons (an entry's dot never passes its actor's clock).
    O(clock + deferred), no walk of the entries."""
    top = max(state.clock.counters.values(), default=0)
    for dfr in state.deferred.values():
        top = max(top, max(dfr.values(), default=0))
    return top <= 2**31 - 1


def orset_state_to_planes(
    state: ORSet, members: Vocab, replicas: Vocab, *, scanned: bool = False
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense ``(clock[R], add[E,R], rm[E,R])`` planes (int32).

    The vocabs are extended in place with anything the state mentions;
    pass ``scanned=True`` when ``orset_scan_vocab`` already ran for this
    state (skips a redundant sparse pass).
    """
    if not scanned:
        orset_scan_vocab(state, members, replicas)
    E, R = len(members), len(replicas)
    clock = np.zeros(R, np.int32)
    add = np.zeros((E, R), np.int32)
    rm = np.zeros((E, R), np.int32)
    for r, c in state.clock.counters.items():
        clock[replicas.index[r]] = c
    for m, entry in state.entries.items():
        e = members.index[m]
        for r, c in entry.items():
            add[e, replicas.index[r]] = c
    for m, dfr in state.deferred.items():
        e = members.index[m]
        for r, c in dfr.items():
            rm[e, replicas.index[r]] = c
    return clock, add, rm


def _grouped_rows_dicts_native(
    m_idx: np.ndarray, a_idx: np.ndarray, ctr: np.ndarray,
    members: list, actors: list, target: dict,
) -> None:
    """The one home of the native ``grouped_rows_dicts`` call
    (statebuild.cpp): member-contiguous int32/int32/int64 rows → nested
    ``{member: {actor: counter}}`` dicts in one C pass.  Raises — with
    ``target`` left EMPTY (a partial fill is cleared) — where the pass
    refuses the rows: a member or actor index out of range (a corrupt
    checkpoint, a caller's bug) or an allocation failure.  A failed build
    of the library raises too, and so do columns of unequal lengths (the
    pass would read past the shorter)."""
    import ctypes

    from .. import native

    if not len(m_idx) == len(a_idx) == len(ctr):
        raise ValueError(f"row columns of unequal lengths {len(m_idx)}, "
                         f"{len(a_idx)}, {len(ctr)}")
    lib = native.load_state()
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    m_idx = np.ascontiguousarray(m_idx, np.int32)
    a_idx = np.ascontiguousarray(a_idx, np.int32)
    ctr = np.ascontiguousarray(ctr, np.int64)
    rc = lib.grouped_rows_dicts(
        m_idx.ctypes.data_as(i32p), a_idx.ctypes.data_as(i32p),
        ctr.ctypes.data_as(i64p), len(m_idx), members, actors, target,
    )
    if rc != 0:
        target.clear()
        raise RuntimeError(
            f"grouped_rows_dicts refused {len(m_idx)} rows over "
            f"{len(members)} members and {len(actors)} actors (an index "
            "out of range, or out of memory)")


def _fill_dicts_from_plane(plane: np.ndarray, members: Vocab,
                           replicas: Vocab, target: dict) -> None:
    """Nonzero plane cells → nested ``{member: {actor: counter}}`` dicts.
    ``np.nonzero`` yields cells in row-major order, i.e. grouped by member
    — the contiguous-groups contract of the native pass."""
    es, rs = np.nonzero(plane)
    if len(es):
        _grouped_rows_dicts_native(es, rs, plane[es, rs], members.items,
                                   replicas.items, target)


def orset_planes_to_state(
    clock: np.ndarray, add: np.ndarray, rm: np.ndarray, members: Vocab, replicas: Vocab
) -> ORSet:
    """Inverse of ``orset_state_to_planes`` (planes must be normalized:
    entries killed where add ≤ rm, rm zeroed where rm ≤ clock)."""
    clock = np.asarray(clock)
    add = np.asarray(add)
    rm = np.asarray(rm)
    state = ORSet()
    state.clock = VClock(
        {replicas.items[r]: int(clock[r]) for r in np.nonzero(clock)[0]}
    )
    _fill_dicts_from_plane(add, members, replicas, state.entries)
    _fill_dicts_from_plane(rm, members, replicas, state.deferred)
    return state


# ---- the sparse regime -----------------------------------------------------


def orset_fold_sparse_host(
    state: ORSet,
    kind: np.ndarray,
    member: np.ndarray,
    actor: np.ndarray,
    counter: np.ndarray,
    members: Vocab,
    replicas: Vocab,
) -> ORSet:
    """Vectorized sparse fold on the host: the dense fold's semantics
    without the planes.

    Per-segment max of live-add dots and remove horizons, stale-filtered
    against the state clock, via ``np.lexsort`` run boundaries: in the
    N ≪ E·R regime the work is one sort and no dense planes exist.  int64 keys — no
    ``2·E·R < 2^31`` bound.  A fold into an empty state (the streaming
    shape) takes the native fold of ``statebuild.cpp`` instead, and falls
    through here where that declines (a shape past its packed sort, a
    counter or clock past int32)."""
    state._mut += 1
    # dense clock FIRST: it may intern clock actors into `replicas`, and
    # the segment keys below must be encoded with the final R or
    # orset_apply_coo would decode them against a different modulus
    clock0 = vclock_to_dense(state.clock, replicas).astype(np.int64)
    E, R = len(members), len(replicas)
    if not state.entries and not state.deferred and E and R:
        folded = _orset_fresh_fold_native(
            state, kind, member, actor, counter, members, replicas, clock0
        )
        if folded is not None:
            return folded
    kind = np.asarray(kind)
    member = np.asarray(member, np.int64)
    actor = np.asarray(actor, np.int64)
    counter = np.asarray(counter, np.int64)
    pad = actor >= R
    a_ix = np.minimum(actor, R - 1)
    is_add = (kind == KIND_ADD) & ~pad
    is_rm = (kind == KIND_RM) & ~pad
    live = is_add & (counter > clock0[a_ix])
    valid = live | is_rm
    seg = member * R + a_ix
    key = np.where(is_rm, seg + E * R, seg)[valid]
    c = counter[valid]
    order = np.lexsort((c, key))
    sk = key[order]
    sc = c[order]
    is_last = np.ones(len(sk), bool)
    if len(sk) > 1:
        is_last[:-1] = sk[:-1] != sk[1:]
    clock = clock0.copy()
    np.maximum.at(clock, a_ix[live], counter[live])
    # int64 throughout: narrowing here would silently wrap a > 2^31 clock
    return orset_apply_coo(state, clock, sk, sc, is_last, members, replicas)


#: rows below this skip the checkpoint-stash bookkeeping — repacking a
#: tiny state from its dicts costs less than carrying the row arrays
CKPT_STASH_MIN_ROWS = 4096


def _orset_fresh_fold_native(
    state, kind, member, actor, counter, members, replicas, clock0
):
    """The native fresh-state sparse fold (statebuild.cpp), byte-identical
    to the numpy path of :func:`orset_fold_sparse_host`.  Returns the
    folded state, or None where it declines: a counter, member or clock
    that int32 narrowing would change, or a shape past the packed sort.

    The pure-C fold (gate, packed-u64 radix sort, dedup, survivor filter)
    runs under ``session.sparse_fold``, the dict writeback under
    ``session.writeback``.  The surviving rows come out member-contiguous
    in the :func:`orset_pack_checkpoint_rows` layout and, from
    ``CKPT_STASH_MIN_ROWS`` rows on, are stashed on the state as
    ``_ckpt_rows`` under the epoch they were folded at, so the
    compaction's checkpoint seals straight from them (core.py
    ``_pack_checkpoint_state``)."""
    import ctypes

    from .. import native

    lib = native.load_state()
    # the writeback below mutates entries/deferred/clock directly
    state._mut += 1
    E, R = len(members), len(replicas)
    kind = np.ascontiguousarray(kind, np.int8)
    member32 = np.ascontiguousarray(member, np.int32)
    actor32 = np.ascontiguousarray(np.minimum(actor, R), np.int32)
    counter32 = np.ascontiguousarray(counter, np.int32)
    if len(member32) and (
        int(counter32.max(initial=0)) != int(np.asarray(counter).max(initial=0))
        or int(member32.max(initial=0)) >= E
    ):
        return None  # int32 narrowing lost information — numpy path
    if len(clock0) and int(np.asarray(clock0).max(initial=0)) > 2**31 - 1:
        return None  # an int64 clock would wrap through the int32 gate
    clock = np.ascontiguousarray(clock0, np.int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    with trace.span("session.sparse_fold"):
        counts = np.zeros(2, np.int64)
        handle = lib.orset_fold_rows(
            kind.ctypes.data_as(i8p),
            member32.ctypes.data_as(i32p),
            actor32.ctypes.data_as(i32p),
            counter32.ctypes.data_as(i32p),
            len(kind), E, R,
            clock.ctypes.data_as(i32p),
            counts.ctypes.data_as(i64p),
        )
        if not handle:
            return None  # packed-sort overflow / allocation failure
        n_a, n_d = int(counts[0]), int(counts[1])
        taken = False
        try:
            am = np.zeros(n_a, np.int32)
            aa = np.zeros(n_a, np.int32)
            ac = np.zeros(n_a, np.int64)
            dm = np.zeros(n_d, np.int32)
            da = np.zeros(n_d, np.int32)
            dc = np.zeros(n_d, np.int64)
            taken = True  # take() frees the handle whatever it returns
            rc = lib.orset_fold_rows_take(
                handle,
                am.ctypes.data_as(i32p), aa.ctypes.data_as(i32p),
                ac.ctypes.data_as(i64p), n_a,
                dm.ctypes.data_as(i32p), da.ctypes.data_as(i32p),
                dc.ctypes.data_as(i64p), n_d,
            )
            if rc != 0:
                raise RuntimeError("orset_fold_rows_take capacity mismatch")
        finally:
            if not taken:  # e.g. MemoryError sizing the output arrays
                lib.orset_fold_rows_drop(handle)
    with trace.span("session.writeback"):
        if n_a:
            _grouped_rows_dicts_native(am, aa, ac, members.items,
                                       replicas.items, state.entries)
        if n_d:
            _grouped_rows_dicts_native(dm, da, dc, members.items,
                                       replicas.items, state.deferred)
        state.clock = VClock(lib.dense_clock_dict(
            clock.ctypes.data_as(i32p), R, replicas.items))
    if n_a + n_d >= CKPT_STASH_MIN_ROWS:
        state._ckpt_rows = (
            state._mut,
            (clock.copy(), am, aa, ac, dm, da, dc, members, replicas),
        )
    return state


def orset_apply_coo(
    state: ORSet,
    clock_dense: np.ndarray,
    seg_keys: np.ndarray,
    seg_max: np.ndarray,
    is_seg_max: np.ndarray,
    members: Vocab,
    replicas: Vocab,
) -> ORSet:
    """Fold sorted per-segment maxima (:func:`orset_fold_sparse_host`'s
    run ends) into the sparse host state.

    Applies exactly the dense fold's semantics without planes: per touched
    segment, entry ``= max(entry, add-dot)``, remove horizon ``=
    max(horizon, batch horizon)``, then the normalization rules — entries
    killed where ``entry ≤ horizon``, horizons dropped where ``≤ clock`` —
    via the state's own ``_normalize_member``.  Touched members plus every
    member holding deferred horizons are normalized: the batch may have
    advanced clocks that retire horizons it never mentioned.  Members
    absent from the state take a vectorized path."""
    state._mut += 1
    E, R = len(members), len(replicas)
    sel = np.asarray(is_seg_max)
    k = np.asarray(seg_keys)[sel].astype(np.int64)
    c = np.asarray(seg_max)[sel]
    mobj = members.items
    aobj_arr = np.asarray(replicas.items, dtype=object)

    # keys are sorted: adds (key < E·R) form the prefix, removes the
    # suffix, and within each side rows are member-major — so members are
    # contiguous groups and fresh entries build as one dict(zip(...))
    split = int(np.searchsorted(k, E * R))
    ak, ac = k[:split], c[:split]
    rk, rc = k[split:] - E * R, c[split:]
    a_m, a_a = ak // R, ak % R
    r_m, r_a = rk // R, rk % R

    # members absent from BOTH entries and deferred: their post-merge
    # dicts are the batch segments with the normalization rules applied
    # column-wise, so no per-member normalize is needed
    clock_arr = np.asarray(clock_dense, np.int64)
    if not state.entries and not state.deferred:
        fresh = None  # all members fresh
        a_fresh = np.ones(len(ak), bool)
        r_fresh = np.ones(len(rk), bool)
        pre_deferred: list = []
    else:
        existing = set(state.entries)
        existing.update(state.deferred)
        pre_deferred = list(state.deferred)
        fresh = np.fromiter((mo not in existing for mo in mobj), bool,
                            count=E)
        a_fresh = fresh[a_m]
        r_fresh = fresh[r_m]

    def build_fresh(m_idx, a_idx, vals, target: dict):
        if not len(m_idx):
            return
        starts = np.flatnonzero(np.r_[True, np.diff(m_idx) != 0])
        ends = np.r_[starts[1:], len(m_idx)]
        a_objs = aobj_arr[a_idx].tolist()
        vv = vals.tolist()
        for s, e in zip(starts.tolist(), ends.tolist()):
            target[mobj[int(m_idx[s])]] = dict(zip(a_objs[s:e], vv[s:e]))

    # fresh adds survive the batch horizon of their own (m, a) segment
    # (strict >: an equal horizon observed the dot — it dies)
    if len(rk):
        pos = np.minimum(np.searchsorted(rk, ak), len(rk) - 1)
        horizon = np.where(rk[pos] == ak, rc[pos], 0)
        keep_add = a_fresh & (ac > horizon)
    else:
        keep_add = a_fresh
    build_fresh(a_m[keep_add], a_a[keep_add], ac[keep_add], state.entries)
    # fresh horizons: only those the merged clock has not caught up with
    keep_rm = r_fresh & (rc > clock_arr[r_a])
    build_fresh(r_m[keep_rm], r_a[keep_rm], rc[keep_rm], state.deferred)

    # members with pre-existing state merge by max, then normalize
    touched: set = set()
    aobj = replicas.items

    def fold_groups(m_idx, a_idx, vals, target: dict):
        a_idx = a_idx.tolist()
        vals = vals.tolist()
        starts = np.flatnonzero(np.r_[True, np.diff(m_idx) != 0])
        ends = np.r_[starts[1:], len(m_idx)]
        for s, e in zip(starts.tolist(), ends.tolist()):
            mo = mobj[int(m_idx[s])]
            touched.add(mo)
            slot = target.setdefault(mo, {})
            for x, cc in zip(a_idx[s:e], vals[s:e]):
                ao = aobj[x]
                if cc > slot.get(ao, 0):
                    slot[ao] = cc

    if fresh is not None:
        stale_a = ~a_fresh
        if stale_a.any():
            fold_groups(a_m[stale_a], a_a[stale_a], ac[stale_a], state.entries)
        stale_r = ~r_fresh
        if stale_r.any():
            fold_groups(r_m[stale_r], r_a[stale_r], rc[stale_r], state.deferred)

    state.clock = dense_to_vclock(clock_dense, replicas)
    touched.update(pre_deferred)
    for mo in touched:
        state._normalize_member(mo)
    return state


# ---- checkpoint pack/unpack ------------------------------------------------


def orset_pack_checkpoint(state: ORSet) -> dict | None:
    """Columnar encoding of one ORSet for the local fold checkpoint
    (core.py ``save_checkpoint``): the three sparse tables flatten to raw
    int row buffers over interned actor/member tables, so a large clock
    packs and loads as ``np.frombuffer`` plus one zip instead of a per-key
    map walk.  Lossless by value.  Returns None when any counter falls
    outside int64 (the caller then seals the adapter's object form)."""
    actors = Vocab()
    members = Vocab()
    for r in state.clock.counters:
        actors.intern(r)

    def rows(table: dict):
        m_idx, a_idx, ctr = [], [], []
        for m, slots in table.items():
            e = members.intern(m)
            for r, c in slots.items():
                m_idx.append(e)
                a_idx.append(actors.intern(r))
                ctr.append(c)
        return (
            np.asarray(m_idx, np.int32),
            np.asarray(a_idx, np.int32),
            np.asarray(ctr, np.int64),
        )

    try:
        clock_ctr = np.asarray(list(state.clock.counters.values()), np.int64)
        em, ea, ec = rows(state.entries)
        dm, da, dc = rows(state.deferred)
    except OverflowError:
        return None
    return {
        b"actors": list(actors.items),
        b"members": list(members.items),
        b"nc": len(state.clock.counters),
        b"cc": clock_ctr.tobytes(),
        b"em": em.tobytes(), b"ea": ea.tobytes(), b"ec": ec.tobytes(),
        b"dm": dm.tobytes(), b"da": da.tobytes(), b"dc": dc.tobytes(),
    }


def orset_pack_checkpoint_rows(
    clock: np.ndarray, am, aa, ac, dm, da, dc,
    members: Vocab, replicas: Vocab,
) -> dict:
    """:func:`orset_pack_checkpoint` computed from the fresh fold's
    surviving row columns (``_orset_fresh_fold_native``'s stash), by
    vectorized index remaps with no walk of the state's dicts.  Same wire
    keys and invariants as the dict pack (clock actors first and aligned
    with ``cc``, member groups contiguous, only referenced objects
    listed); the table and row ORDER may differ from the dict walk, which
    :func:`orset_unpack_checkpoint` does not depend on."""
    clock = np.asarray(clock)
    cnz = np.nonzero(clock)[0]
    used = np.union1d(np.union1d(cnz, aa), da)
    a_order = np.concatenate([cnz, np.setdiff1d(used, cnz)])
    a_perm = np.zeros((int(a_order.max()) + 1) if len(a_order) else 1,
                      np.int32)
    a_perm[a_order] = np.arange(len(a_order), dtype=np.int32)
    em = np.unique(am)
    m_order = np.concatenate([em, np.setdiff1d(np.unique(dm), em)])
    m_perm = np.zeros((int(m_order.max()) + 1) if len(m_order) else 1,
                      np.int32)
    m_perm[m_order] = np.arange(len(m_order), dtype=np.int32)
    aobj, mobj = replicas.items, members.items
    return {
        b"actors": [aobj[int(i)] for i in a_order],
        b"members": [mobj[int(i)] for i in m_order],
        b"nc": len(cnz),
        b"cc": clock[cnz].astype(np.int64).tobytes(),
        b"em": m_perm[am].tobytes(),
        b"ea": a_perm[aa].tobytes(),
        b"ec": np.asarray(ac, np.int64).tobytes(),
        b"dm": m_perm[dm].tobytes(),
        b"da": a_perm[da].tobytes(),
        b"dc": np.asarray(dc, np.int64).tobytes(),
    }


def orset_pack_checkpoint_planes(
    clock: np.ndarray, add: np.ndarray, rm: np.ndarray,
    members: Vocab, replicas: Vocab,
) -> dict:
    """:func:`orset_pack_checkpoint` computed from dense canonical planes
    (the fold service holds each tenant's folded planes): ``np.nonzero``
    yields the entry and deferred row columns in row-major, so
    member-contiguous, order, and the one row packer
    (:func:`orset_pack_checkpoint_rows`) builds the payload.  Planes may
    be bucket-padded: padded cells are zero and never name an index past
    the vocabularies."""
    clock = np.asarray(clock)
    add = np.asarray(add)
    rm = np.asarray(rm)
    es, rs = np.nonzero(add)
    ds, qs = np.nonzero(rm)
    return orset_pack_checkpoint_rows(
        clock, es, rs, add[es, rs], ds, qs, rm[ds, qs], members, replicas
    )


def orset_unpack_checkpoint(obj) -> ORSet:
    """Inverse of :func:`orset_pack_checkpoint` (and of the rows pack)."""
    state = ORSet()
    actors = list(obj[b"actors"])
    members = list(obj[b"members"])
    nc = int(obj[b"nc"])
    cc = np.frombuffer(bytes(obj[b"cc"]), np.int64)
    state.clock = VClock(dict(zip(actors[:nc], cc.tolist())))

    def build(mi, ai, ci, target: dict):
        m_idx = np.frombuffer(bytes(obj[mi]), np.int32)
        if not len(m_idx):
            return
        a_idx = np.frombuffer(bytes(obj[ai]), np.int32)
        ctr = np.frombuffer(bytes(obj[ci]), np.int64)
        # each member's rows are contiguous (the pack contract)
        _grouped_rows_dicts_native(m_idx, a_idx, ctr, members, actors,
                                   target)

    build(b"em", b"ea", b"ec", state.entries)
    build(b"dm", b"da", b"dc", state.deferred)
    return state


# ---- counters ------------------------------------------------------------

INT32_MAX = 2**31 - 1


@dataclass
class CounterColumns:
    sign: np.ndarray  # int8 — POS | NEG (always POS for G-Counter)
    actor: np.ndarray  # int32
    counter: np.ndarray  # int32, or int64 when a counter needs it
    replicas: Vocab = field(default_factory=Vocab)


def _counter_dtype(values) -> type:
    """int32, or int64 when any counter needs it: the host loop takes any
    counter, so the device route widens rather than truncates."""
    return np.int64 if any(c > INT32_MAX for c in values) else np.int32


def counter_ops_to_columns(ops, replicas: Vocab | None = None) -> CounterColumns:
    """Flatten G-Counter (Dot) or PN-Counter ((dir, Dot)) op batches."""
    replicas = replicas if replicas is not None else Vocab()
    sign, actor, counter = [], [], []
    for op in ops:
        if isinstance(op, Dot):
            direction, dot = POS, op
        else:
            direction, dot = op
            if not isinstance(dot, Dot):
                dot = Dot.from_obj(dot)
        if direction not in (POS, NEG):
            raise ValueError(f"bad counter op direction {direction!r}")
        sign.append(direction)
        actor.append(replicas.intern(dot.actor))
        counter.append(dot.counter)
    return CounterColumns(
        np.asarray(sign, np.int8),
        np.asarray(actor, np.int32),
        np.asarray(counter, _counter_dtype(counter)),
        replicas,
    )


def vclock_to_dense(clock: VClock, replicas: Vocab) -> np.ndarray:
    for r in clock.counters:
        replicas.intern(r)
    out = np.zeros(len(replicas), _counter_dtype(clock.counters.values()))
    for r, c in clock.counters.items():
        out[replicas.index[r]] = c
    return out


def dense_to_vclock(arr: np.ndarray, replicas: Vocab) -> VClock:
    arr = np.asarray(arr)
    nz = np.nonzero(arr)[0]
    robj = np.asarray(replicas.items, dtype=object)[nz].tolist()
    return VClock(dict(zip(robj, arr[nz].tolist())))


# ---- LWW -----------------------------------------------------------------


@dataclass
class LwwColumns:
    key: np.ndarray  # int32 — index into keys vocab
    ts_hi: np.ndarray  # int32 — timestamp high 31 bits
    ts_lo: np.ndarray  # int32 — timestamp low 31 bits
    actor: np.ndarray  # int32 — index into actors_sorted (rank)
    value: np.ndarray  # int32 — index into values_sorted (rank)
    tombstone: np.ndarray  # bool
    keys: Vocab = field(default_factory=Vocab)
    actors_sorted: list = field(default_factory=list)  # rank → actor bytes
    values_sorted: list = field(default_factory=list)  # rank → value object


def lww_ops_to_columns(ops, keys: Vocab | None = None) -> LwwColumns:
    """Flatten LWW ops.  Actors and values are *rank*-interned (sorted by
    bytes) so integer comparison on the device reproduces the host's
    lexicographic tie-breaks exactly.  Each value is packed once."""
    from .lww import ts_split

    ops = [LWWOp.from_obj(o) if isinstance(o, (list, tuple)) else o for o in ops]
    keys = keys if keys is not None else Vocab()
    actors = sorted({op.actor for op in ops})
    actor_rank = {a: i for i, a in enumerate(actors)}
    packed = []
    packed_vals = {}
    for op in ops:
        v = None if op.tombstone else op.value
        p = codec.pack(v)
        packed.append(p)
        packed_vals[p] = v
    order = sorted(packed_vals)
    values_sorted = [packed_vals[k] for k in order]
    value_rank = {k: i for i, k in enumerate(order)}
    intern = keys.intern
    key_col = [intern(op.key) for op in ops]
    ts_hi, ts_lo = ts_split(np.asarray([op.ts for op in ops], np.int64).reshape(-1))
    return LwwColumns(
        np.asarray(key_col, np.int32),
        ts_hi,
        ts_lo,
        np.asarray([actor_rank[op.actor] for op in ops], np.int32),
        np.asarray([value_rank[p] for p in packed], np.int32),
        np.asarray([op.tombstone for op in ops], bool),
        keys,
        actors,
        values_sorted,
    )
