"""Columnar bulk fold for the causal reset-remove map (CrdtMap<orset>).

The port's copy of ``crdt_enc_tpu/ops/map_columnar.py``.  Its device
route is the PyTorch scatter phase of ``ops/map_device.py``, chosen by
passing a ``device``; the planes stay int64 on both routes.

The map's apply semantics (models/crdtmap.py) decompose into four row
families — key births, key-remove horizons, child adds, child-remove
horizons — folded as masked scatter-maxes over two plane sets:

* key planes ``(K, R)``: births, key horizons, child clocks;
* pair planes ``(P, R)`` over the *touched* (key, member) pairs (a
  compact vocabulary, never the dense K·M product): child entries and
  child horizons, coupled to the key planes by one gather
  (``eff_rm = max(child_rm, key_horizon[key_of_pair])``).

Order-independence holds for the same reasons as the ORSet kernel
(per-actor dot monotonicity under the core's delivery contract, removes
derived from observed reads), extended by the map's shared-dot
discipline: one dot authorizes both the key birth and the child
mutation, which the native decoder verifies row by row (declining any
payload whose child-add dot differs from its map dot).  The suppression
and reset rules all become "≤ horizon dies", evaluated against the
batch+state horizon maxima — the same final state every sequential
interleaving reaches.  Parity with the host fold and with the JAX
package is fuzzed in tests/test_torch_map_columnar.py.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..models import ORSet, VClock
from ..models.crdtmap import CrdtMap
from ..utils import trace
from .columnar import Vocab
from .native_decode import intern_spans

_i32p = native.i32p
_i64p = native.i64p


def decode_map_payload_batch(payloads: list, actors_sorted: list):
    """Native decode of CrdtMap<orset> op payloads → the four row
    families, with key/member spans interned.  Returns None to request
    the per-op fallback."""
    lib = native.load()
    if not payloads:
        empty = {
            "koff": np.zeros(0, np.uint64), "klen": np.zeros(0, np.uint64),
            "actor": np.zeros(0, np.int32), "ctr": np.zeros(0, np.int32),
            "moff": np.zeros(0, np.uint64), "mlen": np.zeros(0, np.uint64),
            "key": np.zeros(0, np.int32), "member": np.zeros(0, np.int32),
            "mactor": np.zeros(0, np.int32), "mctr": np.zeros(0, np.int32),
            "group": np.zeros(0, np.int32),
        }
        return dict(empty), dict(empty), dict(empty), dict(empty), [], []
    big = b"".join(payloads)
    buf = np.frombuffer(big, np.uint8)
    bp = buf.ctypes.data_as(native.u8p)
    actors_flat = b"".join(actors_sorted)
    ap, _a = native.in_ptr(actors_flat)

    lens = np.array([len(p) for p in payloads], np.uint64)
    bases = np.zeros(len(payloads), np.uint64)
    np.cumsum(lens[:-1], out=bases[1:])

    counts = np.zeros(4, np.int64)
    total = lib.map_count_rows_batch(
        bp, bases.ctypes.data_as(native.u64p),
        lens.ctypes.data_as(native.u64p), len(payloads),
        counts.ctypes.data_as(_i64p),
    )
    if total < 0:
        return None
    nb, na, nr, nk = (int(c) for c in counts)

    def alloc(n, with_member):
        d = {
            "koff": np.zeros(n, np.uint64), "klen": np.zeros(n, np.uint64),
            "actor": np.zeros(n, np.int32), "ctr": np.zeros(n, np.int32),
        }
        if with_member:
            d["moff"] = np.zeros(n, np.uint64)
            d["mlen"] = np.zeros(n, np.uint64)
        return d

    B = alloc(nb, False)
    A = alloc(na, True)
    Rm = alloc(nr, True)
    Rm["mactor"] = np.zeros(nr, np.int32)  # the Up's MAP dot (replay gate)
    Rm["mctr"] = np.zeros(nr, np.int32)
    K = alloc(nk, False)
    K["group"] = np.zeros(nk, np.int32)  # originating Rm op: fire-or-defer
    # is decided per WHOLE remove (the crdts-crate deferral discipline)
    u64 = native.u64p
    got = lib.map_decode_batch(
        bp, bases.ctypes.data_as(u64), lens.ctypes.data_as(u64),
        len(payloads), ap, len(actors_sorted),
        B["koff"].ctypes.data_as(u64), B["klen"].ctypes.data_as(u64),
        B["actor"].ctypes.data_as(_i32p), B["ctr"].ctypes.data_as(_i32p),
        A["koff"].ctypes.data_as(u64), A["klen"].ctypes.data_as(u64),
        A["moff"].ctypes.data_as(u64), A["mlen"].ctypes.data_as(u64),
        A["actor"].ctypes.data_as(_i32p), A["ctr"].ctypes.data_as(_i32p),
        Rm["koff"].ctypes.data_as(u64), Rm["klen"].ctypes.data_as(u64),
        Rm["moff"].ctypes.data_as(u64), Rm["mlen"].ctypes.data_as(u64),
        Rm["actor"].ctypes.data_as(_i32p), Rm["ctr"].ctypes.data_as(_i32p),
        Rm["mactor"].ctypes.data_as(_i32p), Rm["mctr"].ctypes.data_as(_i32p),
        K["koff"].ctypes.data_as(u64), K["klen"].ctypes.data_as(u64),
        K["actor"].ctypes.data_as(_i32p), K["ctr"].ctypes.data_as(_i32p),
        K["group"].ctypes.data_as(_i32p),
    )
    if got != total:
        return None

    # intern every key span across the four families in one pass, then
    # member spans across the two child families
    all_koff = np.concatenate([B["koff"], A["koff"], Rm["koff"], K["koff"]])
    all_klen = np.concatenate([B["klen"], A["klen"], Rm["klen"], K["klen"]])
    kidx_all, key_objs = intern_spans(buf, all_koff, all_klen)
    B["key"] = kidx_all[:nb]
    A["key"] = kidx_all[nb : nb + na]
    Rm["key"] = kidx_all[nb + na : nb + na + nr]
    K["key"] = kidx_all[nb + na + nr :]

    all_moff = np.concatenate([A["moff"], Rm["moff"]])
    all_mlen = np.concatenate([A["mlen"], Rm["mlen"]])
    midx_all, member_objs = intern_spans(buf, all_moff, all_mlen)
    A["member"] = midx_all[:na]
    Rm["member"] = midx_all[na:]
    return B, A, Rm, K, key_objs, member_objs



def _host_scatter_phase(
    clock0, births0, cclk0, cadd0, crm0, key_of_pair,
    B, A, Rm, K, b_pair_a, b_pair_r, NK, R, n_groups,
):
    """The numpy scatter phase — the semantics reference the device twin
    (ops/map_device.py) is fuzzed against.  int64 planes throughout."""

    def smax(target, rows_k, rows_a, rows_c, gate=None):
        if len(rows_k) == 0:
            return
        sel = slice(None)
        if gate is not None:
            sel = rows_c > clock0[rows_a]
        np.maximum.at(target, (rows_k[sel], rows_a[sel]), rows_c[sel])

    birth_new = np.zeros((NK, R), np.int64)
    # every Up advances the clock
    smax(birth_new, np.asarray(B["key"], np.int64), B["actor"], B["ctr"])
    clock = np.maximum(clock0, birth_new.max(axis=0, initial=0))

    # fire-or-defer per WHOLE remove: a remove applies only when every
    # dot its context cites has arrived (the final clock covers it);
    # otherwise the whole (ctx, keys) op defers verbatim.  End-of-batch
    # firing is sequential-equivalent: once the clock covers the ctx, no
    # dot ≤ ctx can re-enter (the replay gate holds it out).
    group_ok = np.ones(max(n_groups, 1), bool)
    if len(K["group"]):
        beyond = K["ctr"] > clock[K["actor"]]
        np.minimum.at(group_ok, K["group"], ~beyond)
    applicable = group_ok[K["group"]] if len(K["group"]) else np.zeros(0, bool)

    keyhz = np.zeros((NK, R), np.int64)
    if applicable.any():
        np.maximum.at(
            keyhz,
            (np.asarray(K["key"], np.int64)[applicable],
             K["actor"][applicable]),
            K["ctr"][applicable],
        )

    births = births0.copy()
    smax(births, np.asarray(B["key"], np.int64), B["actor"], B["ctr"], gate=True)
    births = np.where(births > keyhz, births, 0)

    # child clocks advance only on child ADDS (ORSet removes never touch
    # the clock; a child-rm Up advances the MAP clock alone); fired
    # removes reset them
    cclk = cclk0.copy()
    smax(cclk, np.asarray(A["key"], np.int64), A["actor"], A["ctr"], gate=True)
    cclk = np.where(cclk > keyhz, cclk, 0)

    cadd = cadd0.copy()
    smax(cadd, b_pair_a, A["actor"], A["ctr"], gate=True)
    # child removes apply with their Up (replay-gated on the map dot)
    crm = crm0.copy()
    if len(b_pair_r):
        live_up = Rm["mctr"] > clock0[Rm["mactor"]]
        np.maximum.at(
            crm,
            (b_pair_r[live_up], Rm["actor"][live_up]),
            Rm["ctr"][live_up],
        )

    eff_rm = np.maximum(crm, keyhz[key_of_pair])
    cadd = np.where(cadd > eff_rm, cadd, 0)
    # child horizons: reset by fired key removes, retired by the MAP
    # clock (which subsumes the child clock — see
    # CrdtMap._retire_child_horizons)
    crm = np.where(crm > keyhz[key_of_pair], crm, 0)
    crm = np.where(crm > clock[None, :], crm, 0)
    return clock, births, cclk, cadd, crm, group_ok


def crdtmap_fold_host(
    state: CrdtMap, B, A, Rm, K, keys: Vocab, members: Vocab, replicas: Vocab,
    device=None,
) -> CrdtMap:
    """Vectorized fold of the decoded row families into ``state``
    (CrdtMap<orset>), equal to applying the batch per-op in any
    per-actor-order-preserving interleaving.

    ``device`` (a ``torch.device``) routes the scatter phase (the four
    scatter-max families + normalization) through the PyTorch program of
    ops/map_device.py on that device — same planes, same int64 values
    (fuzzed equal in tests/test_torch_map_columnar.py); ``None`` runs the
    numpy phase.  State↔planes conversion stays on the host."""
    R = len(replicas)
    aidx = replicas.index

    # ---- state → planes --------------------------------------------------
    with trace.span("map.planes"):
        for k in state.births:
            keys.intern(k)
        for k in state.vals:  # residue-only keys (dead key, live horizons)
            keys.intern(k)
        NK = len(keys)
        clock0 = np.zeros(max(R, 1), np.int64)
        for a, c in state.clock.counters.items():
            clock0[aidx[a]] = c
        births0 = np.zeros((NK, R), np.int64)
        cclk0 = np.zeros((NK, R), np.int64)
        for k, birth in state.births.items():
            ki = keys.index[k]
            for a, c in birth.items():
                births0[ki, aidx[a]] = c

        # compact (key, member) pair ids — batch + state.  Pure arithmetic
        # (key * NM + member) densified with one np.unique, so the batch rows
        # map to pair rows without per-row Python.
        for k, child in state.vals.items():
            keys.intern(k)
            for m in child.entries:
                members.intern(m)
            for m in child.deferred:
                members.intern(m)
        NM = len(members)
        NMx = max(NM, 1)
        state_pair_ids = []
        for k, child in state.vals.items():
            ki = keys.index[k]
            for a, c in child.clock.counters.items():
                cclk0[ki, aidx[a]] = c
            for m in child.entries:
                state_pair_ids.append(ki * NMx + members.index[m])
            for m in child.deferred:
                state_pair_ids.append(ki * NMx + members.index[m])
        a_ids = (
            np.asarray(A["key"], np.int64) * NMx + A["member"]
            if len(A["key"]) else np.zeros(0, np.int64)
        )
        r_ids = (
            np.asarray(Rm["key"], np.int64) * NMx + Rm["member"]
            if len(Rm["key"]) else np.zeros(0, np.int64)
        )
        uniq_pairs = np.unique(np.concatenate([
            np.asarray(state_pair_ids, np.int64), a_ids, r_ids
        ]))
        b_pair_a = np.searchsorted(uniq_pairs, a_ids)
        b_pair_r = np.searchsorted(uniq_pairs, r_ids)
        NP = len(uniq_pairs)
        cadd0 = np.zeros((NP, R), np.int64)
        crm0 = np.zeros((NP, R), np.int64)
        for k, child in state.vals.items():
            ki = keys.index[k]
            for m, entry in child.entries.items():
                p = int(np.searchsorted(uniq_pairs, ki * NMx + members.index[m]))
                for a, c in entry.items():
                    cadd0[p, aidx[a]] = c
            for m, dfr in child.deferred.items():
                p = int(np.searchsorted(uniq_pairs, ki * NMx + members.index[m]))
                for a, c in dfr.items():
                    crm0[p, aidx[a]] = c
        key_of_pair = uniq_pairs // NMx

    # ---- batch scatter-maxes --------------------------------------------
    n_groups = int(K["group"].max()) + 1 if len(K["group"]) else 0
    if device is not None:
        from .map_device import crdtmap_scatter_device

        with trace.span("map.scatter_device"):
            clock, births, cclk, cadd, crm, group_ok = crdtmap_scatter_device(
                clock0, births0, cclk0, cadd0, crm0, key_of_pair,
                B, {**A, "pair": b_pair_a}, {**Rm, "pair": b_pair_r}, K,
                n_groups, device=device,
            )
        group_ok_pad = np.ones(max(n_groups, 1), bool)
        group_ok_pad[:n_groups] = group_ok
        group_ok = group_ok_pad
    else:
        with trace.span("map.scatter_host"):
            clock, births, cclk, cadd, crm, group_ok = _host_scatter_phase(
                clock0, births0, cclk0, cadd0, crm0, key_of_pair,
                B, A, Rm, K, b_pair_a, b_pair_r, NK, R, n_groups,
            )

    # ---- planes → state --------------------------------------------------
    with trace.span("map.writeback"):
        state._mut += 1  # writeback mutates the state outside its methods
        robj = replicas.items
        state.clock = VClock(
            {robj[r]: int(clock[r]) for r in np.nonzero(clock)[0]}
        )
        new_births: dict = {}
        new_vals: dict = {}
        live_key = births.any(axis=1)
        for ki in np.nonzero(live_key)[0].tolist():
            ko = keys.items[ki]
            new_births[ko] = {
                robj[r]: int(births[ki, r]) for r in np.nonzero(births[ki])[0]
            }
            child = ORSet()
            child.clock = VClock(
                {robj[r]: int(cclk[ki, r]) for r in np.nonzero(cclk[ki])[0]}
            )
            new_vals[ko] = child
        # child content rides on pairs; surviving horizons of DEAD keys are
        # residue (models/crdtmap.py _rm_now) and keep a vals entry too
        ks_p, rs_p = np.nonzero(cadd)
        for p, r in zip(ks_p.tolist(), rs_p.tolist()):
            ki = int(key_of_pair[p])
            if not live_key[ki]:
                continue
            mo = members.items[int(uniq_pairs[p]) % NMx]
            new_vals[keys.items[ki]].entries.setdefault(mo, {})[robj[r]] = int(
                cadd[p, r]
            )
        ks_p, rs_p = np.nonzero(crm)
        for p, r in zip(ks_p.tolist(), rs_p.tolist()):
            ki = int(key_of_pair[p])
            ko = keys.items[ki]
            child = new_vals.get(ko)
            if child is None:
                child = new_vals[ko] = ORSet()  # residue-only key
            mo = members.items[int(uniq_pairs[p]) % NMx]
            child.deferred.setdefault(mo, {})[robj[r]] = int(crm[p, r])
        state.births = new_births
        state.vals = new_vals
        # batch removes that could not fire defer as WHOLE ops (ctx + keys),
        # joining the state's pending ones; anything the batch unblocked
        # fires through the model's own flush
        if len(K["group"]) and not group_ok.all():
            kk = np.asarray(K["key"], np.int64)
            for g in np.nonzero(~group_ok[: max(n_groups, 1)])[0].tolist():
                rows = np.nonzero(K["group"] == g)[0]
                ctx = VClock()
                gkeys = set()
                for i in rows.tolist():
                    a = robj[int(K["actor"][i])]
                    c = int(K["ctr"][i])
                    if c > ctx.get(a):
                        ctx.counters[a] = c
                    gkeys.add(keys.items[int(kk[i])])
                state._defer(ctx, gkeys)
        state._flush_deferred()
    return state
