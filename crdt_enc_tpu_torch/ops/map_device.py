"""Device scatter phase for the causal reset-remove map fold.

The port's counterpart of ``crdt_enc_tpu/ops/map_device.py``, an XLA
program there and plain PyTorch here, on tensors of any device.
``ops/map_columnar.py`` decomposes a CrdtMap<orset> op batch into four
row families folded over two plane sets — key planes ``(NK, R)`` and
touched-pair planes ``(NP, R)``.  Its scatter phase is masked
scatter-max / segment-min work: ``scatter_reduce_`` with ``"amax"`` for
the planes, ``"amin"`` for the remove-group gate, ``torch.where`` for
the gates and normalization and one gather from the key planes to the
pair planes.  Conventions: 0 = absent, and a row whose actor is ``>= R``
is padding, masked out by its gate (its index is clamped only to stay in
range).

The planes are int64, as in the host numpy phase of map_columnar, which
stays the semantics reference: a state counter past 2^31 − 1 folds here
as it does there (the JAX device route narrows the planes to int32).
Eager PyTorch compiles nothing per shape, so the JAX wrapper's bucket
padding has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import trace


def crdtmap_scatter_phase(
    clock0,  # (R,) int64
    births0,  # (NK, R) int64
    cclk0,  # (NK, R) int64
    cadd0,  # (NP, R) int64
    crm0,  # (NP, R) int64
    key_of_pair,  # (NP,) int64
    b_key, b_actor, b_ctr,  # births (Up dots); actor >= R ⇒ padding
    k_key, k_actor, k_ctr, k_group,  # key-remove horizon rows
    a_key, a_pair, a_actor, a_ctr,  # child adds (shared map dot)
    r_pair, r_actor, r_ctr, r_mactor, r_mctr,  # child-remove horizons
    *,
    num_groups: int,
    combine=None,
):
    """The batch scatter-maxes + normalization of ``crdtmap_fold_host``
    (map_columnar.py).  Returns ``(clock, births, cclk, cadd, crm,
    group_ok)`` with the values the host numpy phase computes, the planes
    in int64 on the planes' device.

    ``combine``: the row-sharding hook, ``combine(fn, cols, op)``.  Each
    scatter over rows runs as ``fn(*cols)``; a mesh's hook
    (``parallel.mesh.dp_combine``) runs it on every dp shard's rows and
    reduces the partials with ``op`` — ``"max"``, the JAX phase's
    ``pmax``, for the planes; ``"min"``, its ``pmin``, for the
    remove-group gate — after which the replicated normalization is the
    same on every shard.  None runs each scatter once over all rows."""
    NK, R = births0.shape
    NP = cadd0.shape[0]
    dev = clock0.device
    i64 = torch.int64
    if combine is None:
        def combine(fn, cols, op):
            return fn(*cols)

    def col(x):
        # lint: disable=OBS001 (crdtmap_scatter_device uploads and counts the columns; they reach here on dev)
        return x.to(device=dev, dtype=i64)

    b_key, b_actor, b_ctr = map(col, (b_key, b_actor, b_ctr))
    k_key, k_actor, k_ctr, k_group = map(col, (k_key, k_actor, k_ctr, k_group))
    a_key, a_pair, a_actor, a_ctr = map(col, (a_key, a_pair, a_actor, a_ctr))
    r_pair, r_actor, r_ctr, r_mactor, r_mctr = map(
        col, (r_pair, r_actor, r_ctr, r_mactor, r_mctr))
    clock0, births0, cclk0, cadd0, crm0 = map(
        col, (clock0, births0, cclk0, cadd0, crm0))
    key_of_pair = col(key_of_pair)

    def smax(rows, seg_rows, seg_actor, rows_c, gate):
        """Zero planes of ``rows`` rows with each gated row's counter
        max-scattered into cell (seg_rows, actor)."""

        def part(seg_rows, seg_actor, rows_c, gate):
            seg = seg_rows * R + seg_actor.clamp(max=R - 1)
            vals = torch.where(gate, rows_c, 0)
            out = torch.zeros(rows * R, dtype=i64, device=seg.device)
            if len(seg):
                out.scatter_reduce_(0, seg, vals, reduce="amax")
            return out

        return combine(part, (seg_rows, seg_actor, rows_c, gate),
                       "max").view(rows, R)

    def at_actor(plane, actor):
        return plane[actor.clamp(max=R - 1)]

    b_pad = b_actor >= R
    k_pad = k_actor >= R
    a_pad = a_actor >= R
    r_pad = r_actor >= R

    # 1. every Up advances the clock (ungated birth scatter)
    birth_new = smax(NK, b_key, b_actor, b_ctr, ~b_pad)
    clock = torch.maximum(clock0, birth_new.amax(dim=0) if NK else
                          torch.zeros_like(clock0))

    # 2. fire-or-defer per WHOLE remove: segment-min over each remove
    #    group of "the final clock covers this ctx dot"
    beyond = (k_ctr > at_actor(clock, k_actor)) & ~k_pad

    def gate_part(k_group, k_pad, beyond):
        ok = torch.ones(num_groups, dtype=i64, device=k_group.device)
        if num_groups and len(k_group):
            ok.scatter_reduce_(0, torch.where(k_pad, 0, k_group),
                               torch.where(beyond, 0, 1), reduce="amin")
        return ok

    group_ok = combine(gate_part, (k_group, k_pad, beyond), "min").bool()
    if num_groups:
        applicable = group_ok[k_group.clamp(max=num_groups - 1)] & ~k_pad
    else:
        applicable = torch.zeros_like(k_pad)

    # 3. fired key-remove horizons
    keyhz = smax(NK, k_key, k_actor, k_ctr, applicable)

    # 4. births: replay-gated on the ORIGINAL clock, reset by horizons
    b_gate = ~b_pad & (b_ctr > at_actor(clock0, b_actor))
    births = torch.maximum(births0, smax(NK, b_key, b_actor, b_ctr, b_gate))
    births = torch.where(births > keyhz, births, 0)

    # 5. child clocks advance on child ADDS only; fired removes reset them
    a_gate = ~a_pad & (a_ctr > at_actor(clock0, a_actor))
    cclk = torch.maximum(cclk0, smax(NK, a_key, a_actor, a_ctr, a_gate))
    cclk = torch.where(cclk > keyhz, cclk, 0)

    # 6. child entries (pair planes), same replay gate
    cadd = torch.maximum(cadd0, smax(NP, a_pair, a_actor, a_ctr, a_gate))

    # 7. child-remove horizons apply with their Up (gated on the MAP dot)
    live_up = ~r_pad & (r_mctr > at_actor(clock0, r_mactor))
    crm = torch.maximum(crm0, smax(NP, r_pair, r_actor, r_ctr, live_up))

    # 8. normalization: fired key horizons kill covered child content;
    #    the MAP clock retires child horizons
    hz_of_pair = keyhz[key_of_pair]
    eff_rm = torch.maximum(crm, hz_of_pair)
    cadd = torch.where(cadd > eff_rm, cadd, 0)
    del eff_rm
    crm = torch.where(crm > hz_of_pair, crm, 0)
    crm = torch.where(crm > clock[None, :], crm, 0)
    return clock, births, cclk, cadd, crm, group_ok


def crdtmap_scatter_device(
    clock0, births0, cclk0, cadd0, crm0, key_of_pair, B, A, Rm, K,
    n_groups: int, *, device, mesh=None,
):
    """Upload the host fold's numpy planes (int64) and the four decoded
    row-family dicts to ``device``, run :func:`crdtmap_scatter_phase` and
    bring the results back as numpy: int64 planes and ``group_ok``, shaped
    exactly as the host phase's.

    ``mesh`` (a ``parallel.mesh.Mesh`` of two or more shards): the rows
    shard over its ``dp`` axis, each family padded to a dp multiple with
    ``actor == R`` sentinels, and the phase runs through
    ``parallel.mesh.crdtmap_scatter_sharded`` on the mesh's devices."""
    sharded = mesh is not None and mesh.size > 1
    device = mesh.home if sharded else torch.device(device)
    dp = mesh.local_dp if sharded else 1

    def up(x):
        a = np.ascontiguousarray(x, np.int64)
        if device.type == "cuda":
            trace.add("h2d_bytes", a.nbytes)
        return torch.from_numpy(a).to(device)

    NK, R = births0.shape

    def rows(d, names, fills):
        n = len(d["actor"])
        padn = -(-n // dp) * dp - n
        return [up(np.concatenate([np.asarray(d[x], np.int64),
                                   np.full(padn, f, np.int64)])
                   if padn else d[x])
                for x, f in zip(names, fills)]

    b_rows = rows(B, ("key", "actor", "ctr"), (0, R, 0))
    k_rows = rows(K, ("key", "actor", "ctr", "group"), (0, R, 0, 0))
    a_rows = rows(A, ("key", "pair", "actor", "ctr"), (0, 0, R, 0))
    r_rows = rows(Rm, ("pair", "actor", "ctr", "mactor", "mctr"),
                  (0, R, 0, R, 0))
    clock0 = np.asarray(clock0)[:R]
    planes = (up(clock0), up(births0), up(cclk0), up(cadd0), up(crm0),
              up(key_of_pair))
    if sharded:
        from ..parallel.mesh import crdtmap_scatter_sharded

        out = crdtmap_scatter_sharded(mesh, *planes, b_rows, k_rows, a_rows,
                                      r_rows, num_groups=n_groups)
    else:
        out = crdtmap_scatter_phase(*planes, *b_rows, *k_rows, *a_rows,
                                    *r_rows, num_groups=n_groups)
    clock, births, cclk, cadd, crm, group_ok = (x.cpu().numpy() for x in out)
    return clock, births, cclk, cadd, crm, group_ok
