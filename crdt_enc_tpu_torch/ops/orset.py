"""OR-Set fold and merge over dense int32 tensors.

The port's counterpart of ``crdt_enc_tpu/ops/orset.py``: the same
contracts and argument names, on torch tensors.

* **fold**: a whole op batch (adds as dots, removes flattened to
  per-replica horizon rows) collapses into the state planes via a
  scatter-max and elementwise masks.  Order independence of the dense
  formulas (max over monotone per-replica counters) is what makes this
  legal.
* **merge**: the Orswot clock-filter merge as pure elementwise arithmetic
  over ``(E, R)`` planes.
* **sparse fold** (``orset_fold_coo``): the batch sorted by segment key
  and reduced to one max per touched ``(member, actor)``, no planes;
* **tenant folds** (the fold service's buckets): T tenants' folds as ONE
  fold over ``(E, T·R)`` planes, tenant t's replica r in column
  ``t·R + r`` (``orset_fold_tenants``), and the plane diff that cuts each
  tenant's delta on the device (``orset_plane_diff*``).

Counters are int32 and always ≥ 1 for real dots, so 0 is the universal
"absent" value.  Padding rows carry the ``actor >= R`` sentinel and drop
out.

``orset_fold``, ``orset_stack_cells`` and ``orset_merge_many`` dispatch on
the tensors' device: CUDA tensors go to the hand-written kernels
(``orset_fold_cuda``, ``orset_merge_cuda``), CPU tensors to the plain code
in this module.  The plain functions (``*_plain``,
``orset_merge_many_tree``) are also the references the kernels are held
against on the card; the main path never calls them with CUDA tensors.
"""

from __future__ import annotations

import torch

from .columnar import KIND_ADD, KIND_RM


def common_device(*tensors: torch.Tensor) -> torch.device:
    """The one device every tensor lies on; raises on a mix, so a CUDA
    tensor can never fall through to the plain CPU code."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {dev} and {t.device}")
    return dev


def _cpu_only(*tensors: torch.Tensor) -> None:
    dev = common_device(*tensors)
    if dev.type != "cpu":
        raise ValueError(f"the plain path takes CPU tensors, got {dev}")


# ---------------------------------------------------------------- fold
def orset_scatter_plain(kind, member, actor, counter, *, num_members: int,
                        num_replicas: int):
    """The raw scatter phase: per (member, actor) cell the max add counter
    and the max remove counter, as two ``(E, R)`` int32 planes.  Rows with
    ``actor >= R`` (padding), a member outside ``[0, E)``, a negative
    actor, or a kind other than ADD/RM drop out.  Untouched cells read 0.
    No replay gate, no normalization."""
    E, R = num_members, num_replicas
    valid = (actor >= 0) & (actor < R) & (member >= 0) & (member < E)
    is_add = (kind == KIND_ADD) & valid
    is_rm = (kind == KIND_RM) & valid
    seg = (member.long() * R + actor.long()).clamp(0, max(E * R - 1, 0))
    # removes scatter into the second (E, R) plane of one flat target
    seg2 = torch.where(is_rm, seg + E * R, seg)
    vals = torch.where(is_add | is_rm, counter, torch.zeros_like(counter))
    both = torch.zeros(2 * E * R, dtype=torch.int32, device=counter.device)
    if len(vals) and E * R:
        both.scatter_reduce_(0, seg2, vals.to(torch.int32), reduce="amax")
    both = both.view(2, E, R)
    return both[0], both[1]


def orset_fold_clock_plain(clock0, add_new):
    """The fold's clock: ``max(clock0, column max of the gated adds)``.
    Adds advance the global clock; removes never do."""
    if not add_new.shape[0]:
        return clock0.clone()
    zero = torch.zeros((), dtype=add_new.dtype, device=add_new.device)
    gated = torch.where(add_new > clock0[None, :], add_new, zero)
    return torch.maximum(clock0, gated.amax(dim=0))


def orset_fold_tail_plain(clock0, clock, add0, rm0, add_new, rm_new, *,
                          retire_rm: bool = True):
    """The fold's tail after the scatter, given the final ``clock``:
    the cell-level replay gate against ``clock0``, the add/rm max, add
    killed where ≤ rm, and (``retire_rm``) horizons retired where
    ≤ ``clock``.  Returns ``(add, rm)``."""
    zero = torch.zeros((), dtype=add_new.dtype, device=add_new.device)
    # stale-add replay gate, lifted from row level to cell level: dots are
    # monotone per actor, so a cell whose scattered max is ≤ the incoming
    # clock held only stale adds
    gated = torch.where(add_new > clock0[None, :], add_new, zero)
    add = torch.maximum(add0, gated)
    rm = torch.maximum(rm0, rm_new)
    add = torch.where(add > rm, add, zero)
    if retire_rm:
        rm = torch.where(rm > clock[None, :], rm, zero)
    return add, rm


def orset_fold_plain(clock0, add0, rm0, kind, member, actor, counter, *,
                     num_members: int, num_replicas: int,
                     retire_rm: bool = True):
    """``orset_fold`` in plain torch, formula for formula the JAX fold
    (scatter, gate, clock from the gated column max, normalize)."""
    add_new, rm_new = orset_scatter_plain(
        kind, member, actor, counter,
        num_members=num_members, num_replicas=num_replicas,
    )
    clock = orset_fold_clock_plain(clock0, add_new)
    add, rm = orset_fold_tail_plain(
        clock0, clock, add0, rm0, add_new, rm_new, retire_rm=retire_rm
    )
    return clock, add, rm


def orset_fold(
    clock0: torch.Tensor,  # (R,) int32
    add0: torch.Tensor,  # (E, R) int32
    rm0: torch.Tensor,  # (E, R) int32
    kind: torch.Tensor,  # (N,) int8
    member: torch.Tensor,  # (N,) int32
    actor: torch.Tensor,  # (N,) int32  (>= num_replicas ⇒ padding row)
    counter: torch.Tensor,  # (N,) int32
    *,
    num_members: int,
    num_replicas: int,
    retire_rm: bool = True,
):
    """Fold an op batch into normalized ORSet planes.

    ``retire_rm=False`` keeps remove horizons un-retired (no ``rm > clock``
    zeroing): required when the planes are a partial reduction to be
    combined with a pre-existing state later.

    Returns ``(clock, add, rm)`` in canonical form: entries zeroed where
    ``add ≤ rm``, horizons zeroed where ``rm ≤ clock``.  CUDA tensors run
    the bucketed fold kernels; CPU tensors the plain code.
    """
    args = (clock0, add0, rm0, kind, member, actor, counter)
    kw = dict(num_members=num_members, num_replicas=num_replicas,
              retire_rm=retire_rm)
    if common_device(*args).type == "cuda":
        from .orset_fold_cuda import orset_fold_cuda

        return orset_fold_cuda(*args, **kw)
    _cpu_only(*args)
    return orset_fold_plain(*args, **kw)


# ------------------------------------------------------------ tenant folds
# T tenants' (E, R) planes fold as one (E, T·R) fold: tenant t's replica r
# is column t·R + r, so a row's cell is member·(T·R) + t·R + actor and the
# replay gate reads clock0[t·R + r], the tenant's own clock.  The kernel's
# actors are int32 and its cells int64, so T·R must stay below 2^31 (at the
# bucket caps, 2^10 tenants of at most 2^20 cells, T·R ≤ 2^30).
TENANT_COLUMNS_MAX = 2**31 - 1


def orset_fold_coo(clock0, kind, member, actor, counter, *,
                   num_members: int, num_replicas: int):
    """Sparse fold: aggregate an op batch WITHOUT the dense ``(E, R)``
    planes (the JAX package's ``orset_fold_coo``, an XLA function there,
    plain PyTorch here on whatever device the tensors share).

    The batch sorts by ``(segment key, counter)``; the last row of each
    key's run holds that segment's max, so the work is O(N log N) and
    independent of E·R.  Key ``member·R + actor`` is a live add's dot,
    key ``E·R + member·R + actor`` a remove horizon, key ``2·E·R`` a row
    that drops out (a padding row with ``actor >= R``, a replayed add,
    any other kind).  Returns ``(clock, seg_keys, seg_max, is_seg_max)``
    for ``ops.columnar.orset_apply_coo``; ``clock`` is ``clock0`` raised
    by each live add's counter.  Keys and counters are int64, so the key
    space is not bounded by int32 here; the accelerator routes batches
    with ``2·E·R < 2^31`` to it, as the JAX package does."""
    common_device(clock0, kind, member, actor, counter)
    E, R = int(num_members), int(num_replicas)
    clock0 = clock0.to(torch.int64)
    member = member.to(torch.int64)
    actor = actor.to(torch.int64)
    counter = counter.to(torch.int64)
    pad = actor >= R
    actor_ix = actor.clamp(max=R - 1)
    is_add = (kind == KIND_ADD) & ~pad
    is_rm = (kind == KIND_RM) & ~pad
    seen = counter <= clock0[actor_ix]
    live_add = is_add & ~seen
    valid = live_add | is_rm
    seg = member * R + actor_ix
    drop = 2 * E * R
    key = torch.where(valid, torch.where(is_rm, seg + E * R, seg),
                      torch.full_like(seg, drop))
    # lexicographic (key, counter): a stable sort by counter, then a
    # stable sort by key
    by_counter = torch.sort(counter, stable=True).indices
    by_key = torch.sort(key[by_counter], stable=True).indices
    order = by_counter[by_key]
    skey, scounter = key[order], counter[order]
    nxt = torch.cat([skey[1:], skey.new_full((1,), -1)])
    is_seg_max = (skey != nxt) & (skey < drop)
    clock_new = torch.zeros(R, dtype=torch.int64, device=clock0.device)
    clock_new.scatter_reduce_(
        0, actor_ix, torch.where(live_add, counter, 0), "amax")
    clock = torch.maximum(clock0, clock_new)
    return clock, skey, scounter, is_seg_max


def tenant_columns(actor, num_replicas: int):
    """Per-tenant actors ``(T, N)`` → columns of the tenant layout,
    flattened ``(T·N,)``: ``t·R + actor`` for a row whose actor lies in
    ``[0, R)``, and the layout's own padding sentinel ``T·R`` for every
    other row.  A tenant's padding row (``actor == R``) must not become
    ``t·R + R``, which is tenant t+1's column 0."""
    T = actor.shape[0]
    R = num_replicas
    if T * R > TENANT_COLUMNS_MAX:
        raise ValueError(
            f"{T} tenants x {R} replicas = {T * R} columns: the tenant "
            "layout needs fewer than 2^31"
        )
    base = torch.arange(T, dtype=torch.int32, device=actor.device)[:, None] * R
    live = (actor >= 0) & (actor < R)
    sentinel = torch.full((), T * R, dtype=torch.int32, device=actor.device)
    return torch.where(live, actor.to(torch.int32) + base, sentinel).reshape(-1)


def tenant_planes(plane, num_tenants: int):
    """An ``(E, T·R)`` plane of the tenant layout as ``(T, E, R)``: a view,
    no copy (``plane.view(E, T, R).permute(1, 0, 2)``)."""
    E = plane.shape[0]
    return plane.view(E, num_tenants, -1).permute(1, 0, 2)


def orset_fold_tenant_layout(clock0, add0, rm0, kind, member, actor, counter,
                             *, num_members: int, num_replicas: int):
    """The fold of T tenants already in the tenant layout: ``clock0``
    ``(T·R,)``, ``add0``/``rm0`` ``(E, T·R)``, op rows ``(T, N)`` with
    per-tenant actors (``actor == R`` pads).  ONE ``orset_fold`` over the
    ``(E, T·R)`` planes, so one K2 launch on CUDA tensors (the plain
    version on CPU tensors), ``retire_rm=True``.  Returns ``(clock, add,
    rm)`` in the same layout."""
    T = kind.shape[0]
    return orset_fold(
        clock0, add0, rm0, kind.reshape(-1), member.reshape(-1),
        tenant_columns(actor, num_replicas), counter.reshape(-1),
        num_members=num_members, num_replicas=T * num_replicas,
    )


def orset_fold_tenants(clock0, add0, rm0, kind, member, actor, counter, *,
                       num_members: int, num_replicas: int):
    """The multi-tenant fold (the JAX package's ``orset_fold_tenants``, a
    ``vmap`` of ``orset_fold``): ``clock0 (T, R)``, ``add0``/``rm0``
    ``(T, E, R)``, op rows ``(T, N)``.  Tenants never interact; the
    result equals T independent ``orset_fold`` calls
    (:func:`orset_fold_tenants_plain`).  Lays the planes out as
    ``(E, T·R)`` and folds them with :func:`orset_fold_tenant_layout`;
    returns ``(T, R)`` and ``(T, E, R)`` views of the folded layout."""
    T = kind.shape[0]
    E, R = num_members, num_replicas
    clock, add, rm = orset_fold_tenant_layout(
        clock0.reshape(T * R),
        add0.permute(1, 0, 2).reshape(E, T * R),
        rm0.permute(1, 0, 2).reshape(E, T * R),
        kind, member, actor, counter, num_members=E, num_replicas=R,
    )
    return clock.view(T, R), tenant_planes(add, T), tenant_planes(rm, T)


def orset_fold_tenants_plain(clock0, add0, rm0, kind, member, actor, counter,
                             *, num_members: int, num_replicas: int):
    """The plain version of :func:`orset_fold_tenants`: one
    ``orset_fold_plain`` per tenant, stacked."""
    outs = [
        orset_fold_plain(clock0[t], add0[t], rm0[t], kind[t], member[t],
                         actor[t], counter[t], num_members=num_members,
                         num_replicas=num_replicas)
        for t in range(kind.shape[0])
    ]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


# Diff codes of the device-cut delta (orset_plane_diff): which map of the
# Orswot window delta a cell feeds, the ``e`` / ``x`` / ``t`` keys of
# delta/codec.orset_delta_diff.
DIFF_ADD = 1  # a window dot: add_n > the base clock
DIFF_REMOVED = 2  # a dot-exact removal: a base slot absent from new
DIFF_HORIZON = 4  # a remove horizon raised past the base's


def orset_plane_diff(clock_b, add_b, rm_b, clock_n, add_n, rm_n):
    """Mark every cell the host dict walk ``orset_delta_diff`` would emit,
    comparing a sealed BASE state's canonical planes with the post-fold
    NEW planes over one shared vocabulary.  Returns ``(code, count)``:
    an int8 plane of ``DIFF_*`` bits and the number of marked cells.
    The conditions are the walk's: add ``add_n > clock_b[r]``; removed
    ``add_b > 0 and add_n == 0``; horizon ``rm_n > rm_b and rm_n >
    clock_n[r]``.  Elementwise, so it also runs on the tenant layout's
    ``(E, T·R)`` planes with ``(T·R,)`` clocks."""
    add_bit = (add_n > clock_b[None, :]).to(torch.int8) * DIFF_ADD
    rm_bit = ((add_b > 0) & (add_n == 0)).to(torch.int8) * DIFF_REMOVED
    hz_bit = ((rm_n > rm_b) & (rm_n > clock_n[None, :])).to(
        torch.int8) * DIFF_HORIZON
    code = add_bit | rm_bit | hz_bit
    return code, (code != 0).sum(dtype=torch.int64)


def orset_plane_diff_rows_tenants(code, add_b, add_n, rm_n, num_tenants: int,
                                  slots):
    """The diff rows of the tenants at ``slots`` (an ascending int64
    tensor of slot indices) from the tenant layout's ``(E, T·R)`` planes
    in one gather: ``(tenant, idx, code, add_b, add_n, rm_n)``, sorted by
    tenant, ``idx`` the flat index ``e·R + r`` within the tenant's own
    ``(E, R)`` planes.  Rows of the other slots are never gathered, so
    the one copy to the host grows with the selected tenants' diffs
    only; the caller splits the rows by tenant.  ``torch.nonzero`` sizes
    the result to the marked cells."""
    T = num_tenants
    R = code.shape[1] // T
    nz = torch.nonzero(tenant_planes(code, T).index_select(0, slots))
    t, e, r = slots[nz[:, 0]], nz[:, 1], nz[:, 2]  # slot-major
    col = t * R + r
    return (t, e * R + r, code[e, col], add_b[e, col], add_n[e, col],
            rm_n[e, col])


def orset_retire(clock, rm):
    """Finalize a chain of ``retire_rm=False`` folds: the horizon
    retirement they skipped, ``rm`` zeroed where ≤ ``clock``.  Equal to
    the eager chain's final ``rm`` (the JAX package's ``orset_retire``,
    plain code there too)."""
    zero = torch.zeros((), dtype=rm.dtype, device=rm.device)
    return torch.where(rm > clock[None, :], rm, zero)


def orset_apply_batch_planes(clock0, add0, rm0, add_b, rm_b):
    """Apply pre-reduced op-batch planes to the state planes: the tail of
    :func:`orset_fold` after the scatter phase, with the stale-add mask
    lifted to cell level against the CURRENT clock.  Not the CvRDT state
    merge (``orset_merge``) — batch rows are ops, so no clock-filter
    survivor rule applies to them."""
    clock = orset_fold_clock_plain(clock0, add_b)
    add, rm = orset_fold_tail_plain(clock0, clock, add0, rm0, add_b, rm_b)
    return clock, add, rm


# --------------------------------------------------------------- merge
def merge_rule(clock_a, add_a, rm_a, clock_b, add_b, rm_b, clock_merged):
    """The clock-filter merge on raw tensors (clocks already row-broadcast
    ready, ``clock_merged = max(clock_a, clock_b)`` supplied by the
    caller).  The single statement of the Orswot merge semantics in the
    port; the merge kernel (csrc/orset_merge.cu) applies it per cell."""
    zero = torch.zeros((), dtype=add_a.dtype, device=add_a.device)
    same = add_a == add_b
    surv_a = torch.where(same | (add_a > clock_b), add_a, zero)
    surv_b = torch.where(same | (add_b > clock_a), add_b, zero)
    add = torch.maximum(surv_a, surv_b)
    rm = torch.maximum(rm_a, rm_b)
    add = torch.where(add > rm, add, zero)
    rm = torch.where(rm > clock_merged, rm, zero)
    return add, rm


def orset_merge(clock_a, add_a, rm_a, clock_b, add_b, rm_b):
    """CvRDT merge of two dense ORSet states over the same (members,
    replicas) vocabularies.  Works on a leading batch axis too: clocks
    ``(..., R)`` against planes ``(..., E, R)``."""
    clock = torch.maximum(clock_a, clock_b)
    add, rm = merge_rule(
        clock_a.unsqueeze(-2), add_a, rm_a, clock_b.unsqueeze(-2), add_b, rm_b,
        clock.unsqueeze(-2),
    )
    return clock, add, rm


def orset_merge_many_tree(clocks, adds, rms):
    """Merge a stacked batch of S states ``(S, R) / (S, E, R)`` as
    ⌈log2 S⌉ rounds of the pairwise merge — the plain reference of the
    merge kernel.  Merge associativity makes any order legal."""
    c, a, r = clocks, adds, rms
    while c.shape[0] > 1:
        s = c.shape[0]
        half = s // 2
        cm, am, rmm = orset_merge(
            c[:half], a[:half], r[:half],
            c[half:2 * half], a[half:2 * half], r[half:2 * half],
        )
        if s % 2:
            cm = torch.cat([cm, c[-1:]])
            am = torch.cat([am, a[-1:]])
            rmm = torch.cat([rmm, r[-1:]])
        c, a, r = cm, am, rmm
    return c[0], a[0], r[0]


def orset_stack_cells_plain(cells, offsets, S: int, E: int, R: int):
    """The ``(S, E, R)`` add and remove stacks of S states from their cells
    (``ops.columnar.orset_states_to_cells``): ``cells (n, 2)`` int32 rows
    ``(e * R + r, counter)``, grouped as ``g = plane * S + s`` (adds, then
    removes) with ``offsets (2S + 1,)`` the groups' first rows.  Every
    other cell is 0.  The plain version of the stacking kernel."""
    plane = E * R
    out = torch.zeros(2 * S * plane, dtype=torch.int32, device=cells.device)
    group = torch.repeat_interleave(
        torch.arange(2 * S, device=cells.device), offsets.diff())
    out[group * plane + cells[:, 0].long()] = cells[:, 1]
    out = out.view(2, S, E, R)
    return out[0], out[1]


def orset_stack_cells(cells: torch.Tensor, offsets: torch.Tensor, S: int,
                      E: int, R: int):
    """The stacks ``orset_merge_many`` reads, built on the cells' device:
    CUDA tensors run the stacking kernel, CPU tensors the plain
    version."""
    if common_device(cells, offsets).type == "cuda":
        from .orset_merge_cuda import orset_stack_cells_cuda

        return orset_stack_cells_cuda(cells, offsets, S, E, R)
    return orset_stack_cells_plain(cells, offsets, S, E, R)


def orset_merge_many(clocks: torch.Tensor, adds: torch.Tensor,
                     rms: torch.Tensor):
    """Merge a stacked batch of S states ``(S, R) / (S, E, R)`` into one.
    CUDA tensors run the single-pass merge kernel for every S; CPU tensors
    the plain tree."""
    if common_device(clocks, adds, rms).type == "cuda":
        from .orset_merge_cuda import orset_merge_many_cuda

        return orset_merge_many_cuda(clocks, adds, rms)
    return orset_merge_many_tree(clocks, adds, rms)
