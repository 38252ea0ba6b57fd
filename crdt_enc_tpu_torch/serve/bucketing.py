"""Ragged tenant bucketing: quantized size classes for the batched fold.

The port's copy of ``crdt_enc_tpu/serve/bucketing.py``, the same plan
for the same shapes.  The fold service batches many tenants' op columns
into one device launch (``ops.orset.orset_fold_tenant_layout``), which
needs every tenant of a batch to share one padded shape:

* every tenant's ragged ``(rows, members, replicas)`` quantizes to a
  power-of-two **size class** (``_bucket``, floor 8);
* tenants of one size class and CRDT kind group into **buckets**; a
  bucket's tenant count pads to a power of two too (floor 1); with
  ``dp``/``mp`` > 1 the slot classes become dp-multiples and OR-Set
  member classes mp-multiples;
* a tenant too big for batching — rows past ``rows_cap`` or dense planes
  past ``cells_cap`` — **spills to the solo path** (the single-tenant
  accelerator's bulk fold, with its sparse and blockwise regimes); a
  size-class group larger than ``tenants_cap`` splits into several
  buckets of the same class.

The planner never looks at tenant contents, only shapes, so two
shuffled mixes of the same size classes give the same set of launch
shapes.  Eager PyTorch compiles nothing per shape; the classes still
bound the padded planes' memory, and keep the plan the JAX package's.
"""

from __future__ import annotations

from dataclasses import dataclass

# A "small remote"; past this the solo accelerator's streaming and sparse
# regimes are the right machinery.
DEFAULT_ROWS_CAP = 1 << 15
# Dense per-tenant plane bound inside a bucket (cells = members·replicas;
# 1M cells = 4MB/plane/tenant): past it the solo fold's sparse regime
# (ops/columnar.orset_fold_sparse_host) wins anyway.
DEFAULT_CELLS_CAP = 1 << 20
# Tenants per bucket: bounds the stacked planes' host and device
# footprint (split buckets share their shape).
DEFAULT_TENANTS_CAP = 1 << 10


def _bucket(n: int, floor: int = 8) -> int:
    """The shape quantizer: the smallest power of two ≥ ``n``, floored."""
    b = floor
    while b < n:
        b *= 2
    return b


@dataclass(frozen=True)
class TenantShape:
    """One tenant's ragged fold shape, as measured after decode:
    ``key`` is the service's tenant handle (opaque to the planner);
    ``members`` is 0 for plane-less kinds (counters)."""

    key: object
    kind: str  # "orset" | "gcounter"
    rows: int
    members: int
    replicas: int


@dataclass
class Bucket:
    """One batched dispatch: ``tenants`` (≤ ``slots``) share the padded
    shape ``(slots, rows, members, replicas)``; slots beyond the tenant
    list are dummy all-sentinel lanes over zero planes."""

    kind: str
    rows: int
    members: int
    replicas: int
    tenants: list
    slots: int


def plan_buckets(
    shapes: list[TenantShape],
    *,
    rows_cap: int = DEFAULT_ROWS_CAP,
    cells_cap: int = DEFAULT_CELLS_CAP,
    tenants_cap: int = DEFAULT_TENANTS_CAP,
    dp: int = 1,
    mp: int = 1,
) -> tuple[list[Bucket], list]:
    """Plan one service cycle's batched dispatches.

    Returns ``(buckets, solo)``: the buckets in deterministic
    (kind, shape) order, and the keys of tenants that spill to the solo
    path.  Pure — no state, no randomness — so the same shapes always
    produce the same plan.

    ``dp``/``mp`` make the plan mesh-aware: bucket slot counts quantize
    to **multiples of dp** (the classes {dp, 2·dp, 4·dp, …}) and OR-Set
    member classes lift to **multiples of mp**.  ``dp=mp=1`` (the
    default, and all the single-card service passes) is the single-chip
    plan.
    """
    if rows_cap < 1 or cells_cap < 1 or tenants_cap < 1:
        raise ValueError("bucket caps must be positive")
    if dp < 1 or mp < 1:
        raise ValueError("mesh axes must be positive")
    groups: dict[tuple, list] = {}
    solo: list = []
    for s in shapes:
        if s.rows <= 0:
            continue  # nothing to fold — the caller's empty path
        rows_b = _bucket(s.rows)
        e_b = _bucket(s.members) if s.kind == "orset" else 0
        if e_b and e_b % mp:
            # lift to the next mp multiple: the class set stays bounded
            # (a pure function of the power-of-two classes), and a
            # non-power-of-two mp terminates — doubling would not
            e_b = -(-e_b // mp) * mp
        r_b = _bucket(s.replicas)
        if s.rows > rows_cap or (s.kind == "orset" and e_b * r_b > cells_cap):
            solo.append(s.key)
            continue
        groups.setdefault((s.kind, rows_b, e_b, r_b), []).append(s.key)
    buckets: list[Bucket] = []
    for (kind, rows_b, e_b, r_b), keys in sorted(
        groups.items(), key=lambda kv: (kv[0][0], kv[0][1], kv[0][2], kv[0][3])
    ):
        for lo in range(0, len(keys), tenants_cap):
            chunk = keys[lo : lo + tenants_cap]
            slots = dp * _bucket(-(-len(chunk) // dp), floor=1)
            buckets.append(Bucket(kind, rows_b, e_b, r_b, chunk, slots))
    return buckets, solo
