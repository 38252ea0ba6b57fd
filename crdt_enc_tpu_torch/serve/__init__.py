"""Multi-tenant serving: many tenants' compactions in shared device
launches.  The port's copy of ``crdt_enc_tpu/serve/`` on one device.

* :mod:`.service` — :class:`FoldService`: ingest → cross-tenant decode
  → one tenant-layout fold per bucket → per-tenant sealed snapshots.
* :mod:`.bucketing` — the pure ragged-shape planner (size classes,
  spill rules).
* :mod:`.warm` — the tenant-keyed LRU of device fold planes under a byte
  budget.
"""

from .bucketing import Bucket, TenantShape, plan_buckets
from .service import FoldService, ServeConfig, TenantResult
from .warm import PlaneWarmTier, WarmEntry

__all__ = [
    "Bucket",
    "FoldService",
    "PlaneWarmTier",
    "ServeConfig",
    "TenantResult",
    "TenantShape",
    "WarmEntry",
    "plan_buckets",
]
