"""Multi-tenant serving: many tenants' compactions in shared device
launches.  The port's copy of ``crdt_enc_tpu/serve/`` on one device.

* :mod:`.service` — :class:`FoldService`: ingest → cross-tenant decode
  → one tenant-layout fold per bucket → per-tenant sealed snapshots.
* :mod:`.daemon` — :class:`FleetDaemon`: the supervised forever-loop
  over the service (staleness scheduling, backoff/quarantine, circuit
  breaker, admission, drain).
* :mod:`.bucketing` — the pure ragged-shape planner (size classes,
  spill rules).
* :mod:`.warm` — the tenant-keyed LRU of device fold planes under a byte
  budget.
"""

from .bucketing import Bucket, TenantShape, plan_buckets
from .daemon import AdmissionError, DaemonConfig, FleetDaemon, TenantEntry
from .service import FoldService, ServeConfig, TenantResult
from .warm import PlaneWarmTier, WarmEntry

__all__ = [
    "AdmissionError",
    "Bucket",
    "DaemonConfig",
    "FleetDaemon",
    "FoldService",
    "PlaneWarmTier",
    "ServeConfig",
    "TenantEntry",
    "TenantResult",
    "TenantShape",
    "WarmEntry",
    "plan_buckets",
]
