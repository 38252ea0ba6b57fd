"""Tenant-keyed warm tier: an LRU of per-tenant fold planes on the card.

The port's copy of ``crdt_enc_tpu/serve/warm.py``.  The single-tenant
accelerator keeps ONE set of device planes (``parallel/accel.
_OrsetPlaneCache``) so the next fold of an unmutated state skips the
state walk and the plane upload.  The fold service does the same per
tenant, under a byte budget: the tier holds each tenant's last fold
output — its own ``(clock, add, rm)`` slice of the bucket's planes,
copied out of the bucket as tensors on the fold's device, padded to the
bucket's shape — and the vocabularies that index them, keyed by the
tenant state's identity and validated by the ``_mut`` epoch the
accelerator cache uses, so ANY host mutation expires the entry.

Budget: ``byte_budget`` bounds the summed plane bytes; inserting past it
evicts least-recently-used entries first (the newest entry itself is
never evicted at insert).  Counters ``serve_warm_hits``,
``serve_warm_misses``, ``serve_warm_expired``, ``serve_warm_evictions``
and the ``serve_warm_bytes`` gauge show the tier per cycle.

Entries carry the ``members / replicas / canon / planes`` of the
accelerator's plane cache, so the service reuses
``TorchAccelerator._remap_to_cache`` and ``_cached_planes_padded``: one
vocabulary-collision guard, not two.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

from ..utils import trace

DEFAULT_BYTE_BUDGET = 256 << 20  # summed plane bytes across tenants


class WarmEntry:
    """One tenant's cached fold planes (see module docs)."""

    __slots__ = ("ref", "token", "members", "replicas", "planes", "canon",
                 "nbytes", "seal_name")

    def __init__(self, ref, token, members, replicas, planes, canon):
        self.ref = ref
        self.token = token
        self.members = members
        self.replicas = replicas
        self.planes = planes  # (clock, add, rm) tensors, padded shapes
        self.canon = canon  # member slot -> canonical packed bytes
        self.nbytes = sum(p.numel() * p.element_size() for p in planes)
        # content-addressed name of the sealed snapshot these planes ARE
        # (stamped after a successful seal by PlaneWarmTier.stamp_seal);
        # None until then.  When it matches the core's delta-base name,
        # the next cycle cuts the tenant's delta on the device from these
        # planes, and the core keeps no host copy of the base.
        self.seal_name = None


class PlaneWarmTier:
    """LRU of :class:`WarmEntry` keyed by tenant state identity.

    ``mesh_key`` pins the tier to one device mesh: a tier built for a
    mesh holds the planes of the sharded tenant folds, laid out for that
    mesh, and a service must never hand a foreign tier its entries.  The
    key is compared by identity in :meth:`compatible_with`; ``None`` is
    the one-device tier."""

    def __init__(self, byte_budget: int = DEFAULT_BYTE_BUDGET,
                 mesh_key=None):
        if byte_budget < 1:
            raise ValueError("byte_budget must be positive")
        self.byte_budget = int(byte_budget)
        self.mesh_key = mesh_key
        self._entries: OrderedDict[int, WarmEntry] = OrderedDict()
        self._bytes = 0

    def compatible_with(self, mesh_key) -> bool:
        """True when entries stored by this tier belong to ``mesh_key``
        (an identity match: two meshes over the same devices are still
        two meshes)."""
        return self.mesh_key is mesh_key

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_held(self) -> int:
        return self._bytes

    def _drop(self, key: int) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry.nbytes
            trace.gauge("serve_warm_bytes", self._bytes)

    def lookup(self, state) -> WarmEntry | None:
        """The live entry for ``state``, or None (no entry, entry for a
        dead/foreign object, or the state mutated since it was stored —
        stale entries are dropped on sight, they can never be right
        again).  A hit refreshes the entry's LRU position; a miss on a
        stored-but-mutated state also counts ``serve_warm_expired``."""
        key = id(state)
        entry = self._entries.get(key)
        if entry is None:
            trace.add("serve_warm_misses", 1)
            return None
        if entry.ref() is not state or entry.token != getattr(
            state, "_mut", None
        ):
            self._drop(key)
            trace.add("serve_warm_misses", 1)
            trace.add("serve_warm_expired", 1)
            return None
        self._entries.move_to_end(key)
        trace.add("serve_warm_hits", 1)
        return entry

    def store(self, state, members, replicas, planes, canon=None) -> WarmEntry:
        """Record ``state``'s post-fold planes as its warm entry (token =
        the state's CURRENT ``_mut`` — call after the writeback bump),
        then evict LRU entries past the byte budget.  The weakref
        finalizer drops the entry the moment the state dies, so plane
        buffers never outlive the tenant they cache; it records no
        metric (see ``_finalize``)."""
        key = id(state)
        self._drop(key)

        tier_ref = weakref.ref(self)

        def _finalize(dead_ref, _key=key):
            # the collector runs this wherever it fires, also inside the
            # trace registry's (non-reentrant) lock on this very thread,
            # so it records nothing: the gauge catches up at the next
            # store or drop
            tier = tier_ref()
            if tier is not None:
                e = tier._entries.get(_key)
                if e is not None and e.ref is dead_ref:
                    del tier._entries[_key]
                    tier._bytes -= e.nbytes

        entry = WarmEntry(
            weakref.ref(state, _finalize), getattr(state, "_mut", None),
            members, replicas, planes, canon if canon is not None else {},
        )
        self._entries[key] = entry
        self._bytes += entry.nbytes
        while self._bytes > self.byte_budget and len(self._entries) > 1:
            oldest = next(iter(self._entries))
            if oldest == key:
                break  # never evict the entry being inserted
            self._drop(oldest)
            trace.add("serve_warm_evictions", 1)
        trace.gauge("serve_warm_bytes", self._bytes)
        return entry

    def stamp_seal(self, state, seal_name) -> bool:
        """Mark ``state``'s live warm entry as byte-identical to the
        sealed snapshot ``seal_name`` — called by the service AFTER a
        successful seal, iff the state has not mutated since the planes
        were stored.  Deliberately not a :meth:`lookup` (no hit/miss
        accounting, no LRU refresh): this is a seal-time annotation, not
        a use.  Returns False (and stamps nothing) on any doubt."""
        entry = self._entries.get(id(state))
        if (
            entry is None
            or entry.ref() is not state
            or entry.token != getattr(state, "_mut", None)
        ):
            return False
        entry.seal_name = seal_name
        return True
