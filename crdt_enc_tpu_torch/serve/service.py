"""Multi-tenant fold service: thousands of small remotes, one launch each
bucket.

The port's copy of ``crdt_enc_tpu/serve/service.py``.  A solo
``Core.compact()`` pays a whole
ingest, session, kernel launch and replication probe per remote;
:class:`FoldService` shares them across a fleet of open cores:

1. **ingest** — per tenant, the service reads remote meta and snapshots
   through the tenant's own paths and pulls the pending op tail through
   ``Core.load_sealed_ops`` (list, load, outer unwrap, ciphertexts
   grouped by sealing key; no decrypt yet).  Tenants ingest concurrently
   under a bounded semaphore.
2. **decrypt** — every tenant whose cryptor has a sync batch open
   (``Cryptor.decrypt_batch_fn``) decrypts inside ONE worker-thread hop;
   the versions are then checked by the core's ``_validate_chunk``
   without advancing any cursor: cursors move only after the fold lands.
3. **decode** — a thread pool maps the native columnar decode over
   groups of tenants (the native calls release the interpreter lock);
   each result lands on its own tenant.
4. **plan + fold** — decoded tenants quantize into size classes
   (``serve.bucketing``) and every bucket folds in ONE device launch:
   the tenants' planes lie side by side as ``(E_b, T·R_b)`` and K2
   (``csrc/orset_fold.cu``) folds them as one fold, tenant t's replica r
   in column ``t·R_b + r`` and every padding row in the layout's own
   sentinel column ``T·R_b`` (``ops.orset.orset_fold_tenant_layout``);
   G-Counter buckets fold the same way in plain PyTorch.  Oversized
   tenants spill to the solo accelerator path (``fold_payloads``);
   tenants whose rows the columns cannot hold fold per op through
   ``Core._fold_chunk_python``.  The fold phase — plane capture, launch,
   writeback, cursor advance — is one synchronous section, so a
   concurrent apply cannot interleave a torn (planes, state) pair.
5. **writeback + seal** — each tenant's slice of the folded planes is
   written back into its live state, and each tenant seals through its
   own ``Core._compact_seal``: the snapshot wire form, GC order,
   checkpoint and sink record of a solo compact, so the sealed bytes
   equal a solo ``compact()``'s (tests/test_torch_serve.py).

**Warm tier** (``serve.warm``): each tenant's folded planes stay on the
device under a byte-budgeted LRU keyed by state identity × mutation
epoch, so the next cycle on an unmutated tenant skips the state walk and
the plane upload; after a seal the entry is stamped with the snapshot's
name, and the next cycle cuts that tenant's delta on the device from the
same planes (``ops.orset.orset_plane_diff``), copying only the diff rows
to the host.

**Mesh** (``FoldService(mesh=)``, a ``parallel.mesh.Mesh`` of two or
more shards): the bucket folds run the sharded tenant folds — tenant
lanes over ``dp``, member planes over ``mp``, one K2 launch per shard
(``mesh.orset_fold_tenants_sharded``, span ``serve.shard``, counters
``serve_sharded_folds`` and ``serve_sharded_tenants``) — the planner
quantizes bucket slots to dp and member classes to mp, the device-cut
delta diffs through ``mesh.tenant_plane_diff_sharded``, and solo spills
fold through a service-owned ``TorchAccelerator(mesh=)``.  The warm tier
belongs to the mesh (``PlaneWarmTier(mesh_key=)``).  A mesh that spans
processes is refused: its dp-sharded arguments are process-local, and a
cycle's tenants are not split across ranks.

**Replication probes**: every tenant's seal samples replication with
``_backlog=[]`` (the cycle's ingest folded everything its listing
found), so a cycle pays zero extra ``stat_ops`` probes.

Every phase emits ``serve.*`` spans; each sealed tenant's end-to-end
latency lands in the ``serve.tenant`` histogram (p50/p95/p99).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import ops as K
from ..models import GCounter, ORSet
from ..models.counters import POS
from ..obs import runtime as obs_runtime
from ..ops import orset as orset_ops
from ..ops.columnar import orset_fits_int32
from ..ops.counters import gcounter_fold_tenants
from ..utils import codec, trace
from . import bucketing
from .bucketing import TenantShape, _bucket, plan_buckets
from .warm import DEFAULT_BYTE_BUDGET, PlaneWarmTier

logger = logging.getLogger("crdt_enc_tpu_torch.serve")


@dataclass
class ServeConfig:
    """Service knobs; the defaults serve the many-small-tenants shape."""

    rows_cap: int = bucketing.DEFAULT_ROWS_CAP
    cells_cap: int = bucketing.DEFAULT_CELLS_CAP
    tenants_cap: int = bucketing.DEFAULT_TENANTS_CAP
    # decode fan-out width: 0 = auto (ops.stream.stream_producer_count:
    # CRDT_STREAM_PRODUCERS, else one per core but one)
    producers: int = 0
    # concurrent tenant ingests and seals (a bounded asyncio semaphore);
    # the daemon's stat-only polls share the bound
    io_width: int = 16
    # the warm plane tier (serve.warm); off, it is neither consulted nor
    # filled, and every cycle folds each tenant from its state
    warm: bool = True
    # its budget, in summed plane bytes
    warm_bytes: int = DEFAULT_BYTE_BUDGET
    # seal a snapshot for a tenant with no new ops (a solo compact's
    # behaviour); off, a quiet tenant costs nothing per cycle (the daemon)
    seal_empty: bool = True
    # skip the seal, GC, checkpoint and sample of a quiet tenant whose seal
    # signature has not moved since its last seal (``serve_noop_cycles``);
    # off, every cycle re-seals it, the O(state) steady state
    noop_skip: bool = True


@dataclass
class TenantResult:
    """One tenant's outcome for one service cycle.  ``path`` is how its
    ops folded: ``batched`` (the bucket fold), ``solo`` (spilled to the
    single-tenant accelerator bulk path), ``perop`` (the columns could
    not hold its rows: per-op fold), ``empty`` (no new ops), or
    ``error``."""

    path: str = "empty"
    rows: int = 0
    latency_s: float = 0.0
    sealed: bool = False
    error: str | None = None


@dataclass
class _TenantWork:
    idx: int
    core: object
    actors: list = field(default_factory=list)
    files: list = field(default_factory=list)
    groups: list = field(default_factory=list)  # (key, idxs, middles)
    clears: list = field(default_factory=list)
    payloads: list = field(default_factory=list)
    metas: list = field(default_factory=list)
    actors_sorted: list = field(default_factory=list)
    kind: str | None = None  # "orset" | "gcounter" | None (solo type)
    cols: tuple | None = None  # decoded columns + vocabularies
    prepared: tuple | None = None  # fold-phase planes/vocabularies
    packed: tuple | None = None  # planes-packed checkpoint payload
    state_obj: tuple | None = None  # pre-built snapshot state object
    delta_cut: dict | None = None  # device-cut delta candidate
    result: TenantResult = field(default_factory=TenantResult)

    @property
    def ok(self) -> bool:
        return self.result.error is None


def _actor_table(state, actors) -> list:
    """Sorted actor table for the native decoders: the storage listing
    plus every actor the state mentions."""
    actor_set = set(actors)
    if isinstance(state, ORSet):
        actor_set.update(state.clock.counters)
        for entry in state.entries.values():
            actor_set.update(entry)
        for dfr in state.deferred.values():
            actor_set.update(dfr)
    elif isinstance(state, GCounter):
        actor_set.update(state.clock.counters)
    return sorted(actor_set)


def _decode_orset_columns(adapter, payloads, actors_sorted):
    """One tenant's payloads → ``(kind, member, actor, counter, members,
    replicas)`` columns, or None where int32 columns cannot hold them (a
    counter past 2^31 − 1: the per-op path then folds the tenant, as a
    solo compact does).  The native span decoder first; the Python
    columnarizer where it declines, or where two members collide as
    Python values (1 == True, 0.0 == -0.0) — the Python path interns by
    value, which is the host dict semantics."""
    from ..ops.native_decode import decode_orset_payload_batch

    decoded = decode_orset_payload_batch(payloads, actors_sorted)
    if decoded is not None:
        kind, member_idx, actor_idx, counter, member_objs = decoded
        members = K.Vocab(member_objs)
        if len(members) == len(member_objs):
            replicas = K.Vocab(list(actors_sorted))
            return kind, member_idx, actor_idx, counter, members, replicas
    ops = [adapter.op_from_obj(o) for p in payloads for o in codec.unpack(p)]
    members, replicas = K.Vocab(), K.Vocab(list(actors_sorted))
    try:
        cols = K.orset_ops_to_columns(ops, members, replicas)
    except OverflowError:
        return None
    return cols.kind, cols.member, cols.actor, cols.counter, members, replicas


def _decode_gcounter_columns(adapter, payloads, actors_sorted):
    """One tenant's payloads → ``(actor, counter, replicas)`` columns, or
    None where the rows are not plain G-Counter increments (the per-op
    path then folds them, as the solo bulk path would)."""
    from ..ops.native_decode import decode_counter_payload_batch

    decoded = decode_counter_payload_batch(payloads, actors_sorted)
    if decoded is not None:
        sign, actor_idx, counter = decoded
        if len(sign) and bool(np.any(sign != POS)):
            return None
        return actor_idx, counter, K.Vocab(list(actors_sorted))
    ops = [adapter.op_from_obj(o) for p in payloads for o in codec.unpack(p)]
    cols = K.counter_ops_to_columns(ops, K.Vocab(list(actors_sorted)))
    if len(cols.sign) and bool(np.any(cols.sign != POS)):
        return None
    return cols.actor, cols.counter, cols.replicas


def _tenant_device(w) -> torch.device:
    """The device a tenant's accelerator folds on: a ``TorchAccelerator``'s
    own device (the card by default), the CPU for the host reference
    (``HostAccelerator``, which has no device)."""
    return torch.device(getattr(w.core.accel, "device", None) or "cpu")


class FoldService:
    """Batch many tenants' compactions into shared device launches.

    ``tenants`` are OPEN :class:`~crdt_enc_tpu_torch.core.core.Core`
    handles, each attached to its own remote; ``run_cycle`` is one
    ``compact()`` of every tenant.  Tenants are bucketed per device, and
    each bucket folds on the device its tenants' accelerators share
    (``TorchAccelerator().device``, the card, unless the tenants were
    opened with ``TorchAccelerator(device="cpu")``; the CPU's plain
    versions for tenants of the host reference, ``HostAccelerator``).
    Concurrent local ``apply_ops`` are honoured (the fold phase is one
    sync section); a second concurrent compactor on the same tenant is
    the caller's bug, as it always was.
    """

    def __init__(self, tenants, config: ServeConfig | None = None,
                 live_port: int | None = None, mesh=None):
        self.tenants = list(tenants)
        self.config = config if config is not None else ServeConfig()
        # a device mesh of two or more shards: the bucket folds run the
        # sharded tenant folds, oversize spills a service-owned mesh
        # accelerator's sharded fold (see the module docs)
        self.mesh = mesh
        self._mesh_active = mesh is not None and mesh.size > 1
        self._mesh_accel = None
        if self._mesh_active:
            if mesh.spans_processes:
                raise ValueError("FoldService folds on an in-process mesh; "
                                 "this one spans processes")
            from ..parallel.accel import TorchAccelerator

            self._mesh_accel = TorchAccelerator(min_device_batch=1, mesh=mesh)
            trace.gauge("serve_mesh_devices", mesh.size)
        mesh_key = mesh if self._mesh_active else None
        self.warm = (PlaneWarmTier(self.config.warm_bytes, mesh_key=mesh_key)
                     if self.config.warm else None)
        # the mesh-identity guard, where entries are consumed: a tier
        # built for another mesh holds planes laid out for that mesh
        if self.warm is not None and not self.warm.compatible_with(mesh_key):
            raise ValueError("warm tier belongs to a different mesh identity")
        # a service-owned live telemetry endpoint (obs/live.py):
        # live_port=0 binds an ephemeral port (self.live.port); None = no
        # server (a process-default CRDT_OBS_HTTP server, if any, still
        # receives the publications)
        self.live = None
        if live_port is not None:
            from ..obs.live import LiveTelemetryServer

            self.live = LiveTelemetryServer(port=live_port)
            self.live.start()
        # the last cycle's summary (paths, wall, SLO burn): what /healthz
        # shows and the cycle's sink record carries
        self.last_cycle_summary: dict | None = None
        self._closed = False
        self._cycle_running = False
        # run_cycle_shared's lock, made per event loop
        self._owner_lock: asyncio.Lock | None = None
        self._owner_loop = None

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """Stop the service-owned live telemetry listener (the tenants
        stay open: they are the caller's).  A second close logs and does
        nothing."""
        if self._closed:
            logger.warning("FoldService.close(): already closed (no-op)")
            return
        self._closed = True
        if self.live is not None:
            self.live.stop()

    # ------------------------------------------------------------- cycle
    async def run_cycle(self, tenants=None) -> list[TenantResult]:
        """One service cycle: ingest → decrypt → decode → bucket folds →
        per-tenant seal.  ``tenants`` overrides the fleet for this cycle.
        Returns one :class:`TenantResult` per tenant, index-aligned.  A
        failing tenant reports ``path="error"`` and the rest of the fleet
        still compacts.  Not reentrant: an overlapping cycle (or one on a
        closed service) raises ``RuntimeError`` at once."""
        if self._closed:
            raise RuntimeError("FoldService is closed; run_cycle refused")
        if self._cycle_running:
            raise RuntimeError(
                "FoldService.run_cycle is not reentrant: a cycle is "
                "already in flight on this service"
            )
        self._cycle_running = True
        try:
            return await self._run_cycle(
                self.tenants if tenants is None else list(tenants)
            )
        finally:
            self._cycle_running = False

    async def run_cycle_shared(self, tenants=None) -> list[TenantResult]:
        """:meth:`run_cycle` for several owners sharing one service:
        overlapping calls queue on a lock and run one whole cycle at a
        time, each the cycle its owner would have run on a private
        service."""
        loop = asyncio.get_running_loop()
        if self._owner_lock is None or self._owner_loop is not loop:
            self._owner_lock = asyncio.Lock()
            self._owner_loop = loop
        async with self._owner_lock:
            return await self.run_cycle(tenants)

    async def _run_cycle(self, tenants) -> list[TenantResult]:
        t0 = time.perf_counter()
        works = [_TenantWork(i, core) for i, core in enumerate(tenants)]
        with trace.span("serve.cycle"):
            await self._ingest_all(works)
            await self._decrypt_all(works)
            decodable = [w for w in works if w.ok and w.kind and w.payloads]
            if decodable:
                await asyncio.to_thread(self._decode_all, decodable)
            self._fold_batched(works)
            await self._fold_fallbacks(works)
            await self._seal_all(works, t0)
            self._stamp_continuations(works)
        trace.add("serve_cycles", 1)
        trace.add("serve_tenants", len(works))
        results = [w.result for w in works]
        await self._publish_cycle(tenants, results, time.perf_counter() - t0)
        return results

    async def _publish_cycle(self, tenants, results, wall_s: float) -> None:
        """After the cycle: its summary (paths, wall, seal-latency SLO
        burn) goes to the live ``/healthz`` and, with a sink configured,
        into one ``serve_cycle`` record; each tenant that sealed publishes
        its fresh replication status.  Never fatal to the cycle."""
        from ..obs import live as obs_live
        from ..obs import sink as obs_sink
        from ..obs import slo as obs_slo

        try:
            burn = obs_slo.cycle_burn(results)
            paths: dict[str, int] = {}
            for r in results:
                paths[r.path] = paths.get(r.path, 0) + 1
            summary = {
                "tenants": len(results),
                "sealed": sum(1 for r in results if r.sealed),
                "errors": sum(1 for r in results if r.error is not None),
                "paths": paths,
                "wall_s": round(wall_s, 4),
                "slo": burn,
            }
            self.last_cycle_summary = summary
            trace.gauge("serve_slo_seal_burn", burn["burn_rate"])
            target = self.live if self.live is not None \
                else obs_live.default_server()
            if target is not None:
                target.publish_cycle("fold_service", summary)
                # only tenants that sealed this cycle sampled a fresh
                # status; republishing an old one would stamp stale
                # watermark data with a current time
                for core, r in zip(tenants, results):
                    status = getattr(core, "last_replication_status", None)
                    if r.sealed and status is not None:
                        target.publish_health(status)
            if obs_sink.default_sink() is not None:
                await asyncio.to_thread(
                    obs_sink.maybe_write, "serve_cycle", summary
                )
        except Exception:  # telemetry must not fail the fleet cycle
            logger.debug("cycle telemetry publication failed",
                         exc_info=True)

    # ------------------------------------------------------- strong reads
    async def read_strong(self, core, *, max_lag=None, min_cursor=None,
                          refresh: bool = True):
        """A tenant's strong read through the service: the guarantee of
        ``Core.read(linearizable=True)``.  ``refresh=False`` skips the
        ``read_remote`` when the caller knows the tenant just cycled.
        Refusals raise ``StalenessError`` unchanged."""
        if self._closed:
            raise RuntimeError("FoldService is closed; read_strong refused")
        with trace.span("serve.read_strong"):
            trace.add("serve_strong_reads", 1)
            return await core.read(
                linearizable=True, max_lag=max_lag,
                min_cursor=min_cursor, refresh=refresh,
            )

    # ------------------------------------------------------------ ingest
    async def _ingest_all(self, works) -> None:
        sem = asyncio.Semaphore(max(1, self.config.io_width))

        async def one(w: _TenantWork):
            async with sem:
                try:
                    with trace.span("serve.ingest", meta=w.idx):
                        core = w.core
                        await core._read_remote_meta()
                        await core._read_remote_states()
                        w.actors, w.files, w.groups = (
                            await core.load_sealed_ops()
                        )
                except Exception as e:  # tenant isolation
                    w.result.error = repr(e)
                    w.result.path = "error"

        await asyncio.gather(*(one(w) for w in works))

    # ----------------------------------------------------------- decrypt
    async def _decrypt_all(self, works) -> None:
        """Open every tenant's ciphertexts, then check versions.  Tenants
        whose cryptor has ``decrypt_batch_fn`` all decrypt inside ONE
        ``asyncio.to_thread`` hop; the rest take the async
        ``decrypt_batch``.  The version checks (``_validate_chunk``) run
        back on the event loop: they read live cursors."""
        sync_plans: list[tuple[_TenantWork, list]] = []
        async_works: list[_TenantWork] = []
        for w in works:
            if not w.ok or not w.files:
                continue
            try:
                plans = []
                for key, idxs, mids in w.groups:
                    fn = w.core.cryptor.decrypt_batch_fn(key.material)
                    if fn is None:
                        plans = None
                        break
                    plans.append((fn, idxs, mids))
            except Exception as e:  # e.g. a foreign key version
                w.result.error = repr(e)
                w.result.path = "error"
                continue
            if plans is None:
                async_works.append(w)
            else:
                sync_plans.append((w, plans))

        def run_sync_plans():
            from ..core.core import _QUARANTINED, IngestDecryptError

            for w, plans in sync_plans:
                try:
                    clears: list = [None] * len(w.files)
                    for fn, idxs, mids in plans:
                        try:
                            outs = fn(mids)
                        except Exception:
                            # a damaged blob in the batch: isolate it per
                            # file (skip, count, hold the cursor); the
                            # WHOLE batch failing is a dead cryptor or a
                            # damaged key, a tenant error
                            outs, failed = [], []
                            for i, m in zip(idxs, mids):
                                try:
                                    outs.append(fn([m])[0])
                                except Exception as e:
                                    outs.append(_QUARANTINED)
                                    failed.append((i, e))
                            if len(mids) > 1 and len(failed) == len(mids):
                                raise IngestDecryptError(
                                    f"all {len(mids)} op files in the "
                                    "tenant batch failed to open"
                                ) from failed[-1][1]
                            for i, e in failed:
                                actor, version, _ = w.files[i]
                                w.core._note_quarantine(
                                    "op", f"{actor.hex()}:v{version}", e,
                                )
                        for i, clear in zip(idxs, outs):
                            clears[i] = clear
                    w.clears = clears
                    trace.add(
                        "bytes_decrypted",
                        sum(len(m) for _, _, mids in plans for m in mids),
                    )
                except Exception as e:  # tenant-local
                    w.result.error = repr(e)
                    w.result.path = "error"

        if sync_plans:
            with trace.span("serve.decrypt", meta=len(sync_plans)):
                await asyncio.to_thread(run_sync_plans)
        for w in async_works:
            try:
                with trace.span("serve.decrypt", meta=w.idx):
                    clears = [None] * len(w.files)
                    for key, idxs, mids in w.groups:
                        outs = await w.core._decrypt_tolerant(
                            key, [w.files[i] for i in idxs], mids
                        )
                        for i, clear in zip(idxs, outs):
                            clears[i] = clear
                    w.clears = clears
                    trace.add(
                        "bytes_decrypted",
                        sum(len(m) for _, _, mids in w.groups for m in mids),
                    )
            except Exception as e:
                w.result.error = repr(e)
                w.result.path = "error"
        # sync section: version checks WITHOUT cursor advance
        for w in works:
            if not w.ok or not w.files:
                continue
            try:
                w.payloads, w.metas = w.core._validate_chunk(
                    w.files, w.clears
                )
                state = w.core._data.state
                if isinstance(state, ORSet):
                    w.kind = "orset"
                elif isinstance(state, GCounter):
                    w.kind = "gcounter"
                if w.payloads:
                    w.actors_sorted = _actor_table(state, w.actors)
            except Exception as e:
                w.result.error = repr(e)
                w.result.path = "error"

    # ------------------------------------------------------------ decode
    def _decode_all(self, works) -> None:
        """The cross-tenant decode fan-out, off the event loop: the
        ordered producer pool (``ops.stream.run_ingest_pipeline``) with
        groups of tenants as its work items, ``config.producers`` wide
        (the native decoders release the interpreter lock); results land
        on each work item in tenant order."""
        from ..ops.stream import run_ingest_pipeline, stream_producer_count

        producers = self.config.producers
        if producers <= 0:
            producers = stream_producer_count()
        # a few groups per producer: thousands of tiny tenants ride in
        # groups, not one queue hop and span each
        group = max(1, -(-len(works) // max(producers * 4, 1)))
        chunks = [works[i : i + group] for i in range(0, len(works), group)]

        def decode_one(w: _TenantWork):
            with trace.span("serve.decode", meta=w.idx):
                if w.kind == "orset":
                    return _decode_orset_columns(
                        w.core.adapter, w.payloads, w.actors_sorted
                    )
                return _decode_gcounter_columns(
                    w.core.adapter, w.payloads, w.actors_sorted
                )

        def ingest(chunk: list, k: int):
            out = []
            for w in chunk:
                try:
                    out.append(decode_one(w))
                except Exception as e:  # tenant isolation
                    out.append(("error", e))
            return out

        def reduce(decoded_list, k: int):
            for w, decoded in zip(chunks[k], decoded_list):
                if isinstance(decoded, tuple) and len(decoded) == 2 and \
                        decoded[0] == "error":
                    w.result.error = repr(decoded[1])
                    w.result.path = "error"
                else:
                    w.cols = decoded  # None = the per-op fallback

        run_ingest_pipeline(
            chunks, ingest, reduce, producers=producers,
            thread_prefix="crdt-serve-producer",
        )

    # -------------------------------------------------------------- fold
    def _fold_batched(self, works) -> None:
        """Plan and run the bucket folds: one synchronous section per
        cycle, so plane capture, launch, writeback and cursor advance
        never interleave with a concurrent apply."""
        by_idx: dict[int, _TenantWork] = {}
        # tenants are planned per device, so a bucket never mixes tenants
        # whose accelerators fold on different devices
        shapes: dict[torch.device, list[TenantShape]] = {}
        buckets = []
        with trace.span("serve.plan"):
            for w in works:
                if not (w.ok and w.kind and w.payloads):
                    continue
                if w.cols is None:
                    w.result.path = "perop"
                    continue
                if len(w.cols[0]) == 0:
                    # validated files that decode to zero rows: nothing to
                    # fold, but the cursors advance as a solo compact's do
                    # (a stale cursor would re-read them forever)
                    w.core._advance_cursors(w.metas)
                    w.result.path = "batched"
                    continue
                prepared = self._prepare_tenant(w)
                if prepared is None:
                    w.result.path = "solo"
                    continue
                shape = prepared[0]
                w.prepared = prepared[1]
                by_idx[w.idx] = w
                # under a mesh every tenant folds on the mesh
                shapes.setdefault(
                    self.mesh.home if self._mesh_active else _tenant_device(w),
                    [],
                ).append(shape)
            for dev_shapes in shapes.values():
                dev_buckets, solo = plan_buckets(
                    dev_shapes,
                    rows_cap=self.config.rows_cap,
                    cells_cap=self.config.cells_cap,
                    tenants_cap=self.config.tenants_cap,
                    dp=self.mesh.shape["dp"] if self._mesh_active else 1,
                    mp=self.mesh.shape["mp"] if self._mesh_active else 1,
                )
                buckets += dev_buckets
                for key in solo:
                    by_idx[key].result.path = "solo"
                    trace.add("serve_solo_spills", 1)
                    del by_idx[key]
        trace.gauge("serve_buckets", len(buckets))
        for bi, bucket in enumerate(buckets):
            try:
                if bucket.kind == "orset":
                    self._fold_orset_bucket(bi, bucket, by_idx)
                else:
                    self._fold_gcounter_bucket(bi, bucket, by_idx)
            except Exception as e:  # e.g. the card out of memory
                # isolation at bucket granularity: tenants whose writeback
                # landed (path "batched", cursors advanced) go on to seal;
                # the rest of the bucket reports the error, and the other
                # buckets still fold
                for key in bucket.tenants:
                    w = by_idx[key]
                    if w.result.path != "batched":
                        w.result.error = repr(e)
                        w.result.path = "error"

    def _prepare_tenant(self, w: _TenantWork):
        """Fold-phase prep of one decoded tenant: the vocabularies (a warm
        remap, or a scan of the state) and its ragged shape.  Returns
        ``(TenantShape, prepared)``, or None to send the tenant to the
        solo path (counters the int32 planes cannot hold: one such tenant
        must not fail its whole bucket)."""
        from ..parallel.accel import TorchAccelerator

        state = w.core._data.state
        if w.kind == "orset":
            kind, member, actor, counter, members, replicas = w.cols
            entry = self.warm.lookup(state) if self.warm is not None else None
            if entry is not None:
                remapped = TorchAccelerator._remap_to_cache(
                    entry, member, actor, members, replicas
                )
                if remapped is None:
                    entry = None
                else:
                    member, actor = remapped
                    members, replicas = entry.members, entry.replicas
            if entry is None:
                if not orset_fits_int32(state):
                    return None  # the int32 planes cannot hold the state
                K.orset_scan_vocab(state, members, replicas)
            shape = TenantShape(
                w.idx, "orset", len(kind), len(members), len(replicas)
            )
            return shape, (kind, member, actor, counter, members, replicas,
                           entry)
        actor_idx, counter, replicas = w.cols
        clock0 = K.vclock_to_dense(state.clock, replicas)
        if clock0.dtype != np.int32 or np.asarray(counter).dtype != np.int32:
            return None  # past int32: the solo path's regime
        shape = TenantShape(w.idx, "gcounter", len(actor_idx), 0,
                            len(replicas))
        return shape, (actor_idx, counter, replicas, clock0)

    def _fold_orset_bucket(self, bi: int, bucket, by_idx) -> None:
        from ..core.core import CHECKPOINT_FMT_ORSET
        from ..parallel.accel import TorchAccelerator

        N_b = _bucket(bucket.rows)
        E_b = _bucket(bucket.members)
        R_b = _bucket(bucket.replicas)
        T = bucket.slots
        dev = self._bucket_device(bucket, by_idx)
        kind = np.zeros((T, N_b), np.int8)
        member = np.zeros((T, N_b), np.int32)
        actor = np.full((T, N_b), R_b, np.int32)  # dummy slots: all padding
        counter = np.zeros((T, N_b), np.int32)
        # the tenant layout: tenant t's (E, R) planes are columns
        # t·R_b .. t·R_b + R − 1 of (E_b, T·R_b) planes; cold tenants'
        # planes are built on the host and uploaded in one copy, warm
        # tenants' are copied into place on the device
        cold, warm = [], []
        # slots whose pre-fold planes ARE the tenant's delta base (a warm
        # entry stamped with the base's seal name): their delta is cut on
        # the device after the fold
        cut_slots: list[tuple[int, object]] = []
        for slot, key in enumerate(bucket.tenants):
            w = by_idx[key]
            k, m, a, c, members, replicas, entry = w.prepared
            n = len(k)
            kind[slot, :n] = k
            member[slot, :n] = m
            actor[slot, :n] = a
            counter[slot, :n] = c
            if entry is None:
                cold.append(slot)
                continue
            warm.append(slot)
            if (
                entry.seal_name is not None
                and entry.seal_name == w.core.delta_base_name
                and w.core._delta_enabled
                and getattr(w.core.storage, "has_deltas", False)
            ):
                cut_slots.append((slot, key))
        h2d = kind.nbytes + member.nbytes + actor.nbytes + counter.nbytes
        with trace.span("serve.planes", meta=bi):
            if cold:
                clock_h = np.zeros((T, R_b), np.int32)
                add_h = np.zeros((E_b, T, R_b), np.int32)
                rm_h = np.zeros((E_b, T, R_b), np.int32)
                for slot in cold:
                    w = by_idx[bucket.tenants[slot]]
                    _, _, _, _, members, replicas, _ = w.prepared
                    E, R = len(members), len(replicas)
                    c0, a0, r0 = K.orset_state_to_planes(
                        w.core._data.state, members, replicas, scanned=True
                    )
                    clock_h[slot, :R] = c0
                    add_h[:E, slot, :R] = a0
                    rm_h[:E, slot, :R] = r0
                h2d += clock_h.nbytes + add_h.nbytes + rm_h.nbytes
                clock0 = torch.from_numpy(clock_h.reshape(T * R_b)).to(dev)
                add0 = torch.from_numpy(add_h.reshape(E_b, T * R_b)).to(dev)
                rm0 = torch.from_numpy(rm_h.reshape(E_b, T * R_b)).to(dev)
            else:
                clock0 = torch.zeros(T * R_b, dtype=torch.int32, device=dev)
                add0 = torch.zeros((E_b, T * R_b), dtype=torch.int32,
                                   device=dev)
                rm0 = torch.zeros_like(add0)
            base_planes: dict[int, tuple] = {}
            for slot in warm:
                w = by_idx[bucket.tenants[slot]]
                entry = w.prepared[6]
                c0, a0, r0 = TorchAccelerator._cached_planes_padded(
                    entry, E_b, R_b
                )
                clock0.view(T, R_b)[slot] = c0
                orset_ops.tenant_planes(add0, T)[slot] = a0
                orset_ops.tenant_planes(rm0, T)[slot] = r0
                base_planes[slot] = (c0, a0, r0)
            rows = [
                torch.from_numpy(x).to(dev)
                for x in (kind, member, actor, counter)
            ]
        if dev.type == "cuda":
            trace.add("h2d_bytes", h2d)
            trace.add("h2d_pageable_bytes", h2d)
        if self._mesh_active:
            # tenant lanes over dp, member planes over mp: slot and member
            # classes already divide the mesh by the planner's law
            from ..parallel import mesh as pmesh

            with trace.span("serve.shard", meta=bi):
                c, a, r = pmesh.orset_fold_tenants_sharded(
                    self.mesh, clock0.view(T, R_b),
                    orset_ops.tenant_planes(add0, T),
                    orset_ops.tenant_planes(rm0, T), *rows,
                )
                out = (c.reshape(T * R_b), pmesh.tenant_layout(a),
                       pmesh.tenant_layout(r))
            trace.add("serve_sharded_folds", 1)
            trace.add("serve_sharded_tenants", len(bucket.tenants))
        else:
            with trace.span("serve.fold", meta=bi):
                out = orset_ops.orset_fold_tenant_layout(
                    clock0, add0, rm0, *rows, num_members=E_b,
                    num_replicas=R_b,
                )
        obs_runtime.sample_device_memory(dev)
        with trace.span("serve.scatter", meta=bi):
            clock_all = out[0].cpu().numpy().reshape(T, R_b)
            add_all = out[1].cpu().numpy().reshape(E_b, T, R_b)
            rm_all = out[2].cpu().numpy().reshape(E_b, T, R_b)
            for slot, key in enumerate(bucket.tenants):
                w = by_idx[key]
                _, _, _, _, members, replicas, entry = w.prepared
                E, R = len(members), len(replicas)
                state = w.core._data.state
                folded = K.orset_planes_to_state(
                    clock_all[slot, :R], add_all[:E, slot, :R],
                    rm_all[:E, slot, :R], members, replicas,
                )
                state.clock = folded.clock
                state.entries = folded.entries
                state.deferred = folded.deferred
                note = getattr(w.core.accel, "_note_orset_writeback", None)
                if note is not None:
                    note(state)
                else:
                    state._mut += 1
                w.core._advance_cursors(w.metas)
                # the warm-open checkpoint payload, packed from the planes
                # just written back (no walk of the state); its epoch lets
                # save_checkpoint refuse it after a concurrent apply
                w.packed = (
                    CHECKPOINT_FMT_ORSET,
                    K.orset_pack_checkpoint_planes(
                        clock_all[slot], add_all[:, slot], rm_all[:, slot],
                        members, replicas,
                    ),
                    state._mut,
                )
                # the snapshot's state object without a second walk: the
                # dicts just written back are plane-canonical, so wrapping
                # them is ORSet.to_obj's output; the epoch guard keeps the
                # alias safe and the canonical packer re-sorts
                w.state_obj = (
                    {
                        b"c": state.clock.to_obj(),
                        b"e": state.entries,
                        b"d": state.deferred,
                    },
                    state._mut,
                )
                n_rows = len(w.prepared[0])
                w.result.path = "batched"
                w.result.rows = n_rows
                trace.add("serve_rows_folded", n_rows)
                if self.warm is None:
                    continue
                # the tenant's next-cycle planes, epoch-stamped after the
                # writeback: its own slice, copied out of the bucket so
                # the bucket's planes can go
                planes = (
                    out[0].view(T, R_b)[slot].clone(),
                    orset_ops.tenant_planes(out[1], T)[slot].clone(),
                    orset_ops.tenant_planes(out[2], T)[slot].clone(),
                )
                self.warm.store(
                    state, members, replicas, planes,
                    canon=entry.canon if entry is not None else None,
                )
        if cut_slots:
            self._cut_deltas(bi, T, E_b, R_b, (clock0, add0, rm0), out,
                             clock_all, cut_slots, base_planes, by_idx)

    def _cut_deltas(self, bi, T, E_b, R_b, before, out, clock_all,
                    cut_slots, base_planes, by_idx) -> None:
        """The device-cut delta of every cut-eligible tenant of a bucket:
        diff the pre-fold planes (for those tenants, their sealed diff
        bases) against the post-fold planes in one pass over the tenant
        layout, gather those tenants' diff rows and copy them to the host
        once, then build each tenant's Orswot wire form from its rows.
        Under its own ``delta.cut`` span, outside ``serve.scatter``."""
        from ..delta.codec import orset_delta_from_rows

        with trace.span("delta.cut", meta=bi):
            clock_b, add_b, rm_b = before
            if self._mesh_active:
                from ..parallel import mesh as pmesh

                tp = orset_ops.tenant_planes
                code, _ = pmesh.tenant_plane_diff_sharded(
                    self.mesh, clock_b.view(T, R_b), tp(add_b, T),
                    tp(rm_b, T), out[0].view(T, R_b), tp(out[1], T),
                    tp(out[2], T),
                )
                code = pmesh.tenant_layout(code)
            else:
                code, _ = orset_ops.orset_plane_diff(clock_b, add_b, rm_b,
                                                     *out)
            # only the cut slots' rows are gathered and copied: a cold
            # tenant's diff covers its whole fold
            slots = torch.tensor([s for s, _ in cut_slots],
                                 dtype=torch.int64, device=code.device)
            if code.device.type == "cuda":
                trace.add("h2d_bytes", slots.nbytes)
                trace.add("h2d_pageable_bytes", slots.nbytes)
            rows = orset_ops.orset_plane_diff_rows_tenants(
                code, add_b, out[1], out[2], T, slots
            )
            t, idx, cd, ab, an, rn = (r.cpu().numpy() for r in rows)
            clock_base = clock_b.cpu().numpy().reshape(T, R_b)
            bounds = np.searchsorted(t, np.arange(T + 1))
            for slot, key in cut_slots:
                w = by_idx[key]
                _, _, _, _, members, replicas, entry = w.prepared
                lo, hi = bounds[slot], bounds[slot + 1]
                dobj = orset_delta_from_rows(
                    (idx[lo:hi], cd[lo:hi], ab[lo:hi], an[lo:hi],
                     rn[lo:hi]),
                    members=members.items,
                    replicas=replicas.items,
                    row_width=R_b,
                    base_clock=clock_base[slot],
                    new_clock=clock_all[slot],
                )
                # accepted by _plan_delta_seal only while the base name
                # and the mutation epoch still match at seal time
                w.delta_cut = {
                    "dobj": dobj,
                    "base_name": entry.seal_name,
                    "mut": w.core._data.state._mut,
                    "base_planes": (*base_planes[slot], members, replicas),
                }

    def _fold_gcounter_bucket(self, bi: int, bucket, by_idx) -> None:
        N_b = _bucket(bucket.rows)
        R_b = _bucket(bucket.replicas)
        T = bucket.slots
        dev = self._bucket_device(bucket, by_idx)
        actor = np.full((T, N_b), R_b, np.int32)
        counter = np.zeros((T, N_b), np.int32)
        clock0 = np.zeros((T, R_b), np.int32)
        for slot, key in enumerate(bucket.tenants):
            a, c, replicas, dense = by_idx[key].prepared
            n = len(a)
            actor[slot, :n] = a
            counter[slot, :n] = c
            clock0[slot, : len(dense)] = dense
        if dev.type == "cuda":
            n = clock0.nbytes + actor.nbytes + counter.nbytes
            trace.add("h2d_bytes", n)
            trace.add("h2d_pageable_bytes", n)
        dev_rows = [torch.from_numpy(x).to(dev)
                    for x in (clock0, actor, counter)]
        if self._mesh_active:
            from ..parallel import mesh as pmesh

            with trace.span("serve.shard", meta=bi):
                out = pmesh.gcounter_fold_tenants_sharded(self.mesh,
                                                          *dev_rows)
            trace.add("serve_sharded_folds", 1)
            trace.add("serve_sharded_tenants", len(bucket.tenants))
        else:
            with trace.span("serve.fold", meta=bi):
                out = gcounter_fold_tenants(*dev_rows, num_replicas=R_b)
        with trace.span("serve.scatter", meta=bi):
            out_all = out.cpu().numpy()
            for slot, key in enumerate(bucket.tenants):
                w = by_idx[key]
                a, _, replicas, _ = w.prepared
                state = w.core._data.state
                state.clock = K.dense_to_vclock(
                    out_all[slot][: len(replicas)], replicas
                )
                w.core._advance_cursors(w.metas)
                w.result.path = "batched"
                w.result.rows = len(a)
                trace.add("serve_rows_folded", len(a))

    def _bucket_device(self, bucket, by_idx) -> torch.device:
        """The device a bucket folds on: the mesh's home under a mesh,
        else its tenants' shared device."""
        if self._mesh_active:
            return self.mesh.home
        return _tenant_device(by_idx[bucket.tenants[0]])

    @staticmethod
    def _fallback_rows(w: _TenantWork) -> int:
        """Op-row count of a fallback tenant, in the batched path's units:
        the decoded columns where there are some, else a payload unpack."""
        if w.cols is not None:
            return len(w.cols[0])
        return sum(len(codec.unpack(p)) for p in w.payloads)

    # -------------------------------------------------------- fallbacks
    async def _fold_fallbacks(self, works) -> None:
        """Tenants outside the bucket folds: solo spills take the
        single-tenant bulk path on the already-decrypted payloads, the
        rest fold per op — the machinery a solo compact would use."""
        for w in works:
            if not w.ok or not w.payloads:
                continue
            core = w.core
            # under a mesh a columnar spill folds through the
            # service-owned mesh accelerator's sharded fold (one large
            # tenant uses every shard); its writeback bumps the epoch, so
            # planes the tenant's own accelerator cached expire
            spill_accel = (
                self._mesh_accel
                if self._mesh_accel is not None
                and w.kind in ("orset", "gcounter")
                else core.accel
            )
            try:
                if w.result.path == "solo":
                    ok = spill_accel.fold_payloads(
                        core._data.state, list(w.payloads),
                        actors_hint=w.actors_sorted,
                    )
                    if ok:
                        core._advance_cursors(w.metas)
                    else:
                        # the spill's bulk path declined too: report the
                        # machinery that folded it
                        await core._fold_chunk_python(w.files, w.clears)
                        w.result.path = "perop"
                        trace.add("serve_python_fallbacks", 1)
                    w.result.rows = self._fallback_rows(w)
                elif w.kind is None or w.result.path == "perop":
                    ok = core.accel.fold_payloads(
                        core._data.state, list(w.payloads),
                        actors_hint=w.actors_sorted,
                    ) if w.kind is None else False
                    if ok:
                        core._advance_cursors(w.metas)
                        w.result.path = "solo"
                    else:
                        await core._fold_chunk_python(w.files, w.clears)
                        w.result.path = "perop"
                        trace.add("serve_python_fallbacks", 1)
                    w.result.rows = self._fallback_rows(w)
            except Exception as e:
                w.result.error = repr(e)
                w.result.path = "error"

    def _stamp_continuations(self, works) -> None:
        """After the seals: for every tenant that sealed and whose warm
        planes still match its live state, stamp the entry with the
        sealed snapshot's name (the tenant's new delta base), so the next
        cycle cuts its delta from those planes.  Any doubt leaves the
        entry unstamped and the next seal walks the host path."""
        if self.warm is None:
            return
        with trace.span("serve.continue"):
            stamped = 0
            for w in works:
                if not (w.ok and w.result.sealed):
                    continue
                name = w.core.delta_base_name
                if name is None:
                    continue
                if self.warm.stamp_seal(w.core._data.state, name):
                    stamped += 1
            if stamped:
                trace.add("serve_continuations", stamped)

    # -------------------------------------------------------------- seal
    async def _seal_all(self, works, t0: float) -> None:
        sem = asyncio.Semaphore(max(1, self.config.io_width))

        async def one(w: _TenantWork):
            async with sem:
                if not w.ok:
                    trace.add("serve_tenant_errors", 1)
                    w.result.latency_s = time.perf_counter() - t0
                    return
                if (
                    w.result.path == "empty"
                    and self.config.noop_skip
                    and w.core._last_seal_sig is not None
                    and w.core._seal_signature() == w.core._last_seal_sig
                ):
                    # a quiet tenant, unmoved since its last seal (cursor,
                    # read sets, mutation epoch): a re-seal would publish
                    # the identical snapshot, so the seal, GC, checkpoint
                    # and sample are all skipped; a tenant never sealed
                    # seals even with no new ops, as a solo compact does
                    trace.add("serve_noop_cycles", 1)
                    w.result.latency_s = time.perf_counter() - t0
                    return
                if w.result.path == "empty" and not self.config.seal_empty:
                    w.result.latency_s = time.perf_counter() - t0
                    return
                try:
                    with trace.span("serve.seal", meta=w.idx):
                        # _backlog=[]: the ingest folded everything its
                        # listing found, so no per-tenant stat_ops probe
                        await w.core._compact_seal(
                            _backlog=[], _packed_state=w.packed,
                            _state_obj=w.state_obj,
                            _delta_cut=w.delta_cut,
                        )
                    w.result.sealed = True
                except Exception as e:
                    w.result.error = repr(e)
                    w.result.path = "error"
                    trace.add("serve_tenant_errors", 1)
                dt = time.perf_counter() - t0
                w.result.latency_s = dt
                if w.result.sealed:
                    # the histogram counts seal completions; a failed
                    # seal's latency stays on its TenantResult
                    trace.observe("serve.tenant", dt)

        await asyncio.gather(*(one(w) for w in works))
