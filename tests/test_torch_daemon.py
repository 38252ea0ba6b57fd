"""The port's fleet daemon on the CPU, held cycle for cycle against the JAX
daemon.

Every scenario runs in lockstep on two byte-identical fleets: the tenant
remotes are written once (through port writers into ``base`` remotes),
then copied into each package's own ``MemoryRemote`` together with each
tenant's local meta, so both packages' tenant cores open the same actor
over the same bytes (``IdentityCryptor``: no nonce makes a sealed file
differ).  After every cycle the two daemons must agree exactly
(tolerance 0): the cycle report (without the clock-derived
``latency_s``), every tenant entry (state, failures, backoff eligibility,
last seal, quarantine cycle, last error), ``health()`` without
``uptime_s``, and, where a scenario says so, each tenant's canonical
bytes and the ``daemon_*`` counters.

The cases are those of tests/test_daemon.py that need neither a mesh nor
the simulator, the daemon cases of tests/test_strong_reads.py (the clock
seam included), and a schedule with seeded jitter whose backoff delays
must equal the JAX daemon's.  The port's tenants use
``TorchAccelerator(device="cpu", min_device_batch=1)``, the JAX ones
``TpuAccelerator(min_device_batch=1)`` on the CPU backend.
"""

from __future__ import annotations

import asyncio
import copy
import json
import types
import urllib.request

import pytest

from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import StaleWriterError as JStaleWriterError
from crdt_enc_tpu.core import orset_adapter as j_orset_adapter
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.models.vclock import VClock as JVClock
from crdt_enc_tpu.parallel import TpuAccelerator
from crdt_enc_tpu.read import StalenessError as JStalenessError
from crdt_enc_tpu.serve import AdmissionError as JAdmissionError
from crdt_enc_tpu.serve import DaemonConfig as JDaemonConfig
from crdt_enc_tpu.serve import FleetDaemon as JFleetDaemon
from crdt_enc_tpu.serve import FoldService as JFoldService
from crdt_enc_tpu.serve import ServeConfig as JServeConfig
from crdt_enc_tpu.serve.daemon import TenantEntry as JTenantEntry
from crdt_enc_tpu.utils import trace as jtrace
from crdt_enc_tpu_torch import (
    Core,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.backends import IdentityCryptor
from crdt_enc_tpu_torch.core.core import StaleWriterError
from crdt_enc_tpu_torch.models.vclock import VClock
from crdt_enc_tpu_torch.read import StalenessError
from crdt_enc_tpu_torch.serve import (
    AdmissionError,
    DaemonConfig,
    FleetDaemon,
    FoldService,
    ServeConfig,
)
from crdt_enc_tpu_torch.serve import daemon as daemon_mod
from crdt_enc_tpu_torch.serve.daemon import (
    ACTIVE,
    BACKOFF,
    QUARANTINED,
    TenantEntry,
)
from crdt_enc_tpu_torch.utils import trace
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1


def run(coro):
    return asyncio.run(coro)


def make_opts(storage, create=True, **kw):
    kw.setdefault("accelerator", TorchAccelerator(device="cpu",
                                                  min_device_batch=1))
    return OpenOptions(
        storage=storage, cryptor=IdentityCryptor(),
        key_cryptor=PlainKeyCryptor(), adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create, **kw,
    )


def jmake_opts(storage, create=True, **kw):
    kw.setdefault("accelerator", TpuAccelerator(min_device_batch=1))
    return JOpenOptions(
        storage=storage, cryptor=JIdentityCryptor(),
        key_cryptor=JPlainKeyCryptor(), adapter=j_orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create, **kw,
    )


def flaky(storage_cls):
    """A storage that refuses listings while ``broken`` — the transient
    storage outage the backoff machine exists for."""

    class FlakyStorage(storage_cls):
        broken = False

        async def list_op_actors(self):
            if self.broken:
                raise OSError("injected outage")
            return await super().list_op_actors()

    return FlakyStorage


PORT = types.SimpleNamespace(
    name="port", Core=Core, Remote=MemoryRemote, Storage=MemoryStorage,
    Flaky=flaky(MemoryStorage), opts=make_opts, Daemon=FleetDaemon,
    DaemonConfig=DaemonConfig, ServeConfig=ServeConfig, Service=FoldService,
    VClock=VClock, StalenessError=StalenessError, StaleWriterError=StaleWriterError,
    AdmissionError=AdmissionError, TenantEntry=TenantEntry, trace=trace,
    canonical=canonical_bytes,
)
JAX = types.SimpleNamespace(
    name="jax", Core=JCore, Remote=JMemoryRemote, Storage=JMemoryStorage,
    Flaky=flaky(JMemoryStorage), opts=jmake_opts, Daemon=JFleetDaemon,
    DaemonConfig=JDaemonConfig, ServeConfig=JServeConfig,
    Service=JFoldService, VClock=JVClock, StalenessError=JStalenessError, StaleWriterError=JStaleWriterError,
    AdmissionError=JAdmissionError, TenantEntry=JTenantEntry, trace=jtrace,
    canonical=j_canonical_bytes,
)
SIDES = (PORT, JAX)


class Twins:
    """Tenant remotes written once and copied byte for byte into both
    packages.  ``remote`` makes a base remote whose writer (the key's
    creator) writes ``n_ops`` adds; ``identity`` opens a throwaway replica
    on a base remote and keeps its local meta, so a copy of it opens the
    same actor in either package; ``freeze`` copies every base remote
    into each side; ``write`` adds through a base writer and copies the
    new op file into both sides."""

    def __init__(self):
        self.bases: list = []
        self.writers: list = []
        self.seen: list = []
        self.copies = {"port": [], "jax": []}

    async def remote(self, n_ops: int = 0, tag: bytes = b"x") -> int:
        base = MemoryRemote()
        w = await Core.open(make_opts(MemoryStorage(base)))
        for i in range(n_ops):
            m = b"%s-%d" % (tag, i % 13)
            await w.update(lambda s, m=m: s.add_ctx(w.actor_id, m))
        self.bases.append(base)
        self.writers.append(w)
        return len(self.bases) - 1

    async def identity(self, r: int) -> tuple:
        st = MemoryStorage(self.bases[r])
        await Core.open(make_opts(st))
        return st._local_meta, st._local_checkpoint

    @staticmethod
    def _ops(base) -> set:
        return {(a, v) for a, d in base.ops.items() for v in d}

    def freeze(self) -> None:
        for base in self.bases:
            for side in SIDES:
                self.copies[side.name].append(side.Remote(
                    metas=dict(base.metas), states=dict(base.states),
                    ops={a: dict(d) for a, d in base.ops.items()},
                    deltas={a: dict(d) for a, d in base.deltas.items()}))
            self.seen.append(self._ops(base))

    def storage(self, side, r: int, ident: tuple, flaky: bool = False):
        st = (side.Flaky if flaky else side.Storage)(
            self.copies[side.name][r])
        st._local_meta, st._local_checkpoint = ident
        return st

    async def write(self, r: int, member: bytes) -> None:
        w = self.writers[r]
        await w.update(lambda s: s.add_ctx(w.actor_id, member))
        base = self.bases[r]
        for a, v in sorted(self._ops(base) - self.seen[r]):
            for side in SIDES:
                self.copies[side.name][r].ops.setdefault(a, {})[v] = \
                    base.ops[a][v]
        self.seen[r] = self._ops(base)


async def twin_fleet(spec, flaky_tenants=()):
    """One tenant per ``(n_ops, tag)`` of ``spec``, its own remote and
    identity; returns the twins and ``{side name: [(core, storage)]}``."""
    tw = Twins()
    idents = []
    for n_ops, tag in spec:
        r = await tw.remote(n_ops, tag)
        idents.append(await tw.identity(r))
    tw.freeze()
    out = {}
    for side in SIDES:
        rows = []
        for t, ident in enumerate(idents):
            st = tw.storage(side, t, ident, flaky=t in flaky_tenants)
            rows.append((await side.Core.open(side.opts(st, create=False)),
                         st))
        out[side.name] = rows
    return tw, out


def quick_cfg(side, **kw):
    kw.setdefault("max_idle_cycles", 1)
    kw.setdefault("backoff_base", 1.0)
    kw.setdefault("backoff_cap", 2.0)
    kw.setdefault("backoff_jitter", 0.0)
    kw.setdefault("serve", side.ServeConfig(seal_empty=False))
    return side.DaemonConfig(**kw)


def scrub_report(report: dict) -> dict:
    out = copy.deepcopy(report)
    for r in out.get("results", {}).values():
        r.pop("latency_s", None)
    return out


def entries(d) -> list:
    return [(tid, e.state, e.failures, e.eligible_at, e.last_sealed,
             e.quarantined_at, e.last_error)
            for tid in d.tenant_ids for e in [d.entry(tid)]]


def health(d) -> dict:
    h = d.health()
    h.pop("uptime_s")
    return h


def daemon_counters(tr) -> dict:
    snap = tr.snapshot()
    return ({k: v for k, v in snap["counters"].items()
             if k.startswith("daemon_")},
            {k: v for k, v in snap["gauges"].items()
             if k.startswith("daemon_")})


class Pair:
    """The port's daemon and the JAX daemon over twin fleets, driven in
    lockstep; every :meth:`cycle` holds them equal."""

    def __init__(self, fleet: dict, cfg, **kw):
        self.d = {side.name: side.Daemon(
            [c for c, _ in fleet[side.name]], cfg(side), **kw)
            for side in SIDES}
        self.fleet = fleet

    @property
    def port(self):
        return self.d["port"]

    @property
    def jax(self):
        return self.d["jax"]

    def check(self) -> None:
        assert entries(self.port) == entries(self.jax)
        assert health(self.port) == health(self.jax)

    async def cycle(self) -> dict:
        p = await self.port.run_cycle()
        j = await self.jax.run_cycle()
        # let waiters the cycles resolved leave on both sides alike
        for _ in range(2):
            await asyncio.sleep(0)
        assert scrub_report(p) == scrub_report(j)
        self.check()
        return p

    def set_broken(self, t: int, broken: bool) -> None:
        for side in SIDES:
            self.fleet[side.name][t][1].broken = broken

    def bytes_equal(self) -> None:
        for side_p, side_j in zip(self.fleet["port"], self.fleet["jax"]):
            assert side_p[0].with_state(canonical_bytes) == \
                side_j[0].with_state(j_canonical_bytes)

    def reset_traces(self) -> None:
        trace.reset()
        jtrace.reset()

    def counters_equal(self) -> None:
        assert daemon_counters(trace) == daemon_counters(jtrace)

    async def drain(self) -> None:
        got = [await self.d[s.name].drain() for s in SIDES]
        assert got[0] == got[1]
        self.check()


# ---------------------------------------------------------- scheduling


def test_scheduler_compacts_backlog_polls_quiet():
    """Staleness-driven cadence: a tenant with sealed-but-unfolded ops
    is selected and sealed; an in-sync tenant is only stat-polled until
    its idle cadence comes due; a laggard jumps the queue."""

    async def scenario():
        tw, fleet = await twin_fleet([(20, b"busy"), (0, b"quiet")])
        for side in SIDES:
            await fleet[side.name][1][0].compact()  # in sync
        pair = Pair(fleet, lambda s: quick_cfg(s, max_idle_cycles=100))
        report = await pair.cycle()
        assert "t0" in report["selected"]
        assert report["results"]["t0"]["outcome"] == "sealed"
        report2 = await pair.cycle()
        assert report2["selected"] == []
        assert report2["results"]["t0"]["outcome"] == "polled"
        assert report2["results"]["t1"]["outcome"] == "polled"
        await tw.write(0, b"late")
        await pair.cycle()  # the poll refreshes the staleness inputs
        report3 = await pair.cycle()
        assert report3["selected"] == ["t0"]
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


# ------------------------------------------- backoff/quarantine machine


def test_backoff_quarantine_and_recovery():
    async def scenario():
        _, fleet = await twin_fleet([(15, b"bad"), (15, b"ok")],
                                    flaky_tenants={0})
        pair = Pair(fleet, lambda s: quick_cfg(
            s, quarantine_after=2, quarantine_probe_every=2,
            backoff_base=2.0, backoff_cap=4.0))
        pair.set_broken(0, True)
        pair.reset_traces()
        await pair.cycle()  # failure 1 → backoff
        t0 = pair.port.entry("t0")
        assert t0.state == BACKOFF and t0.failures == 1
        assert t0.eligible_at > pair.port.cycle
        await pair.cycle()  # still backing off: not attempted
        assert t0.state == BACKOFF
        await pair.cycle()  # re-probe → failure 2 → quarantine
        assert t0.state == QUARANTINED
        snap = trace.snapshot()
        assert snap["counters"]["daemon_backoffs"] >= 1
        assert snap["counters"]["daemon_quarantines"] == 1
        assert snap["gauges"]["daemon_quarantined"] == 1
        pair.counters_equal()
        assert pair.port.entry("t1").state == ACTIVE
        assert pair.port.entry("t1").last_sealed >= 1
        pair.set_broken(0, False)
        for _ in range(6):
            await pair.cycle()
            if pair.port.entry("t0").state == ACTIVE:
                break
        assert pair.port.entry("t0").state == ACTIVE
        assert trace.snapshot()["gauges"]["daemon_quarantined"] == 0
        pair.counters_equal()
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


def test_quarantine_probe_runs_even_when_not_due():
    async def scenario():
        _, fleet = await twin_fleet([(12, b"q")], flaky_tenants={0})
        pair = Pair(fleet, lambda s: quick_cfg(
            s, max_idle_cycles=1000, quarantine_after=2,
            quarantine_probe_every=2, backoff_cap=1.0))
        await pair.cycle()  # seals; status now healthy
        assert pair.port.entry("t0").last_sealed == 1
        pair.set_broken(0, True)
        while pair.port.entry("t0").state != QUARANTINED:
            await pair.cycle()
            assert pair.port.cycle < 10
        pair.set_broken(0, False)
        pair.reset_traces()
        while pair.port.entry("t0").state != ACTIVE:
            await pair.cycle()
            assert pair.port.cycle < 16, "quarantine probe never ran"
        assert trace.snapshot()["counters"]["daemon_probes"] >= 1
        pair.counters_equal()
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


def test_circuit_breaker_degraded_and_half_open_recovery():
    async def scenario():
        _, fleet = await twin_fleet([(12, b"x"), (12, b"y")],
                                    flaky_tenants={0, 1})
        pair = Pair(fleet, lambda s: quick_cfg(
            s, quarantine_after=2, breaker_after=2, breaker_probe_every=2,
            backoff_cap=1.0))
        pair.set_broken(0, True)
        pair.set_broken(1, True)
        pair.reset_traces()
        while not pair.port.degraded:
            await pair.cycle()
            assert pair.port.cycle < 20, "breaker never tripped"
        assert trace.snapshot()["counters"]["daemon_breaker_trips"] == 1
        assert pair.port.health()["degraded"] is True
        while any(pair.port.entry(t).state != QUARANTINED
                  for t in pair.port.tenant_ids):
            await pair.cycle()
            assert pair.port.cycle < 30, "fleet never fully parked"
        pair.set_broken(0, False)
        pair.set_broken(1, False)
        while pair.port.degraded:
            report = await pair.cycle()
            assert pair.port.cycle < 30, "breaker never closed"
        assert any(r["outcome"] == "sealed"
                   for r in report["results"].values())
        assert pair.port.health()["degraded"] is False
        pair.counters_equal()
        await pair.drain()

    run(scenario())


def test_jittered_backoff_schedule_equals_the_jax_daemon():
    """The default jitter (``backoff_jitter`` 0.25) over a seeded daemon:
    six tenants, two of them down for nine cycles, at most two compacted a
    cycle.  Every backoff delay the port draws equals the JAX daemon's
    (the same ``random.Random`` seed string), so every schedule, the
    quarantines and the recovery match cycle for cycle."""

    async def scenario():
        spec = [(9 + 3 * t, b"j%d" % t) for t in range(6)]
        _, fleet = await twin_fleet(spec, flaky_tenants={1, 4})
        pair = Pair(fleet, lambda s: s.DaemonConfig(
            batch=2, max_idle_cycles=3, backoff_cap=8.0,
            quarantine_after=3, quarantine_probe_every=2,
            serve=s.ServeConfig(seal_empty=False)), seed=5)
        pair.set_broken(1, True)
        pair.set_broken(4, True)
        delays = set()
        for cycle in range(1, 25):
            if cycle == 10:
                pair.set_broken(1, False)
                pair.set_broken(4, False)
            await pair.cycle()
            for t in ("t1", "t4"):
                e = pair.port.entry(t)
                if e.state == BACKOFF:
                    delays.add((e.failures, e.eligible_at - cycle))
        assert len({d for f, d in delays if f == 2}) >= 1
        assert any(d != 2 ** (f - 1) for f, d in delays), (
            "no jittered delay was drawn")
        assert all(pair.port.entry(t).state == ACTIVE
                   for t in pair.port.tenant_ids)
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


# --------------------------------------------------- admission/eviction


def max_tenants(side, daemon, n: int, monkeypatch) -> None:
    """The fleet cap: a constant of the port's daemon module, a config
    field of the JAX daemon."""
    if side is PORT:
        monkeypatch.setattr(daemon_mod, "MAX_TENANTS", n)
    else:
        daemon.config.max_tenants = n


def test_admission_budget_and_eviction_checkpoint(monkeypatch):
    async def scenario():
        _, fleet = await twin_fleet([(25, b"adm"), (0, b"extra")])
        outcomes = {}
        for side in SIDES:
            (core, storage), (extra, _) = fleet[side.name]
            daemon = side.Daemon([core], quick_cfg(side))
            max_tenants(side, daemon, 1, monkeypatch)
            with pytest.raises(side.AdmissionError):
                await daemon.admit(extra)
            max_tenants(side, daemon, 100, monkeypatch)
            # the byte budget is the serve warm tier's (the JAX daemon's
            # admission_bytes left at 0)
            warm_bytes = daemon.config.serve.warm_bytes
            daemon.config.serve.warm_bytes = 1024
            daemon.config.tenant_cost_bytes = 4096
            with pytest.raises(side.AdmissionError) as ei:
                await daemon.admit(extra)
            budget_msg = str(ei.value)
            daemon.config.serve.warm_bytes = warm_bytes
            tid = await daemon.admit(extra)
            assert daemon.entry(tid) is not None
            with pytest.raises(side.AdmissionError):
                await daemon.admit(extra, tid=tid)
            report = await daemon.run_cycle()
            got = await daemon.evict("t0")
            assert got is core
            assert daemon.entry("t0") is None
            reopened = await side.Core.open(side.opts(storage, create=False))
            assert reopened.opened_from_checkpoint, (
                reopened.checkpoint_fallback_reason)
            assert reopened.with_state(side.canonical) == core.with_state(
                side.canonical)
            with pytest.raises(KeyError):
                await daemon.evict("t0")
            await daemon.discard("t0")
            await daemon.drain()
            outcomes[side.name] = (tid, budget_msg, scrub_report(report),
                                   entries(daemon), health(daemon),
                                   reopened.with_state(side.canonical))
        assert outcomes["port"] == outcomes["jax"]

    run(scenario())


def test_drain_is_terminal_and_idempotent():
    async def scenario():
        _, fleet = await twin_fleet([(10, b"dr")])
        pair = Pair(fleet, quick_cfg)
        await pair.cycle()
        for side in SIDES:
            daemon = pair.d[side.name]
            core, storage = fleet[side.name][0]
            assert (await daemon.drain()) == {}
            assert daemon.state == "drained"
            assert daemon.service.closed
            with pytest.raises(RuntimeError):
                await daemon.run_cycle()
            with pytest.raises(side.AdmissionError):
                await daemon.admit(core, tid="again")
            assert (await daemon.drain()) == {}
            reopened = await side.Core.open(side.opts(storage, create=False))
            assert reopened.opened_from_checkpoint
        pair.check()
        pair.bytes_equal()

    run(scenario())


# ------------------------------------------------------------- healthz


def test_healthz_daemon_section():
    async def scenario():
        _, fleet = await twin_fleet([(10, b"hz")])
        pair = Pair(fleet, quick_cfg, live_port=0)
        sections = {}
        try:
            await pair.cycle()
            for side in SIDES:
                port = pair.d[side.name].service.live.port
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as resp:
                    d = json.loads(resp.read())["daemon"]
                assert d["state"] == "running"
                assert d["cycles"] == 1 and d["tenants"] == 1
                assert d["quarantined"] == 0 and d["degraded"] is False
                assert d["uptime_s"] >= 0
                assert d["last_cycle"]["selected"] == 1
                d.pop("uptime_s")
                sections[side.name] = d
        finally:
            await pair.drain()
        assert sections["port"] == sections["jax"]
        assert pair.port.health()["state"] == "drained"

    run(scenario())


# ------------------------------------------ the writer's own-history guard


def test_gc_orphan_dot_reuse_guard():
    """An op file a crashed incarnation stored but never recorded is
    folded AND GC'd by a peer before the author's first write after
    reopening: the next write must mint a fresh dot.  Both packages end
    in the same bytes."""

    async def scenario(side, tw, r, w_ident, peer_ident):
        storage = tw.storage(side, r, w_ident)
        w = await side.Core.open(side.opts(storage, create=False))
        for i in range(3):
            await w.update(lambda s, i=i: s.add_ctx(w.actor_id, b"m%d" % i))
        await w.compact()
        blob = await w._seal([[0, b"orphan", [w.actor_id, 4]]])
        await w.storage.store_ops(w.actor_id, 4, blob)
        actor = w.actor_id
        peer = await side.Core.open(side.opts(
            tw.storage(side, r, peer_ident), create=False))
        await peer.compact()
        assert await peer.storage.list_op_actors() == []
        del w
        w2 = await side.Core.open(side.opts(storage, create=False))
        assert w2.opened_from_checkpoint
        await w2.update(lambda s: s.add_ctx(actor, b"fresh"))
        state = w2._data.state
        assert state.clock.counters[actor] == 5
        assert state.entries[b"orphan"] == {actor: 4}
        assert state.entries[b"fresh"] == {actor: 5}
        cold = await side.Core.open(side.opts(
            side.Storage(tw.copies[side.name][r])))
        await cold.read_remote()
        await w2.compact()
        await cold.read_remote()
        assert cold.with_state(side.canonical) == w2.with_state(
            side.canonical)
        return w2.with_state(side.canonical)

    async def both():
        tw = Twins()
        r = await tw.remote()
        w_ident, peer_ident = await tw.identity(r), await tw.identity(r)
        tw.freeze()
        return [await scenario(side, tw, r, w_ident, peer_ident)
                for side in SIDES]

    port, jax = run(both())
    assert port == jax


def test_vanished_history_refuses_write():
    """A replica with durable history facing a view where its merged
    snapshots vanished refuses the write loudly (StaleWriterError), and
    writes normally once the view is repaired — in both packages, to the
    same bytes."""

    def censored(storage_cls):
        class CensoredStorage(storage_cls):
            censor = False

            async def list_state_names(self):
                names = await super().list_state_names()
                return [] if self.censor else names

        return CensoredStorage

    async def scenario(side, tw, r, w_ident, peer_ident):
        storage = censored(side.Storage)(tw.copies[side.name][r])
        storage._local_meta, storage._local_checkpoint = w_ident
        w = await side.Core.open(side.opts(storage, create=False))
        await w.update(lambda s: s.add_ctx(w.actor_id, b"a"))
        await w.compact()
        peer = await side.Core.open(side.opts(
            tw.storage(side, r, peer_ident), create=False))
        await peer.update(lambda s: s.add_ctx(peer.actor_id, b"b"))
        await peer.compact()
        del w
        w2 = await side.Core.open(side.opts(storage, create=False))
        storage.censor = True
        with pytest.raises(side.StaleWriterError):
            await w2.update(lambda s: s.add_ctx(w2.actor_id, b"c"))
        storage.censor = False
        await w2.update(lambda s: s.add_ctx(w2.actor_id, b"c"))
        assert b"c" in w2._data.state.entries
        return w2.with_state(side.canonical)

    async def both():
        tw = Twins()
        r = await tw.remote()
        w_ident, peer_ident = await tw.identity(r), await tw.identity(r)
        tw.freeze()
        return [await scenario(side, tw, r, w_ident, peer_ident)
                for side in SIDES]

    port, jax = run(both())
    assert port == jax


# ---- the daemon cases of tests/test_strong_reads.py ----------------------


def strong_cfg(side, **kw):
    return side.DaemonConfig(serve=side.ServeConfig(seal_empty=True), **kw)


async def strong_fleet(n_tenants: int, with_writer: bool = False):
    """``n_tenants`` tenants on fresh remotes (no ops); with ``with_writer``
    tenant 0's base writer is kept for later writes."""
    tw = Twins()
    idents = []
    for _ in range(n_tenants):
        r = await tw.remote()
        idents.append(await tw.identity(r))
    tw.freeze()
    fleet = {}
    for side in SIDES:
        fleet[side.name] = [
            (await side.Core.open(side.opts(tw.storage(side, t, ident),
                                            create=False)), None)
            for t, ident in enumerate(idents)]
    return tw, fleet


def test_daemon_waiter_jumps_the_queue_and_resolves(monkeypatch):
    # nothing is due without a waiter: the port's backlog threshold is a
    # module constant, the JAX daemon's a config field
    monkeypatch.setattr(daemon_mod, "MIN_BACKLOG_FILES", 99)

    async def scenario():
        tw, fleet = await strong_fleet(1)
        await tw.write(0, b"w")
        pair = Pair(fleet, lambda s: strong_cfg(
            s, max_idle_cycles=99,
            **({"min_backlog_files": 99} if s is JAX else {})))
        await pair.cycle()
        r = await pair.cycle()
        assert r["selected"] == []  # nothing due without a waiter
        actor = tw.writers[0].actor_id
        targets = {s.name: s.VClock({actor: 1}) for s in SIDES}

        async def run_cycles():
            for _ in range(3):
                await pair.cycle()
                await asyncio.sleep(0)

        pview, jview, _ = await asyncio.gather(
            pair.port.await_stable("t0", targets["port"], timeout_s=10),
            pair.jax.await_stable("t0", targets["jax"], timeout_s=10),
            run_cycles())
        assert pview.covers(targets["port"])
        assert pview.cursor.to_obj() == jview.cursor.to_obj()
        assert (pview.lag, pview.watermark_lag) == (jview.lag,
                                                    jview.watermark_lag)
        assert pair.port.health()["waiters"] == 0
        for side in SIDES:
            with pytest.raises(KeyError):
                await pair.d[side.name].await_stable("nope",
                                                     targets[side.name])
        pair.bytes_equal()
        await pair.drain()

    run(scenario())


def test_daemon_evict_and_discard_fail_pending_waiters():
    async def scenario():
        _, fleet = await strong_fleet(2)
        pair = Pair(fleet, strong_cfg)
        messages = {}
        for side in SIDES:
            d = pair.d[side.name]
            target = side.VClock({b"\x01" * 16: 1})
            w0 = asyncio.create_task(d.await_stable("t0", target,
                                                    timeout_s=60))
            w1 = asyncio.create_task(d.await_stable("t1", target,
                                                    timeout_s=60))
            await asyncio.sleep(0)
            await d.evict("t0")
            with pytest.raises(side.StalenessError) as e0:
                await w0
            assert "evicted" in str(e0.value)
            await d.discard("t1")
            with pytest.raises(side.StalenessError) as e1:
                await w1
            assert "discarded" in str(e1.value)
            assert d.health()["waiters"] == 0
            messages[side.name] = (e0.value.reason, str(e0.value),
                                   e1.value.reason, str(e1.value))
        assert messages["port"] == messages["jax"]
        pair.check()
        await pair.drain()

    run(scenario())


def test_daemon_waiter_tier_beats_arbitrarily_large_laggards():
    async def scenario():
        _, fleet = await strong_fleet(2)
        pair = Pair(fleet, lambda s: strong_cfg(s, batch=1))
        scores = {}
        for side in SIDES:
            d = pair.d[side.name]
            d.entry("t1").core.last_replication_status = None
            fut = asyncio.get_running_loop().create_future()
            d._waiters["t0"] = [(side.VClock(), fut)]
            target = d._slo_target()
            s0, s1 = d._score(d.entry("t0"), target), d._score(
                d.entry("t1"), target)
            assert s0 > s1
            scores[side.name] = (target, s0, s1)
        assert scores["port"] == scores["jax"]
        report = await pair.cycle()
        assert report["selected"][0] == "t0"
        await pair.drain()

    run(scenario())


def test_daemon_drain_fails_pending_waiters_loudly():
    async def scenario():
        _, fleet = await strong_fleet(1)
        pair = Pair(fleet, strong_cfg)
        tasks = {s.name: asyncio.create_task(pair.d[s.name].await_stable(
            "t0", s.VClock({b"\x01" * 16: 1}), timeout_s=60)) for s in SIDES}
        await asyncio.sleep(0)
        await pair.drain()
        reasons = {}
        for side in SIDES:
            with pytest.raises(side.StalenessError) as ei:
                await tasks[side.name]
            assert ei.value.reason == "timeout"
            reasons[side.name] = (ei.value.reason, str(ei.value))
        assert reasons["port"] == reasons["jax"]

    run(scenario())


def test_daemon_interval_is_the_configured_interval():
    """``next_interval`` paces run_forever by ``interval_s`` and publishes
    it as the ``daemon_interval_s`` gauge, as the JAX daemon does with its
    wall-clock-aware pacing off (the default; the port has no auto
    interval)."""

    async def scenario():
        got = {}
        for side in SIDES:
            side.trace.reset()
            d = side.Daemon([], strong_cfg(side, interval_s=0.25))
            seen = [d.next_interval(), d.next_interval()]
            got[side.name] = (seen, daemon_counters(side.trace)[1])
            await d.drain()
        assert got["port"] == got["jax"]
        assert got["port"][0] == [0.25, 0.25]
        assert got["port"][1]["daemon_interval_s"] == 0.25

    run(scenario())


def test_daemon_health_uses_clock_seam():
    async def scenario():
        got = {}
        for side in SIDES:
            t = [100.0]
            d = side.Daemon([], strong_cfg(side), clock=lambda t=t: t[0])
            t[0] = 107.5
            assert d.health()["uptime_s"] == pytest.approx(7.5)
            got[side.name] = d.health()
            await d.drain()
        assert got["port"] == got["jax"]

    run(scenario())


# ---- the service settings the daemon brings back --------------------------


@pytest.mark.parametrize("seal_empty", [True, False])
def test_seal_empty_governs_the_first_seal_of_a_quiet_tenant(seal_empty):
    """A tenant never sealed and with no new ops seals once under
    ``seal_empty`` (a solo compact's behaviour) and costs nothing without
    it, in both packages alike."""

    async def scenario():
        _, fleet = await twin_fleet([(0, b"quiet"), (6, b"busy")])
        got = {}
        for side in SIDES:
            service = side.Service([], side.ServeConfig(seal_empty=seal_empty))
            cores = [c for c, _ in fleet[side.name]]
            rounds = []
            for _ in range(2):
                results = await service.run_cycle(cores)
                rounds.append([(r.path, r.sealed, r.error) for r in results])
            names = [len(await c.storage.list_state_names()) for c in cores]
            got[side.name] = (rounds, names,
                              [c.with_state(side.canonical) for c in cores])
            service.close()
        assert got["port"][:2] == got["jax"][:2]
        assert got["port"][2] == got["jax"][2]
        (first, second), names, _ = got["port"]
        assert first[0] == ("empty", seal_empty, None)
        assert first[1] == ("batched", True, None)
        assert second[0] == ("empty", False, None)
        assert names[0] == (1 if seal_empty else 0)

    run(scenario())


def test_host_reference_tenants_fold_on_the_cpu():
    """A daemon over ``HostAccelerator`` tenants (the host reference)
    folds its buckets with the plain versions on the CPU and seals the
    bytes a daemon over ``TorchAccelerator`` tenants seals from a copy of
    the same fleet."""
    from crdt_enc_tpu_torch import HostAccelerator
    from crdt_enc_tpu_torch.serve import service as service_mod

    async def scenario():
        tw = Twins()
        idents = []
        for t in range(5):
            r = await tw.remote(8 + 3 * t, b"h%d" % t)
            idents.append(await tw.identity(r))
        tw.freeze()
        arms = {}
        for arm, accel in (("torch", lambda: TorchAccelerator(
                device="cpu", min_device_batch=1)),
                ("host", HostAccelerator)):
            cores = []
            for t, ident in enumerate(idents):
                base = tw.copies["port"][t]
                st = MemoryStorage(MemoryRemote(
                    metas=dict(base.metas), states=dict(base.states),
                    ops={a: dict(d) for a, d in base.ops.items()}))
                st._local_meta, st._local_checkpoint = ident
                cores.append(await Core.open(make_opts(
                    st, create=False, accelerator=accel())))
            arms[arm] = (FleetDaemon(cores), cores)
        work = types.SimpleNamespace(core=arms["host"][1][0])
        assert service_mod._tenant_device(work).type == "cpu"
        reports = [scrub_report(await arms[a][0].run_cycle())
                   for a in ("torch", "host")]
        assert reports[0] == reports[1]
        assert {r["path"] for r in reports[1]["results"].values()} == {
            "batched"}
        for a, b in zip(arms["torch"][1], arms["host"][1]):
            assert a.with_state(canonical_bytes) == b.with_state(
                canonical_bytes)
        for d, _ in arms.values():
            await d.drain()

    run(scenario())


def test_mixed_device_fleet_is_bucketed_per_device(monkeypatch):
    """A fleet whose tenants fold on two devices is planned per device:
    no bucket mixes them, so a card tenant never folds on the CPU because
    a CPU tenant came first in its size class.  Tenants 1, 3 and 5 stand
    for card tenants (their accelerator's device set to ``cuda``): without
    a card their bucket fails loudly, with one it folds there."""
    import torch

    from crdt_enc_tpu_torch.serve import service as service_mod

    planned = []
    real_plan = service_mod.plan_buckets

    def recording_plan(shapes, **kw):
        planned.append(sorted(s.key for s in shapes))
        return real_plan(shapes, **kw)

    monkeypatch.setattr(service_mod, "plan_buckets", recording_plan)

    async def scenario():
        tw = Twins()
        idents = []
        for t in range(6):
            r = await tw.remote(8 + t, b"d%d" % t)
            idents.append(await tw.identity(r))
        tw.freeze()
        cores = []
        for t, ident in enumerate(idents):
            core = await Core.open(make_opts(tw.storage(PORT, t, ident),
                                             create=False))
            if t % 2:
                core.accel.device = torch.device("cuda")
            cores.append(core)
        service = FoldService([])
        try:
            return await service.run_cycle(cores)
        finally:
            service.close()

    results = run(scenario())
    # one size class: without the split the six would share one bucket
    assert sorted(planned) == [[0, 2, 4], [1, 3, 5]]
    for t in (0, 2, 4):
        assert (results[t].path, results[t].sealed, results[t].error) == (
            "batched", True, None)
    for t in (1, 3, 5):
        if torch.cuda.is_available():
            assert results[t].sealed and results[t].error is None
        else:
            assert results[t].path == "error" and not results[t].sealed
            assert results[t].error


def test_daemon_publishes_to_the_configured_default_server(monkeypatch):
    """Without a server of its own the daemon publishes its health to the
    process default, which the port starts from ``CRDT_OBS_HTTP`` and the
    JAX package from ``obs.live.configure``; both sections agree."""
    from crdt_enc_tpu.obs import live as jlive
    from crdt_enc_tpu_torch.obs import live

    live._reset()
    monkeypatch.setenv(live.ENV_VAR, "127.0.0.1:0")
    servers = {"port": live.default_server(), "jax": jlive.configure(0)}

    async def scenario():
        _, fleet = await twin_fleet([(6, b"pub")])
        pair = Pair(fleet, quick_cfg)
        await pair.cycle()
        sections = {}
        for name, srv in servers.items():
            d = srv.health()["daemon"]
            assert d["cycles"] == 1 and d["state"] == "running"
            d.pop("uptime_s")
            sections[name] = d
        assert sections["port"] == sections["jax"]
        await pair.drain()

    try:
        assert servers["port"] is not None and servers["port"].running
        run(scenario())
        assert servers["port"].health()["daemon"]["state"] == "drained"
    finally:
        live._reset()
        jlive._reset()


# ------------------------------------------------- crash/reopen (kill)


@pytest.mark.parametrize("backend", ["memory", "fs"])
def test_sigkill_reopen_converges_warm_and_fsck_clean(backend, tmp_path):
    """A daemon abandoned mid-flight with no drain loses nothing durable:
    every tenant reopens warm from the cycle-sealed checkpoint, a
    post-reopen write mints fresh dots, the fleet converges with a cold
    reader, and each package's fsck reads the remote clean — in both
    packages, with the same outcome and the same fsck report."""
    import crdt_enc_tpu.sim as jsim
    import crdt_enc_tpu_torch.sim as psim
    from crdt_enc_tpu.backends import FsStorage as JFsStorage
    from crdt_enc_tpu.tools.fsck import fsck_remote as jfsck
    from crdt_enc_tpu_torch.backends import FsStorage
    from crdt_enc_tpu_torch.tools.fsck import fsck_remote as pfsck

    extra = {"port": (FsStorage, pfsck, psim.DeterministicCryptor),
             "jax": (JFsStorage, jfsck, jsim.DeterministicCryptor)}

    async def scenario(side, root):
        Fs, fsck_remote, Det = extra[side.name]
        remotes = [side.Remote() for _ in range(3)]

        def storage(i, tag):
            if backend == "memory":
                return side.Storage(remotes[i])
            return Fs(str(root / f"{tag}-{i}"), str(root / f"remote-{i}"))

        for i in range(3):
            w = await side.Core.open(side.opts(storage(i, "w")))
            for k in range(18):
                m = b"k%d-%d" % (i, k % 13)
                await w.update(lambda s, m=m, w=w: s.add_ctx(w.actor_id, m))
        tenant_storages = [storage(i, "t") for i in range(3)]
        cores = [await side.Core.open(side.opts(st))
                 for st in tenant_storages]
        daemon = side.Daemon(cores, quick_cfg(side))
        await daemon.run_cycle()
        del daemon, cores  # no drain, no close
        out = []
        for i, st in enumerate(tenant_storages):
            c = await side.Core.open(side.opts(st, create=False))
            warm = c.opened_from_checkpoint
            await c.update(lambda s, c=c: s.add_ctx(c.actor_id,
                                                    b"post-kill-%d" % i))
            await c.compact()
            cold = await side.Core.open(side.opts(storage(i, "cold")))
            await cold.read_remote()
            report = await fsck_remote(storage(i, "fsck"), Det(f"k{i}"),
                                       side.opts(None).key_cryptor,
                                       deep=True)
            out.append((warm, cold.with_state(side.canonical)
                        == c.with_state(side.canonical), report.ok,
                        [(x.severity, x.family) for x in report.issues],
                        report.state_files, report.op_files))
        return out

    port = run(scenario(PORT, tmp_path / "port"))
    jax = run(scenario(JAX, tmp_path / "jax"))
    assert port == jax
    assert all(warm and same and ok for warm, same, ok, *_ in port)


# --------------------------------------------------- sim vocabulary


def test_sim_daemon_vocabulary_schedule_roundtrip():
    import crdt_enc_tpu.sim as jsim
    from crdt_enc_tpu_torch.sim import FaultConfig, Schedule, generate

    sched = generate(3, 4, 200, FaultConfig.none(), daemon=True)
    assert "daemon" in {s.kind for s in sched.steps}
    assert sched.to_obj() == jsim.generate(
        3, 4, 200, jsim.FaultConfig.none(), daemon=True).to_obj()
    again = Schedule.from_obj(sched.to_obj())
    assert again.daemon and [s.to_obj() for s in again.steps] == [
        s.to_obj() for s in sched.steps]
    plain = generate(3, 4, 200, FaultConfig.none())
    assert [s.to_obj() for s in plain.steps] == [
        s.to_obj() for s in generate(3, 4, 200, FaultConfig.none(),
                                     daemon=False).steps]
    assert not any(s.kind in ("daemon", "ddrain") for s in plain.steps)


def test_sim_daemon_schedule_runs_clean():
    """A no-fault daemon-vocabulary schedule runs a real FleetDaemon
    inside the port's simulator (tenants folding through the plain
    versions) with the JAX run's fingerprint and five daemon cycles."""
    import crdt_enc_tpu.sim as jsim
    import crdt_enc_tpu_torch.sim as psim

    results = []
    for pkg, kw in ((jsim, {}), (psim, {"device": "cpu"})):
        S = pkg.Step
        sched = pkg.Schedule(
            seed=11, n_replicas=3, daemon=True,
            steps=[S("add", 0, 1), S("add", 1, 2), S("daemon"),
                   S("add", 2, 3), S("daemon"), S("crash", 1),
                   S("daemon"), S("reopen", 1), S("daemon"),
                   S("ddrain"), S("add", 0, 4), S("daemon")],
            faults=pkg.FaultConfig.none(),
        )
        results.append(pkg.run_schedule(sched, **kw))
    jres, pres = results
    assert pres.ok, pres.violation
    assert pres.daemon_cycles == jres.daemon_cycles == 5
    assert pres.fingerprint == jres.fingerprint
