"""Always-on fleet daemon: a self-healing control plane over FoldService.

The port's copy of ``crdt_enc_tpu/serve/daemon.py``.  :class:`FoldService`
is one *cycle*; production is a *process*.  The :class:`FleetDaemon` owns a service and
runs the supervised forever-loop, with the failure behaviour a long-lived
control plane needs:

* **staleness-driven scheduling** — each supervised cycle compacts the
  tenants that *need* it, not the whole fleet round-robin.  Due-ness and
  priority derive from the tenant's last ``replication_status`` (op
  backlog files/bytes past the cursor, ``watermark_lag`` — how far the
  union clock is ahead of the causal stability watermark) plus
  freshness-SLO pressure (``obs.slo``): lag past the SLO target scores
  hardest, so laggards jump the queue.  Tenants not selected are
  *polled* — a stat-only ``replication_status`` probe refreshes their
  score without paying decrypt/decode.  Tenants opened with delta-state
  replication consume delta chains inside the cycle's ingest before
  falling back to full snapshots (``Core._read_remote_states`` is
  delta-first).
* **per-tenant retry / backoff / quarantine** — a failing tenant never
  poisons the cycle (the service already isolates it); the daemon adds
  the *temporal* half: consecutive failures back the tenant off with
  capped exponential delay plus seeded jitter (in units of cycles, so
  schedules replay deterministically), a re-probe path returns it to
  service when the delay expires, and repeat offenders park in a
  quarantine ring (``daemon_quarantined`` gauge) re-probed on a slow
  cadence.  Transient error classes (``IngestDecryptError`` — blobs not
  yet synced intact, ``StaleWriterError`` on reopen — own history not
  yet visible, storage hiccups) are exactly what the backoff exists
  for; they clear themselves on a later probe.
* **circuit breaker** — consecutive *whole-cycle* failures (every
  attempted tenant errored: a dead remote, a dead key service) trip the
  breaker into degraded mode: the daemon seals nothing and sheds all
  decrypt/decode load, keeps polling stat-only, and reports honestly
  (``daemon_degraded`` gauge, drain state in ``/healthz``).  A half-open
  probe every ``breaker_probe_every`` cycles attempts ONE tenant; a
  successful seal closes the breaker.
* **admission / eviction while running** — :meth:`admit` gates new
  tenants against ``max_tenants`` and the warm plane tier's byte budget (observed
  bytes-per-tenant, falling back to a configured estimate) and
  :meth:`evict` checkpoints a tenant and hands its core back, both
  serialized against in-flight cycles by the daemon lock — the fleet
  mutates between cycles, never during one.
* **graceful drain and crash/reopen** — :meth:`drain` (SIGTERM in the
  CLI) finishes the in-flight cycle, seals a warm-open checkpoint for
  every tenant, publishes the final health, and stops the live server.
  A SIGKILL'd daemon loses nothing durable: every seal went through the
  core's write-new-then-delete-old compaction and every cycle resealed
  checkpoints, so reopening the tenants (``Core.open(create=False)``)
  restores warm state.

The daemon is pure asyncio over the service: no thread of its own (the
live endpoint keeps its one server thread), no new wire format, no
storage writes beyond what compaction and checkpoints already do.  Every
fold it causes is the service's: one K2 launch per OR-Set bucket, the
solo spills' folds and K4 in the ingest of tenants with snapshots, on
the device of the tenants' accelerators.  The jitter stream is the JAX
daemon's (``random.Random(f"crdt-daemon-{seed}")``), so the same inputs
give the same schedule in both packages.  ``python -m
crdt_enc_tpu_torch.tools.daemon run`` wraps it as a process.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import dataclass, field

from ..utils import trace
from .service import FoldService, ServeConfig

logger = logging.getLogger("crdt_enc_tpu_torch.serve.daemon")

#: tenant states of the backoff/quarantine machine
ACTIVE = "active"
BACKOFF = "backoff"
QUARANTINED = "quarantined"

#: error classes the backoff path treats as self-clearing (substring
#: match on the ``TenantResult.error`` repr — the service reports errors
#: as reprs so tenant isolation never re-raises across the fleet); the
#: classification labels the backoff's log line
TRANSIENT_ERRORS = (
    "IngestDecryptError",
    "StaleWriterError",
    "MissingKeyError",
    "OSError",
    "ConnectionError",
    "TimeoutError",
)


class AdmissionError(RuntimeError):
    """A tenant was refused admission (fleet or byte budget full)."""


@dataclass
class DaemonConfig:
    """Control-plane knobs.  Backoff and cadence are in units of
    *cycles*, not seconds — the daemon's behaviour is then a pure
    function of its inputs; ``interval_s`` only paces
    :meth:`FleetDaemon.run_forever` between cycles."""

    interval_s: float = 1.0
    # wall-clock-aware pacing: with interval_auto on, run_forever paces
    # by next_interval() — the freshness-SLO burn over the last
    # burn_window_s of the daemon's clock drives the interval
    # geometrically between interval_max_s (no burn) and interval_min_s
    # (burn >= 1: laggards holding the watermark back are visited
    # sooner)
    interval_auto: bool = False
    interval_min_s: float = 0.05
    interval_max_s: float = 8.0
    burn_window_s: float = 30.0
    # scheduler: compact when backlog >= min_backlog_files or watermark
    # lag exceeds the freshness-SLO target, and at least every
    # max_idle_cycles regardless; at most `batch` tenants per cycle
    batch: int = 256
    min_backlog_files: int = 1
    max_idle_cycles: int = 8
    # backoff: delay = min(cap, base·2^(failures-1)) cycles ± jitter
    backoff_base: float = 1.0
    backoff_cap: float = 32.0
    backoff_jitter: float = 0.25
    # quarantine ring: park after N consecutive failures, re-probe one
    # parked tenant every M cycles
    quarantine_after: int = 4
    quarantine_probe_every: int = 16
    # circuit breaker: trip after N consecutive whole-cycle failures,
    # half-open probe every M cycles while degraded
    breaker_after: int = 3
    breaker_probe_every: int = 4
    # admission: refuse tenants past max_tenants, or past the byte budget
    # admission_bytes (0 = serve.warm_bytes) at the per-tenant resident
    # cost, assumed tenant_cost_bytes until the warm tier has observed one
    max_tenants: int = 100_000
    admission_bytes: int = 0
    tenant_cost_bytes: int = 1 << 20
    serve: ServeConfig = field(
        default_factory=lambda: ServeConfig(seal_empty=False)
    )


@dataclass
class TenantEntry:
    """One admitted tenant's control-plane state."""

    tid: str
    core: object
    state: str = ACTIVE
    failures: int = 0  # consecutive; resets on success
    eligible_at: int = 0  # first cycle a backoff re-probe may run
    # cycle of the last successful service visit (a seal, or an "empty"
    # pass over a quiet tenant — both restart the idle cadence)
    last_sealed: int = -1
    quarantined_at: int | None = None
    last_error: str | None = None

    def status(self) -> dict | None:
        return getattr(self.core, "last_replication_status", None)


class FleetDaemon:
    """The supervised forever-loop over a :class:`FoldService` (module
    docs).  ``tenants`` seed the fleet (tids ``t0..tN``); admit/evict
    mutate it while running.  ``seed`` fixes the jitter stream so a
    seeded schedule replays bit-for-bit; ``clock`` replaces
    ``time.monotonic`` for every wall-time read."""

    def __init__(self, tenants=(), config: DaemonConfig | None = None,
                 live_port: int | None = None, seed: int = 0, mesh=None,
                 clock=None):
        self.config = config if config is not None else DaemonConfig()
        # the mesh goes straight through to the service: scheduling,
        # backoff and drain do not depend on the device layout, only the
        # fold launches change shape
        self.service = FoldService([], self.config.serve, live_port=live_port,
                                   mesh=mesh)
        self._entries: dict[str, TenantEntry] = {}
        self._rng = random.Random(f"crdt-daemon-{seed}")
        self._cycle = 0
        # the deterministic-clock seam: every wall-time read (uptime,
        # the SLO burn window, the auto interval) goes through here
        self._clock = clock if clock is not None else time.monotonic
        self._started = self._clock()
        # live freshness-burn samples (clock_t, bad, good) for the
        # wall-clock-aware interval (pruned to burn_window_s)
        self._burn_window: list = []
        # freshness-wait protocol: per-tenant waiters blocked until the
        # tenant's stable prefix covers a target clock; a waiting tenant
        # jumps the cadence queue
        self._waiters: dict[str, list] = {}
        # serializes cycles against admit/evict/drain: the fleet mutates
        # BETWEEN cycles, never during one
        self._lock = asyncio.Lock()
        self._drain_requested = asyncio.Event()
        self.state = "running"  # running | draining | drained
        self.degraded = False
        self._consec_cycle_failures = 0
        self.last_cycle_report: dict | None = None
        for i, core in enumerate(tenants):
            self._admit_locked(core, f"t{i}")

    # ------------------------------------------------------------ fleet
    @property
    def cycle(self) -> int:
        return self._cycle

    @property
    def tenant_ids(self) -> list[str]:
        return list(self._entries)

    def entry(self, tid: str) -> TenantEntry | None:
        return self._entries.get(tid)

    def _admission_cost(self) -> int:
        """Per-tenant resident-bytes estimate for the admission gate:
        the warm tier's OBSERVED mean entry size once it has data, the
        configured estimate before that."""
        warm = self.service.warm
        if warm is not None and len(warm):
            return max(1, warm.bytes_held // len(warm))
        return self.config.tenant_cost_bytes

    def _admit_locked(self, core, tid: str) -> TenantEntry:
        if self.state != "running":
            raise AdmissionError(f"daemon is {self.state}")
        if tid in self._entries:
            raise AdmissionError(f"tenant {tid!r} already admitted")
        if len(self._entries) >= self.config.max_tenants:
            raise AdmissionError(
                f"fleet full ({len(self._entries)} tenants)"
            )
        budget = self.config.admission_bytes or self.config.serve.warm_bytes
        projected = (len(self._entries) + 1) * self._admission_cost()
        if projected > budget:
            raise AdmissionError(
                f"byte budget: {len(self._entries) + 1} tenants × "
                f"{self._admission_cost()}B/tenant > {budget}B warm budget"
            )
        entry = TenantEntry(tid, core)
        self._entries[tid] = entry
        trace.add("daemon_admitted", 1)
        return entry

    async def admit(self, core, tid: str | None = None) -> str:
        """Admit an OPEN core as a tenant while running.  Raises
        :class:`AdmissionError` when the fleet or the warm-tier byte
        budget is full — admission is the backpressure surface, never a
        silent drop.  Returns the tenant id."""
        async with self._lock:
            if tid is None:
                tid = f"t{len(self._entries)}"
                while tid in self._entries:
                    tid = f"{tid}x"
            self._admit_locked(core, tid)
        self._publish()
        return tid

    def _fail_waiters(self, tid: str, why: str) -> None:
        """Fail a departed tenant's pending freshness waiters LOUDLY —
        no cycle can ever resolve them, so letting them ride out their
        timeouts against a gone tenant would be a silent hang."""
        pending = self._waiters.pop(tid, None)
        if not pending:
            return
        from ..read.stable import StalenessError

        for _target, fut in pending:
            if not fut.done():
                fut.set_exception(
                    StalenessError(
                        "timeout",
                        f"tenant {tid}: {why} before the watermark "
                        "covered the target",
                    )
                )

    async def evict(self, tid: str, *, checkpoint: bool = True):
        """Remove a tenant while running: waits out any in-flight cycle,
        seals a final warm-open checkpoint (so the next open of that
        tenant is warm), fails its pending freshness waiters loudly,
        and hands the core back to the caller."""
        async with self._lock:
            entry = self._entries.pop(tid, None)
            if entry is None:
                raise KeyError(f"unknown tenant {tid!r}")
            self._fail_waiters(tid, "evicted")
            if checkpoint:
                try:
                    await entry.core.save_checkpoint()
                except Exception:
                    logger.warning(
                        "evict(%s): final checkpoint failed", tid,
                        exc_info=True,
                    )
            trace.add("daemon_evicted", 1)
        self._publish()
        return entry.core

    async def discard(self, tid: str) -> None:
        """Drop a tenant whose core is GONE (a crashed process, a
        caller-closed handle): no checkpoint, no core returned.  Unknown
        tids are ignored — discard is the cleanup path and must be safe
        to repeat.  Pending freshness waiters fail loudly, exactly as on
        evict."""
        async with self._lock:
            if self._entries.pop(tid, None) is not None:
                self._fail_waiters(tid, "discarded")
                trace.add("daemon_evicted", 1)

    # -------------------------------------------------------- scheduling
    def _slo_target(self) -> float:
        """The freshness-SLO target, resolved once per cycle."""
        from ..obs import slo as obs_slo

        return obs_slo.freshness_spec().target

    def _score(self, entry: TenantEntry, target: float):
        """Staleness priority, as a sort KEY: a pending freshness
        waiter is a separate tier above every score (compacting THIS
        tenant publishes the cursor its watermark is waiting on — the
        laggard jumps the queue outright; an additive boost would let
        a large-enough laggard crowd the waiter out of a full batch),
        then SLO-lag pressure, backlog files/bytes, and idle age.  A
        tenant with no status yet (never sampled) sorts first within
        its tier — unknown staleness is assumed worst."""
        waiting = 1 if self._waiters.get(entry.tid) else 0
        status = entry.status()
        if status is None:
            return (waiting, float("inf"))
        lag = float(status["divergence"]["watermark_lag"])
        backlog = status["backlog"]
        idle = self._cycle - max(entry.last_sealed, 0)
        return (
            waiting,
            (lag / max(target, 1.0)) * 16.0
            + float(backlog["files"])
            + float(backlog["bytes"]) / 65536.0
            + idle / max(self.config.max_idle_cycles, 1),
        )

    def _due(self, entry: TenantEntry, target: float) -> bool:
        if self._waiters.get(entry.tid):
            return True  # a freshness waiter is blocked on this tenant
        status = entry.status()
        if status is None or entry.last_sealed < 0:
            return True
        if status["backlog"]["files"] >= self.config.min_backlog_files:
            return True
        if float(status["divergence"]["watermark_lag"]) > target:
            return True
        return (
            self._cycle - entry.last_sealed >= self.config.max_idle_cycles
        )

    # ------------------------------------------------------------ cycles
    async def run_cycle(self) -> dict:
        """One supervised control-plane cycle (module docs).  Returns
        the cycle report: per-tenant outcomes keyed by tid —
        ``sealed`` / ``empty`` / ``error`` / ``polled`` / a fold path —
        plus the breaker and selection summary."""
        async with self._lock:
            if self.state != "running":
                raise RuntimeError(
                    f"daemon is {self.state}; run_cycle refused"
                )
            self._cycle += 1
            trace.add("daemon_cycles", 1)
            with trace.span("daemon.cycle", meta=self._cycle):
                report = await self._cycle_locked()
        self.last_cycle_report = report
        self._publish()
        return report

    async def _cycle_locked(self) -> dict:
        cfg = self.config
        cycle = self._cycle
        report: dict = {
            "cycle": cycle,
            "degraded": self.degraded,
            "selected": [],
            "results": {},
        }

        # ---- state-machine transitions into this cycle
        probes: list[TenantEntry] = []
        for entry in self._entries.values():
            if entry.state == BACKOFF and cycle >= entry.eligible_at:
                entry.state = ACTIVE  # re-probe path
            elif entry.state == QUARANTINED:
                parked = cycle - (entry.quarantined_at or cycle)
                if parked and parked % cfg.quarantine_probe_every == 0:
                    probes.append(entry)

        candidates = [
            e for e in self._entries.values() if e.state == ACTIVE
        ]
        target = self._slo_target()

        if self.degraded:
            # breaker open: shed decrypt/decode — poll only, except the
            # half-open single-tenant probe on its cadence.  The probe
            # pool falls back to backoff/quarantined tenants when no
            # active one is left — a fully-parked degraded fleet must
            # still be able to close the breaker after the outage ends
            if cycle % cfg.breaker_probe_every == 0 and self._entries:
                pool = candidates or list(self._entries.values())
                probe = max(pool, key=lambda e: self._score(e, target))
                trace.add("daemon_probes", 1)
                await self._compact([probe], report, half_open=True)
                candidates = [c for c in candidates if c is not probe]
            await self._poll(candidates, report)
        else:
            due = sorted(
                (e for e in candidates if self._due(e, target)),
                key=lambda e: self._score(e, target), reverse=True,
            )
            selected = due[: max(1, cfg.batch)]
            if probes:
                # one quarantined re-probe per cycle, APPENDED past the
                # batch cap and outside the due filter — the ring's
                # cadence is a guarantee, not a suggestion (and the
                # counter only ticks for probes that actually run)
                selected.append(probes[0])
                trace.add("daemon_probes", 1)
            chosen = {id(e) for e in selected}
            rest = [e for e in candidates if id(e) not in chosen]
            await self._compact(selected, report)
            await self._poll(rest, report)

        # ---- freshness-wait resolution + live SLO burn sample
        await self._resolve_waiters(report)
        self._note_burn(target)

        # ---- gauges + outcome bookkeeping
        counts = {ACTIVE: 0, BACKOFF: 0, QUARANTINED: 0}
        for entry in self._entries.values():
            counts[entry.state] += 1
        trace.gauge("daemon_tenants", len(self._entries))
        trace.gauge("daemon_quarantined", counts[QUARANTINED])
        trace.gauge("daemon_degraded", 1.0 if self.degraded else 0.0)
        report["degraded"] = self.degraded
        report["states"] = counts
        return report

    # -------------------------------------------------- freshness waits
    async def await_stable(self, tid: str, target, *,
                           timeout_s: float = 30.0):
        """The freshness-wait protocol at the control plane: block until
        tenant ``tid``'s stable prefix covers ``target`` (a VClock, e.g.
        the caller's own last-write clock — read-your-writes through a
        daemon-served tenant).  Registering a waiter lifts the tenant to
        the front of the cadence queue.  Resolution happens at the end of
        each cycle; raises :class:`~crdt_enc_tpu_torch.read.StalenessError`
        (``timeout``) when ``timeout_s`` of wall time elapses first, and
        ``KeyError`` for unknown tenants."""
        from ..read.stable import StalenessError

        entry = self._entries.get(tid)
        if entry is None:
            raise KeyError(f"unknown tenant {tid!r}")
        fut = asyncio.get_running_loop().create_future()
        waiter = (target, fut)
        self._waiters.setdefault(tid, []).append(waiter)
        trace.add("daemon_waiters", 1)
        try:
            return await asyncio.wait_for(fut, timeout=timeout_s)
        except asyncio.TimeoutError:
            raise StalenessError(
                "timeout",
                f"tenant {tid}: watermark did not cover the target "
                f"within {timeout_s}s of daemon cycles",
            ) from None
        finally:
            pending = self._waiters.get(tid, [])
            if waiter in pending:
                pending.remove(waiter)
            if not pending:
                self._waiters.pop(tid, None)

    async def _resolve_waiters(self, report: dict) -> None:
        """End-of-cycle half of :meth:`await_stable`: advance the
        stable prefix of every tenant with pending waiters (knowledge
        is fresh — the cycle just ingested or polled it) and resolve
        the futures whose target the frontier now covers."""
        for tid in list(self._waiters):
            entry = self._entries.get(tid)
            pending = self._waiters.get(tid, [])
            if entry is None or not pending:
                continue
            try:
                view = await entry.core.stable_prefix(refresh=False)
            except Exception as e:
                logger.debug(
                    "waiter advance for %s failed: %r", tid, e
                )
                continue
            for target, fut in list(pending):
                if not fut.done() and view.covers(target):
                    fut.set_result(view)
            report.setdefault("waiters", {})[tid] = len(
                [w for w in pending if not w[1].done()]
            )

    def _note_burn(self, target: float) -> None:
        """One live freshness-burn sample per cycle: the fraction of
        tenants whose watermark lag exceeds the SLO target, window-
        bucketed by the daemon clock — obs/slo.py's burn accounting
        applied to the running fleet instead of sink records."""
        bad = good = 0
        for entry in self._entries.values():
            status = entry.status()
            if status is None:
                continue
            if float(status["divergence"]["watermark_lag"]) > target:
                bad += 1
            else:
                good += 1
        now = self._clock()
        self._burn_window.append((now, bad, good))
        horizon = now - max(self.config.burn_window_s, 1e-9)
        while self._burn_window and self._burn_window[0][0] < horizon:
            self._burn_window.pop(0)

    def next_interval(self) -> float:
        """The pacing for run_forever's next sleep.  Fixed
        ``interval_s`` unless ``interval_auto``; with it, the freshness
        burn rate over the live window drives the interval
        geometrically from ``interval_max_s`` (no burn) down to
        ``interval_min_s`` (burn >= 1).  Published as the
        ``daemon_interval_s`` gauge either way."""
        cfg = self.config
        if not cfg.interval_auto:
            trace.gauge("daemon_interval_s", cfg.interval_s)
            return cfg.interval_s
        from ..obs import slo as obs_slo

        spec = obs_slo.freshness_spec()
        bad = sum(b for _, b, _ in self._burn_window)
        total = bad + sum(g for _, _, g in self._burn_window)
        frac = bad / total if total else 0.0
        burn = min(1.0, frac / spec.budget)
        lo = max(cfg.interval_min_s, 1e-3)
        hi = max(cfg.interval_max_s, lo)
        interval = hi * (lo / hi) ** burn
        trace.gauge("daemon_interval_s", interval)
        return interval

    async def _compact(self, entries, report, *, half_open: bool = False):
        """Run one FoldService cycle over ``entries`` and feed the
        outcomes through the backoff machine; maintains the breaker."""
        if not entries:
            return
        report["selected"] = [e.tid for e in entries]
        results = await self.service.run_cycle([e.core for e in entries])
        any_ok = False
        all_failed = True
        for entry, res in zip(entries, results):
            if res.error is not None:
                self._note_failure(entry, res.error)
                report["results"][entry.tid] = {
                    "outcome": "error", "error": res.error,
                    "state": entry.state, "path": res.path,
                }
                continue
            all_failed = False
            any_ok = any_ok or res.sealed
            self._note_success(entry)
            report["results"][entry.tid] = {
                "outcome": "sealed" if res.sealed else res.path,
                "error": None, "state": entry.state, "path": res.path,
                "latency_s": res.latency_s,
            }
        if all_failed:
            self._consec_cycle_failures += 1
            if (
                not self.degraded
                and self._consec_cycle_failures >= self.config.breaker_after
            ):
                self.degraded = True
                trace.add("daemon_breaker_trips", 1)
                logger.warning(
                    "circuit breaker OPEN after %d consecutive "
                    "whole-cycle failures: degraded mode (seal nothing, "
                    "poll only)", self._consec_cycle_failures,
                )
        else:
            self._consec_cycle_failures = 0
            if self.degraded and (any_ok or half_open):
                self.degraded = False
                logger.info(
                    "circuit breaker CLOSED: half-open probe succeeded"
                )

    async def _poll(self, entries, report) -> None:
        """Stat-only freshness refresh for tenants not compacted this
        cycle: updates each tenant's staleness inputs without any
        decrypt/decode work — fanned out under the service's ``io_width``
        bound so a large quiet fleet does not pay one sequential storage
        round-trip per tenant.  Poll failures ride the same backoff
        machine — an unreachable remote backs its tenant off whether it
        surfaced in a seal or a poll."""
        entries = [e for e in entries if e.state == ACTIVE]
        if not entries:
            return
        sem = asyncio.Semaphore(max(1, self.config.serve.io_width))

        async def one(entry: TenantEntry):
            async with sem:
                try:
                    await entry.core.replication_status()
                except Exception as e:
                    self._note_failure(entry, repr(e))
                    report["results"][entry.tid] = {
                        "outcome": "error", "error": repr(e),
                        "state": entry.state, "path": "poll",
                    }
                else:
                    report["results"].setdefault(
                        entry.tid,
                        {"outcome": "polled", "error": None,
                         "state": entry.state},
                    )

        with trace.span("daemon.poll", meta=len(entries)):
            await asyncio.gather(*(one(e) for e in entries))

    # ----------------------------------------------------- state machine
    def _note_success(self, entry: TenantEntry) -> None:
        if entry.state == QUARANTINED:
            logger.info("tenant %s left quarantine", entry.tid)
        entry.state = ACTIVE
        entry.failures = 0
        entry.last_error = None
        entry.quarantined_at = None
        entry.last_sealed = self._cycle

    def _note_failure(self, entry: TenantEntry, error: str) -> None:
        entry.failures += 1
        entry.last_error = error
        transient = any(t in error for t in TRANSIENT_ERRORS)
        if entry.state == QUARANTINED:
            # a failed re-probe re-parks; the modulo cadence restarts
            entry.quarantined_at = self._cycle
            return
        if entry.failures >= self.config.quarantine_after:
            entry.state = QUARANTINED
            entry.quarantined_at = self._cycle
            trace.add("daemon_quarantines", 1)
            logger.warning(
                "tenant %s quarantined after %d consecutive failures "
                "(last: %s)", entry.tid, entry.failures, error,
            )
            return
        cfg = self.config
        delay = min(
            cfg.backoff_cap, cfg.backoff_base * 2.0 ** (entry.failures - 1)
        )
        delay *= 1.0 + self._rng.uniform(
            -cfg.backoff_jitter, cfg.backoff_jitter
        )
        entry.state = BACKOFF
        entry.eligible_at = self._cycle + max(1, round(delay))
        trace.add("daemon_backoffs", 1)
        logger.info(
            "tenant %s backing off until cycle %d (%s failure %d: %s)",
            entry.tid, entry.eligible_at,
            "transient" if transient else "unclassified",
            entry.failures, error,
        )

    # ------------------------------------------------------------- drain
    def request_drain(self) -> None:
        """Signal-handler-safe drain request: the forever-loop finishes
        its in-flight cycle and drains.  Idempotent."""
        self._drain_requested.set()

    async def drain(self) -> dict:
        """Graceful shutdown: wait out the in-flight cycle, seal a
        warm-open checkpoint for every tenant, publish the final health,
        stop the live server.  Tenant cores stay open (they are the
        caller's); a second drain is a no-op.  Returns the tenants whose
        final checkpoint failed, as ``{tid: error_repr}`` — a failed
        drain checkpoint only costs that tenant a cold next open, so it
        is reported, not raised."""
        if self.state == "drained":
            return {}
        self.state = "draining"
        # pending freshness waiters cannot resolve once cycles stop:
        # fail them loudly now instead of letting them ride out their
        # timeouts against a drained daemon
        from ..read.stable import StalenessError

        for tid, pending in list(self._waiters.items()):
            for _target, fut in pending:
                if not fut.done():
                    fut.set_exception(
                        StalenessError(
                            "timeout",
                            f"tenant {tid}: daemon drained before the "
                            "watermark covered the target",
                        )
                    )
        self._waiters.clear()
        self._publish()
        errors: dict[str, str] = {}
        async with self._lock:
            with trace.span("daemon.drain", meta=len(self._entries)):
                for entry in self._entries.values():
                    try:
                        await entry.core.save_checkpoint()
                    except Exception as e:
                        errors[entry.tid] = repr(e)
                        logger.warning(
                            "drain: checkpoint for %s failed: %r",
                            entry.tid, e,
                        )
            self.state = "drained"
        self._publish()
        self.service.close()
        return errors

    async def run_forever(self, *, max_cycles: int = 0) -> None:
        """The supervised loop: cycle, pace by :meth:`next_interval`
        (``interval_s``, or the burn-paced interval under
        ``interval_auto``), drain on request (or after ``max_cycles`` >
        0).  A cycle that raises
        unexpectedly is logged and the loop keeps going — the daemon
        only stops on drain."""
        try:
            while not self._drain_requested.is_set():
                try:
                    await self.run_cycle()
                except RuntimeError:
                    raise  # drained under us: stop, don't spin
                except Exception:
                    logger.exception(
                        "supervised cycle %d failed; continuing",
                        self._cycle,
                    )
                if max_cycles and self._cycle >= max_cycles:
                    break
                try:
                    await asyncio.wait_for(
                        self._drain_requested.wait(),
                        timeout=self.next_interval(),
                    )
                except asyncio.TimeoutError:
                    pass
        finally:
            await self.drain()

    # ------------------------------------------------------------ health
    def health(self) -> dict:
        """The control-plane section of ``/healthz`` (obs/live.py):
        uptime, cycles, per-state tenant counts, breaker and drain
        state, and the last cycle's selection summary."""
        counts = {ACTIVE: 0, BACKOFF: 0, QUARANTINED: 0}
        for entry in self._entries.values():
            counts[entry.state] += 1
        last = self.last_cycle_report or {}
        return {
            "state": self.state,
            "uptime_s": round(self._clock() - self._started, 3),
            "cycles": self._cycle,
            "tenants": len(self._entries),
            "active": counts[ACTIVE],
            "backoff": counts[BACKOFF],
            "quarantined": counts[QUARANTINED],
            "degraded": self.degraded,
            "consecutive_cycle_failures": self._consec_cycle_failures,
            "waiters": sum(len(v) for v in self._waiters.values()),
            "last_cycle": {
                "cycle": last.get("cycle", 0),
                "selected": len(last.get("selected", [])),
                "errors": sum(
                    1 for r in last.get("results", {}).values()
                    if r.get("error")
                ),
            },
        }

    def _publish(self) -> None:
        """Health → the live endpoint (service-owned, else the process
        default).  Telemetry must never kill the loop it observes."""
        try:
            from ..obs import live as obs_live

            target = (
                self.service.live if self.service.live is not None
                else obs_live.default_server()
            )
            if target is not None:
                target.publish_daemon(self.health())
        except Exception:
            logger.debug("daemon health publication failed", exc_info=True)
