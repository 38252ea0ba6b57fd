"""Fault-injecting storage wrapper: the adversarial sync tool.

The port's copy of ``crdt_enc_tpu/sim/faults.py``, over the port's
:class:`~crdt_enc_tpu_torch.core.storage.Storage`.

The replication substrate is a *passively synced directory* — the system
never sees the sync tool, only its effects.  :class:`FaultyStorage` wraps
any :class:`~crdt_enc_tpu_torch.core.storage.Storage` and plays the hostile
version of that tool, injecting every damage class the survey and the
fsck taxonomy name:

* **torn reads** — an op/state/meta blob comes back truncated (a sync
  caught mid-transfer; the bytes on the remote are fine, so a retry
  after repair succeeds);
* **partial listings** — a listing omits a subset of names (only part of
  the directory has synced);
* **delayed visibility** — a file another replica stored becomes visible
  only after a number of sync *ticks* (:meth:`tick`), modelling transfer
  lag; a replica always sees its own writes immediately;
* **duplicate delivery** — an op load re-delivers already-consumed
  versions (the reader's concurrent-read tolerance must skip them);
* **write crashes** — a store/remove raises :class:`SimCrash` either
  *before* or *after* the inner write takes effect (crash-during-seal:
  the caller cannot know which);
* **stale checkpoints** — ``load_local_checkpoint`` serves the previous
  generation (cursor skew: the resume point lags the durable history).

Every decision is a pure function of ``(seed, family, per-family call
counter)`` via SHA-256 — no wall clock, no shared RNG stream — so a
schedule replay against the same storage call sequence injects the same
faults.  :meth:`heal` ends the adversarial phase (the "sync completed"
fixed point the quiescence checker needs); :attr:`stats` counts every
injected fault per class so runs can report fault-survival totals.

The wrapper is simulation infrastructure, not a production path — but it
only uses the public Storage port, so anything that survives it survives
a real misbehaving sync tool with the same failure envelope.
"""

from __future__ import annotations

import hashlib
from collections import Counter
from dataclasses import dataclass, fields

from ..core.storage import Storage
from ..models.vclock import Actor


class SimCrash(Exception):
    """An injected crash at a write step.  The simulator treats the
    owning replica as dead (its Core is discarded, later reopened);
    production code never sees this type."""


@dataclass
class FaultConfig:
    """Per-class fault probabilities (0 disables a class).  The class
    names double as the schedule-JSON fault keys and the shrinker's
    dimensions — ``python -m crdt_enc_tpu_torch.tools.sim run --faults all``
    enables every class at its default adversarial rate."""

    torn_read: float = 0.0
    partial_list: float = 0.0
    delay_visibility: float = 0.0
    delay_max_ticks: int = 3
    dup_delivery: float = 0.0
    write_crash: float = 0.0
    stale_checkpoint: float = 0.0

    CLASSES = (
        "torn_read",
        "partial_list",
        "delay_visibility",
        "dup_delivery",
        "write_crash",
        "stale_checkpoint",
    )

    @classmethod
    def all_faults(cls) -> "FaultConfig":
        """Every fault class on, at rates convergence can still survive
        within a few hundred steps (the defaults the fleet run uses)."""
        return cls(
            torn_read=0.08,
            partial_list=0.10,
            delay_visibility=0.25,
            delay_max_ticks=3,
            dup_delivery=0.10,
            write_crash=0.04,
            stale_checkpoint=0.20,
        )

    @classmethod
    def none(cls) -> "FaultConfig":
        return cls()

    def to_obj(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    @classmethod
    def from_obj(cls, obj: dict) -> "FaultConfig":
        known = {f.name for f in fields(cls)}
        unknown = set(obj) - known
        if unknown:
            raise ValueError(f"unknown fault keys: {sorted(unknown)}")
        return cls(**{k: v for k, v in obj.items()})

    def without(self, name: str) -> "FaultConfig":
        """A copy with one fault class disabled — the shrinker's
        fault-dimension move."""
        obj = self.to_obj()
        if name not in obj:
            raise ValueError(f"unknown fault class {name!r}")
        obj[name] = 0.0 if name != "delay_max_ticks" else 0
        return self.from_obj(obj)

    def enabled_classes(self) -> list[str]:
        return [c for c in self.CLASSES if getattr(self, c)]


class FaultyStorage(Storage):
    """Wrap ``inner`` with deterministic fault injection (module docs).

    ``name`` keys this wrapper's decision stream (one per replica);
    ``seed`` keys the whole run.  All faults are *transient*: after
    :meth:`heal`, every call passes through clean and every delayed
    file is visible — the quiescence contract."""

    def __init__(self, inner: Storage, cfg: FaultConfig, *, seed: int, name: str):
        self.inner = inner
        self.cfg = cfg
        self.seed = int(seed)
        self.name = str(name)
        self.active = True
        self.ticks = 0
        self.stats: Counter = Counter()
        self._counters: Counter = Counter()
        # delayed visibility: key -> tick at which it becomes visible.
        # Keys are listing names for metas/states and (actor, version)
        # for op files; a key stored THROUGH this wrapper is its own
        # write and registers as immediately visible.
        self._reveal: dict = {}
        # last two checkpoint generations (stale-checkpoint fault)
        self._ckpt_prev: bytes | None = None

    # ------------------------------------------------------------ control
    def tick(self) -> None:
        """One sync tick: delayed files whose reveal time has come become
        visible on the next listing/load."""
        self.ticks += 1

    def heal(self) -> None:
        """End the adversarial phase: no new faults, everything visible."""
        self.active = False

    def arm(self) -> None:
        """Re-enable fault injection after a mid-run quiescence check."""
        self.active = True

    # ---------------------------------------------------------- decisions
    def _roll(self, family: str, extra: int = 0) -> tuple[float, float]:
        """Two uniform [0,1) draws for the next decision in ``family`` —
        a pure function of (seed, wrapper name, family, call counter),
        so the injection pattern is independent of everything but the
        storage call sequence itself."""
        self._counters[family] += 1
        h = hashlib.sha256(
            f"{self.seed}:{self.name}:{family}:{self._counters[family]}:{extra}".encode()
        ).digest()
        return (
            int.from_bytes(h[:8], "big") / 2**64,
            int.from_bytes(h[8:16], "big") / 2**64,
        )

    def _maybe_tear(self, family: str, raw: bytes) -> bytes:
        if not self.active or not self.cfg.torn_read or len(raw) < 2:
            return raw
        p, frac = self._roll(f"tear.{family}")
        if p >= self.cfg.torn_read:
            return raw
        self.stats["torn_read"] += 1
        return raw[: max(1, int(len(raw) * frac))]

    def _filter_listing(self, family: str, names: list) -> list:
        if not self.active:
            return names
        out = []
        for n in names:
            if not self._visible(family, n):
                continue
            if self.cfg.partial_list:
                p, _ = self._roll(f"list.{family}")
                if p < self.cfg.partial_list:
                    self.stats["partial_list"] += 1
                    continue
            out.append(n)
        return out

    def _visible(self, family: str, key) -> bool:
        """Delayed-visibility gate: first sighting of a foreign key rolls
        a reveal tick; until then the key does not exist for this
        replica.  Healing reveals everything."""
        if not self.active:
            return True
        if not self.cfg.delay_visibility:
            return True
        k = (family, key)
        reveal = self._reveal.get(k)
        if reveal is None:
            p, d = self._roll(f"delay.{family}")
            if p < self.cfg.delay_visibility:
                delay = 1 + int(d * max(1, self.cfg.delay_max_ticks))
                self.stats["delay_visibility"] += 1
            else:
                delay = 0
            reveal = self.ticks + delay
            self._reveal[k] = reveal
        return reveal <= self.ticks

    def _note_own(self, family: str, key) -> None:
        self._reveal[(family, key)] = 0  # own writes: always visible

    def _maybe_crash(self, family: str) -> bool:
        """Roll a write-crash decision: raises :class:`SimCrash`
        immediately for crash-BEFORE, returns True when the inner write
        should land first and THEN crash (crash-AFTER), False for no
        fault."""
        if not self.active or not self.cfg.write_crash:
            return False
        p, which = self._roll(f"crash.{family}")
        if p >= self.cfg.write_crash:
            return False
        self.stats["write_crash"] += 1
        if which < 0.5:
            raise SimCrash(f"injected crash before {family}")
        return True  # crash after the inner call

    async def _write(self, family: str, thunk, landed=None):
        """Run one inner write under the crash fault.  ``thunk`` builds
        the inner coroutine — created only AFTER the crash roll, so a
        crash-before leaves no never-awaited coroutine behind.
        ``landed(result)`` runs whenever the inner write took effect —
        INCLUDING before a crash-AFTER raise — so bookkeeping that
        mirrors durable state (own-write visibility, checkpoint
        generations) can never desynchronize from it: a replica always
        sees its own landed writes, crash or no crash."""
        after = self._maybe_crash(family)
        result = await thunk()
        if landed is not None:
            landed(result)
        if after:
            raise SimCrash(f"injected crash after {family}")
        return result

    # -------------------------------------------------------- local meta
    async def load_local_meta(self) -> bytes | None:
        return await self.inner.load_local_meta()

    async def store_local_meta(self, data: bytes) -> None:
        await self._write(
            "store_local_meta", lambda: self.inner.store_local_meta(data)
        )

    # -------------------------------------------------------- checkpoints
    async def load_local_checkpoint(self) -> bytes | None:
        cur = await self.inner.load_local_checkpoint()
        if (
            self.active
            and self.cfg.stale_checkpoint
            and self._ckpt_prev is not None
        ):
            p, _ = self._roll("stale_checkpoint")
            if p < self.cfg.stale_checkpoint:
                self.stats["stale_checkpoint"] += 1
                return self._ckpt_prev
        return cur

    async def store_local_checkpoint(self, data: bytes) -> None:
        prev = await self.inner.load_local_checkpoint()

        def landed(_res):
            if prev is not None:
                self._ckpt_prev = prev

        await self._write(
            "store_local_checkpoint",
            lambda: self.inner.store_local_checkpoint(data),
            landed=landed,
        )

    async def remove_local_checkpoint(self) -> None:
        await self.inner.remove_local_checkpoint()

    # ------------------------------------------------------ remote metas
    async def list_remote_meta_names(self) -> list[str]:
        return self._filter_listing("meta", await self.inner.list_remote_meta_names())

    async def load_remote_metas(self, names: list[str]) -> list[tuple[str, bytes]]:
        loaded = await self.inner.load_remote_metas(
            [n for n in names if self._visible("meta", n)]
        )
        # remote meta is the key/config register: tearing it yields
        # MissingKeyError storms that the schedule cannot heal mid-run,
        # so the torn-read class covers states and ops (the payload
        # families) and leaves the tiny meta blobs intact — the same
        # asymmetry a real sync tool shows (meta files are ~100 bytes).
        return loaded

    async def store_remote_meta(self, data: bytes) -> str:
        return await self._write(
            "store_remote_meta",
            lambda: self.inner.store_remote_meta(data),
            landed=lambda name: self._note_own("meta", name),
        )

    async def remove_remote_metas(self, names: list[str]) -> None:
        await self._write(
            "remove_remote_metas", lambda: self.inner.remove_remote_metas(names)
        )

    # ------------------------------------------------------------ states
    async def list_state_names(self) -> list[str]:
        return self._filter_listing("states", await self.inner.list_state_names())

    async def load_states(self, names: list[str]) -> list[tuple[str, bytes]]:
        loaded = await self.inner.load_states(
            [n for n in names if self._visible("states", n)]
        )
        return [(n, self._maybe_tear("states", raw)) for n, raw in loaded]

    async def store_state(self, data: bytes) -> str:
        return await self._write(
            "store_state",
            lambda: self.inner.store_state(data),
            landed=lambda name: self._note_own("states", name),
        )

    async def remove_states(self, names: list[str]) -> None:
        await self._write(
            "remove_states", lambda: self.inner.remove_states(names)
        )

    # --------------------------------------------------------------- ops
    async def list_op_actors(self) -> list[Actor]:
        return self._filter_listing("actors", await self.inner.list_op_actors())

    def _dup_first(self, actor: Actor, first: int) -> int:
        if not self.active or not self.cfg.dup_delivery or first <= 1:
            return first
        p, back = self._roll("dup")
        if p >= self.cfg.dup_delivery:
            return first
        self.stats["dup_delivery"] += 1
        return max(1, first - 1 - int(back * 2))

    def _censor_ops(
        self, files: list[tuple[Actor, int, bytes]], cut: set | None = None,
        family: str = "ops",
    ) -> list[tuple[Actor, int, bytes]]:
        """Apply visibility + torn reads to a dense op run.  A hidden
        file ends its actor's run (density: nothing past it may be
        delivered); ``cut`` carries ended actors across chunks.  The
        visibility roll is evaluated for EVERY file — even ones already
        behind a cut — so reveal clocks start at first delivery attempt
        and a run un-hides within ``delay_max_ticks`` instead of one
        file per tick (a cascade no real sync tool exhibits).  The
        delta family shares the censor (``family="deltas"``): hiding a
        link mid-log models a half-synced chain, which consumers must
        survive by falling back to the snapshot path."""
        out = []
        ended: set = cut if cut is not None else set()
        for actor, version, raw in files:
            visible = self._visible(family, (actor, version))
            if actor in ended:
                continue
            if not visible:
                ended.add(actor)
                continue
            out.append((actor, version, self._maybe_tear(family, raw)))
        return out

    async def load_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        wanted = [
            (a, self._dup_first(a, first)) for a, first in actor_first_versions
        ]
        return self._censor_ops(await self.inner.load_ops(wanted))

    async def stat_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, int]]:
        # observational probe: visibility applies (a hidden file is not
        # backlog yet), tearing/dup do not (sizes come from stat)
        out = []
        ended: set = set()
        for actor, version, nbytes in await self.inner.stat_ops(
            actor_first_versions
        ):
            visible = self._visible("ops", (actor, version))
            if actor in ended:
                continue
            if not visible:
                ended.add(actor)
                continue
            out.append((actor, version, nbytes))
        return out

    async def iter_op_chunks(
        self,
        actor_first_versions: list[tuple[Actor, int]],
        max_bytes: int = 64 << 20,
    ):
        cut: set = set()
        async for files in self.inner.iter_op_chunks(
            actor_first_versions, max_bytes
        ):
            censored = self._censor_ops(files, cut)
            if censored:
                yield censored

    async def store_ops(self, actor: Actor, version: int, data: bytes) -> None:
        await self._write(
            "store_ops",
            lambda: self.inner.store_ops(actor, version, data),
            landed=lambda _res: self._note_own("ops", (actor, version)),
        )

    async def remove_ops(self, actor_last_versions: list[tuple[Actor, int]]) -> None:
        await self._write(
            "remove_ops", lambda: self.inner.remove_ops(actor_last_versions)
        )

    # ------------------------------------------------------------- deltas
    # The delta family inherits the op family's whole failure envelope:
    # partial actor listings, delayed visibility per file, torn reads,
    # crash-before/after on publishes and GC.  Deltas are an OPTIMIZATION
    # layer — every injected fault here must at worst force the consumer
    # back onto the snapshot path, never diverge it.
    @property
    def has_deltas(self) -> bool:
        return getattr(self.inner, "has_deltas", False)

    async def list_delta_actors(self) -> list[Actor]:
        return self._filter_listing(
            "dactors", await self.inner.list_delta_actors()
        )

    async def load_deltas(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        return self._censor_ops(
            await self.inner.load_deltas(actor_first_versions),
            family="deltas",
        )

    async def store_delta(self, actor: Actor, version: int, data: bytes) -> None:
        await self._write(
            "store_delta",
            lambda: self.inner.store_delta(actor, version, data),
            landed=lambda _res: self._note_own("deltas", (actor, version)),
        )

    async def remove_deltas(
        self, actor_last_versions: list[tuple[Actor, int]]
    ) -> None:
        await self._write(
            "remove_deltas",
            lambda: self.inner.remove_deltas(actor_last_versions),
        )

    # --------------------------------------------------------- lifecycle
    async def init(self, core) -> None:
        await self.inner.init(core)

    async def set_remote_meta(self, meta) -> None:
        await self.inner.set_remote_meta(meta)
