"""Storage port: abstract persistence over four object families.

The port's copy of ``crdt_enc_tpu/core/storage.py`` without the local
fold-checkpoint slot, the chunked op reader of the pipelined ingest and
the delta-snapshot family (the port's ``Core`` uses none of them).

Mirrors the reference Storage trait (crdt-enc/src/storage.rs:8-43): local
meta (one mutable blob), remote metas / states (immutable content-addressed
blobs), and per-actor op logs (immutable, densely version-numbered files).

Contracts carried over:
* ``load_ops`` returns each actor's ops **ordered by version** starting at
  the requested first version, with no gaps (storage.rs:36).
* names returned by list/store are opaque strings; stores of metas/states
  are content-addressed so rewrites are idempotent.
* ``remove_ops`` removes **all versions ≤ the given last version** per actor.

Missing directories/objects are treated as empty/None, never as errors
(crdt-enc-tokio/src/lib.rs:376-401) — a replica may simply not have synced
yet.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..models.vclock import Actor


class Storage(ABC):
    # -- local meta (mutable, private to this replica) ---------------------
    @abstractmethod
    async def load_local_meta(self) -> bytes | None: ...

    @abstractmethod
    async def store_local_meta(self, data: bytes) -> None: ...

    # -- remote metas (immutable, content-addressed) -----------------------
    @abstractmethod
    async def list_remote_meta_names(self) -> list[str]: ...

    @abstractmethod
    async def load_remote_metas(self, names: list[str]) -> list[tuple[str, bytes]]:
        """Missing names are silently skipped (concurrent compaction may
        have removed them)."""

    @abstractmethod
    async def store_remote_meta(self, data: bytes) -> str: ...

    @abstractmethod
    async def remove_remote_metas(self, names: list[str]) -> None: ...

    # -- states (immutable full-state snapshots, content-addressed) --------
    @abstractmethod
    async def list_state_names(self) -> list[str]: ...

    @abstractmethod
    async def load_states(self, names: list[str]) -> list[tuple[str, bytes]]: ...

    @abstractmethod
    async def store_state(self, data: bytes) -> str: ...

    @abstractmethod
    async def remove_states(self, names: list[str]) -> None: ...

    # -- op logs (immutable, per-actor, versioned 1,2,3,…) -----------------
    @abstractmethod
    async def list_op_actors(self) -> list[Actor]: ...

    @abstractmethod
    async def load_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        """For each (actor, first), every stored op file with
        version ≥ first, in version order per actor (scan until the first
        missing version, tolerating none at all)."""

    async def stat_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, int]]:
        """Like ``load_ops`` but returns ``(actor, version, nbytes)`` —
        sizes without content (the writer's own-history probe).  This base
        implementation degrades to loading; backends with cheap metadata
        override it."""
        return [
            (actor, version, len(raw))
            for actor, version, raw in await self.load_ops(
                actor_first_versions
            )
        ]

    @abstractmethod
    async def store_ops(self, actor: Actor, version: int, data: bytes) -> None: ...

    @abstractmethod
    async def remove_ops(self, actor_last_versions: list[tuple[Actor, int]]) -> None:
        """Remove every op file with version ≤ last for each actor."""

    # -- lifecycle ---------------------------------------------------------
    async def init(self, core) -> None:
        """Called once at open with the core handle (plugins may call back,
        cf. CoreSubHandle, reference lib.rs:286-290)."""

    async def set_remote_meta(self, meta) -> None:
        """This plugin's converged config blob changed (an MVReg of opaque
        VersionBytes, reference lib.rs:596-609).

        Delivery-order contract: concurrent ``read_remote`` calls may
        deliver register snapshots out of order.  The register is a CRDT —
        implementations must MERGE it into their own copy (stale snapshots
        then converge to no-ops), never replace state with it."""
