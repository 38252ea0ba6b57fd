"""In-memory storage backend: the port's copy of
``crdt_enc_tpu/backends/memory.py`` without the checkpoint slot and the
delta family.  Multi-replica tests share one ``MemoryRemote`` the way real
replicas share a synced directory."""

from __future__ import annotations

import base64
import hashlib
from dataclasses import dataclass, field

from ..core.storage import Storage
from ..models.vclock import Actor


def content_name(data: bytes) -> str:
    """SHA3-256 → base32-nopad, the reference's content addressing
    (crdt-enc-tokio/src/lib.rs:403-432)."""
    digest = hashlib.sha3_256(data).digest()
    return base64.b32encode(digest).decode().rstrip("=")


@dataclass
class MemoryRemote:
    """The shared 'remote' directory tree."""

    metas: dict = field(default_factory=dict)  # name -> bytes
    states: dict = field(default_factory=dict)  # name -> bytes
    ops: dict = field(default_factory=dict)  # actor -> {version: bytes}


class MemoryStorage(Storage):
    def __init__(self, remote: MemoryRemote | None = None):
        self.remote = remote if remote is not None else MemoryRemote()
        self._local_meta: bytes | None = None

    # -- local meta --------------------------------------------------------
    async def load_local_meta(self) -> bytes | None:
        return self._local_meta

    async def store_local_meta(self, data: bytes) -> None:
        self._local_meta = bytes(data)

    # -- remote metas ------------------------------------------------------
    async def list_remote_meta_names(self) -> list[str]:
        return sorted(self.remote.metas)

    async def load_remote_metas(self, names: list[str]) -> list[tuple[str, bytes]]:
        return [(n, self.remote.metas[n]) for n in names if n in self.remote.metas]

    async def store_remote_meta(self, data: bytes) -> str:
        name = content_name(data)
        self.remote.metas.setdefault(name, bytes(data))
        return name

    async def remove_remote_metas(self, names: list[str]) -> None:
        for n in names:
            self.remote.metas.pop(n, None)

    # -- states ------------------------------------------------------------
    async def list_state_names(self) -> list[str]:
        return sorted(self.remote.states)

    async def load_states(self, names: list[str]) -> list[tuple[str, bytes]]:
        return [(n, self.remote.states[n]) for n in names if n in self.remote.states]

    async def store_state(self, data: bytes) -> str:
        name = content_name(data)
        self.remote.states.setdefault(name, bytes(data))
        return name

    async def remove_states(self, names: list[str]) -> None:
        for n in names:
            self.remote.states.pop(n, None)

    # -- ops ---------------------------------------------------------------
    async def list_op_actors(self) -> list[Actor]:
        return sorted(self.remote.ops)

    async def load_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, bytes]]:
        out = []
        for actor, first in actor_first_versions:
            log = self.remote.ops.get(actor, {})
            v = first
            while v in log:  # gap-free scan (crdt-enc-tokio lib.rs:254-269)
                out.append((actor, v, log[v]))
                v += 1
        return out

    async def stat_ops(
        self, actor_first_versions: list[tuple[Actor, int]]
    ) -> list[tuple[Actor, int, int]]:
        out = []
        for actor, first in actor_first_versions:
            log = self.remote.ops.get(actor, {})
            v = first
            while v in log:
                out.append((actor, v, len(log[v])))
                v += 1
        return out

    async def store_ops(self, actor: Actor, version: int, data: bytes) -> None:
        log = self.remote.ops.setdefault(actor, {})
        if version in log:
            raise FileExistsError(f"op v{version} already exists for this actor")
        log[version] = bytes(data)

    async def remove_ops(self, actor_last_versions: list[tuple[Actor, int]]) -> None:
        for actor, last in actor_last_versions:
            log = self.remote.ops.get(actor)
            if not log:
                continue
            for v in [v for v in log if v <= last]:
                del log[v]
            if not log:
                del self.remote.ops[actor]
