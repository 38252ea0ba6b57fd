"""KeyCryptor port and the Keys CRDT — the "LUKS header" of the system.

The port's copy of ``crdt_enc_tpu/core/key_cryptor.py``.

Mirrors the reference key_cryptor.rs: data is encrypted with random data
keys; the keys themselves converge as a CRDT (an MVReg naming the latest key
id + an OR-Set of key material) that the KeyCryptor backend may additionally
encrypt (e.g. with PGP) inside the remote metadata.  Passwords/recipients can
change without re-encrypting data (reference README.md:19-25).

``Keys.latest_key`` resolves concurrent latest-id writes deterministically by
taking the minimum key id (reference key_cryptor.rs:59-70) and raises on a
dangling id (the reference panics).
"""

from __future__ import annotations

import uuid
from abc import ABC, abstractmethod
from dataclasses import dataclass, field

from ..models.mvreg import MVReg
from ..models.orset import ORSet
from ..models.vclock import Actor
from ..utils import codec
from ..utils.version_bytes import VersionBytes


@dataclass(frozen=True)
class Key:
    """UUID-identified key material.  Identity is the id alone (reference
    key_cryptor.rs:85-139: Borrow/Hash/Eq/Ord by id); material for a given
    id is immutable once generated."""

    id: bytes  # 16-byte UUID
    material: VersionBytes

    @classmethod
    def new(cls, material: VersionBytes) -> "Key":
        return cls(uuid.uuid4().bytes, material)

    def member_obj(self):
        """The ORSet member encoding: nested tuples keep it hashable and
        msgpack-canonical."""
        return (self.id, (self.material.version, self.material.content))

    @classmethod
    def from_member_obj(cls, obj) -> "Key":
        kid, (version, content) = obj
        return cls(bytes(kid), VersionBytes(bytes(version), bytes(content)))


class DanglingLatestKey(Exception):
    """The latest-key register names an id absent from the key set."""


@dataclass
class Keys:
    """MVReg of the latest key id + OR-Set of keys (key_cryptor.rs:35-52)."""

    latest: MVReg = field(default_factory=MVReg)
    keys: ORSet = field(default_factory=ORSet)
    # id → Key lookup index, built lazily and invalidated by every mutation
    # that goes through this class.  ``get_key`` is called per key-group per
    # bulk ingest and per sealed blob open; without the index each call
    # re-sorts the whole rotation history (O(K log K · msgpack)).
    _index: dict | None = field(
        default=None, repr=False, compare=False, init=False
    )

    def _key_index(self) -> dict:
        if self._index is None:
            by_id: dict[bytes, tuple] = {}
            for m in self.keys.entries:
                kid = bytes(m[0])
                prev = by_id.get(kid)
                # ids are unique in practice (material is immutable per id,
                # reference key_cryptor.rs:85-139); if storage ever presents
                # duplicates, keep the canonical-order winner deterministically
                if prev is None or codec.pack(m) < codec.pack(prev):
                    by_id[kid] = m
            self._index = {
                kid: Key.from_member_obj(m) for kid, m in by_id.items()
            }
        return self._index

    def get_key(self, kid: bytes) -> Key | None:
        return self._key_index().get(bytes(kid))

    def latest_key(self) -> Key | None:
        """Deterministic resolution of concurrent latest-id writes: the
        minimum id wins the tie-break (key_cryptor.rs:59-70)."""
        ids = self.latest.read().values
        if not ids:
            return None
        kid = min(bytes(i) for i in ids)
        key = self.get_key(kid)
        if key is None:
            raise DanglingLatestKey(uuid.UUID(bytes=kid).hex)
        return key

    def insert_latest_key(self, actor: Actor, key: Key) -> None:
        """Add the key and point the latest-register at it
        (key_cryptor.rs:72-82: Orswot add + MVReg write under add-ctx)."""
        self.keys.apply(self.keys.add_ctx(actor, key.member_obj()))
        self.latest.apply(self.latest.write_ctx(actor, key.id))
        self._index = None

    def merge(self, other: "Keys") -> None:
        self.latest.merge(other.latest)
        self.keys.merge(other.keys)
        self._index = None

    def to_obj(self):
        return {b"l": self.latest.to_obj(), b"k": self.keys.to_obj()}

    @classmethod
    def from_obj(cls, obj) -> "Keys":
        if obj is None:
            return cls()
        return cls(MVReg.from_obj(obj.get(b"l")), ORSet.from_obj(obj.get(b"k")))

    def is_empty(self) -> bool:
        return self.latest.is_empty() and not self.keys.entries


class KeyCryptor(ABC):
    """Key-management port (key_cryptor.rs:18-33).  Owns how the Keys CRDT
    is protected inside the remote metadata (identity for tests, PGP-style
    asymmetric wrap for real deployments)."""

    @abstractmethod
    async def set_keys(self, keys: Keys) -> None:
        """The core (or the backend itself) updated the key set: encode it
        into this plugin's remote-meta register and push it to the core for
        persistence + convergence (reference gpgme lib.rs:107-129)."""

    async def init(self, core) -> None: ...

    async def set_remote_meta(self, meta) -> None:
        """Converged config register changed.  Concurrent ``read_remote``
        calls may deliver snapshots out of order — MERGE the register
        (it is a CRDT), never replace local state with it."""
