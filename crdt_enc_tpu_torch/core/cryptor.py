"""Cryptor port: abstract AEAD over opaque byte blobs.

The port's copy of ``crdt_enc_tpu/core/cryptor.py``.

Mirrors the reference Cryptor trait (crdt-enc/src/cryptor.rs:11-27): key
generation plus encrypt/decrypt, where keys and ciphertexts are VersionBytes
so cipher formats can rotate independently of everything else.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

from ..utils.version_bytes import VersionBytes


class Cryptor(ABC):
    @abstractmethod
    async def gen_key(self) -> VersionBytes:
        """Fresh random key material, tagged with the cipher's key version."""

    @abstractmethod
    async def encrypt(self, key: VersionBytes, data: bytes) -> bytes:
        """Seal ``data``; returns the raw-serialized cipher envelope (a
        VersionBytes tagged with the cipher's data version)."""

    @abstractmethod
    async def decrypt(self, key: VersionBytes, data: bytes) -> bytes:
        """Open a cipher envelope produced by ``encrypt``."""

    async def decrypt_batch(self, key: VersionBytes, blobs: list) -> list:
        """Open many envelopes sealed with one key.  Default: sequential
        loop; bulk backends override with a parallel native path (the
        decrypt front end of streaming compaction, SURVEY.md §7 step 6)."""
        return [await self.decrypt(key, b) for b in blobs]

    def decrypt_batch_fn(self, key: VersionBytes):
        """Optional sync twin of :meth:`decrypt_batch`: a plain callable
        ``(blobs) -> clears`` bound to ``key``, or None when the cipher
        has no sync path that releases the interpreter lock.  The fold
        service runs many tenants' decrypts inside one worker-thread hop
        through it.  Must open exactly what ``decrypt_batch`` opens."""
        return None

    async def init(self, core) -> None: ...

    async def set_remote_meta(self, meta) -> None:
        """Converged config register changed.  Concurrent ``read_remote``
        calls may deliver snapshots out of order — MERGE the register
        (it is a CRDT), never replace local state with it."""
