"""Plaintext key-cryptor backend: the port's copy of
``crdt_enc_tpu/backends/plain_keys.py``.

Structurally the reference's gpgme backend (crdt-enc-gpgme/src/lib.rs:34-129)
— own remote-meta MVReg, decode-on-notify, encode-and-persist on set_keys —
with identity key protection, which is exactly what the reference's WIP
backend does too (its PGP calls are commented out, lib.rs:95-98, 118-121).
A backend that really protects the blob overrides the two transforms
(``passphrase_keys``, ``gpg_keys``).
"""

from __future__ import annotations

from ..core.key_cryptor import KeyCryptor, Keys
from ..models.mvreg import MVReg
from ..utils.mvreg_codec import (
    decode_version_bytes_mvreg,
    encode_version_bytes_mvreg,
)
from ..utils.versions import KEYS_META_VERSION_1, SUPPORTED_KEYS_META_VERSIONS


class PlainKeyCryptor(KeyCryptor):
    # Subclasses that really protect the blob stamp their own meta version so
    # a reader with the wrong backend fails the version check, not the parse.
    META_VERSION = KEYS_META_VERSION_1
    SUPPORTED_META_VERSIONS = SUPPORTED_KEYS_META_VERSIONS
    # Exception types from _unprotect that skip just that register value
    # (some backends cannot open every concurrent value, e.g. a blob
    # sealed to a recipient set this replica is not in); an entirely
    # unreadable register still raises.
    DECODE_TOLERATES: tuple = ()

    def __init__(self):
        self._reg = MVReg()
        self._core = None

    async def init(self, core) -> None:
        self._core = core

    async def _protect(self, raw: bytes) -> bytes:
        """Hook: encrypt the serialized Keys blob (identity here)."""
        return raw

    async def _unprotect(self, vb) -> bytes:
        """Hook: decrypt a Keys blob (identity here)."""
        return vb.content

    def _trust_epoch(self):
        """Hook: a value that changes whenever ``_unprotect`` learns to open
        blobs it previously could not (e.g. a grown recipient roster).
        Backends with monotone trust growth return something comparable so
        ``set_remote_meta`` can re-decode to a fixpoint; the identity
        backend's trust never changes."""
        return None

    async def set_remote_meta(self, reg: MVReg) -> None:
        """Converged key metadata arrived: fold into our register, decode the
        Keys CRDT, install on the core (gpgme lib.rs:79-105).

        Decoding runs to a trust fixpoint: one register value's roster may
        introduce the identity that signed ANOTHER concurrent value, and
        MVReg iteration order is arbitrary — a single pass would
        tolerate-skip the not-yet-trusted value and silently drop its key
        material.  Trust growth is monotone, so re-running the decode
        whenever a pass grew trust terminates."""
        self._reg.merge(reg)
        while True:
            epoch = self._trust_epoch()
            keys = await decode_version_bytes_mvreg(
                self._reg, self.SUPPORTED_META_VERSIONS, Keys,
                transform=self._unprotect, tolerate=self.DECODE_TOLERATES,
            )
            if self._trust_epoch() == epoch:
                break
        if keys is not None and self._core is not None:
            self._core.set_keys(keys)

    async def set_keys(self, keys: Keys) -> None:
        """Encode the key set into our register, re-notify ourselves, and
        hand the register to the core for persistence (gpgme lib.rs:107-129)."""
        if self._core is None:
            raise RuntimeError("key cryptor not initialized")
        await encode_version_bytes_mvreg(
            self._reg,
            keys,
            self._core.actor_id,
            self.META_VERSION,
            transform=self._protect,
        )
        snapshot = MVReg.from_obj(self._reg.to_obj())
        await self.set_remote_meta(snapshot)
        await self._core.set_remote_meta_key_cryptor(
            MVReg.from_obj(self._reg.to_obj())
        )
