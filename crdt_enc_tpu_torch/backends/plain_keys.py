"""Plaintext key-cryptor backend: the port's copy of
``crdt_enc_tpu/backends/plain_keys.py``.

Structurally the reference's gpgme backend (crdt-enc-gpgme/src/lib.rs:34-129)
— own remote-meta MVReg, decode-on-notify, encode-and-persist on set_keys —
with identity key protection, which is exactly what the reference's WIP
backend does too (its PGP calls are commented out, lib.rs:95-98, 118-121).
The JAX package's protect/unprotect hooks and its trust fixpoint serve its
asymmetric backends, which the port does not copy.
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
    def __init__(self):
        self._reg = MVReg()
        self._core = None

    async def init(self, core) -> None:
        self._core = core

    async def set_remote_meta(self, reg: MVReg) -> None:
        """Converged key metadata arrived: fold into our register, decode the
        Keys CRDT, install on the core (gpgme lib.rs:79-105)."""
        self._reg.merge(reg)
        keys = decode_version_bytes_mvreg(
            self._reg, SUPPORTED_KEYS_META_VERSIONS, Keys
        )
        if keys is not None and self._core is not None:
            self._core.set_keys(keys)

    async def set_keys(self, keys: Keys) -> None:
        """Encode the key set into our register, re-notify ourselves, and
        hand the register to the core for persistence (gpgme lib.rs:107-129)."""
        if self._core is None:
            raise RuntimeError("key cryptor not initialized")
        encode_version_bytes_mvreg(
            self._reg, keys, self._core.actor_id, KEYS_META_VERSION_1
        )
        snapshot = MVReg.from_obj(self._reg.to_obj())
        await self.set_remote_meta(snapshot)
        await self._core.set_remote_meta_key_cryptor(
            MVReg.from_obj(self._reg.to_obj())
        )
