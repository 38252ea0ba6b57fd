"""Identity cryptor: the port's copy of
``crdt_enc_tpu/backends/identity_crypto.py``.

The envelope layering without the cipher — for tests and for deployments
delegating confidentiality to the transport.  Keeps the exact three-layer
wire shape so swapping in a real AEAD changes no formats."""

from __future__ import annotations

import secrets

from ..core.cryptor import Cryptor
from ..utils.version_bytes import VersionBytes
from ..utils.versions import IDENTITY_DATA_VERSION_1, IDENTITY_KEY_VERSION_1


class IdentityCryptor(Cryptor):
    async def gen_key(self) -> VersionBytes:
        return VersionBytes(IDENTITY_KEY_VERSION_1, secrets.token_bytes(32))

    async def encrypt(self, key: VersionBytes, data: bytes) -> bytes:
        key.ensure_version(IDENTITY_KEY_VERSION_1)
        return VersionBytes(IDENTITY_DATA_VERSION_1, data).serialize()

    async def decrypt(self, key: VersionBytes, data: bytes) -> bytes:
        key.ensure_version(IDENTITY_KEY_VERSION_1)
        return (
            VersionBytes.deserialize(data)
            .ensure_version(IDENTITY_DATA_VERSION_1)
            .content
        )
