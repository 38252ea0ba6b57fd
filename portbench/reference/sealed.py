"""Open the program's sealed blobs from their bytes, for the reference.

The wire contract, frozen here: a blob is the raw VersionBytes
``container version (16 bytes) || msgpack [key id, cipher envelope]``;
the envelope is ``XChaCha data version (16 bytes) || msgpack [nonce,
ciphertext || tag]``; the cleartext is ``data version (16 bytes) ||
payload``.  A snapshot's payload is the msgpack array ``[state, cursor,
sealer]``.
"""

from __future__ import annotations

import uuid

from . import msgpack
from .xchacha import open_xchacha

CONTAINER_VERSION_1 = uuid.UUID("8f1d0c7e-2f6a-4bd1-9a3e-5c9b1a6e0d01").bytes
XCHACHA_DATA_VERSION_1 = uuid.UUID("3a7c44f2-9e51-4f0b-8d2c-7b61e4a9c102").bytes


class BadBlob(Exception):
    """A blob that does not open under the frozen wire contract."""


def open_payload(blob: bytes, key: bytes, data_version: bytes):
    """The decoded payload of one sealed blob; raises :class:`BadBlob`."""
    try:
        if blob[:16] != CONTAINER_VERSION_1:
            raise BadBlob("container version")
        _key_id, envelope = msgpack.unpack(blob[16:])
        if envelope[:16] != XCHACHA_DATA_VERSION_1:
            raise BadBlob("cipher version")
        nonce, ct = msgpack.unpack(envelope[16:])
        clear = open_xchacha(key, bytes(nonce), bytes(ct))
        if clear[:16] != data_version:
            raise BadBlob("data version")
        return msgpack.unpack(clear[16:])
    except BadBlob:
        raise
    except Exception as e:  # any malformed layer is a blob that fails
        raise BadBlob(f"{type(e).__name__}: {e}") from e


def open_snapshot(blob: bytes, key: bytes, data_version: bytes):
    """``(state, cursor, sealer)`` of a sealed snapshot."""
    payload = open_payload(blob, key, data_version)
    if not isinstance(payload, tuple) or len(payload) != 3:
        raise BadBlob("snapshot payload is not [state, cursor, sealer]")
    return payload
