"""Format-version registry: the port's copy of the constants of
``crdt_enc_tpu/utils/versions.py`` that its wire path checks.

The reference's de-facto config system is compile-time version sets checked
at every decode boundary (reference crdt-enc/src/lib.rs:26-31).  The UUIDs
are the JAX package's own, byte for byte, so files written by either
package open in the other.
"""

import uuid

# Outer container-format version stamped on every stored file
# (ops, states, remote metas).  Reference analogue: CURRENT_VERSION lib.rs:26.
CONTAINER_VERSION_1 = uuid.UUID("8f1d0c7e-2f6a-4bd1-9a3e-5c9b1a6e0d01").bytes
CURRENT_CONTAINER_VERSION = CONTAINER_VERSION_1
SUPPORTED_CONTAINER_VERSIONS = frozenset({CONTAINER_VERSION_1})

# Cipher-envelope version stamped by the XChaCha20-Poly1305 cryptor on its
# EncBox payloads.  Reference analogue: DATA_VERSION xchacha lib.rs:11.
XCHACHA_DATA_VERSION_1 = uuid.UUID("3a7c44f2-9e51-4f0b-8d2c-7b61e4a9c102").bytes
# Key-material version stamped on generated keys.  Reference: KEY_VERSION.
XCHACHA_KEY_VERSION_1 = uuid.UUID("b45e19d8-6c3f-4aa7-92e0-1f8d57c3ab03").bytes

# Identity (test) cryptor versions.
IDENTITY_DATA_VERSION_1 = uuid.UUID("5d2f8b1a-0e47-4c69-b3d5-9a64e72f1c04").bytes
IDENTITY_KEY_VERSION_1 = uuid.UUID("e91a3c56-7d20-4b8f-a6e1-48c5d90b2f05").bytes

# Key-cryptor remote-meta format (the Keys CRDT blob in the meta MVReg).
KEYS_META_VERSION_1 = uuid.UUID("27c6e0f9-15ab-4d72-8c43-6e9f01d5ba06").bytes
SUPPORTED_KEYS_META_VERSIONS = frozenset({KEYS_META_VERSION_1})

# Passphrase-wrapped key-cryptor remote-meta format: the Keys blob sealed
# under a scrypt-derived key (salt + KDF params + XChaCha EncBox envelope).
PASSPHRASE_KEYS_META_VERSION_1 = uuid.UUID(
    "9d84f2a1-6b0e-4c57-a3d9-0f72e85c4b08"
).bytes
SUPPORTED_PASSPHRASE_KEYS_META_VERSIONS = frozenset(
    {PASSPHRASE_KEYS_META_VERSION_1}
)

# OpenPGP key-cryptor remote-meta format: the Keys blob is an OpenPGP
# message encrypted to the recipient keyring.
GPG_KEYS_META_VERSION_1 = uuid.UUID(
    "7b0e66a1-9c2d-4f5e-b6a7-3d8c1e4f5a62"
).bytes
SUPPORTED_GPG_KEYS_META_VERSIONS = frozenset({GPG_KEYS_META_VERSION_1})

# Recipient-keyed (X25519) key-cryptor remote-meta format: the Keys blob
# sealed to a set of recipient public keys (ephemeral ECDH + HKDF + AEAD)
# and signed by the writer (Ed25519).
X25519_KEYS_META_VERSION_1 = uuid.UUID(
    "4fb7a9d2-3c16-4e80-9b5a-217f60d8e3c9"
).bytes
SUPPORTED_X25519_KEYS_META_VERSIONS = frozenset({X25519_KEYS_META_VERSION_1})

# Application-data versions are chosen by the application that owns the
# CRDT state type (reference OpenOptions.supported_data_versions,
# lib.rs:730-731).  A reasonable default for tests:
DEFAULT_DATA_VERSION_1 = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
