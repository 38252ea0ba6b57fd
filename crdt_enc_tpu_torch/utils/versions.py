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

# Key-cryptor remote-meta format (the Keys CRDT blob in the meta MVReg).
KEYS_META_VERSION_1 = uuid.UUID("27c6e0f9-15ab-4d72-8c43-6e9f01d5ba06").bytes
SUPPORTED_KEYS_META_VERSIONS = frozenset({KEYS_META_VERSION_1})

# Application-data versions are chosen by the application that owns the
# CRDT state type (reference OpenOptions.supported_data_versions,
# lib.rs:730-731).  A reasonable default for tests:
DEFAULT_DATA_VERSION_1 = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes
