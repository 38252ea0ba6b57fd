"""The port's plugin backends: in-memory and filesystem storage, the
XChaCha20-Poly1305 and identity cryptors, and the plaintext, passphrase,
OpenPGP and X25519 recipient-keyed key cryptors.  The JAX package loads
its X25519 cryptor lazily because it needs the third-party
``cryptography`` package; the port's writes its primitives out
(``_curves.py``), so it is imported like the rest."""

from .fs import FsStorage
from .gpg_keys import GpgError, GpgKeyCryptor, NotDecryptable, gpg_available
from .identity_crypto import IdentityCryptor
from .memory import MemoryRemote, MemoryStorage, content_name
from .passphrase_keys import PassphraseKeyCryptor, WrongPassphrase
from .plain_keys import PlainKeyCryptor
from .x25519_keys import (
    NotARecipient,
    UntrustedSigner,
    X25519KeyCryptor,
    generate_identity,
)
from .xchacha import AeadError, XChaChaCryptor

__all__ = [
    "AeadError",
    "FsStorage",
    "GpgError",
    "GpgKeyCryptor",
    "IdentityCryptor",
    "MemoryRemote",
    "MemoryStorage",
    "NotARecipient",
    "NotDecryptable",
    "PassphraseKeyCryptor",
    "PlainKeyCryptor",
    "UntrustedSigner",
    "WrongPassphrase",
    "X25519KeyCryptor",
    "XChaChaCryptor",
    "content_name",
    "generate_identity",
    "gpg_available",
]
