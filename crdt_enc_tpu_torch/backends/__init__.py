"""The port's plugin backends: in-memory and filesystem storage, the
XChaCha20-Poly1305 and identity cryptors, and the plaintext, passphrase
and OpenPGP key cryptors.  The JAX package's X25519 key cryptor needs the
third-party ``cryptography`` package and is not copied."""

from .fs import FsStorage
from .gpg_keys import GpgError, GpgKeyCryptor, NotDecryptable, gpg_available
from .identity_crypto import IdentityCryptor
from .memory import MemoryRemote, MemoryStorage, content_name
from .passphrase_keys import PassphraseKeyCryptor, WrongPassphrase
from .plain_keys import PlainKeyCryptor
from .xchacha import AeadError, XChaChaCryptor

__all__ = [
    "AeadError",
    "FsStorage",
    "GpgError",
    "GpgKeyCryptor",
    "IdentityCryptor",
    "MemoryRemote",
    "MemoryStorage",
    "NotDecryptable",
    "PassphraseKeyCryptor",
    "PlainKeyCryptor",
    "WrongPassphrase",
    "XChaChaCryptor",
    "content_name",
    "gpg_available",
]
