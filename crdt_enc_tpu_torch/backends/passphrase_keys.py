"""Passphrase-protected key-cryptor backend: the port's copy of
``crdt_enc_tpu/backends/passphrase_keys.py``.

Fills the slot the reference's gpgme backend stubs out (its PGP
encrypt/decrypt are identity TODOs, crdt-enc-gpgme/src/lib.rs:95-98,
118-121): here the serialized Keys CRDT really is sealed before it enters
the converged remote metadata, so the data keys are never stored in the
clear.  Protection is symmetric — a passphrase every replica shares —
which is the LUKS model the reference's README describes (README.md:19-25):
rotating the passphrase re-wraps only the small Keys blob, never the data.

Wrap format (the content under ``PASSPHRASE_KEYS_META_VERSION_1``), in
the packer of ``utils.codec`` (the same bytes in both packages):

    pack([salt, log2_n, r, p, sealed])

where ``sealed`` is the XChaCha20-Poly1305 EncBox envelope (same bytes the
data path produces, backends/xchacha.py) under ``scrypt(passphrase, salt,
N=2**log2_n, r, p, dklen=32)``.  A fresh salt is drawn per write, so two
replicas writing the same Keys produce distinct blobs — convergence happens
at the CRDT layer after unwrap, exactly like the plain backend.

KDF work runs in the default thread pool (``asyncio.to_thread``); the AEAD
itself is the native C++ path releasing the interpreter lock.
"""

from __future__ import annotations

import asyncio
import hashlib
import secrets
import threading

from ..utils import codec
from ..utils.versions import (
    PASSPHRASE_KEYS_META_VERSION_1,
    SUPPORTED_PASSPHRASE_KEYS_META_VERSIONS,
)
from . import xchacha
from .plain_keys import PlainKeyCryptor

SALT_LEN = 16
KDF_LOG2_N = 14  # scrypt N = 2**14: interactive-grade, ~50ms
KDF_R = 8
KDF_P = 1
# scrypt memory ceiling for the *decode* side: accept attacker-supplied KDF
# params only up to a bounded work factor, or a hostile meta blob could
# demand gigabytes (128 * N * r bytes) before authentication runs.  The
# bounds also keep 128*N*r*2 under OpenSSL's 2**31-1 maxmem cap, so every
# in-bounds parameter set is actually computable.
MAX_LOG2_N = 20
MAX_R = 8
MAX_P = 4


class WrongPassphrase(Exception):
    """The sealed Keys blob failed authentication under this passphrase."""


def _params_in_bounds(log2_n: int, r: int, p: int) -> bool:
    return 0 < log2_n <= MAX_LOG2_N and 0 < r <= MAX_R and 0 < p <= MAX_P


def _derive(passphrase: bytes, salt: bytes, log2_n: int, r: int, p: int) -> bytes:
    # scrypt uses 128*N*r bytes for the V array plus 128*r*p for the
    # per-lane blocks; 32 MiB slack covers overhead.  With the
    # _params_in_bounds bounds the worst case (log2_n=20, r=8, p=4) is
    # 2**30 + 36 MiB — comfortably under OpenSSL's 2**31-1 maxmem cap.
    maxmem = 128 * (1 << log2_n) * r + 128 * r * p + (1 << 25)
    return hashlib.scrypt(
        passphrase, salt=salt, n=1 << log2_n, r=r, p=p,
        maxmem=maxmem, dklen=xchacha.KEY_LEN,
    )


def wrap_blob(passphrase: bytes, raw: bytes, *, log2_n: int = KDF_LOG2_N,
              r: int = KDF_R, p: int = KDF_P, derive=_derive) -> bytes:
    if not _params_in_bounds(log2_n, r, p):
        raise ValueError(
            f"KDF params out of bounds (log2_n={log2_n}, r={r}, p={p}); "
            f"max log2_n={MAX_LOG2_N}, r={MAX_R}, p={MAX_P}"
        )
    salt = secrets.token_bytes(SALT_LEN)
    key = derive(passphrase, salt, log2_n, r, p)
    sealed = xchacha.encrypt_blob(key, raw)
    return codec.pack([salt, log2_n, r, p, sealed])


def unwrap_blob(passphrase: bytes, blob: bytes, *, derive=_derive) -> bytes:
    try:
        salt, log2_n, r, p, sealed = codec.unpack(blob)
        # type-check, never coerce: bytes(attacker_int) would zero-allocate
        # that many bytes before any validation runs
        if not isinstance(salt, (bytes, bytearray)) or not isinstance(
            sealed, (bytes, bytearray)
        ):
            raise TypeError("salt/sealed must be binary")
        salt, sealed = bytes(salt), bytes(sealed)
        log2_n, r, p = int(log2_n), int(r), int(p)
    except Exception as e:
        raise WrongPassphrase(f"malformed passphrase wrap: {e}") from e
    if not _params_in_bounds(log2_n, r, p):
        raise WrongPassphrase(
            f"KDF params out of bounds (log2_n={log2_n}, r={r}, p={p})"
        )
    try:
        key = derive(passphrase, salt, log2_n, r, p)
    except ValueError as e:  # hostile blob must never escape the error contract
        raise WrongPassphrase(f"KDF failed: {e}") from e
    try:
        return xchacha.decrypt_blob(key, sealed)
    except xchacha.AeadError as e:
        raise WrongPassphrase(str(e)) from e


class PassphraseKeyCryptor(PlainKeyCryptor):
    """Key management with a shared passphrase sealing the Keys CRDT."""

    META_VERSION = PASSPHRASE_KEYS_META_VERSION_1
    SUPPORTED_META_VERSIONS = SUPPORTED_PASSPHRASE_KEYS_META_VERSIONS

    def __init__(self, passphrase: bytes | str, *, kdf_log2_n: int = KDF_LOG2_N,
                 kdf_r: int = KDF_R, kdf_p: int = KDF_P):
        super().__init__()
        if isinstance(passphrase, str):
            passphrase = passphrase.encode()
        if not _params_in_bounds(kdf_log2_n, kdf_r, kdf_p):
            raise ValueError(
                f"KDF params out of bounds (log2_n={kdf_log2_n}, r={kdf_r}, "
                f"p={kdf_p}); max log2_n={MAX_LOG2_N}, r={MAX_R}, p={MAX_P}"
            )
        self._passphrase = passphrase
        self._kdf = (kdf_log2_n, kdf_r, kdf_p)
        # (salt, log2_n, r, p) -> derived key: set_keys unwraps the blob it
        # just wrapped, and every meta notification re-unwraps unchanged
        # blobs — the cache makes repeat derivations free without touching
        # the fresh-salt-per-write property
        self._kdf_cache: dict = {}
        self._kdf_cache_lock = threading.Lock()

    def _derive_cached(self, passphrase, salt, log2_n, r, p):
        ck = (salt, log2_n, r, p)
        with self._kdf_cache_lock:
            key = self._kdf_cache.get(ck)
        if key is None:
            key = _derive(passphrase, salt, log2_n, r, p)
            # concurrent to_thread workers share the cache; the lock keeps
            # the evict-then-insert pair atomic (a double-pop would raise)
            with self._kdf_cache_lock:
                # evict only on real growth: a concurrent duplicate insert
                # must not push out an unrelated cached derivation
                if ck not in self._kdf_cache and len(self._kdf_cache) >= 64:
                    self._kdf_cache.pop(next(iter(self._kdf_cache)), None)
                self._kdf_cache[ck] = key
        return key

    async def _protect(self, raw: bytes) -> bytes:
        log2_n, r, p = self._kdf
        return await asyncio.to_thread(
            wrap_blob, self._passphrase, raw,
            log2_n=log2_n, r=r, p=p, derive=self._derive_cached,
        )

    async def _unprotect(self, vb) -> bytes:
        return await asyncio.to_thread(
            unwrap_blob, self._passphrase, vb.content, derive=self._derive_cached
        )
