"""XChaCha20-Poly1305 cryptor backend over the native C++ implementation.

The port's copy of ``crdt_enc_tpu/backends/xchacha.py``.  Wire format
mirrors the reference cipher backend
(crdt-enc-xchacha20poly1305/src/lib.rs:40-102): a 32-byte random key
tagged with the key version; encrypt draws a random 24-byte XNonce, seals
with XChaCha20-Poly1305, and wraps ``EncBox{nonce, enc_data}`` as msgpack
inside a version-tagged envelope.  Crypto runs off the event loop in the
default thread pool; the C calls hold no Python state.

The bulk open joins the blobs in Python into one buffer and parses and
decrypts them natively in two calls, into one packed cleartext buffer
(``decrypt_blobs_packed``; ``decrypt_blobs`` slices it into views).  The
JAX package's C-API lengths pass and its pointer-array route for large
blobs are not copied.
"""

from __future__ import annotations

import asyncio
import os
import secrets

import numpy as np

from .. import native
from ..core.cryptor import Cryptor
from ..utils import codec
from ..utils.version_bytes import VersionBytes
from ..utils.versions import XCHACHA_DATA_VERSION_1, XCHACHA_KEY_VERSION_1

KEY_LEN = 32
NONCE_LEN = 24
TAG_LEN = 16


class AeadError(Exception):
    """Authentication failed: wrong key or tampered ciphertext."""


def _check_key(key: bytes) -> None:
    # the native code reads exactly 32 bytes; a short corrupt key blob must
    # fail here, not read past the buffer
    if len(key) != KEY_LEN:
        raise AeadError(f"invalid key length {len(key)}; expected {KEY_LEN}")


def seal_raw(key: bytes, nonce: bytes, data: bytes) -> bytes:
    """The bare AEAD: XChaCha20-Poly1305 seal with an explicit nonce,
    returning ``ct ‖ tag`` (no envelope), for callers speaking a foreign
    framing (the reference-remote import and export tools)."""
    _check_key(key)
    if len(nonce) != NONCE_LEN:
        raise AeadError(f"invalid nonce length {len(nonce)}")
    lib = native.load()
    kp, _k = native.in_ptr(key)
    np_, _n = native.in_ptr(nonce)
    pp, _p = native.in_ptr(data)
    op, out = native.out_buf(len(data) + TAG_LEN)
    lib.xchacha20poly1305_encrypt(kp, np_, None, 0, pp, len(data), op)
    return out.tobytes()


def open_raw(key: bytes, nonce: bytes, ct: bytes) -> bytes:
    """Inverse of :func:`seal_raw`; raises AeadError on tag mismatch."""
    _check_key(key)
    if len(nonce) != NONCE_LEN or len(ct) < TAG_LEN:
        raise AeadError("malformed EncBox (nonce/ciphertext lengths)")
    lib = native.load()
    kp, _k = native.in_ptr(key)
    np_, _n = native.in_ptr(nonce)
    cp, _c = native.in_ptr(ct)
    op, out = native.out_buf(len(ct) - TAG_LEN)
    rc = lib.xchacha20poly1305_decrypt(kp, np_, None, 0, cp, len(ct), op)
    if rc != 0:
        raise AeadError("authentication failed (wrong key or tampered data)")
    return out.tobytes()


def encrypt_blob(key: bytes, data: bytes) -> bytes:
    """Synchronous seal: data → raw-serialized versioned EncBox envelope."""
    nonce = secrets.token_bytes(NONCE_LEN)
    box = codec.pack([nonce, seal_raw(key, nonce, data)])
    return VersionBytes(XCHACHA_DATA_VERSION_1, box).serialize()


def decrypt_blob(key: bytes, blob: bytes) -> bytes:
    """Synchronous open: raises AeadError on tag mismatch."""
    _check_key(key)
    # any malformed framing is an auth failure to callers — attacker-shaped
    # input must surface as AeadError, never a raw codec exception
    try:
        vb = VersionBytes.deserialize(blob).ensure_version(XCHACHA_DATA_VERSION_1)
        nonce, ct = codec.unpack(vb.content)
        nonce, ct = bytes(nonce), bytes(ct)
    except Exception as e:
        raise AeadError(f"malformed EncBox: {e}") from e
    return open_raw(key, nonce, ct)


def decrypt_blobs_packed(key: bytes, blobs: list, n_threads: int = 0):
    """Bulk open to ONE cleartext buffer: ``(buffer, offsets)``, with
    ``offsets`` a ``(n + 1,)`` uint64 array (blob i's cleartext is
    ``buffer[offsets[i]:offsets[i + 1]]``).  The columnar decoders take
    the pair as it is, so nothing builds one Python object per blob
    between decrypt and decode.  Every envelope is parsed and decrypted
    natively on ``n_threads`` threads (0 = from the core count, at most
    32).  Raises AeadError when any envelope is malformed or fails to
    authenticate (callers isolate the file per blob)."""
    _check_key(key)
    lib = native.load()
    n = len(blobs)
    if n == 0:
        return np.zeros(0, np.uint8), np.zeros(1, np.uint64)
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    big = b"".join(blobs)
    boffs = np.zeros(n + 1, np.uint64)
    np.cumsum(np.fromiter((len(b) for b in blobs), np.uint64, count=n),
              out=boffs[1:])
    bp, _b = native.in_ptr(big)
    vp, _v = native.in_ptr(XCHACHA_DATA_VERSION_1)
    nonce_offs = np.zeros(n, np.uint64)
    ct_offs = np.zeros(n, np.uint64)
    ct_lens = np.zeros(n, np.uint64)
    total_clear = int(lib.encbox_parse_batch(
        bp, boffs.ctypes.data_as(native.u64p), n, vp,
        nonce_offs.ctypes.data_as(native.u64p),
        ct_offs.ctypes.data_as(native.u64p),
        ct_lens.ctypes.data_as(native.u64p),
    ))
    if total_clear < 0:
        raise AeadError(f"malformed EncBox in a batch of {n} blobs")
    out_offs = np.zeros(n + 1, np.uint64)
    np.cumsum(ct_lens - TAG_LEN, out=out_offs[1:])
    op, out = native.out_buf(total_clear)
    kp, _k = native.in_ptr(key)
    ok = np.zeros(n, np.uint8)
    failures = lib.encbox_decrypt_scatter_mt(
        kp, bp,
        nonce_offs.ctypes.data_as(native.u64p),
        ct_offs.ctypes.data_as(native.u64p),
        ct_lens.ctypes.data_as(native.u64p),
        n, op,
        out_offs.ctypes.data_as(native.u64p),
        ok.ctypes.data_as(native.u8p), n_threads,
    )
    if failures:
        bad = int(np.flatnonzero(ok == 0)[0])
        raise AeadError(
            f"authentication failed on {failures}/{n} blobs (first: #{bad})"
        )
    return out, out_offs


def decrypt_blobs(key: bytes, blobs: list) -> list:
    """Bulk open (:func:`decrypt_blobs_packed`) as a list of
    **memoryviews**: zero-copy slices of the one cleartext buffer.  Treat
    them as transient — each view pins the whole buffer, and they are
    unhashable — and ``bytes(view)`` anything you keep.  Raises AeadError
    when any envelope is malformed or fails to authenticate."""
    out, out_offs = decrypt_blobs_packed(key, blobs)
    view = memoryview(out)
    lo_hi = out_offs.tolist()
    return [view[lo_hi[i] : lo_hi[i + 1]] for i in range(len(blobs))]


class XChaChaCryptor(Cryptor):
    async def gen_key(self) -> VersionBytes:
        return VersionBytes(XCHACHA_KEY_VERSION_1, secrets.token_bytes(KEY_LEN))

    async def encrypt(self, key: VersionBytes, data: bytes) -> bytes:
        key.ensure_version(XCHACHA_KEY_VERSION_1)
        return await asyncio.to_thread(encrypt_blob, key.content, data)

    async def decrypt(self, key: VersionBytes, data: bytes) -> bytes:
        key.ensure_version(XCHACHA_KEY_VERSION_1)
        return await asyncio.to_thread(decrypt_blob, key.content, data)

    async def decrypt_batch(self, key: VersionBytes, blobs: list) -> list:
        key.ensure_version(XCHACHA_KEY_VERSION_1)
        return await asyncio.to_thread(decrypt_blobs, key.content, blobs)

    def decrypt_batch_fn(self, key: VersionBytes):
        """The sync bulk open behind :meth:`decrypt_batch`, bound to
        ``key`` (the fold service's one-hop decrypt of many tenants)."""
        key.ensure_version(XCHACHA_KEY_VERSION_1)
        material = key.content

        def call(blobs: list) -> list:
            return decrypt_blobs(material, blobs)

        return call
