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
(``decrypt_blobs_packed``; ``decrypt_blobs`` slices it into views);
``decrypt_blobs_chunked`` yields such buffers chunk by chunk, decrypting
the next on a worker thread.  The JAX package's C-API lengths pass and
its pointer-array route for large blobs are not copied.
"""

from __future__ import annotations

import asyncio
import contextvars
import os
import secrets

import numpy as np

from .. import native
from ..core.cryptor import Cryptor
from ..utils import codec, trace
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


def _seal(encrypt: str, nonce_len: int, key: bytes, nonce: bytes,
          data: bytes, aad: bytes = b"") -> bytes:
    _check_key(key)
    if len(nonce) != nonce_len:
        raise AeadError(f"invalid nonce length {len(nonce)}")
    lib = native.load()
    kp, _k = native.in_ptr(key)
    np_, _n = native.in_ptr(nonce)
    ap, _a = native.in_ptr(aad)
    pp, _p = native.in_ptr(data)
    op, out = native.out_buf(len(data) + TAG_LEN)
    getattr(lib, encrypt)(kp, np_, ap, len(aad), pp, len(data), op)
    return out.tobytes()


def _open(decrypt: str, nonce_len: int, key: bytes, nonce: bytes, ct: bytes,
          aad: bytes = b"") -> bytes:
    _check_key(key)
    if len(nonce) != nonce_len or len(ct) < TAG_LEN:
        raise AeadError("malformed EncBox (nonce/ciphertext lengths)")
    lib = native.load()
    kp, _k = native.in_ptr(key)
    np_, _n = native.in_ptr(nonce)
    ap, _a = native.in_ptr(aad)
    cp, _c = native.in_ptr(ct)
    op, out = native.out_buf(len(ct) - TAG_LEN)
    if getattr(lib, decrypt)(kp, np_, ap, len(aad), cp, len(ct), op) != 0:
        raise AeadError("authentication failed (wrong key or tampered data)")
    return out.tobytes()


def seal_raw(key: bytes, nonce: bytes, data: bytes) -> bytes:
    """The bare AEAD: XChaCha20-Poly1305 seal with an explicit nonce,
    returning ``ct ‖ tag`` (no envelope), for callers speaking a foreign
    framing (the reference-remote import and export tools)."""
    return _seal("xchacha20poly1305_encrypt", NONCE_LEN, key, nonce, data)


def open_raw(key: bytes, nonce: bytes, ct: bytes) -> bytes:
    """Inverse of :func:`seal_raw`; raises AeadError on tag mismatch."""
    return _open("xchacha20poly1305_decrypt", NONCE_LEN, key, nonce, ct)


IETF_NONCE_LEN = 12


def ietf_seal(key: bytes, nonce: bytes, data: bytes, aad: bytes = b"") -> bytes:
    """The IETF ChaCha20-Poly1305 AEAD of RFC 8439 §2.8 (12-byte nonce),
    returning ``ct ‖ tag``: the X25519 key cryptor's per-recipient key
    wrap (backends/x25519_keys.py)."""
    return _seal("chacha20poly1305_encrypt", IETF_NONCE_LEN, key, nonce, data,
                 aad)


def ietf_open(key: bytes, nonce: bytes, ct: bytes, aad: bytes = b"") -> bytes:
    """Inverse of :func:`ietf_seal`; raises AeadError on tag mismatch."""
    return _open("chacha20poly1305_decrypt", IETF_NONCE_LEN, key, nonce, ct,
                 aad)


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


def decrypt_blobs(key: bytes, blobs: list, n_threads: int = 0) -> list:
    """Bulk open (:func:`decrypt_blobs_packed`, ``n_threads`` native
    threads, 0 = from the core count) as a list of **memoryviews**:
    zero-copy slices of the one cleartext buffer.  Treat them as
    transient — each view pins the whole buffer, and they are unhashable
    — and ``bytes(view)`` anything you keep.  Raises AeadError when any
    envelope is malformed or fails to authenticate."""
    out, out_offs = decrypt_blobs_packed(key, blobs, n_threads)
    view = memoryview(out)
    lo_hi = out_offs.tolist()
    return [view[lo_hi[i] : lo_hi[i + 1]] for i in range(len(blobs))]


def decrypt_blobs_chunked(
    key: bytes, blobs: list, *, chunk_blobs: int = 0, n_chunks: int = 8,
    n_threads: int = 0,
):
    """Yield decrypted chunks, each a packed ``(buffer, offsets)`` pair of
    :func:`decrypt_blobs_packed` (``n_threads`` native threads a chunk,
    0 = from the core count), with one-chunk lookahead: chunk i+1
    decrypts on a worker thread (the native batch call releases the GIL)
    while the consumer decodes chunk i.  Feeds
    ``TorchAccelerator.fold_payload_stream``.  Each chunk's decrypt is a
    ``stream.decrypt`` span tagged with the chunk index.  The same errors
    as :func:`decrypt_blobs_packed`, raised at the failing chunk."""
    from concurrent.futures import ThreadPoolExecutor

    n = len(blobs)
    if n == 0:
        return
    if chunk_blobs <= 0:
        chunk_blobs = max(1, -(-n // max(n_chunks, 1)))
    spans = [blobs[i : i + chunk_blobs] for i in range(0, n, chunk_blobs)]

    def open_chunk(k):
        with trace.span("stream.decrypt", meta=k):
            return decrypt_blobs_packed(key, spans[k], n_threads)

    if (os.cpu_count() or 1) <= 1:
        # one core: a lookahead thread overlaps nothing and only adds
        # executor overhead, so decrypt synchronously
        for k in range(len(spans)):
            yield open_chunk(k)
        return

    def submit(k):
        # in a copy of the caller's context: the span sits in its tree
        return ex.submit(contextvars.copy_context().run, open_chunk, k)

    with ThreadPoolExecutor(1) as ex:
        fut = submit(0)
        for i in range(len(spans)):
            nxt = submit(i + 1) if i + 1 < len(spans) else None
            yield fut.result()
            fut = nxt


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
