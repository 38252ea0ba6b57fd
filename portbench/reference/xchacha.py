"""XChaCha20-Poly1305 in NumPy and Python integers, for the reference.

RFC 8439 (ChaCha20, Poly1305, their AEAD) with the extended nonce of
draft-irtf-cfrg-xchacha (HChaCha20 subkey, nonce ``0^4 || n[16:24]``).
The keystream runs vectorised over blocks; Poly1305 runs over Python
integers.  Only the open is needed: the reference reads what the program
sealed.
"""

from __future__ import annotations

import numpy as np

SIGMA = np.array([0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], np.uint32)
P1305 = (1 << 130) - 5
CLAMP = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


class TagMismatch(Exception):
    """The Poly1305 tag does not authenticate the ciphertext."""


def _rotl(x, n: int):
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _rounds(x) -> None:
    """Twenty rounds in place on a (16, ...) uint32 state."""

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] += x[b]
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] += x[d]
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)


def _words(b: bytes) -> np.ndarray:
    return np.frombuffer(b, "<u4").astype(np.uint32)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    x = np.concatenate([SIGMA, _words(key), _words(nonce16)]).reshape(16, 1)
    with np.errstate(over="ignore"):
        _rounds(x)
    return np.concatenate([x[0:4, 0], x[12:16, 0]]).astype("<u4").tobytes()


def keystream(key: bytes, nonce12: bytes, counter: int, nblocks: int) -> bytes:
    """``nblocks`` ChaCha20 blocks from block ``counter`` on."""
    init = np.empty((16, nblocks), np.uint32)
    init[0:4] = SIGMA[:, None]
    init[4:12] = _words(key)[:, None]
    init[12] = (np.arange(nblocks, dtype=np.uint64) + counter).astype(np.uint32)
    init[13:16] = _words(nonce12)[:, None]
    x = init.copy()
    with np.errstate(over="ignore"):
        _rounds(x)
        x += init
    return x.T.astype("<u4").tobytes()


def poly1305(key: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key[:16], "little") & CLAMP
    s = int.from_bytes(key[16:32], "little")
    acc = 0
    full = len(msg) // 16 * 16
    hi = 1 << 128
    frombytes = int.from_bytes
    for i in range(0, full, 16):
        acc = (acc + frombytes(msg[i:i + 16], "little") + hi) * r % P1305
    if full < len(msg):
        tail = msg[full:]
        acc = (acc + frombytes(tail, "little") + (1 << (8 * len(tail)))) * r % P1305
    return ((acc + s) % (1 << 128)).to_bytes(16, "little")


def _pad16(n: int) -> bytes:
    return b"\0" * (-n % 16)


def open_xchacha(key: bytes, nonce: bytes, ct_tag: bytes, aad: bytes = b"") -> bytes:
    """XChaCha20-Poly1305 open; raises :class:`TagMismatch`."""
    if len(key) != 32 or len(nonce) != 24 or len(ct_tag) < 16:
        raise TagMismatch("malformed key, nonce or ciphertext")
    sub = hchacha20(key, nonce[:16])
    n12 = b"\0\0\0\0" + nonce[16:24]
    ct, tag = ct_tag[:-16], ct_tag[-16:]
    otk = keystream(sub, n12, 0, 1)[:32]
    mac = (aad + _pad16(len(aad)) + ct + _pad16(len(ct))
           + len(aad).to_bytes(8, "little") + len(ct).to_bytes(8, "little"))
    if poly1305(otk, mac) != tag:
        raise TagMismatch("Poly1305 tag mismatch")
    nblocks = -(-len(ct) // 64)
    ks = np.frombuffer(keystream(sub, n12, 1, nblocks), np.uint8)[:len(ct)]
    return (np.frombuffer(ct, np.uint8) ^ ks).tobytes()
