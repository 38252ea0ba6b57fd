"""X25519, Ed25519 and HKDF-SHA256 for the recipient-keyed key cryptor.

The JAX package takes these three primitives from the third-party
``cryptography`` package (``crdt_enc_tpu/backends/x25519_keys.py``); the
port writes them here from their RFCs, over Python integers, ``hashlib``
and ``hmac``, so it needs nothing beyond the standard library:

* **X25519** (RFC 7748 §5): the clamped scalar, the Montgomery ladder over
  the u-coordinate, 32-byte little-endian wire forms.  A private key is 32
  unclamped random bytes, as ``cryptography``'s ``private_bytes_raw``
  gives it; clamping happens at every use.  An all-zero shared secret (a
  small-order peer key) raises ``ValueError``, as ``cryptography``'s
  ``exchange`` does.
* **Ed25519** (RFC 8032 §5.1): a private key is its 32-byte seed; SHA-512
  of the seed gives the clamped scalar and the nonce prefix; signing is
  deterministic, so both packages give the same 64 bytes for one key and
  message.  Verification is cofactorless: it rejects ``S >= L``, a public
  key that does not decode (y not below p, x not on the curve, or x = 0
  with its sign bit set), and accepts only where the encoding of
  ``[S]B - [k]A`` equals the signature's R bytes.
* **HKDF-SHA256** (RFC 5869): extract then expand; ``salt=None`` means 32
  zero bytes.

None of this is constant-time: Python integers take time that depends on
their values.  The cryptor uses these once per Keys write or read (a key
rotation, a roster change), on a replica's own keys; a caller that needs
timing-side-channel resistance must not use them on secret data an
attacker can time repeatedly.
"""

from __future__ import annotations

import hashlib
import hmac

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
_A24 = 121665
_D = -121665 * pow(121666, P - 2, P) % P
_SQRT_M1 = pow(2, (P - 1) // 4, P)

KEY_LEN = 32
SIG_LEN = 64


def _int(b: bytes) -> int:
    return int.from_bytes(b, "little")


def _bytes(n: int) -> bytes:
    return n.to_bytes(32, "little")


def _check_len(b: bytes, what: str) -> bytes:
    b = bytes(b)
    if len(b) != KEY_LEN:
        raise ValueError(f"{what} must be {KEY_LEN} bytes")
    return b


# ---- X25519 (RFC 7748) ------------------------------------------------------


def _clamp(k: bytes) -> int:
    k = bytearray(k)
    k[0] &= 248
    k[31] &= 127
    k[31] |= 64
    return _int(k)


def _ladder(k: int, u: int) -> int:
    """RFC 7748 §5's Montgomery ladder: the u-coordinate of [k]u."""
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in range(254, -1, -1):
        bit = (k >> t) & 1
        swap ^= bit
        if swap:
            x2, x3, z2, z3 = x3, x2, z3, z2
        swap = bit
        a = (x2 + z2) % P
        aa = a * a % P
        b = (x2 - z2) % P
        bb = b * b % P
        e = (aa - bb) % P
        c = (x3 + z3) % P
        d = (x3 - z3) % P
        da = d * a % P
        cb = c * b % P
        x3 = (da + cb) % P
        x3 = x3 * x3 % P
        z3 = (da - cb) % P
        z3 = x1 * (z3 * z3 % P) % P
        x2 = aa * bb % P
        z2 = e * (aa + _A24 * e) % P
    if swap:
        x2, z2 = x3, z3
    return x2 * pow(z2, P - 2, P) % P


def x25519(scalar: bytes, u: bytes) -> bytes:
    """The bare function X25519(k, u) of RFC 7748 §5: 32 bytes each way.
    The u-coordinate's top bit is masked and a value past p is reduced,
    as the RFC says."""
    scalar = _check_len(scalar, "X25519 scalar")
    u = bytearray(_check_len(u, "X25519 u-coordinate"))
    u[31] &= 127
    return _bytes(_ladder(_clamp(scalar), _int(u) % P))


def x25519_public(private: bytes) -> bytes:
    """The public key of a 32-byte X25519 private key: X25519(k, 9)."""
    return x25519(private, _bytes(9))


def x25519_exchange(private: bytes, peer_public: bytes) -> bytes:
    """The shared secret; raises ValueError where it is all zeros (a
    small-order peer key)."""
    shared = x25519(private, peer_public)
    if shared == bytes(KEY_LEN):
        raise ValueError("X25519 shared secret is all zeros (small-order "
                         "peer key)")
    return shared


# ---- Ed25519 (RFC 8032) -----------------------------------------------------

# points in extended coordinates (X, Y, Z, T) with x = X/Z, y = Y/Z,
# x*y = T/Z
_IDENT = (0, 1, 1, 0)


def _add(p1, p2):
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = 2 * t1 * t2 * _D % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _double(p1):
    x1, y1, z1, _ = p1
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    h = a + b
    e = h - (x1 + y1) * (x1 + y1) % P
    g = a - b
    f = c + g
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def _mul(k: int, pt):
    q = _IDENT
    while k > 0:
        if k & 1:
            q = _add(q, pt)
        pt = _double(pt)
        k >>= 1
    return q


def _recover_x(y: int, sign: int) -> int | None:
    if y >= P:
        return None
    x2 = (y * y - 1) * pow(_D * y * y + 1, P - 2, P) % P
    if x2 == 0:
        return None if sign else 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * _SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if (x & 1) != sign:
        x = P - x
    return x


_BY = 4 * pow(5, P - 2, P) % P
_BX = _recover_x(_BY, 0)
_B = (_BX, _BY, 1, _BX * _BY % P)


def _compress(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return _bytes(y | ((x & 1) << 255))


def _decompress(s: bytes):
    y = _int(s)
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def _expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    return _clamp(h[:32]), h[32:]


def _hash_int(*parts: bytes) -> int:
    return _int(hashlib.sha512(b"".join(parts)).digest()) % L


def ed25519_public(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte Ed25519 seed."""
    a, _ = _expand(_check_len(seed, "Ed25519 private key"))
    return _compress(_mul(a, _B))


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    """The deterministic 64-byte signature ``R ‖ S`` of RFC 8032 §5.1.6."""
    a, prefix = _expand(_check_len(seed, "Ed25519 private key"))
    pub = _compress(_mul(a, _B))
    msg = bytes(msg)
    r = _hash_int(prefix, msg)
    rb = _compress(_mul(r, _B))
    s = (r + _hash_int(rb, pub, msg) * a) % L
    return rb + _bytes(s)


def ed25519_verify(public: bytes, sig: bytes, msg: bytes) -> bool:
    """RFC 8032 §5.1.7, cofactorless, with the checks the module names."""
    public, sig = bytes(public), bytes(sig)
    if len(public) != KEY_LEN or len(sig) != SIG_LEN:
        return False
    a_pt = _decompress(public)
    if a_pt is None:
        return False
    s = _int(sig[32:])
    if s >= L:
        return False
    k = _hash_int(sig[:32], public, bytes(msg))
    neg_a = ((-a_pt[0]) % P, a_pt[1], a_pt[2], (-a_pt[3]) % P)
    check = _add(_mul(s, _B), _mul(k, neg_a))
    return _compress(check) == sig[:32]


# ---- HKDF-SHA256 (RFC 5869) ---------------------------------------------------


def hkdf_sha256(ikm: bytes, *, length: int, salt: bytes | None = None,
                info: bytes = b"") -> bytes:
    if not 0 < length <= 255 * 32:
        raise ValueError(f"HKDF-SHA256 length must be in 1..{255 * 32}")
    if salt is None:
        salt = bytes(32)
    prk = hmac.new(bytes(salt), bytes(ikm), hashlib.sha256).digest()
    out, block = b"", b""
    for i in range(1, -(-length // 32) + 1):
        block = hmac.new(prk, block + bytes(info) + bytes([i]),
                         hashlib.sha256).digest()
        out += block
    return out[:length]
