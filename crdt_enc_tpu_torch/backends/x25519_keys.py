"""Recipient-keyed (asymmetric) key-cryptor backend with signed blobs: the
port's copy of ``crdt_enc_tpu/backends/x25519_keys.py``.

The real version of what the reference's gpgme backend intended and left as
a stub (crdt-enc-gpgme/src/lib.rs:131-175: the PGP encrypt-to-recipients
calls are commented out; its unused ``Meta`` CRDT at lib.rs:51-66 was a set
of recipient fingerprints): the serialized Keys CRDT is sealed *to a set of
recipient identities* and *signed by the writer*, so replicas never share a
secret out of band — each holds its own identity keypair, and adding a
device means adding its public identity to the roster.

Threat model: the storage layer is UNTRUSTED.  Confidentiality comes from
the recipient seal; integrity and roster trust come from the signature: a
blob is accepted only if signed by an identity this replica already
trusts, so hostile storage can neither tamper with blobs, forge Keys
metadata, nor poison the roster (recipients are unioned only from blobs
whose signature verified).  Trust is anchored at the locally configured
roster and grows only through blobs trusted identities signed.

Identity = X25519 (sealing) + Ed25519 (signing); ``generate_identity()``
returns 64-byte (private, public) bundles (x ‖ ed halves), in the raw key
forms of the JAX package's ``cryptography`` keys, so a bundle made by
either package works in the other.

Wrap format (content under ``X25519_KEYS_META_VERSION_1``), in the packer
of ``utils.codec`` (the same bytes in both packages):

    pack([body, signer_pub_bundle, signature])
    body = pack([eph_pub, sealed, roster, {x_pub: nonce ‖ wrapped_key}])

One random 32-byte blob key seals the Keys blob through the native
XChaCha20-Poly1305 envelope; per recipient the blob key is wrapped under
the IETF ChaCha20-Poly1305 (the native ``chacha20poly1305_encrypt``) with
``HKDF-SHA256(X25519(eph_priv, recipient_x_pub), info = tag ‖ eph_pub ‖
recipient_x_pub)``.  The Ed25519 signature covers the whole body.  The
ephemeral keypair is fresh per write, so identical Keys produce distinct
blobs — convergence happens at the CRDT layer after unwrap.

The JAX module takes X25519, Ed25519 and HKDF from ``cryptography``; the
port's are written out in ``_curves.py`` over Python integers, which are
not constant-time (see that module).  They run once per Keys write or
read.

Revocation: construct with ``pin_recipients=True`` (no roster growth),
drop the revoked identity, and ``core.rotate_key()``.
"""

from __future__ import annotations

import secrets

from ..utils import codec
from ..utils.versions import (
    SUPPORTED_X25519_KEYS_META_VERSIONS,
    X25519_KEYS_META_VERSION_1,
)
from . import _curves, xchacha
from .plain_keys import PlainKeyCryptor

_HKDF_TAG = b"crdt-enc-tpu x25519 keys v1"
HALF_LEN = 32
BUNDLE_LEN = 64  # x25519 half ‖ ed25519 half
_NONCE_LEN = 12


class NotARecipient(Exception):
    """This replica's identity is not in the blob's recipient set (or the
    blob is malformed / fails AEAD authentication)."""


class UntrustedSigner(Exception):
    """The blob's signature is missing/invalid, or the signer is not a
    trusted identity."""


def generate_identity() -> tuple[bytes, bytes]:
    """A fresh identity: 64-byte (private, public) bundles, each the
    X25519 half followed by the Ed25519 half."""
    x = secrets.token_bytes(HALF_LEN)
    ed = secrets.token_bytes(HALF_LEN)
    return x + ed, _public_of(x, ed)


def _public_of(x_priv: bytes, ed_priv: bytes) -> bytes:
    return _curves.x25519_public(x_priv) + _curves.ed25519_public(ed_priv)


def _split(bundle: bytes, what: str) -> tuple[bytes, bytes]:
    bundle = bytes(bundle)
    if len(bundle) != BUNDLE_LEN:
        raise ValueError(f"{what} bundle must be {BUNDLE_LEN} bytes")
    return bundle[:HALF_LEN], bundle[HALF_LEN:]


def _kek(shared: bytes, eph_pub: bytes, recipient_x_pub: bytes) -> bytes:
    return _curves.hkdf_sha256(
        shared, length=32, salt=None,
        info=_HKDF_TAG + eph_pub + recipient_x_pub,
    )


def wrap_blob(raw: bytes, recipients: list[bytes], signer_priv: bytes) -> bytes:
    """Seal ``raw`` to every recipient identity and sign as ``signer_priv``."""
    if not recipients:
        raise ValueError("at least one recipient identity required")
    sx_priv, sed_priv = _split(signer_priv, "signer private")
    blob_key = secrets.token_bytes(xchacha.KEY_LEN)
    sealed = xchacha.encrypt_blob(blob_key, raw)
    eph = secrets.token_bytes(HALF_LEN)
    eph_pub = _curves.x25519_public(eph)
    roster = []
    wraps = {}
    for bundle in recipients:
        x_pub, _ = _split(bundle, "recipient public")
        roster.append(bytes(bundle))
        shared = _curves.x25519_exchange(eph, x_pub)
        nonce = secrets.token_bytes(_NONCE_LEN)
        wraps[x_pub] = nonce + xchacha.ietf_seal(
            _kek(shared, eph_pub, x_pub), nonce, blob_key
        )
    body = codec.pack([eph_pub, sealed, roster, wraps])
    signer_pub = _public_of(sx_priv, sed_priv)
    return codec.pack([body, signer_pub, _curves.ed25519_sign(sed_priv, body)])


def unwrap_blob(
    private_bundle: bytes, blob: bytes, trusted: set[bytes] | frozenset[bytes]
) -> tuple[bytes, list[bytes], bytes]:
    """Open a sealed Keys blob: verify the signer is trusted and the
    signature covers the body, then decrypt this replica's entry.

    Returns ``(cleartext, roster, signer_pub_bundle)`` — the verified
    recipient identity list, safe to union into a trust set.
    """
    my_x_priv, _ = _split(private_bundle, "private")
    try:
        body, signer_pub, sig = codec.unpack(blob)
        body, signer_pub, sig = bytes(body), bytes(signer_pub), bytes(sig)
        _, signer_ed = _split(signer_pub, "signer public")
    except Exception as e:
        raise UntrustedSigner(f"malformed signed wrap: {e}") from e
    if signer_pub not in trusted:
        raise UntrustedSigner("blob signed by an identity this replica does not trust")
    if not _curves.ed25519_verify(signer_ed, sig, body):
        raise UntrustedSigner("signature verification failed")

    my_x_pub = _curves.x25519_public(my_x_priv)
    try:
        eph_pub, sealed, roster, wraps = codec.unpack(body)
        eph_pub, sealed = bytes(eph_pub), bytes(sealed)
        if len(eph_pub) != HALF_LEN:
            raise ValueError("bad ephemeral public key length")
        roster = [bytes(b) for b in roster]
        if any(len(b) != BUNDLE_LEN for b in roster):
            raise ValueError("bad roster bundle length")
        entry = wraps.get(my_x_pub)
    except Exception as e:
        raise NotARecipient(f"malformed recipient wrap: {e}") from e
    if entry is None:
        raise NotARecipient(
            "this replica's identity is not in the blob's recipient set"
        )
    entry = bytes(entry)
    if len(entry) < _NONCE_LEN + 16:
        raise NotARecipient("recipient wrap entry too short")
    shared = _curves.x25519_exchange(my_x_priv, eph_pub)
    try:
        blob_key = xchacha.ietf_open(
            _kek(shared, eph_pub, my_x_pub), entry[:_NONCE_LEN],
            entry[_NONCE_LEN:],
        )
        return xchacha.decrypt_blob(blob_key, sealed), roster, signer_pub
    except xchacha.AeadError as e:
        raise NotARecipient(f"authentication failed: {e}") from e


class X25519KeyCryptor(PlainKeyCryptor):
    """Key management sealed to recipient identities and signed by the
    writer (no shared secret).

    ``private_bundle`` is this replica's 64-byte private identity
    (``generate_identity()``); ``recipients`` are the public identity
    bundles allowed to read key material — this replica's own identity is
    included automatically, so a lone replica needs no roster at all.

    Trust and roster converge grow-only by default: a blob is accepted
    only if signed by an already-trusted identity, and the rosters of
    accepted blobs are unioned in, so a device restarted with a stale
    config cannot lock peers out, while hostile storage can never inject
    identities.  ``pin_recipients=True`` freezes the roster for deliberate
    revocation (follow with ``core.rotate_key()``).
    """

    META_VERSION = X25519_KEYS_META_VERSION_1
    SUPPORTED_META_VERSIONS = SUPPORTED_X25519_KEYS_META_VERSIONS

    def __init__(
        self,
        private_bundle: bytes,
        recipients: list[bytes] = (),
        *,
        pin_recipients: bool = False,
    ):
        super().__init__()
        self._priv = bytes(private_bundle)
        _split(self._priv, "private")  # validate early
        my_pub = self.public_identity
        pubs = [bytes(p) for p in recipients]
        for p in pubs:
            _split(p, "recipient public")
        if my_pub not in pubs:
            pubs.append(my_pub)
        self._recipients = pubs
        self._pinned = pin_recipients

    @property
    def public_identity(self) -> bytes:
        return _public_of(*_split(self._priv, "private"))

    @property
    def recipients(self) -> tuple[bytes, ...]:
        return tuple(self._recipients)

    async def _protect(self, raw: bytes) -> bytes:
        return wrap_blob(raw, self._recipients, self._priv)

    async def _unprotect(self, vb) -> bytes:
        clear, roster, _signer = unwrap_blob(
            self._priv, vb.content, trusted=set(self._recipients)
        )
        if not self._pinned:
            for pub in roster:
                if pub not in self._recipients:
                    self._recipients.append(pub)
        return clear

    def _trust_epoch(self):
        # roster growth is monotone (append-only unless pinned), so the
        # length is a valid fixpoint epoch for set_remote_meta's re-decode
        return len(self._recipients)

    # A register may hold concurrent values some of which this replica
    # cannot open (e.g. one written by a stale process sealing only to
    # itself).  Readable values must still decode — skipping the
    # unreadable value is safe because its writer re-converges its own
    # keys on its next write.
    DECODE_TOLERATES = (NotARecipient, UntrustedSigner)
