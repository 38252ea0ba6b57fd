"""The port's X25519 key cryptor against the JAX package's, on the CPU.

The JAX module takes X25519, Ed25519, HKDF-SHA256 and the IETF
ChaCha20-Poly1305 from ``cryptography``; the port writes them out.  Here,
on inputs made from a numpy seed: each primitive equals ``cryptography``'s
byte for byte (public keys, shared secrets, deterministic signatures,
derived keys, sealed boxes) and verification agrees on tampered and
non-canonical signatures; a blob either package wraps, the other unwraps;
an identity bundle gives the same public bundle in both; and a remote
keyed by either package's cryptor opens in the other, with equal
canonical bytes both ways.  tests/test_torch_x25519_keys.py holds the RFC
vectors without JAX or ``cryptography``.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

pytest.importorskip(
    "cryptography",
    reason="the JAX package's x25519_keys backend needs the cryptography wheel",
)

from cryptography.exceptions import InvalidSignature  # noqa: E402
from cryptography.hazmat.primitives import hashes  # noqa: E402
from cryptography.hazmat.primitives.asymmetric.ed25519 import (  # noqa: E402
    Ed25519PrivateKey,
    Ed25519PublicKey,
)
from cryptography.hazmat.primitives.asymmetric.x25519 import (  # noqa: E402
    X25519PrivateKey,
    X25519PublicKey,
)
from cryptography.hazmat.primitives.ciphers.aead import (  # noqa: E402
    ChaCha20Poly1305,
)
from cryptography.hazmat.primitives.kdf.hkdf import HKDF  # noqa: E402

from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor  # noqa: E402
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote  # noqa: E402
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage  # noqa: E402
from crdt_enc_tpu.backends import x25519_keys as jx  # noqa: E402
from crdt_enc_tpu.core import Core as JCore  # noqa: E402
from crdt_enc_tpu.core import OpenOptions as JOpenOptions  # noqa: E402
from crdt_enc_tpu.core import orset_adapter as j_orset_adapter  # noqa: E402
from crdt_enc_tpu.core.adapters import HostAccelerator as JHostAccelerator  # noqa: E402
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes  # noqa: E402
from crdt_enc_tpu.utils import codec as jcodec  # noqa: E402
from crdt_enc_tpu_torch import (  # noqa: E402
    Core,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    TorchAccelerator,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.backends import IdentityCryptor  # noqa: E402
from crdt_enc_tpu_torch.backends import _curves, xchacha  # noqa: E402
from crdt_enc_tpu_torch.backends import x25519_keys as px  # noqa: E402
from crdt_enc_tpu_torch.utils import codec  # noqa: E402
from crdt_enc_tpu_torch.utils.versions import (  # noqa: E402
    DEFAULT_DATA_VERSION_1,
    SUPPORTED_X25519_KEYS_META_VERSIONS,
    X25519_KEYS_META_VERSION_1,
)

SEED = 16
N_CASES = 24


def run(coro):
    return asyncio.run(coro)


def seeded_bytes(seed: int, *sizes: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes]


CASES = [seeded_bytes(SEED * 1000 + i, 32, 32, 32, 1 + 37 * i, 12, 9 * i)
         for i in range(N_CASES)]


def test_meta_version_and_wire_constants_match():
    from crdt_enc_tpu.utils import versions as jv

    assert X25519_KEYS_META_VERSION_1 == jv.X25519_KEYS_META_VERSION_1
    assert SUPPORTED_X25519_KEYS_META_VERSIONS == \
        jv.SUPPORTED_X25519_KEYS_META_VERSIONS
    assert px.X25519KeyCryptor.META_VERSION == jx.X25519KeyCryptor.META_VERSION
    assert (px._HKDF_TAG, px.HALF_LEN, px.BUNDLE_LEN, px._NONCE_LEN) == \
        (jx._HKDF_TAG, jx.HALF_LEN, jx.BUNDLE_LEN, jx._NONCE_LEN)


@pytest.mark.parametrize("i", range(N_CASES))
def test_primitives_equal_cryptography(i):
    x_priv, ed_seed, peer, msg, nonce, aad = CASES[i]
    xk = X25519PrivateKey.from_private_bytes(x_priv)
    assert _curves.x25519_public(x_priv) == xk.public_key().public_bytes_raw()
    peer_pub = X25519PrivateKey.from_private_bytes(peer).public_key()
    assert _curves.x25519_exchange(x_priv, peer_pub.public_bytes_raw()) == \
        xk.exchange(peer_pub)
    ek = Ed25519PrivateKey.from_private_bytes(ed_seed)
    ed_pub = ek.public_key().public_bytes_raw()
    assert _curves.ed25519_public(ed_seed) == ed_pub
    sig = _curves.ed25519_sign(ed_seed, msg)
    assert sig == ek.sign(msg)
    assert _curves.ed25519_verify(ed_pub, sig, msg)
    info = msg[:40]
    assert _curves.hkdf_sha256(peer, length=32, salt=None, info=info) == HKDF(
        algorithm=hashes.SHA256(), length=32, salt=None, info=info
    ).derive(peer)
    sealed = xchacha.ietf_seal(x_priv, nonce, msg, aad)
    assert sealed == ChaCha20Poly1305(x_priv).encrypt(nonce, msg, aad)
    assert xchacha.ietf_open(x_priv, nonce, sealed, aad) == msg


def _crypto_verifies(pub: bytes, sig: bytes, msg: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except InvalidSignature:
        return False


@pytest.mark.parametrize("i", range(0, N_CASES, 4))
def test_verification_agrees_with_cryptography(i):
    _, ed_seed, _, msg, _, _ = CASES[i]
    pub = _curves.ed25519_public(ed_seed)
    sig = _curves.ed25519_sign(ed_seed, msg)
    s = int.from_bytes(sig[32:], "little")
    variants = [
        sig,
        sig[:32] + (s + _curves.L).to_bytes(32, "little"),  # S not canonical
        bytes([sig[0] ^ 1]) + sig[1:],  # R tampered
        sig[:32] + bytes([sig[32] ^ 1]) + sig[33:],  # S tampered
    ]
    for v in variants:
        assert _curves.ed25519_verify(pub, v, msg) == _crypto_verifies(
            pub, v, msg)
        assert _curves.ed25519_verify(pub, v, msg + b"!") == _crypto_verifies(
            pub, v, msg + b"!")


def _bundle(x_priv: bytes, ed_seed: bytes) -> bytes:
    return x_priv + ed_seed


@pytest.mark.parametrize("i", range(0, N_CASES, 3))
def test_identity_bundles_give_equal_public_bundles(i):
    x_priv, ed_seed = CASES[i][:2]
    priv = _bundle(x_priv, ed_seed)
    assert px.X25519KeyCryptor(priv).public_identity == \
        jx.X25519KeyCryptor(priv).public_identity


@pytest.mark.parametrize("maker", ["jax", "port"])
def test_generated_identities_work_in_the_other_package(maker):
    gen = jx.generate_identity if maker == "jax" else px.generate_identity
    priv, pub = gen()
    other = px if maker == "jax" else jx
    assert other.X25519KeyCryptor(priv).public_identity == pub


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wraps_open_across_packages(direction):
    wrapper, opener = (jx, px) if direction == "jax_to_port" else (px, jx)
    x_a, ed_a, x_b = CASES[0][:3]
    ed_b = CASES[1][1]
    priv_a, priv_b = _bundle(x_a, ed_a), _bundle(x_b, ed_b)
    pub_a = px.X25519KeyCryptor(priv_a).public_identity
    pub_b = px.X25519KeyCryptor(priv_b).public_identity
    blob = wrapper.wrap_blob(b"the keys crdt", [pub_a, pub_b], priv_a)
    for priv in (priv_a, priv_b):
        clear, roster, signer = opener.unwrap_blob(priv, blob, {pub_a, pub_b})
        assert clear == b"the keys crdt"
        assert roster == [pub_a, pub_b] and signer == pub_a
    # the signature over the body is the same in both packages
    body, signer_pub, sig = codec.unpack(blob)
    assert sig == _curves.ed25519_sign(ed_a, bytes(body))
    assert sig == Ed25519PrivateKey.from_private_bytes(ed_a).sign(bytes(body))
    assert codec.pack([body, signer_pub, sig]) == jcodec.pack(
        [body, signer_pub, sig]) == blob
    # an outsider and an untrusted signer fail the same way in both
    outsider = _bundle(*CASES[2][:2])
    with pytest.raises(opener.NotARecipient):
        opener.unwrap_blob(outsider, blob, {pub_a})
    with pytest.raises(opener.UntrustedSigner):
        opener.unwrap_blob(priv_b, blob, {pub_b})


def _opts(remote, priv, recipients, create=True):
    return OpenOptions(
        storage=MemoryStorage(remote), cryptor=IdentityCryptor(),
        key_cryptor=px.X25519KeyCryptor(priv, recipients),
        adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=TorchAccelerator(device="cpu", min_device_batch=1),
    )


def _jopts(remote, priv, recipients, create=True):
    return JOpenOptions(
        storage=JMemoryStorage(remote), cryptor=JIdentityCryptor(),
        key_cryptor=jx.X25519KeyCryptor(priv, recipients),
        adapter=j_orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=JHostAccelerator(),
    )


def _copy_remote(src, cls):
    return cls(metas=dict(src.metas), states=dict(src.states),
               ops={a: dict(d) for a, d in src.ops.items()},
               deltas={a: dict(d) for a, d in src.deltas.items()})


@pytest.mark.parametrize("first", ["jax", "port"])
def test_x25519_remote_opens_in_the_other_package(first):
    """A remote keyed (and written) by one package's X25519 cryptor opens
    in the other under a second roster identity, with the same key and
    the same bytes; it takes a write there, the first reads it back, a
    rotation by the second reaches the first, and an identity outside
    the roster cannot open it in either."""
    priv_a, pub_a = px.generate_identity()
    priv_b, pub_b = jx.generate_identity()
    roster = [pub_a, pub_b]

    async def go():
        if first == "jax":
            jr = JMemoryRemote()
            a = await JCore.open(_jopts(jr, priv_a, roster))
            await a.update(lambda s: s.add_ctx(a.actor_id, b"x"))
            pr = _copy_remote(jr, MemoryRemote)
            b = await Core.open(_opts(pr, priv_b, roster))
        else:
            pr = MemoryRemote()
            b = await Core.open(_opts(pr, priv_b, roster))
            await b.update(lambda s: s.add_ctx(b.actor_id, b"x"))
            jr = _copy_remote(pr, JMemoryRemote)
            a = await JCore.open(_jopts(jr, priv_a, roster))
        ka, kb = a._data.keys.latest_key(), b._data.keys.latest_key()
        assert ka.id == kb.id and ka.material.content == kb.material.content
        await a.read_remote()
        await b.read_remote()
        assert a.with_state(j_canonical_bytes) == b.with_state(canonical_bytes)
        # the port writes and rotates; the JAX replica reads both back
        await b.rotate_key()
        await b.update(lambda s: s.add_ctx(b.actor_id, b"y"))
        jr.metas.update(pr.metas)
        for actor, files in pr.ops.items():
            jr.ops.setdefault(actor, {}).update(files)
        await a.read_remote()
        assert a.with_state(lambda s: set(s.members())) == {b"x", b"y"}
        assert a.with_state(j_canonical_bytes) == b.with_state(canonical_bytes)
        assert a._data.keys.latest_key().id == b._data.keys.latest_key().id
        priv_eve, _ = px.generate_identity()
        with pytest.raises(Exception) as ei:
            await Core.open(_opts(_copy_remote(jr, MemoryRemote), priv_eve,
                                  roster))
        assert type(ei.value).__name__ in ("NotARecipient", "CoreError")
        with pytest.raises(Exception) as ei:
            await JCore.open(_jopts(_copy_remote(pr, JMemoryRemote), priv_eve,
                                    roster))
        assert type(ei.value).__name__ in ("NotARecipient", "CoreError")

    run(go())
