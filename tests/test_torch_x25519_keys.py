"""The port's recipient-keyed key cryptor (X25519 + Ed25519 + HKDF) on the
CPU, with neither JAX nor ``cryptography``.

The port writes the three primitives out itself
(``crdt_enc_tpu_torch/backends/_curves.py``) and takes the 12-byte-nonce
AEAD from its native library, so this file holds their RFC test vectors
inline: RFC 7748 §5.2 (the two single-step vectors, 1 and 1,000 ladder
iterations) and §6.1, RFC 8032 §7.1 tests 1-3, RFC 5869 A.1-A.3 and RFC
8439 §2.8.2.  It imports neither JAX nor ``cryptography`` (the card's
machine has neither; tests/test_torch_isolation.py checks it), and a
subprocess shows the cryptor runs with ``cryptography`` barred.  Then the
13 cases of tests/test_x25519_keys.py, run on the port.  The cross-package
checks are in tests/test_torch_x25519_interop.py.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import uuid as uuidm

import pytest

from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    OpenOptions,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    orset_adapter,
)
from crdt_enc_tpu_torch.backends import _curves, xchacha
from crdt_enc_tpu_torch.backends.x25519_keys import (
    NotARecipient,
    UntrustedSigner,
    X25519KeyCryptor,
    generate_identity,
    unwrap_blob,
    wrap_blob,
)
from crdt_enc_tpu_torch.core.core import CoreError
from crdt_enc_tpu_torch.utils import codec
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
h = bytes.fromhex


def run(coro):
    return asyncio.run(coro)


# ---- RFC 7748: X25519 --------------------------------------------------------

X25519_VECTORS = [  # §5.2: (scalar, u-coordinate, output)
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]
X25519_ITERATED = {  # §5.2: k = u = 9, then k, u = X25519(k, u), k
    1: "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079",
    1000: "684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51",
}
X25519_DH = {  # §6.1
    "alice_priv": "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a",
    "alice_pub": "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a",
    "bob_priv": "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb",
    "bob_pub": "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f",
    "shared": "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742",
}

# ---- RFC 8032 §7.1: Ed25519, tests 1-3 ----------------------------------------

ED25519_VECTORS = [  # (secret key, public key, message, signature)
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
     "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
     "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
     "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]

# ---- RFC 5869 appendix A: HKDF-SHA256, A.1-A.3 ---------------------------------

HKDF_VECTORS = [  # (IKM, salt, info, L, OKM)
    (bytes([0x0B]) * 22, h("000102030405060708090a0b0c"),
     h("f0f1f2f3f4f5f6f7f8f9"), 42,
     "3cb25f25faacd57a90434f64d0362f2a2d2d0a90cf1a5a4c5db02d56ecc4c5bf"
     "34007208d5b887185865"),
    (bytes(range(0x00, 0x50)), bytes(range(0x60, 0xB0)),
     bytes(range(0xB0, 0x100)), 82,
     "b11e398dc80327a1c8e7f78c596a49344f012eda2d4efad8a050cc4c19afa97c"
     "59045a99cac7827271cb41c65e590e09da3275600c2f09b8367793a9aca3db71"
     "cc30c58179ec3e87c14c01d5c1f3434f1d87"),
    (bytes([0x0B]) * 22, b"", b"", 42,
     "8da4e775a563c18f715f802a063c5a31b8a11f5c5ee1879ec3454e5f3c738d2d"
     "9d201395faa4b61a96c8"),
]

# ---- RFC 8439 §2.8.2: ChaCha20-Poly1305 ---------------------------------------

AEAD_VECTOR = dict(
    key=bytes(range(0x80, 0xA0)),
    nonce=h("070000004041424344454647"),
    aad=h("50515253c0c1c2c3c4c5c6c7"),
    plaintext=(b"Ladies and Gentlemen of the class of '99: If I could offer "
               b"you only one tip for the future, sunscreen would be it."),
    ciphertext=h(
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d6"
        "3dbea45e8ca9671282fafb69da92728b1a71de0a9e060b2905d6a5b67ecd3b36"
        "92ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116"),
    tag=h("1ae10b594f09e26a7e902ecbd0600691"),
)


@pytest.mark.parametrize("scalar,u,out", X25519_VECTORS)
def test_rfc7748_single_step_vectors(scalar, u, out):
    assert _curves.x25519(h(scalar), h(u)).hex() == out


@pytest.mark.parametrize("iterations", sorted(X25519_ITERATED))
def test_rfc7748_iterated_vectors(iterations):
    k = u = (9).to_bytes(32, "little")
    for _ in range(iterations):
        k, u = _curves.x25519(k, u), k
    assert k.hex() == X25519_ITERATED[iterations]


def test_rfc7748_diffie_hellman():
    v = {k: h(x) for k, x in X25519_DH.items()}
    assert _curves.x25519_public(v["alice_priv"]) == v["alice_pub"]
    assert _curves.x25519_public(v["bob_priv"]) == v["bob_pub"]
    assert _curves.x25519_exchange(v["alice_priv"], v["bob_pub"]) == v["shared"]
    assert _curves.x25519_exchange(v["bob_priv"], v["alice_pub"]) == v["shared"]


def test_x25519_rejects_an_all_zero_shared_secret():
    # u = 0 and u = 1 are small-order points: every scalar maps them to 0
    for u in (bytes(32), (1).to_bytes(32, "little")):
        with pytest.raises(ValueError):
            _curves.x25519_exchange(os.urandom(32), u)


@pytest.mark.parametrize("sk,pk,msg,sig", ED25519_VECTORS)
def test_rfc8032_vectors(sk, pk, msg, sig):
    assert _curves.ed25519_public(h(sk)).hex() == pk
    assert _curves.ed25519_sign(h(sk), h(msg)).hex() == sig
    assert _curves.ed25519_verify(h(pk), h(sig), h(msg))
    assert not _curves.ed25519_verify(h(pk), h(sig), h(msg) + b"\x00")


def test_ed25519_verify_rejects_non_canonical_s_and_bad_points():
    sk, pk, msg, sig = (h(x) for x in ED25519_VECTORS[1])
    s = int.from_bytes(sig[32:], "little")
    # S + L names the same scalar, non-canonically
    assert not _curves.ed25519_verify(
        pk, sig[:32] + (s + _curves.L).to_bytes(32, "little"), msg)
    # a y past p does not decode
    assert not _curves.ed25519_verify(
        (_curves.P + 1).to_bytes(32, "little"), sig, msg)
    # y = 2 has no x on the curve
    assert not _curves.ed25519_verify((2).to_bytes(32, "little"), sig, msg)
    # a flipped R bit
    bad = bytearray(sig)
    bad[0] ^= 1
    assert not _curves.ed25519_verify(pk, bytes(bad), msg)
    assert not _curves.ed25519_verify(pk, sig[:63], msg)


@pytest.mark.parametrize("ikm,salt,info,length,okm", HKDF_VECTORS)
def test_rfc5869_vectors(ikm, salt, info, length, okm):
    assert _curves.hkdf_sha256(ikm, length=length, salt=salt,
                               info=info).hex() == okm


def test_hkdf_salt_none_is_32_zero_bytes():
    ikm, info = b"ikm", b"info"
    assert _curves.hkdf_sha256(ikm, length=32, info=info) == \
        _curves.hkdf_sha256(ikm, length=32, salt=bytes(32), info=info)


def test_rfc8439_aead_vector_through_the_native_export():
    v = AEAD_VECTOR
    sealed = xchacha.ietf_seal(v["key"], v["nonce"], v["plaintext"], v["aad"])
    assert sealed == v["ciphertext"] + v["tag"]
    assert xchacha.ietf_open(v["key"], v["nonce"], sealed, v["aad"]) == \
        v["plaintext"]
    for bad in (sealed[:-1] + bytes([sealed[-1] ^ 1]), sealed[:15]):
        with pytest.raises(xchacha.AeadError):
            xchacha.ietf_open(v["key"], v["nonce"], bad, v["aad"])
    with pytest.raises(xchacha.AeadError):
        xchacha.ietf_open(v["key"], v["nonce"], sealed, b"other aad")


def test_the_cryptor_runs_with_cryptography_barred():
    """A fresh interpreter where ``import cryptography`` fails wraps and
    unwraps through the port: the cryptor needs no third-party crypto."""
    code = (
        "import sys\n"
        "sys.modules['cryptography'] = None\n"
        "from crdt_enc_tpu_torch.backends.x25519_keys import (\n"
        "    generate_identity, wrap_blob, unwrap_blob)\n"
        "priv, pub = generate_identity()\n"
        "blob = wrap_blob(b'keys', [pub], priv)\n"
        "assert unwrap_blob(priv, blob, {pub})[0] == b'keys'\n"
        "assert not any(m.split('.')[0] in ('cryptography', 'jax')\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": ROOT}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


# ---- wrap/unwrap primitives (tests/test_x25519_keys.py) -------------------------


def test_wrap_unwrap_roundtrip_multi_recipient():
    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()
    blob = wrap_blob(b"the keys crdt", [pub_a, pub_b], priv_a)
    trusted = {pub_a, pub_b}
    clear_a, roster_a, signer_a = unwrap_blob(priv_a, blob, trusted)
    clear_b, roster_b, signer_b = unwrap_blob(priv_b, blob, trusted)
    assert clear_a == clear_b == b"the keys crdt"
    assert set(roster_a) == set(roster_b) == trusted
    assert signer_a == signer_b == pub_a


def test_non_recipient_rejected():
    priv_a, pub_a = generate_identity()
    priv_eve, pub_eve = generate_identity()
    blob = wrap_blob(b"secret", [pub_a], priv_a)
    with pytest.raises(NotARecipient):
        unwrap_blob(priv_eve, blob, {pub_a, pub_eve})


def test_forged_blob_rejected():
    """Hostile storage can build a valid-looking blob (sealing needs only
    public keys), but it cannot sign as a trusted identity."""
    priv_a, pub_a = generate_identity()
    priv_eve, pub_eve = generate_identity()
    forged = wrap_blob(b"attacker keys", [pub_a, pub_eve], priv_eve)
    with pytest.raises(UntrustedSigner):
        unwrap_blob(priv_a, forged, {pub_a})


def test_tampered_roster_rejected():
    """Appending an attacker identity to the roster breaks the
    signature."""
    priv_a, pub_a = generate_identity()
    _, pub_eve = generate_identity()
    blob = wrap_blob(b"secret", [pub_a], priv_a)
    body, signer_pub, sig = codec.unpack(blob)
    eph_pub, sealed, roster, wraps = codec.unpack(bytes(body))
    roster = [bytes(r) for r in roster] + [pub_eve]
    tampered_body = codec.pack([bytes(eph_pub), bytes(sealed), roster, wraps])
    tampered = codec.pack([tampered_body, signer_pub, sig])
    with pytest.raises(UntrustedSigner):
        unwrap_blob(priv_a, tampered, {pub_a})


def test_tampered_bytes_rejected():
    priv_a, pub_a = generate_identity()
    blob = bytearray(wrap_blob(b"secret", [pub_a], priv_a))
    blob[-1] ^= 0x01
    with pytest.raises((UntrustedSigner, NotARecipient)):
        unwrap_blob(priv_a, bytes(blob), {pub_a})


def test_fresh_ephemeral_per_write():
    priv_a, pub_a = generate_identity()
    assert wrap_blob(b"x", [pub_a], priv_a) != wrap_blob(b"x", [pub_a], priv_a)


# ---- through the port's core -----------------------------------------------------


def make_opts(tmp_path, name, priv, recipients, create=True, **kc_kw):
    return OpenOptions(
        storage=FsStorage(str(tmp_path / name), str(tmp_path / "remote")),
        cryptor=XChaChaCryptor(),
        key_cryptor=X25519KeyCryptor(priv, recipients, **kc_kw),
        adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=create,
        accelerator=TorchAccelerator(device="cpu", min_device_batch=1),
    )


def test_two_recipient_replicas_converge(tmp_path):
    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()
    roster = [pub_a, pub_b]

    async def go():
        c1 = await Core.open(make_opts(tmp_path, "a", priv_a, roster))
        await c1.update(lambda s: s.add_ctx(c1.actor_id, b"x"))
        c2 = await Core.open(make_opts(tmp_path, "b", priv_b, roster))
        await c2.read_remote()
        assert c2.with_state(lambda s: s.contains(b"x"))
        k1 = c1._data.keys.latest_key()
        k2 = c2._data.keys.latest_key()
        assert k1.id == k2.id and k1.material == k2.material
        assert c1.with_state(canonical_bytes) == c2.with_state(canonical_bytes)

    run(go())


def test_outsider_cannot_join(tmp_path):
    priv_a, pub_a = generate_identity()
    priv_eve, pub_eve = generate_identity()

    async def go():
        c1 = await Core.open(make_opts(tmp_path, "a", priv_a, [pub_a]))
        await c1.update(lambda s: s.add_ctx(c1.actor_id, b"x"))
        with pytest.raises((NotARecipient, CoreError)):
            await Core.open(make_opts(tmp_path, "eve", priv_eve, [pub_a]))

    run(go())


def test_rotation_under_recipient_keys(tmp_path):
    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()
    roster = [pub_a, pub_b]

    async def go():
        c1 = await Core.open(make_opts(tmp_path, "a", priv_a, roster))
        await c1.update(lambda s: s.add_ctx(c1.actor_id, b"old"))
        await c1.rotate_key()
        await c1.update(lambda s: s.add_ctx(c1.actor_id, b"new"))
        c2 = await Core.open(make_opts(tmp_path, "b", priv_b, roster))
        await c2.read_remote()
        assert set(c2.with_state(lambda s: s.members())) == {b"old", b"new"}

    run(go())


def test_stale_roster_writer_cannot_lock_out_peers(tmp_path):
    """A device restarted with a stale roster must not seal future key
    material away from peers an earlier writer admitted: the roster
    converges grow-only from every verified blob it opens."""
    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()

    async def go():
        c_a = await Core.open(make_opts(tmp_path, "a", priv_a, [pub_a, pub_b]))
        await c_a.update(lambda s: s.add_ctx(c_a.actor_id, b"x"))
        kc = X25519KeyCryptor(priv_a, [])  # stale: B missing
        opts = make_opts(tmp_path, "a2", priv_a, [])
        opts.key_cryptor = kc
        c_a2 = await Core.open(opts)
        assert pub_b in kc.recipients
        await c_a2.rotate_key()
        await c_a2.update(lambda s: s.add_ctx(c_a2.actor_id, b"y"))
        c_b = await Core.open(make_opts(tmp_path, "b", priv_b, [pub_a, pub_b]))
        await c_b.read_remote()
        assert set(c_b.with_state(lambda s: s.members())) == {b"x", b"y"}

    run(go())


def test_pinned_roster_revocation(tmp_path):
    """After a rotation under a pinned roster, the revoked device cannot
    read keys sealed from then on."""
    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()

    async def go():
        c_a = await Core.open(make_opts(tmp_path, "a", priv_a, [pub_a, pub_b]))
        await c_a.update(lambda s: s.add_ctx(c_a.actor_id, b"x"))
        opts = make_opts(tmp_path, "a2", priv_a, [])
        opts.key_cryptor = X25519KeyCryptor(priv_a, [pub_a], pin_recipients=True)
        c_a2 = await Core.open(opts)
        await c_a2.rotate_key()
        with pytest.raises((NotARecipient, CoreError)):
            await Core.open(make_opts(tmp_path, "b", priv_b, [pub_a, pub_b]))

    run(go())


def test_unreadable_concurrent_value_tolerated(tmp_path):
    """A register holding one value this replica can open and one it
    cannot (signed by a trusted peer but sealed only to that peer) still
    decodes: per-value tolerance (DECODE_TOLERATES)."""
    from crdt_enc_tpu_torch.core.core import RemoteMeta
    from crdt_enc_tpu_torch.core.key_cryptor import Key, Keys
    from crdt_enc_tpu_torch.models.mvreg import MVReg
    from crdt_enc_tpu_torch.utils.mvreg_codec import encode_version_bytes_mvreg
    from crdt_enc_tpu_torch.utils.version_bytes import VersionBytes
    from crdt_enc_tpu_torch.utils.versions import CURRENT_CONTAINER_VERSION

    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()

    async def go():
        c_a = await Core.open(make_opts(tmp_path, "a", priv_a, [pub_a, pub_b]))
        await c_a.update(lambda s: s.add_ctx(c_a.actor_id, b"x"))
        kc_b = X25519KeyCryptor(priv_b, [pub_b], pin_recipients=True)
        keys_b = Keys()
        keys_b.insert_latest_key(
            uuidm.uuid4().bytes,
            Key.new(VersionBytes(DEFAULT_DATA_VERSION_1, b"\x00" * 32)),
        )
        reg = MVReg()
        await encode_version_bytes_mvreg(
            reg, keys_b, uuidm.uuid4().bytes, kc_b.META_VERSION,
            transform=kc_b._protect,
        )
        inj = FsStorage(str(tmp_path / "inj"), str(tmp_path / "remote"))
        rm = RemoteMeta(key_cryptor=reg)
        await inj.store_remote_meta(
            VersionBytes(CURRENT_CONTAINER_VERSION,
                         codec.pack(rm.to_obj())).serialize()
        )
        await c_a.read_remote()
        assert c_a.with_state(lambda s: s.contains(b"x"))
        assert c_a._data.keys.latest_key() is not None
        await c_a.update(lambda s: s.add_ctx(c_a.actor_id, b"y"))

    run(go())


def test_roster_trust_growth_reaches_fixpoint(monkeypatch):
    """Two concurrent register values: one signed by A (trusted), whose
    roster introduces B; one signed by B carrying a rotated latest key.
    The decode recovers B's key material whatever the MVReg value
    order."""
    from crdt_enc_tpu_torch.core.key_cryptor import Key, Keys
    from crdt_enc_tpu_torch.models.mvreg import MVReg
    from crdt_enc_tpu_torch.utils.version_bytes import VersionBytes

    priv_a, pub_a = generate_identity()
    priv_b, pub_b = generate_identity()
    priv_c, pub_c = generate_identity()
    roster = [pub_a, pub_b, pub_c]

    actor_a, actor_b = b"A" * 16, b"B" * 16
    key1 = Key.new(VersionBytes(DEFAULT_DATA_VERSION_1, b"\x01" * 32))
    key2 = Key.new(VersionBytes(DEFAULT_DATA_VERSION_1, b"\x02" * 32))
    keys_a = Keys()
    keys_a.insert_latest_key(actor_a, key1)
    keys_b = Keys.from_obj(keys_a.to_obj())
    keys_b.insert_latest_key(actor_b, key2)

    def reg_value(keys, signer_priv):
        blob = wrap_blob(codec.pack(keys.to_obj()), roster, signer_priv)
        return VersionBytes(X25519KeyCryptor.META_VERSION, blob).to_obj()

    reg_a, reg_b = MVReg(), MVReg()
    reg_a.apply(reg_a.write_ctx(actor_a, reg_value(keys_a, priv_a)))
    reg_b.apply(reg_b.write_ctx(actor_b, reg_value(keys_b, priv_b)))
    reg_a.merge(reg_b)
    assert len(reg_a.read().values) == 2

    class CoreStub:
        keys = None

        def set_keys(self, keys):
            self.keys = keys

    async def decode_with_order(reverse: bool):
        kc = X25519KeyCryptor(priv_c, [pub_a])  # trusts only A (+ itself)
        stub = CoreStub()
        await kc.init(stub)
        if reverse:
            orig_read = MVReg.read

            def rev_read(self):
                ctx = orig_read(self)
                ctx.values = list(reversed(ctx.values))
                return ctx

            monkeypatch.setattr(MVReg, "read", rev_read)
        try:
            await kc.set_remote_meta(MVReg.from_obj(reg_a.to_obj()))
        finally:
            monkeypatch.undo()
        return stub.keys

    for reverse in (False, True):
        got = run(decode_with_order(reverse))
        assert got is not None
        assert got.get_key(key1.id) is not None
        assert got.get_key(key2.id) is not None, (
            f"rotated key lost to decode order (reverse={reverse})"
        )
        assert got.latest_key().id == key2.id
