"""The port's passphrase and OpenPGP key cryptors on the CPU.

The cases of tests/test_passphrase_keys.py and tests/test_gpg_keys.py,
run against the port (``crdt_enc_tpu_torch.backends``), plus the
cross-package checks: a blob wrapped by either package unwraps in the
other, and a remote keyed by either package's plugin opens in the other
and reads the same canonical bytes, both ways.  The register codec's
``transform``/``tolerate`` hooks are held against the JAX codec.  The
KDF stays cheap (``log2_n`` 4) as in the JAX tests; the OpenPGP cases
skip with a named reason where no ``gpg`` binary is found.
"""

from __future__ import annotations

import asyncio
import os
import subprocess

import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import IdentityCryptor as JIdentityCryptor
from crdt_enc_tpu.backends import MemoryRemote as JMemoryRemote
from crdt_enc_tpu.backends import MemoryStorage as JMemoryStorage
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.backends.gpg_keys import GpgKeyCryptor as JGpgKeyCryptor
from crdt_enc_tpu.backends.passphrase_keys import (
    PassphraseKeyCryptor as JPassphraseKeyCryptor,
)
from crdt_enc_tpu.backends.passphrase_keys import unwrap_blob as j_unwrap_blob
from crdt_enc_tpu.backends.passphrase_keys import wrap_blob as j_wrap_blob
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import gcounter_adapter as j_gcounter_adapter
from crdt_enc_tpu.core import orset_adapter as j_orset_adapter
from crdt_enc_tpu.core.adapters import HostAccelerator as JHostAccelerator
from crdt_enc_tpu.core.key_cryptor import Keys as JKeys
from crdt_enc_tpu.models import canonical_bytes as j_canonical_bytes
from crdt_enc_tpu.models.mvreg import MVReg as JMVReg
from crdt_enc_tpu.utils import mvreg_codec as j_mvreg_codec
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    MemoryRemote,
    MemoryStorage,
    OpenOptions,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
    gcounter_adapter,
    orset_adapter,
)
from crdt_enc_tpu_torch.backends import (
    GpgKeyCryptor,
    IdentityCryptor,
    NotDecryptable,
    PassphraseKeyCryptor,
    WrongPassphrase,
    gpg_available,
)
from crdt_enc_tpu_torch.backends.passphrase_keys import (
    MAX_LOG2_N,
    MAX_P,
    MAX_R,
    unwrap_blob,
    wrap_blob,
)
from crdt_enc_tpu_torch.core.core import CoreError
from crdt_enc_tpu_torch.core.key_cryptor import Keys
from crdt_enc_tpu_torch.models.mvreg import MVReg
from crdt_enc_tpu_torch.utils import codec, mvreg_codec
from crdt_enc_tpu_torch.utils.version_bytes import VersionBytes
from crdt_enc_tpu_torch.utils.versions import (
    DEFAULT_DATA_VERSION_1,
    GPG_KEYS_META_VERSION_1,
    PASSPHRASE_KEYS_META_VERSION_1,
)

# cheap KDF for tests: 2**4 iterations instead of 2**14
FAST = dict(kdf_log2_n=4, kdf_r=8, kdf_p=1)

needs_gpg = pytest.mark.skipif(not gpg_available(), reason="no gpg binary")


def run(coro):
    return asyncio.run(coro)


def cpu():
    return TorchAccelerator(device="cpu", min_device_batch=1)


def pp_opts(remote, passphrase=b"hunter2", create=True):
    return OpenOptions(
        storage=MemoryStorage(remote), cryptor=IdentityCryptor(),
        key_cryptor=PassphraseKeyCryptor(passphrase, **FAST),
        adapter=gcounter_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=cpu(),
    )


def jpp_opts(remote, passphrase=b"hunter2", create=True):
    return JOpenOptions(
        storage=JMemoryStorage(remote), cryptor=JIdentityCryptor(),
        key_cryptor=JPassphraseKeyCryptor(passphrase, **FAST),
        adapter=j_gcounter_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=JHostAccelerator(),
    )


def copy_remote(src, cls):
    return cls(metas=dict(src.metas), states=dict(src.states),
               ops={a: dict(d) for a, d in src.ops.items()},
               deltas={a: dict(d) for a, d in src.deltas.items()})


# ---- the passphrase wrap ---------------------------------------------------


def test_wrap_roundtrip():
    blob = wrap_blob(b"pw", b"payload", log2_n=4)
    assert unwrap_blob(b"pw", blob) == b"payload"
    # a fresh salt per wrap: distinct ciphertexts for identical input
    assert wrap_blob(b"pw", b"payload", log2_n=4) != blob


def test_wrap_rejects_wrong_passphrase():
    blob = wrap_blob(b"pw", b"payload", log2_n=4)
    with pytest.raises(WrongPassphrase):
        unwrap_blob(b"other", blob)


def test_wrap_rejects_garbage_and_hostile_kdf_params():
    with pytest.raises(WrongPassphrase):
        unwrap_blob(b"pw", b"not a packed list at all")
    # an out-of-bounds work factor is refused before any scrypt memory
    hostile = codec.pack([b"\0" * 16, 30, 8, 1, b"x" * 40])
    with pytest.raises(WrongPassphrase):
        unwrap_blob(b"pw", hostile)


def test_max_bounds_kdf_params_are_computable():
    blob = wrap_blob(b"pw", b"payload", log2_n=MAX_LOG2_N, r=MAX_R, p=MAX_P)
    assert unwrap_blob(b"pw", blob) == b"payload"


def test_integer_salt_rejected_without_allocation():
    hostile = codec.pack([2**33, 4, 8, 1, b"x" * 40])
    with pytest.raises(WrongPassphrase):
        unwrap_blob(b"pw", hostile)


def test_wrap_does_not_leak_plaintext():
    secret = b"super-secret-key-material-0123456789"
    blob = wrap_blob(b"pw", secret, log2_n=4)
    assert secret not in blob


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_wraps_open_across_packages(direction):
    wrap, unwrap = ((j_wrap_blob, unwrap_blob) if direction == "jax_to_port"
                    else (wrap_blob, j_unwrap_blob))
    blob = wrap(b"pw", b"keys blob", log2_n=4)
    assert unwrap(b"pw", blob) == b"keys blob"
    with pytest.raises(Exception) as ei:
        unwrap(b"wrong", blob)
    assert type(ei.value).__name__ == "WrongPassphrase"


# ---- the passphrase key cryptor through Core -------------------------------


def test_two_replica_convergence_shared_passphrase():
    async def go():
        remote = MemoryRemote()
        c1 = await Core.open(pp_opts(remote))
        c2 = await Core.open(pp_opts(remote))
        k1 = c1._data.keys.latest_key()
        k2 = c2._data.keys.latest_key()
        assert k1 is not None and k2 is not None
        assert k1.id == k2.id and k1.material == k2.material
        await c1.apply_ops([c1.with_state(lambda s: s.inc(c1.actor_id, 5))])
        await c2.read_remote()
        assert c2.with_state(lambda s: s.read()) == 5

    run(go())


def test_wrong_passphrase_replica_cannot_join():
    async def go():
        remote = MemoryRemote()
        await Core.open(pp_opts(remote))
        with pytest.raises(WrongPassphrase):
            await Core.open(pp_opts(remote, passphrase=b"wrong"))

    run(go())


def test_keys_blob_sealed_in_remote_meta():
    async def go():
        remote = MemoryRemote()
        c1 = await Core.open(pp_opts(remote))
        key = c1._data.keys.latest_key()
        assert key is not None
        for raw in remote.metas.values():
            assert key.material.content not in bytes(raw)
        values = c1._data.remote_meta.key_cryptor.read().values
        assert values and all(
            VersionBytes.from_obj(v).version == PASSPHRASE_KEYS_META_VERSION_1
            for v in values)

    run(go())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_passphrase_remote_opens_in_the_other_package(first):
    """A remote keyed (and written) by one package's passphrase cryptor
    opens in the other with the same key, reads the same bytes, takes a
    write, and the first package reads that write back."""

    async def go():
        if first == "jax":
            jr = JMemoryRemote()
            a = await JCore.open(jpp_opts(jr))
            await a.apply_ops([a.with_state(lambda s: s.inc(a.actor_id, 3))])
            pr = copy_remote(jr, MemoryRemote)
            b = await Core.open(pp_opts(pr))
        else:
            pr = MemoryRemote()
            b = await Core.open(pp_opts(pr))
            await b.apply_ops([b.with_state(lambda s: s.inc(b.actor_id, 3))])
            jr = copy_remote(pr, JMemoryRemote)
            a = await JCore.open(jpp_opts(jr))
        ka, kb = a._data.keys.latest_key(), b._data.keys.latest_key()
        assert ka.id == kb.id and ka.material.content == kb.material.content
        await a.read_remote()
        await b.read_remote()
        assert a.with_state(j_canonical_bytes) == b.with_state(canonical_bytes)
        # the second package writes; the first reads it through its copy
        await b.apply_ops([b.with_state(lambda s: s.inc(b.actor_id, 4))])
        for actor, files in pr.ops.items():
            jr.ops.setdefault(actor, {}).update(files)
        await a.read_remote()
        assert a.with_state(lambda s: s.read()) == 7
        assert a.with_state(j_canonical_bytes) == b.with_state(canonical_bytes)
        with pytest.raises(WrongPassphrase):
            await Core.open(pp_opts(copy_remote(jr, MemoryRemote),
                                    passphrase=b"wrong"))

    run(go())


# ---- the register codec hooks, against the JAX codec -----------------------


class Opaque(Exception):
    """A value this replica cannot open."""


def test_register_codec_transform_and_tolerate_match_jax():
    """Two concurrent Keys values, one sealed so that ``transform`` cannot
    open it: with the error tolerated both codecs merge the readable one
    alone; untolerated, or with every value unreadable, both raise."""

    async def go():
        out = {}
        for name, Reg, mod, from_keys in (
                ("port", MVReg, mvreg_codec, Keys),
                ("jax", JMVReg, j_mvreg_codec, JKeys)):
            reg = Reg()
            for actor, tag in ((b"\1" * 16, b"ok"), (b"\2" * 16, b"sealed")):
                side = Reg()
                keys = from_keys()
                await mod.encode_version_bytes_mvreg(
                    side, keys, actor, b"\7" * 16,
                    transform=lambda raw, tag=tag: tag + raw)
                reg.merge(side)

            def opener(vb):
                if vb.content.startswith(b"sealed"):
                    raise Opaque("not a recipient")
                return vb.content[2:]

            merged = await mod.decode_version_bytes_mvreg(
                reg, {b"\7" * 16}, from_keys, transform=opener,
                tolerate=(Opaque,))
            with pytest.raises(Opaque):
                await mod.decode_version_bytes_mvreg(
                    reg, {b"\7" * 16}, from_keys, transform=opener)

            async def never(vb):
                raise Opaque("no value opens")

            with pytest.raises(Opaque):
                await mod.decode_version_bytes_mvreg(
                    reg, {b"\7" * 16}, from_keys, transform=never,
                    tolerate=(Opaque,))
            assert await mod.decode_version_bytes_mvreg(
                Reg(), {b"\7" * 16}, from_keys) is None
            out[name] = codec.pack(merged.to_obj())
        assert out["port"] == out["jax"]

    run(go())


# ---- OpenPGP ---------------------------------------------------------------


def _gpg(home, *args, stdin=None):
    env = dict(os.environ, GNUPGHOME=str(home))
    r = subprocess.run(
        ["gpg", "--batch", "--quiet", "--yes", "--pinentry-mode", "loopback",
         "--passphrase", ""] + list(args),
        input=stdin, capture_output=True, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()
    return r.stdout


def make_identity(tmp_path, name: str) -> tuple[str, str]:
    """A fresh GnuPG home with one signing+encryption keypair; returns
    (home, fingerprint)."""
    home = tmp_path / f"gnupg-{name}"
    home.mkdir(mode=0o700)
    _gpg(home, "--quick-gen-key", f"{name} <{name}@test>", "ed25519",
         "cert,sign", "never")
    cols = _gpg(home, "--list-keys", "--with-colons").decode()
    fpr = next(l.split(":")[9] for l in cols.splitlines()
               if l.startswith("fpr"))
    _gpg(home, "--quick-add-key", fpr, "cv25519", "encr", "never")
    return str(home), fpr


@pytest.fixture
def identity(tmp_path):
    """``identity(name)`` makes a GnuPG home (``make_identity``); each
    home's agent stops when the test ends."""
    homes = []

    def make(name: str) -> tuple[str, str]:
        home, fpr = make_identity(tmp_path, name)
        homes.append(home)
        return home, fpr

    yield make
    for home in homes:
        subprocess.run(["gpgconf", "--homedir", home, "--kill", "gpg-agent"],
                       capture_output=True, timeout=30)


def share_pubkey(src_home, fpr, dst_home):
    _gpg(dst_home, "--import", stdin=_gpg(src_home, "--export", fpr))


def gpg_opts(tmp_path, name, kc):
    return OpenOptions(
        storage=FsStorage(str(tmp_path / name), str(tmp_path / "remote")),
        cryptor=XChaChaCryptor(), key_cryptor=kc, adapter=orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=cpu(),
    )


def jgpg_opts(tmp_path, name, kc):
    return JOpenOptions(
        storage=JFsStorage(str(tmp_path / name), str(tmp_path / "remote")),
        cryptor=JXChaChaCryptor(), key_cryptor=kc, adapter=j_orset_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=True,
        accelerator=JHostAccelerator(),
    )


@needs_gpg
def test_two_pgp_replicas_converge(tmp_path, identity):
    home_a, fpr_a = identity("alice")
    home_b, fpr_b = identity("bob")
    share_pubkey(home_a, fpr_a, home_b)
    share_pubkey(home_b, fpr_b, home_a)
    recipients = [fpr_a, fpr_b]

    async def go():
        a = await Core.open(gpg_opts(
            tmp_path, "a", GpgKeyCryptor(recipients, gnupg_home=home_a)))
        await a.update(lambda s: s.add_ctx(a.actor_id, b"x"))
        b = await Core.open(gpg_opts(
            tmp_path, "b", GpgKeyCryptor(recipients, gnupg_home=home_b)))
        await b.read_remote()
        assert b.with_state(lambda s: s.contains(b"x"))
        ka, kb = a._data.keys.latest_key(), b._data.keys.latest_key()
        assert ka.id == kb.id and ka.material == kb.material
        assert a.with_state(canonical_bytes) == b.with_state(canonical_bytes)

    run(go())


@needs_gpg
def test_non_recipient_cannot_join(tmp_path, identity):
    home_a, fpr_a = identity("alice")
    home_eve, _ = identity("eve")
    share_pubkey(home_a, fpr_a, home_eve)  # eve knows alice's PUBLIC key

    async def go():
        a = await Core.open(gpg_opts(
            tmp_path, "a", GpgKeyCryptor([fpr_a], gnupg_home=home_a)))
        await a.update(lambda s: s.add_ctx(a.actor_id, b"secret"))
        with pytest.raises((CoreError, NotDecryptable)):
            await Core.open(gpg_opts(
                tmp_path, "eve", GpgKeyCryptor([fpr_a], gnupg_home=home_eve)))

    run(go())


@needs_gpg
def test_keys_blob_is_standard_openpgp(tmp_path, identity):
    """The stored key metadata decrypts with plain ``gpg --decrypt``."""
    home_a, fpr_a = identity("alice")

    async def go():
        a = await Core.open(gpg_opts(
            tmp_path, "a", GpgKeyCryptor([fpr_a], gnupg_home=home_a)))
        await a.update(lambda s: s.add_ctx(a.actor_id, b"x"))
        reg = a._data.remote_meta.key_cryptor.read().values
        assert reg
        vb = VersionBytes.from_obj(reg[0])
        assert vb.version == GPG_KEYS_META_VERSION_1
        clear = _gpg(home_a, "--decrypt", "--output", "-", stdin=vb.content)
        assert Keys.from_obj(codec.unpack(clear)).latest_key() is not None

    run(go())


class _Blob:
    def __init__(self, content):
        self.content = content


@needs_gpg
def test_signed_blobs_and_unsigned_rejection(tmp_path, identity):
    home_a, fpr_a = identity("alice")
    home_b, fpr_b = identity("bob")
    share_pubkey(home_a, fpr_a, home_b)
    share_pubkey(home_b, fpr_b, home_a)
    recipients = [fpr_a, fpr_b]

    async def go():
        a = await Core.open(gpg_opts(
            tmp_path, "a",
            GpgKeyCryptor(recipients, gnupg_home=home_a, sign_with=fpr_a)))
        await a.update(lambda s: s.add_ctx(a.actor_id, b"x"))
        b = await Core.open(gpg_opts(
            tmp_path, "b",
            GpgKeyCryptor(recipients, gnupg_home=home_b, sign_with=fpr_b,
                          require_signature=True)))
        await b.read_remote()
        assert b.with_state(lambda s: s.contains(b"x"))

    run(go())

    async def check_unsigned():
        kc = GpgKeyCryptor([fpr_a], gnupg_home=home_a, sign_with=fpr_a,
                           require_signature=True)
        unsigned = await GpgKeyCryptor([fpr_a],
                                       gnupg_home=home_a)._protect(b"payload")
        with pytest.raises(NotDecryptable):
            await kc._unprotect(_Blob(unsigned))

    run(check_unsigned())
    with pytest.raises(ValueError):
        GpgKeyCryptor([fpr_a], gnupg_home=home_a, require_signature=True)


@needs_gpg
def test_goodsig_forgery_in_plaintext_filename_rejected(tmp_path, identity):
    """An unsigned message whose literal-packet filename says GOODSIG
    (echoed into the PLAINTEXT status line) is still rejected."""
    home_a, fpr_a = identity("alice")

    async def go():
        forged = _gpg(
            home_a, "--encrypt", "--trust-model", "always",
            "--set-filename", "[GNUPG:] GOODSIG 0 forged",
            "--recipient", fpr_a, "--output", "-",
            stdin=b"attacker keys blob",
        )
        kc = GpgKeyCryptor([fpr_a], gnupg_home=home_a, sign_with=fpr_a,
                           require_signature=True)
        with pytest.raises(NotDecryptable):
            await kc._unprotect(_Blob(forged))

    run(go())


@needs_gpg
@pytest.mark.parametrize("first", ["jax", "port"])
def test_pgp_remote_opens_in_the_other_package(tmp_path, identity, first):
    """Alice keys and writes a remote with one package's OpenPGP cryptor;
    Bob opens it with the other's, reads the same bytes and writes; Alice
    reads Bob's write back."""
    home_a, fpr_a = identity("alice")
    home_b, fpr_b = identity("bob")
    share_pubkey(home_a, fpr_a, home_b)
    share_pubkey(home_b, fpr_b, home_a)
    recipients = [fpr_a, fpr_b]
    port_side = (gpg_opts, GpgKeyCryptor, canonical_bytes, Core)
    jax_side = (jgpg_opts, JGpgKeyCryptor, j_canonical_bytes, JCore)
    alice_side, bob_side = ((jax_side, port_side) if first == "jax"
                            else (port_side, jax_side))

    async def go():
        opts, Kc, canon_a, CoreA = alice_side
        a = await CoreA.open(opts(tmp_path, "a",
                                  Kc(recipients, gnupg_home=home_a)))
        await a.update(lambda s: s.add_ctx(a.actor_id, b"from-alice"))
        opts_b, Kc_b, canon_b, CoreB = bob_side
        b = await CoreB.open(opts_b(tmp_path, "b",
                                    Kc_b(recipients, gnupg_home=home_b)))
        await b.read_remote()
        assert b.with_state(lambda s: s.contains(b"from-alice"))
        ka, kb = a._data.keys.latest_key(), b._data.keys.latest_key()
        assert ka.id == kb.id and ka.material.content == kb.material.content
        await b.update(lambda s: s.add_ctx(b.actor_id, b"from-bob"))
        await a.read_remote()
        assert a.with_state(lambda s: s.contains(b"from-bob"))
        assert a.with_state(canon_a) == b.with_state(canon_b)

    run(go())
