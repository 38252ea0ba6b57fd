"""The port's native library (``crdt_enc_tpu_torch/native``) against the
JAX package's: the XChaCha20-Poly1305 envelopes open across the packages,
the batch open agrees with the single one, the payload decoders give
equal columns and members, and the fs op-log scans read the same files.
A failed build raises."""

from __future__ import annotations

import asyncio
import secrets
import uuid

import numpy as np
import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import xchacha as jx
from crdt_enc_tpu.ops import native_decode as jnd
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import native
from crdt_enc_tpu_torch.backends import xchacha as px
from crdt_enc_tpu_torch.backends.fs import FsStorage
from crdt_enc_tpu_torch.ops import native_decode as pnd

ACTORS = sorted(uuid.UUID(int=i + 1).bytes for i in range(6))


def test_native_library_builds_and_binds():
    lib = native.load()
    assert lib is native.load()
    assert native.lib_path().exists()
    assert native.lib_path().name.startswith("libcrdtnative-")


def test_a_failed_build_raises_every_time(tmp_path, monkeypatch):
    for name in native.SOURCES:
        (tmp_path / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "HERE", tmp_path)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="native build failed"):
            native.load()
    assert not list((tmp_path / "build").glob("*.so"))


def test_the_hash_covers_sources_and_flags(tmp_path, monkeypatch):
    for name in native.SOURCES:
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(native, "HERE", tmp_path)
    first = native.lib_path()
    (tmp_path / "codec.cpp").write_text("// edited\n")
    second = native.lib_path()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert len({first, second, native.lib_path()}) == 3


def test_the_hash_covers_the_host_cpu(monkeypatch):
    """A build carried to a CPU whose ``-march=native`` differs is not
    loaded there: the target's macros are part of the hash."""
    target = native._target()
    assert b"__VERSION__" in target
    assert any(m in target for m in (b"__x86_64__", b"__aarch64__"))
    here = native.lib_path()
    monkeypatch.setattr(native, "_target", lambda: target + b"#define __AVX512F__ 1\n")
    assert native.lib_path() != here


@pytest.mark.parametrize("size", [0, 1, 63, 64, 1000, 70000])
def test_blobs_open_across_packages(size):
    key = secrets.token_bytes(32)
    data = secrets.token_bytes(size)
    assert jx.decrypt_blob(key, px.encrypt_blob(key, data)) == data
    assert px.decrypt_blob(key, jx.encrypt_blob(key, data)) == data


def test_wrong_key_and_tampering_raise():
    key = secrets.token_bytes(32)
    blob = jx.encrypt_blob(key, b"payload")
    with pytest.raises(px.AeadError):
        px.decrypt_blob(secrets.token_bytes(32), blob)
    bad = bytearray(blob)
    bad[-1] ^= 1
    with pytest.raises(px.AeadError):
        px.decrypt_blob(key, bytes(bad))
    with pytest.raises(px.AeadError):
        px.decrypt_blob(key[:31], blob)


def test_batch_open_matches_single_opens_and_detects_tamper():
    key = secrets.token_bytes(32)
    blobs = [
        (jx if i % 2 else px).encrypt_blob(key, f"payload-{i}".encode() * (i % 9 + 1))
        for i in range(64)
    ]
    got = px.decrypt_blobs(key, blobs)
    assert [bytes(v) for v in got] == [jx.decrypt_blob(key, b) for b in blobs]
    assert [bytes(v) for v in got] == [bytes(v) for v in jx.decrypt_blobs(key, blobs)]
    assert px.decrypt_blobs(key, []) == []
    bad = bytearray(blobs[7])
    bad[-1] ^= 1
    with pytest.raises(px.AeadError, match="#7"):
        px.decrypt_blobs(key, blobs[:7] + [bytes(bad)] + blobs[8:])
    with pytest.raises(px.AeadError, match="malformed"):
        px.decrypt_blobs(key, blobs[:3] + [b"short"])


def orset_payloads(seed: int, n_files: int = 30):
    """Op files of adds and removes over members of several types."""
    rng = np.random.default_rng(seed)
    members = [0, 1, 127, 128, 300, 70000, -3, b"m", "s", (1, b"t"), b"x" * 40]
    counters = {a: 0 for a in ACTORS}
    payloads = []
    for _ in range(n_files):
        ops = []
        for _ in range(int(rng.integers(1, 9))):
            a = ACTORS[int(rng.integers(len(ACTORS)))]
            m = members[int(rng.integers(len(members)))]
            if rng.random() < 0.3:
                ctx = {b: int(rng.integers(1, 400)) for b in ACTORS[: int(rng.integers(1, 4))]}
                ops.append([1, m, ctx])
            else:
                counters[a] += int(rng.integers(1, 200))
                ops.append([0, m, [a, counters[a]]])
        payloads.append(jcodec.pack(ops))
    return payloads


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_orset_payload_decode_matches_the_jax_decoder(seed):
    payloads = orset_payloads(seed)
    ref = jnd.decode_orset_payload_batch(payloads, ACTORS)
    got = pnd.decode_orset_payload_batch(payloads, ACTORS)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(r, g)
        assert r.dtype == g.dtype
    assert ref[4] == got[4]
    assert [type(m) for m in ref[4]] == [type(m) for m in got[4]]


def test_orset_decode_of_decrypted_views_matches_joined_bytes():
    """The bulk path hands the decoder zero-copy views of one cleartext
    buffer; the decode must equal the decode of plain bytes."""
    key = secrets.token_bytes(32)
    payloads = orset_payloads(3)
    views = px.decrypt_blobs(key, [px.encrypt_blob(key, p) for p in payloads])
    assert type(views[0]) is memoryview
    ref = pnd.decode_orset_payload_batch(payloads, ACTORS)
    got = pnd.decode_orset_payload_batch(views, ACTORS)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(r, g)
    assert ref[4] == got[4]


def test_orset_decode_declines_like_the_jax_decoder():
    stranger = uuid.UUID(int=99).bytes
    unknown = [jcodec.pack([[0, 1, [stranger, 1]]])]
    assert jnd.decode_orset_payload_batch(unknown, ACTORS) is None
    assert pnd.decode_orset_payload_batch(unknown, ACTORS) is None
    empty = pnd.decode_orset_payload_batch([], ACTORS)
    assert len(empty[0]) == 0 and empty[4] == []


@pytest.mark.parametrize("pn", [False, True])
def test_counter_payload_decode_matches_the_jax_decoder(pn):
    rng = np.random.default_rng(5)
    payloads = []
    for _ in range(25):
        ops = []
        for _ in range(int(rng.integers(1, 6))):
            dot = [ACTORS[int(rng.integers(len(ACTORS)))], int(rng.integers(1, 2**31 - 1))]
            ops.append([int(rng.integers(2)), dot] if pn else dot)
        payloads.append(jcodec.pack(ops))
    ref = jnd.decode_counter_payload_batch(payloads, ACTORS)
    got = pnd.decode_counter_payload_batch(payloads, ACTORS)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(r, g)
        assert r.dtype == g.dtype


def test_counters_past_int32_decline_where_the_jax_decoder_wraps():
    """The JAX decoder narrows a counter past 2^31 - 1 into int32 without
    a check (native/codec.cpp) and yields a negative counter; the port's
    copy declines the payload so the caller folds it per op."""
    a = ACTORS[0]
    big = 2**31 + 5
    counter_payload = [jcodec.pack([[a, big]])]
    orset_payload = [jcodec.pack([[0, 7, [a, big]]])]
    assert int(jnd.decode_counter_payload_batch(counter_payload, [a])[2][0]) < 0
    assert int(jnd.decode_orset_payload_batch(orset_payload, [a])[3][0]) < 0
    assert pnd.decode_counter_payload_batch(counter_payload, [a]) is None
    assert pnd.decode_orset_payload_batch(orset_payload, [a]) is None
    at_max = [jcodec.pack([[a, 2**31 - 1]])]
    assert int(pnd.decode_counter_payload_batch(at_max, [a])[2][0]) == 2**31 - 1


def test_fs_op_scans_match_the_jax_storage(tmp_path):
    async def go():
        remote = tmp_path / "remote"
        writer = FsStorage(str(tmp_path / "w"), str(remote))
        rng = np.random.default_rng(0)
        for i, a in enumerate(ACTORS):
            for v in range(1, 3 + 5 * i):
                await writer.store_ops(a, v, secrets.token_bytes(int(rng.integers(1, 900))))
        # a gap ends actor 2's dense run at v3
        (remote / "ops" / ACTORS[2].hex() / "4").unlink()
        port = FsStorage(str(tmp_path / "p"), str(remote))
        ref = JFsStorage(str(tmp_path / "j"), str(remote))
        wanted = [(a, 1 + i % 3) for i, a in enumerate(ACTORS)]
        wanted.append((uuid.UUID(int=77).bytes, 1))
        assert await port.list_op_actors() == await ref.list_op_actors()
        assert await port.load_ops(wanted) == await ref.load_ops(wanted)
        assert await port.stat_ops(wanted) == await ref.stat_ops(wanted)
        # small byte rounds: several native rounds per actor
        port.NATIVE_SCAN_BYTES = 1000
        assert await port.load_ops(wanted) == await ref.load_ops(wanted)
        assert await FsStorage(str(tmp_path / "e"), str(tmp_path / "none")).load_ops(
            wanted) == []

    asyncio.run(go())
