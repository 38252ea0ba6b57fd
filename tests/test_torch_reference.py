"""The port's reference-remote migration tools against the JAX package's.

``crdt_enc_tpu_torch.tools.import_reference`` and ``export_reference``
on the CPU (destination and source ``Core``s on
``TorchAccelerator(device="cpu")``): the cases of
tests/test_reference_import.py and tests/test_reference_export.py, each
held against the JAX tools on the same fixtures, compared as canonical
state bytes.  Remotes cross in both directions: a reference-format
remote either package exports imports into the same canonical state
under either package's importer, and blobs either package seals open in
the other.

Fixture layers per the reference source (as in the JAX tests): outer raw
VersionBytes = container uuid ‖ payload; the cipher envelope
``rmp to_vec_named(VersionBytesRef(DATA_VERSION, EncBox))``; inner raw
VersionBytes(app data version) ‖ rmp(Vec<Op>); op dirs named by the
actor uuid's Display form, files from version 0.
"""

from __future__ import annotations

import asyncio
import os
import secrets
import uuid as uuidm

import numpy as np
import pytest

from crdt_enc_tpu.backends import FsStorage as JFsStorage
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlainKeyCryptor
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaChaCryptor
from crdt_enc_tpu.backends.xchacha import AeadError as JAeadError
from crdt_enc_tpu.backends.xchacha import seal_raw as jseal_raw
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import mvreg_adapter as jmvreg_adapter
from crdt_enc_tpu.models import canonical_bytes as jcanonical_bytes
from crdt_enc_tpu.tools import export_reference as jexport
from crdt_enc_tpu.tools import import_reference as jimport
from crdt_enc_tpu.utils import codec as jcodec
from crdt_enc_tpu_torch import (
    Core,
    FsStorage,
    OpenOptions,
    PlainKeyCryptor,
    TorchAccelerator,
    XChaChaCryptor,
    canonical_bytes,
)
from crdt_enc_tpu_torch.backends.xchacha import AeadError, open_raw, seal_raw
from crdt_enc_tpu_torch.core.adapters import mvreg_adapter
from crdt_enc_tpu_torch.models import MVReg
from crdt_enc_tpu_torch.tools import export_reference as pexport
from crdt_enc_tpu_torch.tools import import_reference as pimport
from crdt_enc_tpu_torch.utils import codec
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

APP_DATA_VERSION = uuidm.UUID("11111111-2222-3333-4444-555555555555").bytes
ACTOR_A = uuidm.UUID(int=0xA).bytes
ACTOR_B = uuidm.UUID(int=0xB).bytes
ACTOR_C = uuidm.UUID(int=0xC).bytes
PACKAGES = ["jax", "port"]


def run(coro):
    return asyncio.run(coro)


# ---- fixtures in the reference's layering ----------------------------------


def ref_seal(key: bytes, payload: bytes, data_version=APP_DATA_VERSION) -> bytes:
    """A reference op file sealed with the JAX package's primitives."""
    inner = data_version + payload
    nonce = secrets.token_bytes(24)
    enc_box = jcodec.pack({"nonce": nonce,
                           "enc_data": jseal_raw(key, nonce, inner)})
    middle = jcodec.pack([jimport.REF_CIPHER_DATA_VERSION, enc_box])
    return jimport.REF_CONTAINER_VERSION + middle


def ref_mvreg_op(clock: dict, val, named=True):
    """crdts v7 ``mvreg::Op { clock, val }``, named-map or positional."""
    if named:
        return {"clock": {"dots": dict(clock)}, "val": val}
    return [dict(clock), val]


def write_ref_remote(root, key, files_by_actor):
    for actor, files in files_by_actor.items():
        d = root / "ops" / str(uuidm.UUID(bytes=actor))
        d.mkdir(parents=True)
        for v, ops in enumerate(files):
            (d / str(v)).write_bytes(ref_seal(key, jcodec.pack(ops)))


def random_history(seed: int, n_actors: int = 4, n_files: int = 5,
                   per_file: int = 3) -> dict:
    """Per-actor reference op logs of the example's MVReg<_, Uuid>: each
    actor's writes carry its own counter and a random view of the others'
    (dominated and concurrent writes both occur); values are uuids."""
    rng = np.random.default_rng(seed)
    actors = [uuidm.UUID(int=int(rng.integers(1, 2**62))).bytes
              for _ in range(n_actors)]
    seen = {a: 0 for a in actors}
    out = {a: [] for a in actors}
    for _ in range(n_files):
        for a in actors:
            ops = []
            for _ in range(per_file):
                seen[a] += 1
                clock = {a: seen[a]}
                for b in actors:
                    if b != a and seen[b] and rng.random() < 0.5:
                        clock[b] = int(rng.integers(1, seen[b] + 1))
                ops.append(ref_mvreg_op(
                    clock, uuidm.UUID(int=int(rng.integers(0, 2**62))).bytes,
                    named=bool(rng.random() < 0.8)))
            out[a].append(ops)
    return out


def popts(tmp_path, name, remote=None, create=True):
    return OpenOptions(
        storage=FsStorage(str(tmp_path / name / "local"),
                          str(remote or tmp_path / name / "remote")),
        cryptor=XChaChaCryptor(), key_cryptor=PlainKeyCryptor(),
        adapter=mvreg_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create,
        accelerator=TorchAccelerator(device="cpu", min_device_batch=1))


def jopts(tmp_path, name, remote=None, create=True):
    return JOpenOptions(
        storage=JFsStorage(str(tmp_path / name / "local"),
                           str(remote or tmp_path / name / "remote")),
        cryptor=JXChaChaCryptor(), key_cryptor=JPlainKeyCryptor(),
        adapter=jmvreg_adapter(),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1, create=create)


async def import_with(package, tmp_path, name, src, key, compact=False):
    """Import ``src`` with ``package``'s tool into a fresh destination;
    returns (stats, canonical state bytes)."""
    if package == "jax":
        dest = await JCore.open(jopts(tmp_path, name))
        stats = await jimport.import_reference_remote(src, dest, key,
                                                      compact=compact)
        return stats, dest.with_state(jcanonical_bytes)
    dest = await Core.open(popts(tmp_path, name))
    stats = await pimport.import_reference_remote(src, dest, key,
                                                  compact=compact)
    return stats, dest.with_state(canonical_bytes)


# ---- blob level ------------------------------------------------------------


@pytest.mark.parametrize("sealer", PACKAGES)
@pytest.mark.parametrize("opener", PACKAGES)
def test_reference_blobs_open_across_the_packages(sealer, opener):
    key = secrets.token_bytes(32)
    payload = codec.pack([ref_mvreg_op({ACTOR_A: 1}, 7)])
    seal = (jexport if sealer == "jax" else pexport).seal_reference_blob
    blob = seal(key, payload, APP_DATA_VERSION)
    opened = (jimport if opener == "jax" else pimport).open_reference_blob
    ver, out = opened(key, blob)
    assert ver == APP_DATA_VERSION and bytes(out) == payload


def test_raw_aead_matches_the_jax_primitive():
    key, nonce = secrets.token_bytes(32), secrets.token_bytes(24)
    data = secrets.token_bytes(300)
    assert seal_raw(key, nonce, data) == jseal_raw(key, nonce, data)
    assert open_raw(key, nonce, seal_raw(key, nonce, data)) == data
    with pytest.raises(AeadError):
        open_raw(secrets.token_bytes(32), nonce, seal_raw(key, nonce, data))
    with pytest.raises(AeadError):
        seal_raw(key, b"short", data)


def test_open_reference_blob_refuses_wrong_key_and_formats():
    key = secrets.token_bytes(32)
    blob = ref_seal(key, b"x")
    with pytest.raises(AeadError):
        pimport.open_reference_blob(secrets.token_bytes(32), blob)
    with pytest.raises(JAeadError):
        jimport.open_reference_blob(secrets.token_bytes(32), blob)
    for bad in (b"\x00" * 40,
                blob[:16] + codec.pack([APP_DATA_VERSION, b"junk"]),
                blob[:16] + b"\xc1"):
        with pytest.raises(pimport.ReferenceFormatError):
            pimport.open_reference_blob(key, bad)
        with pytest.raises(jimport.ReferenceFormatError):
            jimport.open_reference_blob(key, bad)
    with pytest.raises(pimport.ReferenceFormatError):
        pimport.open_reference_blob(b"short", blob)


@pytest.mark.parametrize("named", [True, False])
def test_mvreg_translator_matches_the_jax_one(named):
    ops = [ref_mvreg_op({ACTOR_A: 3, ACTOR_B: 1}, 42, named=named),
           ref_mvreg_op({ACTOR_C: 9}, b"\x01" * 16, named=named)]
    payload = codec.pack(ops)
    got = pimport.mvreg_translator(payload)
    want = jimport.mvreg_translator(payload)
    assert [(o.clock.counters, o.value) for o in got] == \
        [(o.clock.counters, o.value) for o in want]
    with pytest.raises(pimport.ReferenceFormatError):
        pimport.mvreg_translator(codec.pack([[1, 2, 3]]))


# ---- import, end to end -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("compact", [False, True])
def test_import_matches_the_jax_importer(tmp_path, seed, compact):
    """One reference remote, imported by each package: the same stats and
    the same canonical state bytes."""
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, random_history(seed))

    async def go():
        jstats, jstate = await import_with("jax", tmp_path, "j", src, key,
                                           compact)
        pstats, pstate = await import_with("port", tmp_path, "p", src, key,
                                           compact)
        assert (pstats.actors, pstats.op_files, pstats.ops) == \
            (jstats.actors, jstats.op_files, jstats.ops) == (4, 20, 60)
        assert pstats.data_versions == jstats.data_versions == \
            {APP_DATA_VERSION}
        assert pstate == jstate

    run(go())


def test_import_end_to_end_and_a_fresh_replica_rejoins(tmp_path):
    """Three reference actors (A writes 1, B overwrites with 2, C writes 3
    concurrently): import → fold → compact; a fresh replica re-joins from
    the snapshot alone with the same bytes."""
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, {
        ACTOR_A: [[ref_mvreg_op({ACTOR_A: 1}, 1)]],
        ACTOR_B: [[ref_mvreg_op({ACTOR_A: 1, ACTOR_B: 1}, 2)]],
        ACTOR_C: [[ref_mvreg_op({ACTOR_A: 1, ACTOR_C: 1}, 3)]],
    })

    async def go():
        dest = await Core.open(popts(tmp_path, "dest"))
        stats = await pimport.import_reference_remote(src, dest, key,
                                                      compact=True)
        assert (stats.actors, stats.op_files, stats.ops) == (3, 3, 3)
        assert sorted(dest.with_state(lambda s: s.read().values)) == [2, 3]
        fresh = await Core.open(popts(tmp_path, "fresh",
                                      remote=tmp_path / "dest" / "remote"))
        await fresh.read_remote()
        assert fresh.with_state(canonical_bytes) == \
            dest.with_state(canonical_bytes)

    run(go())


def test_import_shifts_versions_to_start_at_one(tmp_path):
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, {ACTOR_A: [
        [ref_mvreg_op({ACTOR_A: 1}, 10)],
        [ref_mvreg_op({ACTOR_A: 2}, 11)],
        [ref_mvreg_op({ACTOR_A: 3}, 12), ref_mvreg_op({ACTOR_A: 4}, 13)],
    ]})

    async def go():
        dest = await Core.open(popts(tmp_path, "dest"))
        stats = await pimport.import_reference_remote(src, dest, key)
        assert (stats.op_files, stats.ops) == (3, 4)
        assert dest.with_state(lambda s: s.read().values) == [13]
        names = sorted(int(n) for n in os.listdir(
            tmp_path / "dest" / "remote" / "ops" / ACTOR_A.hex())
            if not n.startswith("."))
        assert names == [1, 2, 3]

    run(go())


def test_import_skips_reference_states_and_warns(tmp_path, caplog):
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, {ACTOR_A: [[ref_mvreg_op({ACTOR_A: 1}, 5)]]})
    (src / "states").mkdir()
    (src / "states" / "somehash").write_bytes(b"unreadable by design")
    (src / "meta").mkdir()
    (src / "meta" / "m1").write_bytes(b"keys")

    async def go():
        dest = await Core.open(popts(tmp_path, "dest"))
        with caplog.at_level("WARNING"):
            stats = await pimport.import_reference_remote(src, dest, key)
        assert (stats.skipped_states, stats.skipped_metas) == (1, 1)
        assert any("state file" in r.message for r in caplog.records)
        assert dest.with_state(lambda s: s.read().values) == [5]

    run(go())


@pytest.mark.parametrize("package", PACKAGES)
def test_import_refuses_a_gapped_history(tmp_path, package):
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, {ACTOR_A: [
        [ref_mvreg_op({ACTOR_A: i}, i)] for i in (1, 2, 3)]})
    os.remove(src / "ops" / str(uuidm.UUID(bytes=ACTOR_A)) / "1")
    exc = (jimport if package == "jax" else pimport).ReferenceFormatError
    with pytest.raises(exc, match="gap"):
        run(import_with(package, tmp_path, "dest", src, key))


def test_import_refuses_a_remote_without_op_dirs(tmp_path):
    (tmp_path / "ref-remote" / "ops" / "not-a-uuid").mkdir(parents=True)
    with pytest.raises(pimport.ReferenceFormatError, match="no reference"):
        run(import_with("port", tmp_path, "dest", tmp_path / "ref-remote",
                        secrets.token_bytes(32)))


def test_import_cli(tmp_path, capsys):
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, {
        ACTOR_A: [[ref_mvreg_op({ACTOR_A: 1}, 5)]],
        ACTOR_B: [[ref_mvreg_op({ACTOR_A: 1, ACTOR_B: 1}, 6)]],
    })
    argv = [str(src), str(tmp_path / "d-local"), str(tmp_path / "d-remote"),
            "--key-hex", key.hex(), "--compact"]
    assert pimport.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "imported 2 ops in 2 files from 2 actors" in out
    assert jimport.main([str(src), str(tmp_path / "j-local"),
                         str(tmp_path / "j-remote"), "--key-hex", key.hex(),
                         "--compact"]) == 0
    assert capsys.readouterr().out == out

    async def read(remote):
        r = await JCore.open(jopts(tmp_path, f"r-{remote}",
                                   remote=tmp_path / remote))
        await r.read_remote()
        return r.with_state(jcanonical_bytes)

    assert run(read("d-remote")) == run(read("j-remote"))


def test_cli_device_cuda_without_a_card(tmp_path, capsys):
    """``--device cuda`` where no card is: exit 1, the daemon's message;
    a bad device spec: exit 2."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    common = ["--key-hex", "00" * 32]
    assert pimport.main(["s", "l", "r", *common]) == 1
    assert "DeviceUnavailableError" in capsys.readouterr().err
    assert pexport.main(["l", "r", "d", *common, "--data-version-uuid",
                         str(uuidm.UUID(bytes=APP_DATA_VERSION))]) == 1
    assert "DeviceUnavailableError" in capsys.readouterr().err
    assert pimport.main(["s", "l", "r", *common, "--device", "tpu"]) == 2


# ---- export ----------------------------------------------------------------


def test_untranslators_invert_the_translator():
    a, b = uuidm.UUID(int=1).bytes, uuidm.UUID(int=2).bytes
    reg = MVReg()
    reg.apply(reg.write_ctx(a, 41))
    reg.apply(reg.write_ctx(b, 42))
    back = pimport.mvreg_translator(codec.pack(
        pexport.mvreg_state_untranslator(reg)))
    rebuilt = MVReg()
    for op in back:
        rebuilt.apply(op)
    assert canonical_bytes(rebuilt) == canonical_bytes(reg)
    op = reg.write_ctx(a, "x")
    wire = pexport.mvreg_op_untranslator(op)
    assert codec.pack(wire) == jcodec.pack(wire)
    (got,) = pimport.mvreg_translator(codec.pack([wire]))
    assert (got.value, got.clock.counters) == ("x", op.clock.counters)


def populate(tmp_path, package="port"):
    """Three writers on one shared remote with dominated and concurrent
    register writes; returns the first writer, read up to date."""
    core, mk = (Core, popts) if package == "port" else (JCore, jopts)
    shared = tmp_path / "shared" / "remote"

    async def go():
        a = await core.open(mk(tmp_path, "a", remote=shared))
        b = await core.open(mk(tmp_path, "b", remote=shared))
        c = await core.open(mk(tmp_path, "c", remote=shared))
        await a.update(lambda s: s.write_ctx(a.actor_id, 1))
        await b.read_remote()
        await b.update(lambda s: s.write_ctx(b.actor_id, 2))
        await c.update(lambda s: s.write_ctx(c.actor_id, 3))
        await a.read_remote()
        return a

    return run(go())


@pytest.mark.parametrize("mode", ["state", "log"])
def test_export_reimports_identically(tmp_path, mode):
    src = populate(tmp_path)
    key = secrets.token_bytes(32)
    ref_remote = tmp_path / "ref-remote"

    async def go():
        if mode == "state":
            stats = await pexport.export_reference_state(
                src, ref_remote, key, APP_DATA_VERSION)
            assert (stats.op_files, stats.actors, stats.ops) == (1, 1, 2)
        else:
            stats = await pexport.export_reference_log(
                src, ref_remote, key, APP_DATA_VERSION)
            assert (stats.actors, stats.op_files, stats.ops) == (3, 3, 3)
            d = ref_remote / "ops" / str(uuidm.UUID(bytes=src.actor_id))
            assert sorted(os.listdir(d)) == ["0"]
        _, state = await import_with("port", tmp_path, "reimport",
                                     ref_remote, key)
        await src.read_remote()
        assert state == src.with_state(canonical_bytes)

    run(go())


def test_log_export_refuses_a_compacted_source(tmp_path):
    src = populate(tmp_path)
    key = secrets.token_bytes(32)

    async def go():
        await src.compact()
        with pytest.raises(pimport.ReferenceFormatError, match="state"):
            await pexport.export_reference_log(
                src, tmp_path / "ref-remote", key, APP_DATA_VERSION)
        await pexport.export_reference_state(
            src, tmp_path / "ref-remote", key, APP_DATA_VERSION)
        _, state = await import_with("port", tmp_path, "reimport",
                                     tmp_path / "ref-remote", key)
        assert state == src.with_state(canonical_bytes)

    run(go())


def test_log_export_refuses_a_gapped_source(tmp_path):
    src = populate(tmp_path)
    key = secrets.token_bytes(32)

    async def go():
        for i in range(3):
            await src.update(lambda s, i=i: s.write_ctx(src.actor_id, 10 + i))
        ops_dir = tmp_path / "shared" / "remote" / "ops" / src.actor_id.hex()
        versions = sorted(int(n) for n in os.listdir(ops_dir))
        os.remove(ops_dir / str(versions[1]))
        with pytest.raises(pimport.ReferenceFormatError, match="stranded"):
            await pexport.export_reference_log(
                src, tmp_path / "ref-remote", key, APP_DATA_VERSION)

    run(go())


def test_export_of_an_empty_state_writes_nothing(tmp_path):
    async def go():
        src = await Core.open(popts(tmp_path, "empty"))
        stats = await pexport.export_reference_state(
            src, tmp_path / "ref-remote", secrets.token_bytes(32),
            APP_DATA_VERSION)
        assert (stats.op_files, stats.ops) == (0, 0)
        assert not (tmp_path / "ref-remote").exists()
        with pytest.raises(pimport.ReferenceFormatError, match="no op logs"):
            await pexport.export_reference_log(
                src, tmp_path / "ref-remote", secrets.token_bytes(32),
                APP_DATA_VERSION)

    run(go())


def test_export_cli(tmp_path, capsys):
    populate(tmp_path)
    key = secrets.token_bytes(32)
    argv = [str(tmp_path / "a" / "local"), str(tmp_path / "shared" / "remote"),
            str(tmp_path / "ref-remote"), "--key-hex", key.hex(),
            "--data-version-uuid", str(uuidm.UUID(bytes=APP_DATA_VERSION)),
            "--mode", "log", "--device", "cpu"]
    assert pexport.main(argv) == 0
    assert "exported 3 ops in 3 files (log mode, 3 actor(s))" in \
        capsys.readouterr().out
    _, state = run(import_with("jax", tmp_path, "reimport",
                               tmp_path / "ref-remote", key))
    _, pstate = run(import_with("port", tmp_path, "preimport",
                                tmp_path / "ref-remote", key))
    assert state == pstate


# ---- remotes across the packages -------------------------------------------


@pytest.mark.parametrize("exporter", PACKAGES)
@pytest.mark.parametrize("mode", ["state", "log"])
def test_an_exported_remote_imports_alike_in_both_packages(
        tmp_path, exporter, mode):
    """A reference remote exported by either package (from a source
    remote that package wrote) imports into the same canonical state
    under the JAX importer and the port's, equal to the source's."""
    src = populate(tmp_path, exporter)
    key = secrets.token_bytes(32)
    ref_remote = tmp_path / "ref-remote"
    tool = jexport if exporter == "jax" else pexport
    fn = tool.export_reference_state if mode == "state" \
        else tool.export_reference_log

    async def go():
        await fn(src, ref_remote, key, APP_DATA_VERSION)
        await src.read_remote()
        want = src.with_state(jcanonical_bytes if exporter == "jax"
                              else canonical_bytes)
        _, jstate = await import_with("jax", tmp_path, "j", ref_remote, key)
        _, pstate = await import_with("port", tmp_path, "p", ref_remote, key)
        assert jstate == pstate == want

    run(go())


def test_migration_round_trip_keeps_the_bytes(tmp_path):
    """Reference remote → port import (compacted) → port state export →
    import again: the same canonical bytes at every step, and the JAX
    importer agrees on the re-exported remote."""
    key = secrets.token_bytes(32)
    src = tmp_path / "ref-remote"
    write_ref_remote(src, key, random_history(5, n_actors=6, n_files=4))

    async def go():
        dest = await Core.open(popts(tmp_path, "dest"))
        await pimport.import_reference_remote(src, dest, key, compact=True)
        first = dest.with_state(canonical_bytes)
        await pexport.export_reference_state(
            dest, tmp_path / "back", key, APP_DATA_VERSION)
        _, again = await import_with("port", tmp_path, "again",
                                     tmp_path / "back", key, compact=True)
        _, jagain = await import_with("jax", tmp_path, "jagain",
                                      tmp_path / "back", key)
        assert again == jagain == first

    run(go())
