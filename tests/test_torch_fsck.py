"""The port's remote integrity checker (crdt_enc_tpu_torch.tools.fsck)
against the JAX package's.

Every case of tests/test_fsck.py runs on a remote written by either
package (``writer``): the damage is inflicted once, then both packages'
``fsck_remote`` walk the same remote, and the port's issue list
(severity, family, object) must equal the JAX one.  A healthy remote
sealed by either package reads clean in both checkers.
"""

from __future__ import annotations

import asyncio
import os

import pytest

from crdt_enc_tpu.backends import FsStorage as JFs
from crdt_enc_tpu.backends import PlainKeyCryptor as JPlain
from crdt_enc_tpu.backends import XChaChaCryptor as JXChaCha
from crdt_enc_tpu.core import Core as JCore
from crdt_enc_tpu.core import OpenOptions as JOpenOptions
from crdt_enc_tpu.core import orset_adapter as jorset
from crdt_enc_tpu.models import ORSet as JORSet
from crdt_enc_tpu.tools import fsck as jfsck
from crdt_enc_tpu_torch.backends import FsStorage, PlainKeyCryptor, \
    XChaChaCryptor
from crdt_enc_tpu_torch.core.adapters import HostAccelerator, orset_adapter
from crdt_enc_tpu_torch.core.core import Core, OpenOptions
from crdt_enc_tpu_torch.models import ORSet
from crdt_enc_tpu_torch.tools import fsck as pfsck
from crdt_enc_tpu_torch.utils.versions import DEFAULT_DATA_VERSION_1

WRITERS = ["jax", "port"]


def run(coro):
    return asyncio.run(coro)


def make_opts(tmp_path, name, writer):
    storage_cls = JFs if writer == "jax" else FsStorage
    common = dict(
        storage=storage_cls(str(tmp_path / name), str(tmp_path / "remote")),
        supported_data_versions=(DEFAULT_DATA_VERSION_1,),
        current_data_version=DEFAULT_DATA_VERSION_1,
        create=True,
    )
    if writer == "jax":
        return JOpenOptions(cryptor=JXChaCha(), key_cryptor=JPlain(),
                            adapter=jorset(), **common)
    return OpenOptions(cryptor=XChaChaCryptor(), key_cryptor=PlainKeyCryptor(),
                       adapter=orset_adapter(), accelerator=HostAccelerator(),
                       **common)


async def populate(tmp_path, writer):
    core = JCore if writer == "jax" else Core
    a = await core.open(make_opts(tmp_path, "a", writer))
    for m in range(6):
        await a.update(lambda s, m=m: s.add_ctx(a.actor_id, m))
    await a.compact()
    b = await core.open(make_opts(tmp_path, "b", writer))
    for m in range(3):
        await b.update(lambda s, m=m: s.add_ctx(b.actor_id, 100 + m))
    return a, b


def issues(report) -> list:
    return [(i.severity, i.family, i.obj) for i in report.issues]


def both(tmp_path, *, jkc=None, pkc=None):
    """Both checkers over the remote; the port's report must equal the
    JAX one in its issues and counts.  Returns the port's report."""
    jrep = run(jfsck.fsck_remote(
        JFs(str(tmp_path / "fsck-j"), str(tmp_path / "remote")),
        JXChaCha(), jkc if jkc is not None else JPlain()))
    prep = run(pfsck.fsck_remote(
        FsStorage(str(tmp_path / "fsck-p"), str(tmp_path / "remote")),
        XChaChaCryptor(), pkc if pkc is not None else PlainKeyCryptor()))
    assert issues(prep) == issues(jrep)
    assert prep.ok == jrep.ok
    assert prep.summary() == jrep.summary()
    return prep


def first_op_file(tmp_path):
    ops_root = tmp_path / "remote" / "ops"
    return ops_root / sorted(os.listdir(ops_root))[0]


@pytest.mark.parametrize("writer", WRITERS)
def test_healthy_remote_is_ok(tmp_path, writer):
    run(populate(tmp_path, writer))
    report = both(tmp_path)
    assert report.ok, [str(i) for i in report.issues]
    assert report.state_files == 1
    assert report.op_files == 3
    assert report.ops_decoded == 3
    assert report.keys_found >= 1
    assert "OK" in report.summary()


@pytest.mark.parametrize("writer", WRITERS)
def test_detects_tampered_op_file(tmp_path, writer):
    run(populate(tmp_path, writer))
    target = first_op_file(tmp_path) / "1"
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 1
    target.write_bytes(bytes(raw))
    report = both(tmp_path)
    assert not report.ok
    assert any(i.family == "ops" for i in report.issues)


@pytest.mark.parametrize("writer", WRITERS)
def test_detects_op_log_gap(tmp_path, writer):
    run(populate(tmp_path, writer))
    os.remove(first_op_file(tmp_path) / "2")
    report = both(tmp_path)
    assert not report.ok
    assert any("gap" in i.problem for i in report.issues)


@pytest.mark.parametrize("writer", WRITERS)
def test_detects_content_address_mismatch_and_torn_state(tmp_path, writer):
    run(populate(tmp_path, writer))
    states = tmp_path / "remote" / "states"
    name = os.listdir(states)[0]
    blob = (states / name).read_bytes()
    (states / name).write_bytes(blob[: len(blob) // 2])
    report = both(tmp_path)
    assert not report.ok
    assert any(i.family == "states" and "address" in i.problem
               for i in report.issues)


@pytest.mark.parametrize("writer", WRITERS)
def test_detects_damaged_key_metadata(tmp_path, writer):
    run(populate(tmp_path, writer))
    meta = tmp_path / "remote" / "meta"
    for n in os.listdir(meta):
        os.remove(meta / n)
    report = both(tmp_path)
    assert not report.ok
    assert any(i.family == "keys" or "unknown key" in i.problem
               for i in report.issues)


@pytest.mark.parametrize("writer", WRITERS)
def test_cli(tmp_path, capsys, writer):
    run(populate(tmp_path, writer))
    rc = pfsck.main([str(tmp_path / "remote")])
    out = capsys.readouterr().out
    assert rc == 0 and "OK" in out
    assert jfsck.main([str(tmp_path / "remote")]) == 0
    capsys.readouterr()
    target = first_op_file(tmp_path) / "1"
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 1
    target.write_bytes(bytes(raw))
    rc = pfsck.main([str(tmp_path / "remote"), "--obs"])
    captured = capsys.readouterr()
    assert rc == 1 and "DAMAGED" in captured.out
    assert "fsck.ops" in captured.err  # --obs prints the phase table
    assert jfsck.main([str(tmp_path / "remote")]) == 1
    jout = capsys.readouterr().out
    assert jout.splitlines()[-1] == captured.out.splitlines()[-1]


@pytest.mark.parametrize("writer", WRITERS)
def test_post_compaction_tail_is_healthy(tmp_path, writer):
    _a, b = run(populate(tmp_path, writer))

    async def more():
        await b.compact()
        for m in range(2):
            await b.update(lambda s, m=m: s.add_ctx(b.actor_id, 200 + m))

    run(more())
    report = both(tmp_path)
    assert report.ok, [str(i) for i in report.issues]
    assert report.op_files == 2


@pytest.mark.parametrize("writer", WRITERS)
def test_detects_malformed_snapshot_sealer(tmp_path, writer):
    a, _b = run(populate(tmp_path, writer))

    async def forge():
        state_obj = a.with_state(lambda s: a.adapter.state_to_obj(s))
        bad = await a._seal([state_obj, {}, b"short"])
        await a.storage.store_state(bad)

    run(forge())
    report = both(tmp_path)
    assert not report.ok
    assert any("sealer id is not 16 bytes" in i.problem
               for i in report.issues)


def damaged(base, orset):
    class DamagedKeyCryptor(base):
        async def set_remote_meta(self, reg):
            await super().set_remote_meta(reg)
            if self._core is not None:
                keys = self._core.keys
                keys.keys = orset()  # material gone, latest id kept
                keys._index = None

    return DamagedKeyCryptor()


@pytest.mark.parametrize("writer", WRITERS)
def test_dangling_latest_key_reported_not_crash(tmp_path, writer):
    run(populate(tmp_path, writer))
    assert both(tmp_path).ok
    report = both(tmp_path, jkc=damaged(JPlain, JORSet),
                  pkc=damaged(PlainKeyCryptor, ORSet))
    assert not report.ok
    assert any(i.family == "keys" for i in report.issues)


@pytest.mark.parametrize("writer", WRITERS)
def test_verify_checkpoint_matches(tmp_path, writer):
    """``--verify-checkpoint``: a compacting replica's local checkpoint
    verifies clean in both packages' checkers."""
    run(populate(tmp_path, writer))
    args = [str(tmp_path / "remote"), "--verify-checkpoint",
            str(tmp_path / "a")]
    assert pfsck.main(args) == 0
    assert jfsck.main(args) == 0
