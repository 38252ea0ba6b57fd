"""The plain reference against published vectors, against what the port
seals, and against small runs of the cell through the plain PyTorch
path (``TorchAccelerator(device="cpu")``)."""

import os

import numpy as np
import pytest

from harness import cells, run_small
from portbench import gen
from portbench.reference import msgpack, orset, sealed, xchacha


def test_poly1305_rfc8439_vector():
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a8"
                        "0103808afb0db2fd4abff6af4149f51b")
    tag = xchacha.poly1305(key, b"Cryptographic Forum Research Group")
    assert tag.hex() == "a8061dc1305136c6c22b8baf0c0127a9"


def test_hchacha20_vector():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a0000000031415927")
    assert xchacha.hchacha20(key, nonce).hex() == (
        "82413b4227b27bfed30e42508a877d73a0f9e4d58a74a853c12ec41326d3ecdc")


def test_chacha20_block_vector():
    key = bytes(range(32))
    nonce = bytes.fromhex("000000090000004a00000000")
    block = xchacha.keystream(key, nonce, 1, 1)
    assert block[:16].hex() == "10f1e7e4d13b5915500fdd1fa32071c4"


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 70001])
def test_open_matches_the_ports_seal(n):
    from crdt_enc_tpu_torch.backends import xchacha as port_xchacha

    rng = np.random.default_rng(n)
    key, nonce = rng.bytes(32), rng.bytes(24)
    data = rng.bytes(n)
    ct = port_xchacha.seal_raw(key, nonce, data)
    assert xchacha.open_xchacha(key, nonce, ct) == data
    bad = bytearray(ct)
    bad[-1] ^= 1
    with pytest.raises(xchacha.TagMismatch):
        xchacha.open_xchacha(key, nonce, bytes(bad))


def test_msgpack_decodes_what_the_port_packs():
    from crdt_enc_tpu_torch.utils import codec

    obj = {b"c": {b"a" * 16: 2**40, b"b" * 16: 7}, b"e": {0: {b"a" * 16: 300},
           -5: {}}, b"x": [None, True, False, "text", 1.5, -2**40, 65535,
                            b"\x00" * 70000, list(range(20))]}
    expect = {b"c": {b"a" * 16: 2**40, b"b" * 16: 7},
              b"e": {0: {b"a" * 16: 300}, -5: {}},
              b"x": (None, True, False, "text", 1.5, -2**40, 65535,
                     b"\x00" * 70000, tuple(range(20)))}
    assert msgpack.unpack(codec.pack(obj)) == expect
    with pytest.raises(ValueError):
        msgpack.unpack(codec.pack(obj)[:-1])


def test_reference_fold_equals_the_ports_host_loop():
    from crdt_enc_tpu_torch.models.orset import AddOp, ORSet, RmOp
    from crdt_enc_tpu_torch.models.vclock import Dot, VClock

    R = 6
    cols = gen.columns(11, R, 16, 40, 10, 5)
    actors = gen.actor_ids(11, R)
    state = ORSet()
    for k, m, a, c in zip(*(x.tolist() for x in cols)):
        ab = actors[a]
        state.apply(AddOp(m, Dot(ab, c)) if k == 0 else RmOp(m, VClock({ab: c})))
    ref = orset.fold(cols, R)
    index = {a: i for i, a in enumerate(actors)}
    assert orset.judge(ref, orset.encode(state.to_obj(), index, R)) == {
        "cells_off": 0, "clock_off": 0}
    obj = state.to_obj()
    m = min(obj[b"e"])
    a = next(iter(obj[b"e"][m]))
    obj[b"e"][m][a] += 1
    assert orset.judge(ref, orset.encode(obj, index, R))["cells_off"] == 2


def test_sealed_blob_opens_with_the_frozen_contract():
    import asyncio

    from crdt_enc_tpu_torch import Core, HostAccelerator, MemoryRemote, MemoryStorage

    from portbench import port

    key = os.urandom(32)

    async def seal():
        core = await Core.open(port.options(MemoryStorage(MemoryRemote()),
                                            HostAccelerator(), key))
        return await core._seal([1, {b"k": 2}])

    blob = asyncio.run(seal())
    assert sealed.open_payload(blob, key, port.DATA_VERSION) == (1, {b"k": 2})
    with pytest.raises(sealed.BadBlob):
        sealed.open_payload(blob, os.urandom(32), port.DATA_VERSION)


@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("seed", [0, 2**31 + 11])
def test_a_small_run_of_each_cell_is_correct(monkeypatch, workload, seed):
    res = run_small(monkeypatch, workload, seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0
    assert "compact_rss_mb" in res["metrics"]  # every driver reports it
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["checks"].values())


@pytest.mark.parametrize("workload", cells())
def test_a_traced_small_run_reports_per_layer_metrics(monkeypatch, workload):
    res = run_small(monkeypatch, workload, 3, trace=1)
    assert res["correct"]
    assert res["metrics"], "the span readers found nothing"
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
