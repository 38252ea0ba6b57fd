"""The upload accounting that OBS001 holds the port to, on both devices.

The CrdtMap fold's scatter phase (``ops/map_device.py``,
``crdtmap_scatter_device``) uploads its int64 columns and counts them in
``h2d_bytes`` where they cross to a card, as ``TorchAccelerator._upload``
does; on the CPU nothing crosses and nothing is counted.  The map
history is made here from a seed with the port's own models, and the
file imports no JAX, so its card case runs on the card's machine:
``python3 -m pytest tests/test_torch_upload_counts.py`` there.
"""

from __future__ import annotations

import random
import uuid

import numpy as np
import pytest
import torch

import crdt_enc_tpu_torch.models as P
from crdt_enc_tpu_torch.models import canonical_bytes
from crdt_enc_tpu_torch.ops import map_device
from crdt_enc_tpu_torch.parallel.accel import TorchAccelerator
from crdt_enc_tpu_torch.utils import codec, trace

ACTORS = [uuid.UUID(int=i + 1).bytes for i in range(4)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda")


def map_history(seed: int, n_ops: int = 80):
    """A CrdtMap<orset> oracle and its ops as op-file payloads, three ops
    a file, each file within one actor's stream: adds, member removes and
    key removes over three keys."""
    rng = random.Random(seed)
    oracle = P.CrdtMap(child=b"orset")
    streams = {a: [] for a in ACTORS}
    for _ in range(n_ops):
        actor, key = rng.choice(ACTORS), f"k{rng.randrange(3)}"
        roll, child = rng.random(), oracle.get(key)
        if roll < 0.15:
            op = oracle.rm_ctx(key)
            if op.ctx.is_empty():
                continue
        elif roll < 0.3 and child is not None and child.contains(10):
            op = oracle.update_ctx(actor, key, lambda c, d: c.rm_ctx(10))
        else:
            member = 10 + rng.randrange(3)
            op = oracle.update_ctx(actor, key,
                                   lambda c, d: P.AddOp(member, d))
        oracle.apply(op)
        streams[actor].append(oracle.op_to_obj(op))
    payloads = [codec.pack(ops[i : i + 3])
                for ops in streams.values() for i in range(0, len(ops), 3)]
    return oracle, payloads


def fold_on(device, oracle, payloads):
    state = P.CrdtMap(child=b"orset")
    accel = TorchAccelerator(device=device, min_device_batch=1)
    assert accel.fold_payloads(state, payloads, actors_hint=ACTORS)
    assert canonical_bytes(state) == canonical_bytes(oracle)


def scatter_call(monkeypatch, seed):
    """The arguments a CPU fold hands ``crdtmap_scatter_device``, and its
    results."""
    seen = []
    real = map_device.crdtmap_scatter_device

    def capture(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, kw, out))
        return out

    monkeypatch.setattr(map_device, "crdtmap_scatter_device", capture)
    fold_on("cpu", *map_history(seed))
    monkeypatch.setattr(map_device, "crdtmap_scatter_device", real)
    (call,) = seen
    return call


@pytest.mark.parametrize("seed", range(3))
def test_map_scatter_counts_no_upload_on_the_cpu(seed):
    """On the CPU the fold takes the device route (the scatter phase in
    PyTorch) and counts no ``h2d_bytes``."""
    trace.reset()
    try:
        fold_on("cpu", *map_history(seed))
        snap = trace.snapshot()
        assert "map.scatter_device" in snap["spans"]
        assert "h2d_bytes" not in snap["counters"]
    finally:
        trace.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_map_scatter_counts_its_upload_on_the_card(dev, monkeypatch, seed):
    """On the card the scatter phase counts exactly the bytes of the
    int64 columns it uploads, its results equal the CPU's, and the whole
    fold on the card gives the oracle's bytes."""
    args, kw, cpu_out = scatter_call(monkeypatch, seed)
    uploaded = []
    real_from_numpy = torch.from_numpy

    def from_numpy(a):
        uploaded.append(a.nbytes)
        return real_from_numpy(a)

    trace.reset()
    try:
        monkeypatch.setattr(torch, "from_numpy", from_numpy)
        out = map_device.crdtmap_scatter_device(*args, **{**kw, "device": dev})
        monkeypatch.setattr(torch, "from_numpy", real_from_numpy)
        assert trace.snapshot()["counters"]["h2d_bytes"] == sum(uploaded) > 0
        trace.reset()
        fold_on(dev, *map_history(seed))
        assert trace.snapshot()["counters"]["h2d_bytes"] >= sum(uploaded)
    finally:
        trace.reset()
    for a, b in zip(out, cpu_out):
        assert np.array_equal(np.asarray(a), np.asarray(b))
