"""The system under test: how the benchmark opens the port's replicas.

Everything here is the port's public surface (``Core``, ``OpenOptions``,
the storages, the cryptors, ``TorchAccelerator``), set up as a
deployment would: encrypted with XChaCha20-Poly1305, the cell's CRDT
adapter (the OR-Set's by default), the defaults of every switch, and the
widths the configuration pins.  The one seam is the data key: the
cryptor's key generation returns the key the benchmark drew from the
seed, so the reference can open what the program sealed without taking
anything the program made.
"""

from __future__ import annotations

import uuid

DATA_VERSION = uuid.UUID("c3b80d17-42fe-4e95-b7a8-2d50c61e9f07").bytes


def seeded_cryptor(key: bytes):
    """An ``XChaChaCryptor`` whose generated data key is ``key``."""
    from crdt_enc_tpu_torch.backends import XChaChaCryptor
    from crdt_enc_tpu_torch.utils.version_bytes import VersionBytes
    from crdt_enc_tpu_torch.utils.versions import XCHACHA_KEY_VERSION_1

    class SeededCryptor(XChaChaCryptor):
        async def gen_key(self):
            return VersionBytes(XCHACHA_KEY_VERSION_1, key)

    return SeededCryptor()


def options(storage, accel, key: bytes, adapter=None):
    """``OpenOptions`` of an encrypted replica that joins (or creates) the
    remote behind ``storage``: of an OR-Set, unless ``adapter`` gives
    another type."""
    from crdt_enc_tpu_torch import OpenOptions, PlainKeyCryptor, orset_adapter

    return OpenOptions(
        storage=storage, cryptor=seeded_cryptor(key),
        key_cryptor=PlainKeyCryptor(),
        adapter=orset_adapter() if adapter is None else adapter,
        supported_data_versions=(DATA_VERSION,),
        current_data_version=DATA_VERSION, accelerator=accel, create=True)


def pin_widths(widths: dict) -> None:
    """The host widths the configuration pins, applied before the port
    builds any pool."""
    import torch

    torch.set_num_threads(int(widths["torch_threads"]))


def card_accelerator(widths: dict, device: str = "cuda"):
    from crdt_enc_tpu_torch import TorchAccelerator

    return TorchAccelerator(device=device,
                            stream_producers=int(widths["stream_producers"]))


def plain_state(state) -> dict:
    """A program ``ORSet`` read as plain dicts in the snapshot's shape
    (``{b"c": clock, b"e": entries, b"d": deferred}``): what the
    reference judges of the in-memory state."""
    return {
        b"c": dict(state.clock.counters),
        b"e": {m: dict(v) for m, v in state.entries.items() if v},
        b"d": {m: {a: c for a, c in v.items() if c > state.clock.get(a)}
               for m, v in state.deferred.items()
               if any(c > state.clock.get(a) for a, c in v.items())},
    }
