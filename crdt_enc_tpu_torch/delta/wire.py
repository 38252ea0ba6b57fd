"""The sealed delta payload: the port's copy of
``crdt_enc_tpu/delta/wire.py``, the same wire form byte for byte.

A delta file travels the same three-layer wire as every other object
(``core.Core._open_sealed``); this module owns only the decrypted inner
object.  Every field is load-bearing for the fallback discipline:

* ``base`` / ``new`` — the content-addressed NAMES of the two endpoint
  snapshots.  Names are fingerprints (SHA3 of the sealed bytes), so
  "has the consumer merged exactly this base?" is a set-membership
  test against ``read_states`` — any doubt (unknown base, renamed
  snapshot, adapter mismatch) falls back to the full snapshot.
* ``bcur`` / ``ncur`` — the op-log cursors of the two snapshots; a
  consumer that applies the delta advances its ingest cursor exactly
  as if it had merged the new snapshot.
* ``s`` — the sealer's actor id: the cursor-matrix row this delta
  teaches (obs/replication.py), and the log directory it must be
  filed under.
* ``wm`` — the sealer's causal stability watermark at seal time
  (the cursor-matrix math of ``obs/replication.py``): the causal tag anchoring the chain — a
  reader can see how far behind fleet-stable the chain base was.
* ``a`` — the adapter name; selects the delta codec.
* ``d`` — the codec delta object (delta/codec.py).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..models.vclock import VClock

DELTA_WIRE_VERSION = 1


@dataclass
class DeltaRecord:
    base_name: str  # "" when the sealer had no base (no delta is sealed then)
    new_name: str
    base_cursor: VClock
    new_cursor: VClock
    sealer: bytes
    adapter: bytes
    watermark: dict  # actor -> stable version at seal time
    delta_obj: object


def build_delta_obj(rec: DeltaRecord) -> dict:
    return {
        b"v": DELTA_WIRE_VERSION,
        b"base": rec.base_name.encode(),
        b"new": rec.new_name.encode(),
        b"bcur": rec.base_cursor.to_obj(),
        b"ncur": rec.new_cursor.to_obj(),
        b"s": rec.sealer,
        b"a": rec.adapter,
        b"wm": {bytes(a): int(c) for a, c in sorted(rec.watermark.items())},
        b"d": rec.delta_obj,
    }


def parse_delta_obj(obj) -> DeltaRecord:
    """Decode + validate one delta payload.  Raises ``ValueError`` on
    any malformed field — the consumer counts it as a fallback."""
    if not isinstance(obj, dict):
        raise ValueError("delta payload is not a map")
    v = obj.get(b"v")
    if v != DELTA_WIRE_VERSION:
        raise ValueError(f"unsupported delta wire version {v!r}")
    sealer = obj.get(b"s")
    if not isinstance(sealer, (bytes, bytearray, memoryview)) or len(sealer) != 16:
        raise ValueError("delta sealer id is not 16 bytes")
    adapter = obj.get(b"a")
    if not isinstance(adapter, (bytes, bytearray, memoryview)) or not adapter:
        raise ValueError("delta adapter name missing")
    new_name = obj.get(b"new")
    if not isinstance(new_name, (bytes, bytearray, memoryview)) or not new_name:
        raise ValueError("delta target snapshot name missing")
    base_name = obj.get(b"base", b"")
    if not isinstance(base_name, (bytes, bytearray, memoryview)):
        raise ValueError("delta base snapshot name malformed")
    wm = obj.get(b"wm")
    if not isinstance(wm, dict):
        raise ValueError("delta base watermark missing")
    bcur, ncur = obj.get(b"bcur"), obj.get(b"ncur")
    if not isinstance(bcur, dict) or not isinstance(ncur, dict):
        raise ValueError("delta cursors missing")
    if b"d" not in obj:
        raise ValueError("delta body missing")
    return DeltaRecord(
        base_name=bytes(base_name).decode(),
        new_name=bytes(new_name).decode(),
        base_cursor=VClock.from_obj(bcur),
        new_cursor=VClock.from_obj(ncur),
        sealer=bytes(sealer),
        adapter=bytes(adapter),
        watermark={bytes(a): int(c) for a, c in wm.items()},
        delta_obj=obj[b"d"],
    )
