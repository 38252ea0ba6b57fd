"""Delta-state replication: the port's copy of ``crdt_enc_tpu/delta``.

Full-state snapshots make the remote the fan-in bottleneck: every
consumer re-downloads O(state) bytes even when only a handful of ops
landed since its last read.  Alongside each compacted snapshot the core
seals an encrypted **delta snapshot** — the state change since the
sealer's previous snapshot, tagged with both endpoint cursors and the
sealer's causal stability watermark — so an incremental consumer folds
``full-at-base + delta chain`` instead of re-reading the full snapshot,
falling back to the snapshot path on any gap, GC'd link or fingerprint
doubt (counted in ``delta_fallbacks``, never silent).

* :mod:`.codec` — per-CRDT-type delta codecs (OR-Set, G-Counter,
  PN-Counter; the resettable counter rides the OR-Set codec);
* :mod:`.wire` — the sealed delta payload;
* :mod:`.compose` — the resettable counter as an OR-Set-typed adapter.

Deltas live in a per-sealer versioned log (``remote/deltas/
<actor-hex>/<N>``, the op-log idiom, byte for byte the JAX package's
layout, so both packages read one remote): consumed prefixes are removed
at compaction, own logs are bounded at :data:`MAX_CHAIN` links, and
anything missing falls back to the snapshot path.
"""

from __future__ import annotations

# longest own delta chain a sealer keeps: a consumer more than
# MAX_CHAIN compactions behind re-reads the full snapshot once and
# rejoins the chain — bounding both remote clutter and the worst-case
# chain a reader walks
MAX_CHAIN = 16

from .codec import codec_for, orset_delta_apply, orset_delta_diff  # noqa: E402
from .compose import (  # noqa: E402
    ResettableCounter,
    UndoError,
    rcounter_adapter,
)
from .wire import DeltaRecord, build_delta_obj, parse_delta_obj  # noqa: E402

__all__ = [
    "MAX_CHAIN",
    "codec_for",
    "orset_delta_diff",
    "orset_delta_apply",
    "DeltaRecord",
    "build_delta_obj",
    "parse_delta_obj",
    "ResettableCounter",
    "UndoError",
    "rcounter_adapter",
]
