"""Strong-read tier: linearizable reads at the stability watermark.

The port's copy of ``crdt_enc_tpu/read/``:

* :mod:`.stable` — the **stable prefix**: a second, monotone state per
  replica folded only from ops and snapshots covered by the stability
  watermark.  ``Core.stable_prefix()`` advances and views it,
  ``Core.read(linearizable=True)`` / ``contains`` / ``value`` answer
  from it, and :class:`StalenessError` is the refusal when the
  watermark cannot cover the request.
* :mod:`.policy` — :class:`MembershipPolicy`: an expected replica set
  and/or the decay of provably silent replicas out of the watermark's
  denominator, surfaced on every status (never a silent drop).
"""

from .policy import MembershipPolicy
from .stable import ReadResult, StablePrefix, StableView, StalenessError

__all__ = [
    "MembershipPolicy",
    "ReadResult",
    "StablePrefix",
    "StableView",
    "StalenessError",
]
