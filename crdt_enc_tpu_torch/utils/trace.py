"""Per-phase spans and counters: the process-wide registry.

A copy of the span/counter core of ``crdt_enc_tpu.utils.trace`` (there a
shim onto ``crdt_enc_tpu/obs/record.py``), cut to what the port uses:
wall-clock spans around the fold and merge phases (``fold.columns``,
``fold.vocab``, ``fold.planes``, ``fold.device``, ``fold.writeback``,
``merge.planes``, ``merge.device``, ``merge.writeback``) and counters such
as ``h2d_bytes``.
Histograms, the event ring and counter taps stay in the JAX package until
a slice needs them.

Usage::

    from crdt_enc_tpu_torch.utils import trace

    with trace.span("fold.device"):
        ...
    trace.add("h2d_bytes", n)
    trace.snapshot()  # {"spans": {name: {"count", "seconds", "max_ms"}}, "counters": {...}}
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

logger = logging.getLogger("crdt_enc_tpu_torch.trace")

_lock = threading.Lock()
# name -> [count, total_seconds, max_seconds]
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}


@contextmanager
def span(name: str):
    """Time a phase.  Re-entrant: every exit accumulates (count, seconds,
    max) under ``name``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            slot = _spans.setdefault(name, [0, 0.0, 0.0])
            slot[0] += 1
            slot[1] += dt
            if dt > slot[2]:
                slot[2] = dt
        logger.debug("span %s: %.6fs", name, dt)


def add(name: str, n: int = 1) -> None:
    """Bump a counter (e.g. bytes uploaded host to device)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def snapshot() -> dict:
    """A consistent copy: {"spans": {name: {"count", "seconds",
    "max_ms"}}, "counters": {...}}."""
    with _lock:
        return {
            "spans": {
                k: {"count": c, "seconds": s, "max_ms": mx * 1e3}
                for k, (c, s, mx) in _spans.items()
            },
            "counters": dict(_counters),
        }


def reset() -> None:
    """Clear every span and counter."""
    with _lock:
        _spans.clear()
        _counters.clear()
