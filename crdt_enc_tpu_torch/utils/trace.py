"""Per-phase spans, counters, gauges and an optional event log: the
process-wide registry.

A copy of the span/counter core of ``crdt_enc_tpu.utils.trace`` (there a
shim onto ``crdt_enc_tpu/obs/record.py``), cut to what the port uses:
wall-clock spans around the fold and merge phases (``fold.columns``,
``fold.vocab``, ``fold.planes``, ``fold.device``, ``fold.writeback``,
``merge.planes``, ``merge.device``, ``merge.writeback``) and the streaming
stages (``stream.*``, ``session.*``, ``ops.chunk_*``), counters such as
``h2d_bytes``, gauges such as ``stream_producers``, and a bounded log of
span occurrences (off by default) from which the streaming tests read the
overlap of pipeline stages.  Histograms and counter taps stay in the JAX
package until a slice needs them.

Usage::

    from crdt_enc_tpu_torch.utils import trace

    with trace.span("fold.device"):
        ...
    with trace.span("stream.fold", meta=k):  # meta goes to the event log
        ...
    trace.add("h2d_bytes", n)
    trace.gauge("stream_producers", 4)
    trace.snapshot()  # {"spans": {name: {"count", "seconds", "max_ms"}}, "counters": {...}, "gauges": {...}}
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from contextlib import contextmanager

logger = logging.getLogger("crdt_enc_tpu_torch.trace")

EVENT_CAPACITY = 65536

_lock = threading.Lock()
# name -> [count, total_seconds, max_seconds]
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}
_gauges: dict[str, float] = {}
_events: deque = deque(maxlen=EVENT_CAPACITY)
_events_enabled = False


@contextmanager
def span(name: str, meta=None):
    """Time a phase.  Re-entrant: every exit accumulates (count, seconds,
    max) under ``name``.  ``meta`` (e.g. a chunk index) is recorded only
    in the event log, never in the aggregate."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        dt = t1 - t0
        with _lock:
            slot = _spans.setdefault(name, [0, 0.0, 0.0])
            slot[0] += 1
            slot[1] += dt
            if dt > slot[2]:
                slot[2] = dt
            if _events_enabled:
                if len(_events) == _events.maxlen:
                    _counters["events_dropped"] = (
                        _counters.get("events_dropped", 0) + 1)
                t = threading.current_thread()
                _events.append({"name": name, "t0": t0, "t1": t1,
                                "meta": meta, "thread": t.name})
        logger.debug("span %s: %.6fs", name, dt)


def add(name: str, n: int = 1) -> None:
    """Bump a counter (e.g. bytes uploaded host to device)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a gauge to its latest value (e.g. a pool's width)."""
    with _lock:
        _gauges[name] = value


def enable_events(on: bool = True) -> None:
    """Turn the per-occurrence span log on or off."""
    global _events_enabled
    with _lock:
        _events_enabled = on


def events() -> list[dict]:
    """A copy of the recorded span occurrences, in completion order:
    name, t0, t1 (``time.perf_counter`` seconds, comparable across
    threads), meta and the recording thread's name."""
    with _lock:
        return [dict(e) for e in _events]


def snapshot() -> dict:
    """A consistent copy: {"spans": {name: {"count", "seconds",
    "max_ms"}}, "counters": {...}, "gauges": {...}}."""
    with _lock:
        return {
            "spans": {
                k: {"count": c, "seconds": s, "max_ms": mx * 1e3}
                for k, (c, s, mx) in _spans.items()
            },
            "counters": dict(_counters),
            "gauges": dict(_gauges),
        }


def reset() -> None:
    """Clear every span, counter, gauge and event, and turn the event log
    off."""
    global _events_enabled
    with _lock:
        _spans.clear()
        _counters.clear()
        _gauges.clear()
        _events.clear()
        _events_enabled = False
