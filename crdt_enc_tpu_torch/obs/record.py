"""Per-phase spans, counters, gauges, histograms and an optional event
log: the process-wide registry.

The port's copy of ``crdt_enc_tpu/obs/record.py``;
``crdt_enc_tpu_torch.utils.trace`` is this same module object (it
replaces itself in ``sys.modules``), so every ``trace.*`` call site and
every ``record.*`` call site share one registry.

Aggregates are count + total seconds + max + a **bounded log-scale
histogram** (quarter-octave buckets, each quantile within ~±9% of the
true value): ``snapshot()`` publishes p50/p95/p99 per span.  The fold
service's per-tenant latency (``serve.tenant``, fed by :func:`observe`)
and its seal-latency SLO read them.

Usage::

    from crdt_enc_tpu_torch.utils import trace

    with trace.span("fold.device"):
        ...
    with trace.span("stream.fold", meta=k):  # meta goes to the event log
        ...
    trace.add("h2d_bytes", n)
    trace.gauge("stream_producers", 4)
    trace.observe("serve.tenant", 0.012)  # a duration measured elsewhere
    with trace.counter_tap() as mine:  # this task tree's increments only
        ...
    trace.snapshot()  # {"spans": {name: {"count", "seconds", "max_ms",
                      #   "p50_ms", "p95_ms", "p99_ms"}}, "counters", "gauges"}

The event log (off by default) records one entry per span exit: name,
t0, t1 (``time.perf_counter`` seconds, comparable across threads), meta
and the recording thread's name; the streaming tests read pipeline
overlap from it.  It is a ring buffer of ``EVENT_CAPACITY`` entries;
overflow bumps the ``events_dropped`` counter.
"""

from __future__ import annotations

import contextvars
import logging
import math
import threading
import time
from collections import deque
from contextlib import contextmanager

logger = logging.getLogger("crdt_enc_tpu_torch.trace")

EVENT_CAPACITY = 65536

_lock = threading.Lock()
# name -> [count, total_seconds, max_seconds, {bucket_index: count}]
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}
_gauges: dict[str, float] = {}
_events: deque = deque(maxlen=EVENT_CAPACITY)
_events_enabled = False

# --------------------------------------------------------------- histogram
# Quarter-octave log2 buckets: index = floor(4·log2(dt)), clamped to
# [2^-30 s, 2^19 s], so a span's table has at most ~200 slots.
_HIST_SCALE = 4
_HIST_MIN_IDX = _HIST_SCALE * -30
_HIST_MAX_IDX = _HIST_SCALE * 19


def _hist_index(dt: float) -> int:
    if dt <= 0:
        return _HIST_MIN_IDX
    i = math.floor(_HIST_SCALE * math.log2(dt))
    return max(_HIST_MIN_IDX, min(_HIST_MAX_IDX, i))


def _hist_value(idx: int) -> float:
    return 2.0 ** ((idx + 0.5) / _HIST_SCALE)


def _hist_quantile(hist: dict, count: int, q: float) -> float:
    """Value at quantile ``q`` (the bucket's geometric midpoint)."""
    rank = max(1, math.ceil(q * count))
    seen = 0
    for idx in sorted(hist):
        seen += hist[idx]
        if seen >= rank:
            return _hist_value(idx)
    return 0.0


def quantiles_ms(hist: dict, count: int) -> dict:
    """p50/p95/p99 in milliseconds from one span's bucket table."""
    if not count:
        return {}
    return {
        f"p{int(q * 100)}_ms": round(_hist_quantile(hist, count, q) * 1e3, 4)
        for q in (0.50, 0.95, 0.99)
    }


# ------------------------------------------------------------------- spans
@contextmanager
def span(name: str, meta=None):
    """Time a phase.  Re-entrant: every exit accumulates (count, seconds,
    max, histogram) under ``name``.  ``meta`` (e.g. a chunk index) is
    recorded only in the event log, never in the aggregate."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _record_span(name, t0, time.perf_counter(), meta)


def _record_span(name: str, t0: float, t1: float, meta=None) -> None:
    dt = t1 - t0
    with _lock:
        slot = _spans.setdefault(name, [0, 0.0, 0.0, {}])
        slot[0] += 1
        slot[1] += dt
        if dt > slot[2]:
            slot[2] = dt
        idx = _hist_index(dt)
        slot[3][idx] = slot[3].get(idx, 0) + 1
        if _events_enabled:
            if len(_events) == _events.maxlen:
                _counters["events_dropped"] = (
                    _counters.get("events_dropped", 0) + 1)
            t = threading.current_thread()
            _events.append({"name": name, "t0": t0, "t1": t1,
                            "meta": meta, "thread": t.name})
    logger.debug("span %s: %.6fs", name, dt)


def observe(name: str, seconds: float, meta=None) -> None:
    """Record one occurrence of ``seconds`` under span ``name`` without a
    context manager: a duration measured elsewhere (a tenant's
    end-to-end latency in a service cycle)."""
    t1 = time.perf_counter()
    _record_span(name, t1 - seconds, t1, meta)


# ---------------------------------------------------------------- counters
# Context-local counter taps: every add() also lands in each tap visible
# from the caller's context.  asyncio tasks and to_thread hops copy the
# context at creation, so a tap covers the whole task tree under its
# ``with`` and nothing outside it.
_taps: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "crdt_torch_trace_counter_taps", default=()
)


@contextmanager
def counter_tap():
    """Yield a dict accumulating every counter increment made from this
    context (and the tasks and threads spawned within it) until exit.
    Taps nest; the global registry is untouched."""
    local: dict[str, int] = {}
    token = _taps.set(_taps.get() + (local,))
    try:
        yield local
    finally:
        _taps.reset(token)


def add(name: str, n: int = 1) -> None:
    """Bump a counter (e.g. bytes uploaded host to device)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        for tap in _taps.get():
            tap[name] = tap.get(name, 0) + n


def gauge(name: str, value: float) -> None:
    """Set a gauge to its latest value (e.g. a pool's width)."""
    with _lock:
        _gauges[name] = value


# ------------------------------------------------------------ event buffer
def enable_events(on: bool = True) -> None:
    """Turn the per-occurrence span log on or off."""
    global _events_enabled
    with _lock:
        _events_enabled = on


def events_enabled() -> bool:
    return _events_enabled


def events() -> list[dict]:
    """A copy of the recorded span occurrences, in completion order:
    name, t0, t1 (``time.perf_counter`` seconds, comparable across
    threads), meta and the recording thread's name."""
    with _lock:
        return [dict(e) for e in _events]


def drain_events() -> list[dict]:
    """Like :func:`events`, but consumes the log, so successive drains
    never hand out the same occurrence twice (the metrics sink drains)."""
    with _lock:
        out = [dict(e) for e in _events]
        _events.clear()
        return out


# ---------------------------------------------------------------- registry
def snapshot() -> dict:
    """A consistent copy: {"spans": {name: {"count", "seconds", "max_ms",
    "p50_ms", "p95_ms", "p99_ms"}}, "counters": {...}, "gauges": {...}}."""
    with _lock:
        return {
            "spans": {
                k: {"count": c, "seconds": s, "max_ms": mx * 1e3,
                    **quantiles_ms(h, c)}
                for k, (c, s, mx, h) in _spans.items()
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


def format_snapshot(snap: dict) -> str:
    """Human-readable phase table for one snapshot dict, longest total
    first, with quantiles, then the counters and gauges."""
    lines = []
    spans = sorted(snap.get("spans", {}).items(),
                   key=lambda kv: kv[1]["seconds"], reverse=True)
    if spans:
        w = max(len(k) for k, _ in spans)
        for k, v in spans:
            q = ""
            if "p50_ms" in v:
                q = (
                    f"  p50 {v['p50_ms']:>9.3f}ms  p95 {v['p95_ms']:>9.3f}ms"
                    f"  p99 {v['p99_ms']:>9.3f}ms  max {v['max_ms']:>9.3f}ms"
                )
            lines.append(f"{k:<{w}}  {v['seconds']:>9.4f}s  x{v['count']}{q}")
    for k in sorted(snap.get("counters", ())):
        lines.append(f"{k} = {snap['counters'][k]}")
    for k in sorted(snap.get("gauges", ())):
        lines.append(f"{k} = {snap['gauges'][k]} (gauge)")
    return "\n".join(lines) if lines else "(no spans recorded)"
