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

The event log (off by default) records one entry per span exit —
``{"name", "kind": "span", "t0", "t1", "meta", "tid", "thread", "id",
"parent", "root"}`` with ``time.perf_counter`` seconds comparable across
threads — and, while it is on, one per counter or gauge update (``kind``
``"counter"`` or ``"gauge"``, the post-update ``value`` at ``t0 ==
t1``, and the ``parent`` and ``root`` of the span it was made in).  The
JAX package's keys are all there, so ``obs.timeline`` (either package's)
builds one lane per recording thread and a counter track per counter
from a record the port wrote.  It is a ring buffer of
``DEFAULT_EVENT_CAPACITY`` entries (:func:`set_events_capacity`);
overflow, or a shrink, bumps the ``events_dropped`` counter.
:func:`reset` restores the defaults (off, default capacity).

The span tree: while the log is on, every span gets ``id``, a
process-wide sequence number; ``parent``, the id of the innermost span
open in the caller's context (None for an outermost span); and ``root``,
the id of the outermost span of that chain (its own id for an outermost
span, such as ``core.open``, ``core.compact``, ``serve.cycle`` or
``daemon.cycle``).  They travel in a context variable, so they follow
``asyncio`` tasks and ``asyncio.to_thread`` hops as the counter taps do;
a span in a worker thread started without a copy of the caller's context
is a root of its own.  A span entered while the log was off carries
None for all three.  With the log off, ``span()`` reads no context
variable.
"""

from __future__ import annotations

import contextvars
import itertools
import math
import threading
import time
from collections import deque
from contextlib import contextmanager

DEFAULT_EVENT_CAPACITY = 65536

_lock = threading.Lock()
# name -> [count, total_seconds, max_seconds, {bucket_index: count}]
_spans: dict[str, list] = {}
_counters: dict[str, int] = {}
_gauges: dict[str, float] = {}
_events_enabled = False
_events_capacity = DEFAULT_EVENT_CAPACITY
_events: deque = deque(maxlen=DEFAULT_EVENT_CAPACITY)

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
# The span tree, while the event log is on: (id, root) of the innermost
# span open in this context.  Tasks and to_thread hops copy the context at
# creation, so a child task's spans name the span that spawned it.
_open_span: contextvars.ContextVar[tuple | None] = contextvars.ContextVar(
    "crdt_torch_trace_open_span", default=None
)
_span_ids = itertools.count(1)  # next() is atomic under the GIL


def _tree_node() -> tuple:
    """(id, parent, root) for a new span in this context."""
    outer = _open_span.get()
    sid = next(_span_ids)
    return (sid, None, sid) if outer is None else (sid, outer[0], outer[1])


@contextmanager
def span(name: str, meta=None):
    """Time a phase.  Re-entrant: every exit accumulates (count, seconds,
    max, histogram) under ``name``.  ``meta`` (e.g. a chunk index) is
    recorded only in the event log, never in the aggregate."""
    if not _events_enabled:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _record_span(name, t0, time.perf_counter(), meta)
        return
    tree = _tree_node()
    token = _open_span.set((tree[0], tree[2]))
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        try:
            _open_span.reset(token)
        except ValueError:  # left in another context than it was entered
            pass
        _record_span(name, t0, t1, meta, tree)


def _record_span(name: str, t0: float, t1: float, meta=None,
                 tree: tuple = (None, None, None)) -> None:
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
            e = _event_base(name, "span")
            e["t0"], e["t1"], e["meta"] = t0, t1, meta
            e["id"], e["parent"], e["root"] = tree
            _append_event_locked(e)


def observe(name: str, seconds: float, meta=None) -> None:
    """Record one occurrence of ``seconds`` under span ``name`` without a
    context manager: a duration measured elsewhere (a tenant's
    end-to-end latency in a service cycle)."""
    t1 = time.perf_counter()
    tree = _tree_node() if _events_enabled else (None, None, None)
    _record_span(name, t1 - seconds, t1, meta, tree)


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
        value = _counters.get(name, 0) + n
        _counters[name] = value
        for tap in _taps.get():
            tap[name] = tap.get(name, 0) + n
        if _events_enabled:
            _append_value_event_locked(name, "counter", value)


def gauge(name: str, value: float) -> None:
    """Set a gauge to its latest value (e.g. a pool's width)."""
    with _lock:
        _gauges[name] = value
        if _events_enabled:
            _append_value_event_locked(name, "gauge", value)


# ------------------------------------------------------------ event buffer
def _event_base(name: str, kind: str) -> dict:
    t = threading.current_thread()
    return {"name": name, "kind": kind, "tid": t.ident, "thread": t.name}


def _append_event_locked(entry: dict) -> None:
    if len(_events) == _events.maxlen:
        _counters["events_dropped"] = _counters.get("events_dropped", 0) + 1
    _events.append(entry)


def _append_value_event_locked(name: str, kind: str, value) -> None:
    e = _event_base(name, kind)
    e["t0"] = e["t1"] = time.perf_counter()
    e["meta"], e["value"] = None, value
    outer = _open_span.get()
    e["parent"], e["root"] = (None, None) if outer is None else outer
    _append_event_locked(e)


def enable_events(on: bool = True) -> None:
    """Turn the per-occurrence event log on or off."""
    global _events_enabled
    with _lock:
        _events_enabled = on


def set_events_capacity(capacity: int) -> None:
    """Resize the event ring buffer, keeping the newest events; the ones a
    shrink discards count into ``events_dropped`` like ring overflow."""
    if capacity < 1:
        raise ValueError(f"event capacity must be >= 1, got {capacity}")
    global _events, _events_capacity
    with _lock:
        overflow = len(_events) - capacity
        if overflow > 0:
            _counters["events_dropped"] = (
                _counters.get("events_dropped", 0) + overflow)
        _events_capacity = capacity
        _events = deque(_events, maxlen=capacity)


def events_capacity() -> int:
    return _events_capacity


def events_enabled() -> bool:
    return _events_enabled


def events() -> list[dict]:
    """A copy of the recorded occurrences, in completion order.  Span
    entries: name, kind ``"span"``, t0, t1 (``time.perf_counter``
    seconds, comparable across threads), meta, tid and thread (the
    recording thread), id, parent and root (the span tree).  Counter and
    gauge entries carry kind ``"counter"``/``"gauge"``, the post-update
    ``value`` at t0, and the parent and root of the span they were made
    in."""
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
                k: {"count": c, "seconds": s, "max_ms": round(mx * 1e3, 4),
                    **quantiles_ms(h, c)}
                for k, (c, s, mx, h) in _spans.items()
            },
            "counters": dict(_counters),
            "gauges": dict(_gauges),
        }


def reset() -> None:
    """Clear every span, counter, gauge and event, and restore the event
    log's defaults: off, default capacity."""
    global _events_enabled, _events_capacity, _events
    with _lock:
        _spans.clear()
        _counters.clear()
        _gauges.clear()
        _events_enabled = False
        _events_capacity = DEFAULT_EVENT_CAPACITY
        _events = deque(maxlen=DEFAULT_EVENT_CAPACITY)


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


def report() -> str:
    """The registry's phase table as :func:`format_snapshot` renders it."""
    return format_snapshot(snapshot())


def throughput(span_name: str, counter_name: str) -> float | None:
    """counter / span seconds, or None if either is missing or zero."""
    snap = snapshot()
    s = snap["spans"].get(span_name)
    c = snap["counters"].get(counter_name)
    if not s or not c or s["seconds"] <= 0:
        return None
    return c / s["seconds"]
