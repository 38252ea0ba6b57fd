"""Chrome-trace / Perfetto export of the span event log.

The port's copy of ``crdt_enc_tpu/obs/timeline.py``.  Aggregates prove a
phase was fast; only a timeline proves two phases overlapped, which is
the streaming pipeline's claim (chunk k+1's decrypt and decode riding
under chunk k's fold).  :func:`to_chrome_trace` turns ``obs.record``
events into the Chrome trace-event JSON that ``chrome://tracing`` and
Perfetto load:

* one **lane per recording thread** (``M``/``thread_name`` metadata
  events), so a producer's ``stream.ingest`` visibly overlaps the
  consumer's ``stream.reduce``;
* spans as complete (``ph: "X"``) events with the span ``meta`` (chunk
  index) in ``args``, so :func:`chunk_overlaps` can check the overlap
  from the exported JSON alone (``obs_report export-trace
  --check-overlap``);
* counter and gauge updates as counter-track (``ph: "C"``) events.

Timestamps are ``time.perf_counter`` seconds rebased to the earliest
event and scaled to the format's microseconds.
"""

from __future__ import annotations

import json

from . import record

PID = 1


def to_chrome_trace(events: list | None = None) -> dict:
    """Build the Chrome trace-event JSON object for ``events`` (default:
    the live event log).  Deterministic: events sort by start time and
    thread lanes number in order of first appearance."""
    if events is None:
        events = record.events()
    out: list[dict] = []
    if not events:
        return {"traceEvents": out, "displayTimeUnit": "ms"}
    t_base = min(e["t0"] for e in events)
    lanes: dict = {}
    for e in sorted(events, key=lambda e: (e["t0"], e["t1"])):
        ts = (e["t0"] - t_base) * 1e6
        kind = e.get("kind", "span")
        if kind in ("counter", "gauge"):
            # counter tracks are per-process graphs; no thread lane
            out.append({
                "ph": "C",
                "pid": PID,
                "tid": 0,
                "name": e["name"],
                "ts": ts,
                "args": {"value": e.get("value", 0)},
            })
            continue
        tid = e.get("tid")
        if tid not in lanes:
            lanes[tid] = len(lanes)
            out.append({
                "ph": "M",
                "pid": PID,
                "tid": lanes[tid],
                "name": "thread_name",
                "args": {"name": e.get("thread", f"thread-{tid}")},
            })
        ev = {
            "ph": "X",
            "pid": PID,
            "tid": lanes[tid],
            "name": e["name"],
            "ts": ts,
            "dur": (e["t1"] - e["t0"]) * 1e6,
            "args": {},
        }
        if e.get("meta") is not None:
            ev["args"]["chunk"] = e["meta"]
        out.append(ev)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(path: str, events: list | None = None) -> dict:
    """Write :func:`to_chrome_trace` to ``path``; returns the trace dict."""
    trace_obj = to_chrome_trace(events)
    with open(path, "w") as f:
        json.dump(trace_obj, f)
    return trace_obj


def _spans_by_chunk(trace_obj: dict, name: str) -> dict:
    """chunk index -> (ts, ts+dur) for the ``X`` events named ``name``,
    from the LAST recorded run only.  A stage's chunk indices increase
    strictly within one pipeline run, so a non-increasing index marks a
    new run — without the split, an event log spanning two runs (e.g. a
    warmup pass before the measured one) would pair chunk k of run 1
    with chunk k+1 of run 2 and "prove" an overlap that never happened."""
    runs: list[dict] = [{}]
    rows = sorted(
        (
            e for e in trace_obj.get("traceEvents", ())
            if e.get("ph") == "X" and e.get("name") == name
            and e.get("args", {}).get("chunk") is not None
        ),
        key=lambda e: e["ts"],
    )
    last_k = None
    for e in rows:
        k = e["args"]["chunk"]
        if last_k is not None and k <= last_k:
            runs.append({})
        runs[-1][k] = (e["ts"], e["ts"] + e["dur"])
        last_k = k
    return runs[-1]


def chunk_overlaps(
    trace_obj: dict,
    earlier: str = "stream.ingest",
    later: str = "stream.reduce",
) -> list[int]:
    """The chunk indices ``k`` for which chunk k+1's ``earlier`` stage
    STARTED before chunk k's ``later`` stage FINISHED — the pipeline's
    overlap proof, read from an exported Chrome trace.  Empty list =
    the recorded run was fully serialized (or stages are missing)."""
    a = _spans_by_chunk(trace_obj, earlier)
    b = _spans_by_chunk(trace_obj, later)
    return [
        k for k in sorted(b)
        if (k + 1) in a and a[k + 1][0] < b[k][1]
    ]
