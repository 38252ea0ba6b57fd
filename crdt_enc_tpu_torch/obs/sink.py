"""Run-scoped metrics sink: JSONL records + Prometheus text exposition.

The port's copy of the write side of ``crdt_enc_tpu/obs/sink.py``.  The
sink appends ONE self-contained JSON line per labelled snapshot:

    {"schema": 2, "label": "compact", "ts": <unix seconds>,
     "spans": {...}, "counters": {...}, "gauges": {...},
     "events": [...]?, "meta": {...}?, "replication": {...}?}

``events`` is attached only when the event log is enabled and non-empty
(the log is drained per write); ``replication`` is the replication status
``Core.compact`` attaches; a fold service cycle writes a ``serve_cycle``
record whose ``meta`` is the cycle summary.  The records are the JAX
package's, so its ``obs_report`` reads a file either package wrote.

Wiring: set ``CRDT_OBS_SINK=/path/run.jsonl`` (or call :func:`configure`)
and every ``Core.compact`` and fold service cycle appends a record
(:func:`maybe_write`).  A sink made with ``max_bytes`` rotates its file
to ``<path>.1`` when an append would pass that bound.

:func:`to_prometheus` renders a snapshot in the Prometheus text format:
every counter and gauge its own family with ``# TYPE`` and ``# HELP``;
span aggregates label-keyed families (totals, counts, a quantile
summary).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path

from . import record

ENV_VAR = "CRDT_OBS_SINK"

#: sink record format version.  2 added ``schema`` itself and the
#: ``replication`` payload; unstamped records are retroactively 1.
SCHEMA_VERSION = 2

_configured: "MetricsSink | None | bool" = False  # False = not resolved yet


#: serializes the size-check → rotate → append sequence across threads
#: (a service's per-tenant seals write concurrently): without it two
#: writers could both rotate, dropping a generation, or interleave the
#: check with another's append and overshoot the bound.
_io_lock = threading.Lock()


class MetricsSink:
    """Append-only JSONL sink for labelled registry snapshots."""

    def __init__(self, path: str, max_bytes: int = 0):
        self.path = path
        # rotation bound in bytes; 0 = the file only grows
        self.max_bytes = int(max_bytes)

    def write(self, label: str, *, snapshot: dict | None = None,
              events: list | None = None, meta: dict | None = None,
              replication: dict | None = None) -> dict:
        """Append one record; returns it.  ``snapshot`` defaults to the
        live registry.  ``events`` defaults to DRAINING the live event
        log when recording is enabled, so each record carries only the
        timeline since the previous write.  Never raises on I/O failure:
        bookkeeping must not kill a good run."""
        snap = record.snapshot() if snapshot is None else snapshot
        rec = {
            "schema": SCHEMA_VERSION,
            "label": label,
            "ts": round(time.time(), 3),
            **snap,
        }
        if events is None:
            evs = record.drain_events() if record.events_enabled() else []
        else:
            evs = events
        if evs:
            rec["events"] = evs
        if meta:
            rec["meta"] = meta
        if replication:
            rec["replication"] = replication
        try:
            line = json.dumps(rec)
            with _io_lock:
                if self.max_bytes:
                    try:
                        if os.path.getsize(self.path) + len(line) + 1 \
                                > self.max_bytes:
                            os.replace(self.path, self.path + ".1")
                    except OSError:
                        pass  # no file yet — first append creates it
                with open(self.path, "a") as f:
                    f.write(line + "\n")
        except (OSError, TypeError, ValueError):
            pass
        return rec


def configure(path: str | None,
              max_bytes: int = 0) -> "MetricsSink | None":
    """Set (or with None, clear) the process-default sink, overriding the
    ``CRDT_OBS_SINK`` environment variable."""
    global _configured
    _configured = MetricsSink(path, max_bytes) if path else None
    return _configured


def default_sink() -> "MetricsSink | None":
    """The configured sink, else one from ``CRDT_OBS_SINK``, else None.
    The environment variable is re-read per call."""
    if _configured is not False:
        return _configured
    path = os.environ.get(ENV_VAR)
    return MetricsSink(path) if path else None


def maybe_write(label: str, meta: dict | None = None,
                replication: dict | None = None) -> dict | None:
    """Append a snapshot to the default sink if one is configured: the
    hook ``Core.compact`` and the fold service call, one check when no
    sink is set."""
    sink = default_sink()
    if sink is None:
        return None
    return sink.write(label, meta=meta, replication=replication)


# ----------------------------------------------------------- prometheus
_help_cache: dict[str, str] | None = None

_DOC_REL = Path("docs") / "observability.md"
_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|\s*(?:[^|]*\|)?\s*([^|]+)\|?\s*$")


def registry_help() -> dict[str, str]:
    """name → description from the ``docs/observability.md`` registry
    tables beside the package, for ``# HELP`` lines.  Empty when the
    document is not there; the exposition then uses generic help text."""
    global _help_cache
    if _help_cache is not None:
        return _help_cache
    doc = Path(__file__).resolve().parents[2] / _DOC_REL
    out: dict[str, str] = {}
    try:
        text = doc.read_text()
    except OSError:
        _help_cache = out
        return out
    for line in text.splitlines():
        m = _ROW_RE.match(line)
        if not m or m.group(1) in ("span", "name"):
            continue
        # raw text here; escaping for the exposition format happens at
        # render time (_escape_help) so it applies uniformly to registry
        # and fallback help strings alike
        desc = m.group(2).strip().replace("`", "")
        if desc:
            out.setdefault(m.group(1), desc)
    _help_cache = out
    return out


def _metric_name(prefix: str, name: str) -> str:
    return f"{prefix}_" + re.sub(r"[^a-zA-Z0-9_:]", "_", name)


# Prometheus text-format escaping (the exposition spec): label VALUES
# escape backslash, double-quote and newline; HELP text escapes
# backslash and newline.  Metric names need none (sanitized above), but
# span names ride as label values and are dotted free text.
def _escape_label(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def to_prometheus(snap: dict | None = None, prefix: str = "crdt",
                  timestamp: float | None = None) -> str:
    """Render one snapshot in the Prometheus text exposition format.

    Counters expose as ``<prefix>_<name>_total`` counter families and
    gauges as ``<prefix>_<name>`` gauge families — one family per
    registered name, each with ``# TYPE`` and a ``# HELP`` taken from
    the registry descriptions (:func:`registry_help`).  Span aggregates
    stay label-keyed (``span="..."``) because span names are dotted and
    the set is wide: totals/counts as counters, quantiles as a summary.
    ``timestamp`` (epoch seconds) stamps every sample in milliseconds.
    """
    if snap is None:
        snap = record.snapshot()
    ts = "" if timestamp is None else f" {int(timestamp * 1000)}"
    help_ = registry_help()
    lines: list[str] = []
    if snap.get("spans"):
        lines += [
            f"# HELP {prefix}_span_seconds_total total seconds per span",
            f"# TYPE {prefix}_span_seconds_total counter",
            f"# HELP {prefix}_span_count_total occurrences per span",
            f"# TYPE {prefix}_span_count_total counter",
            f"# HELP {prefix}_span_seconds span latency quantiles",
            f"# TYPE {prefix}_span_seconds summary",
        ]
    for name, v in sorted(snap.get("spans", {}).items()):
        lab = f'{{span="{_escape_label(name)}"}}'
        lines.append(
            f"{prefix}_span_seconds_total{lab} {v['seconds']:.6f}{ts}"
        )
        lines.append(f"{prefix}_span_count_total{lab} {v['count']}{ts}")
        for q in ("p50", "p95", "p99"):
            ms = v.get(f"{q}_ms")
            if ms is not None:
                lines.append(
                    f'{prefix}_span_seconds{{span="{_escape_label(name)}"'
                    f',quantile="0.{q[1:]}"}} {ms / 1e3:.6f}{ts}'
                )
    for name, v in sorted(snap.get("counters", {}).items()):
        fam = _metric_name(prefix, name)
        if not fam.endswith("_total"):
            fam += "_total"
        h = _escape_help(help_.get(name, f"counter {name}"))
        lines.append(f"# HELP {fam} {h}")
        lines.append(f"# TYPE {fam} counter")
        lines.append(f"{fam} {v}{ts}")
    for name, v in sorted(snap.get("gauges", {}).items()):
        fam = _metric_name(prefix, name)
        h = _escape_help(help_.get(name, f"gauge {name}"))
        lines.append(f"# HELP {fam} {h}")
        lines.append(f"# TYPE {fam} gauge")
        lines.append(f"{fam} {v}{ts}")
    return "\n".join(lines) + "\n"
