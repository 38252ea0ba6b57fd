"""The traced window: the device's activity from ``torch.profiler``, the
host's spans from the port's event log, and their reduction.

Only CUDA activity is profiled (kernels, copies, sets), so the trace stays
small over a whole window.  Kineto stamps device events in wall-clock
nanoseconds; the port's spans are ``time.perf_counter`` seconds; the two
clocks are tied by one reading of each at the window's start.
"""

from __future__ import annotations

import time

EVENT_CAPACITY = 1 << 20


class DeviceTrace:
    """``with DeviceTrace(on):`` around the measured window.  Off, it does
    nothing and ``reduce()`` returns None."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.device_events: list = []  # (name, t0, t1) in perf_counter s
        self.host_spans: list = []  # (name, t0, t1)
        self.t0 = self.t1 = None

    def __enter__(self):
        if not self.on:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        from crdt_enc_tpu_torch.utils import trace

        trace.enable_events(True)
        trace.set_events_capacity(EVENT_CAPACITY)
        self.card = torch.cuda.is_available()
        # off the card (the CPU tests) the profiler needs some activity
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.card
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()
        if self.card:
            torch.cuda.synchronize()
        self.wall0_ns = time.time_ns()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch

        from crdt_enc_tpu_torch.utils import trace

        if self.card:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.host_spans = [(e["name"], e["t0"], e["t1"])
                           for e in trace.events() if e.get("kind") == "span"]
        self.events_dropped = trace.snapshot()["counters"].get(
            "events_dropped", 0)
        trace.enable_events(False)
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != cuda or e.duration_ns() <= 0:
                continue
            s = self.t0 + (e.start_ns() - self.wall0_ns) / 1e9
            self.device_events.append((e.name(), s, s + e.duration_ns() / 1e9))
        return False

    # ------------------------------------------------------------ reduction
    def kernel_seconds(self, match) -> tuple:
        """(summed device seconds, launches) of the events whose name
        ``match(name)`` accepts."""
        secs, n = 0.0, 0
        for name, a, b in self.device_events:
            if match(name):
                secs += b - a
                n += 1
        return secs, n

    def busy_intervals(self) -> list:
        """The union of device activity inside the window, merged."""
        iv = sorted((max(a, self.t0), min(b, self.t1))
                    for _, a, b in self.device_events)
        merged: list = []
        for a, b in iv:
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def reduce(self) -> dict | None:
        if not self.on:
            return None
        busy = self.busy_intervals()
        window = self.t1 - self.t0
        busy_s = sum(b - a for a, b in busy)
        by_op: dict = {}
        for name, a, b in self.device_events:
            key = _short(name)
            by_op[key] = by_op.get(key, 0.0) + (b - a)
        gaps, edge = [], self.t0
        for a, b in busy:
            if a > edge:
                gaps.append((edge, a))
            edge = b
        if edge < self.t1:
            gaps.append((edge, self.t1))
        return {
            "busy_s": busy_s,
            "window_s": window,
            "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
            "idle_gaps": self._gaps_by_span(gaps)[:10],
            "events_dropped": self.events_dropped,
        }

    def _gaps_by_span(self, gaps: list) -> list:
        """Idle seconds by what the host was doing: each instant of a gap
        goes to the shortest host span open at that instant (on any
        thread), else to ``outside_any_span``."""
        import heapq

        spans = sorted(self.host_spans, key=lambda s: s[1])
        out: dict = {}
        active: list = []
        i = 0
        for g0, g1 in gaps:  # in time order: a sweep over the spans
            while i < len(spans) and spans[i][1] <= g1:
                active.append(spans[i])
                i += 1
            active = [s for s in active if s[2] > g0]
            marks = []
            for k, (name, a, b) in enumerate(active):
                if b > g0 and a < g1:
                    marks.append((max(a, g0), 1, k, b - a, name))
                    marks.append((min(b, g1), 0, k, b - a, name))
            marks.sort()
            heap: list = []
            closed: set = set()
            prev = g0
            for t, opening, k, length, name in marks + [(g1, 0, -1, 0, "")]:
                while heap and heap[0][1] in closed:
                    heapq.heappop(heap)
                if t > prev:
                    owner = heap[0][2] if heap else "outside_any_span"
                    out[owner] = out.get(owner, 0.0) + (t - prev)
                    prev = t
                if k < 0:
                    break
                if opening:
                    heapq.heappush(heap, (length, k, name))
                else:
                    closed.add(k)
        return sorted(out.items(), key=lambda kv: -kv[1])


def _short(name: str) -> str:
    """A device op's name as the breakdown keeps it: 64 characters of
    letters, digits and ``_``."""
    return "".join(ch if ch.isalnum() else "_" for ch in name)[:64]
