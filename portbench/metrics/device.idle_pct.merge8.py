"""`device.idle_pct.*`: the share of the traced window in which no
kernel, copy or set ran on the card (the profiler's device activity,
merged)."""


def read(run):
    trace = run["trace"]
    if trace is None or not trace.on or not trace.device_events:
        return None
    busy = sum(b - a for a, b in trace.busy_intervals())
    window = trace.t1 - trace.t0
    return 100.0 * (1.0 - busy / window)
