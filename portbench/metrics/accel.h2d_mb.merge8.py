"""`accel.h2d_mb.merge8`: MB the port uploads host to device per
compaction (its `h2d_bytes` counter over the window, per compaction)."""


def read(run):
    n = run["counters"].get("h2d_bytes")
    if not run["units"] or not n:
        return None
    return n / run["units"] / 1e6
