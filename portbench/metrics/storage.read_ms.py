"""`storage.read_ms`: reading op files and snapshots from the remote
(`ops.chunk_read` + `states.load`), in ms per compaction, from the
port's span registry over the window."""

SPANS = ("ops.chunk_read", "states.load")


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
