"""`core.seal_ms`: the snapshot's pack and seal (`compact.seal`), in ms
per compaction, from the port's span registry over the window."""

SPANS = ("compact.seal",)


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
