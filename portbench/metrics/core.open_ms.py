"""`core.open_ms`: the whole of ``Core.open`` (`core.open`), in ms per
compaction, from the port's span registry over the window."""

SPANS = ("core.open",)


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
