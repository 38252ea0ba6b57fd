"""`session.finish_ms`: the fold session's finish
(`ops.session_finish`), in ms per compaction, from the port's span
registry over the window."""

SPANS = ("ops.session_finish",)


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
