"""`decode.ops_ms`: opening and decoding op files and snapshots
(`ops.chunk_decrypt` + `ops.chunk_unwrap` + `states.decrypt_decode`), in
ms per compaction, from the port's span registry over the window."""

SPANS = ("ops.chunk_decrypt", "ops.chunk_unwrap", "states.decrypt_decode")


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
