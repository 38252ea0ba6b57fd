"""`ops.read_wait_ms`: the time the pipelined ingest's fold sat starved of
op chunks (`ops.chunk_wait`, around the consumer's wait on the chunk
queue), in ms per compaction: the reads' share of the compaction's
critical path, where `storage.read_ms` is their busy time."""

SPANS = ("ops.chunk_wait",)


def read(run):
    spans, units = run["spans"], run["units"]
    if not units or not any(s in spans for s in SPANS):
        return None
    return 1e3 * sum(spans[s]["seconds"] for s in SPANS if s in spans) / units
