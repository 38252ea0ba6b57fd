"""`storage.read_mb.merge8`: MB of op files and snapshots the port's
``FsStorage`` read per compaction (its `storage_bytes_read` counter over
the window)."""


def read(run):
    n = run["counters"].get("storage_bytes_read")
    if not run["units"] or n is None:
        return None
    return n / run["units"] / 1e6
