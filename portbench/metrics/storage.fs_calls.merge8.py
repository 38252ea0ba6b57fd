"""`storage.fs_calls.merge8`: the files the port's ``FsStorage`` read,
stat'd and unlinked, per compaction (`storage_files_read` +
`storage_files_statted` + `storage_files_removed` over the window): the
per-file round trips a synced folder pays."""

COUNTERS = ("storage_files_read", "storage_files_statted",
            "storage_files_removed")


def read(run):
    counters, units = run["counters"], run["units"]
    if not units or not any(c in counters for c in COUNTERS):
        return None
    return sum(counters.get(c, 0) for c in COUNTERS) / units
