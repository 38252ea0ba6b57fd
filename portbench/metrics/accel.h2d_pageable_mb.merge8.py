"""`accel.h2d_pageable_mb.merge8`: MB the port uploads host to device
from pageable host memory per compaction (its `h2d_pageable_bytes`
counter over the window, per compaction): the part of
`accel.h2d_mb.merge8` that no pinned buffer carries."""


def read(run):
    n = run["counters"].get("h2d_pageable_bytes")
    if not run["units"] or n is None:
        return None
    return n / run["units"] / 1e6
