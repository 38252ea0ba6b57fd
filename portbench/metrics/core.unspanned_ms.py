"""`core.unspanned_ms`: the time inside the port's root spans `core.open`
and `core.compact` in which no leaf span of the root's tree is open on
any thread, in ms per compaction.  From the port's event log, which the
traced window leaves in the registry: a span's `root` names its tree, a
leaf is a span no other span names as its `parent`, so a wrapper's own
gaps (between and around its children) count as unspanned.  None
without tracing, or where the log carries no span tree."""

ROOTS = ("core.open", "core.compact")


def uncovered(events) -> dict:
    """{root id: (name, t0, t1, uncovered seconds)} for every outermost
    `core.open` and `core.compact` span in ``events``."""
    spans = [e for e in events
             if e.get("kind", "span") == "span" and e.get("id") is not None]
    parents = {e["parent"] for e in spans}
    leaves: dict = {}
    for e in spans:
        if e["parent"] is not None and e["id"] not in parents:
            leaves.setdefault(e["root"], []).append((e["t0"], e["t1"]))
    out = {}
    for e in spans:
        if e["name"] not in ROOTS or e["parent"] is not None:
            continue
        a, b = e["t0"], e["t1"]
        covered, edge = 0.0, a
        for s0, s1 in sorted(leaves.get(e["id"], ())):
            s0, s1 = max(s0, edge), min(s1, b)
            if s1 > s0:
                covered += s1 - s0
                edge = s1
        out[e["id"]] = (e["name"], a, b, (b - a) - covered)
    return out


def read(run):
    trace, units = run["trace"], run["units"]
    if trace is None or not trace.on or not units:
        return None
    from crdt_enc_tpu_torch.utils import trace as record

    roots = uncovered(record.events())
    if not roots:
        return None
    return 1e3 * sum(r[3] for r in roots.values()) / units
