"""`k4_roofline`: the state merge kernel (`csrc/orset_merge.cu`
`merge_kernel`) against the card's memory rate: the bytes its dense
stack needs (`peaks.merge_bytes`, each input read once, each output
written once) per launch, over the kernel's device time in the trace."""


def read(run):
    trace, shape = run["trace"], run["shapes"].get("merge")
    if trace is None or not trace.on or not shape:
        return None
    secs, launches = trace.kernel_seconds(lambda n: "merge_kernel" in n)
    if not launches:
        return None
    peaks = run["peaks"]
    return peaks.roofline_pct(
        launches * peaks.merge_bytes(shape["S"], shape["E"], shape["R"]), secs)
