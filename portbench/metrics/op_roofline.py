"""`op_roofline.serve` / `op_roofline.train`: `sparse_roofline`'s formula
on the program's own op spans (`lib/spans.py`): the sum of the least
times of the outermost `dgsparse.op.*` spans of the traced window, forward
and backward, over the device time launched inside them, in %.

A span's least time is the larger of its FLOPs over the card's
fp32-accurate peak and its compulsory bytes over the memory bandwidth
(`peaks.json`), from the work count that prices its op (`WORK`) on the
span's tags: `forward` for a `.fwd` span, `backward` for a `.bwd` one.
Nothing when an outermost op span has no work count, when a device
operation of the window could not be traced to its launch, or without
the program's spans in the trace."""

# the program's (op, reduction) -> the work count (`work/<name>.py`)
WORK = {("spmm", "sum"): "spmm_sum", ("spmm_multihead", "sum"):
        "spmm_multihead", ("edge_softmax", None): "edge_softmax"}


def read(ctx):
    prog = ctx.trace.get("program")
    flops_peak = ctx.peaks.get("fp32_flops")
    bytes_peak = ctx.peaks.get("hbm_bytes_per_s")
    if not (prog and prog["ops"] and flops_peak and bytes_peak) \
            or prog["unmatched"]:
        return None
    least = device_s = 0.0
    for op in prog["ops"]:
        tags = op["tags"] or {}
        name = WORK.get((op["op"], tags.get("reduce")))
        if name is None or name not in ctx.works:
            return None
        work = ctx.works[name]
        f, b = (work.forward if op["phase"] == "fwd" else work.backward)(
            **tags)
        least += max(f / flops_peak, b / bytes_peak)
        device_s += op["device_s"]
    return 100.0 * least / device_s if device_s > 0 else None
