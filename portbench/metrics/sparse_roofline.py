"""`sparse_roofline.serve` / `sparse_roofline.train`: the sum of the
least times of the sparse ops the traced requests or steps called, over
the device time of every device operation launched inside those ops'
ranges, forward and backward, in %.

A call's least time is the larger of its FLOPs over the card's
fp32-accurate peak and its compulsory bytes over the memory bandwidth
(`peaks.json`), from `work/<op>.py` on the call's shapes; its backward's
counts only where its backward range ran. Nothing when the trace shows
no such call or no device time in them, or when a device operation of
the window could not be traced to its launch (its op unknown)."""


def read(ctx):
    tr = ctx.trace
    flops_peak = ctx.peaks.get("fp32_flops")
    bytes_peak = ctx.peaks.get("hbm_bytes_per_s")
    device_s = sum(tr["op_device_s"].values())
    if not (flops_peak and bytes_peak and tr["calls"] and device_s > 0) \
            or tr["unmatched"]:
        return None
    least = 0.0
    for op, shapes, backward_ran in tr["calls"]:
        work = ctx.works[op]
        parts = [work.forward(**shapes)]
        if backward_ran:
            parts.append(work.backward(**shapes))
        least += sum(max(f / flops_peak, b / bytes_peak) for f, b in parts)
    return 100.0 * least / device_s
