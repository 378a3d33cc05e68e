"""`mfu.serve` / `mfu.train`: the model FLOPs of one request or step
(`reference/<model>.py::model_flops`, from the configuration's shapes)
over the untraced window's time per request or step times the card's
fp32-accurate peak (`peaks.json`), in %."""


def read(ctx):
    peak = ctx.peaks.get("fp32_flops")
    if not peak or not ctx.seconds_per_iter:
        return None
    flops = ctx.reference.model_flops(ctx.cfg, ctx.num_nodes, ctx.nnz,
                                      ctx.train)
    return 100.0 * flops / (ctx.seconds_per_iter * peak)
