"""`device_idle.serve` / `device_idle.train`: 1 - (the union of the
device operations' intervals / the traced window), in %. The profiler's
own host cost widens the window; PERF.md states it."""


def read(ctx):
    tr = ctx.trace
    if tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
