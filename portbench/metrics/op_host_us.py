"""`op_host_us.serve` / `op_host_us.train`: host microseconds a sparse-op
call takes to dispatch: the host time of the traced window's outermost
`dgsparse.op.*` spans, forward and backward, over the forward spans'
count (`lib/spans.py`). A synchronize or host copy hidden inside an op
shows here. Nothing without the program's spans in the trace."""


def read(ctx):
    prog = ctx.trace.get("program")
    calls = sum(op["phase"] == "fwd" for op in prog["ops"]) if prog else 0
    if not calls:
        return None
    return 1e6 * sum(op["host_s"] for op in prog["ops"]) / calls
