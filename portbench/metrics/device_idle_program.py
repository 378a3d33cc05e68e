"""`device_idle_program.serve` / `device_idle_program.train`: the share of
the traced window, in %, in which the device is idle while a `dgsparse.`
span is open on the host at the idle gap's middle (`lib/spans.py`): idle
the program causes. `device_idle` minus this is idle caused outside the
port (the caller's loop, its synchronize, Python between requests).
Nothing without the program's spans in the trace."""


def read(ctx):
    prog = ctx.trace.get("program")
    if not prog or prog["window_s"] <= 0:
        return None
    return 100.0 * prog["idle_program_s"] / prog["window_s"]
