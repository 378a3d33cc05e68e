"""One cell with the program's own tracing on, on the card:

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        [--seconds <s>] [--pairs <n>]

The program's spans and counters (`dgsparse_tpu_torch/utils/metrics.py`)
are on for set-up (the runner's `prepare`) and for the traced windows
only, never for the untimed window that `mfu.*` reads. The traced window
is the runner's (`lib/trace.py`: the profiler, the op ranges, the same
number of requests or steps), run `--pairs` times with the program's
tracing off and on in turn, so the cost of the spans shows as the change
in time per request or step. The last window with them on is read by
every per-layer reader of the cell and by those of the program's spans
(`op_roofline`, `op_host_us`, `device_idle_program`, `program_setup_s`),
whose shapes, device time and set-up come from the spans
(`lib/spans.py`). Standard error gets each outermost set-up span's
seconds; the last line of standard output is one JSON object. The
benchmark's own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
READERS = ("op_roofline", "op_host_us", "device_idle_program",
           "program_setup_s")


def traced_events(iterate, n: int, device, works, program: bool):
    """The Chrome events of `iterate(n)` under the runner's profiler and op
    ranges, with the program's tracing on or off, and the calls the op
    ranges saw."""
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile

    from dgsparse_tpu_torch.utils import metrics
    from portbench.lib import trace

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with trace.OpRanges(works) as ranges:
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                if program:
                    metrics.enable()
                try:
                    iterate(n)
                finally:
                    metrics.disable()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    calls = [(op, shapes, span is not None and span.ran)
             for op, shapes, span in ranges.calls]
    return events, calls


def run(cell_name: str, seed: int, seconds: float, pairs: int, device,
        config_override=None) -> dict:
    """The cell's per-layer readings with the program's spans, the time
    per request or step of each traced window off and on, and set-up."""
    from dgsparse_tpu_torch.utils import metrics
    from portbench.lib import runner, spans, spec, trace

    metrics.reset()
    metrics.enable()
    try:
        prep = runner.prepare(ROOT, cell_name, seed, device, config_override)
    finally:
        metrics.disable()
    setup_records = metrics.spans()
    setup_s = time.perf_counter() - T0
    for r in spans.setup_spans(setup_records):
        print(f"set-up span {r['name']} "
              f"{(r['end_ns'] - r['start_ns']) * 1e-9:.6f} s {r['tags']}",
              file=sys.stderr)
    print(f"cache counters {metrics.cache_counters()}", file=sys.stderr)

    loop = prep.loop
    window = loop.window(seconds)
    per_s = window["seconds"] / window["count"]
    n = min(max(int(runner.TRACED_SECONDS / per_s), runner.MIN_TRACED),
            runner.MAX_TRACED)
    works = {m.__name__.split(".")[-1]: m
             for m in spec.all_named(ROOT, "work")}
    ms = {"off": [], "on": []}
    for _ in range(pairs):
        for side in ("off", "on"):
            metrics.reset()
            events, calls = traced_events(loop.iterate, n, device, works,
                                          side == "on")
            tr = trace.parse(events)
            ms[side].append(tr["window_s"] / n * 1e3)
    tr.update(calls=calls, iterations=n,
              program=spans.parse(events, metrics.spans()))
    trace.require_ops(tr, prep.cfg["sparse_ops"], loop.trains)
    ctx = types.SimpleNamespace(
        cfg=prep.cfg, cell=prep.cell, train=loop.trains,
        num_nodes=prep.num_nodes, nnz=prep.nnz, seconds_per_iter=per_s,
        storage_build_s=prep.storage_build_s, trace=tr, works=works,
        reference=prep.reference, peaks=runner.peaks(ROOT, device),
        setup_spans=setup_records)
    names = [m["name"] for m in spec.metrics_for(prep.bench, "per_layer",
                                                 cell_name)]
    suffix = ".train" if loop.trains else ".serve"
    names += [r if r == "program_setup_s" else r + suffix for r in READERS]
    values = {name: spec.reader(ROOT, name).read(ctx) for name in names}
    prog = tr["program"]
    loop.release()
    return {"workload": cell_name, "seed": seed, "metrics": values,
            "setup_s": setup_s, "iterations": n,
            "untraced_ms": per_s * 1e3, "traced_ms": ms,
            "op_spans": len(prog["ops"]), "unmatched": prog["unmatched"],
            "idle_s": prog["idle_s"],
            "idle_program_s": prog["idle_program_s"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--pairs", type=int, default=2)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench.lib import env

    env.prepare(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    env.import_program(ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.empty(1, device=device)
    out = run(args.workload, args.seed, args.seconds, args.pairs, device)
    out["device"] = env.card(torch, 1)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
