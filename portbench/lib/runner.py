"""One run of one cell: set-up, the measured window, the traced window
(with `--trace 1`), the comparison that decides `correct`, and the result.

`run_cell` runs on any device, so tests drive it on the CPU at a small
size; `main`, the command's, runs only on a card.
"""

import json
import sys
import time
import types
from pathlib import Path
from typing import Dict, Optional

from portbench.lib import env, spec

GIB = 2.0 ** 30
# a traced window holds this many seconds of requests or steps, at least
# MIN_TRACED and at most MAX_TRACED of them
TRACED_SECONDS, MIN_TRACED, MAX_TRACED = 0.5, 10, 400


def end_to_end(loop, window: dict, setup_s: float, peak: int) -> dict:
    """Every end-to-end quantity of the run, by metric name: set-up and
    the peak, and the loop's own."""
    return {"setup_s": setup_s, "peak_mem_gib": peak / GIB,
            **loop.end_to_end(window)}


def prepare(root: Path, cell_name: str, seed: int, device,
            config_override: Optional[dict] = None):
    """Everything a run sets up for a cell and seed, up to the window:
    a namespace with the configuration, mix, limits, reference, inputs,
    the loop holding the program's model, and the storage's build time."""
    import torch

    from portbench.lib import inputs as inputs_mod
    from portbench.lib import loop as loop_mod

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(bench, root, cell["config"])
    cfg.update(config_override or {})
    mix = spec.traffic(root, cell["traffic"])
    loop_cls = loop_mod.load(root, mix)
    reference = spec.named(root, "reference", cfg["model"])
    adapter = spec.named(root, "models", cfg["model"])
    generator = spec.named(root, "graphs", cfg["graph"]["generator"])

    # TF32 as the configuration states it
    tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    stamps = [time.perf_counter()]
    inp = inputs_mod.make(cfg, generator, reference, seed, device)
    loop_mod.sync(device)
    stamps.append(time.perf_counter())
    adj = adapter.adjacency(cfg, inp.graph, device)
    loop_mod.sync(device)
    stamps.append(time.perf_counter())
    storage_build_s = stamps[-1] - stamps[-2]
    model = adapter.build(cfg, inp.weights, device)
    loop = loop_cls(mix, model, adj, inp, device, seed, adapter, cfg)
    stamps.append(time.perf_counter())
    loop.setup()
    stamps.append(time.perf_counter())
    print("set-up phases (s): inputs {:.3f}, adjacency {:.3f}, model {:.3f}, "
          "warm-up or first steps {:.3f}".format(
              *(b - a for a, b in zip(stamps, stamps[1:]))), file=sys.stderr)
    return types.SimpleNamespace(
        bench=bench, cell=cell, cfg=cfg, mix=mix, reference=reference,
        inputs=inp, loop=loop, nnz=adapter.nnz(adj),
        num_nodes=inp.graph["num_nodes"], storage_build_s=storage_build_s,
        limits=spec.limits(root, cell_name))


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t0: float,
             config_override: Optional[dict] = None) -> dict:
    """The result of one run (the dict printed as the last line), with
    the numbers compared under "checks". `config_override` replaces keys
    of the configuration (tests shrink the graph with it)."""
    import torch

    cuda = device.type == "cuda"
    if cuda:
        # the allocator exists once something is allocated
        torch.empty(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    run = prepare(root, cell_name, seed, device, config_override)
    bench, cfg, loop, limits = run.bench, run.cfg, run.loop, run.limits
    setup_s = time.perf_counter() - t0

    window = loop.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    e2e = end_to_end(loop, window, setup_s, peak)
    result = {"correct": False, "attempted": window["count"], "failed": 0}

    if trace:
        from portbench.lib import trace as trace_mod

        per_s = window["seconds"] / window["count"]
        n = min(max(int(TRACED_SECONDS / per_s), MIN_TRACED), MAX_TRACED)
        works = {m.__name__.split(".")[-1]: m
                 for m in spec.all_named(root, "work")}
        tr = trace_mod.profile(loop.iterate, n, device, works)
        trace_mod.require_ops(tr, cfg["sparse_ops"], loop.trains)
        ctx = types.SimpleNamespace(
            cfg=cfg, cell=run.cell, train=loop.trains,
            num_nodes=run.num_nodes,
            nnz=run.nnz, seconds_per_iter=per_s,
            storage_build_s=run.storage_build_s, trace=tr, works=works,
            reference=run.reference, peaks=peaks(root, device))
        metrics = {}
        for m in spec.metrics_for(bench, "per_layer", cell_name):
            value = spec.reader(root, m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        print(f"traced window: {n} iterations, {tr['window_s']:.6f} s "
              f"({tr['window_s'] / n * 1e3:.4f} ms each against "
              f"{per_s * 1e3:.4f} untraced), {tr['device_events']} device "
              f"operations, {tr['unmatched']} without a launch, "
              f"op device s {tr['op_device_s']}", file=sys.stderr)
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_for(bench, "end_to_end", cell_name)}

    loop.release()
    if cuda:
        torch.cuda.empty_cache()
    checks = loop.compare(run.reference, cfg, run.inputs)
    result["correct"] = all(checks[k] <= limits[k] for k in limits)
    result["metrics"] = metrics
    result["device"] = {"peak": peak}
    if trace:
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in
                                              tr["device_ops"]],
                               "idle_gaps": [[k[:120], v] for k, v in
                                             tr["idle_gaps"]]}
        result["device"].update(busy_s=tr["busy_s"],
                                window_s=tr["window_s"])
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    result["readings"] = checks
    return result


def peaks(root: Path, device) -> Dict[str, float]:
    """The card's peaks from `peaks.json`, by its name; none elsewhere."""
    if device.type != "cuda":
        return {}
    import torch

    table = spec.read_json(Path(root) / spec.PKG / "peaks.json")
    return table.get(torch.cuda.get_device_name(device), {})


def finish(result: dict, dev: dict) -> str:
    """The result's last line: `device` with the card's description and
    the peak, and the compared numbers last."""
    extra = dict(result["device"])
    peak = extra.pop("peak")
    out = {k: result[k] for k in ("correct", "attempted", "failed",
                                  "metrics")}
    out["device"] = {**dev, "memory_peak_bytes": peak, **extra}
    if "breakdown" in result:
        out["breakdown"] = result["breakdown"]
    out["checks"] = result["checks"]
    return json.dumps(out)


def main(args, root: Path, t0: float) -> int:
    env.prepare(root)
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    t = time.perf_counter()
    env.import_program(root)
    print(f"imports (s): torch and CUDA check {t - t0:.3f}, the program "
          f"{time.perf_counter() - t:.3f}", file=sys.stderr)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), device, t0)
    found = env.forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 4
    for k, v in result.pop("readings").items():
        print(f"reading {k} {v!r}", file=sys.stderr)
    line = finish(result, env.card(torch, cell["chips"]))
    for k, v in json.loads(line)["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(line, flush=True)
    return 0
