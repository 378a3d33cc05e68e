"""Readings that a cell's correctness limits are set from, all in one
process on the card: the program's numbers over many seeds (its sound
runs: the lower reading), the control's over a few (the upper), and the
faults the cell can have, planted in the reference put in the program's
place:

    python3 portbench/control.py --workload <cell> --seeds <n> \
        --control-seeds <n> [--base-seed <n>] [--seconds <s>]

The control is the plain reference computed one step below the
configuration's precision (float32 with TF32 off): every product's
operands rounded to TF32 (`reference/common.py`). The cell's loop
(`loops/<mode>.py::Loop.controls`) plants the faults its cells can have:
for a serving cell, one answer altered where it is produced; for a
training cell, a step that leaves its state unchanged and the loss taken
over half of the nodes. The benchmark's own runs never run this.
Each reading is one JSON line on standard output; the last line sums them
up: the largest of the program's readings and the smallest of each
control and fault, by number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(root: Path, cell_name: str, seed: int, seconds: float, device,
             control: bool, config_override=None):
    """[(side, {number: reading})] of one seed: the program's, after a
    window of `seconds` at the cell's own load, and, with `control`, the
    control's and the faults' that the cell's loop plants."""
    import torch

    from portbench.lib import runner

    run = runner.prepare(root, cell_name, seed, device, config_override)
    loop, cfg, ref, inp = run.loop, run.cfg, run.reference, run.inputs
    loop.window(seconds)
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = [("program", loop.compare(ref, cfg, inp))]
    if control:
        out += loop.controls(ref, cfg, inp)
    return out


def summary(rows) -> dict:
    """The largest program reading and the smallest of each other side,
    by number."""
    out = {}
    for side, nums in rows:
        pick = max if side == "program" else min
        for k, v in nums.items():
            key = f"{side}.{k}"
            out[key] = pick(out.get(key, v), v)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--base-seed", type=int, default=7_000_000_000)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
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
    rows = []
    for i in range(args.seeds):
        seed = args.base_seed + 7919 * i
        t = time.perf_counter()
        got = readings(ROOT, args.workload, seed, args.seconds, device,
                       i < args.control_seeds)
        for side, nums in got:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "side": side, **nums,
                              "s": time.perf_counter() - t}), flush=True)
        rows += got
    print(json.dumps({"workload": args.workload,
                      "summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
