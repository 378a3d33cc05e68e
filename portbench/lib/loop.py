"""The one traffic generator: it reads a traffic mix
(`traffic/<name>.json`) and drives the program's entry with the loop the
mix names.

A mix's "mode" names a loop file, `portbench/loops/<mode>.py`, found by
name like every other part of the benchmark; its other keys are that
loop's parameters. A loop file defines `Loop`, built as
`Loop(mix, model, adj, inputs, device, seed, adapter, cfg)`, with:
- `trains`: whether it runs backward passes, which the model's FLOPs and
  the traced ops' backward ranges follow;
- `setup()`: what runs before the window (warm-up, or the first steps
  that `correct` compares);
- `window(seconds)`: the measured window, {"count", "seconds", ...};
- `end_to_end(window)`: the loop's own end-to-end metrics by name;
- `iterate(n)`: n requests or steps for the traced window;
- `release()`: drop the program's model and state;
- `compare(reference, cfg, inputs)`: {number: reading} against the plain
  reference, once the window has closed;
- `controls(reference, cfg, inputs)`: [(side, {number: reading})] of the
  control and the faults the loop's cells can have, for
  `portbench/control.py`.

A new loop is a new file here; a mix that reuses one is data alone.
"""

from pathlib import Path

import torch

from portbench.lib import spec


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load(root: Path, mix: dict):
    """The `Loop` class a mix's "mode" names."""
    return spec.named(root, "loops", mix["mode"]).Loop
