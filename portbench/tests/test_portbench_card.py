"""On the card (marked `gpu`; skipped without one): each cell's command
for a second, traced, with `correct` true, and at a small size the
program within the cell's limits and the control failing one, there as
on the CPU. Run with
`python -m pytest portbench/tests -m gpu` on a machine with a card."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control
from portbench.lib import spec
from portbench.tests.helpers import CELLS, ROOT, SMALL_GRAPH


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    _card()
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**32 + 9), "--seconds", "1", "--trace", "1"], cwd=ROOT,
        env=dict(os.environ), capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    """On the card as on the CPU, at the small size: the program's readings
    within each of the cell's limits, and the control and each fault
    failing one of them."""
    device = _card()
    limits = spec.limits(ROOT, cell)
    sides = dict(control.readings(ROOT, cell, 21, 0.1, device, True,
                                  SMALL_GRAPH))
    program = sides.pop("program")
    assert all(program[k] <= limits[k] for k in limits), (program, limits)
    assert sides and all(any(v[k] > limits[k] for k in limits)
                         for v in sides.values()), sides
