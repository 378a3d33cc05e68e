"""What decides `correct`, at a small size on the CPU: the references
agree with the port, the control (the reference one precision step
below) and the planted faults fail a limit, and a run whose timed path is
broken underneath reports `correct` false."""

import time

import pytest
import torch
from torch.nn import functional as F

from portbench import control
from portbench.lib import runner, spec
from portbench.tests.helpers import CELLS, ROOT, SMALL_GRAPH


def _fails(nums: dict, limits: dict) -> bool:
    return any(nums[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_control_and_faults_fail(cell, cpu):
    limits = spec.limits(ROOT, cell)
    for seed in (11, 2**35 + 1):
        rows = control.readings(ROOT, cell, seed, 0.05, cpu, True,
                                SMALL_GRAPH)
        sides = dict(rows)
        assert not _fails(sides.pop("program"), limits), rows
        assert sides and all(_fails(v, limits) for v in sides.values()), rows


def test_tf32_rounding():
    common = spec.named(ROOT, "reference", "common")
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + 1.5 * ulp, one + ulp / 4,
                      -(one + 0.75 * ulp), 3.0])
    got = common.to_prec(x, "tf32")
    want = torch.tensor([one, one + 2 * ulp, one, -(one + ulp), 3.0])
    assert torch.equal(got, want)
    assert common.to_prec(x, "fp32") is x


def _run(cell, cpu):
    return runner.run_cell(ROOT, cell, 99, 0.1, False, cpu,
                           time.perf_counter(), SMALL_GRAPH)


@pytest.mark.parametrize("cell", CELLS[1:])
def test_step_that_keeps_its_state_is_not_correct(cell, cpu, monkeypatch):
    from dgsparse_tpu_torch import entry

    def frozen(model, opt, x, adj, y):
        opt.zero_grad(set_to_none=True)
        loss = F.cross_entropy(model(x, adj), y)
        loss.backward()
        return loss.detach()

    monkeypatch.setattr(entry, "train_step", frozen)
    assert _run(cell, cpu)["correct"] is False


@pytest.mark.parametrize("cell", CELLS[1:])
def test_half_the_batch_is_not_correct(cell, cpu, monkeypatch):
    from dgsparse_tpu_torch import entry

    def halved(model, opt, x, adj, y):
        opt.zero_grad(set_to_none=True)
        logits = model(x, adj)
        half = torch.arange(0, y.shape[0], 2, device=y.device)
        loss = F.cross_entropy(logits[half], y[half])
        loss.backward()
        opt.step()
        return loss.detach()

    monkeypatch.setattr(entry, "train_step", halved)
    assert _run(cell, cpu)["correct"] is False


def test_altered_answer_is_not_correct(cpu, monkeypatch):
    from dgsparse_tpu_torch.nn.gcn import GCN

    forward = GCN.forward

    def altered(self, x, adj):
        out = forward(self, x, adj).clone()
        out[3] = out[4]
        return out

    monkeypatch.setattr(GCN, "forward", altered)
    assert _run(CELLS[0], cpu)["correct"] is False
