"""Mode "train": full-graph training steps back to back through
`entry.train_step`, with no synchronize until the window closes.

Keys of the mix:
- "first_steps": steps run before the window on the object the window
  then continues (set-up); their losses, the first gradient and the
  parameters' change are what `correct` compares.

End-to-end metric: `step_ms` (the window over all its steps).
"""

import time
from pathlib import Path
from typing import Dict

import torch

from portbench.lib import check, spec
from portbench.lib.loop import sync


def reference_train(reference, cfg, inputs, prec: str, loss_rows=None,
                    steps: int = 3) -> dict:
    common = spec.named(Path(__file__).resolve().parents[2], "reference",
                        "common")
    return common.train(reference, cfg, inputs.graph, inputs.x, inputs.y,
                        inputs.weights, steps, prec, loss_rows)


def readings(ref: dict, weights: dict) -> dict:
    """A reference run's first steps in the form the program's take."""
    return {"losses": ref["losses"], "grad_norms": check.norms(ref["grads"]),
            "update_norms": check.norms({k: ref["params"][k] - weights[k]
                                         for k in weights})}


class Loop:
    """Full-graph training steps through `entry.train_step`."""

    trains = True

    def __init__(self, mix: dict, model, adj, inputs, device, seed: int,
                 adapter, cfg: dict):
        from dgsparse_tpu_torch import entry

        self.mix, self.model, self.adj = mix, model, adj
        self.x, self.y, self.device = inputs.x, inputs.y, device
        opt = cfg["optimizer"]
        if opt["name"] != "adam" or \
                tuple(opt["betas"]) != tuple(entry.ADAM["betas"]) or \
                opt["eps"] != entry.ADAM["eps"]:
            raise ValueError("the configuration's Adam is not the port's")
        self.opt = entry.build_optimizer(model, opt["lr"])
        self.params = adapter.param_map(model)

    def step(self) -> torch.Tensor:
        from dgsparse_tpu_torch import entry

        return entry.train_step(self.model, self.opt, self.x, self.adj,
                                self.y)

    def setup(self) -> None:
        """The first steps, with what `correct` compares: each step's loss,
        the first gradient as Adam holds it after step 1, and the
        parameters' change over the steps."""
        start = {k: p.detach().clone() for k, (p, _) in self.params.items()}
        losses, grads = [], None
        for i in range(int(self.mix.get("first_steps", 3))):
            losses.append(self.step())
            if i == 0:
                # a parameter the step did not reach has no state: Adam
                # holds no gradient for it
                beta1 = self.opt.param_groups[0]["betas"][0]
                grads = check.norms({
                    k: self.opt.state[p].get("exp_avg", torch.zeros(1)) /
                    (1 - beta1) for k, (p, _) in self.params.items()})
        update = check.norms({k: p.detach() - start[k]
                              for k, (p, _) in self.params.items()})
        sync(self.device)
        self.first = {"losses": [float(v) for v in losses],
                      "grad_norms": grads, "update_norms": update}

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self.step()
            n += 1
        sync(self.device)
        return {"count": n, "seconds": time.perf_counter() - t0}

    def end_to_end(self, window: dict) -> Dict[str, float]:
        return {"step_ms": window["seconds"] / window["count"] * 1e3}

    def iterate(self, n: int) -> None:
        for _ in range(n):
            self.step()
        sync(self.device)

    def release(self) -> None:
        del self.model, self.adj, self.opt, self.params, self.x, self.y

    def compare(self, reference, cfg, inputs) -> Dict[str, float]:
        """The training gaps of the first steps against the reference's."""
        ref = reference_train(reference, cfg, inputs, "fp32",
                              steps=len(self.first["losses"]))
        return check.train_gaps(self.first, ref, inputs.weights)

    def controls(self, reference, cfg, inputs) -> list:
        """The control (the reference with TF32 operands); a step that
        leaves its state unchanged (the first loss and gradient at every
        step, no change: 1 by `update_gap`); and the loss taken over half
        of the nodes (half the batch left out, the mean over the rest)."""
        steps = len(self.first["losses"])
        w = inputs.weights
        exact = reference_train(reference, cfg, inputs, "fp32", steps=steps)
        tf32 = reference_train(reference, cfg, inputs, "tf32", steps=steps)
        frozen = {"losses": [exact["losses"][0]] * steps,
                  "grads": exact["grads"], "params": w}
        half = torch.arange(0, inputs.graph["num_nodes"], 2,
                            device=inputs.x.device)
        halved = reference_train(reference, cfg, inputs, "fp32", half, steps)
        return [(side, check.train_gaps(readings(r, w), exact, w))
                for side, r in (("control", tf32),
                                ("fault_state_unchanged", frozen),
                                ("fault_half_batch", halved))]
