"""Mode "forward": a closed loop of one client that sends the next request
when the last has returned.

A request is one full-graph forward, `model(x, adj)` under
`torch.inference_mode()`, ended by `torch.cuda.synchronize()`; its
latency runs from the call to the synchronize's return, read between two
CUDA events on the card (the host clock on the CPU). The window's rate is
the host clock over all of it.

Keys of the mix:
- "warmup": requests run before the window (set-up);
- "samples": requests whose logits are kept for the comparison, copied
  to the host as they return: the first and the last of the window, and
  the rest drawn from the seed among the first 64.

End-to-end metrics: `serve_ms` (the window over its requests) and
`serve_p95_ms` (the 95th percentile of their latencies).
"""

import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.lib import check
from portbench.lib.loop import sync


def p95(xs: List[float]) -> float:
    return statistics.quantiles(xs, n=100)[94] if len(xs) > 1 else xs[0]


def reference_logits(reference, cfg, inputs, prec: str) -> torch.Tensor:
    with torch.no_grad():
        ctx = reference.prepare(cfg, inputs.graph, inputs.x.device)
        return reference.forward(cfg, ctx, inputs.x, inputs.weights, prec)


class Loop:
    """Closed-loop full-graph forwards."""

    trains = False

    def __init__(self, mix: dict, model, adj, inputs, device, seed: int,
                 adapter=None, cfg=None):
        self.mix, self.model, self.adj = mix, model, adj
        self.x, self.device = inputs.x, device
        rng = np.random.default_rng(seed & (2**64 - 1))
        k = max(int(mix.get("samples", 3)) - 2, 0)
        self.keep = {0} | set(rng.choice(np.arange(1, 64), k,
                                         replace=False).tolist())
        self.samples = {}

    def request(self) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(self.x, self.adj)

    def setup(self) -> None:
        for _ in range(int(self.mix.get("warmup", 3))):
            self.request()
        sync(self.device)

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        if cuda:
            # two events, recorded again for every request and read once
            # it has synchronized
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        samples, lat = {}, []
        t0 = time.perf_counter()
        i, done = 0, False
        while not done:
            if cuda:
                start.record()
                out = self.request()
                end.record()
                torch.cuda.synchronize(self.device)
                lat.append(start.elapsed_time(end))
            else:
                s = time.perf_counter()
                out = self.request()
                lat.append((time.perf_counter() - s) * 1e3)
            done = time.perf_counter() - t0 >= seconds
            # a kept answer goes to the host, and no answer stays on the
            # card into the next request: the peak is the model's own
            if i in self.keep or done:
                samples[i] = out.cpu()
            del out
            i += 1
        wall = time.perf_counter() - t0
        self.samples = samples
        return {"count": i, "seconds": wall, "latencies_ms": lat}

    def end_to_end(self, window: dict) -> Dict[str, float]:
        return {"serve_ms": window["seconds"] / window["count"] * 1e3,
                "serve_p95_ms": p95(window["latencies_ms"])}

    def iterate(self, n: int) -> None:
        for _ in range(n):
            self.request()
            sync(self.device)

    def release(self) -> None:
        del self.model, self.adj, self.x

    def compare(self, reference, cfg, inputs) -> Dict[str, float]:
        """logits_gap of the kept requests against the reference."""
        ref = reference_logits(reference, cfg, inputs, "fp32")
        return {"logits_gap": check.logits_gap(
            list(self.samples.values()), ref)}

    def controls(self, reference, cfg, inputs) -> list:
        """The control (the reference with TF32 operands) and one answer
        altered where it is produced (one node's logits replaced by the
        next node's)."""
        exact = reference_logits(reference, cfg, inputs, "fp32")
        tf32 = reference_logits(reference, cfg, inputs, "tf32")
        altered = exact.clone()
        altered[0] = exact[1]
        return [("control", {"logits_gap": check.logits_gap([tf32], exact)}),
                ("fault_altered_answer",
                 {"logits_gap": check.logits_gap([altered], exact)})]
