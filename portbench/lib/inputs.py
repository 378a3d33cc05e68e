"""Inputs from `--seed`: the same seed gives the same graph, features,
labels and weights.

The graph comes from a host generator (`graphs/<generator>.py`, numpy);
features, labels and weights are drawn on the run's device by one
`torch.Generator` in a few large calls: the weights as one flat draw cut
into the reference's parameters (`reference/<model>.py::param_specs`),
each scaled by its standard deviation, all in the configuration's
`dtype`. Both sides get these same tensors:
the reference under its own names, the program through
`models/<model>.py`.
"""

import dataclasses
from typing import Dict

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """An independent 63-bit seed for one use of the run's seed (any whole
    number, negative or past 32 bits)."""
    ss = np.random.SeedSequence([seed & (2**64 - 1), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Inputs:
    graph: dict                   # the generator's arrays and sizes
    x: torch.Tensor               # [num_nodes, in_features], cfg's dtype
    y: torch.Tensor               # [num_nodes] int64 class labels
    weights: Dict[str, torch.Tensor]   # the reference's names


def make(cfg: dict, generator, reference, seed: int, device) -> Inputs:
    graph = generator.make(cfg["graph"], sub_seed(seed, 1))
    n = graph["num_nodes"]
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2))
    dtype = getattr(torch, cfg["dtype"])
    x = torch.randn(n, cfg["in_features"], generator=gen, device=device,
                    dtype=dtype)
    y = torch.randint(0, cfg["num_classes"], (n,), generator=gen,
                      device=device)
    specs = reference.param_specs(cfg)
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in specs),
                       generator=gen, device=device, dtype=dtype)
    weights, at = {}, 0
    for name, shape, std in specs:
        size = int(np.prod(shape))
        weights[name] = flat[at:at + size].reshape(shape).mul(std)
        at += size
    return Inputs(graph, x, y, weights)
