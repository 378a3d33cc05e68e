"""Plain reference of a GCN (Kipf and Welling, 2017) as the port runs it:
each layer A_hat (H W + b), ReLU between layers, no dropout, with A_hat =
D^-1/2 (A + I) D^-1/2 worked out here from the raw edge list. The bias
is added before the aggregation, as in the port and the JAX package.

Parameters, under this file's names: w<i> [in, out] and b<i> [out] for
layer i = 1 .. num_layers. Imports torch and the benchmark's own helpers
only.
"""

import math
from pathlib import Path

import torch

from portbench.lib import spec

_ROOT = Path(__file__).resolve().parents[2]
common = spec.named(_ROOT, "reference", "common")
work_linear = spec.named(_ROOT, "work", "linear")
work_spmm = spec.named(_ROOT, "work", "spmm_sum")


def widths(cfg: dict):
    hidden = [cfg["hidden_features"]] * (cfg["num_layers"] - 1)
    return [cfg["in_features"]] + hidden + [cfg["num_classes"]]


def param_specs(cfg: dict):
    """(name, shape, std) in draw order: LeCun-normal weights, biases at a
    tenth."""
    w = widths(cfg)
    specs = []
    for i in range(cfg["num_layers"]):
        specs.append((f"w{i + 1}", (w[i], w[i + 1]), 1 / math.sqrt(w[i])))
        specs.append((f"b{i + 1}", (w[i + 1],), 0.1))
    return specs


def prepare(cfg: dict, graph: dict, device) -> dict:
    n = graph["num_nodes"]
    ei = common.with_self_loops(
        torch.as_tensor(graph["edge_index"], device=device), n)
    return {"n": n, "edge_index": ei, "vals": common.gcn_values(ei, n)}


def forward(cfg: dict, ctx: dict, x, params: dict, prec: str):
    h = x
    for i in range(cfg["num_layers"]):
        if i:
            h = torch.relu(h)
        h = common.mm(h, params[f"w{i + 1}"], prec) + params[f"b{i + 1}"]
        h = common.aggregate(ctx["edge_index"], ctx["vals"], h, ctx["n"],
                             prec)
    return h


def model_flops(cfg: dict, n: int, nnz: int, train: bool) -> float:
    """Model FLOPs of one full-graph forward, or of a training step: the
    dense products and one SpMM a layer; the backward adds dW for every
    layer, dH for all but the first (whose input needs no gradient), and
    the transpose SpMM of every layer."""
    w = widths(cfg)
    fwd = bwd = 0.0
    for i in range(cfg["num_layers"]):
        gemm = work_linear.flops(n, w[i], w[i + 1])
        spmm = work_spmm.forward(n, n, nnz, w[i + 1], True)[0]
        fwd += gemm + spmm
        bwd += gemm * (2 if i else 1) + spmm
    return fwd + bwd if train else fwd
