"""Plain reference of a GAT (Velickovic et al. 2018, arXiv:1710.10903) as
the port runs it: a layer projects h = x W into H heads of F features,
scores each edge (r, c) as LeakyReLU(a_dst . h[r] + a_src . h[c]) per
head, takes the softmax of the scores over each row's edges, and sums
the weighted h[c] into row r; heads are concatenated. Layers: H heads x F
features, ELU, then one head onto the classes. No dropout, no bias. The
graph's self-loops are added here, as the port's adjacency has them.

Parameters, under this file's names, layer i = 1, 2: w<i> [in, H * F],
a_dst<i> and a_src<i> [H, F]. Imports torch and the benchmark's own
helpers only.
"""

import math
from pathlib import Path

import torch
from torch.nn import functional as F

from portbench.lib import spec

_ROOT = Path(__file__).resolve().parents[2]
common = spec.named(_ROOT, "reference", "common")
work_linear = spec.named(_ROOT, "work", "linear")
work_mh = spec.named(_ROOT, "work", "spmm_multihead")
work_sddmm = spec.named(_ROOT, "work", "sddmm")


def layers(cfg: dict):
    """(in, heads, features) of each layer."""
    heads, feats = cfg["num_heads"], cfg["hidden_features"]
    return [(cfg["in_features"], heads, feats),
            (heads * feats, 1, cfg["num_classes"])]


def param_specs(cfg: dict):
    """(name, shape, std) in draw order: LeCun-normal projections, Glorot-
    normal attention vectors."""
    specs = []
    for i, (fan_in, h, f) in enumerate(layers(cfg), 1):
        specs.append((f"w{i}", (fan_in, h * f), 1 / math.sqrt(fan_in)))
        for a in ("a_dst", "a_src"):
            specs.append((f"{a}{i}", (h, f), math.sqrt(2 / (h + f))))
    return specs


def prepare(cfg: dict, graph: dict, device) -> dict:
    n = graph["num_nodes"]
    ei = common.with_self_loops(
        torch.as_tensor(graph["edge_index"], device=device), n)
    return {"n": n, "edge_index": ei}


def forward(cfg: dict, ctx: dict, x, params: dict, prec: str):
    ei, n = ctx["edge_index"], ctx["n"]
    slope = cfg["negative_slope"]
    h = x
    for i, (_, heads, feats) in enumerate(layers(cfg), 1):
        if i > 1:
            h = F.elu(h)
        h = common.mm(h, params[f"w{i}"], prec).reshape(n, heads, feats)
        sd = (h * params[f"a_dst{i}"]).sum(-1)                  # [N, H]
        ss = (h * params[f"a_src{i}"]).sum(-1)
        e = F.leaky_relu(sd.index_select(0, ei[0]) + ss.index_select(0, ei[1]),
                         slope)
        alpha = common.edge_softmax(ei, e, n)                    # [E, H]
        h = common.aggregate(ei, alpha, h, n, prec).reshape(n, heads * feats)
    return h


def model_flops(cfg: dict, n: int, nnz: int, train: bool) -> float:
    """Model FLOPs of one full-graph forward, or of a training step: each
    layer's projection and its multi-head SpMM; the backward adds dW for
    both layers, dX for the second (the first's input needs no gradient),
    the transpose SpMM and the SDDMM of the attention weights' gradient."""
    fwd = bwd = 0.0
    for i, (fan_in, heads, feats) in enumerate(layers(cfg)):
        gemm = work_linear.flops(n, fan_in, heads * feats)
        spmm = work_mh.forward(n, n, nnz, heads, feats)[0]
        fwd += gemm + spmm
        bwd += gemm * (2 if i else 1) + spmm + work_sddmm.flops(
            nnz, heads * feats)
    return fwd + bwd if train else fwd
