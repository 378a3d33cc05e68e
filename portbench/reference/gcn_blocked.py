"""Plain reference of the GCN of `reference/gcn.py` for a graph whose
per-edge messages do not fit on the card at once: the same maths,
parameter names, draws (`param_specs`) and FLOPs (`model_flops`), with
each aggregation run over blocks of edges. At Reddit's size one [E, F]
message tensor is 29 GB at F = 64, twice over under autograd.

An aggregation out[r] = sum over edges (r, c) of vals[e] * h[c] takes
`BLOCK_EDGES` edges at a time: it gathers their source rows, scales them
by their values and adds them into their destination rows. Its gradient
is written out (`_Aggregate`): the same loop over the edges reversed,
d_h[c] += vals[e] * g[r]. Operands are rounded to the precision `prec`
names as `common.aggregate` rounds them, h (and so its gradient) by
`common.to_prec` and the values once. Imports torch and the benchmark's
own helpers only.
"""

from pathlib import Path

import torch

from portbench.lib import spec

_ROOT = Path(__file__).resolve().parents[2]
common = spec.named(_ROOT, "reference", "common")
gcn = spec.named(_ROOT, "reference", "gcn")

# 8,388,608 edges a block: 2 GiB of messages at F = 64
BLOCK_EDGES = 1 << 23

widths, param_specs, model_flops = (gcn.widths, gcn.param_specs,
                                    gcn.model_flops)


def prepare(cfg: dict, graph: dict, device) -> dict:
    ctx = gcn.prepare(cfg, graph, device)
    ctx["block"] = BLOCK_EDGES
    return ctx


def _sum_blocks(dst: torch.Tensor, src: torch.Tensor, vals: torch.Tensor,
                h: torch.Tensor, rows: int, block: int) -> torch.Tensor:
    """out[dst[e]] += vals[e] * h[src[e]] over every edge, `block` edges at
    a time, into a fresh [rows, F]."""
    out = h.new_zeros((rows, h.shape[1]))
    for s in range(0, dst.shape[0], block):
        msg = h.index_select(0, src[s:s + block])
        msg *= vals[s:s + block].unsqueeze(1)
        out.index_add_(0, dst[s:s + block], msg)
    return out


class _Aggregate(torch.autograd.Function):
    """A_hat h over edge blocks, and its gradient A_hatᵀ g alike."""

    @staticmethod
    def forward(ctx, h, edge_index, vals, n, block):
        ctx.save_for_backward(edge_index, vals)
        ctx.rows, ctx.block = h.shape[0], block
        return _sum_blocks(edge_index[0], edge_index[1], vals, h, n, block)

    @staticmethod
    def backward(ctx, g):
        edge_index, vals = ctx.saved_tensors
        d_h = _sum_blocks(edge_index[1], edge_index[0], vals, g, ctx.rows,
                          ctx.block)
        return d_h, None, None, None, None


def aggregate(ctx: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    return _Aggregate.apply(common.to_prec(h, prec), ctx["edge_index"],
                            common.to_prec(ctx["vals"], prec), ctx["n"],
                            ctx["block"])


def forward(cfg: dict, ctx: dict, x, params: dict, prec: str):
    h = x
    for i in range(cfg["num_layers"]):
        if i:
            h = torch.relu(h)
        h = common.mm(h, params[f"w{i + 1}"], prec) + params[f"b{i + 1}"]
        h = aggregate(ctx, h, prec)
    return h
