"""GAT layer and 2-layer model: per-edge attention scores, edge_softmax,
then the value-weighted multi-head SpMM.

Counterpart of `dgsparse_tpu/nn/gat.py`, edge-space branch only: its
slot-space `gat_attention` branch, which the JAX package runs on
hybrid-planned graphs of 2^21 or more edges, needs the slot-space
attention (`dgsparse_tpu/ops/slot.py`, `ops/attention.py`), which is not
ported. The hybrid plan itself is (`core/planner.py`, `ops/hybrid.py`:
the SUM/MEAN SpMM and `sddmm` take its tiers), but this layer runs the
edge-space branch on every graph. Layout as there: node
features [N, H, F] with heads outer (`h.reshape(N, H, F)`), attention
vectors `a_dst`/`a_src` [H, F]. The attention weights are the SpMM's edge
values, so a training step runs both gradients of the multi-head SpMM:
`d_dense` (the CSR kernel over the CSC view) and `d_values` (the SDDMM
kernel).
"""

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.core.transform import gather_rows
from dgsparse_tpu_torch.nn._flax import init_like_flax_dense
from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead
from dgsparse_tpu_torch.ops.types import Algorithm


class GATConv(nn.Module):
    """Single GAT layer with `num_heads` attention heads (concatenated)."""

    def __init__(self, in_features: int, out_features: int,
                 num_heads: int = 1, negative_slope: float = 0.2,
                 algorithm: Algorithm = Algorithm.AUTO,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_features = out_features
        self.num_heads = num_heads
        self.negative_slope = negative_slope
        self.algorithm = algorithm
        self.proj = nn.Linear(in_features, num_heads * out_features,
                              bias=False)
        self.a_dst = nn.Parameter(torch.empty(num_heads, out_features))
        self.a_src = nn.Parameter(torch.empty(num_heads, out_features))
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        """flax's defaults: the Dense kernel LeCun-normal truncated at two
        standard deviations; a_dst/a_src glorot-uniform over fan_in = H,
        fan_out = F."""
        init_like_flax_dense(self.proj, generator)
        limit = math.sqrt(6.0 / (self.num_heads + self.out_features))
        for a in (self.a_dst, self.a_src):
            a.uniform_(-limit, limit, generator=generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        n = x.shape[0]
        h = self.proj(x).reshape(n, self.num_heads, self.out_features)
        # per-node attention halves; per-edge score = dst half + src half
        sd = torch.einsum("nhf,hf->nh", h, self.a_dst)
        ss = torch.einsum("nhf,hf->nh", h, self.a_src)
        st = adj.storage
        logits = F.leaky_relu(
            gather_rows(sd, st.coo_row()) + gather_rows(ss, st.col()),
            self.negative_slope)                            # [nnz, H]
        alpha = edge_softmax(adj, logits)
        out = spmm_multihead(adj, alpha, h, "sum", self.algorithm)
        return out.reshape(n, self.num_heads * self.out_features)


class GAT(nn.Module):
    """2-layer GAT: multi-head layer -> ELU -> single-head layer."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_heads: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gat1 = GATConv(in_features, hidden_features, num_heads,
                            generator=generator)
        self.gat2 = GATConv(hidden_features * num_heads, out_features, 1,
                            generator=generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        return self.gat2(F.elu(self.gat1(x, adj)), adj)
