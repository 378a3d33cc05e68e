"""GAT layer and 2-layer model: per-edge attention scores, edge_softmax,
then the value-weighted multi-head SpMM.

Counterpart of `dgsparse_tpu/nn/gat.py`, with both of its branches:
- a storage with a hybrid plan (`core/planner.py::HybridPlan`) and at
  least `GAT_SLOT_MIN_NNZ` (2^21) edges runs the fused slot-space
  attention (`ops/attention.py::gat_attention`) once a head, on that
  head's contiguous [N, F] slice, and stacks the heads
  (`dgsparse_tpu/nn/gat.py:42-56`): its kernels are the hybrid tiers'
  (`spmm_dense_cells`, `spmm_bell`, `csr_spmm`, and in the backward
  `sddmm_cells` and `sddmm_csr`);
- every other storage runs the edge-space branch: the attention weights
  [nnz, H] in CSR edge order are the multi-head SpMM's edge values, so a
  training step runs both gradients of the multi-head SpMM, `d_dense`
  (the CSR kernel over the CSC view) and `d_values` (the SDDMM kernel).
Layout as there: node features [N, H, F] with heads outer
(`h.reshape(N, H, F)`), attention vectors `a_dst`/`a_src` [H, F].
"""

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.core.transform import gather_rows
from dgsparse_tpu_torch.nn._flax import init_like_flax_dense
from dgsparse_tpu_torch.ops.attention import gat_attention
from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
from dgsparse_tpu_torch.ops.spmm_mh import spmm_multihead
from dgsparse_tpu_torch.ops.types import Algorithm
from dgsparse_tpu_torch.utils import metrics

# the slot-space branch's gate on the edge count (JAX's `1 << 21`); a
# module constant so that tests can lower it
GAT_SLOT_MIN_NNZ = 1 << 21


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
        if st.ell_plan() is not None and st.nnz >= GAT_SLOT_MIN_NNZ:
            out = torch.stack(
                [gat_attention(adj, sd[:, i].contiguous(),
                               ss[:, i].contiguous(),
                               h[:, i].contiguous(), self.negative_slope)
                 for i in range(self.num_heads)], dim=1)
            return out.reshape(n, self.num_heads * self.out_features)
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
        with metrics.span("dgsparse.model.GAT.forward", nodes=x.shape[0],
                          nnz=adj.nnz):
            return self.gat2(F.elu(self.gat1(x, adj)), adj)
