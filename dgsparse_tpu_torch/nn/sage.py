"""GraphSAGE layer (mean aggregator) and 2-layer model on `spmm_mean`.

Counterpart of `dgsparse_tpu/nn/sage.py` (no reference equivalent): each
layer is lin_self(x) + lin_neigh(mean of the neighbours' x), the mean run
by the CSR SpMM kernel. Names follow flax's (`sage1/lin_self`, ...), so
`nn.load_flax_params` copies a JAX model's params by path.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn._flax import init_like_flax_dense
from dgsparse_tpu_torch.ops.spmm import spmm_mean
from dgsparse_tpu_torch.ops.types import Algorithm


class SAGEConv(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 algorithm: Algorithm = Algorithm.AUTO,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.algorithm = algorithm
        self.lin_self = nn.Linear(in_features, out_features)
        self.lin_neigh = nn.Linear(in_features, out_features)
        for linear in (self.lin_self, self.lin_neigh):
            init_like_flax_dense(linear, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        neigh = spmm_mean(adj, x, self.algorithm)
        return self.lin_self(x) + self.lin_neigh(neigh)


class SAGE(nn.Module):
    """sage1 -> ReLU -> sage2."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.sage1 = SAGEConv(in_features, hidden_features,
                              generator=generator)
        self.sage2 = SAGEConv(hidden_features, out_features,
                              generator=generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        return self.sage2(F.relu(self.sage1(x, adj)), adj)
