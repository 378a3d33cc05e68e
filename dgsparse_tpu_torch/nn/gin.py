"""GIN layer + model (reference: dgsparse/nn/ginconv.py:9-112).

Counterpart of `dgsparse_tpu/nn/gin.py`: out = MLP((1 + eps) * x +
aggregate(adj, x)), the aggregator one of {sum, max, mean}. The sum and
mean aggregations run the CSR SpMM kernel, max the CSR max/min kernel,
whose backward sends each element's gradient to its earliest winning
edge. Module and parameter names follow flax's (`gin{i}/apply_func/
Dense_{j}`, `gin{i}/eps`, `readout`), so `load_flax_params` copies a JAX
model's params by path.
"""

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn._flax import init_like_flax_dense
from dgsparse_tpu_torch.ops.spmm import spmm
from dgsparse_tpu_torch.ops.types import Algorithm
from dgsparse_tpu_torch.utils import metrics

AGGREGATORS = ("sum", "max", "mean")


class MLP(nn.Module):
    """Dense layers `Dense_0 .. Dense_{k-1}` with ReLU between them."""

    def __init__(self, in_features: int, features: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_features, *features]
        self.num_layers = len(features)
        for i in range(self.num_layers):
            linear = nn.Linear(dims[i], dims[i + 1])
            init_like_flax_dense(linear, generator)
            self.add_module(f"Dense_{i}", linear)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i + 1 < self.num_layers:
                x = F.relu(x)
        return x


class GINConv(nn.Module):
    """Reference parity: GINConv (ginconv.py:9-61)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 aggregator_type: str = "sum", init_eps: float = 0.0,
                 learn_eps: bool = False,
                 algorithm: Algorithm = Algorithm.AUTO,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if aggregator_type not in AGGREGATORS:
            raise ValueError(f"bad aggregator {aggregator_type}")
        self.aggregator_type = aggregator_type
        self.algorithm = algorithm
        if learn_eps:
            self.eps = nn.Parameter(torch.tensor(float(init_eps)))
        else:
            self.eps = float(init_eps)
        self.apply_func = MLP(in_features, features, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        neigh = spmm(adj, x, self.aggregator_type, self.algorithm)
        return self.apply_func((1 + self.eps) * x + neigh)


class GIN(nn.Module):
    """Multi-layer GIN (reference: ginconv.py:64-112): `num_layers - 1`
    GINConv layers of MLP (hidden, hidden), each followed by ReLU and
    dropout, then a Dense readout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_layers: int = 2,
                 aggregator_type: str = "sum", dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_convs = num_layers - 1
        self.dropout = dropout
        for i in range(self.num_convs):
            self.add_module(f"gin{i}", GINConv(
                in_features if i == 0 else hidden_features,
                (hidden_features, hidden_features), aggregator_type,
                generator=generator))
        self.readout = nn.Linear(
            hidden_features if self.num_convs else in_features, out_features)
        init_like_flax_dense(self.readout, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        with metrics.span("dgsparse.model.GIN.forward", nodes=x.shape[0],
                          nnz=adj.nnz):
            for i in range(self.num_convs):
                x = F.relu(getattr(self, f"gin{i}")(x, adj))
                x = F.dropout(x, self.dropout, training=self.training)
            return self.readout(x)
