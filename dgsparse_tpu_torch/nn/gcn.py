"""GCN layer + 2-layer model (reference: dgsparse/nn/gcnconv.py:10-70).

Counterpart of `dgsparse_tpu/nn/gcn.py`. Graph normalization is the same
host-side numpy step, producing a SparseTensor once; the model is a
`torch.nn.Module` whose layers run `Linear -> spmm_sum`. As in the JAX
package, the bias is added before the aggregation: A·(XW + b).
"""

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn._flax import (  # noqa: F401  (load_flax_params)
    init_like_flax_dense, load_flax_params)
from dgsparse_tpu_torch.ops.spmm import spmm_sum
from dgsparse_tpu_torch.ops.types import Algorithm
from dgsparse_tpu_torch.utils import metrics


def gcn_norm_from_edge_index(
    edge_index: np.ndarray, num_nodes: int, add_self_loops: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side GCN normalization: values of D^-1/2 (A+I) D^-1/2 as CSR
    (rowptr, col, vals). Duplicate edges are kept."""
    row, col = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    if add_self_loops:
        loops = np.arange(num_nodes, dtype=row.dtype)
        row = np.concatenate([row, loops])
        col = np.concatenate([col, loops])
    order = np.lexsort((col, row))
    row, col = row[order], col[order]
    deg = np.bincount(row, minlength=num_nodes).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    vals = (dinv[row] * dinv[col]).astype(np.float32)
    rowptr = np.zeros(num_nodes + 1, np.int32)
    np.add.at(rowptr, row + 1, 1)
    rowptr = np.cumsum(rowptr).astype(np.int32)
    return rowptr, col.astype(np.int32), vals


def get_gcn_dcsr_from_edge_index(edge_index, num_nodes: int,
                                 device=None) -> SparseTensor:
    """Normalized adjacency as a SparseTensor (reference
    get_gcn_dcsr_from_edge_index, dgsparse/nn/gcnconv.py:53-70)."""
    with metrics.span("dgsparse.adjacency.gcn_norm", nodes=num_nodes):
        rowptr, col, vals = gcn_norm_from_edge_index(edge_index, num_nodes)
    return SparseTensor.from_csr(rowptr, col, torch.from_numpy(vals),
                                 sparse_sizes=(num_nodes, num_nodes),
                                 device=device)


class GCNConv(nn.Module):
    """One GCN layer: x -> A_hat · (x W + b)."""

    def __init__(self, in_features: int, out_features: int,
                 algorithm: Algorithm = Algorithm.AUTO,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.algorithm = algorithm
        self.linear = nn.Linear(in_features, out_features)
        self.reset_parameters(generator)

    def reset_parameters(self,
                         generator: Optional[torch.Generator] = None) -> None:
        init_like_flax_dense(self.linear, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        return spmm_sum(adj, self.linear(x), self.algorithm)


class GCN(nn.Module):
    """2-layer GCN (reference: gcnconv.py:22-33): conv -> relu -> dropout ->
    conv."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, dropout: float = 0.5,
                 algorithm: Algorithm = Algorithm.AUTO,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = GCNConv(in_features, hidden_features, algorithm,
                             generator)
        self.conv2 = GCNConv(hidden_features, out_features, algorithm,
                             generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        with metrics.span("dgsparse.model.GCN.forward", nodes=x.shape[0],
                          nnz=adj.nnz):
            x = F.relu(self.conv1(x, adj))
            x = F.dropout(x, self.dropout, training=self.training)
            return self.conv2(x, adj)
