"""Graph neural network modules (counterpart of dgsparse_tpu/nn)."""

from dgsparse_tpu_torch.nn import gat as _gat
from dgsparse_tpu_torch.nn import gcn as _gcn
from dgsparse_tpu_torch.nn.gat import GAT, GATConv
from dgsparse_tpu_torch.nn.gcn import (GCN, GCNConv, gcn_norm_from_edge_index,
                                       get_gcn_dcsr_from_edge_index)


def load_flax_params(model, params):
    """Copy the JAX package's flax params into a GCN or a GAT."""
    if isinstance(model, GAT):
        return _gat.load_flax_params(model, params)
    return _gcn.load_flax_params(model, params)


__all__ = [
    "GAT",
    "GATConv",
    "GCN",
    "GCNConv",
    "gcn_norm_from_edge_index",
    "get_gcn_dcsr_from_edge_index",
    "load_flax_params",
]
