"""Graph neural network modules (counterpart of dgsparse_tpu/nn)."""

from dgsparse_tpu_torch.nn.gcn import (GCN, GCNConv, gcn_norm_from_edge_index,
                                       get_gcn_dcsr_from_edge_index,
                                       load_flax_params)

__all__ = [
    "GCN",
    "GCNConv",
    "gcn_norm_from_edge_index",
    "get_gcn_dcsr_from_edge_index",
    "load_flax_params",
]
