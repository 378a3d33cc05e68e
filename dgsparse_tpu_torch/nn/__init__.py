"""Graph neural network and sparse-convolution modules (counterpart of
dgsparse_tpu/nn).

Module and parameter names follow flax's, so `load_flax_params` copies a
JAX model's params into any of them by path.
"""

from dgsparse_tpu_torch.nn._flax import load_flax_params
from dgsparse_tpu_torch.nn.edgeconv import DGCNN, EdgeConv
from dgsparse_tpu_torch.nn.gat import GAT, GATConv
from dgsparse_tpu_torch.nn.gcn import (GCN, GCNConv, gcn_norm_from_edge_index,
                                       get_gcn_dcsr_from_edge_index)
from dgsparse_tpu_torch.nn.gin import GIN, MLP, GINConv
from dgsparse_tpu_torch.nn.sage import SAGE, SAGEConv
from dgsparse_tpu_torch.nn.sparse_conv import (SparseConv3d, SparseConvBlock,
                                               SparseInverseConv3d,
                                               SubMConv3d)
from dgsparse_tpu_torch.nn.unet import PointCloudUNet

__all__ = [
    "DGCNN",
    "EdgeConv",
    "GAT",
    "GATConv",
    "GCN",
    "GCNConv",
    "GIN",
    "GINConv",
    "MLP",
    "PointCloudUNet",
    "SAGE",
    "SAGEConv",
    "SparseConv3d",
    "SparseConvBlock",
    "SparseInverseConv3d",
    "SubMConv3d",
    "gcn_norm_from_edge_index",
    "get_gcn_dcsr_from_edge_index",
    "load_flax_params",
]
