"""EdgeConv (DGCNN) layer: h_i = max_j ReLU(theta(x_i ‖ x_j − x_i)).

Counterpart of `dgsparse_tpu/nn/edgeconv.py` (no reference equivalent).
The per-edge MLP makes an [nnz, F'] edge-space tensor, so, as in the JAX
package, the layer is gathers, one dense matmul and a segment max over the
CSR rows (empty rows give 0), all plain PyTorch.

The segment max keeps JAX's gradient rule, not `spmm`'s: `jax.ops.
segment_max` splits an element's gradient evenly among the edges that tie
for its maximum, where `spmm` MAX sends it to the earliest winner alone.
`torch.Tensor.scatter_reduce(..., "amax")` follows neither rule (with
`include_self=False` two tied edges of a segment got 1/3 and 1/3 where
JAX gives 1/2 and 1/2), so `_SegmentMax` writes its own backward. After
the ReLU, ties at exactly 0 are common.
"""

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.nn._flax import init_like_flax_dense


class _SegmentMax(torch.autograd.Function):
    """Per row m of the CSR the max over its edges of e [nnz, F] (0 for
    an empty row); the gradient of each element is shared evenly by the
    edges that attain its maximum."""

    @staticmethod
    def forward(ctx, e, coo_row, num_rows: int):
        idx = coo_row.long()[:, None].expand(-1, e.shape[1])
        out = torch.full((num_rows, e.shape[1]), float("-inf"),
                         dtype=e.dtype, device=e.device)
        out.scatter_reduce_(0, idx, e, "amax")
        win = e == out.index_select(0, coo_row.long())
        ties = torch.zeros_like(out).index_add_(0, coo_row.long(),
                                                win.to(e.dtype))
        ctx.save_for_backward(coo_row, win, ties)
        return torch.where(ties > 0, out, torch.zeros_like(out))

    @staticmethod
    def backward(ctx, g):
        coo_row, win, ties = ctx.saved_tensors
        share = g / torch.clamp(ties, min=1)
        return (torch.where(win, share.index_select(0, coo_row.long()), 0.0),
                None, None)


def segment_max(e: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
    """Max of per-edge rows e [nnz, F] into the rows of `adj`, with JAX's
    even split of the gradient among ties."""
    st = adj.storage
    return _SegmentMax.apply(e, st.coo_row(), st.num_rows)


class EdgeConv(nn.Module):
    """Single EdgeConv layer over a fixed neighbourhood structure."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.theta = nn.Linear(2 * in_features, out_features)
        init_like_flax_dense(self.theta, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        st = adj.storage
        xi = x.index_select(0, st.coo_row().long())
        xj = x.index_select(0, st.col().long())
        e = F.relu(self.theta(torch.cat([xi, xj - xi], dim=-1)))
        return segment_max(e, adj)


class DGCNN(nn.Module):
    """Small DGCNN-style classifier: stacked EdgeConv + readout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"edge{i}", EdgeConv(
                in_features if i == 0 else hidden_features, hidden_features,
                generator))
        self.head = nn.Linear(hidden_features, out_features)
        init_like_flax_dense(self.head, generator)

    def forward(self, x: torch.Tensor, adj: SparseTensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"edge{i}")(x, adj)
        return self.head(x)
