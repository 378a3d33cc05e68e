"""Edge softmax: softmax of per-edge logits over each destination row.

Counterpart of `dgsparse_tpu/ops/edge_softmax.py`: slot-space logits
(`SlotValues`) go to `ops/slot.py::edge_softmax_slots`. The JAX version is
XLA segment ops; here one autograd Function runs the row softmax forward
and its backward, d_logits = alpha * (g - the row's sum of alpha * g), on
the storage's CSR order: the hand-written kernels of
`kernels/edge_softmax.py` for CUDA float32 logits, their plain versions for
every other tensor. Numerically stable (shifted by the row's max, which is
exact for softmax); empty rows are a no-op; a row whose logits are all -inf
gives 0.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.kernels import edge_softmax as K
from dgsparse_tpu_torch.utils import metrics


class _EdgeSoftmax(torch.autograd.Function):
    """alpha = the row softmax of logits [nnz, ...]; its backward reads the
    saved alpha alone and writes d_logits in the logits' layout (a GAT
    layer's logits may be column-major)."""

    @staticmethod
    def forward(ctx, logits, st):
        ctx.st, ctx.span = st, metrics.current()
        ctx.column_major = (logits.dim() == 2 and logits.shape[1] > 1
                            and logits.stride(0) == 1)
        alpha = K.edge_softmax(st.rowptr(), logits, coo_row=st.coo_row(),
                               split=st.row_split())
        ctx.save_for_backward(alpha)
        return alpha

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span, d_logits=True):
            (alpha,) = ctx.saved_tensors
            st = ctx.st
            return K.edge_softmax_bwd(st.rowptr(), alpha, g,
                                      coo_row=st.coo_row(),
                                      split=st.row_split(),
                                      column_major=ctx.column_major), None


def edge_softmax(sparse: SparseTensor, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of `logits` [nnz] or [nnz, ...] (e.g. per attention head)
    grouped by destination row. Returns the same shape. Slot-space logits
    (`SlotValues`) give SlotValues (`edge_softmax_slots`)."""
    from dgsparse_tpu_torch.ops.slot import SlotValues, edge_softmax_slots

    if isinstance(logits, SlotValues):
        return edge_softmax_slots(sparse, logits)
    st = sparse.storage
    heads = logits.numel() // max(st.nnz, 1)
    metrics.record("edge_softmax", nnz=st.nnz, heads=heads)
    if not metrics.enabled():
        return _EdgeSoftmax.apply(logits, st)
    with metrics.span("dgsparse.op.edge_softmax.edge.fwd", m=st.num_rows,
                      nnz=st.nnz, heads=heads, dtype=str(logits.dtype)[6:],
                      d_logits=logits.requires_grad):
        return _EdgeSoftmax.apply(logits, st)
