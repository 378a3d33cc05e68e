"""Edge softmax: softmax of per-edge logits over each destination row.

Counterpart of `dgsparse_tpu/ops/edge_softmax.py`: slot-space logits
(`SlotValues`) go to `ops/slot.py::edge_softmax_slots`. The JAX version
is XLA segment ops, not a
Pallas kernel, and so is this one in PyTorch: a row max, exp, a row sum.
Numerically stable (max-shifted, the shift detached, which is exact for
softmax); empty rows are a no-op.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.core.transform import gather_rows


def _row_sums(x: torch.Tensor, row: torch.Tensor, m: int) -> torch.Tensor:
    """Per-row sums of per-edge x. A 2-D x is summed into an [H, M] buffer
    and returned as its column-major [M, H] view: the backward of
    index_add_ gathers gradient rows, fast only column-major
    (`gather_rows`)."""
    if x.dim() == 2:
        return x.new_zeros(x.shape[1], m).index_add(1, row, x.t()).t()
    return x.new_zeros((m,) + tuple(x.shape[1:])).index_add(0, row, x)


def edge_softmax(sparse: SparseTensor, logits: torch.Tensor) -> torch.Tensor:
    """Softmax of `logits` [nnz] or [nnz, ...] (e.g. per attention head)
    grouped by destination row. Returns the same shape. Slot-space logits
    (`SlotValues`) give SlotValues (`edge_softmax_slots`)."""
    from dgsparse_tpu_torch.ops.slot import SlotValues, edge_softmax_slots

    if isinstance(logits, SlotValues):
        return edge_softmax_slots(sparse, logits)
    st = sparse.storage
    row = st.coo_row()
    m = st.num_rows
    shape = (m,) + tuple(logits.shape[1:])
    idx = row.long().reshape((-1,) + (1,) * (logits.dim() - 1))
    row_max = torch.full(shape, float("-inf"), dtype=logits.dtype,
                         device=logits.device)
    row_max = row_max.scatter_reduce(0, idx.expand_as(logits),
                                     logits.detach(), "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    # index_select / index_add, not x[row]: the backward of advanced
    # indexing sorts the indices, index_select's adds with atomics
    ex = torch.exp(logits - gather_rows(row_max, row))
    denom = _row_sums(ex, row, m)
    return ex / gather_rows(torch.clamp(denom, min=1e-38), row)
