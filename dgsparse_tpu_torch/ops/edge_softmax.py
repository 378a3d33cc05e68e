"""Edge softmax: softmax of per-edge logits over each destination row.

Counterpart of `dgsparse_tpu/ops/edge_softmax.py`: slot-space logits
(`SlotValues`) go to `ops/slot.py::edge_softmax_slots`. The JAX version
is XLA segment ops, not a
Pallas kernel, and so is this one in PyTorch: a row max, exp, a row sum.
Numerically stable (max-shifted, the shift detached, which is exact for
softmax); empty rows are a no-op.

Its backward is autograd's, over the aten nodes of the forward. With
tracing on (`utils/metrics.py`) and a gradient to compute, two identity
autograd Functions bracket the op: `_OpenBackward` on the output opens
its `.bwd` span when the cotangent arrives, before any of those nodes
runs, and `_CloseBackward` on the logits closes it once their gradient
is complete. With tracing off the graph is the op's alone.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.core.transform import gather_rows
from dgsparse_tpu_torch.utils import metrics


class _Bracket:
    """The `.bwd` span of one call, opened and closed by two nodes."""

    def __init__(self, fwd):
        self.fwd, self.open = fwd, None


class _OpenBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bracket):
        ctx.bracket = bracket
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        b = ctx.bracket
        if b.open is None:
            b.open = metrics.backward_span(b.fwd, d_logits=True)
            b.open.__enter__()
        return g, None


class _CloseBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bracket):
        ctx.bracket = bracket
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        b = ctx.bracket
        if b.open is not None:
            b.open.__exit__(None, None, None)
            b.open = None
        return g, None


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
    heads = logits.numel() // max(st.nnz, 1)
    metrics.record("edge_softmax", nnz=st.nnz, heads=heads)
    if not metrics.enabled():
        return _edge_softmax(st, logits)
    with metrics.span("dgsparse.op.edge_softmax.edge.fwd", m=st.num_rows,
                      nnz=st.nnz, heads=heads, dtype=str(logits.dtype)[6:],
                      d_logits=logits.requires_grad) as fwd:
        bracket = None
        if torch.is_grad_enabled() and logits.requires_grad:
            bracket = _Bracket(fwd)
            logits = _CloseBackward.apply(logits, bracket)
        out = _edge_softmax(st, logits)
        if bracket is not None:
            out = _OpenBackward.apply(out, bracket)
        return out


def _edge_softmax(st, logits: torch.Tensor) -> torch.Tensor:
    """The softmax of `edge_softmax` on the storage's CSR order."""
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
