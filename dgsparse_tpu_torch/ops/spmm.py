"""CSR SpMM with SUM/MEAN reductions: the public ops.

Counterpart of `spmm`, `spmm_sum` and `spmm_mean` in
`dgsparse_tpu/ops/spmm.py`, with the same shape checks. `_SpMM` is a
`torch.autograd.Function` over `kernels/spmm_csr.py::csr_spmm` (the Hopper
kernel on CUDA, its plain version on the CPU), with values [nnz, H] and
dense [N, H, F] so that `spmm_multihead` shares it, and with the
reference's gradient structure (`ops/spmm.py:206-280`, src/spmm.cpp:66-74):
  d_dense  = Aᵀ·g, the same kernel over the CSC view cached at
             construction (colptr, row, values permuted by csr2csc);
  d_values = SDDMM(g, dense), `kernels/sddmm_csr.py`, computed only when
             the values require a gradient (a GCN's constant adjacency
             never does);
with g divided by max(deg, 1) first for MEAN.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import gather_rows, row_degrees
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.ops.types import (Algorithm, ReduceOp, as_algorithm,
                                          as_reduce)


def mean_scaled(g: torch.Tensor, st: Storage,
                per_edge: bool = False) -> torch.Tensor:
    """g divided by max(deg, 1) of its row: g [M, ...] row by row (the
    cotangent of a MEAN SpMM), or with `per_edge` g [nnz, ...] edge by edge
    (that of a MEAN SDDMM); either way what the SUM backward takes."""
    deg = torch.clamp(row_degrees(st.rowptr()), min=1).to(g.dtype)
    if per_edge:
        deg = deg[st.coo_row().long()]
    return g / deg.reshape((-1,) + (1,) * (g.dim() - 1))


def transpose_values(values, st: Storage):
    """Edge values (or None) in the CSC view's edge order, contiguous."""
    if values is None:
        return None
    return gather_rows(values, st.csr2csc()).contiguous()


class _SpMM(torch.autograd.Function):
    """out [M, H, F]: per head h, the SpMM of the structure with values
    [:, h] (or ones for values None) and dense [N, H, F][:, h]. One
    `csr_spmm` launch serves every head; `spmm` is the case H = 1."""

    @staticmethod
    def forward(ctx, values, dense, st: Storage, reduce: ReduceOp):
        ctx.st, ctx.reduce = st, reduce
        ctx.save_for_backward(values, dense)
        n, h, f = dense.shape
        out = csr_spmm(st.rowptr(), st.col(), values, dense.reshape(n, h * f),
                       reduce, coo_row=st.coo_row())
        return out.reshape(st.num_rows, h, f)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
            raise NotImplementedError(
                f"the {ctx.reduce.value} backward comes with the MAX/MIN "
                "kernel (ROADMAP.md, queue B)")
        values, dense = ctx.saved_tensors
        st = ctx.st
        n, h, f = dense.shape
        g = g.reshape(st.num_rows, h * f).contiguous()
        if ctx.reduce == ReduceOp.MEAN:
            g = mean_scaled(g, st)
        d_values = d_dense = None
        if ctx.needs_input_grad[0]:
            d_values = sddmm_csr(st.rowptr(), st.col(), g,
                                 dense.reshape(n, h * f), h,
                                 coo_row=st.coo_row()).to(values.dtype)
        if ctx.needs_input_grad[1]:
            d_dense = csr_spmm(st.colptr(), st.row(),
                               transpose_values(values, st), g,
                               ReduceOp.SUM, coo_row=st.csc_col())
            d_dense = d_dense.reshape(n, h, f).to(dense.dtype)
        return d_values, d_dense, None, None


def spmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
         algorithm=Algorithm.AUTO) -> torch.Tensor:
    """SpMM with a SUM or MEAN reduction. Returns [M, F]; differentiable
    in `dense` and in the sparse values.

    Every `algorithm` runs the one CSR kernel; MAX/MIN are not ported yet.
    """
    reduce = as_reduce(reduce)
    as_algorithm(algorithm)
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise NotImplementedError(
            f"spmm reduce={reduce.value} is not ported yet; MAX/MIN come "
            "with their kernel (ROADMAP.md, queue B)")
    if dense.dim() != 2:
        raise ValueError(
            f"dense must be [N, F], got shape {tuple(dense.shape)}")
    if dense.shape[0] != sparse.sparse_sizes()[1]:
        raise ValueError(
            f"dense rows {dense.shape[0]} != sparse num_cols "
            f"{sparse.sparse_sizes()[1]}")
    st = sparse.storage
    values = st.values() if sparse.has_value else None
    if values is not None and values.dim() != 1:
        raise ValueError(
            f"spmm takes one value per edge, got {tuple(values.shape)}; "
            "per-head values go to spmm_multihead")
    if values is not None:
        values = values.float().unsqueeze(1)
    out = _SpMM.apply(values, dense.contiguous().unsqueeze(1), st, reduce)
    return out.squeeze(1)


def spmm_sum(sparse: SparseTensor, dense: torch.Tensor,
             algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:5-28 (spmm_sum)."""
    return spmm(sparse, dense, ReduceOp.SUM, algorithm)


def spmm_mean(sparse: SparseTensor, dense: torch.Tensor,
              algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:31-54 (spmm_mean)."""
    return spmm(sparse, dense, ReduceOp.MEAN, algorithm)
