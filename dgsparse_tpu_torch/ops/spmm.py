"""CSR SpMM with SUM/MEAN/MAX/MIN reductions: the public ops.

Counterpart of `spmm`, `spmm_sum`, `spmm_mean`, `spmm_max` and `spmm_min`
in `dgsparse_tpu/ops/spmm.py`, with the same shape checks. Two
`torch.autograd.Function`s carry them, both with values [nnz, H] and dense
[N, H, F] so that `spmm_multihead` (and `gspmm`) share them:

`_SpMM` (SUM/MEAN) runs `kernels/spmm_csr.py::csr_spmm` (the Hopper kernel
on CUDA, its plain version on the CPU) with the reference's gradient
structure (`ops/spmm.py:206-280`, src/spmm.cpp:66-74):
  d_dense  = Aᵀ·g, the same kernel over the CSC view cached at
             construction (colptr, row, values permuted by csr2csc);
  d_values = SDDMM(g, dense), `kernels/sddmm_csr.py`, computed only when
             the values require a gradient (a GCN's constant adjacency
             never does);
with g divided by max(deg, 1) first for MEAN.

`_SpMMMaxMin` (MAX/MIN, any semiring compute) runs
`kernels/spmm_maxmin.py::spmm_maxmin`, which also returns the winning CSR
edge id of every output element, and saves it. Its backward is the
edge-space winner-mask backward of `ops/spmm.py:472-530`: the gradient of
each output element flows through its winning edge only,
  d_dense  = `spmm_maxmin_d_dense` over the CSC view, scaled by the
             per-edge partial of compute in the feature (1 for copy_u,
             ADD and SUB, the value for MUL, 1/value for DIV);
  d_values = `spmm_maxmin_d_values`, the masked sum of g (ADD/SUB) or of
             g·dense (MUL/DIV) per edge, times the rest of the partial in
             the value (`_dcompute`, `ops/gspmm.py:37-48`); only when the
             values require a gradient.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import gather_rows, row_degrees
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.kernels.spmm_maxmin import (spmm_maxmin,
                                                    spmm_maxmin_d_dense,
                                                    spmm_maxmin_d_values)
from dgsparse_tpu_torch.ops.types import (Algorithm, ComputeOp, ReduceOp,
                                          as_algorithm, as_reduce)


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


class _SpMMMaxMin(torch.autograd.Function):
    """out [M, H, F]: per head h, the MAX/MIN over each row's edges e of
    compute(values[e, h], dense[col[e], h]) (dense alone for values None,
    copy_u). One `spmm_maxmin` launch serves every head."""

    @staticmethod
    def forward(ctx, values, dense, st: Storage, reduce: ReduceOp,
                compute: ComputeOp):
        n, h, f = dense.shape
        out, arg = spmm_maxmin(st.rowptr(), st.col(), values,
                               dense.reshape(n, h * f), reduce, compute,
                               coo_row=st.coo_row())
        ctx.st, ctx.compute = st, compute
        ctx.save_for_backward(values, dense, arg)
        return out.reshape(st.num_rows, h, f)

    @staticmethod
    def backward(ctx, g):
        values, dense, arg = ctx.saved_tensors
        st, compute = ctx.st, ctx.compute
        n, h, f = dense.shape
        g = g.reshape(st.num_rows, h * f).contiguous()
        d_values = d_dense = None
        if ctx.needs_input_grad[1]:
            # d compute / d feat per edge: 1, the value, or its reciprocal
            w = None
            if values is not None and compute == ComputeOp.MUL:
                w = values
            elif values is not None and compute == ComputeOp.DIV:
                w = 1.0 / values
            d_dense = spmm_maxmin_d_dense(
                st.colptr(), st.row(), st.csr2csc(),
                transpose_values(w, st), arg, g, csc_col=st.csc_col())
            d_dense = d_dense.reshape(n, h, f).to(dense.dtype)
        if ctx.needs_input_grad[0]:
            dot = compute in (ComputeOp.MUL, ComputeOp.DIV)
            s = spmm_maxmin_d_values(
                st.rowptr(), st.col(), arg, g,
                dense.reshape(n, h * f) if dot else None, h,
                coo_row=st.coo_row())
            if compute == ComputeOp.SUB:
                s = -s
            elif compute == ComputeOp.DIV:
                s = -s / (values * values)
            d_values = s.to(values.dtype)
        return d_values, d_dense, None, None, None


def aggregate(values, dense: torch.Tensor, st: Storage, reduce: ReduceOp,
              compute: ComputeOp = ComputeOp.MUL) -> torch.Tensor:
    """The differentiable [M, H, F] SpMM of values [nnz, H] (or None) and
    dense [N, H, F] under any reduction; SUM/MEAN take MUL only."""
    if reduce in (ReduceOp.MAX, ReduceOp.MIN):
        return _SpMMMaxMin.apply(values, dense, st, reduce, compute)
    if compute != ComputeOp.MUL:
        raise ValueError(f"the {reduce.value} SpMM multiplies, got {compute}")
    return _SpMM.apply(values, dense, st, reduce)


def spmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
         algorithm=Algorithm.AUTO) -> torch.Tensor:
    """SpMM with a selectable reduction. Returns [M, F]; differentiable
    in `dense` and in the sparse values.

    SUM/MEAN run the CSR kernel, MAX/MIN the CSR max/min kernel, whatever
    the `algorithm`. MAX/MIN keep the earliest winning edge of each
    element (ties included) and send its gradient there alone.
    """
    reduce = as_reduce(reduce)
    as_algorithm(algorithm)
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
    out = aggregate(values, dense.contiguous().unsqueeze(1), st, reduce)
    return out.squeeze(1)


def spmm_sum(sparse: SparseTensor, dense: torch.Tensor,
             algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:5-28 (spmm_sum)."""
    return spmm(sparse, dense, ReduceOp.SUM, algorithm)


def spmm_mean(sparse: SparseTensor, dense: torch.Tensor,
              algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:31-54 (spmm_mean)."""
    return spmm(sparse, dense, ReduceOp.MEAN, algorithm)


def spmm_max(sparse: SparseTensor, dense: torch.Tensor,
             algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:57-80 (spmm_max)."""
    return spmm(sparse, dense, ReduceOp.MAX, algorithm)


def spmm_min(sparse: SparseTensor, dense: torch.Tensor,
             algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:83-106 (spmm_min)."""
    return spmm(sparse, dense, ReduceOp.MIN, algorithm)
