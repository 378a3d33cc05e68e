"""SDDMM: sampled dense-dense matmul producing per-edge values.

Counterpart of `dgsparse_tpu/ops/sddmm.py` (reference:
src/sddmm/sddmm.cu:8-41 and src/cuda/spmm_cuda.cu:305-382):
out[e] = dot(d1[row_e], d2[col_e]), MEAN dividing by max(row degree, 1).
It runs `kernels/sddmm_csr.py` (the Hopper kernel on CUDA, its plain
version on the CPU); the JAX package's "pallas" choice was its `sddmm_esc`
kernel, which this one replaces. On a storage whose hybrid plan has dense
cells, "auto" and "xla" run `ops/hybrid.py::sddmm_hybrid` instead (the
cells' blocks from `sddmm_cells`, the other edges from `sddmm_csr`), as
`dgsparse_tpu/ops/sddmm.py:55-62` does on the TPU.

The backward follows `ops/sddmm.py:72-94`: both gradients are SpMMs with
the cotangent as edge values (divided by the row degree for MEAN),
  d_d1 = A(g) · d2        (the CSR kernel),
  d_d2 = A(g)ᵀ · d1       (the same kernel over the CSC view, g permuted).
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.ops.hybrid import sddmm_hybrid
from dgsparse_tpu_torch.ops.spmm import mean_scaled, transpose_values
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.debug import maybe_validate

ALGORITHMS = ("auto", "xla", "pallas")


class _SDDMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, d1, d2, st: Storage, reduce: ReduceOp, hybrid: bool):
        ctx.st, ctx.reduce = st, reduce
        ctx.span = metrics.current()
        ctx.save_for_backward(d1, d2)
        if hybrid:
            return sddmm_hybrid(st, d1, d2, reduce)
        return sddmm_csr(st.rowptr(), st.col(), d1, d2, 1, reduce,
                         coo_row=st.coo_row(),
                         split=st.row_split()).reshape(-1)

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span, d_d1=ctx.needs_input_grad[0],
                                   d_d2=ctx.needs_input_grad[1]):
            return _SDDMM._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        d1, d2 = ctx.saved_tensors
        st = ctx.st
        g = g.float().contiguous()
        if ctx.reduce == ReduceOp.MEAN:
            g = mean_scaled(g, st, per_edge=True)
        d_d1 = d_d2 = None
        if ctx.needs_input_grad[0]:
            d_d1 = csr_spmm(st.rowptr(), st.col(), g, d2, ReduceOp.SUM,
                            coo_row=st.coo_row(),
                            split=st.row_split()).to(d1.dtype)
        if ctx.needs_input_grad[1]:
            d_d2 = csr_spmm(st.colptr(), st.row(), transpose_values(g, st),
                            d1, ReduceOp.SUM, coo_row=st.csc_col(),
                            split=st.col_split()).to(d2.dtype)
        return d_d1, d_d2, None, None, None


def sddmm(sparse: SparseTensor, d1: torch.Tensor, d2: torch.Tensor,
          reduce="sum", algorithm="auto") -> torch.Tensor:
    """Per-edge dots over the sparsity pattern of `sparse`.

    d1: [M, F] (rows), d2: [N, F] (cols). Returns [nnz] in CSR edge order
    in the dtype the JAX function returns for these inputs (their
    promoted dtype: bfloat16 for bfloat16), cast from the kernels'
    float32 sums; differentiable in d1 and d2. `algorithm` is "auto",
    "xla" or "pallas" for parity with the JAX package: all run the CSR
    kernel, but "auto" and "xla" take the hybrid route on a storage whose
    hybrid plan has dense cells.
    """
    reduce = as_reduce(reduce)
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown sddmm algorithm {algorithm!r}")
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise NotImplementedError(f"sddmm handles SUM/MEAN, got {reduce}")
    maybe_validate(sparse)
    metrics.record("sddmm", alg=algorithm, reduce=str(reduce),
                   nnz=sparse.nnz, feat=d1.shape[-1])
    m, n = sparse.sparse_sizes()
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1] \
            or d1.shape[0] != m or d2.shape[0] != n:
        raise ValueError(
            f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [{m}, F] "
            f"and [{n}, F]")
    st = sparse.storage
    hp = st.ell_plan()
    hybrid = algorithm != "pallas" and hp is not None and hp.cells is not None
    with sddmm_span("hybrid" if hybrid else "csr", st, d1, d2, reduce):
        out = _SDDMM.apply(d1.contiguous(), d2.contiguous(), st, reduce,
                           hybrid)
        return out.to(torch.promote_types(d1.dtype, d2.dtype))


def sddmm_span(route: str, st: Storage, d1: torch.Tensor, d2: torch.Tensor,
               reduce: ReduceOp = ReduceOp.SUM):
    """The forward span of an SDDMM (`sddmm`, `sddmm_slots`) on `route`,
    with the tags its work count takes."""
    if not metrics.enabled():
        return metrics.NULL_SPAN
    return metrics.span(
        f"dgsparse.op.sddmm.{route}.fwd", m=st.num_rows, n=st.num_cols,
        nnz=st.nnz, f=d1.shape[1], reduce=reduce.value,
        dtype=str(d1.dtype)[6:], d_d1=d1.requires_grad,
        d_d2=d2.requires_grad)


def sddmm_coo(row: torch.Tensor, col: torch.Tensor, d1: torch.Tensor,
              d2: torch.Tensor) -> torch.Tensor:
    """COO-order SDDMM (reference: sddmm_cuda_coo, src/sddmm/sddmm.cu:8-24):
    out[e] = dot(d1[row[e]], d2[col[e]]) for edges in any order.

    As in the JAX package (an einsum of two gathers there), this is plain
    PyTorch, differentiated by autograd: unsorted edges have no CSR rows
    for the kernel to walk.
    """
    return (d1[row.long()] * d2[col.long()]).sum(-1)
