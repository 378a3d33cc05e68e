"""CSR SpMM with SUM/MEAN reductions: the public ops.

Counterpart of `spmm`, `spmm_sum` and `spmm_mean` in
`dgsparse_tpu/ops/spmm.py`, with the same shape checks. The forward runs
`kernels/spmm_csr.py::csr_spmm` (the Hopper kernel on CUDA, its plain
version on the CPU) inside a `torch.autograd.Function`. The backward is
the next slice of the port (ROADMAP.md: the GCN training step), so it
raises rather than let a gradient vanish at the ctypes call.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.ops.types import (Algorithm, ReduceOp, as_algorithm,
                                          as_reduce)


class _SpMM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, dense, rowptr, col, coo_row, reduce):
        return csr_spmm(rowptr, col, values, dense, reduce, coo_row=coo_row)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the SpMM backward is not ported yet: it comes with the GCN "
            "training-step slice (ROADMAP.md, queue A #3)")


def spmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
         algorithm=Algorithm.AUTO) -> torch.Tensor:
    """SpMM with a SUM or MEAN reduction. Returns [M, F].

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
    if values is not None and values.dtype != torch.float32:
        values = values.float()
    return _SpMM.apply(values, dense.contiguous(), st.rowptr(), st.col(),
                       st.coo_row(), reduce)


def spmm_sum(sparse: SparseTensor, dense: torch.Tensor,
             algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:5-28 (spmm_sum)."""
    return spmm(sparse, dense, ReduceOp.SUM, algorithm)


def spmm_mean(sparse: SparseTensor, dense: torch.Tensor,
              algorithm=Algorithm.AUTO) -> torch.Tensor:
    """Reference parity: dgsparse/spmm.py:31-54 (spmm_mean)."""
    return spmm(sparse, dense, ReduceOp.MEAN, algorithm)
