"""COO SpMM: reduce over an edge list in any order.

Counterpart of `dgsparse_tpu/ops/spmm_coo.py::spmm_coo` (reference:
`cuda_csr_coo_spmm`, src/ge-spmm/gespmm_csrcoo_v2.cu). The JAX package
reduces the unsorted list with XLA segment ops; the port sorts it once by
row with a stable sort (`Storage`'s `coo2csr`, on the host) and runs the
CSR ops of `ops/spmm.py`, so every reduction rides the CSR kernels. The
sort is stable, so within a row the edges keep the caller's order and
MAX/MIN's "earliest edge wins a tie" means the earliest in the caller's
list, as there. The values are permuted by differentiable indexing, so
their gradient comes back in the caller's edge order.

For repeated use of one graph, build a `SparseTensor` once: this op pays
the sort and the CSC view on every call.
"""

from typing import Optional

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import spmm


def spmm_coo(row: torch.Tensor, col: torch.Tensor,
             values: Optional[torch.Tensor], dense: torch.Tensor,
             num_rows: int, reduce="sum") -> torch.Tensor:
    """COO SpMM: out[m] = reduce_{e: row[e]=m} values[e] * dense[col[e]].

    row, col: [nnz] int edge endpoints, any order, duplicates allowed.
    values: [nnz] or None (implicit ones). dense: [N, F]. Returns [M, F]
    with M = num_rows, differentiable in values and dense.
    """
    if row.shape != col.shape or row.dim() != 1:
        raise ValueError(
            f"row/col must be matching [nnz] vectors, got "
            f"{tuple(row.shape)} vs {tuple(col.shape)}")
    if dense.dim() != 2:
        raise ValueError(f"dense must be [N, F], got {tuple(dense.shape)}")
    if values is not None and values.shape != row.shape:
        raise ValueError(
            f"values must be [nnz={row.shape[0]}], got {tuple(values.shape)}")
    sparse = SparseTensor(row=row, col=col, values=values,
                          has_value=values is not None,
                          sparse_sizes=(int(num_rows), dense.shape[0]),
                          device=dense.device)
    return spmm(sparse, dense, reduce)
