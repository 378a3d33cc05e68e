"""Multi-head batched SpMM: per-head edge values over shared structure.

Counterpart of `dgsparse_tpu/ops/spmm_mh.py` for SUM/MEAN:
`spmm_multihead(sparse, values, dense)` with values [nnz, H] and dense
[N, H, F] computes, per head h, out[:, h] = SpMM(A_h, dense[:, h]) where
A_h is the shared structure with values[:, h]. As `spmm_esc_mh` folds the
heads into the feature axis of one `segment_matmul`, one launch of
`kernels/spmm_csr.py::csr_spmm` serves every head (dense viewed as
[N, H*F], feature j scaled by values[e, j // F]).

The autograd Function is `ops/spmm.py::_SpMM`, which `spmm` runs with one
head. Its backward follows `ops/spmm_mh.py:172-211`: after dividing g by
the degree for MEAN,
  d_values = the multi-head SDDMM of g and dense (`sddmm_csr`, H heads),
  d_dense  = the same multi-head SpMM over the CSC view, values permuted.
MAX/MIN and slot-order values (`SlotValues`) are not ported yet.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import _SpMM
from dgsparse_tpu_torch.ops.types import (Algorithm, ReduceOp, as_algorithm,
                                          as_reduce)


def spmm_multihead(sparse: SparseTensor, values, dense: torch.Tensor,
                   reduce="sum",
                   algorithm: Algorithm = Algorithm.AUTO) -> torch.Tensor:
    """Batched multi-head SpMM.

    Args:
      sparse: structure-only SparseTensor (its own values are ignored).
      values: [nnz, H] per-head edge values (e.g. attention weights), or
        None for copy-u aggregation shared across heads.
      dense: [N, H, F] per-head node features.
      reduce: "sum" or "mean".

    Returns [M, H, F], differentiable in values and dense.
    """
    reduce = as_reduce(reduce)
    as_algorithm(algorithm)
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise NotImplementedError(
            f"spmm_multihead reduce={reduce.value} is not ported yet; "
            "MAX/MIN come with their kernel (ROADMAP.md, queue B)")
    if isinstance(values, (list, tuple)):
        raise NotImplementedError(
            "slot-order per-head values (SlotValues) are not ported yet "
            "(ROADMAP.md, queue A #10)")
    st = sparse.storage
    if dense.dim() != 3:
        raise ValueError(f"dense must be [N, H, F], got {tuple(dense.shape)}")
    if dense.shape[0] != st.num_cols:
        raise ValueError(
            f"dense rows {dense.shape[0]} != sparse num_cols {st.num_cols}")
    if values is not None:
        if values.dim() != 2 or values.shape[0] != st.nnz \
                or values.shape[1] != dense.shape[1]:
            raise ValueError(
                f"values must be [nnz={st.nnz}, H={dense.shape[1]}], got "
                f"{tuple(values.shape)}")
        if values.dtype != torch.float32:
            values = values.float()
        values = values.contiguous()
    return _SpMM.apply(values, dense.contiguous(), st, reduce)
