"""Multi-head batched SpMM: per-head edge values over shared structure.

Counterpart of `dgsparse_tpu/ops/spmm_mh.py`: `spmm_multihead(sparse,
values, dense)` with values [nnz, H] and dense [N, H, F] computes, per head
h, out[:, h] = SpMM(A_h, dense[:, h]) where A_h is the shared structure
with values[:, h]. As `spmm_esc_mh` folds the heads into the feature axis
of one `segment_matmul`, one kernel launch serves every head (dense viewed
as [N, H*F], feature j scaled by values[e, j // F]): `csr_spmm` for
SUM/MEAN, `spmm_maxmin` for MAX/MIN, whose per-head winning edges are the
[M, H, F] residual of `_xla_mh_maxmin`.

The autograd Functions are those of `ops/spmm.py`, which `spmm` runs with
one head. SUM/MEAN follow `ops/spmm_mh.py:172-211`: after dividing g by
the degree for MEAN,
  d_values = the multi-head SDDMM of g and dense (`sddmm_csr`, H heads),
  d_dense  = the same multi-head SpMM over the CSC view, values permuted.
MAX/MIN follow `_spmm_mh_maxmin_bwd`: the winner-mask backward, per head.
Slot-order values (`SlotValues`) are not ported yet.
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import aggregate
from dgsparse_tpu_torch.ops.types import Algorithm, as_algorithm, as_reduce


def spmm_multihead(sparse: SparseTensor, values, dense: torch.Tensor,
                   reduce="sum",
                   algorithm: Algorithm = Algorithm.AUTO) -> torch.Tensor:
    """Batched multi-head SpMM.

    Args:
      sparse: structure-only SparseTensor (its own values are ignored).
      values: [nnz, H] per-head edge values (e.g. attention weights), or
        None for copy-u aggregation shared across heads.
      dense: [N, H, F] per-head node features.
      reduce: "sum", "mean", "max" or "min".

    Returns [M, H, F], differentiable in values and dense.
    """
    reduce = as_reduce(reduce)
    as_algorithm(algorithm)
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
    return aggregate(values, dense.contiguous(), st, reduce)
