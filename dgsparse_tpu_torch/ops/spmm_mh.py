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
A list of slot-space values (`SlotValues`, one per head) runs one
`spmm_slots` per head and stacks them (`ops/spmm_mh.py:234-247`).
"""

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import aggregate, op_span
from dgsparse_tpu_torch.ops.types import (Algorithm, ReduceOp, as_algorithm,
                                          as_reduce)
from dgsparse_tpu_torch.utils import metrics


def spmm_multihead(sparse: SparseTensor, values, dense: torch.Tensor,
                   reduce="sum",
                   algorithm: Algorithm = Algorithm.AUTO) -> torch.Tensor:
    """Batched multi-head SpMM.

    Args:
      sparse: structure-only SparseTensor (its own values are ignored).
      values: [nnz, H] per-head edge values (e.g. attention weights), a
        list of H `SlotValues`, or None for copy-u aggregation shared
        across heads.
      dense: [N, H, F] per-head node features.
      reduce: "sum", "mean", "max" or "min".

    Returns [M, H, F], differentiable in values and dense.
    """
    reduce = as_reduce(reduce)
    as_algorithm(algorithm)
    if isinstance(values, (list, tuple)):
        from dgsparse_tpu_torch.ops.slot import SlotValues, spmm_slots

        if not values or not all(isinstance(v, SlotValues) for v in values):
            raise TypeError("a list of values must hold one SlotValues a "
                            "head")
        if dense.dim() != 3 or dense.shape[1] != len(values):
            raise ValueError(f"dense must be [N, H={len(values)}, F], got "
                             f"{tuple(dense.shape)}")
        metrics.record("spmm_multihead", route="slots", reduce=reduce.value,
                       nnz=sparse.nnz, heads=dense.shape[1],
                       feat=dense.shape[2])
        with op_span("spmm_multihead", "slots", sparse.storage, None, dense,
                     reduce):
            return torch.stack([spmm_slots(sparse, sv, dense[:, h], reduce)
                                for h, sv in enumerate(values)], dim=1)
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
    route = "maxmin" if reduce in (ReduceOp.MAX, ReduceOp.MIN) else "csr"
    metrics.record("spmm_multihead", route=route, reduce=reduce.value,
                   nnz=st.nnz, heads=dense.shape[1], feat=dense.shape[2])
    with op_span("spmm_multihead", route, st, values, dense, reduce):
        return aggregate(values, dense.contiguous(), st, reduce)
