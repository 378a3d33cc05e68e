"""Generalized semiring SpMM: reduce_{e=(m,c)} compute(edge[e], feat[c]).

Counterpart of `dgsparse_tpu/ops/gspmm.py` (reference: the gspmm-fp
extension, src/gspmm-fp/gspmm.cc:27-44, and the DGL-style
`u_<compute>_e_<reduce>` / `copy_u_<reduce>` grid of
example/gspmm-fp/util.py:17-110). compute(a=edge, b=feat) with SUB = b - a
and DIV = b / a (include/gspmm.h:67-91).

No kernel of its own: every op rides the two SpMM autograd Functions of
`ops/spmm.py`, so every gradient is theirs.
- MAX/MIN: the max/min kernel takes compute as a template parameter and
  keeps the winning edge; the gradient flows through it alone.
- SUM/MEAN decompose as `_hybrid_sum_mean` (`ops/gspmm.py:220-261`) does:
  MUL is the values-weighted SpMM, DIV the SpMM weighted by 1/values, and
  ADD/SUB the unweighted SpMM plus or minus the row sum (row mean for
  MEAN) of the values, Σ(u[c] ± e) = Σ u[c] ± Σ e. Their backward is the
  CSR kernel over the CSC view with weights 1, values or 1/values
  (`ops/gspmm.py:133-143`), and for the values the SDDMM (MUL, DIV, with
  autograd's -1/v² for DIV) or the row sum of g gathered per edge (ADD,
  SUB, autograd of the `index_add`).
"""

from typing import Optional

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import aggregate
from dgsparse_tpu_torch.ops.types import (ComputeOp, ReduceOp, as_compute,
                                          as_reduce)


def gspmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
          compute="mul", values=None) -> torch.Tensor:
    """Semiring SpMM over a SparseTensor, [M, F], differentiable in dense
    and in the sparse values. compute is ignored (copy_u) when the tensor
    has no values. `values` (slot-order `SlotValues` in the JAX package)
    is not ported and must be None."""
    reduce, compute = as_reduce(reduce), as_compute(compute)
    if values is not None:
        raise NotImplementedError(
            "slot-order values (SlotValues) are not ported yet "
            "(ROADMAP.md, queue A #10)")
    if dense.dim() != 2 or dense.shape[0] != sparse.sparse_sizes()[1]:
        raise ValueError(
            f"dense must be [{sparse.sparse_sizes()[1]}, F], got "
            f"{tuple(dense.shape)}")
    st = sparse.storage
    vals = st.values() if sparse.has_value else None
    if vals is not None:
        vals = vals.float()
    x = dense.contiguous().unsqueeze(1)
    if reduce in (ReduceOp.MAX, ReduceOp.MIN) or vals is None \
            or compute == ComputeOp.MUL:
        w = None if vals is None else vals.unsqueeze(1)
        return aggregate(w, x, st, reduce, compute).squeeze(1)
    if compute == ComputeOp.DIV:
        return aggregate((1.0 / vals).unsqueeze(1), x, st,
                         reduce).squeeze(1)
    base = aggregate(None, x, st, reduce).squeeze(1)
    e_row = torch.zeros(st.num_rows, dtype=vals.dtype,
                        device=vals.device).index_add(
                            0, st.coo_row().long(), vals)
    if reduce == ReduceOp.MEAN:
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        e_row = e_row / torch.clamp(deg, min=1).to(e_row.dtype)
    e_row = e_row.to(base.dtype)[:, None]
    return base + e_row if compute == ComputeOp.ADD else base - e_row


def _sparse(rowptr, colind, values: Optional[torch.Tensor],
            dense: torch.Tensor) -> SparseTensor:
    return SparseTensor.from_csr(
        rowptr, colind, values,
        sparse_sizes=(int(rowptr.shape[0]) - 1, int(dense.shape[0])),
        device=dense.device)


def GSpMM_u_e(rowptr, colind, values, dense, reduce_op, compute_op):
    """Reference-parity entry (src/gspmm-fp/gspmm.cc:27-35): raw CSR arrays,
    edge values combined with node features then reduced."""
    return gspmm(_sparse(rowptr, colind, values, dense), dense, reduce_op,
                 compute_op)


def GSpMM_u(rowptr, colind, dense, reduce_op):
    """Reference-parity entry (src/gspmm-fp/gspmm.cc:36-43): copy_u +
    reduce."""
    return gspmm(_sparse(rowptr, colind, None, dense), dense, reduce_op,
                 ComputeOp.MUL)


def _make_u_e(compute: ComputeOp, reduce: ReduceOp):
    def op(sparse: SparseTensor, dense: torch.Tensor) -> torch.Tensor:
        return gspmm(sparse, dense, reduce, compute)

    op.__name__ = f"u_{compute.value}_e_{reduce.value}"
    op.__doc__ = (
        f"DGL-style op: reduce '{reduce.value}' of "
        f"compute('{compute.value}', edge, feat) over in-edges "
        f"(reference: example/gspmm-fp/util.py:17-110).")
    return op


def _make_copy_u(reduce: ReduceOp):
    def op(sparse: SparseTensor, dense: torch.Tensor) -> torch.Tensor:
        return gspmm(sparse.set_values(None), dense, reduce, ComputeOp.MUL)

    op.__name__ = f"copy_u_{reduce.value}"
    op.__doc__ = f"DGL-style op: reduce '{reduce.value}' of neighbor features."
    return op


# The full u_*_e_* grid (reference: example/gspmm-fp/util.py:17-110).
_ops = {}
for _c in ComputeOp:
    for _r in ReduceOp:
        _f = _make_u_e(_c, _r)
        _ops[_f.__name__] = _f
for _r in ReduceOp:
    _f = _make_copy_u(_r)
    _ops[_f.__name__] = _f
globals().update(_ops)
__all__ = ["gspmm", "GSpMM_u_e", "GSpMM_u"] + sorted(_ops)
