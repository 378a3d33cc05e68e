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
  MEAN) of the values, Σ(u[c] ± e) = Σ u[c] ± Σ e; copy_u (no values) is
  the unweighted SpMM. Their backward is the SpMM's (`d_dense` over the
  transpose with weights 1, values or 1/values), and for the values the
  SDDMM (MUL, DIV, with autograd's -1/v² for DIV) or the row sum of g
  gathered per edge (ADD, SUB, autograd of the `index_add`).
  On a storage with a hybrid plan, SUM/MEAN run that SpMM on the hybrid
  tiers, as JAX routes a `HybridPlan` to `_hybrid_sum_mean`
  (`ops/gspmm.py:324-328`; the tuner is not consulted): the forward is
  `ops/hybrid.py::spmm_hybrid` and `d_dense` its transpose
  `spmm_hybrid_t`, `d_values` the CSR SDDMM. MUL and copy_u take the
  storage's cached tiers for its values or for ones (JAX's `st.vslot()`),
  ADD/SUB the ones' cached tiers (JAX's `ones_vslot`), and DIV tiers
  gathered for 1/values on every call (JAX's `vslot=None`). A bf16 dense
  runs the tiers in the bf16 compute mode, as `spmm` does
  (`ops/spmm.py:84-93`); the result keeps dense's dtype. Without a plan
  every SUM/MEAN op runs the CSR kernel.
Slot-space values (`values=SlotValues`, `ops/slot.py`) cover the same
grid as `dgsparse_tpu/ops/gspmm.py:284-316`: MUL runs `spmm_slots`, DIV
runs it on `_sv_reciprocal`, ADD/SUB run it on `_sv_ones` plus or minus
`sv_rowsum` (divided by the degree for MEAN), and MAX/MIN pay the one
edge-order boundary (`slots_to_edges`) and take the edge-order op.
"""

from typing import Optional

import torch

from dgsparse_tpu_torch.core import planner
from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.ops.spmm import _mode, aggregate, op_span
from dgsparse_tpu_torch.ops.types import (ComputeOp, ReduceOp, as_compute,
                                          as_reduce)
from dgsparse_tpu_torch.utils import metrics
from dgsparse_tpu_torch.utils.debug import maybe_validate


def gspmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
          compute="mul", values=None) -> torch.Tensor:
    """Semiring SpMM over a SparseTensor, [M, F], differentiable in dense
    and in the sparse values. compute is ignored (copy_u) when the tensor
    has no values. `values`, slot-space `SlotValues`, overrides the
    tensor's own values (then compute always applies)."""
    reduce, compute = as_reduce(reduce), as_compute(compute)
    if values is not None:
        with op_span("gspmm", "slots", sparse.storage, values, dense, reduce,
                     compute=compute.value):
            return _gspmm_slots(sparse, dense, reduce, compute, values)
    maybe_validate(sparse)
    metrics.record("gspmm", reduce=reduce.value, compute=compute.value,
                   nnz=sparse.nnz, feat=dense.shape[-1])
    if dense.dim() != 2 or dense.shape[0] != sparse.sparse_sizes()[1]:
        raise ValueError(
            f"dense must be [{sparse.sparse_sizes()[1]}, F], got "
            f"{tuple(dense.shape)}")
    st = sparse.storage
    vals = st.values() if sparse.has_value else None
    if vals is not None:
        vals = vals.float()
    x = dense.contiguous().unsqueeze(1)
    if reduce in (ReduceOp.MAX, ReduceOp.MIN):
        w = None if vals is None else vals.unsqueeze(1)
        with op_span("gspmm", "maxmin", st, vals, dense, reduce,
                     compute=compute.value):
            return aggregate(w, x, st, reduce, compute).squeeze(1)
    # SUM / MEAN: one weighted SpMM (values, 1/values, or none), plus or
    # minus the values' row sum for ADD / SUB
    if vals is None or compute == ComputeOp.MUL:
        w = vals
    elif compute == ComputeOp.DIV:
        w = 1.0 / vals
    else:
        w = None
    tiers = _hybrid_tiers(st, dense, reduce, w,
                          cached=vals is None or compute != ComputeOp.DIV)
    with op_span("gspmm", "csr" if tiers is None else "hybrid", st, vals,
                 dense, reduce, compute=compute.value):
        out = aggregate(None if w is None else w.unsqueeze(1), x, st, reduce,
                        tiers=tiers).squeeze(1)
        if vals is None or compute in (ComputeOp.MUL, ComputeOp.DIV):
            return out
        e_row = torch.zeros(st.num_rows, dtype=vals.dtype,
                            device=vals.device).index_add(
                                0, st.coo_row().long(), vals)
        if reduce == ReduceOp.MEAN:
            deg = st.rowptr()[1:] - st.rowptr()[:-1]
            e_row = e_row / torch.clamp(deg, min=1).to(e_row.dtype)
        e_row = e_row.to(out.dtype)[:, None]
        return out + e_row if compute == ComputeOp.ADD else out - e_row


def _hybrid_tiers(st: Storage, dense: torch.Tensor, reduce: ReduceOp, w,
                  cached: bool):
    """The hybrid tier values of the SpMM weighted by w (None: ones) in
    dense's compute mode, or None without a hybrid plan: the storage's
    cached tiers for its values or for ones where `cached`, else tiers
    gathered for w on this call. Records the route as `spmm` does."""
    hp = st.ell_plan()
    if hp is None:
        return None
    mode = _mode(dense)
    if cached:
        tiers = st.tier_values(ones=w is None, compute_dtype=mode)
    else:
        tiers = planner.tier_values(hp, w, st.device)
        if mode == torch.bfloat16:
            planner.with_bf16_cells(tiers)
    metrics.record("spmm", alg="PALLAS_ROW_TILE", reduce=reduce.value,
                   nnz=st.nnz, feat=dense.shape[1], cached_values=cached)
    return tiers


def _gspmm_slots(sparse: SparseTensor, dense: torch.Tensor,
                 reduce: ReduceOp, compute: ComputeOp, sv) -> torch.Tensor:
    """The semiring grid on slot-space values `sv` (see the module
    docstring)."""
    from dgsparse_tpu_torch.ops.slot import (SlotValues, _sv_ones,
                                             _sv_reciprocal, slots_to_edges,
                                             spmm_slots, sv_rowsum)

    if not isinstance(sv, SlotValues):
        raise TypeError(f"values must be SlotValues, got {type(sv)}")
    if reduce in (ReduceOp.MAX, ReduceOp.MIN):
        return gspmm(sparse.set_values(slots_to_edges(sparse, sv)), dense,
                     reduce, compute)
    if compute == ComputeOp.MUL:
        return spmm_slots(sparse, sv, dense, reduce)
    if compute == ComputeOp.DIV:
        return spmm_slots(sparse, _sv_reciprocal(sparse, sv), dense, reduce)
    base = spmm_slots(sparse, _sv_ones(sparse, sv), dense, reduce)
    e_row = sv_rowsum(sparse, sv)
    if reduce == ReduceOp.MEAN:
        rowptr = sparse.storage.rowptr()
        e_row = e_row / torch.clamp(rowptr[1:] - rowptr[:-1], min=1).to(
            e_row.dtype)
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
        if reduce in (ReduceOp.SUM, ReduceOp.MEAN):
            # the ones' hybrid tiers, kept by the caller's storage, which
            # the copy without values shares; built on the copy, they
            # would be rebuilt on every call
            sparse.storage.tier_values(ones=True)
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
