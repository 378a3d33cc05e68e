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
On a storage with a hybrid plan (`core/planner.py::HybridPlan`), `spmm`
SUM/MEAN under AUTO or PALLAS_ROW_TILE runs the three tiers instead
(`ops/hybrid.py`, as the JAX package does on the TPU, `ops/spmm.py:77-93,
167-171`): the forward is `spmm_hybrid` and `d_dense` the hybrid
transpose `spmm_hybrid_t`, over the tier values the storage caches;
`d_values` stays the CSR SDDMM. As in JAX (`ops/spmm.py:84-93,
236-247`), a bf16 `dense` runs the forward's tiers in the bf16 compute mode
and a bf16 `g` the transpose's (`ops/hybrid.py`: the cells' bf16 twin on
the bf16-cell kernel); the result keeps dense's dtype. XLA_SEGMENT,
PALLAS_EDGE_TILE and PALLAS_BELL keep the CSR kernel, as does the
multi-head caller of `aggregate`; the semiring caller (`ops/gspmm.py`)
passes tiers for SUM/MEAN on a hybrid storage, as JAX's does.

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
from dgsparse_tpu_torch.ops.hybrid import spmm_hybrid, spmm_hybrid_t
from dgsparse_tpu_torch.ops.types import (Algorithm, ComputeOp, ReduceOp,
                                          as_algorithm, as_reduce)
from dgsparse_tpu_torch.utils import metrics, tune
from dgsparse_tpu_torch.utils.debug import maybe_validate


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


def op_span(op: str, route: str, st: Storage, values, dense: torch.Tensor,
            reduce: ReduceOp, **tags):
    """The forward span of an SpMM-family op (`spmm`, `spmm_multihead`,
    `gspmm`) on `route`, with the tags its work count takes: values
    [nnz] or [nnz, H], slot-space values, or None, and dense [N, F] or
    [N, H, F]."""
    if not metrics.enabled():
        return metrics.NULL_SPAN
    heads, f = (1, dense.shape[1]) if dense.dim() == 2 else dense.shape[1:]
    return metrics.span(
        f"dgsparse.op.{op}.{route}.fwd", m=st.num_rows, n=st.num_cols,
        nnz=st.nnz, f=f, heads=heads, reduce=reduce.value,
        dtype=str(dense.dtype)[6:], has_values=values is not None,
        d_dense=dense.requires_grad,
        d_values=isinstance(values, torch.Tensor) and values.requires_grad,
        **tags)


def _mode(x: torch.Tensor):
    """The hybrid tiers' compute dtype for an operand x (JAX's rule): the
    bf16 compute mode for a bf16 x, else float32."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


class _SpMM(torch.autograd.Function):
    """out [M, H, F]: per head h, the SpMM of the structure with values
    [:, h] (or ones for values None) and dense [N, H, F][:, h]. One
    `csr_spmm` launch serves every head; `spmm` is the case H = 1. With
    `tiers`, the hybrid tier values for these values (H = 1: the
    storage's cached ones, or `gspmm`'s for 1/values), the hybrid tiers
    run instead."""

    @staticmethod
    def forward(ctx, values, dense, st: Storage, reduce: ReduceOp,
                tiers=None):
        ctx.st, ctx.reduce, ctx.tiers = st, reduce, tiers
        ctx.span = metrics.current()
        ctx.save_for_backward(values, dense)
        n, h, f = dense.shape
        if tiers is not None:
            out = spmm_hybrid(st, tiers, dense.reshape(n, f), reduce,
                              _mode(dense))
        else:
            out = csr_spmm(st.rowptr(), st.col(), values,
                           dense.reshape(n, h * f), reduce,
                           coo_row=st.coo_row(), split=st.row_split())
        return out.reshape(st.num_rows, h, f)

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span,
                                   d_values=ctx.needs_input_grad[0],
                                   d_dense=ctx.needs_input_grad[1]):
            return _SpMM._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
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
                                 coo_row=st.coo_row(),
                                 split=st.row_split()).to(values.dtype)
        if ctx.needs_input_grad[1]:
            if ctx.tiers is not None:
                d_dense = spmm_hybrid_t(st, ctx.tiers, g, _mode(g))
            else:
                d_dense = csr_spmm(st.colptr(), st.row(),
                                   transpose_values(values, st), g,
                                   ReduceOp.SUM, coo_row=st.csc_col(),
                                   split=st.col_split())
            d_dense = d_dense.reshape(n, h, f).to(dense.dtype)
        return d_values, d_dense, None, None, None


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
        ctx.span = metrics.current()
        ctx.save_for_backward(values, dense, arg)
        return out.reshape(st.num_rows, h, f)

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span,
                                   d_values=ctx.needs_input_grad[0],
                                   d_dense=ctx.needs_input_grad[1]):
            return _SpMMMaxMin._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
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
                transpose_values(w, st), arg, g, st.rowptr(), st.csc_slot(),
                csc_col=st.csc_col())
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
              compute: ComputeOp = ComputeOp.MUL,
              tiers=None) -> torch.Tensor:
    """The differentiable [M, H, F] SpMM of values [nnz, H] (or None) and
    dense [N, H, F] under any reduction; SUM/MEAN take MUL only, and run
    the hybrid tiers when given `tiers` (see `_SpMM`)."""
    if reduce in (ReduceOp.MAX, ReduceOp.MIN):
        return _SpMMMaxMin.apply(values, dense, st, reduce, compute)
    if compute != ComputeOp.MUL:
        raise ValueError(f"the {reduce.value} SpMM multiplies, got {compute}")
    return _SpMM.apply(values, dense, st, reduce, tiers)


def spmm(sparse: SparseTensor, dense: torch.Tensor, reduce="sum",
         algorithm=Algorithm.AUTO) -> torch.Tensor:
    """SpMM with a selectable reduction. Returns [M, F]; differentiable
    in `dense` and in the sparse values.

    SUM/MEAN run the hybrid tiers on a storage with a hybrid plan under
    AUTO or PALLAS_ROW_TILE, else the CSR kernel; MAX/MIN the CSR max/min
    kernel, whatever the `algorithm`. AUTO first takes the route tuned for
    this structure, width and reduction on this device
    (`utils/tune.py`), where there is one. MAX/MIN keep the earliest
    winning edge of each element (ties included) and send its gradient
    there alone.
    """
    reduce = as_reduce(reduce)
    algorithm = as_algorithm(algorithm)
    maybe_validate(sparse)
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
    if algorithm == Algorithm.AUTO:
        tuned = tune.lookup_key(st._tune_key, dense.shape[1], reduce,
                                device=dense.device)
        if tuned is not None:       # (XLA_SEGMENT is 0, so no `or`)
            algorithm = tuned
    tiers = None
    if st.ell_plan() is not None and reduce in (ReduceOp.SUM, ReduceOp.MEAN) \
            and algorithm in (Algorithm.AUTO, Algorithm.PALLAS_ROW_TILE):
        # bf16 mode's cell passes read the blocks' bf16 twin, made here at
        # the first such call (a bf16 cotangent comes with a bf16 dense)
        tiers = st.tier_values(ones=values is None,
                               compute_dtype=_mode(dense))
    # the route run: the hybrid tiers, or the CSR (sum/mean or max/min)
    # kernel
    metrics.record("spmm", alg=("PALLAS_ROW_TILE" if tiers is not None
                                else "XLA_SEGMENT"),
                   reduce=reduce.value, nnz=st.nnz, feat=dense.shape[1],
                   cached_values=tiers is not None)
    route = ("maxmin" if reduce in (ReduceOp.MAX, ReduceOp.MIN) else
             "hybrid" if tiers is not None else "csr")
    with op_span("spmm", route, st, values, dense, reduce):
        if values is not None:
            values = values.float().unsqueeze(1)
        out = aggregate(values, dense.contiguous().unsqueeze(1), st, reduce,
                        tiers=tiers)
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
