"""Fused GAT attention in slot space: scores, softmax and the weighted SpMM
with no CSR-edge-order array in between.

Counterpart of `dgsparse_tpu/ops/attention.py`. `gat_attention(sp,
s_row, s_col, x)` computes

    out[r] = sum over r's edges (r, c) of
             softmax_r(LeakyReLU(s_row[r] + s_col[c])) * x[c]

GAT logits are rank-1 over (row, col), so each tier of a hybrid plan
(`core/planner.py::HybridPlan`) builds its own weights from the two score
vectors: a whole [R, C] cell block is an outer sum of two 128-vectors, a
BELL slot or residue edge takes one gather from each.

On a hybrid storage one `torch.autograd.Function` runs it:
- forward: the shift is the per-row upper bound LeakyReLU(s_row[r] +
  max(s_col)), taken without a gradient (softmax is exactly
  shift-invariant, and LeakyReLU's monotonicity puts every logit of row r
  below it, so no exp overflows); the tier weights exp(LeakyReLU(z) -
  shift[r]) (times the multiplicity on the cells, 0 on BELL padding) go
  to `spmm_hybrid` on [x, 1], whose last column is the denominator,
  clamped at 1e-30;
- backward: the weights are recomputed, not kept (at Reddit scale the
  cells' block alone is 415 MB a head); with u = g / denom and rho =
  rowdot(g, out) / denom, d_x is the hybrid transpose of u with those
  weights; dz = w * (dsig - rho[row]) * LeakyReLU'(z) per tier, dsig
  being `sddmm_cells` of (u, x) on the cells and `sddmm_csr` over the
  non-cell sub-CSR `hp.nd` elsewhere; d_s_row is the row sums of dz (the
  hybrid SpMM against a ones column) and d_s_col its column sums (the
  transpose). Everything that is not s_row, s_col or x gets None.
The hybrid route builds no [nnz]-sized tensor in CSR edge order, forward
or backward: every per-edge array it makes belongs to one tier (cells
[ncells, R, C], BELL [T * E], residue [res nnz], the non-cell dots and
the CSC gather [nd nnz]).

`compute_dtype` (JAX's argument, `ops/attention.py:266-299`): float32 by
default; bfloat16 runs the forward's `spmm_hybrid` and the backward's d_x
transpose in the bf16 compute mode (`ops/hybrid.py`): the forward
aggregates a bf16 [x, 1], so the denominator column sums bf16-rounded
weights as in JAX, and its cell weights are written as bf16 for the call;
d_x's transpose takes a bf16 u. d_s_row, d_s_col and the `sddmm_cells`
of (u, x) stay float32, as in JAX.

The shift is loose by at most range(s_col): a row whose true maximum
logit lies more than ~87 below its bound underflows to a zero
denominator and gives 0 (the JAX package's documented caveat).
`_edge_space_attention`, which every other storage runs, has the exact
per-row max.
"""

import torch
from torch.nn import functional as F

from dgsparse_tpu_torch.core.formats import SparseTensor, Storage
from dgsparse_tpu_torch.core.transform import gather_rows
from dgsparse_tpu_torch.kernels.spmm_cells import check_compute_dtype
from dgsparse_tpu_torch.ops import slot as S
from dgsparse_tpu_torch.ops.hybrid import spmm_hybrid, spmm_hybrid_t
from dgsparse_tpu_torch.utils import metrics


def _weights(st: Storage, s_row, s_col, shift, slope):
    """Per tier (cells, bell, res): the weights exp(LeakyReLU(z) -
    shift[row]) (cells times the multiplicity, BELL padding 0) and where
    z > 0, all float32. The cells' padded rows take s_row = -inf (weight
    exactly 0) and their padded columns max(s_col) (z within the row's
    bound): no padding overflows, so none meets its 0 multiplicity as
    inf."""
    hp = st.ell_plan()
    w_c = pos_c = w_b = pos_b = None
    if hp.cells is not None:
        z = S.cell_rows(hp, s_row, pad=float("-inf"))[:, :, None] + \
            S.cell_cols(hp, s_col, pad=s_col.max())[:, None, :]
        pos_c = z > 0
        w_c = F.leaky_relu_(z, slope)
        w_c.sub_(S.cell_rows(hp, shift)[:, :, None]).exp_().mul_(
            S.cell_mult(st))
    if hp.bell is not None:
        rows = st.slot_map("bell_rows")
        z = s_row.index_select(0, rows) + \
            s_col.index_select(0, st.slot_map("bell_cols"))
        pos_b = z > 0
        w_b = torch.exp(F.leaky_relu(z, slope) - shift.index_select(0, rows))
        w_b = torch.where(st.slot_map("bell_valid"), w_b, 0.0)
    rows = st.slot_map("res_rows")
    z = s_row.index_select(0, rows) + s_col.index_select(0, hp.res.col)
    pos_r = z > 0
    w_r = torch.exp(F.leaky_relu(z, slope) - shift.index_select(0, rows))
    return (w_c, w_b, w_r), (pos_c, pos_b, pos_r)


class _HybridAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, s_row, s_col, x, st: Storage, slope: float,
                compute_dtype):
        sr, sc = s_row.float(), s_col.float()
        # the per-row upper bound of the logits, outside autograd
        shift = F.leaky_relu(sr + sc.max(), slope)
        (w_c, w_b, w_r), _ = _weights(st, sr, sc, shift, slope)
        f = x.shape[1]
        xd = torch.cat([x.float(), x.new_ones(x.shape[0], 1,
                                              dtype=torch.float32)], 1)
        if compute_dtype == torch.bfloat16:
            # the cells' weights as the bf16 pass reads them, half the
            # bytes, and the fp32 ones freed before the SpMM
            tiers = S.forward_tiers(None, w_b, w_r)
            tiers["cells_bf16"] = None if w_c is None else w_c.to(
                torch.bfloat16)
        else:
            tiers = S.forward_tiers(w_c, w_b, w_r)
        del w_c, w_b, w_r
        nd = spmm_hybrid(st, tiers, xd, compute_dtype=compute_dtype)
        del tiers
        denom = torch.clamp(nd[:, f], min=S._TINY)
        out = nd[:, :f] / denom[:, None]
        ctx.st, ctx.slope, ctx.compute_dtype = st, slope, compute_dtype
        ctx.span = metrics.current()
        ctx.save_for_backward(s_row, s_col, x, shift, denom, out)
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        with metrics.backward_span(ctx.span, d_s_row=ctx.needs_input_grad[0],
                                   d_s_col=ctx.needs_input_grad[1],
                                   d_x=ctx.needs_input_grad[2]):
            return _HybridAttention._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        s_row, s_col, x, shift, denom, out = ctx.saved_tensors
        st, slope = ctx.st, ctx.slope
        hp = st.ell_plan()
        g32 = g.float()
        u = (g32 / denom[:, None]).contiguous()
        rho = (g32 * out).sum(1) / denom                      # [M]
        x32 = x.float().contiguous()
        (w_c, w_b, w_r), (pos_c, pos_b, pos_r) = _weights(
            st, s_row.float(), s_col.float(), shift, slope)
        d_x = d_s_row = d_s_col = None
        if ctx.needs_input_grad[2]:
            d_x = spmm_hybrid_t(st, S.transpose_tiers(st, w_c, w_b, w_r),
                                u, ctx.compute_dtype).to(x.dtype)
        if not (ctx.needs_input_grad[0] or ctx.needs_input_grad[1]):
            return None, None, d_x, None, None, None

        def dleaky(pos):
            return torch.where(pos, 1.0, slope)

        # dz = w * (dsig - rho[row]) * LeakyReLU'(z), dsig = dot(u[r], x[c])
        ds_c, ds_b, ds_r = S.slot_dots(st, u, x32)
        dz_c = dz_b = None
        if w_c is not None:
            ds_c.sub_(S.cell_rows(hp, rho)[:, :, None]).mul_(w_c)
            dz_c = ds_c.mul_(dleaky(pos_c))
            del w_c, pos_c
        if w_b is not None:
            rho_b = rho.index_select(0, st.slot_map("bell_rows"))
            dz_b = w_b * (ds_b - rho_b) * dleaky(pos_b)
        rho_r = rho.index_select(0, st.slot_map("res_rows"))
        dz_r = w_r * (ds_r - rho_r) * dleaky(pos_r)
        if ctx.needs_input_grad[0]:
            ones_n = torch.ones(st.num_cols, 1, device=g.device)
            d_s_row = spmm_hybrid(st, S.forward_tiers(dz_c, dz_b, dz_r),
                                  ones_n)[:, 0].to(s_row.dtype)
        if ctx.needs_input_grad[1]:
            ones_m = torch.ones(st.num_rows, 1, device=g.device)
            d_s_col = spmm_hybrid_t(st, S.transpose_tiers(st, dz_c, dz_b,
                                                          dz_r),
                                    ones_m)[:, 0].to(s_col.dtype)
        return d_s_row, d_s_col, d_x, None, None, None


def gat_attention(sparse: SparseTensor, s_row: torch.Tensor,
                  s_col: torch.Tensor, x: torch.Tensor,
                  negative_slope: float = 0.2,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Softmax attention aggregation over the edges of `sparse`: out[r] =
    sum_c alpha_rc x[c], alpha = softmax over r's edges of LeakyReLU(
    s_row[r] + s_col[c]). s_row [M], s_col [N], x [N, F]; returns [M, F]
    in x's dtype, differentiable in s_row, s_col and x. Structure only:
    the tensor's values are ignored, and duplicate edges each attend.

    A storage with a hybrid plan runs the fused slot-space route (no CSR
    edge-order intermediate), its SpMMs in `compute_dtype` (float32 or
    bfloat16, the bf16 compute mode; see the module docstring); any other
    storage `_edge_space_attention`, which, as JAX's, ignores it."""
    check_compute_dtype(compute_dtype)
    m, n = sparse.sparse_sizes()
    if s_row.shape != (m,) or s_col.shape != (n,) or x.dim() != 2 \
            or x.shape[0] != n:
        raise ValueError(
            f"s_row {tuple(s_row.shape)}, s_col {tuple(s_col.shape)} and x "
            f"{tuple(x.shape)} must be [{m}], [{n}] and [{n}, F]")
    st = sparse.storage
    fused = st.ell_plan() is not None
    metrics.record("gat_attention", route="fused" if fused else "edge",
                   nnz=st.nnz, feat=x.shape[1])
    with _span("fused" if fused else "edge", st, x, compute_dtype):
        if fused:
            return _HybridAttention.apply(
                s_row.contiguous(), s_col.contiguous(), x.contiguous(), st,
                float(negative_slope), compute_dtype)
        return _edge_space_attention(sparse, s_row, s_col, x, negative_slope)


def _span(route: str, st: Storage, x: torch.Tensor, compute_dtype):
    """The forward span of `gat_attention` on `route`."""
    if not metrics.enabled():
        return metrics.NULL_SPAN
    return metrics.span(
        f"dgsparse.op.gat_attention.{route}.fwd", m=st.num_rows,
        n=st.num_cols, nnz=st.nnz, f=x.shape[1], dtype=str(x.dtype)[6:],
        compute_dtype=str(compute_dtype)[6:])


def _edge_space_attention(sparse: SparseTensor, s_row, s_col, x,
                          negative_slope):
    """The edge-space pipeline, differentiated by autograd (any storage):
    per-edge logits in CSR edge order, `edge_softmax`, then `spmm` with
    the weights as values."""
    from dgsparse_tpu_torch.ops.edge_softmax import edge_softmax
    from dgsparse_tpu_torch.ops.spmm import spmm

    st = sparse.storage
    z = gather_rows(s_row, st.coo_row()) + gather_rows(s_col, st.col())
    alpha = edge_softmax(sparse, F.leaky_relu(z, negative_slope))
    return spmm(sparse.set_values(alpha.float()), x, "sum")
