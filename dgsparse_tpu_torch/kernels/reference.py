"""Plain PyTorch SpMM (SUM/MEAN/MAX/MIN, single- and multi-head), the
semiring SpMM, the MAX/MIN masked backward and SDDMM: the CPU path and the
port's oracle.

Counterpart of `dgsparse_tpu/kernels/xla.py`, of `_xla_mh` and
`_xla_mh_maxmin` in `dgsparse_tpu/ops/spmm_mh.py` and of the edge-space
MAX/MIN backward of `dgsparse_tpu/ops/spmm.py`, with the same semantics
(reference CUDA kernels):
- empty rows produce 0,
- MEAN divides by max(row degree, 1),
- MAX/MIN keep the earliest winning edge of each output element (the
  reference updates on strict improvement only); the winner is an edge
  id in CSR order, nnz for an empty row, and a non-finite extremum gives
  0,
- missing values mean implicit 1.0,
- the semiring combine is compute(edge, feat), SUB = feat - edge and
  DIV = feat / edge.

Sums and extrema are taken in float32 whatever the input dtype (as the JAX
package's chunked path and the CUDA kernels do) and cast to the input
dtype at the end. On a CUDA tensor `index_add_` uses atomics, so its
summation order, and the last bits of its result, vary from run to run.
"""

from typing import Optional, Tuple

import torch

from dgsparse_tpu_torch.ops.types import ComputeOp, ReduceOp

# Largest [chunk, F] float32 contribution buffer the forward materializes
# at once (the JAX package's _SPMM_CHUNK_BUDGET), and the same for the
# SDDMM's gathered buffers (_SDDMM_CHUNK_BUDGET).
_SPMM_CHUNK_BUDGET = 512 << 20
_SDDMM_CHUNK_BUDGET = 512 << 20


def spmm_chunk_edges(f: int) -> int:
    """Edges per chunk for the [nnz, F] float32 contribution buffer."""
    return max(_SPMM_CHUNK_BUDGET // (4 * max(f, 1)), 1)


def combine(compute: ComputeOp, edge_vals: torch.Tensor,
            feats: torch.Tensor) -> torch.Tensor:
    """Semiring combine; edge_vals is [nnz] (broadcast against [nnz, F]),
    or already shaped to broadcast (same ndim as feats)."""
    e = edge_vals if edge_vals.dim() == feats.dim() else edge_vals[:, None]
    if compute == ComputeOp.ADD:
        return feats + e
    if compute == ComputeOp.SUB:
        return feats - e
    if compute == ComputeOp.MUL:
        return feats * e
    if compute == ComputeOp.DIV:
        return feats / e
    raise ValueError(compute)


def _check_sum_mean(reduce: ReduceOp) -> None:
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError(f"expected SUM or MEAN, got {reduce}")


def _is_maxmin(reduce: ReduceOp) -> bool:
    return reduce in (ReduceOp.MAX, ReduceOp.MIN)


def _mean_divide(out: torch.Tensor, degrees: torch.Tensor) -> torch.Tensor:
    return out / torch.clamp(degrees, min=1).to(out.dtype)[:, None]


def segment_reduce(
    contrib: torch.Tensor,
    seg_ids: torch.Tensor,
    num_segments: int,
    reduce: ReduceOp,
    degrees: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Reduce per-edge contributions [nnz, F] into [num_segments, F].

    Returns (out, arg): for MAX/MIN arg is the int32 earliest winning edge
    per output element (nnz for an empty segment), else None. Empty
    segments yield 0.
    """
    if _is_maxmin(reduce):
        out, arg = _extreme_chunk(contrib.float(), seg_ids, num_segments,
                                  reduce == ReduceOp.MAX, 0,
                                  contrib.shape[0])
        return _finite_or_zero(out).to(contrib.dtype), arg
    out = torch.zeros((num_segments, contrib.shape[-1]), dtype=torch.float32,
                      device=contrib.device)
    out.index_add_(0, seg_ids.long(), contrib.float())
    if reduce == ReduceOp.MEAN:
        if degrees is None:
            degrees = torch.bincount(seg_ids.long(), minlength=num_segments)
        out = _mean_divide(out, degrees)
    return out.to(contrib.dtype), None


def spmm_forward(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    values: Optional[torch.Tensor],
    dense: torch.Tensor,
    num_rows: int,
    reduce: ReduceOp,
    degrees: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """CSR SpMM: out[m] = reduce_{e=(m,c)} values[e] * dense[c].

    The edge axis is chunked (`spmm_chunk_edges`) so the [nnz, F]
    contribution buffer never exceeds 512 MiB; chunk partials add (MAX/MIN:
    `maxmin_forward`). Returns (out, arg) as `segment_reduce` does.
    """
    if _is_maxmin(reduce):
        return maxmin_forward(coo_row, col, values, dense, num_rows, reduce)
    nnz = col.shape[0]
    f = dense.shape[-1]
    per = spmm_chunk_edges(f)
    out = torch.zeros((num_rows, f), dtype=torch.float32, device=dense.device)
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        contrib = dense[col[e0:e1].long()].float()
        if values is not None:
            contrib = contrib * values[e0:e1, None].float()
        out.index_add_(0, coo_row[e0:e1].long(), contrib)
    if reduce == ReduceOp.MEAN:
        if degrees is None:
            degrees = torch.bincount(coo_row.long(), minlength=num_rows)
        out = _mean_divide(out, degrees)
    return out.to(dense.dtype), None


def _extreme_chunk(contrib: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, is_max: bool, e0: int, nnz: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per segment the extremum of float32 contributions [E, F] (±inf for
    an empty segment) and the smallest id, counting from e0, of the edges
    that attain it (nnz for an empty segment)."""
    f = contrib.shape[1]
    idx = seg_ids.long()[:, None].expand(-1, f)
    ident = float("-inf") if is_max else float("inf")
    out = torch.full((num_segments, f), ident, dtype=contrib.dtype,
                     device=contrib.device)
    out.scatter_reduce_(0, idx, contrib, "amax" if is_max else "amin")
    eids = torch.arange(e0, e0 + contrib.shape[0], dtype=torch.int32,
                        device=contrib.device)[:, None]
    cand = torch.where(contrib == out.index_select(0, seg_ids.long()), eids,
                       nnz).to(torch.int32)
    arg = torch.full((num_segments, f), nnz, dtype=torch.int32,
                     device=contrib.device)
    arg.scatter_reduce_(0, idx, cand, "amin")
    return out, arg


def _finite_or_zero(out: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def maxmin_forward(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    values: Optional[torch.Tensor],
    dense: torch.Tensor,
    num_rows: int,
    reduce: ReduceOp,
    compute: ComputeOp = ComputeOp.MUL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAX/MIN semiring SpMM: out[m, j] = max/min over e in row m of
    compute(values[e, j // (F / H)], dense[col[e], j]), and arg [M, F], the
    earliest winning edge id (nnz for an empty row). values None is copy_u;
    values [nnz] or [nnz, H] (H heads dividing the width F).

    Edge-chunked as `spmm_forward`; chunk extrema merge as in
    `kernels/xla.py:106-141`: a strict improvement takes the chunk's
    winner, an exact tie keeps the smaller edge id.
    """
    is_max = reduce == ReduceOp.MAX
    nnz, hf = col.shape[0], dense.shape[-1]
    heads = 1 if values is None or values.dim() == 1 else values.shape[1]
    per = spmm_chunk_edges(hf)
    out = torch.full((num_rows, hf), float("-inf") if is_max
                     else float("inf"), device=dense.device)
    arg = torch.full((num_rows, hf), nnz, dtype=torch.int32,
                     device=dense.device)
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        contrib = dense[col[e0:e1].long()].float()
        if values is not None:
            v = values[e0:e1].float().reshape(e1 - e0, heads, 1)
            contrib = combine(compute, v, contrib.view(
                e1 - e0, heads, hf // heads)).reshape(e1 - e0, hf)
        part, argc = _extreme_chunk(contrib, coo_row[e0:e1], num_rows,
                                    is_max, e0, nnz)
        better = part > out if is_max else part < out
        arg = torch.where(better, argc, torch.where(
            part == out, torch.minimum(arg, argc), arg))
        out = torch.maximum(out, part) if is_max else torch.minimum(out,
                                                                    part)
    return _finite_or_zero(out).to(dense.dtype), arg


def gspmm_forward(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    values: Optional[torch.Tensor],
    dense: torch.Tensor,
    num_rows: int,
    reduce: ReduceOp,
    compute: ComputeOp,
    degrees: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Semiring SpMM (reference: src/gspmm-fp/gspmm.cu): out[m] =
    reduce_{e=(m,c)} compute(values[e], dense[c]); values None is copy_u.
    Returns (out, arg) as `segment_reduce` does."""
    if _is_maxmin(reduce):
        return maxmin_forward(coo_row, col, values, dense, num_rows, reduce,
                              compute)
    gathered = dense[col.long()].float()
    if values is not None:
        gathered = combine(compute, values.float(), gathered)
    out, _ = segment_reduce(gathered, coo_row, num_rows, reduce, degrees)
    return out.to(dense.dtype), None


def maxmin_d_dense(
    csc_col: torch.Tensor,
    row_csc: torch.Tensor,
    perm: torch.Tensor,
    weights_csc: Optional[torch.Tensor],
    arg: torch.Tensor,
    g: torch.Tensor,
    num_cols: int,
) -> torch.Tensor:
    """d_dense of a MAX/MIN SpMM over the CSC view: d[c, j] = sum over the
    edges k of column c (row_csc[k], CSR edge id perm[k]) of
    [arg[row_k, j] == perm[k]] * g[row_k, j] * weights_csc[k, j // (F/H)]
    (weights None: 1). Edge-chunked; sums and returns float32 [N, F]."""
    nnz, hf = row_csc.shape[0], g.shape[1]
    heads = (1 if weights_csc is None or weights_csc.dim() == 1
             else weights_csc.shape[1])
    per = spmm_chunk_edges(hf)
    out = torch.zeros((num_cols, hf), dtype=torch.float32, device=g.device)
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        r = row_csc[e0:e1].long()
        win = arg[r] == perm[e0:e1, None]
        contrib = torch.where(win, g[r].float(), 0.0)
        if weights_csc is not None:
            w = weights_csc[e0:e1].float().reshape(e1 - e0, heads, 1)
            contrib = (contrib.view(e1 - e0, heads, hf // heads)
                       * w).reshape(e1 - e0, hf)
        out.index_add_(0, csc_col[e0:e1].long(), contrib)
    return out


def maxmin_d_values(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    arg: torch.Tensor,
    g: torch.Tensor,
    dense: Optional[torch.Tensor],
    heads: int,
) -> torch.Tensor:
    """Per edge e and head h the sum over the features j of head h of
    [arg[row_e, j] == e] * g[row_e, j], times dense[col_e, j] when `dense`
    is given ("dot") else 1 ("sum"). Edge-chunked; float32 [nnz, H]."""
    nnz, hf = col.shape[0], g.shape[1]
    per = spmm_chunk_edges(hf)
    parts = []
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        r = coo_row[e0:e1].long()
        eids = torch.arange(e0, e1, dtype=arg.dtype, device=arg.device)
        masked = torch.where(arg[r] == eids[:, None], g[r].float(), 0.0)
        if dense is not None:
            masked = masked * dense[col[e0:e1].long()].float()
        parts.append(masked.view(e1 - e0, heads, hf // heads).sum(-1))
    if not parts:
        return torch.zeros((0, heads), dtype=torch.float32, device=g.device)
    return torch.cat(parts)


def spmm_mh(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    values: torch.Tensor,
    dense: torch.Tensor,
    num_rows: int,
    reduce: ReduceOp,
    degrees: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-head SpMM: out[m, h] = reduce_{e=(m,c)} values[e, h] * dense[c, h]
    for dense [N, H, F] and values [nnz, H]. Returns [num_rows, H, F];
    edge-chunked as `spmm_forward`."""
    _check_sum_mean(reduce)
    _, h, f = dense.shape
    nnz = col.shape[0]
    per = spmm_chunk_edges(h * f)
    out = torch.zeros((num_rows, h, f), dtype=torch.float32,
                      device=dense.device)
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        contrib = dense[col[e0:e1].long()].float() \
            * values[e0:e1, :, None].float()
        out.index_add_(0, coo_row[e0:e1].long(), contrib)
    if reduce == ReduceOp.MEAN:
        if degrees is None:
            degrees = torch.bincount(coo_row.long(), minlength=num_rows)
        out = out / torch.clamp(degrees, min=1).float()[:, None, None]
    return out.to(dense.dtype)


def _per_edge_degrees(out: torch.Tensor, coo_row: torch.Tensor,
                      degrees: Optional[torch.Tensor]) -> torch.Tensor:
    if degrees is None:
        raise ValueError("degrees required for MEAN sddmm")
    deg = torch.clamp(degrees, min=1).float()[coo_row.long()]
    return deg.reshape(deg.shape + (1,) * (out.dim() - 1))


def sddmm(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    d1: torch.Tensor,
    d2: torch.Tensor,
    reduce: ReduceOp = ReduceOp.SUM,
    degrees: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-edge dots out[e] = dot(d1[row_e], d2[col_e]) over the last axis:
    d1 [M, F], d2 [N, F] give [nnz]; [M, H, F] and [N, H, F] give [nnz, H].
    MEAN divides by max(row degree, 1). Sums and returns float32."""
    out = (d1[coo_row.long()].float() * d2[col.long()].float()).sum(-1)
    if reduce == ReduceOp.MEAN:
        out = out / _per_edge_degrees(out, coo_row, degrees)
    return out


def sddmm_chunked(
    coo_row: torch.Tensor,
    col: torch.Tensor,
    d1: torch.Tensor,
    d2: torch.Tensor,
    reduce: ReduceOp = ReduceOp.SUM,
    degrees: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """`sddmm` with the two gathered [nnz, ...] buffers materialized one
    edge chunk at a time (at most 512 MiB each)."""
    nnz = coo_row.shape[0]
    per = max(_SDDMM_CHUNK_BUDGET // (4 * max(d1.shape[1:].numel(), 1)), 1)
    if nnz <= per:
        return sddmm(coo_row, col, d1, d2, reduce, degrees)
    out = torch.cat([sddmm(coo_row[e0:e0 + per], col[e0:e0 + per], d1, d2)
                     for e0 in range(0, nnz, per)])
    if reduce == ReduceOp.MEAN:
        out = out / _per_edge_degrees(out, coo_row, degrees)
    return out


def sddmm_bwd_chunked(
    seg_ids: torch.Tensor,
    other_ids: torch.Tensor,
    g: torch.Tensor,
    other: torch.Tensor,
    num_segments: int,
) -> torch.Tensor:
    """d_d1 / d_d2 of the SDDMM: the segment sum over seg_ids of
    g[e] * other[other_ids[e]], one edge chunk at a time. Sums and returns
    float32 [num_segments, F]."""
    nnz = seg_ids.shape[0]
    f = other.shape[-1]
    per = max(_SDDMM_CHUNK_BUDGET // (4 * max(f, 1)), 1)
    out = torch.zeros((num_segments, f), dtype=torch.float32,
                      device=other.device)
    for e0 in range(0, nnz, per):
        e1 = min(e0 + per, nnz)
        contrib = other[other_ids[e0:e1].long()].float() \
            * g[e0:e1, None].float()
        out.index_add_(0, seg_ids[e0:e1].long(), contrib)
    return out
