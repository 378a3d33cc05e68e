"""Plain PyTorch SpMM (SUM/MEAN, single- and multi-head) and SDDMM: the
CPU path and the port's oracle.

Counterpart of the SUM/MEAN and SDDMM parts of `dgsparse_tpu/kernels/xla.py`
and of `_xla_mh` in `dgsparse_tpu/ops/spmm_mh.py`, with the same semantics
(reference CUDA kernels):
- empty rows produce 0,
- MEAN divides by max(row degree, 1),
- missing values mean implicit 1.0,
- the semiring combine is compute(edge, feat), SUB = feat - edge and
  DIV = feat / edge.

Sums accumulate in float32 whatever the input dtype (as the JAX package's
chunked path and the CUDA kernel do) and are cast to the input dtype at
the end. On a CUDA tensor `index_add_` uses atomics, so its summation
order, and the last bits of its result, vary from run to run. MAX/MIN
come with their kernel.
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
        raise NotImplementedError(
            f"{reduce} is not ported yet; MAX/MIN come with their kernel")


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

    Returns (out, None); the second slot is the MAX/MIN winning-edge
    residual of the JAX package's signature. Empty segments yield 0.
    """
    _check_sum_mean(reduce)
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
    contribution buffer never exceeds 512 MiB; chunk partials add.
    Returns (out, None) as `segment_reduce` does.
    """
    _check_sum_mean(reduce)
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
