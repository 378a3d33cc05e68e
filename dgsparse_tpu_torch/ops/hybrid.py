"""The three-tier hybrid SpMM, its transpose and the hybrid SDDMM.

Counterparts of `spmm_hybrid` and `spmm_hybrid_t`
(`dgsparse_tpu/kernels/pallas_spmm.py:706-797`) and `sddmm_hybrid`
(`dgsparse_tpu/kernels/pallas_sddmm.py:170-211`), over a storage's
`core/planner.py::HybridPlan` and its cached tier values
(`Storage.tier_values`). Every tier is a row-partitioned partial sum:
  forward    out = cells + BELL + residue, MEAN dividing once at the end;
  transpose  Aᵀ·g = cellsᵀ (the same blocks) + the non-cell edges' CSC;
  SDDMM      [cell blocks ++ non-cell edges], then one gather (edge_src)
             into CSR edge order.
The cells run `kernels/spmm_cells.py`, BELL `kernels/spmm_bell.py`, and the
residue, the non-cell transpose and the non-cell SDDMM the CSR kernels
(`csr_spmm`, `sddmm_csr`). Tier sums are float32.

The forward's BELL tier adds into the tier sum in place (`spmm_bell(...,
out=out)`: only the rows with BELL edges are read and written), where the
JAX function adds a fresh [M, F] output. The sum is the forward's own
tensor, made here and not yet returned (inside the autograd Function's
forward, `ops/spmm.py`), so nothing else sees the update; the order of
the additions, residue then cells then BELL, is unchanged.

`compute_dtype` is the JAX functions' argument. float32 (the default) is
the mode above. bfloat16, the bf16 compute mode (`ops/spmm.py` takes it for
a bf16 `dense` or `g`, `ops/attention.py` on request), rounds dense (or g)
to bf16 once a call, and every tier reads that copy: the residue's
`csr_spmm` and the non-cell transpose gather bf16 rows, BELL reads them,
and the cells multiply the storage's bf16 twin of the blocks
(`tiers["cells_bf16"]`, or the fp32 blocks rounded by the kernel's wrapper
where the dict has no twin) on the bf16-cell kernel. Every product of two
bf16 operands is exact in float32, the tier sums stay float32 and in the
same order. One difference from the JAX mode is intended: JAX's BELL
kernel also rounds each edge's product (value times row) to bf16 before
its one-hot sum (`pallas_spmm.py:824-828`), which on the TPU halves an MXU
pass; on Hopper BELL's FMAs read the bf16 rows either way, so the port
keeps the fp32 product, within 2^-9 of a BELL term of JAX's. (JAX's
residue likewise multiplies bf16-rounded weights in bf16; the port's CSR
kernel keeps fp32 weights and products.) `sddmm_hybrid`'s bf16 mode rounds
d1 and d2 for the cells only, as JAX's does.

With tracing on (`utils/metrics.py`), each tier of `spmm_hybrid` and
`spmm_hybrid_t` is a span of its own inside the op's span, with the tags
that price it, and a count of its launches (`hybrid.<tier>`):
`dgsparse.hybrid.residue` (m, nnz, f), `.cells` (cells, f, transpose),
`.bell` (rows, long_rows, slots, f) and `.nd_t` (n, nnz, f).
"""

import torch

from dgsparse_tpu_torch.core.formats import Storage
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_bell import spmm_bell
from dgsparse_tpu_torch.kernels.spmm_cells import (check_compute_dtype,
                                                   sddmm_cells,
                                                   spmm_dense_cells)
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.ops.types import ReduceOp
from dgsparse_tpu_torch.utils import metrics


def _tier(name: str, **tags):
    """The span `dgsparse.hybrid.<name>` of one tier's launch, counted as
    `hybrid.<name>`. Call sites ask only with tracing on
    (`metrics.enabled()`), so that tracing off works out no tag."""
    metrics.count(f"hybrid.{name}")
    return metrics.span(f"dgsparse.hybrid.{name}", **tags)


def _cells(tiers: dict, bf16: bool) -> torch.Tensor:
    """The blocks a cell pass multiplies: the bf16 twin in bf16 mode where
    the dict holds one, else the fp32 blocks."""
    if bf16 and tiers.get("cells_bf16") is not None:
        return tiers["cells_bf16"]
    return tiers["cells"]


def spmm_hybrid(st: Storage, tiers: dict, dense: torch.Tensor,
                reduce: ReduceOp = ReduceOp.SUM,
                compute_dtype=torch.float32) -> torch.Tensor:
    """A · dense [N, F] for the storage's structure with the values that
    `tiers` caches, in dense's dtype."""
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError("spmm_hybrid handles SUM/MEAN only")
    bf16 = check_compute_dtype(compute_dtype)
    hp = st.ell_plan()
    x = dense.to(torch.bfloat16) if bf16 else dense
    on, f = metrics.enabled(), x.shape[1]
    with _tier("residue", m=hp.num_rows, nnz=hp.res.nnz, f=f) if on \
            else metrics.NULL_SPAN:
        out = csr_spmm(hp.res.rowptr, hp.res.col, tiers["res"], x,
                       ReduceOp.SUM).float()
    if hp.cells is not None:
        with _tier("cells", cells=hp.cells.num_cells, f=f,
                   transpose=False) if on else metrics.NULL_SPAN:
            out += spmm_dense_cells(hp.cells, _cells(tiers, bf16), x,
                                    compute_dtype=compute_dtype)
    bp = hp.bell
    if bp is not None:
        with _tier("bell", rows=bp.num_bell_rows, long_rows=bp.num_long_rows,
                   slots=bp.padded_edges, f=f) if on else metrics.NULL_SPAN:
            spmm_bell(bp, tiers["bell"], x, out=out)
    if reduce == ReduceOp.MEAN:
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        out /= torch.clamp(deg, min=1).float()[:, None]
    return out.to(dense.dtype)


def spmm_hybrid_t(st: Storage, tiers: dict, g: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """Aᵀ · g for g [M, F]: float32 [N, F]."""
    bf16 = check_compute_dtype(compute_dtype)
    hp = st.ell_plan()
    x = g.to(torch.bfloat16) if bf16 else g
    on, f = metrics.enabled(), x.shape[1]
    with _tier("nd_t", n=hp.num_cols, nnz=hp.nd_t.nnz, f=f) if on \
            else metrics.NULL_SPAN:
        out = csr_spmm(hp.nd_t.rowptr, hp.nd_t.col, tiers["nd_t"], x,
                       ReduceOp.SUM).float()
    if hp.cells is not None:
        with _tier("cells", cells=hp.cells.num_cells, f=f,
                   transpose=True) if on else metrics.NULL_SPAN:
            out += spmm_dense_cells(hp.cells, _cells(tiers, bf16), x,
                                    transpose=True,
                                    compute_dtype=compute_dtype)
    return out


def sddmm_hybrid(st: Storage, d1: torch.Tensor, d2: torch.Tensor,
                 reduce: ReduceOp = ReduceOp.SUM,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """Per-edge dots dot(d1[row_e], d2[col_e]) in CSR edge order, float32
    [nnz]: the cells' blocks from one kernel (in `compute_dtype`), the
    non-cell edges from the CSR SDDMM over their sub-CSR; MEAN divides by
    max(row degree, 1)."""
    check_compute_dtype(compute_dtype)
    hp = st.ell_plan()
    parts = [sddmm_csr(hp.nd.rowptr, hp.nd.col, d1, d2).reshape(-1)]
    if hp.cells is not None:
        parts.insert(0, sddmm_cells(hp.cells, d1, d2,
                                    compute_dtype=compute_dtype))
    stream = parts[0] if len(parts) == 1 else torch.cat(parts)
    out = stream.index_select(0, hp.edge_src)
    if reduce == ReduceOp.MEAN:
        deg = torch.clamp(st.rowptr()[1:] - st.rowptr()[:-1], min=1).float()
        out = out / deg[st.coo_row().long()]
    return out
