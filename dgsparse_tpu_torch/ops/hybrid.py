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
"""

import torch

from dgsparse_tpu_torch.core.formats import Storage
from dgsparse_tpu_torch.kernels.sddmm_csr import sddmm_csr
from dgsparse_tpu_torch.kernels.spmm_bell import spmm_bell
from dgsparse_tpu_torch.kernels.spmm_cells import (sddmm_cells,
                                                   spmm_dense_cells)
from dgsparse_tpu_torch.kernels.spmm_csr import csr_spmm
from dgsparse_tpu_torch.ops.types import ReduceOp


def spmm_hybrid(st: Storage, tiers: dict, dense: torch.Tensor,
                reduce: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """A · dense [N, F] for the storage's structure with the values that
    `tiers` caches, in dense's dtype."""
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError("spmm_hybrid handles SUM/MEAN only")
    hp = st.ell_plan()
    out = csr_spmm(hp.res.rowptr, hp.res.col, tiers["res"], dense,
                   ReduceOp.SUM).float()
    if hp.cells is not None:
        out += spmm_dense_cells(hp.cells, tiers["cells"], dense)
    if hp.bell is not None:
        spmm_bell(hp.bell, tiers["bell"], dense, out=out)
    if reduce == ReduceOp.MEAN:
        deg = st.rowptr()[1:] - st.rowptr()[:-1]
        out /= torch.clamp(deg, min=1).float()[:, None]
    return out.to(dense.dtype)


def spmm_hybrid_t(st: Storage, tiers: dict, g: torch.Tensor) -> torch.Tensor:
    """Aᵀ · g for g [M, F]: float32 [N, F]."""
    hp = st.ell_plan()
    out = csr_spmm(hp.nd_t.rowptr, hp.nd_t.col, tiers["nd_t"], g,
                   ReduceOp.SUM).float()
    if hp.cells is not None:
        out += spmm_dense_cells(hp.cells, tiers["cells"], g, transpose=True)
    return out


def sddmm_hybrid(st: Storage, d1: torch.Tensor, d2: torch.Tensor,
                 reduce: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Per-edge dots dot(d1[row_e], d2[col_e]) in CSR edge order, float32
    [nnz]: the cells' blocks from one kernel, the non-cell edges from the
    CSR SDDMM over their sub-CSR; MEAN divides by max(row degree, 1)."""
    hp = st.ell_plan()
    parts = [sddmm_csr(hp.nd.rowptr, hp.nd.col, d1, d2).reshape(-1)]
    if hp.cells is not None:
        parts.insert(0, sddmm_cells(hp.cells, d1, d2))
    stream = parts[0] if len(parts) == 1 else torch.cat(parts)
    out = stream.index_select(0, hp.edge_src)
    if reduce == ReduceOp.MEAN:
        deg = torch.clamp(st.rowptr()[1:] - st.rowptr()[:-1], min=1).float()
        out = out / deg[st.coo_row().long()]
    return out
