"""GE-SpMM standalone-library API: the reference's framework-free C API
surface (src/ge-spmm/gespmm.h:9-85) on the port's SpMM.

Counterpart of `dgsparse_tpu/ge_spmm.py`: the `SpMatCsrDescr_t`
descriptor, the `gespmmAlg_t` enum (`GespmmAlg`), the `gespmmAlgSel`
heuristic (src/ge-spmm/gespmm.cc:13-24, its return values kept exactly),
the `gespmmCsrSpMM` entry with `transpose=False`, the legacy `spmm_cuda`
/ `spmm_cuda_no_edge_value` aliases and the v2 COO entry
`cuda_csr_coo_spmm`, as a thin layer over `SparseTensor` and `spmm`, so
code written against the reference's C API maps one to one.

The reference's schedules map onto the port's routes (`ops/spmm.py`);
on the card each algorithm runs:
- DEFAULT -> AUTO, and the two row-balance algorithms -> PALLAS_ROW_TILE:
  the hybrid tiers (`spmm_dense_cells`, `spmm_bell` and `csr_spmm` for
  the residue) on a storage with a hybrid plan, else `csr_spmm`;
- the two nnz-balance algorithms -> PALLAS_EDGE_TILE and the two
  row-caching ones -> PALLAS_BELL: `csr_spmm` on every storage (in the
  port both routes are the CSR kernel).
`transpose=False` (column-major B and C, csrspmm_non_transpose.cu) takes
B as [N, ncol] and returns C as [N, nrow], through transposed views.
"""

import dataclasses
import enum
from typing import Optional

import torch

from dgsparse_tpu_torch.core.formats import SparseTensor
from dgsparse_tpu_torch.ops.spmm import spmm
from dgsparse_tpu_torch.ops.types import Algorithm


class GespmmAlg(enum.Enum):
    """gespmmAlg_t (src/ge-spmm/gespmm.h:18-30), with the JAX package's
    values."""

    DEFAULT = "default"                     # = gespmmAlgSel
    SEQREDUCE_ROWBALANCE = "seqreduce_rowbalance"
    PARREDUCE_ROWBALANCE = "parreduce_rowbalance"
    SEQREDUCE_NNZBALANCE = "seqreduce_nnzbalance"
    PARREDUCE_NNZBALANCE = "parreduce_nnzbalance"
    ROWCACHING_ROWBALANCE = "rowcaching_rowbalance"
    ROWCACHING_NNZBALANCE = "rowcaching_nnzbalance"


_ALG_MAP = {
    GespmmAlg.DEFAULT: Algorithm.AUTO,
    # row balance: the hybrid tiers where there is a plan, else csr_spmm
    GespmmAlg.SEQREDUCE_ROWBALANCE: Algorithm.PALLAS_ROW_TILE,
    GespmmAlg.PARREDUCE_ROWBALANCE: Algorithm.PALLAS_ROW_TILE,
    # nnz balance and row caching: csr_spmm
    GespmmAlg.SEQREDUCE_NNZBALANCE: Algorithm.PALLAS_EDGE_TILE,
    GespmmAlg.PARREDUCE_NNZBALANCE: Algorithm.PALLAS_EDGE_TILE,
    GespmmAlg.ROWCACHING_ROWBALANCE: Algorithm.PALLAS_BELL,
    GespmmAlg.ROWCACHING_NNZBALANCE: Algorithm.PALLAS_BELL,
}


@dataclasses.dataclass
class SpMatCsrDescr_t:  # noqa: N801 — reference-parity name
    """CSR descriptor (src/ge-spmm/gespmm.h:9-16). Its SparseTensor is
    built once, on the device of `indptr`, at first use and kept (the
    plans and the CSC view are built once per descriptor, not per call)."""

    nrow: int
    ncol: int
    nnz: int
    indptr: torch.Tensor
    indices: torch.Tensor
    data: Optional[torch.Tensor] = None
    _sp: Optional[SparseTensor] = dataclasses.field(
        default=None, repr=False, compare=False)

    def to_sparse_tensor(self) -> SparseTensor:
        if self._sp is None:
            self._sp = SparseTensor.from_csr(
                self.indptr, self.indices, self.data,
                sparse_sizes=(self.nrow, self.ncol),
                device=torch.as_tensor(self.indptr).device)
        return self._sp


def gespmmAlgSel(dense_ncol: int, transpose: bool = True) -> GespmmAlg:  # noqa: N802
    """The reference heuristic (src/ge-spmm/gespmm.cc:13-24): N >= 32 ->
    row-caching, N > 4 -> seqreduce row-balance, else parreduce
    row-balance; column-major B -> parreduce row-balance. Kept for drop-in
    parity; the port's AUTO routes by structure."""
    if not transpose:
        return GespmmAlg.PARREDUCE_ROWBALANCE
    if dense_ncol >= 32:
        return GespmmAlg.ROWCACHING_ROWBALANCE
    if dense_ncol > 4:
        return GespmmAlg.SEQREDUCE_ROWBALANCE
    return GespmmAlg.PARREDUCE_ROWBALANCE


def gespmmCsrSpMM(sp_descr: SpMatCsrDescr_t, B: torch.Tensor,  # noqa: N802
                  alg: GespmmAlg = GespmmAlg.DEFAULT,
                  transpose: bool = True) -> torch.Tensor:
    """gespmmCsrSpMM (src/ge-spmm/gespmm.h:40-47): C = A @ B, sum-reduce.

    transpose=True: B is [ncol, N] row-major (the common layout).
    transpose=False: the reference's column-major variant, B [N, ncol]
    and C returned [N, nrow]."""
    sp = sp_descr.to_sparse_tensor()
    algorithm = _ALG_MAP[alg]
    if transpose:
        return spmm(sp, B, "sum", algorithm)
    return spmm(sp, B.t(), "sum", algorithm).t()


def spmm_cuda(sp_descr: SpMatCsrDescr_t, B: torch.Tensor) -> torch.Tensor:
    """Legacy alias (src/ge-spmm/gespmm.h:60-70)."""
    return gespmmCsrSpMM(sp_descr, B, GespmmAlg.DEFAULT)


def spmm_cuda_no_edge_value(sp_descr: SpMatCsrDescr_t,
                            B: torch.Tensor) -> torch.Tensor:
    """Legacy alias with the values taken as implicit ones
    (src/ge-spmm/gespmm.h:72-82); the value-free twin descriptor is kept
    on the descriptor, apart from its valued SparseTensor."""
    if sp_descr.data is None:
        return gespmmCsrSpMM(sp_descr, B, GespmmAlg.DEFAULT)
    d = getattr(sp_descr, "_no_value_twin", None)
    if d is None:
        d = dataclasses.replace(sp_descr, data=None, _sp=None)
        sp_descr._no_value_twin = d
    return gespmmCsrSpMM(d, B, GespmmAlg.DEFAULT)


def cuda_csr_coo_spmm(row: torch.Tensor, col: torch.Tensor,
                      values: Optional[torch.Tensor], B: torch.Tensor,
                      nrow: int, transpose: bool = True) -> torch.Tensor:
    """Legacy v2 COO entry (src/ge-spmm/gespmm_csrcoo_v2.cu:6-606): SpMM
    over an unsorted edge list (`ops/spmm_coo.py::spmm_coo`)."""
    from dgsparse_tpu_torch.ops.spmm_coo import spmm_coo

    if transpose:
        return spmm_coo(row, col, values, B, nrow, "sum")
    return spmm_coo(row, col, values, B.t(), nrow, "sum").t()
