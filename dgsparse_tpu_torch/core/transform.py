"""Sparse format transforms on torch tensors, plus their numpy twins.

Counterpart of `dgsparse_tpu/core/transform.py`. The transpose is a stable
argsort over column indices; `Storage` runs the numpy twins once, on the
host, at construction, and caches the CSC view (as the reference caches it,
dgsparse/storage.py:100). All index arrays are int32.
"""

from typing import Optional, Tuple

import numpy as np
import torch


def expand_rowptr(rowptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """CSR rowptr -> per-edge row ids (COO row array); empty rows are fine."""
    positions = torch.arange(nnz, dtype=rowptr.dtype, device=rowptr.device)
    return torch.searchsorted(rowptr[1:].contiguous(), positions,
                              right=True).to(torch.int32)


def compress_rowids(row: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Sorted COO row ids -> CSR rowptr of length num_rows + 1."""
    counts = torch.bincount(row.long(), minlength=num_rows)
    rowptr = torch.zeros(num_rows + 1, dtype=torch.int32, device=row.device)
    rowptr[1:] = torch.cumsum(counts, 0)
    return rowptr


def csr2csc(
    rowptr: torch.Tensor,
    col: torch.Tensor,
    values: Optional[torch.Tensor],
    num_cols: int,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Transpose CSR into CSC: (colptr, row, values_csc, perm), where
    ``values_csc = values[perm]``. The sort is stable, so rows stay sorted
    within each column."""
    row = expand_rowptr(rowptr, col.shape[0])
    perm = torch.argsort(col, stable=True).to(torch.int32)
    colptr = compress_rowids(col, num_cols)
    row_csc = row[perm.long()]
    values_csc = None if values is None else values[perm.long()]
    return colptr, row_csc, values_csc, perm


def coo2csr(
    row: torch.Tensor,
    col: torch.Tensor,
    values: Optional[torch.Tensor],
    num_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Sort COO edges by row (stable, so column order is kept) and build
    rowptr. Returns (rowptr, col_sorted, values_sorted, perm)."""
    perm = torch.argsort(row, stable=True).to(torch.int32)
    p = perm.long()
    rowptr = compress_rowids(row[p], num_rows)
    values_sorted = None if values is None else values[p]
    return rowptr, col[p], values_sorted, perm


def csr2coo(rowptr: torch.Tensor,
            col: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR -> COO (row, col)."""
    return expand_rowptr(rowptr, col.shape[0]), col


def row_degrees(rowptr: torch.Tensor) -> torch.Tensor:
    return rowptr[1:] - rowptr[:-1]


# --- numpy twins: host-side structure building at construction ---------------

def expand_rowptr_np(rowptr: np.ndarray) -> np.ndarray:
    return np.repeat(
        np.arange(len(rowptr) - 1, dtype=np.int32), np.diff(rowptr))


def csr2csc_np(rowptr: np.ndarray, col: np.ndarray, num_cols: int):
    """(colptr, row_csc, perm) with a stable numpy argsort."""
    row = expand_rowptr_np(rowptr)
    perm = np.argsort(col, kind="stable").astype(np.int32)
    colptr = np.zeros(num_cols + 1, np.int32)
    np.cumsum(np.bincount(col, minlength=num_cols), out=colptr[1:])
    return colptr, row[perm], perm
