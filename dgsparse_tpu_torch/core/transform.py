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


def invert_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i, in perm's dtype and on its device."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype,
                                    device=perm.device)
    return inv


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


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """table[index] along dim 0, through index_select on a column-major
    copy of a 2-D table with more than one column.

    On the H100, PyTorch gathers rows of 16 bytes (4 fp32) from a
    contiguous table some 40x slower than from a column-major one
    (`chip_smoke.py`, phase 8, times both); the copy costs one pass over
    the table. The backward is index_add_.
    """
    if table.dim() == 2 and table.shape[1] > 1:
        table = table.t().contiguous().t()
    return table.index_select(0, index)


def row_degrees(rowptr: torch.Tensor) -> torch.Tensor:
    return rowptr[1:] - rowptr[:-1]


# --- numpy twins: host-side structure building at construction ---------------

def expand_rowptr_np(rowptr: np.ndarray) -> np.ndarray:
    return np.repeat(
        np.arange(len(rowptr) - 1, dtype=np.int32), np.diff(rowptr))


def stable_argsort(keys: np.ndarray, device=None) -> np.ndarray:
    """np.argsort(keys, kind="stable") as int64, sorted on `device` when
    that is a CUDA device: a stable sort's permutation is unique, so both
    give the same array, and the card sorts 10^8 keys in milliseconds where
    numpy takes seconds."""
    if device is None or torch.device(device).type != "cuda":
        return np.argsort(keys, kind="stable")
    _, perm = torch.sort(torch.from_numpy(np.ascontiguousarray(keys)).to(
        device), stable=True)
    return perm.cpu().numpy()


def csr2csc_np(rowptr: np.ndarray, col: np.ndarray, num_cols: int,
               device=None):
    """(colptr, row_csc, perm) with a stable argsort (`stable_argsort`)."""
    row = expand_rowptr_np(rowptr)
    perm = stable_argsort(col, device).astype(np.int32)
    colptr = np.zeros(num_cols + 1, np.int32)
    np.cumsum(np.bincount(col, minlength=num_cols), out=colptr[1:])
    return colptr, row[perm], perm
