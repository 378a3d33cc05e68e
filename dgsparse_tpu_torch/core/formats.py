"""CSR sparse containers: `Storage` and `SparseTensor` on torch tensors.

Counterpart of `dgsparse_tpu/core/formats.py` (reference:
dgsparse/storage.py, dgsparse/tensor.py): int32 CSR indices, optional
values (implicit ones when absent), and the CSC view (colptr, row, the
csr2csc permutation, per-edge row ids in CSR order and per-edge column ids
in CSC order) built once on the host at construction, so no op derives
structure per call. The JAX package's kernel plans (edge-tile, ELL, BELL,
hybrid, slot caches) have no counterpart: the CUDA kernel reads CSR as is.
"""

from typing import Optional, Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.core import transform as T


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _index_host(x) -> np.ndarray:
    arr = _host(x)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(f"index arrays must be integer, got {arr.dtype}")
    return arr.astype(np.int32, copy=False)


def _index_tensor(arr: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(arr, dtype=np.int32)).to(device)


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


class Storage:
    """CSR arrays plus the CSC view, all built at construction.

    Tensors: rowptr, col, values (or None), colptr, row_csc, csr2csc perm,
    coo_row, csc_col. Sizes: num_rows, num_cols, nnz.
    """

    def __init__(
        self,
        rowptr=None,
        col=None,
        values=None,
        row=None,
        sparse_sizes: Optional[Tuple[int, int]] = None,
        device=None,
    ):
        if col is None:
            raise ValueError("col is required")
        if device is None:
            device = _device_of(rowptr, col, values, row)
        col_np = _index_host(col)
        nnz = len(col_np)
        vals = None if values is None else torch.as_tensor(values)

        if rowptr is None:
            if row is None:
                raise ValueError("either rowptr or row must be given")
            row_np = _index_host(row)
            if sparse_sizes is None:
                num_rows = int(row_np.max()) + 1 if nnz else 0
            else:
                num_rows = int(sparse_sizes[0])
            perm = np.argsort(row_np, kind="stable")
            counts = np.zeros(num_rows + 1, np.int64)
            np.add.at(counts, row_np + 1, 1)
            rowptr_np = np.cumsum(counts).astype(np.int32)
            col_np = col_np[perm]
            if vals is not None:
                vals = vals[torch.as_tensor(perm, device=vals.device)]
        else:
            rowptr_np = _index_host(rowptr)

        num_rows = len(rowptr_np) - 1
        if sparse_sizes is not None:
            if int(sparse_sizes[0]) != num_rows:
                raise ValueError(
                    f"sparse_sizes[0]={sparse_sizes[0]} != rowptr rows "
                    f"{num_rows}")
            num_cols = int(sparse_sizes[1])
        else:
            # reference derives N = col.max() + 1 (storage.py:33-41)
            num_cols = int(col_np.max()) + 1 if nnz else 0
        if nnz and int(col_np.max()) >= num_cols:
            raise ValueError(
                f"col index {int(col_np.max())} out of range "
                f"[0, {num_cols}) — wrong sparse_sizes?")
        if vals is not None and vals.shape[0] != nnz:
            raise ValueError("values/col length mismatch")

        colptr, row_csc, perm = T.csr2csc_np(rowptr_np, col_np, num_cols)
        self._rowptr = _index_tensor(rowptr_np, device)
        self._col = _index_tensor(col_np, device)
        self._values = None if vals is None else vals.to(device)
        self._colptr = _index_tensor(colptr, device)
        self._row_csc = _index_tensor(row_csc, device)
        self._csr2csc = _index_tensor(perm, device)
        self._coo_row = _index_tensor(T.expand_rowptr_np(rowptr_np), device)
        # per-edge col ids in CSC order: the transpose's segment ids
        self._csc_col = _index_tensor(T.expand_rowptr_np(colptr), device)
        self._num_rows = num_rows
        self._num_cols = num_cols
        self._nnz = nnz

    def _replace(self, **tensors) -> "Storage":
        """A copy with some tensors (and, via `_num_*`, sizes) replaced."""
        obj = Storage.__new__(Storage)
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update({f"_{k}": v for k, v in tensors.items()})
        return obj

    def to(self, device) -> "Storage":
        """The same structure with every tensor on `device`."""
        moved = {k[1:]: (None if v is None else v.to(device))
                 for k, v in self.__dict__.items()
                 if isinstance(v, torch.Tensor) or k == "_values"}
        return self._replace(**moved)

    # --- reference-parity accessors (dgsparse/storage.py) ---
    def rowptr(self) -> torch.Tensor:
        return self._rowptr

    def col(self) -> torch.Tensor:
        return self._col

    def values(self) -> Optional[torch.Tensor]:
        return self._values

    def colptr(self) -> torch.Tensor:
        return self._colptr

    def row(self) -> torch.Tensor:
        """CSC row indices (paired with colptr)."""
        return self._row_csc

    def csr2csc(self) -> torch.Tensor:
        """Permutation p with values_csc = values[p]."""
        return self._csr2csc

    def coo_row(self) -> torch.Tensor:
        """Per-edge row ids in CSR order."""
        return self._coo_row

    def csc_col(self) -> torch.Tensor:
        """Per-edge col ids in CSC order (segment ids of the transpose)."""
        return self._csc_col

    @property
    def device(self) -> torch.device:
        return self._rowptr.device

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def num_cols(self) -> int:
        return self._num_cols

    @property
    def nnz(self) -> int:
        return self._nnz

    def sparse_sizes(self) -> Tuple[int, int]:
        return (self._num_rows, self._num_cols)


class SparseTensor:
    """CSR sparse matrix handle (reference: dgsparse/tensor.py:7-42)."""

    def __init__(
        self,
        row=None,
        rowptr=None,
        col=None,
        values=None,
        has_value: bool = False,
        sparse_sizes: Optional[Tuple[int, int]] = None,
        device=None,
    ):
        self.storage = Storage(rowptr=rowptr, col=col, values=values,
                               row=row, sparse_sizes=sparse_sizes,
                               device=device)
        self.has_value = bool(has_value)

    @classmethod
    def _wrap(cls, storage: Storage, has_value: bool) -> "SparseTensor":
        obj = cls.__new__(cls)
        obj.storage = storage
        obj.has_value = has_value
        return obj

    # --- constructors ---
    @classmethod
    def from_csr(cls, rowptr, col, values=None,
                 sparse_sizes: Optional[Tuple[int, int]] = None,
                 device=None) -> "SparseTensor":
        return cls(rowptr=rowptr, col=col, values=values,
                   has_value=values is not None, sparse_sizes=sparse_sizes,
                   device=device)

    @classmethod
    def from_edge_index(cls, edge_index, edge_attr=None,
                        sparse_sizes: Optional[Tuple[int, int]] = None,
                        device=None) -> "SparseTensor":
        """Build from a [2, nnz] edge_index (row 0 = dst/row, row 1 =
        src/col); edges are stably sorted by row."""
        ei = _index_host(edge_index)
        if device is None:
            device = _device_of(edge_index, edge_attr)
        return cls(row=ei[0], col=ei[1], values=edge_attr,
                   has_value=edge_attr is not None,
                   sparse_sizes=sparse_sizes, device=device)

    @classmethod
    def from_scipy(cls, mat, device=None) -> "SparseTensor":
        csr = mat.tocsr()
        csr.sort_indices()
        return cls.from_csr(
            csr.indptr.astype(np.int32), csr.indices.astype(np.int32),
            torch.from_numpy(np.asarray(csr.data, np.float32)),
            sparse_sizes=(int(csr.shape[0]), int(csr.shape[1])),
            device=device)

    @classmethod
    def from_dense(cls, mat, device=None) -> "SparseTensor":
        if device is None:
            device = _device_of(mat)
        mat = _host(mat)
        row, col = np.nonzero(mat)
        order = np.lexsort((col, row))
        row, col = row[order], col[order]
        rowptr = np.zeros(mat.shape[0] + 1, np.int32)
        np.add.at(rowptr, row + 1, 1)
        rowptr = np.cumsum(rowptr).astype(np.int32)
        return cls.from_csr(
            rowptr, col.astype(np.int32),
            torch.from_numpy(mat[row, col].astype(np.float32)),
            sparse_sizes=(int(mat.shape[0]), int(mat.shape[1])),
            device=device)

    # --- views ---
    def to_dense(self) -> torch.Tensor:
        m, n = self.sparse_sizes()
        vals = self.values_or_ones()
        out = torch.zeros((m, n), dtype=vals.dtype, device=vals.device)
        st = self.storage
        return out.index_put_((st.coo_row().long(), st.col().long()), vals,
                              accumulate=True)

    def values_or_ones(self) -> torch.Tensor:
        """Explicit values, or implicit all-ones (reference
        __guard_load_default_one, include/cuda/cuda_util.cuh:139-146)."""
        v = self.storage.values()
        if self.has_value and v is not None:
            return v
        return torch.ones(self.nnz, dtype=torch.float32, device=self.device)

    def t(self) -> "SparseTensor":
        """Transpose, reusing the cached CSC view (no re-sort)."""
        src = self.storage
        perm = src.csr2csc()
        vals = None
        if self.has_value and src.values() is not None:
            vals = src.values()[perm.long()]
        inv = torch.empty_like(perm)
        inv[perm.long()] = torch.arange(src.nnz, dtype=perm.dtype,
                                        device=perm.device)
        st = src._replace(
            rowptr=src.colptr(), col=src.row(), values=vals,
            colptr=src.rowptr(), row_csc=src.col(), csr2csc=inv,
            # the transpose's edge-order arrays are the original's CSC twins
            coo_row=src.csc_col(), csc_col=src.coo_row(),
            num_rows=src.num_cols, num_cols=src.num_rows)
        return SparseTensor._wrap(st, self.has_value)

    def to(self, device) -> "SparseTensor":
        return SparseTensor._wrap(self.storage.to(device), self.has_value)

    # --- shape ---
    def sparse_sizes(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    @property
    def nnz(self) -> int:
        return self.storage.nnz

    @property
    def device(self) -> torch.device:
        return self.storage.device

    def __repr__(self) -> str:
        m, n = self.sparse_sizes()
        return (f"SparseTensor(shape=({m}, {n}), nnz={self.nnz}, "
                f"has_value={self.has_value}, device={self.device})")
