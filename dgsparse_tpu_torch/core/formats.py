"""CSR sparse containers: `Storage` and `SparseTensor` on torch tensors.

Counterpart of `dgsparse_tpu/core/formats.py` (reference:
dgsparse/storage.py, dgsparse/tensor.py): int32 CSR indices, optional
values (implicit ones when absent), and the CSC view (colptr, row, the
csr2csc permutation, per-edge row ids in CSR order and per-edge column ids
in CSC order) built once on the host at construction, so no op derives
structure per call. Of the JAX package's kernel plans only the hybrid one
has a counterpart (`core/planner.py::HybridPlan`, built under the same
gate, `Storage.ell_plan()`), with its construction-time cache of each
tier's values; the edge-tile, ELL and slot plans have none: the CSR
kernels read CSR as is. Each storage also carries the sampled structure
hash `_tune_key` that keys the tuner's cache (`utils/tune.py`), with the
JAX recipe, so both packages key a structure alike.
"""

import contextlib
import hashlib
import time
from typing import Optional, Tuple

import numpy as np
import torch

from dgsparse_tpu_torch.core import planner as P
from dgsparse_tpu_torch.core import transform as T
from dgsparse_tpu_torch.kernels.spmm_csr import SplitPlan, split_plan
from dgsparse_tpu_torch.utils import metrics


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


def _check_csr(rowptr: np.ndarray, col: np.ndarray, num_cols: int,
               nnz: int) -> None:
    """Raise ValueError unless rowptr starts at 0, ends at nnz and never
    decreases and every column lies in [0, num_cols) (the CSR kernels walk
    [rowptr[m], rowptr[m + 1]) of col unchecked): the invariants and
    messages of `dgsparse_tpu/core/formats.py::SparseTensor.validate`."""
    if len(rowptr) == 0 or rowptr[0] != 0 or rowptr[-1] != nnz:
        raise ValueError("rowptr must start at 0 and end at nnz")
    if (np.diff(rowptr) < 0).any():
        raise ValueError("rowptr must be nondecreasing")
    if len(col) and (col.min() < 0 or col.max() >= num_cols):
        raise ValueError(f"col indices out of range [0, {num_cols})")


def structure_hash(num_rows: int, num_cols: int, nnz: int, rowptr,
                   col) -> str:
    """The sampled structure hash of `dgsparse_tpu/core/formats.py:147-156`:
    blake2b (12 bytes) of "m,n,nnz", then rowptr and col as int32, each
    sampled at stride max(len // 65536, 1). A tensor is sampled where it
    lies and only the sample is copied to the host."""
    h = hashlib.blake2b(digest_size=12)
    h.update(f"{num_rows},{num_cols},{nnz}".encode())
    for a in (rowptr, col):
        step = max(len(a) // 65536, 1)
        h.update(np.ascontiguousarray(_host(a[::step]), np.int32).tobytes())
    return h.hexdigest()


def _values_key(values: torch.Tensor) -> Tuple[int, int]:
    """What the cached tier values were built from: the values tensor's
    identity and its version counter, which every in-place change moves
    (views and `.detach()` share it). An inference tensor keeps no
    counter; it is keyed by identity alone."""
    try:
        return id(values), values._version
    except RuntimeError:
        return id(values), -1


def _device_of(*xs) -> torch.device:
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return torch.device("cpu")


def _move(obj, device):
    """A Storage field on `device`: tensors, plans and dicts of tensors
    move; anything else stays."""
    if isinstance(obj, dict):
        return {k: _move(v, device) for k, v in obj.items()}
    return obj.to(device) if hasattr(obj, "to") else obj


def _host_csr(rowptr, col, values, row, sparse_sizes):
    """(rowptr, col, values, num_cols) of a storage's input on the host,
    sorted by row from COO `row` where no rowptr is given, and checked
    (`_check_csr`); values stay a tensor, permuted with the columns."""
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
    _check_csr(rowptr_np, col_np, num_cols, nnz)
    if vals is not None and vals.shape[0] != nnz:
        raise ValueError("values/col length mismatch")
    return rowptr_np, col_np, vals, num_cols


def _tier_build(ones: bool):
    """The span of a tier-value build after construction, counted."""
    metrics.count("tier_values.built")
    return metrics.span("dgsparse.storage.tier_values", ones=ones)


@contextlib.contextmanager
def _phase(seconds: dict, name: str):
    """One phase of a storage's construction: its host seconds into
    `seconds[name]`, under the span `dgsparse.storage.build.<name>`, which
    it yields."""
    with metrics.span(f"dgsparse.storage.build.{name}") as span:
        t0 = time.perf_counter()
        yield span
        seconds[name] = time.perf_counter() - t0


class Storage:
    """CSR arrays plus the CSC view, all built at construction.

    Tensors: rowptr, col, values (or None), colptr, row_csc, csr2csc perm,
    coo_row, csc_col, and csc_slot (the perm's inverse) on first use.
    Sizes: num_rows, num_cols, nnz. The split plans of both views
    (`kernels/spmm_csr.py::split_plan`: rows or columns longer than
    `SPLIT_CHUNK` entries, cut into chunks) go to every `csr_spmm` over
    them (`row_split()`, `col_split()`).

    With `build_plans` (the default), a graph of nnz >= 4096 and average
    degree >= 16 also gets a `HybridPlan` when at least 30 % of its edges
    fall in filled cells: the gate of `dgsparse_tpu/core/formats.py:202-234`.
    The tiers' values are then cached for the values given here (or for
    implicit ones); `build_seconds` times the construction's phases
    (`host_check`, `csc`, `upload`, `split_plan`, `hybrid_plan`,
    `tier_values`), each also a child span of `dgsparse.storage.build`;
    the `hybrid_plan` span is tagged with the plan's shape
    (`core.planner.describe`).
    """

    def __init__(
        self,
        rowptr=None,
        col=None,
        values=None,
        row=None,
        sparse_sizes: Optional[Tuple[int, int]] = None,
        device=None,
        build_plans: bool = True,
    ):
        if col is None:
            raise ValueError("col is required")
        if device is None:
            device = _device_of(rowptr, col, values, row)
        seconds = self.build_seconds = {}
        with metrics.span("dgsparse.storage.build", nnz=len(col)):
            with _phase(seconds, "host_check"):
                rowptr_np, col_np, vals, num_cols = _host_csr(
                    rowptr, col, values, row, sparse_sizes)
            num_rows, nnz = len(rowptr_np) - 1, len(col_np)
            with _phase(seconds, "csc"):
                colptr, row_csc, perm = T.csr2csc_np(rowptr_np, col_np,
                                                     num_cols, device)
            with _phase(seconds, "upload"):
                self._rowptr = _index_tensor(rowptr_np, device)
                self._col = _index_tensor(col_np, device)
                self._values = None if vals is None else vals.to(device)
                self._colptr = _index_tensor(colptr, device)
                self._row_csc = _index_tensor(row_csc, device)
                self._csr2csc = _index_tensor(perm, device)
                self._csc_slot = None   # csr2csc's inverse, on first use
                self._coo_row = _index_tensor(T.expand_rowptr_np(rowptr_np),
                                              device)
                # per-edge col ids in CSC order: the transpose's segment ids
                self._csc_col = _index_tensor(T.expand_rowptr_np(colptr),
                                              device)
                self._num_rows = num_rows
                self._num_cols = num_cols
                self._nnz = nnz
                self._tune_key = structure_hash(num_rows, num_cols, nnz,
                                                rowptr_np, col_np)
            with _phase(seconds, "split_plan"):
                self._row_split = split_plan(rowptr_np, device=device)
                self._col_split = split_plan(colptr, device=device)

            self._hybrid = self._tier_vals = self._tier_ones = None
            self._tier_key = self._slot_maps = None
            if build_plans and nnz >= 4096 and nnz / max(num_rows, 1) >= 16:
                with _phase(seconds, "hybrid_plan") as span:
                    hyb = P.build_hybrid_plan(rowptr_np, col_np, num_cols,
                                              device=device)
                    if hyb is not None and metrics.enabled():
                        span.tag(**P.describe(hyb))
                if hyb is not None and hyb.dense_fraction >= 0.3:
                    self._hybrid = hyb
                    with _phase(seconds, "tier_values"):
                        metrics.count("tier_values.built")
                        if vals is None:
                            self._tier_ones = P.tier_values(hyb, None, device)
                        else:
                            self._tier_vals = P.tier_values(
                                hyb, vals.detach().float().cpu().numpy(),
                                device)
                            self._tier_key = _values_key(self._values)

    def _replace(self, **tensors) -> "Storage":
        """A copy with some tensors (and, via `_num_*`, sizes) replaced."""
        obj = Storage.__new__(Storage)
        obj.__dict__.update(self.__dict__)
        obj.__dict__.update({f"_{k}": v for k, v in tensors.items()})
        return obj

    def to(self, device) -> "Storage":
        """The same structure with every tensor (and plan) on `device`."""
        moved = {k[1:]: _move(v, device)
                 for k, v in self.__dict__.items() if k.startswith("_")}
        if self._tier_vals is not None and \
                self._tier_key == _values_key(self._values):
            # the moved tiers are those of the moved values
            moved["tier_key"] = _values_key(moved["values"])
        return self._replace(**moved)

    def ell_plan(self) -> Optional[P.HybridPlan]:
        """The hybrid plan, or None (the JAX Storage's accessor; its other
        ELL plans have no counterpart here)."""
        return self._hybrid

    def tier_values(self, ones: bool = False,
                    compute_dtype=torch.float32) -> Optional[dict]:
        """The hybrid tiers' values (`core.planner.tier_values`) for this
        storage's values, or with `ones` for implicit ones; None without a
        hybrid plan. Built at construction or on first use, and kept while
        the values tensor is the same object at the same `_version`: an
        in-place change (`v.mul_(2)`, an optimizer step on a Parameter,
        through any view of it, `.detach()` included) rebuilds them on the
        values' device at the next use, as does `set_values`. With
        `compute_dtype` bfloat16 the dict also holds "cells_bf16", the
        blocks' bf16 twin, made at the first such call and kept with them
        (`core.planner.with_bf16_cells`). The ones' tiers depend on the
        structure alone; do not change them in place."""
        if self._hybrid is None:
            return None
        # kept tensors are made outside inference mode, or a later call
        # under autograd could not save them for backward
        with torch.inference_mode(False):
            if ones:
                if self._tier_ones is None:
                    with _tier_build(ones=True):
                        self._tier_ones = P.tier_values(self._hybrid, None,
                                                        self.device)
                else:
                    metrics.count("tier_values.reused")
                tiers = self._tier_ones
            else:
                if self._values is None:
                    raise ValueError("the storage has no values")
                key = _values_key(self._values)
                if self._tier_vals is None or self._tier_key != key:
                    with _tier_build(ones=False):
                        self._tier_vals = P.tier_values(
                            self._hybrid, self._values, self.device)
                    self._tier_key = key
                else:
                    metrics.count("tier_values.reused")
                tiers = self._tier_vals
            if compute_dtype == torch.bfloat16:
                P.with_bf16_cells(tiers)
            return tiers

    def slot_map(self, name: str) -> torch.Tensor:
        """One of the hybrid plan's slot-space index maps
        (`core.planner.slot_map`), composed on the host at first use and
        kept: they depend on the structure alone, not on the values."""
        if self._hybrid is None:
            raise ValueError("the storage has no hybrid plan")
        if self._slot_maps is None:
            self._slot_maps = {}
        if name not in self._slot_maps:
            with torch.inference_mode(False):
                self._slot_maps[name] = P.slot_map(self._hybrid, name,
                                                   self.device)
        return self._slot_maps[name]

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

    def csc_slot(self) -> torch.Tensor:
        """The CSC slot of each CSR edge, the inverse of `csr2csc`: built
        on first use and kept (the max/min backward writes its winner
        masks in CSC order)."""
        if self._csc_slot is None:
            self._csc_slot = T.invert_permutation(self._csr2csc)
        return self._csc_slot

    def row_split(self) -> SplitPlan:
        """The CSR view's split plan (its rows longer than `SPLIT_CHUNK`
        entries, cut into chunks), for `csr_spmm` over rowptr and col."""
        return self._row_split

    def col_split(self) -> SplitPlan:
        """The CSC view's split plan, for `csr_spmm` over colptr and row."""
        return self._col_split

    def coo_row(self) -> torch.Tensor:
        """Per-edge row ids in CSR order."""
        return self._coo_row

    def degrees(self) -> torch.Tensor:
        """Row degrees, [num_rows] int32."""
        return T.row_degrees(self._rowptr)

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
        build_plans: bool = True,
    ):
        self.storage = Storage(rowptr=rowptr, col=col, values=values,
                               row=row, sparse_sizes=sparse_sizes,
                               device=device, build_plans=build_plans)
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
                 device=None, build_plans: bool = True) -> "SparseTensor":
        return cls(rowptr=rowptr, col=col, values=values,
                   has_value=values is not None, sparse_sizes=sparse_sizes,
                   device=device, build_plans=build_plans)

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
        """Transpose, reusing the cached CSC view (no re-sort); the
        transpose has no hybrid plan."""
        src = self.storage
        perm = src.csr2csc()
        vals = None
        if self.has_value and src.values() is not None:
            vals = src.values()[perm.long()]
        st = src._replace(
            rowptr=src.colptr(), col=src.row(), values=vals,
            colptr=src.rowptr(), row_csc=src.col(),
            csr2csc=T.invert_permutation(perm), csc_slot=perm,
            # the transpose's edge-order arrays are the original's CSC twins
            coo_row=src.csc_col(), csc_col=src.coo_row(),
            row_split=src.col_split(), col_split=src.row_split(),
            num_rows=src.num_cols, num_cols=src.num_rows,
            # the tuner's entries are for the original structure
            tune_key=None,
            hybrid=None, tier_vals=None, tier_ones=None, tier_key=None,
            slot_maps=None)
        return SparseTensor._wrap(st, self.has_value)

    def to(self, device) -> "SparseTensor":
        return SparseTensor._wrap(self.storage.to(device), self.has_value)

    def set_values(self, values: Optional[torch.Tensor]) -> "SparseTensor":
        """A SparseTensor sharing this one's structure with new values
        (None: implicit ones). The values keep their autograd history, so
        computed edge weights can become an SpMM's differentiable values.
        A hybrid storage drops its tier values cached for the old values;
        the new ones are materialized on their device at first use."""
        if values is not None and values.shape[0] != self.nnz:
            raise ValueError(
                f"{values.shape[0]} values for {self.nnz} edges")
        return SparseTensor._wrap(
            self.storage._replace(values=values, tier_vals=None,
                                  tier_key=None),
            values is not None)

    # --- shape ---
    def sparse_sizes(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    @property
    def shape(self) -> Tuple[int, int]:
        return self.storage.sparse_sizes()

    @property
    def nnz(self) -> int:
        return self.storage.nnz

    @property
    def device(self) -> torch.device:
        return self.storage.device

    def validate(self) -> "SparseTensor":
        """Check the CSR invariants on host copies, with the messages of
        `dgsparse_tpu/core/formats.py::SparseTensor.validate`; raises
        ValueError on a violation. `utils/debug.py` runs it before an op's
        first launch: an out-of-range index that reached a kernel would be
        an illegal address, which poisons the CUDA context."""
        st = self.storage
        _check_csr(_host(st.rowptr()), _host(st.col()),
                   self.sparse_sizes()[1], self.nnz)
        if self.has_value and st.values() is not None \
                and st.values().shape[0] != self.nnz:
            raise ValueError("values length != nnz")
        return self

    def __repr__(self) -> str:
        m, n = self.sparse_sizes()
        return (f"SparseTensor(shape=({m}, {n}), nnz={self.nnz}, "
                f"has_value={self.has_value}, device={self.device})")
