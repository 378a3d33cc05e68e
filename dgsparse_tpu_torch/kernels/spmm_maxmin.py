"""CSR SpMM with MAX/MIN reductions and its masked backward: the Hopper
kernels and their plain versions.

Counterpart of `dgsparse_tpu/kernels/pallas_spmm_maxmin.py::spmm_maxmin_esc`
(forward) and of the edge-space winner-mask backward of
`dgsparse_tpu/ops/spmm.py` (`:439-528`) and `ops/gspmm.py` (`:191-212`).
The kernels are `csrc/spmm_maxmin.cu` (CUDA C++, sm_90a), built by
`_build.py` and called through ctypes on PyTorch's current stream:

- `spmm_maxmin`: out [M, F] and arg [M, F] int32, per element the
  max/min over the row's edges of compute(values[e], dense[col[e]]) and the
  CSR edge id of the earliest winner (nnz for an empty row, whose out is
  0). compute is ADD, SUB, MUL or DIV (SUB = feat - edge, DIV =
  feat / edge); values None is copy_u. values [nnz, H] give H heads over
  dense [N, H*F], as in `spmm_csr.csr_spmm`.
- `spmm_maxmin_d_dense`: d_dense [N, F] over the CSC view, each element's
  gradient sent to the column of its winning edge, scaled by the per-edge
  partial of compute in the feature (weights in CSC order; None for 1).
  On graphs of long enough rows the kernel first turns arg into winner
  masks, `mask_words(F)` uint32 words an edge in CSC order (scratch it
  allocates), reading each row's arg once, then sums each column's won
  elements from the masks on `d_dense_path`.
- `spmm_maxmin_d_values`: per edge and head, the sum of g over the
  elements the edge won, times dense[col[e]] in "dot" mode (MUL/DIV) or
  not ("sum" mode, ADD/SUB); the caller applies the rest of the partial.

The forward's path, (vec, group, nv): `vec` elements a load, `group`
lanes a row, `nv` vectors a lane, is chosen here by `maxmin_path`, a pure
function of the width, the heads, the dtype and the pointers' alignment,
so that the CPU tests can check it: a feature slice of `group * nv * vec`
features, at most SLICE_BYTES of a row, and the grid's slowest dimension,
so that one slice of X stays in L2 while every row gathers from it.
d_dense's column pass walks the columns on the same kind of path, chosen
by `d_dense_path`, so that one slice of g stays in L2 while every column
gathers from it; `pick_d_dense` runs it where the rows are long enough
for the masks to pay, and one warp a column elsewhere.

Routing as in `spmm_csr.py`: the plain version (`kernels/reference.py`)
for tensors on the CPU, the kernel (or an exception) for tensors on a
CUDA device. `LAUNCHES` counts kernel launches per entry point.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference, spmm_csr
from dgsparse_tpu_torch.ops.types import (ComputeOp, ReduceOp, as_compute,
                                          as_reduce)

LAUNCHES = {"spmm_maxmin": 0, "spmm_maxmin_d_dense": 0,
            "spmm_maxmin_d_values": 0}

# the C interface's compute codes; 0 is copy_u (values None)
_COMPUTE_CODE = {ComputeOp.ADD: 1, ComputeOp.SUB: 2, ComputeOp.MUL: 3,
                 ComputeOp.DIV: 4}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spmm_maxmin")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_spmm_maxmin.argtypes = [i, i, i, i, p, p, p, p, p, p, i, i, i, i,
                                   i, i, i, p]
    lib.dg_maxmin_d_dense.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.dg_maxmin_d_dense_masked.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                             p, i, i, i, i, i, i, i, i, p]
    lib.dg_maxmin_d_values.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, p]
    for fn in (lib.dg_spmm_maxmin, lib.dg_maxmin_d_dense,
               lib.dg_maxmin_d_dense_masked, lib.dg_maxmin_d_values):
        fn.restype = i
    return lib


def _maxmin(reduce) -> ReduceOp:
    reduce = as_reduce(reduce)
    if reduce not in (ReduceOp.MAX, ReduceOp.MIN):
        raise ValueError(f"spmm_maxmin reduces by MAX or MIN, got {reduce}")
    return reduce


# --- the forward's path -----------------------------------------------------

# bytes of a row in one feature slice: a slice of X (arxiv: 169,343 rows x
# 256 B = 43.4 MB) stays within an H100's 50 MB L2 while every row
# gathers from it
SLICE_BYTES = 256
MAX_VECTORS = 2         # vectors a lane (kMaxVectors in csrc/spmm_maxmin.cu)
MASK_BITS = 32          # features a winner-mask word of d_dense covers
# `path` of spmm_maxmin_d_dense_cuda for the one-warp-a-column kernel
WARP_PER_COLUMN = "warp_per_column"
MASK_MIN_DEGREE = 4     # edges a row on average for the winner masks
L2_BYTES = 50 * 2 ** 20  # an H100's L2


def slices_cross_heads(slice_vecs: int, feat_vecs: int, heads: int) -> bool:
    """Whether slices of `slice_vecs` vectors over a row of `feat_vecs`
    split some head between two slices while holding part of another."""
    head_vecs = feat_vecs // heads
    return (heads > 1 and slice_vecs < feat_vecs
            and slice_vecs % head_vecs != 0 and head_vecs % slice_vecs != 0)


@functools.lru_cache(maxsize=None)
def maxmin_path(feat: int, heads: int, itemsize: int, align: int = 16,
                slice_bytes: int = SLICE_BYTES):
    """(vec, group, nv) of the forward for a width `feat` of `heads` heads.
    Over the loads of at most 16 bytes and `align` whose element count
    divides the head width, the groups and the vectors a lane, with
    slices of at most `slice_bytes` of a row (or one narrowest group):
    slices that hold whole heads or lie inside one head where some do;
    then the fewest slices (each re-reads the rows' col); the fewest
    features a slice times slices (idle lanes); the widest group (fewer
    rows a warp wait on its longest); the widest load. A group is at
    least 8 lanes where the row has 8 vectors. On an H100 at arxiv F = 256
    (fp32) one row a warp of 8-byte loads over 256-byte slices, (2, 32,
    1), beat 16 lanes of 16 bytes, (4, 16, 1), and 8 lanes over 128-byte
    slices, (4, 8, 1) (`chip_smoke.py` phase 7 times the slice widths)."""
    best = None
    vec = spmm_csr.widest_vec(feat, heads, itemsize, align)
    while vec >= 1:
        nvec = feat // vec
        least = 8 if nvec >= 8 else 4
        budget = max(slice_bytes // (vec * itemsize), least)
        for group in spmm_csr.GROUPS:
            for nv in range(1, MAX_VECTORS + 1):
                sv = group * nv
                if group < least or sv > budget:
                    continue
                slices = -(-nvec // sv)
                key = (slices_cross_heads(sv, nvec, heads), slices,
                       slices * sv * vec, -group, -vec)
                if best is None or key < best[0]:
                    best = (key, (vec, group, nv))
        vec //= 2
    return best[1]


@functools.lru_cache(maxsize=None)
def d_dense_path(feat: int, heads: int, itemsize: int, align: int = 16):
    """(vec, group, nv) of d_dense's column pass: the widest load, one
    vector a lane, and the narrowest group that spans the row or a slice
    of at most SLICE_BYTES; past 32 lanes, a second vector a lane. (On
    an H100 at arxiv F = 256, 16-byte loads over 64-feature slices ran
    the columns faster than the forward's 8-byte path.)"""
    vec = spmm_csr.widest_vec(feat, heads, itemsize, align)
    want = min(feat // vec, max(SLICE_BYTES // (vec * itemsize), 4))
    group = next((g for g in sorted(spmm_csr.GROUPS) if g >= want), None)
    if group is None:
        return vec, 32, min(MAX_VECTORS, -(-want // 32))
    return vec, group, 1


def pick_d_dense(feat: int, heads: int, itemsize: int, align: int,
                 nnz: int, num_rows: int):
    """The mapping of d_dense for `nnz` edges over `num_rows` CSR rows:
    the winner masks and `d_dense_path` where they pay, else
    WARP_PER_COLUMN, which re-reads a row's arg [F] int32 for every edge
    of the row. The masks pay where the rows average MASK_MIN_DEGREE
    edges or more (re-reads to save), arg outgrows L2 by half again (the
    re-reads miss it) and the masks fit in it (their scattered stores
    stay there). Over 62 shapes on an H100 (`utils/path_sweep.py`:
    62,586-400,000 rows, 1.1-11 edges a row, F = 32-256) this picked the
    slower mapping at 12, by at most 13 %: mostly F = 32 and 64 on rows
    of 7 or more edges, where the masks won by 3-13 %."""
    if (nnz < MASK_MIN_DEGREE * num_rows
            or 2 * 4 * num_rows * feat <= 3 * L2_BYTES
            or 4 * nnz * mask_words(feat) > L2_BYTES):
        return WARP_PER_COLUMN
    return d_dense_path(feat, heads, itemsize, align)


def slice_words(path) -> int:
    """Mask words a column-pass slice of `path` reads, stored together a
    CSC slot (`slice_words` in csrc/spmm_maxmin.cu)."""
    vec, group, nv = path
    return max(1, group * nv * vec // MASK_BITS)


# --- spmm_maxmin (forward) ---------------------------------------------------

def spmm_maxmin_plain(rowptr, col, values, dense, reduce=ReduceOp.MAX,
                      compute=ComputeOp.MUL,
                      coo_row: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch `spmm_maxmin` (scatter_reduce, edge-chunked)."""
    reduce, compute = _maxmin(reduce), as_compute(compute)
    _launch.heads_of(values, dense.shape[1])
    if coo_row is None:
        coo_row = expand_rowptr(rowptr, col.shape[0])
    return reference.maxmin_forward(coo_row, col, values, dense,
                                    rowptr.shape[0] - 1, reduce, compute)


def spmm_maxmin_cuda(rowptr, col, values, dense, reduce=ReduceOp.MAX,
                     compute=ComputeOp.MUL, path=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (out, arg) as the module says, on `path` (default
    `maxmin_path`). Raises unless every tensor is on one CUDA device with
    the types it takes."""
    reduce = _maxmin(reduce)
    _launch.check_device(dense.device, rowptr=rowptr, col=col, values=values,
                         dense=dense)
    _launch.check_dense("dense", dense)
    _launch.check_index("rowptr", rowptr)
    _launch.check_index("col", col)
    num_rows, nnz = rowptr.shape[0] - 1, col.shape[0]
    feat = dense.shape[1]
    heads = _launch.heads_of(values, feat)
    _launch.check_values("values", values, nnz)
    out = torch.empty((num_rows, feat), dtype=dense.dtype,
                      device=dense.device)
    arg = torch.empty((num_rows, feat), dtype=torch.int32,
                      device=dense.device)
    if num_rows == 0 or nnz == 0 or feat == 0:
        # a zero-size grid is an invalid launch: nothing to launch
        return out.zero_(), arg.fill_(nnz)
    if path is None:
        path = maxmin_path(feat, heads, dense.element_size(),
                           _launch.alignment(dense, out))
    err = _lib().dg_spmm_maxmin(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        0 if values is None else _COMPUTE_CODE[as_compute(compute)],
        int(reduce == ReduceOp.MIN), rowptr.data_ptr(), col.data_ptr(),
        None if values is None else values.data_ptr(), dense.data_ptr(),
        out.data_ptr(), arg.data_ptr(), num_rows, feat, heads, nnz, *path,
        _launch.stream(dense.device))
    _launch.raise_on(err, "spmm_maxmin")
    LAUNCHES["spmm_maxmin"] += 1
    return out, arg


def spmm_maxmin(rowptr, col, values, dense, reduce=ReduceOp.MAX,
                compute=ComputeOp.MUL,
                coo_row: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MAX/MIN SpMM with winning edge ids: the plain version on the CPU,
    the kernel on CUDA."""
    if dense.device.type == "cpu":
        return spmm_maxmin_plain(rowptr, col, values, dense, reduce, compute,
                                 coo_row)
    return spmm_maxmin_cuda(rowptr, col, values, dense, reduce, compute)


# --- spmm_maxmin_d_dense -----------------------------------------------------

def spmm_maxmin_d_dense_plain(colptr, row_csc, perm, weights_csc, arg, g,
                              csc_col: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Plain PyTorch `spmm_maxmin_d_dense` (index_add_ over csc_col)."""
    _launch.heads_of(weights_csc, g.shape[1])
    if csc_col is None:
        csc_col = expand_rowptr(colptr, row_csc.shape[0])
    out = reference.maxmin_d_dense(csc_col, row_csc, perm, weights_csc, arg,
                                   g, colptr.shape[0] - 1)
    return out.to(g.dtype)


def mask_words(feat: int) -> int:
    """Winner-mask words an edge: one uint32 per 32 features."""
    return -(-feat // MASK_BITS)


def spmm_maxmin_d_dense_cuda(colptr, row_csc, perm, weights_csc, arg, g,
                             rowptr, slot, path=None) -> torch.Tensor:
    """The kernel: d_dense [N, F] in g's dtype, no atomics, on `path`,
    `pick_d_dense`'s by default: a (vec, group, nv) of `d_dense_path` runs
    the winner-mask pass over the CSR rows (`rowptr`; `slot`, the CSC slot
    of each CSR edge, `Storage.csc_slot()`), then the column pass on it;
    WARP_PER_COLUMN runs one warp a column, which re-reads a row's arg for
    every edge of the row. Counts one launch a call."""
    _launch.check_device(g.device, colptr=colptr, row_csc=row_csc, perm=perm,
                         weights_csc=weights_csc, arg=arg, g=g,
                         rowptr=rowptr, slot=slot)
    _launch.check_dense("g", g)
    for name, t in (("colptr", colptr), ("row_csc", row_csc), ("perm", perm),
                    ("rowptr", rowptr), ("slot", slot)):
        _launch.check_index(name, t)
    if arg.dtype != torch.int32 or arg.shape != g.shape:
        raise TypeError(f"arg must be int32 of g's shape {tuple(g.shape)}")
    num_rows, feat = g.shape
    num_cols, nnz = colptr.shape[0] - 1, row_csc.shape[0]
    heads = _launch.heads_of(weights_csc, feat)
    _launch.check_values("weights_csc", weights_csc, nnz)
    for name, t, n in (("rowptr", rowptr, num_rows + 1), ("slot", slot, nnz),
                       ("perm", perm, nnz)):
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    if num_cols == 0 or nnz == 0 or feat == 0:
        return torch.zeros((num_cols, feat), dtype=g.dtype, device=g.device)
    out = torch.empty((num_cols, feat), dtype=g.dtype, device=g.device)
    w = None if weights_csc is None else weights_csc.data_ptr()
    dtype, device = _launch.DTYPE_CODE[g.dtype], g.device.index or 0
    if path is None:
        path = pick_d_dense(feat, heads, g.element_size(),
                            _launch.alignment(g, out), nnz, num_rows)
    if path == WARP_PER_COLUMN:
        err = _lib().dg_maxmin_d_dense(
            dtype, device, colptr.data_ptr(), row_csc.data_ptr(),
            perm.data_ptr(), w, g.data_ptr(), arg.data_ptr(), out.data_ptr(),
            num_cols, feat, heads, _launch.stream(g.device))
    else:
        sw = slice_words(path)
        mask = torch.empty((-(-mask_words(feat) // sw), nnz, sw),
                           dtype=torch.int32, device=g.device)
        err = _lib().dg_maxmin_d_dense_masked(
            dtype, device, rowptr.data_ptr(), slot.data_ptr(),
            arg.data_ptr(), mask.data_ptr(), colptr.data_ptr(),
            row_csc.data_ptr(), w, g.data_ptr(), out.data_ptr(), num_rows,
            num_cols, nnz, feat, heads, *path, _launch.stream(g.device))
    _launch.raise_on(err, "spmm_maxmin_d_dense")
    LAUNCHES["spmm_maxmin_d_dense"] += 1
    return out


def spmm_maxmin_d_dense(colptr, row_csc, perm, weights_csc, arg, g, rowptr,
                        slot, csc_col: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The MAX/MIN backward's d_dense: the plain version on the CPU (which
    takes `csc_col`), the kernel on CUDA (which takes `rowptr` and
    `slot`)."""
    if g.device.type == "cpu":
        return spmm_maxmin_d_dense_plain(colptr, row_csc, perm, weights_csc,
                                         arg, g, csc_col)
    return spmm_maxmin_d_dense_cuda(colptr, row_csc, perm, weights_csc, arg,
                                    g, rowptr, slot)


# --- spmm_maxmin_d_values ----------------------------------------------------

def spmm_maxmin_d_values_plain(rowptr, col, arg, g, dense, heads: int = 1,
                               coo_row: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Plain PyTorch `spmm_maxmin_d_values` (dense None: "sum" mode)."""
    if coo_row is None:
        coo_row = expand_rowptr(rowptr, col.shape[0])
    return reference.maxmin_d_values(coo_row, col, arg, g, dense, heads)


def spmm_maxmin_d_values_cuda(rowptr, col, arg, g, dense,
                              heads: int = 1) -> torch.Tensor:
    """The kernel: float32 [nnz, heads], one warp per CSR row, masked sums
    reduced by xor shuffles; dense None is "sum" mode."""
    _launch.check_device(g.device, rowptr=rowptr, col=col, arg=arg, g=g,
                         dense=dense)
    _launch.check_dense("g", g)
    _launch.check_index("rowptr", rowptr)
    _launch.check_index("col", col)
    if arg.dtype != torch.int32 or arg.shape != g.shape:
        raise TypeError(f"arg must be int32 of g's shape {tuple(g.shape)}")
    if dense is not None and (dense.dtype != g.dtype
                              or dense.dim() != 2
                              or dense.shape[1] != g.shape[1]):
        raise TypeError("dense must be [N, F] in g's dtype")
    num_rows, nnz, feat = rowptr.shape[0] - 1, col.shape[0], g.shape[1]
    if heads < 1 or feat % heads:
        raise ValueError(f"{heads} heads do not divide width {feat}")
    out = torch.zeros((nnz, heads), dtype=torch.float32, device=g.device)
    if num_rows == 0 or nnz == 0 or feat == 0:
        return out
    err = _lib().dg_maxmin_d_values(
        _launch.DTYPE_CODE[g.dtype], g.device.index or 0,
        int(dense is not None), rowptr.data_ptr(), col.data_ptr(),
        arg.data_ptr(), g.data_ptr(),
        None if dense is None else dense.data_ptr(), out.data_ptr(),
        num_rows, heads, feat // heads, _launch.stream(g.device))
    _launch.raise_on(err, "spmm_maxmin_d_values")
    LAUNCHES["spmm_maxmin_d_values"] += 1
    return out


def spmm_maxmin_d_values(rowptr, col, arg, g, dense, heads: int = 1,
                         coo_row: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """The MAX/MIN backward's masked per-edge sums: the plain version on
    the CPU, the kernel on CUDA."""
    if g.device.type == "cpu":
        return spmm_maxmin_d_values_plain(rowptr, col, arg, g, dense, heads,
                                          coo_row)
    return spmm_maxmin_d_values_cuda(rowptr, col, arg, g, dense, heads)
