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
- `spmm_maxmin_d_values`: per edge and head, the sum of g over the
  elements the edge won, times dense[col[e]] in "dot" mode (MUL/DIV) or
  not ("sum" mode, ADD/SUB); the caller applies the rest of the partial.

Routing as in `spmm_csr.py`: the plain version (`kernels/reference.py`)
for tensors on the CPU, the kernel (or an exception) for tensors on a
CUDA device. `LAUNCHES` counts kernel launches per entry point.
"""

import ctypes
import functools
from typing import Optional, Tuple

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference
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
                                   p]
    lib.dg_maxmin_d_dense.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, p]
    lib.dg_maxmin_d_values.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i, p]
    for fn in (lib.dg_spmm_maxmin, lib.dg_maxmin_d_dense,
               lib.dg_maxmin_d_values):
        fn.restype = i
    return lib


def _maxmin(reduce) -> ReduceOp:
    reduce = as_reduce(reduce)
    if reduce not in (ReduceOp.MAX, ReduceOp.MIN):
        raise ValueError(f"spmm_maxmin reduces by MAX or MIN, got {reduce}")
    return reduce


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
                     compute=ComputeOp.MUL
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel: (out, arg) as the module says. Raises unless every
    tensor is on one CUDA device with the types it takes."""
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
    err = _lib().dg_spmm_maxmin(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        0 if values is None else _COMPUTE_CODE[as_compute(compute)],
        int(reduce == ReduceOp.MIN), rowptr.data_ptr(), col.data_ptr(),
        None if values is None else values.data_ptr(), dense.data_ptr(),
        out.data_ptr(), arg.data_ptr(), num_rows, feat, heads, nnz,
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


def spmm_maxmin_d_dense_cuda(colptr, row_csc, perm, weights_csc, arg,
                             g) -> torch.Tensor:
    """The kernel: d_dense [N, F] in g's dtype, one warp per CSC column,
    no atomics."""
    _launch.check_device(g.device, colptr=colptr, row_csc=row_csc, perm=perm,
                         weights_csc=weights_csc, arg=arg, g=g)
    _launch.check_dense("g", g)
    for name, t in (("colptr", colptr), ("row_csc", row_csc), ("perm", perm)):
        _launch.check_index(name, t)
    if arg.dtype != torch.int32 or arg.shape != g.shape:
        raise TypeError(f"arg must be int32 of g's shape {tuple(g.shape)}")
    num_cols, nnz, feat = colptr.shape[0] - 1, row_csc.shape[0], g.shape[1]
    heads = _launch.heads_of(weights_csc, feat)
    _launch.check_values("weights_csc", weights_csc, nnz)
    if num_cols == 0 or nnz == 0 or feat == 0:
        return torch.zeros((num_cols, feat), dtype=g.dtype, device=g.device)
    out = torch.empty((num_cols, feat), dtype=g.dtype, device=g.device)
    err = _lib().dg_maxmin_d_dense(
        _launch.DTYPE_CODE[g.dtype], g.device.index or 0, colptr.data_ptr(),
        row_csc.data_ptr(), perm.data_ptr(),
        None if weights_csc is None else weights_csc.data_ptr(),
        g.data_ptr(), arg.data_ptr(), out.data_ptr(), num_cols, feat, heads,
        _launch.stream(g.device))
    _launch.raise_on(err, "spmm_maxmin_d_dense")
    LAUNCHES["spmm_maxmin_d_dense"] += 1
    return out


def spmm_maxmin_d_dense(colptr, row_csc, perm, weights_csc, arg, g,
                        csc_col: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The MAX/MIN backward's d_dense: the plain version on the CPU, the
    kernel on CUDA."""
    if g.device.type == "cpu":
        return spmm_maxmin_d_dense_plain(colptr, row_csc, perm, weights_csc,
                                         arg, g, csc_col)
    return spmm_maxmin_d_dense_cuda(colptr, row_csc, perm, weights_csc, arg,
                                    g)


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
