"""CSR SpMM (SUM/MEAN, one or H heads) and CSR segment sum: the Hopper
kernel and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_spmm.py::segment_matmul` and of
the `spmm_esc`/`gspmm_esc` (MUL) and `spmm_esc_mh` forwards that drive it.
The kernel is `csrc/spmm_csr.cu` (CUDA C++, sm_90a), built by `_build.py`
and called through ctypes on PyTorch's current stream. Run over the CSC
view (colptr, row, values permuted by csr2csc) it is the transpose the
backward needs.

Routing: `csr_spmm` and `segment_sum_csr` take the plain version in
`kernels/reference.py` for tensors on the CPU, and launch the kernel for
tensors on a CUDA device. On CUDA they launch or raise (no nvcc, a failed
build, a refused launch); nothing falls back to the plain version there.
`LAUNCHES` counts kernel launches per entry point.
"""

import ctypes
import functools
from typing import Optional

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce

LAUNCHES = {"csr_spmm": 0, "segment_sum_csr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spmm_csr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_csr_spmm.argtypes = [i, i, p, p, p, p, p, i, i, i, i, p]
    lib.dg_csr_spmm.restype = i
    lib.dg_segment_sum_csr.argtypes = [i, i, p, p, p, i, i, p]
    lib.dg_segment_sum_csr.restype = i
    return lib


# --- csr_spmm ----------------------------------------------------------------

def csr_spmm_plain(rowptr, col, values, dense, reduce=ReduceOp.SUM,
                   coo_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch `csr_spmm` (index_add_ over coo_row, edge-chunked)."""
    reduce = as_reduce(reduce)
    if coo_row is None:
        coo_row = expand_rowptr(rowptr, col.shape[0])
    num_rows = rowptr.shape[0] - 1
    degrees = rowptr[1:] - rowptr[:-1] if reduce == ReduceOp.MEAN else None
    heads = _launch.heads_of(values, dense.shape[1])
    if heads > 1:
        n, hf = dense.shape
        out = reference.spmm_mh(coo_row, col, values,
                                dense.reshape(n, heads, hf // heads),
                                num_rows, reduce, degrees)
        return out.reshape(num_rows, hf)
    if values is not None:
        values = values.reshape(-1)             # [nnz] or [nnz, 1]
    out, _ = reference.spmm_forward(coo_row, col, values, dense, num_rows,
                                    reduce, degrees)
    return out


def csr_spmm_cuda(rowptr, col, values, dense,
                  reduce=ReduceOp.SUM) -> torch.Tensor:
    """The kernel: out[m] = sum_{e in row m} values[e] * dense[col[e]]
    (values None means 1.0; values [nnz, H] scale feature j by
    values[e, j // (F / H)]), MEAN divides by max(deg, 1). Raises unless
    every tensor is on one CUDA device with the types it takes."""
    reduce = as_reduce(reduce)
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise NotImplementedError(f"csr_spmm handles SUM/MEAN, got {reduce}")
    _launch.check_device(dense.device, rowptr=rowptr, col=col, values=values,
                         dense=dense)
    _launch.check_dense("dense", dense)
    _launch.check_index("rowptr", rowptr)
    _launch.check_index("col", col)
    num_rows = rowptr.shape[0] - 1
    feat = dense.shape[1]
    heads = _launch.heads_of(values, feat)
    _launch.check_values("values", values, col.shape[0])
    if num_rows == 0 or col.numel() == 0 or feat == 0:
        # a zero-size grid is an invalid launch: nothing to launch
        return torch.zeros((num_rows, feat), dtype=dense.dtype,
                           device=dense.device)
    out = torch.empty((num_rows, feat), dtype=dense.dtype,
                      device=dense.device)
    err = _lib().dg_csr_spmm(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        rowptr.data_ptr(), col.data_ptr(),
        None if values is None else values.data_ptr(),
        dense.data_ptr(), out.data_ptr(), num_rows, feat, heads,
        int(reduce == ReduceOp.MEAN), _launch.stream(dense.device))
    _launch.raise_on(err, "csr_spmm")
    LAUNCHES["csr_spmm"] += 1
    return out


def csr_spmm(rowptr, col, values, dense, reduce=ReduceOp.SUM,
             coo_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSR SpMM: the plain version on the CPU, the kernel on CUDA."""
    if dense.device.type == "cpu":
        return csr_spmm_plain(rowptr, col, values, dense, reduce, coo_row)
    return csr_spmm_cuda(rowptr, col, values, dense, reduce)


# --- segment_sum_csr ---------------------------------------------------------

def segment_sum_csr_plain(rowptr, contrib,
                          coo_row: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain PyTorch `segment_sum_csr` (index_add_ over coo_row)."""
    if coo_row is None:
        coo_row = expand_rowptr(rowptr, contrib.shape[0])
    out, _ = reference.segment_reduce(contrib, coo_row, rowptr.shape[0] - 1,
                                      ReduceOp.SUM)
    return out


def segment_sum_csr_cuda(rowptr, contrib) -> torch.Tensor:
    """The kernel: out[m] = sum of contrib[rowptr[m]:rowptr[m+1]] (rows of
    contributions already in CSR edge order)."""
    _launch.check_device(contrib.device, rowptr=rowptr, contrib=contrib)
    _launch.check_dense("contrib", contrib)
    _launch.check_index("rowptr", rowptr)
    num_rows = rowptr.shape[0] - 1
    feat = contrib.shape[1]
    if num_rows == 0 or contrib.shape[0] == 0 or feat == 0:
        return torch.zeros((num_rows, feat), dtype=contrib.dtype,
                           device=contrib.device)
    out = torch.empty((num_rows, feat), dtype=contrib.dtype,
                      device=contrib.device)
    err = _lib().dg_segment_sum_csr(
        _launch.DTYPE_CODE[contrib.dtype], contrib.device.index or 0,
        rowptr.data_ptr(), contrib.data_ptr(), out.data_ptr(), num_rows,
        feat, _launch.stream(contrib.device))
    _launch.raise_on(err, "segment_sum_csr")
    LAUNCHES["segment_sum_csr"] += 1
    return out


def segment_sum_csr(rowptr, contrib,
                    coo_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted segment sum: the plain version on the CPU, the kernel on
    CUDA."""
    if contrib.device.type == "cpu":
        return segment_sum_csr_plain(rowptr, contrib, coo_row)
    return segment_sum_csr_cuda(rowptr, contrib)
