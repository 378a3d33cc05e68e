"""CSR SDDMM (one or H heads): the Hopper kernel and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_sddmm.py::sddmm_esc` and of
the XLA SDDMM the JAX package runs for `sddmm`, for the SpMM's `d_values`
(`kernels/xla.py::sddmm_chunked`) and for the multi-head SpMM's `d_values`
(`ops/spmm_mh.py`). The kernel is `csrc/sddmm_csr.cu` (CUDA C++, sm_90a):
out[e, h] = dot(d1[row_e, h], d2[col_e, h]) over F features per head, for
d1 [M, H*F] and d2 [N, H*F], float32 [nnz, H] in CSR edge order; MEAN
divides by max(deg, 1).

Routing as in `spmm_csr.py`: the plain version for CPU tensors, the kernel
(or an exception) for CUDA tensors. `LAUNCHES` counts kernel launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce

LAUNCHES = {"sddmm_csr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("sddmm_csr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_sddmm_csr.argtypes = [i, i, p, p, p, p, p, i, i, i, i, p]
    lib.dg_sddmm_csr.restype = i
    return lib


def _check_shapes(rowptr, col, d1, d2, heads: int) -> None:
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(
            f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be [M, H*F] "
            "and [N, H*F]")
    if d1.shape[0] != rowptr.shape[0] - 1:
        raise ValueError(f"d1 has {d1.shape[0]} rows, the sparse matrix "
                         f"{rowptr.shape[0] - 1}")
    if heads < 1 or d1.shape[1] % heads:
        raise ValueError(f"{heads} heads do not divide width {d1.shape[1]}")


def sddmm_csr_plain(rowptr, col, d1, d2, heads: int = 1,
                    reduce=ReduceOp.SUM,
                    coo_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch `sddmm_csr` (two row gathers, edge-chunked)."""
    reduce = as_reduce(reduce)
    _check_shapes(rowptr, col, d1, d2, heads)
    if coo_row is None:
        coo_row = expand_rowptr(rowptr, col.shape[0])
    degrees = rowptr[1:] - rowptr[:-1] if reduce == ReduceOp.MEAN else None
    f = d1.shape[1] // heads
    out = reference.sddmm_chunked(
        coo_row, col, d1.reshape(d1.shape[0], heads, f),
        d2.reshape(d2.shape[0], heads, f), reduce, degrees)
    return out.reshape(col.shape[0], heads)


def sddmm_csr_cuda(rowptr, col, d1, d2, heads: int = 1,
                   reduce=ReduceOp.SUM) -> torch.Tensor:
    """The kernel: float32 [nnz, heads] per-edge, per-head dots. Raises
    unless every tensor is on one CUDA device with the types it takes."""
    reduce = as_reduce(reduce)
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise NotImplementedError(f"sddmm_csr handles SUM/MEAN, got {reduce}")
    _launch.check_device(d1.device, rowptr=rowptr, col=col, d1=d1, d2=d2)
    _launch.check_dense("d1", d1)
    _launch.check_dense("d2", d2)
    if d1.dtype != d2.dtype:
        raise TypeError(f"d1 is {d1.dtype} and d2 {d2.dtype}; they must match")
    _launch.check_index("rowptr", rowptr)
    _launch.check_index("col", col)
    _check_shapes(rowptr, col, d1, d2, heads)
    num_rows = rowptr.shape[0] - 1
    nnz = col.shape[0]
    feat = d1.shape[1] // heads
    if num_rows == 0 or nnz == 0 or feat == 0:
        return torch.zeros((nnz, heads), dtype=torch.float32,
                           device=d1.device)
    out = torch.empty((nnz, heads), dtype=torch.float32, device=d1.device)
    err = _lib().dg_sddmm_csr(
        _launch.DTYPE_CODE[d1.dtype], d1.device.index or 0,
        rowptr.data_ptr(), col.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        out.data_ptr(), num_rows, heads, feat,
        int(reduce == ReduceOp.MEAN), _launch.stream(d1.device))
    _launch.raise_on(err, "sddmm_csr")
    LAUNCHES["sddmm_csr"] += 1
    return out


def sddmm_csr(rowptr, col, d1, d2, heads: int = 1, reduce=ReduceOp.SUM,
              coo_row: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CSR SDDMM: the plain version on the CPU, the kernel on CUDA."""
    if d1.device.type == "cpu":
        return sddmm_csr_plain(rowptr, col, d1, d2, heads, reduce, coo_row)
    return sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce)
