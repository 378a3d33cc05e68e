"""Blocked-ELL SpMM (SUM/MEAN): the Hopper kernel of the hybrid plan's
middle tier and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_spmm.py::spmm_bell` over a
`core/planner.py::BellPlan` (no chunking: the TPU chunked its tile stream
for its scalar-prefetch memory). The kernel is `csrc/spmm_bell.cu` (CUDA
C++, sm_90a), built by `_build.py` and called through ctypes on PyTorch's
current stream; the plain version is `kernels/reference.py::spmm_bell`.
The kernel sums; MEAN scales the slot values by their row's degree first,
as the JAX function does (`:874-881`).

Routing as in `spmm_csr.py`: the plain version for tensors on the CPU, the
kernel (or an exception) for tensors on a CUDA device. `LAUNCHES` counts
kernel launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from dgsparse_tpu_torch.core.planner import BellPlan
from dgsparse_tpu_torch.kernels import _launch, reference
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce

LAUNCHES = {"spmm_bell": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spmm_bell")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_spmm_bell.argtypes = [i, i, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dg_spmm_bell.restype = i
    return lib


def _slot_values(plan: BellPlan, vals: torch.Tensor, reduce,
                 degrees: Optional[torch.Tensor]) -> torch.Tensor:
    """The slot values [T*E] float32, divided by their row's max(deg, 1)
    for MEAN."""
    reduce = as_reduce(reduce)
    if reduce not in (ReduceOp.SUM, ReduceOp.MEAN):
        raise ValueError(f"spmm_bell handles SUM/MEAN, got {reduce}")
    if vals.shape != (plan.padded_edges,):
        raise ValueError(f"vals must be [{plan.padded_edges}], got "
                         f"{tuple(vals.shape)}")
    vals = vals.float()
    if reduce == ReduceOp.MEAN:
        if degrees is None:
            raise ValueError("degrees required for MEAN")
        rows = plan.tile_rb.long().repeat_interleave(plan.edge_tile) \
            * plan.row_block + plan.lrow.long()
        deg = torch.clamp(degrees, min=1).float()
        vals = vals / deg[torch.clamp(rows, max=plan.num_rows - 1)]
    return vals.contiguous()


def spmm_bell_plain(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
                    reduce=ReduceOp.SUM,
                    degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch `spmm_bell` (per-slot gather and index_add_)."""
    return reference.spmm_bell(plan.tile_rb, plan.tile_cw, plan.lcol,
                               plan.lrow,
                               _slot_values(plan, vals, reduce, degrees),
                               dense, plan.num_rows, plan.row_block,
                               plan.col_window)


def spmm_bell_cuda(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
                   reduce=ReduceOp.SUM,
                   degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: float32 out [M, F], each slot's vals[e] * dense[window
    row] summed into its row (vals 0 on padding; MEAN divides by the row's
    degree). Raises unless every tensor is on one CUDA device with the types
    it takes."""
    _launch.check_device(dense.device, vals=vals, dense=dense,
                         tile_ptr=plan.tile_ptr, lcol=plan.lcol)
    _launch.check_dense("dense", dense)
    if dense.shape[0] != plan.num_cols:
        raise ValueError(f"dense has {dense.shape[0]} rows, expected "
                         f"{plan.num_cols}")
    v = _slot_values(plan, vals, reduce, degrees)
    feat = dense.shape[1]
    if plan.num_rows == 0 or feat == 0 or plan.num_tiles == 0:
        return torch.zeros((plan.num_rows, feat), dtype=torch.float32,
                           device=dense.device)
    out = torch.empty((plan.num_rows, feat), dtype=torch.float32,
                      device=dense.device)
    err = _lib().dg_spmm_bell(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        plan.tile_ptr.data_ptr(), plan.tile_cw.data_ptr(),
        plan.lcol.data_ptr(), plan.lrow.data_ptr(), v.data_ptr(),
        dense.data_ptr(), out.data_ptr(), plan.num_row_blocks,
        plan.edge_tile, plan.num_rows, plan.num_cols, feat,
        _launch.stream(dense.device))
    _launch.raise_on(err, "spmm_bell")
    LAUNCHES["spmm_bell"] += 1
    return out


def spmm_bell(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
              reduce=ReduceOp.SUM,
              degrees: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BELL SpMM: the plain version on the CPU, the kernel on CUDA."""
    if dense.device.type == "cpu":
        return spmm_bell_plain(plan, vals, dense, reduce, degrees)
    return spmm_bell_cuda(plan, vals, dense, reduce, degrees)
