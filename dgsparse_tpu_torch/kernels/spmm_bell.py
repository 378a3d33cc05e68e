"""Blocked-ELL SpMM (SUM/MEAN): the Hopper kernel of the hybrid plan's
middle tier and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_spmm.py::spmm_bell` over a
`core/planner.py::BellPlan` (no chunking: the TPU chunked its tile stream
for its scalar-prefetch memory). The kernel is `csrc/spmm_bell.cu` (CUDA
C++, sm_90a), built by `_build.py` and called through ctypes on PyTorch's
current stream; the plain version is `kernels/reference.py::spmm_bell`.
The kernel sums; MEAN scales the slot values by their row's degree first,
as the JAX function does (`:874-881`).

The kernel walks the plan's row runs and adds into a float32 `out` in
place: given `out`, only the rows with BELL edges change (the hybrid SpMM
passes its tier sum); without it, the wrapper adds into fresh zeros. Short
rows take a group of lanes each on `spmm_csr.spmm_path`'s mapping; rows of
`core.planner.LONG_ROW_SLOTS` slots or more a warp each, 32 features of
`long_vec` elements a warp, in a grid that the short rows' grid overlaps.

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
from dgsparse_tpu_torch.kernels.spmm_csr import spmm_path, widest_vec
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
    lib.dg_spmm_bell.argtypes = [i, i, p, p, p, p, p, p, p, p, p, i, i, i,
                                 i, i, i, i, i, i, p]
    lib.dg_spmm_bell.restype = i
    return lib


def long_vec(feat: int, itemsize: int, align: int = 16) -> int:
    """Elements a lane loads on the long rows (one warp a row, 32 vectors
    a feature slice): the widest load of at most 4 bytes that divides the
    width, so that a lane holds many slots' gathers in flight."""
    return widest_vec(feat, 1, itemsize, min(align, 4))


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


def _check_out(plan: BellPlan, out: torch.Tensor,
               dense: torch.Tensor) -> None:
    """`out` must be float32 [M, F], contiguous, on dense's device."""
    want = (plan.num_rows, dense.shape[1])
    if out.dtype != torch.float32 or tuple(out.shape) != want:
        raise ValueError(f"out must be float32 {list(want)}, got "
                         f"{out.dtype} {list(out.shape)}")
    if out.device != dense.device:
        raise ValueError(f"out is on {out.device}, expected {dense.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


def spmm_bell_plain(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
                    reduce=ReduceOp.SUM,
                    degrees: Optional[torch.Tensor] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch `spmm_bell` (per-slot gather and index_add_), added
    into `out` in place where it is given."""
    if out is not None:
        _check_out(plan, out, dense)
    part = reference.spmm_bell(plan.tile_rb, plan.tile_cw, plan.lcol,
                               plan.lrow,
                               _slot_values(plan, vals, reduce, degrees),
                               dense, plan.num_rows, plan.row_block,
                               plan.col_window)
    return part if out is None else out.add_(part)


def spmm_bell_cuda(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
                   reduce=ReduceOp.SUM,
                   degrees: Optional[torch.Tensor] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel: out[row] += each slot's vals[e] * dense[window row]
    summed over the row's runs (vals 0 on padding; MEAN divides by the
    row's degree), for the rows with BELL edges, in place; `out` None
    means fresh zeros. Returns out. Raises unless every tensor is on one
    CUDA device with the types it takes."""
    _launch.check_device(dense.device, vals=vals, dense=dense,
                         run_ptr=plan.run_ptr, lcol=plan.lcol,
                         rows=plan.rows)
    _launch.check_dense("dense", dense)
    if dense.shape[0] != plan.num_cols:
        raise ValueError(f"dense has {dense.shape[0]} rows, expected "
                         f"{plan.num_cols}")
    if out is not None:
        _check_out(plan, out, dense)
    v = _slot_values(plan, vals, reduce, degrees)
    feat = dense.shape[1]
    if plan.num_bell_rows == 0 or feat == 0:
        # a zero-size grid is an invalid launch: nothing to launch
        return out if out is not None else torch.zeros(
            (plan.num_rows, feat), dtype=torch.float32, device=dense.device)
    if out is None:
        out = torch.zeros((plan.num_rows, feat), dtype=torch.float32,
                          device=dense.device)
    align = _launch.alignment(dense, out)
    err = _lib().dg_spmm_bell(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        plan.rows.data_ptr(), plan.run_ptr.data_ptr(),
        plan.run_slot.data_ptr(), plan.run_len.data_ptr(),
        plan.tile_cw.data_ptr(), plan.lcol.data_ptr(), v.data_ptr(),
        dense.data_ptr(), out.data_ptr(),
        plan.num_bell_rows - plan.num_long_rows, plan.num_long_rows, feat,
        plan.edge_tile, plan.col_window,
        *spmm_path(feat, 1, dense.element_size(), align),
        long_vec(feat, dense.element_size(), align),
        _launch.stream(dense.device))
    _launch.raise_on(err, "spmm_bell")
    LAUNCHES["spmm_bell"] += 1
    return out


def spmm_bell(plan: BellPlan, vals: torch.Tensor, dense: torch.Tensor,
              reduce=ReduceOp.SUM, degrees: Optional[torch.Tensor] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BELL SpMM, added into `out` in place where it is given: the plain
    version on the CPU, the kernel on CUDA."""
    if dense.device.type == "cpu":
        return spmm_bell_plain(plan, vals, dense, reduce, degrees, out)
    return spmm_bell_cuda(plan, vals, dense, reduce, degrees, out)
