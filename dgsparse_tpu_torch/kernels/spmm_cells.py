"""Dense-cell SpMM (forward and transpose) and dense-cell SDDMM: the Hopper
kernels of the hybrid plan's materialized tier and their plain versions.

Counterparts of `dgsparse_tpu/kernels/pallas_spmm.py::spmm_dense_cells`
(with its `materialize_cells`) and `dgsparse_tpu/kernels/pallas_sddmm.py::
sddmm_cells`. The kernels are `csrc/spmm_cells.cu` (CUDA C++, sm_90a),
built by `_build.py` and called through ctypes on PyTorch's current
stream; the plain versions are `kernels/reference.py::spmm_dense_cells`
and `::sddmm_cells`. Both multiply on the tensor cores, fp32 as 3xTF32
(fp32-accurate); `sddmm_cells` gives each CTA a chunk of consecutive cells
(`cells_per_cta`).

`compute_dtype` is the JAX functions' argument. float32 (the default)
multiplies the fp32 cells at fp32 accuracy, whatever dense's dtype.
bfloat16, the bf16 compute mode, rounds the inputs to bf16 (the cells,
unless their bf16 twin `Storage.tier_values(compute_dtype=bfloat16)[
"cells_bf16"]` is passed, and dense; d1 and d2), multiplies bf16 by bf16
(exact in fp32) and sums in fp32. Each kernel has a variant of its own
for it, on bf16 `mma.sync.m16n8k16` with `ldmatrix` fragments: the SpMM's
`dense_cells_bf16_kernel`, which reads half the cell bytes, and the
SDDMM's `sddmm_cells_bf16_kernel`, which also runs for bf16 d1 and d2 in
float32 mode (the cast is then a no-op). The plain versions round the same
way and multiply in float32.

Routing as in `spmm_csr.py`: the plain version for tensors on the CPU, the
kernel (or an exception) for tensors on a CUDA device. `LAUNCHES` counts
kernel launches, the bf16 variants under "spmm_dense_cells_bf16" and
"sddmm_cells_bf16".
"""

import ctypes
import functools

import numpy as np
import torch

from dgsparse_tpu_torch.core.planner import DenseCellPlan
from dgsparse_tpu_torch.kernels import _launch, reference

LAUNCHES = {"spmm_dense_cells": 0, "spmm_dense_cells_bf16": 0,
            "sddmm_cells": 0, "sddmm_cells_bf16": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spmm_cells")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_spmm_dense_cells.argtypes = [i, i, i, p, p, p, p, p, p, i, i, i,
                                        i, i, p]
    lib.dg_spmm_dense_cells.restype = i
    lib.dg_sddmm_cells.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, p]
    lib.dg_sddmm_cells.restype = i
    return lib


def check_compute_dtype(compute_dtype) -> bool:
    """True for the bf16 compute mode, False for float32; raises for any
    other dtype."""
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute_dtype must be torch.float32 or "
                         f"torch.bfloat16, got {compute_dtype}")
    return compute_dtype == torch.bfloat16


def _check_cells(plan: DenseCellPlan, cells: torch.Tensor,
                 dtype=torch.float32) -> None:
    shape = (plan.num_cells, plan.row_block, plan.col_window)
    if tuple(cells.shape) != shape or cells.dtype != dtype:
        raise ValueError(f"cells must be {dtype} {shape}, got "
                         f"{cells.dtype} {tuple(cells.shape)}")


def _io_rows(plan: DenseCellPlan, transpose: bool):
    """(rows of the input, rows of the output)."""
    if transpose:
        return plan.num_rows, plan.num_cols
    return plan.num_cols, plan.num_rows


def _bf16(*ts):
    """The tensors rounded to bf16 (those that are not already)."""
    return [t.to(torch.bfloat16) for t in ts]


# --- spmm_dense_cells --------------------------------------------------------

def spmm_dense_cells_plain(plan: DenseCellPlan, cells: torch.Tensor,
                           dense: torch.Tensor, transpose: bool = False,
                           compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch `spmm_dense_cells` (bmm and index_add_, float32); in
    bf16 mode on the cells and dense rounded to bf16."""
    if check_compute_dtype(compute_dtype):
        cells, dense = _bf16(cells, dense)
    return reference.spmm_dense_cells(cells.float(), plan.cell_rb,
                                      plan.cell_cw, dense, plan.num_rows,
                                      plan.num_cols, transpose)


def spmm_dense_cells_cuda(plan: DenseCellPlan, cells: torch.Tensor,
                          dense: torch.Tensor, transpose: bool = False,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel: float32 out [M, F] = Σ cells @ dense[window] per row
    block (dense [N, F]), or with `transpose` out [N, F] = Σ cellsᵀ @
    dense[block] per column window (dense [M, F]); blocks no cell visits
    are 0. float32 mode takes float32 cells; bf16 mode rounds fp32 cells
    and dense to bf16 (bf16 cells, the storage's twin, as they are) and
    runs the bf16-cell variant. Raises unless every tensor is on one CUDA
    device with the types it takes."""
    bf16 = check_compute_dtype(compute_dtype)
    if bf16:
        cells, dense = _bf16(cells, dense)
    _launch.check_device(dense.device, cells=cells, dense=dense,
                         cell_rb=plan.cell_rb, t_order=plan.t_order)
    _launch.check_dense("dense", dense)
    _check_cells(plan, cells, compute_dtype)
    in_rows, out_rows = _io_rows(plan, transpose)
    if dense.shape[0] != in_rows:
        raise ValueError(f"dense has {dense.shape[0]} rows, expected "
                         f"{in_rows}")
    feat = dense.shape[1]
    if plan.num_cells == 0 or out_rows == 0 or feat == 0 or in_rows == 0:
        return torch.zeros((out_rows, feat), dtype=torch.float32,
                           device=dense.device)
    out = torch.empty((out_rows, feat), dtype=torch.float32,
                      device=dense.device)
    if transpose:
        ptr, order, win = plan.t_ptr, plan.t_order.data_ptr(), plan.cell_rb
    else:
        ptr, order, win = plan.fwd_ptr, None, plan.cell_cw
    err = _lib().dg_spmm_dense_cells(
        _launch.DTYPE_CODE[cells.dtype], _launch.DTYPE_CODE[dense.dtype],
        dense.device.index or 0, cells.data_ptr(), ptr.data_ptr(), order,
        win.data_ptr(), dense.data_ptr(), out.data_ptr(), ptr.shape[0] - 1,
        out_rows, in_rows, feat, int(transpose),
        _launch.stream(dense.device))
    _launch.raise_on(err, "spmm_dense_cells")
    LAUNCHES["spmm_dense_cells_bf16" if bf16 else "spmm_dense_cells"] += 1
    return out


def spmm_dense_cells(plan: DenseCellPlan, cells: torch.Tensor,
                     dense: torch.Tensor, transpose: bool = False,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Dense-cell SpMM: the plain version on the CPU, the kernel on CUDA."""
    if dense.device.type == "cpu":
        return spmm_dense_cells_plain(plan, cells, dense, transpose,
                                      compute_dtype)
    return spmm_dense_cells_cuda(plan, cells, dense, transpose,
                                 compute_dtype)


# --- sddmm_cells -------------------------------------------------------------

CTAS_PER_SM = 2      # both SDDMM kernels' occupancy (their shared memory)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cells_per_cta(num_cells: int, num_sms: int) -> int:
    """Cells a CTA of the SDDMM takes: one wave of equal chunks over every
    CTA slot of the card (every cell costs the same block of products and
    stores)."""
    return max(1, -(-num_cells // (CTAS_PER_SM * num_sms)))


def _check_sddmm(plan: DenseCellPlan, d1, d2) -> None:
    if d1.dim() != 2 or d2.dim() != 2 or d1.shape[1] != d2.shape[1] \
            or d1.shape[0] != plan.num_rows or d2.shape[0] != plan.num_cols:
        raise ValueError(
            f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} must be "
            f"[{plan.num_rows}, F] and [{plan.num_cols}, F]")


def sddmm_cells_plain(plan: DenseCellPlan, d1: torch.Tensor,
                      d2: torch.Tensor,
                      compute_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch `sddmm_cells` (one float32 bmm); in bf16 mode on d1
    and d2 rounded to bf16."""
    _check_sddmm(plan, d1, d2)
    if check_compute_dtype(compute_dtype):
        d1, d2 = _bf16(d1, d2)
    return reference.sddmm_cells(plan.cell_rb, plan.cell_cw, d1, d2,
                                 plan.row_block, plan.col_window)


def sddmm_cells_cuda(plan: DenseCellPlan, d1: torch.Tensor,
                     d2: torch.Tensor,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """The kernel: float32 [ncells * R * C], per cell the block d1[rb] @
    d2[cw]ᵀ (rows past M or N count as 0). bf16 mode rounds d1 and d2 to
    bf16; bf16 operands, in either mode, run `sddmm_cells_bf16_kernel`
    (counted as "sddmm_cells_bf16"), float32 ones the 3xTF32 kernel.
    Raises unless every tensor is on one CUDA device with the types it
    takes."""
    if check_compute_dtype(compute_dtype):
        d1, d2 = _bf16(d1, d2)
    _launch.check_device(d1.device, d1=d1, d2=d2, cell_rb=plan.cell_rb)
    _launch.check_dense("d1", d1)
    _launch.check_dense("d2", d2)
    if d1.dtype != d2.dtype:
        raise TypeError(f"d1 is {d1.dtype} and d2 {d2.dtype}; they must match")
    bf16 = d1.dtype == torch.bfloat16
    _check_sddmm(plan, d1, d2)
    if plan.num_cells == 0 or d1.shape[1] == 0:
        return torch.zeros(plan.cell_slots, dtype=torch.float32,
                           device=d1.device)
    out = torch.empty(plan.cell_slots, dtype=torch.float32,
                      device=d1.device)
    index = d1.device.index or 0
    err = _lib().dg_sddmm_cells(
        _launch.DTYPE_CODE[d1.dtype], index, plan.cell_rb.data_ptr(),
        plan.cell_cw.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        out.data_ptr(), plan.num_cells, plan.num_rows, plan.num_cols,
        d1.shape[1], cells_per_cta(plan.num_cells, _sm_count(index)),
        _launch.stream(d1.device))
    _launch.raise_on(err, "sddmm_cells")
    LAUNCHES["sddmm_cells_bf16" if bf16 else "sddmm_cells"] += 1
    return out


def sddmm_cells(plan: DenseCellPlan, d1: torch.Tensor, d2: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Dense-cell SDDMM: the plain version on the CPU, the kernel on
    CUDA."""
    if d1.device.type == "cpu":
        return sddmm_cells_plain(plan, d1, d2, compute_dtype)
    return sddmm_cells_cuda(plan, d1, d2, compute_dtype)


# --- cell materialization ----------------------------------------------------

def _slot_segments(plan: DenseCellPlan, device):
    """(rowptr over the distinct slots, the distinct slots int64, eperm
    int64) on `device`, for summing edge values slot by slot; built once
    per plan and device."""
    cache = plan.__dict__.setdefault("_segments", {})
    key = str(device)
    if key not in cache:
        slot = plan.slot
        first = np.ones(len(slot), bool)
        first[1:] = slot[1:] != slot[:-1]
        starts = np.nonzero(first)[0]
        rowptr = np.append(starts, len(slot)).astype(np.int32)
        cache[key] = (torch.from_numpy(rowptr).to(device),
                      torch.from_numpy(slot[starts].astype(np.int64)).to(
                          device),
                      torch.from_numpy(plan.eperm.astype(np.int64)).to(
                          device))
    return cache[key]


def materialize_cells(plan: DenseCellPlan,
                      values: torch.Tensor) -> torch.Tensor:
    """The cells [ncells, R, C] float32 for edge values [nnz] on their
    device: one sorted segment sum of the dense-tier values over the slot
    order (`segment_sum_csr`, the CSR kernel on CUDA), as
    `dgsparse_tpu/kernels/pallas_spmm.py::materialize_cells` does in-graph."""
    from dgsparse_tpu_torch.kernels.spmm_csr import segment_sum_csr

    rowptr, uslot, eperm = _slot_segments(plan, values.device)
    flat = torch.zeros(plan.cell_slots, dtype=torch.float32,
                       device=values.device)
    if len(uslot):
        sums = segment_sum_csr(rowptr,
                               values.float()[eperm].unsqueeze(1).contiguous())
        flat[uslot] = sums[:, 0]
    return flat.view(plan.num_cells, plan.row_block, plan.col_window)
