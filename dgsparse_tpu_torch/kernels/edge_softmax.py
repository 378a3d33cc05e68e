"""Edge softmax over CSR rows, forward and backward: the Hopper kernels and
their plain versions.

No TPU kernel stands behind them: the JAX package computes `edge_softmax`
(`dgsparse_tpu/ops/edge_softmax.py`) with XLA segment ops. The kernels are
`csrc/edge_softmax.cu` (CUDA C++, sm_90a), one launch forward and one
backward over the CSR rows, each with a small second launch for the rows
of the CSR's split plan (`spmm_csr.split_plan`, the one a storage builds
for `csr_spmm`, `Storage.row_split()`):
- forward: alpha = exp(x - the row's max) / the row's sum of exps, per
  head, for logits x [nnz] or [nnz, H] (or [nnz, ...], heads flattened) in
  CSR edge order; a row whose logits are all -inf gives 0;
- backward: d_logits = alpha * (g - the row's sum of alpha * g), per head.

The mapping, (lanes, group): `lanes` lanes an edge and `group` lanes a row,
is chosen here by `softmax_path`, a pure function of the heads.

Routing rests on the device and dtype of the input alone: the kernels for
CUDA float32 tensors (they launch or raise), the plain versions for every
other tensor. `LAUNCHES` counts kernel launches: "edge_softmax" and
"edge_softmax_bwd" once a call, "edge_softmax_split" once a call of either
that also ran the split rows' second launch. With metrics on, those calls
also count "edge_softmax.split_rows" / ".split_chunks".
"""

import ctypes
import functools
from typing import Optional

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr, gather_rows
from dgsparse_tpu_torch.kernels import _launch, spmm_csr
from dgsparse_tpu_torch.utils import metrics

LAUNCHES = {"edge_softmax": 0, "edge_softmax_bwd": 0, "edge_softmax_split": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("edge_softmax")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.dg_edge_softmax.argtypes = [i, p, p, q, q, p, p, i, i, i, i, p, i, i,
                                    p]
    lib.dg_edge_softmax_bwd.argtypes = [i, p, p, p, q, q, p, q, q, p, i, i, i,
                                        i, p, i, i, p]
    lib.dg_edge_softmax.restype = lib.dg_edge_softmax_bwd.restype = i
    return lib


# --- the path ----------------------------------------------------------------

MAX_LANES = 8           # lanes an edge: more heads run in slices of 8
MAX_CHUNK = 128         # the longest row or chunk a group holds (kMaxChunk)


def softmax_path(heads: int):
    """(lanes, group): one lane a head of an edge, the heads rounded up to a
    power of two and at most MAX_LANES (more heads in slices of that many);
    `group` lanes a row, so group / lanes edges of a row a pass: 16 lanes
    for one head, else a warp. (On an H100 at the benchmark's one-head
    layer, 14.7 entries a row: 28.6 / 32.1 us forward / backward at 16
    lanes, 30.3 / 42.0 at 8, 35.3 / 31.5 at 32.)"""
    lanes = 1
    while lanes < min(heads, MAX_LANES):
        lanes *= 2
    return lanes, 16 if lanes == 1 else 32


# --- the plain versions ------------------------------------------------------

def _row_sums(x: torch.Tensor, row: torch.Tensor, m: int) -> torch.Tensor:
    """Per-row sums of per-edge x. A 2-D x is summed into an [H, M] buffer
    and returned as its column-major [M, H] view, which `gather_rows`
    gathers from without a copy."""
    if x.dim() == 2:
        return x.new_zeros(x.shape[1], m).index_add(1, row, x.t()).t()
    return x.new_zeros((m,) + tuple(x.shape[1:])).index_add(0, row, x)


def _rows(rowptr, nnz: int, coo_row):
    return rowptr.shape[0] - 1, (expand_rowptr(rowptr, nnz)
                                 if coo_row is None else coo_row)


def edge_softmax_plain(rowptr, logits, coo_row: Optional[torch.Tensor] = None,
                       split: Optional[spmm_csr.SplitPlan] = None
                       ) -> torch.Tensor:
    """Plain PyTorch softmax of `logits` [nnz, ...] over each CSR row (a
    scatter max, the exps, an index_add of row sums), in the logits' dtype;
    `split` is taken so that it can stand in for the kernel, and unread."""
    m, row = _rows(rowptr, logits.shape[0], coo_row)
    idx = row.long().reshape((-1,) + (1,) * (logits.dim() - 1))
    row_max = logits.new_full((m,) + tuple(logits.shape[1:]), float("-inf"))
    row_max = row_max.scatter_reduce(0, idx.expand_as(logits), logits, "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max,
                          torch.zeros_like(row_max))
    ex = torch.exp(logits - gather_rows(row_max, row))
    denom = _row_sums(ex, row, m)
    return ex / gather_rows(torch.clamp(denom, min=1e-38), row)


def edge_softmax_bwd_plain(rowptr, alpha, g,
                           coo_row: Optional[torch.Tensor] = None,
                           split: Optional[spmm_csr.SplitPlan] = None,
                           column_major: bool = False) -> torch.Tensor:
    """Plain PyTorch d_logits = alpha * (g - the row's sum of alpha * g);
    `split` and `column_major` (the kernel's output layout) unread."""
    m, row = _rows(rowptr, alpha.shape[0], coo_row)
    return alpha * (g - gather_rows(_row_sums(alpha * g, row, m), row))


# --- the kernels -------------------------------------------------------------

def _as_2d(t: torch.Tensor) -> torch.Tensor:
    """[nnz] or [nnz, ...] as [nnz, H] (a view where the strides allow)."""
    return t.reshape(t.shape[0], -1)


def _plan(rowptr, nnz: int, split, device):
    """(plan pointer, chunks, chunk size, the plan kept alive) for the C
    interface; without a plan, this CSR's built on the host."""
    if split is None:
        split = spmm_csr.split_plan(rowptr.cpu(), device=device)
    split.check(rowptr.shape[0] - 1, nnz, device)
    if split.chunk > MAX_CHUNK:
        raise ValueError(f"split plan of chunks of {split.chunk} entries: the "
                         f"kernel holds rows of at most {MAX_CHUNK}")
    ptr = split.index.data_ptr() if split.num_chunks else None
    return ptr, split.num_chunks, split.chunk, split


def _count_split(name: str, split) -> None:
    if split.num_chunks:
        LAUNCHES["edge_softmax_split"] += 1
        metrics.count("edge_softmax.split_rows", split.num_split_rows)
        metrics.count("edge_softmax.split_chunks", split.num_chunks)
    LAUNCHES[name] += 1


def _check(rowptr, nnz: int, **tensors) -> torch.device:
    """The one CUDA device of rowptr and the float32 [nnz, ...] tensors."""
    device = rowptr.device
    _launch.check_index("rowptr", rowptr)
    if not rowptr.is_contiguous():
        raise ValueError("rowptr must be contiguous")
    for name, t in tensors.items():
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} is on {t.device} and rowptr on "
                             f"{device}: the kernel needs one CUDA device")
        if t.dtype != torch.float32 or t.dim() < 1 or t.shape[0] != nnz:
            raise TypeError(f"{name} must be float32 [nnz, ...] with nnz = "
                            f"{nnz}, got {t.dtype} {tuple(t.shape)}")
    return device


def edge_softmax_cuda(rowptr, logits,
                      split: Optional[spmm_csr.SplitPlan] = None
                      ) -> torch.Tensor:
    """The forward kernel: alpha of `logits`' shape, row-major, on the rows
    of `split` (this CSR's split plan; built here when None) taken by
    chunks. Raises unless rowptr (int32) and logits (float32) share a CUDA
    device."""
    nnz = logits.shape[0]
    device = _check(rowptr, nnz, logits=logits)
    alpha = torch.empty(logits.shape, dtype=torch.float32, device=device)
    x = _as_2d(logits)
    heads = x.shape[1]
    num_rows = rowptr.shape[0] - 1
    if num_rows == 0 or nnz == 0 or heads == 0:
        return alpha
    plan, chunks, chunk, split = _plan(rowptr, nnz, split, device)
    work = torch.empty((chunks, heads, 2), dtype=torch.float32,
                       device=device) if chunks else None
    err = _lib().dg_edge_softmax(
        device.index or 0, rowptr.data_ptr(), x.data_ptr(), x.stride(0),
        x.stride(1), alpha.data_ptr(),
        None if work is None else work.data_ptr(), num_rows, heads,
        *softmax_path(heads), plan, chunks, chunk, _launch.stream(device))
    _launch.raise_on(err, "edge_softmax")
    _count_split("edge_softmax", split)
    return alpha


def edge_softmax_bwd_cuda(rowptr, alpha, g,
                          split: Optional[spmm_csr.SplitPlan] = None,
                          column_major: bool = False) -> torch.Tensor:
    """The backward kernel: d_logits of `alpha`'s shape from alpha (the
    forward's output, row-major) and g (any strides); column-major [nnz,
    H] where `column_major` (the logits' layout), else row-major."""
    nnz = alpha.shape[0]
    device = _check(rowptr, nnz, alpha=alpha, g=g)
    if alpha.shape != g.shape or not alpha.is_contiguous():
        raise ValueError(f"alpha {tuple(alpha.shape)} must be contiguous and "
                         f"of g's shape {tuple(g.shape)}")
    column_major = column_major and alpha.dim() == 2
    if column_major:
        dx = torch.empty(alpha.shape[::-1], dtype=torch.float32,
                         device=device).t()
    else:
        dx = torch.empty(alpha.shape, dtype=torch.float32, device=device)
    gx, dx2 = _as_2d(g), _as_2d(dx)
    heads = dx2.shape[1]
    num_rows = rowptr.shape[0] - 1
    if num_rows == 0 or nnz == 0 or heads == 0:
        return dx
    plan, chunks, chunk, split = _plan(rowptr, nnz, split, device)
    work = torch.empty((chunks, heads), dtype=torch.float32,
                       device=device) if chunks else None
    err = _lib().dg_edge_softmax_bwd(
        device.index or 0, rowptr.data_ptr(), alpha.data_ptr(),
        gx.data_ptr(), gx.stride(0), gx.stride(1), dx2.data_ptr(),
        dx2.stride(0), dx2.stride(1),
        None if work is None else work.data_ptr(), num_rows, heads,
        *softmax_path(heads), plan, chunks, chunk, _launch.stream(device))
    _launch.raise_on(err, "edge_softmax_bwd")
    _count_split("edge_softmax_bwd", split)
    return dx


def _on_kernel(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and t.dtype == torch.float32


def edge_softmax(rowptr, logits, coo_row: Optional[torch.Tensor] = None,
                 split: Optional[spmm_csr.SplitPlan] = None) -> torch.Tensor:
    """The row softmax: the kernel for CUDA float32 logits (with `split`,
    the CSR's split plan), else the plain version."""
    if _on_kernel(logits):
        return edge_softmax_cuda(rowptr, logits, split=split)
    return edge_softmax_plain(rowptr, logits, coo_row)


def edge_softmax_bwd(rowptr, alpha, g, coo_row: Optional[torch.Tensor] = None,
                     split: Optional[spmm_csr.SplitPlan] = None,
                     column_major: bool = False) -> torch.Tensor:
    """Its backward: the kernel for CUDA float32 alpha, else the plain
    version."""
    if _on_kernel(alpha):
        return edge_softmax_bwd_cuda(rowptr, alpha, g, split=split,
                                     column_major=column_major)
    return edge_softmax_bwd_plain(rowptr, alpha, g, coo_row)
