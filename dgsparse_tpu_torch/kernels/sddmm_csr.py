"""CSR SDDMM (one or H heads): the Hopper kernel and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_sddmm.py::sddmm_esc` and of
the XLA SDDMM the JAX package runs for `sddmm`, for the SpMM's `d_values`
(`kernels/xla.py::sddmm_chunked`) and for the multi-head SpMM's `d_values`
(`ops/spmm_mh.py`). The kernel is `csrc/sddmm_csr.cu` (CUDA C++, sm_90a):
out[e, h] = dot(d1[row_e, h], d2[col_e, h]) over F features per head, for
d1 [M, H*F] and d2 [N, H*F], float32 [nnz, H] in CSR edge order; MEAN
divides by max(deg, 1).

The kernel has two mappings: a group of lanes a row with the row's edges
spread over lanes, on a path (vec, k, q, heads_per_pass, group) chosen by
`sddmm_path`, and one warp a row (WARP_PER_ROW). `pick_sddmm` chooses
between them; both are pure functions of the head width, the heads, the
dtype and the pointers' alignment, so that the CPU tests can check that
a path covers every (edge, head, feature) once.

Hub rows: given the CSR's split plan (`spmm_csr.split_plan`, the one a
storage builds for `csr_spmm`, `Storage.row_split()`), either mapping runs
the chunks of every row longer than `SPLIT_CHUNK` entries as extra slots of
the same launch, in its first blocks, and skips those rows in the others,
so the longest row no longer sets the launch's time. Each (edge, head) is
still written once, by the same dot: no workspace, no second launch, and
the output bitwise the one without a plan. Without a plan, or with an
empty one, the launch is the one without chunks.

Routing as in `spmm_csr.py`: the plain version for CPU tensors, the kernel
(or an exception) for CUDA tensors. `LAUNCHES` counts kernel launches.
"""

import ctypes
import functools
from typing import Optional

import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference, spmm_csr
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce
from dgsparse_tpu_torch.utils import metrics

# "sddmm_csr_split": the sddmm_csr launches that took a non-empty split
# plan (each also counted under "sddmm_csr")
LAUNCHES = {"sddmm_csr": 0, "sddmm_csr_split": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("sddmm_csr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_sddmm_csr.argtypes = [i, i, p, p, p, p, p, i, i, i, i, p, i, i,
                                 p]
    lib.dg_sddmm_csr_group.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i,
                                       i, i, i, p, i, i, p]
    lib.dg_sddmm_csr.restype = lib.dg_sddmm_csr_group.restype = i
    return lib


# --- the path ----------------------------------------------------------------

LANE_BYTES = 32         # bytes of a head a lane gathers an edge
KS = (1, 2, 4, 8)       # vectors a lane (the kernel's K)
ROW_EDGES = 8           # edges of a row a group takes at once
# `path` of sddmm_csr_cuda for the one-warp-a-row mapping
WARP_PER_ROW = "warp_per_row"


@functools.lru_cache(maxsize=None)
def sddmm_path(feat: int, heads: int, itemsize: int, align: int = 16):
    """(vec, k, q, heads_per_pass, group) for `heads` heads of `feat`
    features each: the widest load (at most 16 bytes, `align` bytes the
    pointers allow) whose element count divides the head; the fewest lanes
    a head q (a power of two, at most 32) whose vectors, at most
    LANE_BYTES a lane (half that for loads narrower than 16 bytes on a
    head wider than LANE_BYTES), cover the head, then the fewest vectors
    a lane k that do (a wider head runs in chunks); as many heads of an
    edge side by side as fit a warp (a power of two, so q * heads_per_pass
    lanes an edge); and a group of lanes a row that takes ROW_EDGES of its
    edges a pass, or fewer where that would pass a warp. (On an H100 at
    arxiv's GAT widths, 32 bytes a lane ran faster than 16 or 64.)"""
    vec = spmm_csr.widest_vec(feat * heads, heads, itemsize, align)
    head_vecs = feat // vec
    lane_bytes = LANE_BYTES
    if vec * itemsize < 16 and feat * itemsize > LANE_BYTES:
        lane_bytes //= 2        # narrow loads: more lanes a head
    k_most = max(k for k in KS if k * vec * itemsize <= lane_bytes)
    q = 1
    while q < 32 and q * k_most < head_vecs:
        q *= 2
    k = next((k for k in KS if k <= k_most and q * k >= head_vecs), k_most)
    per_pass = 1
    while per_pass < heads and 2 * per_pass * q <= 32:
        per_pass *= 2
    group = min(32, ROW_EDGES * q * per_pass)
    return vec, k, q, per_pass, group


def pick_sddmm(feat: int, heads: int, itemsize: int, align: int = 16):
    """The mapping for `heads` heads of `feat` features: `sddmm_path`'s
    group mapping where it loads vectors of two or more elements, and
    WARP_PER_ROW where it would load scalars (an odd head width, or
    pointers so aligned). On an H100 (`utils/path_sweep.py`) the group
    mapping lost to one warp a row at 25 of the 27 shapes where it loads
    scalars, by 4-95 % (the one-warp kernel's lane layout is fixed at
    compile time and it reads a row's col 32 edges at a time), and won
    at a head of 7 on rows of ~7 edges (by 6 %) and at bf16 F = 41 on
    rows of ~98 (by 8 %); with vector loads it won at 23 of 24."""
    path = sddmm_path(feat, heads, itemsize, align)
    return WARP_PER_ROW if path[0] == 1 else path


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
                    coo_row: Optional[torch.Tensor] = None,
                    split: Optional[spmm_csr.SplitPlan] = None
                    ) -> torch.Tensor:
    """Plain PyTorch `sddmm_csr` (two row gathers, edge-chunked); `split`
    is taken so that it can stand in for the kernel, and unread: the plan
    changes which lanes compute an edge, not its result."""
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
                   reduce=ReduceOp.SUM, path=None,
                   split: Optional[spmm_csr.SplitPlan] = None) -> torch.Tensor:
    """The kernel: float32 [nnz, heads] per-edge, per-head dots, on `path`
    (`pick_sddmm`'s by default): a path of `sddmm_path` for the group
    mapping, or WARP_PER_ROW; with the rows of `split` (this CSR's
    `split_plan`, or None) taken by chunks. Raises unless every tensor is
    on one CUDA device with the types it takes."""
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
    chunks = split.num_chunks if split is not None else 0
    plan = (None, 0, 0)
    if chunks:
        split.check(num_rows, nnz, d1.device)
        plan = (split.index.data_ptr(), chunks, split.chunk)
    out = torch.empty((nnz, heads), dtype=torch.float32, device=d1.device)
    args = (_launch.DTYPE_CODE[d1.dtype], d1.device.index or 0,
            rowptr.data_ptr(), col.data_ptr(), d1.data_ptr(), d2.data_ptr(),
            out.data_ptr(), num_rows, heads, feat,
            int(reduce == ReduceOp.MEAN))
    if path is None:
        path = pick_sddmm(feat, heads, d1.element_size(),
                          _launch.alignment(d1, d2))
    if path == WARP_PER_ROW:
        err = _lib().dg_sddmm_csr(*args, *plan, _launch.stream(d1.device))
    else:
        err = _lib().dg_sddmm_csr_group(*args, *path, *plan,
                                        _launch.stream(d1.device))
    _launch.raise_on(err, "sddmm_csr")
    LAUNCHES["sddmm_csr"] += 1
    if chunks:
        LAUNCHES["sddmm_csr_split"] += 1
        metrics.count("sddmm_csr.split_rows", split.num_split_rows)
        metrics.count("sddmm_csr.split_chunks", chunks)
    return out


def sddmm_csr(rowptr, col, d1, d2, heads: int = 1, reduce=ReduceOp.SUM,
              coo_row: Optional[torch.Tensor] = None,
              split: Optional[spmm_csr.SplitPlan] = None) -> torch.Tensor:
    """CSR SDDMM: the plain version on the CPU, the kernel on CUDA (with
    `split`, the CSR's split plan, where the caller owns one)."""
    if d1.device.type == "cpu":
        return sddmm_csr_plain(rowptr, col, d1, d2, heads, reduce, coo_row)
    return sddmm_csr_cuda(rowptr, col, d1, d2, heads, reduce, split=split)
