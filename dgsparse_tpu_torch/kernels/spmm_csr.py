"""CSR SpMM (SUM/MEAN, one or H heads) and CSR segment sum: the Hopper
kernel and its plain version.

Counterpart of `dgsparse_tpu/kernels/pallas_spmm.py::segment_matmul` and of
the `spmm_esc`/`gspmm_esc` (MUL) and `spmm_esc_mh` forwards that drive it.
The kernel is `csrc/spmm_csr.cu` (CUDA C++, sm_90a), built by `_build.py`
and called through ctypes on PyTorch's current stream. Run over the CSC
view (colptr, row, values permuted by csr2csc) it is the transpose the
backward needs.

The kernel's path, (vec, group, nv): `vec` elements a load, `group` lanes
a row, `nv` vectors a lane, is chosen here by `spmm_path`, a pure function
of the width, the heads, the dtype and the pointers' alignment, so that the
CPU tests can check that it covers every feature once.

Hub rows: a storage builds a split plan (`split_plan`) of each view once,
listing every row longer than `SPLIT_CHUNK` entries cut into chunks of that
many; `csr_spmm` given one runs the chunks as extra slots of the same
launch and adds each long row's partials in a fixed order in a small
second launch (`csrc/spmm_csr.cu`), so the longest row no longer sets the
launch's time. Without a plan, or with an empty one, the launch is the one
without chunks.

Routing: `csr_spmm` and `segment_sum_csr` take the plain version in
`kernels/reference.py` for tensors on the CPU, and launch the kernel for
tensors on a CUDA device. On CUDA they launch or raise (no nvcc, a failed
build, a refused launch); nothing falls back to the plain version there.
`LAUNCHES` counts kernel launches per entry point.
"""

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from dgsparse_tpu_torch.core.transform import expand_rowptr
from dgsparse_tpu_torch.kernels import _launch, reference
from dgsparse_tpu_torch.ops.types import ReduceOp, as_reduce
from dgsparse_tpu_torch.utils import metrics

# "csr_spmm_split": the csr_spmm launches that took a non-empty split plan
# (each also counted under "csr_spmm")
LAUNCHES = {"csr_spmm": 0, "csr_spmm_split": 0, "segment_sum_csr": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spmm_csr")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_csr_spmm.argtypes = [i, i, p, p, p, p, p, i, i, i, i, i, i, i,
                                p, i, i, i, p, p]
    lib.dg_csr_spmm.restype = i
    lib.dg_segment_sum_csr.argtypes = [i, i, p, p, p, i, i, i, i, i, p]
    lib.dg_segment_sum_csr.restype = i
    return lib


# --- the path ----------------------------------------------------------------

GROUPS = (32, 16, 8, 4)         # lanes a row, widest first


def max_vectors(vec: int, itemsize: int) -> int:
    """Most vectors a lane may carry (`max_vectors` in csrc/spmm_csr.cu)."""
    return 2 if vec * itemsize == 16 else 4


def widest_vec(feat: int, heads: int, itemsize: int, align: int) -> int:
    """Widest load (at most 16 bytes, `align` bytes the pointers allow)
    whose element count divides the head width, so no vector straddles
    two heads."""
    vec = 16 // itemsize
    while vec > 1 and ((feat // heads) % vec or align % (vec * itemsize)):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def spmm_path(feat: int, heads: int, itemsize: int, align: int = 16):
    """(vec, group, nv) for a width `feat` of `heads` heads: the widest
    load; at most 16 bytes a lane (more costs registers, and so warps in
    flight: at arxiv F = 256 on an H100, two 16-byte vectors a lane in one
    pass ran 12-15 % slower than one vector in two feature slices,
    chip_smoke.py's phase 7); then the fewest feature slices (one pass
    over a row's edges wherever the group can span the row), the fewest
    lane slots a row (group * nv), the widest group (fewer rows a warp, so
    less waiting on a warp's longest row). A group is at least 8 lanes
    where the row has 8 vectors."""
    vec = widest_vec(feat, heads, itemsize, align)
    nvec = feat // vec
    least = 8 if nvec >= 8 else 4
    most = min(max_vectors(vec, itemsize), 16 // (vec * itemsize))
    best = None
    for group in GROUPS:
        if group < least:
            continue
        for nv in range(1, most + 1):
            slices = -(-nvec // (group * nv))
            key = (slices, slices * group * nv, -group)
            if best is None or key < best[0]:
                best = (key, (vec, group, nv))
    return best[1]


# --- the split plan ----------------------------------------------------------

# Rows longer than this many entries are cut into chunks of it. Device time
# of the split launch plus its fix-up on an NVIDIA H100 80GB HBM3 (700 W),
# on the benchmark's ogbn-arxiv-sized citation graph (2,484,941 nnz, rows up
# to 13,096 entries; 4,019 us a GCN forward without a plan), for C = 64 /
# 96 / 128 / 192 / 256:
#   F = 256        595.7 / 590.9 / 590.2 / 596.6 / 601.6 us
#   F = 40         110.3 / 112.6 / 116.4 / 125.8 / 133.1
#   H = 8, F = 8   172.2 / 172.3 / 176.8 / 188.2 / 194.6
# A longer chunk leaves a longer row to end the launch; a shorter one adds
# partial sums and fix-up work (19.4 us at C = 64, F = 256). 64-128 lie
# within 3 % of each other; 128 splits the fewest rows of the three.
SPLIT_CHUNK = 128


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The chunks of a CSR's rows longer than `chunk` entries, in CSR order:
    chunk k covers entries [chunk_start[k], min(chunk_start[k] + chunk,
    rowptr[chunk_row[k] + 1])), and split row i (the i-th such row) owns
    chunks [chunk_ptr[i], chunk_ptr[i + 1]). The three int32 arrays lie one
    after the other in one tensor `index`, as the kernel takes them (one
    upload, one pointer). `num_rows` and `nnz` are the CSR's it was built
    for."""

    index: torch.Tensor
    num_chunks: int
    num_split_rows: int
    chunk: int
    num_rows: int
    nnz: int

    @property
    def chunk_row(self) -> torch.Tensor:
        return self.index[:self.num_chunks]

    @property
    def chunk_start(self) -> torch.Tensor:
        return self.index[self.num_chunks:2 * self.num_chunks]

    @property
    def chunk_ptr(self) -> torch.Tensor:
        return self.index[2 * self.num_chunks:]

    def to(self, device) -> "SplitPlan":
        return dataclasses.replace(self, index=self.index.to(device))

    def check(self, num_rows: int, nnz: int, device) -> None:
        """Raise ValueError unless the plan is this CSR's, on `device`."""
        if (self.num_rows, self.nnz) != (num_rows, nnz) or \
                self.index.device != device:
            raise ValueError(
                f"split plan of {self.num_rows} rows and {self.nnz} entries "
                f"on {self.index.device} for a CSR of {num_rows} and {nnz} "
                f"on {device}")


def split_plan(rowptr, chunk: int = SPLIT_CHUNK, device=None) -> SplitPlan:
    """The split plan of a host CSR row pointer (numpy or a CPU tensor):
    every row longer than `chunk` entries, ascending, cut into chunks of
    `chunk` consecutive entries, the last one shorter where the row is not
    a multiple. Storages build theirs with `SPLIT_CHUNK`; `chunk` is for
    the tests and for timing other sizes."""
    rowptr = np.asarray(rowptr, dtype=np.int64)
    lengths = np.diff(rowptr)
    rows = np.flatnonzero(lengths > chunk)
    counts = -(-lengths[rows] // chunk)
    chunk_ptr = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts, out=chunk_ptr[1:])
    chunk_row = np.repeat(rows, counts)
    within = np.arange(len(chunk_row)) - np.repeat(chunk_ptr[:-1], counts)
    chunk_start = rowptr[chunk_row] + chunk * within
    index = np.concatenate([chunk_row, chunk_start, chunk_ptr])
    return SplitPlan(torch.from_numpy(index.astype(np.int32)).to(device),
                     num_chunks=len(chunk_row), num_split_rows=len(rows),
                     chunk=int(chunk), num_rows=len(lengths),
                     nnz=int(rowptr[-1]))


# --- csr_spmm ----------------------------------------------------------------

def csr_spmm_plain(rowptr, col, values, dense, reduce=ReduceOp.SUM,
                   coo_row: Optional[torch.Tensor] = None,
                   split: Optional[SplitPlan] = None) -> torch.Tensor:
    """Plain PyTorch `csr_spmm` (index_add_ over coo_row, edge-chunked);
    `split` is taken so that it can stand in for the kernel, and unread:
    the plan changes the kernel's order of summation, not its result."""
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


def csr_spmm_cuda(rowptr, col, values, dense, reduce=ReduceOp.SUM,
                  path=None, split: Optional[SplitPlan] = None
                  ) -> torch.Tensor:
    """The kernel: out[m] = sum_{e in row m} values[e] * dense[col[e]]
    (values None means 1.0; values [nnz, H] scale feature j by
    values[e, j // (F / H)]), MEAN divides by max(deg, 1), on `path`
    (default `spmm_path`), with the rows of `split` (this CSR's
    `split_plan`, or None) summed by chunks. Raises unless every tensor is
    on one CUDA device with the types it takes."""
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
    if path is None:
        path = spmm_path(feat, heads, dense.element_size(),
                         _launch.alignment(dense, out))
    chunks = split.num_chunks if split is not None else 0
    plan = (None, 0, 0, 1, None)
    if chunks:
        split.check(num_rows, col.shape[0], dense.device)
        # fp32 partial sums of the chunks, each written once
        work = torch.empty((chunks, feat), dtype=torch.float32,
                           device=dense.device)
        plan = (split.index.data_ptr(), chunks, split.num_split_rows,
                split.chunk, work.data_ptr())
    err = _lib().dg_csr_spmm(
        _launch.DTYPE_CODE[dense.dtype], dense.device.index or 0,
        rowptr.data_ptr(), col.data_ptr(),
        None if values is None else values.data_ptr(),
        dense.data_ptr(), out.data_ptr(), num_rows, feat, heads,
        int(reduce == ReduceOp.MEAN), *path, *plan,
        _launch.stream(dense.device))
    _launch.raise_on(err, "csr_spmm")
    LAUNCHES["csr_spmm"] += 1
    if chunks:
        LAUNCHES["csr_spmm_split"] += 1
        metrics.count("csr_spmm.split_rows", split.num_split_rows)
        metrics.count("csr_spmm.split_chunks", chunks)
    return out


def csr_spmm(rowptr, col, values, dense, reduce=ReduceOp.SUM,
             coo_row: Optional[torch.Tensor] = None,
             split: Optional[SplitPlan] = None) -> torch.Tensor:
    """CSR SpMM: the plain version on the CPU, the kernel on CUDA (with
    `split`, the CSR's split plan, where the caller owns one)."""
    if dense.device.type == "cpu":
        return csr_spmm_plain(rowptr, col, values, dense, reduce, coo_row)
    return csr_spmm_cuda(rowptr, col, values, dense, reduce, split=split)


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
    path = spmm_path(feat, 1, contrib.element_size(),
                     _launch.alignment(contrib, out))
    err = _lib().dg_segment_sum_csr(
        _launch.DTYPE_CODE[contrib.dtype], contrib.device.index or 0,
        rowptr.data_ptr(), contrib.data_ptr(), out.data_ptr(), num_rows,
        feat, *path, _launch.stream(contrib.device))
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
