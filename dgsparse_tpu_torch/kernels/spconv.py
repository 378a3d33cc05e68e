"""Sparse 3-D convolution over a rulebook's pairs: the Hopper kernels
`spconv_pairs` (gather-GEMM-scatter, the forward and dX) and `spconv_dw`
(the weight gradient), the pair layouts they read, and their plain
versions.

Counterparts of `dgsparse_tpu/kernels/pallas_spconv.py::fused_pair_matmul`
and `::fused_pair_dw`. The kernels are `csrc/spconv.cu` (CUDA C++, sm_90a),
built by `_build.py` and called through ctypes on PyTorch's current
stream; the plain versions are `kernels/reference.py::spconv_pairs_plain`
and `::spconv_dw_plain`. Both multiply on the tensor cores, fp32 as
3xTF32 (fp32-accurate); `spconv_pairs` in one of two variants that the
plan's density picks (`PairCSR.density`), `spconv_dw` over chunks of one
offset's pairs (`offset_pairs`), whose partials a second launch sums in
chunk order.

In place of the TPU's edge-tile plans and slot arrays, a rulebook's pairs
are held twice, both built once in numpy (`pair_csr`, `offset_pairs`):
- `PairCSR`: a CSR over destination rows, pairs sorted stably by
  (destination row, offset), each (row, offset) at most once; over the
  output ids it is the forward, over the input ids dX;
- `OffsetPairs`: the pairs grouped by offset (the rulebook's kpos runs),
  cut into chunks that stay inside one offset, for dW.

Routing as in `spmm_csr.py`: the plain version for tensors on the CPU, the
kernel (or an exception) for tensors on a CUDA device. `LAUNCHES` counts
kernel launches, one per wrapper call that launches.
"""

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from dgsparse_tpu_torch.kernels import _launch, reference

LAUNCHES = {"spconv_pairs": 0, "spconv_dw": 0}

# destination rows per CTA of spconv_pairs (kRows in csrc/spconv.cu); a
# plan's density is reckoned over blocks of this many rows
ROW_BLOCK = 128
# spconv_dw cuts each offset's pairs into chunks of at least this many
# pairs, and of more where that keeps the chunks near DW_CHUNKS (about two
# waves of its CTAs, two an SM of an H100)
DW_MIN_CHUNK = 256
DW_CHUNKS = 512


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib():
    from dgsparse_tpu_torch.kernels import _build

    lib = _build.load("spconv")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dg_spconv_pairs.argtypes = [i, i, p, p, p, p, p, p, i, i, i, i, i,
                                    ctypes.c_float, p]
    lib.dg_spconv_pairs.restype = i
    lib.dg_spconv_dw.argtypes = [i, i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.dg_spconv_dw.restype = i
    return lib


# --- the pair layouts --------------------------------------------------------

def _tensors_to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device)
        for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)})


@dataclasses.dataclass
class PairCSR:
    """A rulebook's pairs as a CSR over destination rows, sorted stably by
    (destination row, offset), each (row, offset) at most once."""

    ptr: torch.Tensor      # [num_rows + 1] int32
    src: torch.Tensor      # [P] int32 source row of each pair
    widx: torch.Tensor     # [P] int32 kernel offset of each pair
    dst: torch.Tensor      # [P] int32 destination row (ptr expanded)
    k_vol: int             # 1 + the largest offset
    density: float         # mean pairs per (ROW_BLOCK rows, busy offset)

    @property
    def num_rows(self) -> int:
        return self.ptr.shape[0] - 1

    @property
    def num_pairs(self) -> int:
        return self.src.shape[0]

    def to(self, device) -> "PairCSR":
        return _tensors_to(self, device)


@dataclasses.dataclass
class OffsetPairs:
    """A rulebook's pairs grouped by kernel offset, in chunks for dW:
    chunk c holds pairs [bounds[c], bounds[c + 1]), all of one offset, and
    the chunks of offset k are [chunk_ptr[k], chunk_ptr[k + 1])."""

    in_ids: torch.Tensor     # [P] int32
    out_ids: torch.Tensor    # [P] int32
    widx: torch.Tensor       # [P] int32, non-decreasing
    bounds: torch.Tensor     # [C + 1] int32
    chunk_ptr: torch.Tensor  # [k_vol + 1] int32
    k_vol: int

    @property
    def num_chunks(self) -> int:
        return self.bounds.shape[0] - 1

    def to(self, device) -> "OffsetPairs":
        return _tensors_to(self, device)


def pair_csr(dst: np.ndarray, src: np.ndarray, widx: np.ndarray,
             num_rows: int, device="cpu") -> PairCSR:
    """The `PairCSR` of pairs (dst, src, widx) in any order; raises if a
    (destination row, offset) repeats, which the kernel does not take.
    Its density, the mean pairs per (block of ROW_BLOCK rows, offset that
    holds a pair), picks the kernel's variant (csrc/spconv.cu)."""
    dst = np.asarray(dst, np.int64)
    widx = np.asarray(widx, np.int64)
    k_vol = int(widx.max()) + 1 if len(widx) else 1
    order = np.argsort(dst * k_vol + widx, kind="stable")
    dst_s, widx_s = dst[order], widx[order]
    if ((dst_s[1:] == dst_s[:-1]) & (widx_s[1:] == widx_s[:-1])).any():
        raise ValueError("a (destination row, offset) holds two pairs")
    ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(dst_s, minlength=num_rows), out=ptr[1:])
    blocks = -(-num_rows // ROW_BLOCK) * np.count_nonzero(np.bincount(widx_s))
    density = len(widx_s) / blocks if blocks else 0.0
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(device)
    return PairCSR(as_t(ptr), as_t(np.asarray(src)[order]), as_t(widx_s),
                   as_t(dst_s), k_vol, density)


def offset_pairs(in_ids: np.ndarray, out_ids: np.ndarray, widx: np.ndarray,
                 k_vol: int, device="cpu") -> OffsetPairs:
    """The `OffsetPairs` of pairs already grouped by offset (widx
    non-decreasing), in chunks of max(DW_MIN_CHUNK, P / DW_CHUNKS) pairs
    (a multiple of 32) that never cross an offset."""
    widx = np.asarray(widx, np.int64)
    if (np.diff(widx) < 0).any():
        raise ValueError("pairs must be grouped by offset")
    total = len(widx)
    chunk = max(DW_MIN_CHUNK, -(-total // DW_CHUNKS // 32) * 32)
    kpos = np.searchsorted(widx, np.arange(k_vol + 1))
    bounds, chunk_ptr = [], [0]
    for k in range(k_vol):
        bounds.extend(range(int(kpos[k]), int(kpos[k + 1]), chunk))
        chunk_ptr.append(len(bounds))
    bounds.append(total)
    as_t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.int32)).to(device)
    return OffsetPairs(as_t(in_ids), as_t(out_ids), as_t(widx),
                       as_t(np.asarray(bounds)), as_t(np.asarray(chunk_ptr)),
                       k_vol)


# --- spconv_pairs ------------------------------------------------------------

def _check_weight(weight: torch.Tensor, x: torch.Tensor) -> None:
    if weight.dim() != 3 or weight.shape[1] != x.shape[1] \
            or weight.dtype != x.dtype:
        raise ValueError(
            f"weight {weight.dtype} {tuple(weight.shape)} must be [k_vol, "
            f"{x.shape[1]}, c_out] in x's type {x.dtype}")


def spconv_pairs_plain(pairs: PairCSR, x: torch.Tensor,
                       weight: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `spconv_pairs` (a product per offset, index_add_)."""
    return reference.spconv_pairs_plain(x, pairs.src, pairs.dst, pairs.widx,
                                        weight, pairs.num_rows)


def spconv_pairs_cuda(pairs: PairCSR, x: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """The kernel: float32 out [num_rows, c_out] with out[r] = the sum over
    the pairs p of row r of x[src[p]] @ weight[widx[p]] (x [*, c_in],
    weight [k_vol, c_in, c_out] in x's type); rows without a pair are 0.
    Raises unless every tensor is on one CUDA device with the types it
    takes."""
    _launch.check_device(x.device, x=x, weight=weight, ptr=pairs.ptr,
                         src=pairs.src, widx=pairs.widx)
    _launch.check_dense("x", x)
    _check_weight(weight, x)
    for name in ("ptr", "src", "widx"):
        _launch.check_index(name, getattr(pairs, name))
    num_rows, (k_vol, c_in, c_out) = pairs.num_rows, weight.shape
    if pairs.k_vol > k_vol:
        raise ValueError(f"the pairs reach offset {pairs.k_vol - 1}, the "
                         f"weight has {k_vol}")
    if num_rows == 0 or pairs.num_pairs == 0 or c_in == 0 or c_out == 0:
        return torch.zeros((num_rows, c_out), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((num_rows, c_out), dtype=torch.float32, device=x.device)
    err = _lib().dg_spconv_pairs(
        _launch.DTYPE_CODE[x.dtype], x.device.index or 0,
        pairs.ptr.data_ptr(), pairs.src.data_ptr(), pairs.widx.data_ptr(),
        x.data_ptr(), weight.data_ptr(), out.data_ptr(), num_rows, c_in,
        c_out, k_vol, ROW_BLOCK, pairs.density,
        _launch.stream(x.device))
    _launch.raise_on(err, "spconv_pairs")
    LAUNCHES["spconv_pairs"] += 1
    return out


def spconv_pairs(pairs: PairCSR, x: torch.Tensor,
                 weight: torch.Tensor) -> torch.Tensor:
    """Gather-GEMM-scatter over a PairCSR: the plain version on the CPU,
    the kernel on CUDA."""
    if x.device.type == "cpu":
        return spconv_pairs_plain(pairs, x, weight)
    return spconv_pairs_cuda(pairs, x, weight)


# --- spconv_dw ---------------------------------------------------------------

def _check_dw(pairs: OffsetPairs, x, g) -> None:
    if x.dim() != 2 or g.dim() != 2 or x.dtype != g.dtype:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)} and g {g.dtype} "
                         f"{tuple(g.shape)} must be 2-D of one type")


def spconv_dw_plain(pairs: OffsetPairs, x: torch.Tensor,
                    g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch `spconv_dw` (a product per offset)."""
    _check_dw(pairs, x, g)
    return reference.spconv_dw_plain(x, g, pairs.in_ids, pairs.out_ids,
                                     pairs.widx, pairs.k_vol)


def spconv_dw_cuda(pairs: OffsetPairs, x: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """The kernel: float32 dW [k_vol, c_in, c_out] with dW[k] = the sum
    over the pairs of offset k of x[in_id]ᵀ g[out_id] (x [*, c_in], g [*,
    c_out], one type), summed chunk by chunk in a fixed order. Raises
    unless every tensor is on one CUDA device with the types it takes."""
    _launch.check_device(x.device, x=x, g=g, in_ids=pairs.in_ids,
                         out_ids=pairs.out_ids, bounds=pairs.bounds,
                         chunk_ptr=pairs.chunk_ptr)
    _launch.check_dense("x", x)
    _launch.check_dense("g", g)
    _check_dw(pairs, x, g)
    for name in ("in_ids", "out_ids", "bounds", "chunk_ptr"):
        _launch.check_index(name, getattr(pairs, name))
    c_in, c_out = x.shape[1], g.shape[1]
    if c_in == 0 or c_out == 0:
        return torch.zeros((pairs.k_vol, c_in, c_out), dtype=torch.float32,
                           device=x.device)
    dw = torch.empty((pairs.k_vol, c_in, c_out), dtype=torch.float32,
                     device=x.device)
    part = torch.empty((pairs.num_chunks, c_in, c_out), dtype=torch.float32,
                       device=x.device)
    err = _lib().dg_spconv_dw(
        _launch.DTYPE_CODE[x.dtype], x.device.index or 0,
        pairs.bounds.data_ptr(), pairs.chunk_ptr.data_ptr(),
        pairs.in_ids.data_ptr(), pairs.out_ids.data_ptr(), x.data_ptr(),
        g.data_ptr(), part.data_ptr(), dw.data_ptr(), pairs.num_chunks,
        pairs.k_vol, c_in, c_out, _launch.stream(x.device))
    _launch.raise_on(err, "spconv_dw")
    LAUNCHES["spconv_dw"] += 1
    return dw


def spconv_dw(pairs: OffsetPairs, x: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """The weight gradient over OffsetPairs: the plain version on the CPU,
    the kernel on CUDA."""
    if x.device.type == "cpu":
        return spconv_dw_plain(pairs, x, g)
    return spconv_dw_cuda(pairs, x, g)
