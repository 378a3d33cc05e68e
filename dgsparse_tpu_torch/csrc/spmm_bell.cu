// Blocked-ELL SpMM (SUM) for Hopper (sm_90a): the hybrid plan's middle
// tier.
//
// Replaces the TPU kernel `dgsparse_tpu/kernels/pallas_spmm.py::spmm_bell`
// (body `_bell_kernel`). There each tile of `edge_tile` edge slots, all in
// one (128-row block x 128-column window) cell, gathers its rows of B by a
// one-hot [E, C] matmul against the window and scatters the scaled rows
// into the row block by a one-hot [R, E] matmul, so no random memory
// access reaches HBM; the row block's sum rides in VMEM across the
// sequential grid. Here one CTA owns one row block and walks that block's
// run of tiles (`tile_ptr`): per tile it stages the B window [128, 32
// features] in shared memory, then gathers from there, scales by the slot's
// value (0 on padding) and adds into a [128, 32] output block kept in shared
// memory, written once at the end. Row blocks without tiles are written as
// zero (the padding tiles the plan appends for them are never read).
//
// What bounds it: each tile reads its 16 KB window slice (fp32) once for up
// to `edge_tile` gathers, so on the sparse BELL cells (96-767 edges of
// 16,384 slots) the window reads, not the 2*E*F flops, bound it. Each
// thread owns one feature column and walks the tile's slots in order,
// flushing its running sum into the output block when the slot's row
// changes (within a cell BELL keeps CSR order, so rows do not decrease
// inside a tile): no atomics, and results are bitwise repeatable.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kR = 128;     // row block
constexpr int kC = 128;     // column window
constexpr int kFT = 32;     // features per CTA: one warp, one per thread
constexpr int kMaxTile = 1024;

template <typename T>
__global__ void __launch_bounds__(kFT)
    bell_kernel(const int* __restrict__ tile_ptr,
                const int* __restrict__ tile_cw,
                const int* __restrict__ lcol, const int* __restrict__ lrow,
                const float* __restrict__ vals, const T* __restrict__ b,
                float* __restrict__ out, int edge_tile, int out_rows,
                int in_rows, int feat) {
  __shared__ float Bs[kC][kFT];
  __shared__ float Os[kR][kFT];
  __shared__ int s_col[kMaxTile];
  __shared__ int s_row[kMaxTile];
  __shared__ float s_val[kMaxTile];
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int f = threadIdx.x;
  const bool active = f0 + f < feat;

  for (int r = 0; r < kR; ++r) Os[r][f] = 0.f;
  const int t0 = tile_ptr[blk];
  const int t1 = tile_ptr[blk + 1];
  for (int t = t0; t < t1; ++t) {
    const int64_t in0 = static_cast<int64_t>(tile_cw[t]) * kC;
    const int64_t e0 = static_cast<int64_t>(t) * edge_tile;
    __syncwarp();
    for (int c = 0; c < kC; ++c) {
      const int64_t row = in0 + c;
      Bs[c][f] = active && row < in_rows ? to_float(b[row * feat + f0 + f])
                                         : 0.f;
    }
    for (int e = f; e < edge_tile; e += kFT) {
      s_col[e] = lcol[e0 + e];
      s_row[e] = lrow[e0 + e];
      s_val[e] = vals[e0 + e];
    }
    __syncwarp();
    float acc = 0.f;
    int cur = s_row[0];
    for (int e = 0; e < edge_tile; ++e) {
      const int r = s_row[e];
      if (r != cur) {
        Os[cur][f] += acc;
        acc = 0.f;
        cur = r;
      }
      acc = fmaf(s_val[e], Bs[s_col[e]][f], acc);
    }
    Os[cur][f] += acc;
  }
  if (!active) return;
  for (int r = 0; r < kR; ++r) {
    const int64_t row = static_cast<int64_t>(blk) * kR + r;
    if (row >= out_rows) break;
    out[row * feat + f0 + f] = Os[r][f];
  }
}

template <typename T>
int launch(int device, const int* tile_ptr, const int* tile_cw,
           const int* lcol, const int* lrow, const float* vals, const void* b,
           float* out, int num_blocks, int edge_tile, int out_rows,
           int in_rows, int feat, void* stream) {
  if (num_blocks <= 0 || feat <= 0 || out_rows <= 0 || edge_tile <= 0 ||
      edge_tile > kMaxTile)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (feat + kFT - 1) / kFT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  bell_kernel<T><<<grid, kFT, 0, static_cast<cudaStream_t>(stream)>>>(
      tile_ptr, tile_cw, lcol, lrow, vals, static_cast<const T*>(b), out,
      edge_tile, out_rows, in_rows, feat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [out_rows, F] fp32, every row written: for row block blk the sum over
// its tiles t in [tile_ptr[blk], tile_ptr[blk+1]) and slots e of tile t of
// vals[t*E + e] * B[tile_cw[t] * 128 + lcol[t*E + e]] into row
// blk * 128 + lrow[t*E + e]. B [in_rows, F] in `dtype` (0 fp32, 1 bf16);
// E = edge_tile <= 1024. Returns a cudaError_t.
int dg_spmm_bell(int dtype, int device, const int* tile_ptr,
                 const int* tile_cw, const int* lcol, const int* lrow,
                 const float* vals, const void* b, float* out,
                 int num_blocks, int edge_tile, int out_rows, int in_rows,
                 int feat, void* stream) {
  if (dtype == kFloat32)
    return launch<float>(device, tile_ptr, tile_cw, lcol, lrow, vals, b, out,
                         num_blocks, edge_tile, out_rows, in_rows, feat,
                         stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(device, tile_ptr, tile_cw, lcol, lrow,
                                 vals, b, out, num_blocks, edge_tile,
                                 out_rows, in_rows, feat, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
