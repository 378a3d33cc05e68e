// Dense-cell SpMM (forward and transpose) and dense-cell SDDMM for Hopper
// (sm_90a): the hybrid plan's materialized tier.
//
// Replaces two TPU kernels:
//   `dgsparse_tpu/kernels/pallas_spmm.py::spmm_dense_cells` (body
//   `_cell_matmul_kernel`): out[seg[t]] += cells[order[t]] @ B[win[t]], or
//   cellᵀ @ g into column windows with `transpose`, from the same cells;
//   `dgsparse_tpu/kernels/pallas_sddmm.py::sddmm_cells` (body
//   `_sddmm_cells_kernel`): out[t] = d1[rb[t]] @ d2[cw[t]]ᵀ, the [128, 128]
//   block of per-edge dots of each cell.
// The TPU kernels walk the cells in one sequential grid and carry a row
// block's sum in VMEM from one grid step to the next; here CTAs run in
// parallel, so one CTA owns one output block and walks that block's run of
// cells itself (a CSR over blocks, `blk_ptr`), keeping the sum in registers
// and writing it once, with no atomics: results are bitwise repeatable, and
// a block no cell visits is written as zero (the tier sum relies on it).
//
// What bounds them: a 128x128 cell times a [128, F] window is 2*128*128*F
// flops on 64 KB of cell and 512*F bytes of window, ~F/4 flops a byte, so
// at the GCN widths (F = 41, 64) the fp32 FFMA rate and the cell bytes
// bound it about equally (13.3 GFLOP and ~0.54 GB at Reddit scale, F = 64).
// fp32 runs on FFMA, not TF32 tensor cores, to keep the JAX package's
// Precision.HIGHEST parity (1e-5); bf16 inputs are converted on load and
// summed in fp32. Design: a CTA of 256 threads computes a [128, 64] tile;
// k-slices of 32 of the cell and of the window are staged in shared memory
// (the transpose reads the staged cell transposed, no transposed copy of
// the cells exists) and each thread accumulates an 8x4 register tile.
// A tensor-core version (wgmma on bf16, 3xTF32 for fp32, TMA loads) is the
// later step.
//
// Offsets indexed by cell * 16384 or by row * F are 64-bit: at Reddit
// scale the cell array holds ~1.04e8 floats.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kR = 128;       // cell rows (row block)
constexpr int kC = 128;       // cell columns (column window)
constexpr int kCell = kR * kC;
constexpr int kK = 32;        // contraction slice staged per step
constexpr int kFT = 64;       // output features per CTA (SpMM)
constexpr int kThreads = 256;

// One CTA per (output block, 64-feature tile). Forward: output block = row
// block, A = cell [R, C], B rows = column window. Transpose: output block =
// column window, A = cellᵀ [C, R], B rows = row block. order[p] (or p when
// NULL) is the p-th cell of the block runs blk_ptr delimits; win[cell] is
// the cell's B block.
template <typename T, bool TRANSPOSE>
__global__ void __launch_bounds__(kThreads)
    dense_cells_kernel(const float* __restrict__ cells,
                       const int* __restrict__ blk_ptr,
                       const int* __restrict__ order,
                       const int* __restrict__ win, const T* __restrict__ b,
                       float* __restrict__ out, int out_rows, int in_rows,
                       int feat) {
  __shared__ float As[kR][kK + 1];                 // As[r][k] = A(r, k0 + k)
  __shared__ __align__(16) float Bs[kK][kFT];      // Bs[k][f] = B(k0 + k, f)
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // output columns tx*4 .. tx*4+3
  const int ty = tid / 16;  // output rows ty*8 .. ty*8+7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int p0 = blk_ptr[blk];
  const int p1 = blk_ptr[blk + 1];
  for (int p = p0; p < p1; ++p) {
    const int c = order != nullptr ? order[p] : p;
    const float* cell = cells + static_cast<int64_t>(c) * kCell;
    const int64_t in0 = static_cast<int64_t>(win[c]) * kC;
    for (int k0 = 0; k0 < kC; k0 += kK) {
      // A slice: 128 x 32 floats as 1024 float4 loads, 4 per thread
#pragma unroll
      for (int it = 0; it < kR * kK / 4 / kThreads; ++it) {
        const int i = tid + it * kThreads;
        if (!TRANSPOSE) {
          const int r = i / (kK / 4), kq = i % (kK / 4);  // row r of cell
          const float4 v = *reinterpret_cast<const float4*>(
              cell + r * kC + k0 + 4 * kq);
          As[r][4 * kq + 0] = v.x;
          As[r][4 * kq + 1] = v.y;
          As[r][4 * kq + 2] = v.z;
          As[r][4 * kq + 3] = v.w;
        } else {
          const int k = i / (kR / 4), rq = i % (kR / 4);  // row k0+k of cell
          const float4 v = *reinterpret_cast<const float4*>(
              cell + (k0 + k) * kC + 4 * rq);
          As[4 * rq + 0][k] = v.x;
          As[4 * rq + 1][k] = v.y;
          As[4 * rq + 2][k] = v.z;
          As[4 * rq + 3][k] = v.w;
        }
      }
      // B slice: 32 rows x 64 features, zero past the matrix
#pragma unroll
      for (int it = 0; it < kK * kFT / kThreads; ++it) {
        const int i = tid + it * kThreads;
        const int k = i / kFT, f = i % kFT;
        const int64_t row = in0 + k0 + k;
        float v = 0.f;
        if (row < in_rows && f0 + f < feat)
          v = to_float(b[row * feat + f0 + f]);
        Bs[k][f] = v;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kK; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[ty * 8 + i][k];
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][0] = fmaf(a[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int64_t row = static_cast<int64_t>(blk) * kR + ty * 8 + i;
    if (row >= out_rows) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + tx * 4 + j;
      if (f < feat) out[row * feat + f] = acc[i][j];
    }
  }
}

// One CTA per cell: the [128, 128] block d1[rb] @ d2[cw]ᵀ over F features,
// staged 32 features at a time; each thread holds an 8x8 tile of rows
// ty + 16 i and columns tx + 16 j (conflict-free shared reads).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sddmm_cells_kernel(const int* __restrict__ cell_rb,
                       const int* __restrict__ cell_cw,
                       const T* __restrict__ d1, const T* __restrict__ d2,
                       float* __restrict__ out, int num_rows, int num_cols,
                       int feat) {
  __shared__ float As[kK][kR + 1];  // As[k][r] = d1[r0 + r, f0 + k]
  __shared__ float Bs[kK][kC + 1];  // Bs[k][c] = d2[c0 + c, f0 + k]
  const int cell = blockIdx.x;
  const int64_t r0 = static_cast<int64_t>(cell_rb[cell]) * kR;
  const int64_t c0 = static_cast<int64_t>(cell_cw[cell]) * kC;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int f0 = 0; f0 < feat; f0 += kK) {
#pragma unroll 4
    for (int it = 0; it < kR * kK / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int r = i / kK, k = i % kK;  // a warp reads 32 features of a row
      const bool in_f = f0 + k < feat;
      const int64_t row = r0 + r, col = c0 + r;
      As[k][r] = in_f && row < num_rows ? to_float(d1[row * feat + f0 + k])
                                        : 0.f;
      Bs[k][r] = in_f && col < num_cols ? to_float(d2[col * feat + f0 + k])
                                        : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kK; ++k) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + static_cast<int64_t>(cell) * kCell;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      o[(ty + 16 * i) * kC + tx + 16 * j] = acc[i][j];
}

template <typename T>
int launch_cells(int device, const float* cells, const int* blk_ptr,
                 const int* order, const int* win, const void* b, float* out,
                 int num_blocks, int out_rows, int in_rows, int feat,
                 int transpose, void* stream) {
  if (num_blocks <= 0 || feat <= 0 || out_rows <= 0 || in_rows <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (feat + kFT - 1) / kFT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* bt = static_cast<const T*>(b);
  if (transpose)
    dense_cells_kernel<T, true><<<grid, kThreads, 0, s>>>(
        cells, blk_ptr, order, win, bt, out, out_rows, in_rows, feat);
  else
    dense_cells_kernel<T, false><<<grid, kThreads, 0, s>>>(
        cells, blk_ptr, order, win, bt, out, out_rows, in_rows, feat);
  return cudaGetLastError();
}

template <typename T>
int launch_sddmm(int device, const int* cell_rb, const int* cell_cw,
                 const void* d1, const void* d2, float* out, int num_cells,
                 int num_rows, int num_cols, int feat, void* stream) {
  if (num_cells <= 0 || feat <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  sddmm_cells_kernel<T><<<num_cells, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      cell_rb, cell_cw, static_cast<const T*>(d1),
      static_cast<const T*>(d2), out, num_rows, num_cols, feat);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [out_rows, F] fp32, every row written: for each output block
// (num_blocks of 128 rows) the sum over its cells p in [blk_ptr[blk],
// blk_ptr[blk+1]) of A(cell) @ B[win[cell] * 128 : +128], cell = order[p]
// (order NULL: p), A = the cell [128, 128] fp32 or, with transpose != 0,
// its transpose. B [in_rows, F] in `dtype` (0 fp32, 1 bf16); B rows past
// in_rows count as 0. Returns a cudaError_t.
int dg_spmm_dense_cells(int dtype, int device, const float* cells,
                        const int* blk_ptr, const int* order, const int* win,
                        const void* b, float* out, int num_blocks,
                        int out_rows, int in_rows, int feat, int transpose,
                        void* stream) {
  if (dtype == kFloat32)
    return launch_cells<float>(device, cells, blk_ptr, order, win, b, out,
                               num_blocks, out_rows, in_rows, feat,
                               transpose, stream);
  if (dtype == kBFloat16)
    return launch_cells<__nv_bfloat16>(device, cells, blk_ptr, order, win,
                                       b, out, num_blocks, out_rows, in_rows,
                                       feat, transpose, stream);
  return cudaErrorInvalidValue;
}

// out [num_cells * 128 * 128] fp32: per cell t the block
// d1[cell_rb[t] * 128 + r] . d2[cell_cw[t] * 128 + c] for r, c < 128, over
// F features of d1 [num_rows, F] and d2 [num_cols, F] in `dtype`; rows
// past num_rows / num_cols count as 0. Returns a cudaError_t.
int dg_sddmm_cells(int dtype, int device, const int* cell_rb,
                   const int* cell_cw, const void* d1, const void* d2,
                   float* out, int num_cells, int num_rows, int num_cols,
                   int feat, void* stream) {
  if (dtype == kFloat32)
    return launch_sddmm<float>(device, cell_rb, cell_cw, d1, d2, out,
                               num_cells, num_rows, num_cols, feat, stream);
  if (dtype == kBFloat16)
    return launch_sddmm<__nv_bfloat16>(device, cell_rb, cell_cw, d1, d2,
                                       out, num_cells, num_rows, num_cols,
                                       feat, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
