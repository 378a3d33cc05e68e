// Sparse 3-D convolution for Hopper (sm_90a): the gather-GEMM-scatter over
// a rulebook's pairs (forward, and dX with the transposed weights) and the
// weight gradient.
//
// Replaces two TPU kernels of `dgsparse_tpu/kernels/pallas_spconv.py`:
//   `fused_pair_matmul` (body `_fused_pair_kernel`): out[r] = sum over the
//   pairs p of row r of x[src_p] @ W[k_p], pairs ordered by destination row
//   block; the forward by output ids with W, dX by input ids with Wᵀ;
//   `fused_pair_dw` (body `_dw_kernel`): dW[k] = sum over the pairs of
//   offset k of x[in_p]ᵀ g[out_p].
// The TPU kernel projects every pair against the whole weight stack (k_vol
// times the flops) and picks each pair's slice with one-hots, because its
// matrix unit idles while gathers are dear; neither trade holds here, so
// these kernels compute each pair's product with its own weight slice only.
//
// What bounds them: at the 60K-voxel UNet's enc2 (2,078,556 pairs, 64 -> 64
// channels) one direction is 2 * 2.08 M * 64 * 64 = 17 GFLOP, 0.25 ms at the
// 67 TFLOP/s fp32 FFMA rate, against ~80 MB of compulsory bytes (24 us at
// 3.35 TB/s): operations bound it. fp32 runs on FFMA, not TF32 tensor cores,
// to keep the JAX package's Precision.HIGHEST parity (1e-5); bf16 inputs
// are converted on load and summed in fp32. wgmma, TMA and 3xTF32 are the
// later steps.
//
// spconv_pairs: each (destination row, offset) has at most one pair, so the
// pairs of a block of 64 destination rows at one offset form a dense
// product of at most 64 gathered rows with one weight slice. One CTA owns 64
// destination rows and a tile of 32 or 64 output channels. It caches its
// rows' pairs (CSR order: by row, then offset) in shared memory, walks the
// offsets in order, and at each offset compacts the rows that have a pair
// there, stages that weight slice and the gathered source rows 32 input
// channels at a time, multiplies on FFMA from a register tile and adds the
// result into its destination rows' fp32 sums in shared memory. Each row is
// written once at the end, zero where it has no pair: no atomics, and the
// sum order is fixed, so results are bitwise repeatable.
//
// spconv_dw: one CTA per (chunk of one offset's pairs, 64 x 64 tile of dW)
// stages 32 pairs' gathered x and g rows at a time and accumulates its
// [c_in, c_out] tile in registers; a second launch sums each offset's
// chunks in chunk order. Deterministic, no atomics.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kRows = 64;      // destination rows per CTA (spconv_pairs)
constexpr int kKI = 32;        // input channels staged per step
constexpr int kThreads = 256;
constexpr int kDwPairs = 32;   // pairs staged per step (spconv_dw)
constexpr int kDwTile = 64;    // dW tile: 64 input x 64 output channels

// One CTA per (64 destination rows, CT output channels). The block's pairs
// [ptr[r0], ptr[r0 + 64]) are cached in dynamic shared memory (`cap` of
// them at most: the source ids, then the offsets).
template <typename T, int CT>
__global__ void __launch_bounds__(kThreads)
    pairs_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                 const int* __restrict__ widx, const T* __restrict__ x,
                 const T* __restrict__ w, float* __restrict__ out,
                 int num_rows, int c_in, int c_out, int k_vol, int cap) {
  constexpr int TX = CT / 4;           // threads along the channels, 4 each
  constexpr int TY = kThreads / TX;    // threads along the compacted rows
  constexpr int RPT = kRows / TY;      // compacted rows per thread
  extern __shared__ int cache[];       // [cap] source ids, [cap] offsets
  __shared__ float acc_s[kRows][CT];   // the destination rows' sums
  __shared__ float xs[kRows][kKI + 1];
  __shared__ __align__(16) float ws[kKI][CT];
  __shared__ int row_ptr[kRows + 1];
  __shared__ int cursor[kRows];
  __shared__ int lrow[kRows];          // compacted: destination row
  __shared__ int lsrc[kRows];          // compacted: source row
  __shared__ int warp_count[2][kRows / kWarp];

  const int r0 = blockIdx.x * kRows;
  const int o0 = blockIdx.y * CT;
  const int tid = threadIdx.x;
  const int rows = min(kRows, num_rows - r0);
  const int p0 = ptr[r0];
  const int np = ptr[r0 + rows] - p0;
  int* c_src = cache;
  int* c_k = cache + cap;

  for (int i = tid; i <= kRows; i += kThreads)
    row_ptr[i] = ptr[r0 + min(i, rows)] - p0;
  for (int i = tid; i < np; i += kThreads) {
    c_src[i] = src[p0 + i];
    c_k[i] = widx[p0 + i];
  }
  for (int i = tid; i < kRows * CT; i += kThreads) (&acc_s[0][0])[i] = 0.f;
  __syncthreads();
  if (tid < kRows) cursor[tid] = row_ptr[tid];

  const int tx = tid % TX;
  const int ty = tid / TX;
  for (int k = 0; k < k_vol; ++k) {
    // the rows with a pair at offset k, compacted in row order (threads
    // 0..63, one row each; cursor[r] is only touched by thread r)
    bool has = false;
    int s = 0;
    if (tid < kRows) {
      const int c = cursor[tid];
      has = c < row_ptr[tid + 1] && c_k[c] == k;
      if (has) {
        s = c_src[c];
        cursor[tid] = c + 1;
      }
    }
    const unsigned ballot = __ballot_sync(kFullMask, has);
    int* count = warp_count[k & 1];
    if (tid < kRows && tid % kWarp == 0) count[tid / kWarp] = __popc(ballot);
    __syncthreads();
    if (has) {
      const int j = (tid >= kWarp ? count[0] : 0) +
                    __popc(ballot & ((1u << (tid % kWarp)) - 1u));
      lrow[j] = tid;
      lsrc[j] = s;
    }
    const int nk = count[0] + count[1];
    if (nk == 0) continue;

    float acc[RPT][4];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[r][b] = 0.f;
    const T* wk = w + static_cast<int64_t>(k) * c_in * c_out;
    for (int i0 = 0; i0 < c_in; i0 += kKI) {
      for (int e = tid; e < kKI * CT; e += kThreads) {
        const int i = e / CT, o = e % CT;
        float v = 0.f;
        if (i0 + i < c_in && o0 + o < c_out)
          v = to_float(wk[static_cast<int64_t>(i0 + i) * c_out + o0 + o]);
        ws[i][o] = v;
      }
      __syncthreads();  // lrow / lsrc complete before the gather reads them
      for (int e = tid; e < nk * kKI; e += kThreads) {
        const int j = e / kKI, i = e % kKI;
        xs[j][i] = i0 + i < c_in
                       ? to_float(x[static_cast<int64_t>(lsrc[j]) * c_in +
                                    i0 + i])
                       : 0.f;
      }
      __syncthreads();
      if (ty * RPT < nk) {
#pragma unroll 8
        for (int i = 0; i < kKI; ++i) {
          float a[RPT];
#pragma unroll
          for (int r = 0; r < RPT; ++r) a[r] = xs[ty * RPT + r][i];
          const float4 b = *reinterpret_cast<const float4*>(&ws[i][tx * 4]);
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            acc[r][0] = fmaf(a[r], b.x, acc[r][0]);
            acc[r][1] = fmaf(a[r], b.y, acc[r][1]);
            acc[r][2] = fmaf(a[r], b.z, acc[r][2]);
            acc[r][3] = fmaf(a[r], b.w, acc[r][3]);
          }
        }
      }
      __syncthreads();
    }
    // one thread per (compacted row, channel): no two write one sum
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int j = ty * RPT + r;
      if (j < nk) {
        float* dst = &acc_s[lrow[j]][tx * 4];
#pragma unroll
        for (int b = 0; b < 4; ++b) dst[b] += acc[r][b];
      }
    }
    __syncthreads();  // before the next offset rewrites lrow / lsrc
  }
  __syncthreads();
  for (int e = tid; e < rows * CT; e += kThreads) {
    const int r = e / CT, o = e % CT;
    if (o0 + o < c_out)
      out[static_cast<int64_t>(r0 + r) * c_out + o0 + o] = acc_s[r][o];
  }
}

// One CTA per (chunk c of one offset's pairs, 64 x 64 tile of dW): the
// partial sum over pairs [bounds[c], bounds[c + 1]) of x[in]ᵀ g[out], into
// part[c] [c_in, c_out].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_partial_kernel(const int* __restrict__ bounds,
                      const int* __restrict__ in_ids,
                      const int* __restrict__ out_ids,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int c_in, int c_out) {
  __shared__ __align__(16) float xs[kDwPairs][kDwTile + 4];
  __shared__ __align__(16) float gs[kDwPairs][kDwTile + 4];
  const int c = blockIdx.x;
  const int i0 = blockIdx.y * kDwTile;
  const int o0 = blockIdx.z * kDwTile;
  const int tid = threadIdx.x;
  const int ti = tid / 16;  // input channels ti*4 .. ti*4+3
  const int to = tid % 16;  // output channels to*4 .. to*4+3
  const int lo = bounds[c];
  const int hi = bounds[c + 1];

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int q0 = lo; q0 < hi; q0 += kDwPairs) {
    for (int e = tid; e < kDwPairs * kDwTile; e += kThreads) {
      const int p = e / kDwTile, j = e % kDwTile;
      const int q = q0 + p;
      float xv = 0.f, gv = 0.f;
      if (q < hi) {
        if (i0 + j < c_in)
          xv = to_float(x[static_cast<int64_t>(in_ids[q]) * c_in + i0 + j]);
        if (o0 + j < c_out)
          gv = to_float(g[static_cast<int64_t>(out_ids[q]) * c_out + o0 + j]);
      }
      xs[p][j] = xv;
      gs[p][j] = gv;
    }
    __syncthreads();
#pragma unroll 8
    for (int p = 0; p < kDwPairs; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[p][ti * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&gs[p][to * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][0] = fmaf(av[r], b.x, acc[r][0]);
        acc[r][1] = fmaf(av[r], b.y, acc[r][1]);
        acc[r][2] = fmaf(av[r], b.z, acc[r][2]);
        acc[r][3] = fmaf(av[r], b.w, acc[r][3]);
      }
    }
    __syncthreads();
  }
  float* pc = part + static_cast<int64_t>(c) * c_in * c_out;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ti * 4 + a;
    if (i >= c_in) break;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + to * 4 + b;
      if (o < c_out) pc[static_cast<int64_t>(i) * c_out + o] = acc[a][b];
    }
  }
}

// dw[k] = sum of part[c] over the chunks c in [chunk_ptr[k],
// chunk_ptr[k + 1]), in chunk order; 0 for an offset without pairs.
__global__ void __launch_bounds__(kThreads)
    dw_reduce_kernel(const int* __restrict__ chunk_ptr,
                     const float* __restrict__ part, float* __restrict__ dw,
                     int size) {
  const int k = blockIdx.y;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= size) return;
  float s = 0.f;
  for (int c = chunk_ptr[k]; c < chunk_ptr[k + 1]; ++c)
    s += part[static_cast<int64_t>(c) * size + e];
  dw[static_cast<int64_t>(k) * size + e] = s;
}

template <typename T, int CT>
int launch_pairs_ct(const int* ptr, const int* src, const int* widx,
                    const void* x, const void* w, float* out, int num_rows,
                    int c_in, int c_out, int k_vol, int cap,
                    cudaStream_t s) {
  const size_t smem = 2 * sizeof(int) * static_cast<size_t>(cap);
  auto kernel = pairs_kernel<T, CT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((num_rows + kRows - 1) / kRows, (c_out + CT - 1) / CT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, s>>>(
      ptr, src, widx, static_cast<const T*>(x), static_cast<const T*>(w), out,
      num_rows, c_in, c_out, k_vol, cap);
  return cudaGetLastError();
}

template <typename T>
int launch_pairs(int device, const int* ptr, const int* src, const int* widx,
                 const void* x, const void* w, float* out, int num_rows,
                 int c_in, int c_out, int k_vol, int cap, void* stream) {
  if (num_rows <= 0 || c_in <= 0 || c_out <= 0 || k_vol <= 0 || cap < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c_out <= 32)
    return launch_pairs_ct<T, 32>(ptr, src, widx, x, w, out, num_rows, c_in,
                                  c_out, k_vol, cap, s);
  return launch_pairs_ct<T, 64>(ptr, src, widx, x, w, out, num_rows, c_in,
                                c_out, k_vol, cap, s);
}

template <typename T>
int launch_dw(int device, const int* bounds, const int* chunk_ptr,
              const int* in_ids, const int* out_ids, const void* x,
              const void* g, float* part, float* dw, int num_chunks,
              int k_vol, int c_in, int c_out, void* stream) {
  if (num_chunks < 0 || k_vol <= 0 || c_in <= 0 || c_out <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_chunks > 0) {
    const dim3 grid(num_chunks, (c_in + kDwTile - 1) / kDwTile,
                    (c_out + kDwTile - 1) / kDwTile);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
    dw_partial_kernel<T><<<grid, kThreads, 0, s>>>(
        bounds, in_ids, out_ids, static_cast<const T*>(x),
        static_cast<const T*>(g), part, c_in, c_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int size = c_in * c_out;
  const dim3 grid((size + kThreads - 1) / kThreads, k_vol);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  dw_reduce_kernel<<<grid, kThreads, 0, s>>>(chunk_ptr, part, dw, size);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out [num_rows, c_out] fp32, every row written: out[r] = sum over the pairs
// p in [ptr[r], ptr[r + 1]) of x[src[p]] @ w[widx[p]], x [*, c_in] and w
// [k_vol, c_in, c_out] in `dtype` (0 fp32, 1 bf16). Each row's pairs are
// sorted by offset, each (row, offset) at most once, and no `row_block`
// rows (which must be 64) hold more than `cap` pairs. Returns a
// cudaError_t.
int dg_spconv_pairs(int dtype, int device, const int* ptr, const int* src,
                    const int* widx, const void* x, const void* w,
                    float* out, int num_rows, int c_in, int c_out, int k_vol,
                    int row_block, int cap, void* stream) {
  if (row_block != kRows) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_pairs<float>(device, ptr, src, widx, x, w, out, num_rows,
                               c_in, c_out, k_vol, cap, stream);
  if (dtype == kBFloat16)
    return launch_pairs<__nv_bfloat16>(device, ptr, src, widx, x, w, out,
                                       num_rows, c_in, c_out, k_vol, cap,
                                       stream);
  return cudaErrorInvalidValue;
}

// dw [k_vol, c_in, c_out] fp32: dw[k] = sum over the chunks c of offset k
// (chunk_ptr [k_vol + 1]) and their pairs q in [bounds[c], bounds[c + 1])
// of x[in_ids[q]]ᵀ g[out_ids[q]], x [*, c_in] and g [*, c_out] in `dtype`;
// part is scratch of num_chunks * c_in * c_out floats. Returns a
// cudaError_t.
int dg_spconv_dw(int dtype, int device, const int* bounds,
                 const int* chunk_ptr, const int* in_ids, const int* out_ids,
                 const void* x, const void* g, float* part, float* dw,
                 int num_chunks, int k_vol, int c_in, int c_out,
                 void* stream) {
  if (dtype == kFloat32)
    return launch_dw<float>(device, bounds, chunk_ptr, in_ids, out_ids, x, g,
                            part, dw, num_chunks, k_vol, c_in, c_out, stream);
  if (dtype == kBFloat16)
    return launch_dw<__nv_bfloat16>(device, bounds, chunk_ptr, in_ids,
                                    out_ids, x, g, part, dw, num_chunks,
                                    k_vol, c_in, c_out, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
