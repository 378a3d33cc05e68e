// CSR SpMM with MAX/MIN reductions and its masked backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// `dgsparse_tpu/kernels/pallas_spmm_maxmin.py::spmm_maxmin_esc` (an
// in-register segmented max-scan over edge tiles, a one-hot selection
// matmul for each row's winner, and plan-slot winner ids) and, for the
// backward, the XLA winner-mask gathers and sorted segment sum of
// `dgsparse_tpu/ops/spmm.py` (`:439-528`), which materialise [nnz, F]
// masks. These are the reference's csrspmm_seqreduce_rowbalance_kernel with
// its `E` argmax tensor and the masked kernels that replay it
// (SURVEY.md 2.4-2.5):
//
//   dg_spmm_maxmin    out[m, f] = max/min over e in row m of
//                     compute(w[e], X[col[e], f]), and arg[m, f] = the CSR
//                     edge id e of the winner. compute is a template
//                     parameter: copy (X alone), ADD X + w, SUB X - w,
//                     MUL X * w, DIV X / w. A tie keeps the earliest edge
//                     (update on strict improvement only); an empty row
//                     gives 0 and arg = nnz; a non-finite extremum gives 0.
//   dg_maxmin_d_dense d[c, f] = sum over the CSC column c of
//                     [arg[row_k, f] == perm[k]] * g[row_k, f] * w_csc[k]
//                     (w = d compute / d X, 1 when NULL).
//   dg_maxmin_d_values d[e, h] = sum over the features f of head h of
//                     [arg[row_e, f] == e] * g[row_e, f] * (X[col_e, f] in
//                     "dot" mode, 1 in "sum" mode); the wrapper applies the
//                     remaining factor of d compute / d w.
//
// Heads: w [nnz, H] with X [N, H*F], feature j taking w[e, j / F], as in
// csrc/spmm_csr.cu.
//
// What bounds them: the forward gathers a random F-element row of X for
// every edge and writes out and arg once, so it is bound by those gathers,
// like the SUM kernel, and moves 4 more bytes per output element (arg). The
// design is that kernel's: one warp per (row, 32*VEC-feature slice), col and
// w read 32 at a time and broadcast by __shfl_sync, VEC-wide loads, the
// running extremum and its edge id in registers, each output written once,
// no atomics. The row is walked in CSR order by one warp, so "earliest edge
// wins a tie" needs no merge of partials.
// d_dense is one warp per CSC column: per edge of the column it gathers the
// row's arg slice (VEC int32 per lane) and only where an element won
// through this edge also the g slice; no atomics, and sentinel winners
// (nnz) never match an edge id. It reads each row's arg once per edge of
// the row, about nnz * F * 4 bytes where the bound counts M * F * 4.
// d_values is one warp per CSR row: the row's arg and g sit in registers (8
// elements a lane, 256 features a pass), each edge's masked sum is reduced
// by xor shuffles only when some lane won through it, and X is read only at
// winning elements. Lane 0 adds each pass's sum into the edge's output,
// which the wrapper zero-fills; a row's edges belong to its warp alone, so
// there are no atomics.

#include <type_traits>

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kRowK = 8;  // elements a lane holds in d_values: 256 a pass

enum Compute : int { kCopy = 0, kAdd = 1, kSub = 2, kMul = 3, kDiv = 4 };

template <int C>
__device__ __forceinline__ float combine(float w, float x) {
  if constexpr (C == kAdd) {
    return x + w;
  } else if constexpr (C == kSub) {
    return x - w;
  } else if constexpr (C == kMul) {
    return x * w;
  } else if constexpr (C == kDiv) {
    return x / w;
  } else {
    return x;
  }
}

template <typename T, int VEC, int C, bool IS_MIN, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    maxmin_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                  const float* __restrict__ val, const T* __restrict__ src,
                  T* __restrict__ out, int* __restrict__ arg, int num_rows,
                  int feat, int heads, int head_feat, int nnz) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int f0 = (blockIdx.y * kWarp + lane) * VEC;
  const bool active = f0 < feat;  // VEC divides feat: the whole vector fits
  const int head = HEADS && active ? f0 / head_feat : 0;
  const int start = rowptr[row];
  const int end = rowptr[row + 1];

  float best[VEC];
  int win[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    best[k] = 0.f;
    win[k] = nnz;
  }
  for (int base = start; base < end; base += kWarp) {
    const int e = base + lane;
    int src_row = 0;
    float w = 1.f;
    if (e < end) {
      src_row = col[e];
      if (C != kCopy && !HEADS) w = val[e];
    }
    const int n = min(kWarp, end - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kFullMask, src_row, j);
      float wj = __shfl_sync(kFullMask, w, j);
      if (active) {
        if (C != kCopy && HEADS)
          wj = val[static_cast<int64_t>(base + j) * heads + head];
        const Packed<T, VEC> x = *reinterpret_cast<const Packed<T, VEC>*>(
            src + static_cast<int64_t>(r) * feat + f0);
        const bool first = base + j == start;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float v = combine<C>(wj, to_float(x.v[k]));
          if (first || (IS_MIN ? v < best[k] : v > best[k])) {
            best[k] = v;
            win[k] = base + j;
          }
        }
      }
    }
  }
  if (!active) return;
  Packed<T, VEC> y;
  Packed<int, VEC> a;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    y.v[k] = from_float<T>(isfinite(best[k]) ? best[k] : 0.f);
    a.v[k] = win[k];
  }
  const int64_t o = static_cast<int64_t>(row) * feat + f0;
  *reinterpret_cast<Packed<T, VEC>*>(out + o) = y;
  *reinterpret_cast<Packed<int, VEC>*>(arg + o) = a;
}

template <typename T, int VEC, bool WEIGHTED, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    d_dense_kernel(const int* __restrict__ colptr,
                   const int* __restrict__ row_csc,
                   const int* __restrict__ perm,
                   const float* __restrict__ w_csc, const T* __restrict__ g,
                   const int* __restrict__ arg, T* __restrict__ out,
                   int num_cols, int feat, int heads, int head_feat) {
  const int c = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (c >= num_cols) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int f0 = (blockIdx.y * kWarp + lane) * VEC;
  const bool active = f0 < feat;
  const int head = HEADS && active ? f0 / head_feat : 0;
  const int start = colptr[c];
  const int end = colptr[c + 1];

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int base = start; base < end; base += kWarp) {
    const int k_mine = base + lane;
    int r_mine = 0, e_mine = -1;
    float w = 1.f;
    if (k_mine < end) {
      r_mine = row_csc[k_mine];
      e_mine = perm[k_mine];
      if (WEIGHTED && !HEADS) w = w_csc[k_mine];
    }
    const int n = min(kWarp, end - base);
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kFullMask, r_mine, j);
      const int e = __shfl_sync(kFullMask, e_mine, j);
      float wj = __shfl_sync(kFullMask, w, j);
      if (!active) continue;
      const int64_t o = static_cast<int64_t>(r) * feat + f0;
      const Packed<int, VEC> a = *reinterpret_cast<const Packed<int, VEC>*>(
          arg + o);
      bool any = false;
#pragma unroll
      for (int k = 0; k < VEC; ++k) any |= a.v[k] == e;
      if (!any) continue;
      if (WEIGHTED && HEADS)
        wj = w_csc[static_cast<int64_t>(base + j) * heads + head];
      const Packed<T, VEC> x = *reinterpret_cast<const Packed<T, VEC>*>(g + o);
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (a.v[k] == e) acc[k] += wj * to_float(x.v[k]);
    }
  }
  if (!active) return;
  Packed<T, VEC> y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[k]);
  *reinterpret_cast<Packed<T, VEC>*>(out + static_cast<int64_t>(c) * feat +
                                     f0) = y;
}

template <typename T, bool DOT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    d_values_kernel(const int* __restrict__ rowptr,
                    const int* __restrict__ col, const int* __restrict__ arg,
                    const T* __restrict__ g, const T* __restrict__ src,
                    float* __restrict__ out, int num_rows, int heads,
                    int head_feat) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (start == end) return;
  const int lane = threadIdx.x;
  const int feat = heads * head_feat;
  const int64_t row_off = static_cast<int64_t>(row) * feat;

  for (int h = 0; h < heads; ++h) {
    for (int c0 = 0; c0 < head_feat; c0 += kWarp * kRowK) {
      // this lane's features of the pass: h * head_feat + c0 + lane + 32k
      int a[kRowK];
      float gv[kRowK];
      bool mine = false;
#pragma unroll
      for (int k = 0; k < kRowK; ++k) {
        const int f = c0 + lane + k * kWarp;
        const bool ok = f < head_feat;
        const int64_t o = row_off + h * head_feat + f;
        a[k] = ok ? arg[o] : -1;
        gv[k] = ok ? to_float(g[o]) : 0.f;
        mine |= a[k] >= start && a[k] < end;
      }
      if (!__any_sync(kFullMask, mine)) continue;
      for (int base = start; base < end; base += kWarp) {
        const int k_mine = base + lane;
        const int col_mine = DOT && k_mine < end ? col[k_mine] : 0;
        const int n = min(kWarp, end - base);
        for (int j = 0; j < n; ++j) {
          const int e = base + j;
          const int cj = __shfl_sync(kFullMask, col_mine, j);
          float p = 0.f;
          bool hit = false;
#pragma unroll
          for (int k = 0; k < kRowK; ++k) {
            if (a[k] != e) continue;
            hit = true;
            if (DOT) {
              const int f = h * head_feat + c0 + lane + k * kWarp;
              p += gv[k] * to_float(src[static_cast<int64_t>(cj) * feat + f]);
            } else {
              p += gv[k];
            }
          }
          if (!__any_sync(kFullMask, hit)) continue;
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1)
            p += __shfl_xor_sync(kFullMask, p, off);
          if (lane == 0) out[static_cast<int64_t>(e) * heads + h] += p;
        }
      }
    }
  }
}

// Widest vector (at most 16 bytes of T) that divides the head width, still
// gives every lane of a warp work, and that every pointer is aligned for
// (int32 pointers at VEC * 4 bytes).
template <typename T>
int pick_vec(int feat, int head_feat, const void* a, const void* b,
             const void* idx) {
  for (int vec = 16 / static_cast<int>(sizeof(T)); vec > 1; vec /= 2) {
    const int bytes = vec * static_cast<int>(sizeof(T));
    if (head_feat % vec == 0 && feat >= kWarp * vec && aligned(a, bytes) &&
        aligned(b, bytes) && aligned(idx, vec * 4))
      return vec;
  }
  return 1;
}

// Calls f(std::integral_constant<int, VEC>) for the runtime `vec`.
template <typename T, typename F>
void with_vec(int vec, F&& f) {
  switch (vec) {
    case 8:
      // only reachable for 2-byte types (16 bytes / 2)
      if constexpr (sizeof(T) == 2) f(std::integral_constant<int, 8>());
      break;
    case 4:
      f(std::integral_constant<int, 4>());
      break;
    case 2:
      f(std::integral_constant<int, 2>());
      break;
    default:
      f(std::integral_constant<int, 1>());
  }
}

dim3 row_grid(int rows, int feat, int vec) {
  const int slice = kWarp * vec;
  return dim3((rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
              (feat + slice - 1) / slice);
}

template <typename T, int C, bool IS_MIN, bool HEADS>
int launch_forward(const int* rowptr, const int* col, const float* val,
                   const void* x, void* out, int* arg, int num_rows, int feat,
                   int heads, int nnz, cudaStream_t s) {
  const int vec = pick_vec<T>(feat, feat / heads, x, out, arg);
  const dim3 grid = row_grid(num_rows, feat, vec);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  with_vec<T>(vec, [&](auto v) {
    maxmin_kernel<T, decltype(v)::value, C, IS_MIN, HEADS>
        <<<grid, dim3(kWarp, kWarpsPerBlock), 0, s>>>(
            rowptr, col, val, static_cast<const T*>(x), static_cast<T*>(out),
            arg, num_rows, feat, heads, feat / heads, nnz);
  });
  return cudaGetLastError();
}

template <typename T, bool IS_MIN, bool HEADS>
int forward_compute(int compute, const int* rowptr, const int* col,
                    const float* val, const void* x, void* out, int* arg,
                    int num_rows, int feat, int heads, int nnz,
                    cudaStream_t s) {
#define DG_FWD(C)                                                         \
  launch_forward<T, C, IS_MIN, HEADS>(rowptr, col, val, x, out, arg,      \
                                      num_rows, feat, heads, nnz, s)
  switch (compute) {
    case kCopy:
      return DG_FWD(kCopy);
    case kAdd:
      return DG_FWD(kAdd);
    case kSub:
      return DG_FWD(kSub);
    case kMul:
      return DG_FWD(kMul);
    case kDiv:
      return DG_FWD(kDiv);
  }
#undef DG_FWD
  return cudaErrorInvalidValue;
}

template <typename T>
int forward(int compute, int is_min, const int* rowptr, const int* col,
            const float* val, const void* x, void* out, int* arg,
            int num_rows, int feat, int heads, int nnz, cudaStream_t s) {
  const bool multi = heads > 1 && compute != kCopy;
  if (is_min) {
    return multi ? forward_compute<T, true, true>(compute, rowptr, col, val,
                                                  x, out, arg, num_rows, feat,
                                                  heads, nnz, s)
                 : forward_compute<T, true, false>(compute, rowptr, col, val,
                                                   x, out, arg, num_rows,
                                                   feat, heads, nnz, s);
  }
  return multi ? forward_compute<T, false, true>(compute, rowptr, col, val, x,
                                                 out, arg, num_rows, feat,
                                                 heads, nnz, s)
               : forward_compute<T, false, false>(compute, rowptr, col, val,
                                                  x, out, arg, num_rows, feat,
                                                  heads, nnz, s);
}

template <typename T, bool WEIGHTED, bool HEADS>
int launch_d_dense(const int* colptr, const int* row_csc, const int* perm,
                   const float* w_csc, const void* g, const int* arg,
                   void* out, int num_cols, int feat, int heads,
                   cudaStream_t s) {
  const int vec = pick_vec<T>(feat, feat / heads, g, out, arg);
  const dim3 grid = row_grid(num_cols, feat, vec);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  with_vec<T>(vec, [&](auto v) {
    d_dense_kernel<T, decltype(v)::value, WEIGHTED, HEADS>
        <<<grid, dim3(kWarp, kWarpsPerBlock), 0, s>>>(
            colptr, row_csc, perm, w_csc, static_cast<const T*>(g), arg,
            static_cast<T*>(out), num_cols, feat, heads, feat / heads);
  });
  return cudaGetLastError();
}

template <typename T>
int d_dense(const int* colptr, const int* row_csc, const int* perm,
            const float* w_csc, const void* g, const int* arg, void* out,
            int num_cols, int feat, int heads, cudaStream_t s) {
  if (w_csc == nullptr)
    return launch_d_dense<T, false, false>(colptr, row_csc, perm, w_csc, g,
                                           arg, out, num_cols, feat, heads,
                                           s);
  if (heads > 1)
    return launch_d_dense<T, true, true>(colptr, row_csc, perm, w_csc, g, arg,
                                         out, num_cols, feat, heads, s);
  return launch_d_dense<T, true, false>(colptr, row_csc, perm, w_csc, g, arg,
                                        out, num_cols, feat, heads, s);
}

template <typename T>
int d_values(int dot, const int* rowptr, const int* col, const int* arg,
             const void* g, const void* x, float* out, int num_rows,
             int heads, int head_feat, cudaStream_t s) {
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarp, kWarpsPerBlock);
  if (dot)
    d_values_kernel<T, true><<<grid, block, 0, s>>>(
        rowptr, col, arg, static_cast<const T*>(g),
        static_cast<const T*>(x), out, num_rows, heads, head_feat);
  else
    d_values_kernel<T, false><<<grid, block, 0, s>>>(
        rowptr, col, arg, static_cast<const T*>(g), nullptr, out, num_rows,
        heads, head_feat);
  return cudaGetLastError();
}

bool bad_shape(int rows, int feat, int heads) {
  return rows <= 0 || feat <= 0 || heads <= 0 || feat % heads != 0;
}

}  // namespace

extern "C" {

// out [M, F] in `dtype` (0 fp32, 1 bf16) and arg [M, F] int32 for CSR A
// (rowptr [M+1], col [nnz] int32), X [N, F] in `dtype` and w [nnz, H] fp32
// (ignored for compute 0, copy). compute: 0 copy, 1 add, 2 sub, 3 mul,
// 4 div; is_min != 0 takes the minimum. Returns a cudaError_t.
int dg_spmm_maxmin(int dtype, int device, int compute, int is_min,
                   const int* rowptr, const int* col, const float* val,
                   const void* x, void* out, int* arg, int num_rows, int feat,
                   int heads, int nnz, void* stream) {
  if (bad_shape(num_rows, feat, heads) || compute < kCopy || compute > kDiv)
    return cudaErrorInvalidValue;
  if (compute != kCopy && val == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return forward<float>(compute, is_min, rowptr, col, val, x, out, arg,
                          num_rows, feat, heads, nnz, s);
  if (dtype == kBFloat16)
    return forward<__nv_bfloat16>(compute, is_min, rowptr, col, val, x, out,
                                  arg, num_rows, feat, heads, nnz, s);
  return cudaErrorInvalidValue;
}

// d_dense [N, F] in `dtype` from g [M, F] in `dtype` and arg [M, F] over the
// CSC view (colptr [N+1], row_csc [nnz], perm [nnz]: the CSR edge id of
// each CSC slot) with w_csc [nnz, H] fp32 in CSC order, or NULL for ones.
// Returns a cudaError_t.
int dg_maxmin_d_dense(int dtype, int device, const int* colptr,
                      const int* row_csc, const int* perm, const float* w_csc,
                      const void* g, const int* arg, void* out, int num_cols,
                      int feat, int heads, void* stream) {
  if (bad_shape(num_cols, feat, heads)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return d_dense<float>(colptr, row_csc, perm, w_csc, g, arg, out, num_cols,
                          feat, heads, s);
  if (dtype == kBFloat16)
    return d_dense<__nv_bfloat16>(colptr, row_csc, perm, w_csc, g, arg, out,
                                  num_cols, feat, heads, s);
  return cudaErrorInvalidValue;
}

// out [nnz, H] fp32, zero-filled by the caller: per edge and head the sum
// of g [M, H*F] (times X [N, H*F] at col[e] when dot != 0) over the
// elements of row_e that e won (arg [M, H*F]). Returns a cudaError_t.
int dg_maxmin_d_values(int dtype, int device, int dot, const int* rowptr,
                       const int* col, const int* arg, const void* g,
                       const void* x, float* out, int num_rows, int heads,
                       int head_feat, void* stream) {
  if (bad_shape(num_rows, heads * head_feat, heads))
    return cudaErrorInvalidValue;
  if (dot && x == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    return d_values<float>(dot, rowptr, col, arg, g, x, out, num_rows, heads,
                           head_feat, s);
  if (dtype == kBFloat16)
    return d_values<__nv_bfloat16>(dot, rowptr, col, arg, g, x, out,
                                   num_rows, heads, head_feat, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
