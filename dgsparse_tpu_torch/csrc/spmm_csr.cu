// CSR SpMM (SUM/MEAN) and CSR segment sum for Hopper (sm_90a).
//
// Replaces the TPU kernel
// `dgsparse_tpu/kernels/pallas_spmm.py::segment_matmul`
// as it is driven by `spmm_esc`/`gspmm_esc` (MUL): there, an XLA gather forms
// per-edge contributions values[e] * X[col[e]] and the Pallas kernel sums them
// into row blocks with a one-hot MXU matmul. Here one kernel fuses the gather,
// the value scale and the row reduction (`dg_csr_spmm`); `dg_segment_sum_csr`
// is the same kernel with an identity gather, summing contributions that are
// already in CSR edge order (the direct counterpart of `segment_matmul`).
//
// What bounds it: each edge does 2*F flops on a random 4*F-byte (fp32) row
// read of X from HBM or L2, so the kernel is bound by those gathers, never by
// FLOPs. The design (GE-SpMM row balance, reference SURVEY.md 2.4-2.5) keeps
// everything else off that path:
//   - one warp per (row, 32*VEC-feature slice); lanes span features, so each
//     gathered row segment is one coalesced read, VEC elements (up to 16
//     bytes) per lane when F and the pointers allow it;
//   - the row's col/values are read 32 at a time, coalesced, and broadcast
//     to the warp with __shfl_sync;
//   - sums stay in fp32 registers and each output element is written once:
//     no atomics, so results are deterministic and the output needs no
//     zero-fill. Columns within a row need not be sorted.
// Rows map to gridDim.x (up to 2^31-1 blocks), feature slices to gridDim.y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Packed {
  T v[VEC];
};

// out[m, f] = (sum over e in [rowptr[m], rowptr[m+1]) of w[e] * src[r(e), f])
//             / (MEAN ? max(deg, 1) : 1)
// with r(e) = col[e] and w[e] = val ? val[e] : 1 when GATHER, else r(e) = e
// and w[e] = 1.
template <typename T, int VEC, bool GATHER>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_reduce_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const T* __restrict__ src, T* __restrict__ out,
                      int num_rows, int feat, int mean) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int f0 = (blockIdx.y * kWarp + lane) * VEC;
  const bool active = f0 < feat;  // VEC divides feat: the whole vector fits
  const int start = rowptr[row];
  const int end = rowptr[row + 1];

  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;

  for (int base = start; base < end; base += kWarp) {
    const int e = base + lane;
    int src_row = 0;
    float w = 1.f;
    if (e < end) {
      src_row = GATHER ? col[e] : e;
      if (GATHER && val != nullptr) w = val[e];
    }
    const int n = min(kWarp, end - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kFullMask, src_row, j);
      const float wj = __shfl_sync(kFullMask, w, j);
      if (active) {
        const Packed<T, VEC> x = *reinterpret_cast<const Packed<T, VEC>*>(
            src + static_cast<int64_t>(r) * feat + f0);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += wj * to_float(x.v[k]);
      }
    }
  }
  if (!active) return;
  const float denom = mean ? static_cast<float>(max(end - start, 1)) : 1.f;
  Packed<T, VEC> y;
#pragma unroll
  for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[k] / denom);
  *reinterpret_cast<Packed<T, VEC>*>(out + static_cast<int64_t>(row) * feat +
                                     f0) = y;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Widest vector (at most 16 bytes) that divides feat, still gives every lane
// of a warp work, and that both pointers are aligned for.
template <typename T>
int pick_vec(int feat, const void* src, const void* out) {
  for (int vec = 16 / static_cast<int>(sizeof(T)); vec > 1; vec /= 2) {
    const int bytes = vec * static_cast<int>(sizeof(T));
    if (feat % vec == 0 && feat >= kWarp * vec && aligned(src, bytes) &&
        aligned(out, bytes))
      return vec;
  }
  return 1;
}

template <typename T, int VEC, bool GATHER>
void launch_vec(dim3 grid, dim3 block, cudaStream_t stream, const int* rowptr,
                const int* col, const float* val, const void* src, void* out,
                int num_rows, int feat, int mean) {
  csr_reduce_kernel<T, VEC, GATHER><<<grid, block, 0, stream>>>(
      rowptr, col, val, static_cast<const T*>(src), static_cast<T*>(out),
      num_rows, feat, mean);
}

template <typename T, bool GATHER>
int launch(int device, const int* rowptr, const int* col, const float* val,
           const void* src, void* out, int num_rows, int feat, int mean,
           void* stream) {
  if (num_rows <= 0 || feat <= 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int vec = pick_vec<T>(feat, src, out);
  const int slice = kWarp * vec;
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                  (feat + slice - 1) / slice);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8:
      // only reachable for 2-byte types (16 bytes / 2)
      if constexpr (sizeof(T) == 2) {
        launch_vec<T, 8, GATHER>(grid, block, s, rowptr, col, val, src, out,
                                 num_rows, feat, mean);
      }
      break;
    case 4:
      launch_vec<T, 4, GATHER>(grid, block, s, rowptr, col, val, src, out,
                               num_rows, feat, mean);
      break;
    case 2:
      launch_vec<T, 2, GATHER>(grid, block, s, rowptr, col, val, src, out,
                               num_rows, feat, mean);
      break;
    default:
      launch_vec<T, 1, GATHER>(grid, block, s, rowptr, col, val, src, out,
                               num_rows, feat, mean);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[M, F] = A · X for CSR A (rowptr [M+1], col [nnz] int32, val [nnz] fp32
// or NULL for implicit ones) and X [N, F] in `dtype` (0 fp32, 1 bf16);
// mean != 0 divides each row by max(deg, 1). Returns a cudaError_t.
int dg_csr_spmm(int dtype, int device, const int* rowptr, const int* col,
                const float* val, const void* x, void* out, int num_rows,
                int feat, int mean, void* stream) {
  if (dtype == kFloat32)
    return launch<float, true>(device, rowptr, col, val, x, out, num_rows,
                               feat, mean, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, true>(device, rowptr, col, val, x, out,
                                       num_rows, feat, mean, stream);
  return cudaErrorInvalidValue;
}

// out[M, F] = per-row sums of contrib [nnz, F] (CSR edge order) over the
// segments rowptr [M+1] delimits. Returns a cudaError_t.
int dg_segment_sum_csr(int dtype, int device, const int* rowptr,
                       const void* contrib, void* out, int num_rows, int feat,
                       void* stream) {
  if (dtype == kFloat32)
    return launch<float, false>(device, rowptr, nullptr, nullptr, contrib,
                                out, num_rows, feat, 0, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, false>(device, rowptr, nullptr, nullptr,
                                        contrib, out, num_rows, feat, 0,
                                        stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
