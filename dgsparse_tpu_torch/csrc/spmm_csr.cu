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
//
// Heads (the counterpart of `spmm_esc_mh`, which folds H heads into the
// feature axis of one `segment_matmul`): with values [nnz, H] and X
// [N, H*F], feature j of an edge is scaled by values[e, j / F]. One launch
// serves every head; each lane reads the value of its own head (lanes of
// one head read one address). A vector never straddles two heads: VEC
// divides F. H = 1 runs the single-value path unchanged.

#include "common.cuh"

using namespace dg;

namespace {

// out[m, f] = (sum over e in [rowptr[m], rowptr[m+1]) of w[e] * src[r(e), f])
//             / (MEAN ? max(deg, 1) : 1)
// with r(e) = col[e] and w[e] = val ? val[e] : 1 when GATHER, else r(e) = e
// and w[e] = 1. HEADS: w[e] = val[e * heads + f / head_feat] (val not NULL).
template <typename T, int VEC, bool GATHER, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_reduce_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const T* __restrict__ src, T* __restrict__ out,
                      int num_rows, int feat, int mean, int heads,
                      int head_feat) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int f0 = (blockIdx.y * kWarp + lane) * VEC;
  const bool active = f0 < feat;  // VEC divides feat: the whole vector fits
  const int head = HEADS && active ? f0 / head_feat : 0;
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
      if (GATHER && !HEADS && val != nullptr) w = val[e];
    }
    const int n = min(kWarp, end - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int r = __shfl_sync(kFullMask, src_row, j);
      float wj = __shfl_sync(kFullMask, w, j);
      if (active) {
        if (HEADS)
          wj = val[static_cast<int64_t>(base + j) * heads + head];
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

// Widest vector (at most 16 bytes) that divides the head width (so it
// divides feat too), still gives every lane of a warp work, and that both
// pointers are aligned for.
template <typename T>
int pick_vec(int feat, int head_feat, const void* src, const void* out) {
  for (int vec = 16 / static_cast<int>(sizeof(T)); vec > 1; vec /= 2) {
    const int bytes = vec * static_cast<int>(sizeof(T));
    if (head_feat % vec == 0 && feat >= kWarp * vec && aligned(src, bytes) &&
        aligned(out, bytes))
      return vec;
  }
  return 1;
}

template <typename T, int VEC, bool GATHER, bool HEADS>
void launch_vec(dim3 grid, dim3 block, cudaStream_t stream, const int* rowptr,
                const int* col, const float* val, const void* src, void* out,
                int num_rows, int feat, int mean, int heads) {
  csr_reduce_kernel<T, VEC, GATHER, HEADS><<<grid, block, 0, stream>>>(
      rowptr, col, val, static_cast<const T*>(src), static_cast<T*>(out),
      num_rows, feat, mean, heads, feat / heads);
}

template <typename T, bool GATHER, bool HEADS>
int launch(int device, const int* rowptr, const int* col, const float* val,
           const void* src, void* out, int num_rows, int feat, int mean,
           int heads, void* stream) {
  if (num_rows <= 0 || feat <= 0 || heads <= 0 || feat % heads != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int vec = pick_vec<T>(feat, feat / heads, src, out);
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
        launch_vec<T, 8, GATHER, HEADS>(grid, block, s, rowptr, col, val,
                                        src, out, num_rows, feat, mean,
                                        heads);
      }
      break;
    case 4:
      launch_vec<T, 4, GATHER, HEADS>(grid, block, s, rowptr, col, val,
                                      src, out, num_rows, feat, mean,
                                      heads);
      break;
    case 2:
      launch_vec<T, 2, GATHER, HEADS>(grid, block, s, rowptr, col, val,
                                      src, out, num_rows, feat, mean,
                                      heads);
      break;
    default:
      launch_vec<T, 1, GATHER, HEADS>(grid, block, s, rowptr, col, val,
                                      src, out, num_rows, feat, mean,
                                      heads);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[M, F] = A · X for CSR A (rowptr [M+1], col [nnz] int32, val [nnz, H]
// fp32 or NULL for implicit ones) and X [N, F] in `dtype` (0 fp32, 1 bf16),
// F = H * (features per head); feature j takes val[e, j / (F / H)].
// mean != 0 divides each row by max(deg, 1). Returns a cudaError_t.
int dg_csr_spmm(int dtype, int device, const int* rowptr, const int* col,
                const float* val, const void* x, void* out, int num_rows,
                int feat, int heads, int mean, void* stream) {
  if (heads > 1 && val != nullptr) {
    if (dtype == kFloat32)
      return launch<float, true, true>(device, rowptr, col, val, x, out,
                                       num_rows, feat, mean, heads, stream);
    if (dtype == kBFloat16)
      return launch<__nv_bfloat16, true, true>(device, rowptr, col, val, x,
                                               out, num_rows, feat, mean,
                                               heads, stream);
    return cudaErrorInvalidValue;
  }
  // one value per edge (or none): the single-head kernel, whatever `heads`
  if (dtype == kFloat32)
    return launch<float, true, false>(device, rowptr, col, val, x, out,
                                      num_rows, feat, mean, 1, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, true, false>(device, rowptr, col, val, x,
                                              out, num_rows, feat, mean, 1,
                                              stream);
  return cudaErrorInvalidValue;
}

// out[M, F] = per-row sums of contrib [nnz, F] (CSR edge order) over the
// segments rowptr [M+1] delimits. Returns a cudaError_t.
int dg_segment_sum_csr(int dtype, int device, const int* rowptr,
                       const void* contrib, void* out, int num_rows, int feat,
                       void* stream) {
  if (dtype == kFloat32)
    return launch<float, false, false>(device, rowptr, nullptr, nullptr,
                                       contrib, out, num_rows, feat, 0, 1,
                                       stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, false, false>(device, rowptr, nullptr,
                                               nullptr, contrib, out,
                                               num_rows, feat, 0, 1, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
