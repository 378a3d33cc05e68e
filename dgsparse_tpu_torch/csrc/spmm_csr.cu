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
//   - a group of G lanes (G = 4, 8, 16 or 32, so a warp carries 32 / G rows)
//     reads one row's col/values in one pass, G edges at a time, coalesced,
//     and broadcasts them to the group with __shfl_sync(width G); lanes span
//     features, each lane NV vectors of VEC elements (up to 16 bytes), so a
//     row of F = 40 fp32 features is ten 16-byte loads by one 16-lane group
//     and F = 41 is 41 4-byte loads by 16 lanes, three each. Only widths
//     past G * NV * VEC (128 x 16 bytes) split into feature slices on
//     gridDim.y, each slice re-reading the row's col/values;
//   - each lane issues the gathers of 4 edges before their FMAs, so several
//     row reads are in flight where rows are short (arxiv: ~7.4 edges);
//   - sums stay in fp32 registers, added edge by edge in CSR order, and each
//     output element is written once: no atomics, so results are bitwise
//     repeatable and the output needs no zero-fill. Columns within a row
//     need not be sorted.
// The path (VEC, G, NV) is a pure function of F, H, dtype and the pointers'
// alignment, chosen by the Python wrapper (`kernels/spmm_csr.py::
// spmm_path`, checked on the CPU) and passed in; the launcher here only
// refuses a path the kernel cannot run.
//
// Heads (the counterpart of `spmm_esc_mh`, which folds H heads into the
// feature axis of one `segment_matmul`): with values [nnz, H] and X
// [N, H*F], feature j of an edge is scaled by values[e, j / F]. One launch
// serves every head; each lane reads the value of each vector's head (lanes
// of one head read one address). A vector never straddles two heads: VEC
// divides F. H = 1 runs the single-value path unchanged.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kAhead = 4;  // edges whose gathers are issued before their FMAs

// Most vectors a lane carries: two of 16 bytes, else four.
template <typename T, int VEC>
__host__ __device__ constexpr int max_vectors() {
  return VEC * static_cast<int>(sizeof(T)) == 16 ? 2 : 4;
}

// out[m, f] = (sum over e in [rowptr[m], rowptr[m+1]) of w[e] * src[r(e), f])
//             / (MEAN ? max(deg, 1) : 1)
// with r(e) = col[e] and w[e] = val ? val[e] : 1 when GATHER, else r(e) = e
// and w[e] = 1. HEADS: w[e] = val[e * heads + f / head_feat] (val not NULL).
// Lane l of a warp serves row (warp * 32 + l) / group and, in feature slice
// blockIdx.y, the vectors v < NV at feature
// (blockIdx.y * group * NV + v * group + l % group) * VEC.
template <typename T, int VEC, int NV, bool GATHER, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_reduce_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const T* __restrict__ src, T* __restrict__ out,
                      int num_rows, int feat, int mean, int heads,
                      int head_feat, int group) {
  const int lane = threadIdx.x;
  const int li = lane & (group - 1);
  const int row = (blockIdx.x * kWarpsPerBlock + threadIdx.y) *
                      (kWarp / group) + lane / group;
  const bool has_row = row < num_rows;
  int f[NV], head[NV];
  bool act[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    f[v] = ((blockIdx.y * NV + v) * group + li) * VEC;
    act[v] = f[v] < feat;  // VEC divides feat: the whole vector fits
    head[v] = HEADS && act[v] ? f[v] / head_feat : 0;
  }
  // a lane past the last row keeps taking part in the warp's shuffles
  const int start = has_row ? rowptr[row] : 0;
  const int end = has_row ? rowptr[row + 1] : 0;

  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[v][k] = 0.f;

  // every lane runs every trip (the warp's longest row decides), so the
  // full-mask shuffles never see a lane that has left
  for (int base = start; __any_sync(kFullMask, base < end); base += group) {
    const int e = base + li;
    int src_row = 0;
    float w = 1.f;
    if (e < end) {
      src_row = GATHER ? col[e] : e;
      if (GATHER && !HEADS && val != nullptr) w = val[e];
    }
    const int n = max(min(group, end - base), 0);  // this group's edges
    const int n_warp = __reduce_max_sync(kFullMask, n);
    for (int j = 0; j < n_warp; j += kAhead) {
      int r[kAhead];
      float wu[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        r[u] = __shfl_sync(kFullMask, src_row, j + u, group);
        wu[u] = __shfl_sync(kFullMask, w, j + u, group);
      }
      Packed<T, VEC> x[kAhead][NV];
      float wh[kAhead][NV];
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (j + u < n && act[v]) {
            x[u][v] = *reinterpret_cast<const Packed<T, VEC>*>(
                src + static_cast<int64_t>(r[u]) * feat + f[v]);
            wh[u][v] = HEADS ? val[static_cast<int64_t>(base + j + u) *
                                       heads + head[v]]
                             : wu[u];
          }
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (j + u < n && act[v]) {
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              acc[v][k] += wh[u][v] * to_float(x[u][v].v[k]);
          }
    }
  }
  if (!has_row) return;
  const float denom = mean ? static_cast<float>(max(end - start, 1)) : 1.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!act[v]) continue;
    Packed<T, VEC> y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[v][k] / denom);
    *reinterpret_cast<Packed<T, VEC>*>(out + static_cast<int64_t>(row) * feat +
                                       f[v]) = y;
  }
}

template <typename T, int VEC, int NV, bool GATHER, bool HEADS>
int launch_path(const int* rowptr, const int* col, const float* val,
                const void* src, void* out, int num_rows, int feat, int mean,
                int heads, int group, cudaStream_t stream) {
  const int rows = kWarpsPerBlock * (kWarp / group);  // rows per block
  const int slice = group * NV * VEC;
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((num_rows + rows - 1) / rows, (feat + slice - 1) / slice);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  csr_reduce_kernel<T, VEC, NV, GATHER, HEADS><<<grid, block, 0, stream>>>(
      rowptr, col, val, static_cast<const T*>(src), static_cast<T*>(out),
      num_rows, feat, mean, heads, feat / heads, group);
  return cudaGetLastError();
}

template <typename T, int VEC, bool GATHER, bool HEADS>
int launch_vec(const int* rowptr, const int* col, const float* val,
               const void* src, void* out, int num_rows, int feat, int mean,
               int heads, int group, int nv, cudaStream_t stream) {
  const int bytes = VEC * static_cast<int>(sizeof(T));
  if (nv < 1 || nv > max_vectors<T, VEC>() || (feat / heads) % VEC != 0 ||
      !aligned(src, bytes) || !aligned(out, bytes))
    return cudaErrorInvalidValue;
  constexpr int kMax = max_vectors<T, VEC>();
  switch (nv) {
    case 1:
      return launch_path<T, VEC, 1, GATHER, HEADS>(
          rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
          stream);
    case 2:
      return launch_path<T, VEC, 2, GATHER, HEADS>(
          rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
          stream);
    default:
      if constexpr (kMax == 4) {
        if (nv == 3)
          return launch_path<T, VEC, 3, GATHER, HEADS>(
              rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
              stream);
        return launch_path<T, VEC, 4, GATHER, HEADS>(
            rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
            stream);
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool GATHER, bool HEADS>
int launch(int device, const int* rowptr, const int* col, const float* val,
           const void* src, void* out, int num_rows, int feat, int mean,
           int heads, int vec, int group, int nv, void* stream) {
  if (num_rows <= 0 || feat <= 0 || heads <= 0 || feat % heads != 0 ||
      (group != 4 && group != 8 && group != 16 && group != 32))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 8:
      // only for 2-byte types (16 bytes / 2)
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 8, GATHER, HEADS>(rowptr, col, val, src, out,
                                               num_rows, feat, mean, heads,
                                               group, nv, s);
      return cudaErrorInvalidValue;
    case 4:
      return launch_vec<T, 4, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, s);
    case 2:
      return launch_vec<T, 2, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, s);
    case 1:
      return launch_vec<T, 1, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out[M, F] = A · X for CSR A (rowptr [M+1], col [nnz] int32, val [nnz, H]
// fp32 or NULL for implicit ones) and X [N, F] in `dtype` (0 fp32, 1 bf16),
// F = H * (features per head); feature j takes val[e, j / (F / H)].
// mean != 0 divides each row by max(deg, 1). (vec, group, nv) is the path:
// `vec` elements a load (dividing F / H, both pointers aligned to it),
// `group` lanes a row (4, 8, 16 or 32), `nv` vectors a lane. Returns a
// cudaError_t.
int dg_csr_spmm(int dtype, int device, const int* rowptr, const int* col,
                const float* val, const void* x, void* out, int num_rows,
                int feat, int heads, int mean, int vec, int group, int nv,
                void* stream) {
  if (heads > 1 && val != nullptr) {
    if (dtype == kFloat32)
      return launch<float, true, true>(device, rowptr, col, val, x, out,
                                       num_rows, feat, mean, heads, vec,
                                       group, nv, stream);
    if (dtype == kBFloat16)
      return launch<__nv_bfloat16, true, true>(device, rowptr, col, val, x,
                                               out, num_rows, feat, mean,
                                               heads, vec, group, nv, stream);
    return cudaErrorInvalidValue;
  }
  // one value per edge (or none): the single-head kernel, whatever `heads`
  if (dtype == kFloat32)
    return launch<float, true, false>(device, rowptr, col, val, x, out,
                                      num_rows, feat, mean, 1, vec, group,
                                      nv, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, true, false>(device, rowptr, col, val, x,
                                              out, num_rows, feat, mean, 1,
                                              vec, group, nv, stream);
  return cudaErrorInvalidValue;
}

// out[M, F] = per-row sums of contrib [nnz, F] (CSR edge order) over the
// segments rowptr [M+1] delimits, on the path (vec, group, nv) as above.
// Returns a cudaError_t.
int dg_segment_sum_csr(int dtype, int device, const int* rowptr,
                       const void* contrib, void* out, int num_rows, int feat,
                       int vec, int group, int nv, void* stream) {
  if (dtype == kFloat32)
    return launch<float, false, false>(device, rowptr, nullptr, nullptr,
                                       contrib, out, num_rows, feat, 0, 1,
                                       vec, group, nv, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, false, false>(device, rowptr, nullptr,
                                               nullptr, contrib, out,
                                               num_rows, feat, 0, 1, vec,
                                               group, nv, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
