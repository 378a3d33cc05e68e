// CSR SDDMM (per-edge, per-head dots) for Hopper (sm_90a).
//
// Replaces the TPU kernel `dgsparse_tpu/kernels/pallas_sddmm.py::sddmm_esc`
// and the XLA SDDMM that the JAX package runs in its place
// (`kernels/xla.py::sddmm_chunked`, the einsum of `ops/spmm_mh.py`):
//   out[e, h] = sum_f d1[row_e, h*F + f] * d2[col_e, h*F + f]
// divided by max(deg(row_e), 1) for MEAN, with d1 [M, H*F], d2 [N, H*F] in
// fp32 or bf16, sums in fp32, and out [nnz, H] fp32 in CSR edge order.
// H = 1 is the plain SDDMM. There, each edge tile expands its 128-row
// block of d1 with a one-hot MXU matmul, which lost to the two XLA gathers.
//
// What bounds it: each (edge, head) gathers a random F-element row segment
// of d2 and does 2*F flops on it, so the kernel is bound by those gathers
// (from HBM, or L2 when d2 fits its 50 MB), never by FLOPs, and with rows
// of a few edges, by how many gathers each warp keeps in flight. The
// design follows the reference's sddmmCSR*Scale (SURVEY.md 2.4-2.5):
//   - one warp per row. Each head of an edge gets a group of LPH lanes (a
//     power of two, LPH * K >= F) and each lane K elements of it, strided
//     by LPH so a group's loads are contiguous; the heads of an edge sit
//     side by side (up to 32 lanes), and the warp takes 32 / (lanes per
//     edge) edges of the row at a time. A narrow head (F = 7: 2 lanes of
//     4) leaves no lanes idle, and every lane has K loads in flight;
//   - per head, the row's d1 segment sits in registers (K elements a lane,
//     chunk by chunk when F > 256), loaded once per row;
//   - the row's col is read 32 at a time, coalesced, and broadcast to the
//     groups by __shfl_sync;
//   - each group sums its dot with xor shuffles and one lane writes the
//     output once: no atomics, no zero-fill, deterministic.
// Rows map to gridDim.x; empty rows write nothing (they own no edges).

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kMaxK = 8;  // elements a lane holds per chunk: 256 features

// Lane lg of a head's group holds features ch*LPH*K + lg + k*LPH, k < K.
template <typename T, int K, int LPH>
__device__ __forceinline__ void load_segment(const T* __restrict__ p,
                                             int chunk, int lg, int feat,
                                             bool ok, float (&a)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int f = chunk * LPH * K + lg + k * LPH;
    a[k] = ok && f < feat ? to_float(p[f]) : 0.f;
  }
}

// LPH lanes per head, K elements a lane; `heads_per_pass` heads of an edge
// side by side (LPH * heads_per_pass <= 32 lanes).
template <typename T, int K, int LPH>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sddmm_csr_kernel(const int* __restrict__ rowptr,
                     const int* __restrict__ col, const T* __restrict__ d1,
                     const T* __restrict__ d2, float* __restrict__ out,
                     int num_rows, int heads, int feat, int heads_per_pass,
                     int mean) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (start == end) return;
  const int lane = threadIdx.x;
  const int lanes_per_edge = LPH * heads_per_pass;
  const int edges_per_pass = kWarp / lanes_per_edge;
  const int slot = lane / lanes_per_edge;       // edge of the row in flight
  const int hp = lane % lanes_per_edge / LPH;   // head within the pass
  const int lg = lane % LPH;                    // lane within the head
  const int hf = heads * feat;
  const int chunks = (feat + LPH * K - 1) / (LPH * K);
  const float denom = mean ? static_cast<float>(end - start) : 1.f;
  const T* d1_row = d1 + static_cast<int64_t>(row) * hf;

  for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {  // uniform
    const int h = h0 + hp;
    const bool head_ok = h < heads;
    float a[K];
    if (chunks == 1)
      load_segment<T, K, LPH>(d1_row + h * feat, 0, lg, feat, head_ok, a);
    for (int base = start; base < end; base += kWarp) {
      const int mine = base + lane;
      const int col_mine = mine < end ? col[mine] : 0;
      const int n = min(kWarp, end - base);
      for (int s = 0; s < n; s += edges_per_pass) {  // uniform
        const int j = s + slot;  // < 32: s <= 32 - edges_per_pass
        const bool valid = head_ok && j < n;
        const int c = __shfl_sync(kFullMask, col_mine, j);
        const T* b = d2 + static_cast<int64_t>(c) * hf + h * feat;
        float acc = 0.f;
        for (int ch = 0; ch < chunks; ++ch) {
          if (chunks > 1)
            load_segment<T, K, LPH>(d1_row + h * feat, ch, lg, feat,
                                    head_ok, a);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int f = ch * LPH * K + lg + k * LPH;
            if (valid && f < feat) acc += a[k] * to_float(b[f]);
          }
        }
#pragma unroll
        for (int off = LPH / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kFullMask, acc, off);
        if (valid && lg == 0)
          out[static_cast<int64_t>(base + j) * heads + h] = acc / denom;
      }
    }
  }
}

template <typename T, int K, int LPH>
void launch_k(dim3 grid, dim3 block, cudaStream_t s, const int* rowptr,
              const int* col, const void* d1, const void* d2, float* out,
              int num_rows, int heads, int feat, int mean) {
  int per_pass = 1;  // heads side by side: a power of two, <= 32 lanes
  while (per_pass < heads && per_pass * 2 * LPH <= kWarp) per_pass *= 2;
  sddmm_csr_kernel<T, K, LPH><<<grid, block, 0, s>>>(
      rowptr, col, static_cast<const T*>(d1), static_cast<const T*>(d2), out,
      num_rows, heads, feat, per_pass, mean);
}

// Lanes per head LPH and elements per lane K for a head of `feat`
// features: four elements a lane up to F = 128 (LPH = 1 ... 32), then
// eight, in chunks of 256 features beyond that.
template <typename T>
int launch(int device, const int* rowptr, const int* col, const void* d1,
           const void* d2, float* out, int num_rows, int heads, int feat,
           int mean, void* stream) {
  if (num_rows <= 0 || heads <= 0 || feat <= 0) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(heads) * feat > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid((num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DG_LAUNCH(K, LPH)                                                 \
  launch_k<T, K, LPH>(grid, block, s, rowptr, col, d1, d2, out, num_rows, \
                      heads, feat, mean)
  if (feat <= 4) {
    DG_LAUNCH(4, 1);
  } else if (feat <= 8) {
    DG_LAUNCH(4, 2);
  } else if (feat <= 16) {
    DG_LAUNCH(4, 4);
  } else if (feat <= 32) {
    DG_LAUNCH(4, 8);
  } else if (feat <= 64) {
    DG_LAUNCH(4, 16);
  } else if (feat <= 128) {
    DG_LAUNCH(4, 32);
  } else {
    DG_LAUNCH(kMaxK, 32);
  }
#undef DG_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[nnz, H] (fp32) = per-edge, per-head dots of d1 [M, H*F] rows and
// d2 [N, H*F] rows over CSR A (rowptr [M+1], col [nnz] int32), d1 and d2
// in `dtype` (0 fp32, 1 bf16); mean != 0 divides by max(deg, 1). Returns a
// cudaError_t.
int dg_sddmm_csr(int dtype, int device, const int* rowptr, const int* col,
                 const void* d1, const void* d2, float* out, int num_rows,
                 int heads, int feat, int mean, void* stream) {
  if (dtype == kFloat32)
    return launch<float>(device, rowptr, col, d1, d2, out, num_rows, heads,
                         feat, mean, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(device, rowptr, col, d1, d2, out, num_rows,
                                 heads, feat, mean, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
