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
// Hub rows: a row's group walks its edges kAhead gathers a round, so a row
// of ~13,100 entries (ogbn-arxiv's largest) keeps one group busy for ~3,300
// dependent rounds, milliseconds after every other warp has finished. A
// split plan (`kernels/spmm_csr.py::split_plan`, built once per storage)
// cuts each row longer than C entries into chunks of C consecutive
// entries. One launch then has two roles, by block index: the first blocks
// take the chunks, one group a chunk as if it were a row, and write its
// fp32 partial sum to a workspace [chunks, F]; they are scheduled first,
// so the long work starts first. The other blocks map rows as before and
// skip a row longer than C. A second, small launch (`csr_split_fixup_kernel`)
// adds each long row's partials in a fixed order, divides for MEAN and
// writes the row once. No float atomics: the sums keep a fixed order and
// stay bitwise repeatable. A row of at most C entries is summed exactly as
// without a plan, so a graph without such rows gets the same launch and
// the same bits.
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
constexpr int kFixupWarps = 8;  // a split row's chunks in 8 runs
constexpr int kNoSplit = 0x7fffffff;  // row length past which rows are split

// A split plan on the device: the chunks of the rows longer than `size`
// entries, in CSR order, and the workspace of their partial sums.
struct RowSplit {
  const int* row;    // [chunks] the row of each chunk
  const int* start;  // [chunks] its first entry; a chunk runs `size`
                     // entries or to its row's end
  const int* ptr;    // [rows + 1] each split row's chunks
  float* work;       // [chunks, feat] fp32 partial sums
  int chunks, rows, size;
};

// Most vectors a lane carries: two of 16 bytes, else four.
template <typename T, int VEC>
__host__ __device__ constexpr int max_vectors() {
  return VEC * static_cast<int>(sizeof(T)) == 16 ? 2 : 4;
}

// out[m, f] = (sum over e in [rowptr[m], rowptr[m+1]) of w[e] * src[r(e), f])
//             / (MEAN ? max(deg, 1) : 1)
// with r(e) = col[e] and w[e] = val ? val[e] : 1 when GATHER, else r(e) = e
// and w[e] = 1. HEADS: w[e] = val[e * heads + f / head_feat] (val not NULL).
// A slot is a row, or with SPLIT in the first `chunk_blocks` blocks a
// chunk of `split`. Lane l of a warp serves slot (warp * 32 + l) / group,
// counted from the first block of its role, and, in feature slice
// blockIdx.y, the vectors v < NV at feature
// (blockIdx.y * group * NV + v * group + l % group) * VEC.
// Without SPLIT (no plan) the kernel is the one before plans existed: with
// the roles' few instructions compiled in, a launch without chunks ran 1-4 %
// slower (NVIDIA H100 80GB HBM3, 700 W, an arxiv-sized graph without hubs).
template <typename T, int VEC, int NV, bool GATHER, bool HEADS, bool SPLIT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    csr_reduce_kernel(const int* __restrict__ rowptr,
                      const int* __restrict__ col,
                      const float* __restrict__ val,
                      const T* __restrict__ src, T* __restrict__ out,
                      int num_rows, int feat, int mean, int heads,
                      int head_feat, int group, RowSplit split,
                      int chunk_blocks) {
  const int lane = threadIdx.x;
  const int li = lane & (group - 1);
  const bool chunks = SPLIT && blockIdx.x < chunk_blocks;  // block-uniform
  const int slot =
      ((SPLIT && !chunks ? blockIdx.x - chunk_blocks : blockIdx.x) *
           kWarpsPerBlock + threadIdx.y) * (kWarp / group) + lane / group;
  int f[NV], head[NV];
  bool act[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    f[v] = ((blockIdx.y * NV + v) * group + li) * VEC;
    act[v] = f[v] < feat;  // VEC divides feat: the whole vector fits
    head[v] = HEADS && act[v] ? f[v] / head_feat : 0;
  }
  // a lane with no slot, or on a split row, walks no edges but keeps
  // taking part in the warp's shuffles
  bool has_slot;
  int start, end;
  if constexpr (SPLIT) {
    start = end = 0;
    has_slot = false;
    if (chunks) {
      if (slot < split.chunks) {
        start = split.start[slot];
        end = min(start + split.size, rowptr[split.row[slot] + 1]);
        has_slot = true;
      }
    } else if (slot < num_rows) {
      start = rowptr[slot];
      end = rowptr[slot + 1];
      has_slot = end - start <= split.size;  // else its chunks sum it
      if (!has_slot) start = end;
    }
  } else {
    has_slot = slot < num_rows;
    start = has_slot ? rowptr[slot] : 0;
    end = has_slot ? rowptr[slot + 1] : 0;
  }

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
  if (!has_slot) return;
  if (chunks) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      if (!act[v]) continue;
      Packed<float, VEC> p;
#pragma unroll
      for (int k = 0; k < VEC; ++k) p.v[k] = acc[v][k];
      *reinterpret_cast<Packed<float, VEC>*>(
          split.work + static_cast<int64_t>(slot) * feat + f[v]) = p;
    }
    return;
  }
  const float denom = mean ? static_cast<float>(max(end - start, 1)) : 1.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!act[v]) continue;
    Packed<T, VEC> y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) y.v[k] = from_float<T>(acc[v][k] / denom);
    *reinterpret_cast<Packed<T, VEC>*>(out + static_cast<int64_t>(slot) *
                                                 feat + f[v]) = y;
  }
}

// out[m] of each split row m: its chunks' partial sums added in a fixed
// order, then divided as above, in T. Block (i, y) serves the plan's row i
// and features [32 y, 32 y + 32), lane l feature 32 y + l: warp w adds the
// w-th run of consecutive chunks in chunk order (kFixupWarps runs of equal
// length, the last shorter), then warp 0 adds the runs' sums in run order.
// Loads of a warp are one 128-byte row of a chunk's partials.
template <typename T>
__global__ void __launch_bounds__(kWarp * kFixupWarps)
    csr_split_fixup_kernel(const int* __restrict__ rowptr, RowSplit split,
                           T* __restrict__ out, int feat, int mean) {
  __shared__ float runs[kFixupWarps][kWarp];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int j = blockIdx.y * kWarp + lane;
  const int c0 = split.ptr[blockIdx.x], c1 = split.ptr[blockIdx.x + 1];
  const int per = (c1 - c0 + kFixupWarps - 1) / kFixupWarps;
  const int lo = c0 + warp * per, hi = min(lo + per, c1);
  float acc = 0.f;
  if (j < feat) {
#pragma unroll 8
    for (int c = lo; c < hi; ++c)
      acc += split.work[static_cast<int64_t>(c) * feat + j];
  }
  runs[warp][lane] = acc;
  __syncthreads();
  if (warp != 0 || j >= feat) return;
  acc = runs[0][lane];
#pragma unroll
  for (int w = 1; w < kFixupWarps; ++w) acc += runs[w][lane];
  const int row = split.row[c0];
  const float denom =
      mean ? static_cast<float>(max(rowptr[row + 1] - rowptr[row], 1)) : 1.f;
  out[static_cast<int64_t>(row) * feat + j] = from_float<T>(acc / denom);
}

template <typename T, int VEC, int NV, bool GATHER, bool HEADS>
int launch_path(const int* rowptr, const int* col, const float* val,
                const void* src, void* out, int num_rows, int feat, int mean,
                int heads, int group, const RowSplit& split,
                cudaStream_t stream) {
  const int slots = kWarpsPerBlock * (kWarp / group);  // slots per block
  const int slice = group * NV * VEC;
  const int chunk_blocks = (split.chunks + slots - 1) / slots;
  const dim3 block(kWarp, kWarpsPerBlock);
  const dim3 grid(chunk_blocks + (num_rows + slots - 1) / slots,
                  (feat + slice - 1) / slice);
  const dim3 fix_grid(split.rows, (feat + kWarp - 1) / kWarp);
  if (grid.y > 65535 || fix_grid.y > 65535)
    return cudaErrorInvalidConfiguration;
  if (split.chunks == 0) {
    csr_reduce_kernel<T, VEC, NV, GATHER, HEADS, false>
        <<<grid, block, 0, stream>>>(
            rowptr, col, val, static_cast<const T*>(src),
            static_cast<T*>(out), num_rows, feat, mean, heads, feat / heads,
            group, split, 0);
    return cudaGetLastError();
  }
  if constexpr (GATHER) {  // a segment sum takes no plan
    csr_reduce_kernel<T, VEC, NV, GATHER, HEADS, true>
        <<<grid, block, 0, stream>>>(
            rowptr, col, val, static_cast<const T*>(src),
            static_cast<T*>(out), num_rows, feat, mean, heads, feat / heads,
            group, split, chunk_blocks);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  csr_split_fixup_kernel<T><<<fix_grid, dim3(kWarp, kFixupWarps), 0,
                              stream>>>(rowptr, split, static_cast<T*>(out),
                                        feat, mean);
  return cudaGetLastError();
}

template <typename T, int VEC, bool GATHER, bool HEADS>
int launch_vec(const int* rowptr, const int* col, const float* val,
               const void* src, void* out, int num_rows, int feat, int mean,
               int heads, int group, int nv, const RowSplit& split,
               cudaStream_t stream) {
  const int bytes = VEC * static_cast<int>(sizeof(T));
  if (nv < 1 || nv > max_vectors<T, VEC>() || (feat / heads) % VEC != 0 ||
      !aligned(src, bytes) || !aligned(out, bytes) ||
      (split.chunks > 0 && !aligned(split.work, VEC * 4)))
    return cudaErrorInvalidValue;
  constexpr int kMax = max_vectors<T, VEC>();
  switch (nv) {
    case 1:
      return launch_path<T, VEC, 1, GATHER, HEADS>(
          rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
          split, stream);
    case 2:
      return launch_path<T, VEC, 2, GATHER, HEADS>(
          rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
          split, stream);
    default:
      if constexpr (kMax == 4) {
        if (nv == 3)
          return launch_path<T, VEC, 3, GATHER, HEADS>(
              rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
              split, stream);
        return launch_path<T, VEC, 4, GATHER, HEADS>(
            rowptr, col, val, src, out, num_rows, feat, mean, heads, group,
            split, stream);
      }
      return cudaErrorInvalidValue;
  }
}

template <typename T, bool GATHER, bool HEADS>
int launch(int device, const int* rowptr, const int* col, const float* val,
           const void* src, void* out, int num_rows, int feat, int mean,
           int heads, int vec, int group, int nv, const RowSplit& split,
           void* stream) {
  if (num_rows <= 0 || feat <= 0 || heads <= 0 || feat % heads != 0 ||
      (group != 4 && group != 8 && group != 16 && group != 32) ||
      split.chunks < 0 || split.size < 1 ||
      (split.chunks > 0 &&
       (split.rows < 1 || !split.row || !split.start || !split.ptr ||
        !split.work)))
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
                                               group, nv, split, s);
      return cudaErrorInvalidValue;
    case 4:
      return launch_vec<T, 4, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, split, s);
    case 2:
      return launch_vec<T, 2, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, split, s);
    case 1:
      return launch_vec<T, 1, GATHER, HEADS>(rowptr, col, val, src, out,
                                             num_rows, feat, mean, heads,
                                             group, nv, split, s);
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
// `group` lanes a row (4, 8, 16 or 32), `nv` vectors a lane. A split plan
// of `chunks` > 0 chunks of `chunk` entries over `split_rows` rows (every
// row longer than `chunk`): `plan`, int32 chunk_row [chunks], chunk_start
// [chunks] and chunk_ptr [split_rows + 1] one after the other, and `work`,
// fp32 [chunks, F] aligned to a load; `chunks` 0 launches without one (the
// pointers unread). Returns a cudaError_t.
int dg_csr_spmm(int dtype, int device, const int* rowptr, const int* col,
                const float* val, const void* x, void* out, int num_rows,
                int feat, int heads, int mean, int vec, int group, int nv,
                const int* plan, int chunks, int split_rows, int chunk,
                float* work, void* stream) {
  const RowSplit split{plan, plan + chunks, plan + 2 * chunks, work, chunks,
                       split_rows, chunks > 0 ? chunk : kNoSplit};
  if (heads > 1 && val != nullptr) {
    if (dtype == kFloat32)
      return launch<float, true, true>(device, rowptr, col, val, x, out,
                                       num_rows, feat, mean, heads, vec,
                                       group, nv, split, stream);
    if (dtype == kBFloat16)
      return launch<__nv_bfloat16, true, true>(device, rowptr, col, val, x,
                                               out, num_rows, feat, mean,
                                               heads, vec, group, nv, split,
                                               stream);
    return cudaErrorInvalidValue;
  }
  // one value per edge (or none): the single-head kernel, whatever `heads`
  if (dtype == kFloat32)
    return launch<float, true, false>(device, rowptr, col, val, x, out,
                                      num_rows, feat, mean, 1, vec, group,
                                      nv, split, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, true, false>(device, rowptr, col, val, x,
                                              out, num_rows, feat, mean, 1,
                                              vec, group, nv, split, stream);
  return cudaErrorInvalidValue;
}

// out[M, F] = per-row sums of contrib [nnz, F] (CSR edge order) over the
// segments rowptr [M+1] delimits, on the path (vec, group, nv) as above.
// Returns a cudaError_t.
int dg_segment_sum_csr(int dtype, int device, const int* rowptr,
                       const void* contrib, void* out, int num_rows, int feat,
                       int vec, int group, int nv, void* stream) {
  const RowSplit none{nullptr, nullptr, nullptr, nullptr, 0, 0, kNoSplit};
  if (dtype == kFloat32)
    return launch<float, false, false>(device, rowptr, nullptr, nullptr,
                                       contrib, out, num_rows, feat, 0, 1,
                                       vec, group, nv, none, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, false, false>(device, rowptr, nullptr,
                                               nullptr, contrib, out,
                                               num_rows, feat, 0, 1, vec,
                                               group, nv, none, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
