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
// like the SUM kernel, and moves 4 more bytes per output element (arg).
// The gathers reach HBM when X outgrows the 50 MB L2 (arxiv at F = 256:
// 173 MB, every edge a miss). The design is the CSR SUM kernel's
// (csrc/spmm_csr.cu) with one change of grid:
//   - a group of G lanes (4, 8, 16 or 32; 32 / G rows a warp) covers one
//     row's feature slice, each lane NV vectors of VEC elements; the group
//     reads the row's col (and w) G edges at a time, coalesced, and
//     broadcasts them by __shfl_sync(width G); every lane runs the warp's
//     longest row's trips, so the full-mask shuffles stay legal;
//   - each lane issues the gathers of 4 edges before their compares, which
//     then run in CSR edge order with strict improvement only: a tie keeps
//     the earliest edge, with no merge of partials;
//   - the feature slice (G * NV * VEC features, at most 256 bytes of a
//     row: `kernels/spmm_maxmin.py::maxmin_path`; at the GIN widths one
//     row a warp of 8-byte loads) is the grid's slowest dimension, so the
//     slice of X being gathered from (arxiv: 169,343 rows x 256 B = 43.4
//     MB) stays in L2 while every row block reads it, and X comes from HBM
//     about once; out and arg are written with the streaming hint so that
//     they do not push the slice out;
//   - the running extremum and its edge id stay in registers; each output
//     written once, no atomics; an empty row gives 0 and arg = nnz.
// d_dense is bound by the bytes it must move (arg and g read once, d_dense
// written once), but a column-side walk reads a row's arg once per edge of
// the row (nnz * F * 4 bytes, 1.1 GB at arxiv F = 256 where the bound
// counts 173 MB). So it runs in two passes (`dg_maxmin_d_dense_masked`):
//   - the winner-mask pass, one warp a CSR row: the row's arg is read once,
//     8 words of 32 features at a time with the streaming hint, its loads
//     issued before the row's bounds arrive. For each chunk of 32 of the
//     row's edges and each word, lane j needs the lanes (features) whose
//     winner is the chunk's edge j: the ballots of "has a place in the
//     chunk" and of each bit of the place (3 for a chunk of up to 8 edges)
//     give it with a few AND-NOTs, whatever the degree.
//     Lane j then writes edge j's words, zero where it won nothing, at its
//     CSC slot (`slot`), the sw words of one column-pass slice in one
//     store: masks [ceil(F / 32 / sw), nnz, sw] uint32 in CSC order, every
//     word written once by the one warp that owns its row: no atomics. The
//     sentinel nnz (an empty row's) and ids outside the chunk have no
//     place. The launcher zero-fills the masks first, not for the result
//     but so that their lines sit in L2 when the scattered stores arrive
//     (stores of part of a sector that is not in L2 cost a fetch from HBM).
//     `__match_any_sync` in place of the ballots, and one word a store,
//     were slower on an H100;
//   - the column pass, the forward's group mapping over the CSC view: a
//     group of G lanes a column (32 / G columns a warp), each lane NV
//     vectors of VEC features, the feature slice the grid's slowest
//     dimension so the slice of g being gathered stays in L2. Per edge a
//     lane reads its word of the mask (a slice's sw words of consecutive
//     slots are contiguous) and gathers g only where the edge won one of
//     its features, then adds, one edge at a time (2 or 4 edges' gathers in
//     flight were slower on an H100: the gathers are bound by L2's rate
//     for scattered sectors, not by latency); the adds run in CSC order:
//     each element's terms are added
//     in the order, and with the operations, of the one-warp-a-column
//     mapping below, so the two are bitwise equal.
// d_dense_kernel, one warp per CSC column, runs where the masks do not pay
// (`kernels/spmm_maxmin.py::pick_d_dense`: short rows, an arg that fits in
// L2, or masks that do not): per edge of the column it gathers the row's
// arg slice (VEC int32 per lane) and only where an element won through
// this edge also the g slice; no atomics, and sentinel winners (nnz) never
// match an edge id.
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
constexpr int kAhead = 4;  // edges whose gathers are issued before their
                           // compares (forward)
constexpr int kMaxVectors = 2;  // vectors a lane (forward, column pass)
constexpr int kMaskWords = 8;   // words of a row's arg a mask-pass warp
                                // holds: 256 features

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

// out[m, f] = max/min over e in [rowptr[m], rowptr[m+1]) of
// combine(w_e, src[col[e], f]) and arg[m, f] = the CSR id of the earliest
// winning e (w_e = val[e], or val[e * heads + f / head_feat] with HEADS).
// Lane l of a warp serves row (warp * 32 + l) / group and, in feature slice
// blockIdx.y, the vectors v < NV at feature
// (blockIdx.y * group * NV + v * group + l % group) * VEC.
template <typename T, int VEC, int NV, int C, bool IS_MIN, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    maxmin_kernel(const int* __restrict__ rowptr, const int* __restrict__ col,
                  const float* __restrict__ val, const T* __restrict__ src,
                  T* __restrict__ out, int* __restrict__ arg, int num_rows,
                  int feat, int heads, int head_feat, int nnz, int group) {
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
    act[v] = has_row && f[v] < feat;  // VEC divides feat: the vector fits
    head[v] = HEADS && act[v] ? f[v] / head_feat : 0;
  }
  // a lane past the last row keeps taking part in the warp's shuffles
  const int start = has_row ? rowptr[row] : 0;
  const int end = has_row ? rowptr[row + 1] : 0;

  float best[NV][VEC];
  int win[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      best[v][k] = 0.f;
      win[v][k] = nnz;
    }
  // every lane runs every trip (the warp's longest row decides), so the
  // full-mask shuffles never see a lane that has left
  for (int base = start; __any_sync(kFullMask, base < end); base += group) {
    const int e = base + li;
    int src_row = 0;
    float w = 1.f;
    if (e < end) {
      src_row = col[e];
      if (C != kCopy && !HEADS) w = val[e];
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
      // the gathers of kAhead edges in flight before the first compare
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
      // compares in CSR edge order, updating on strict improvement only:
      // a tie keeps the earliest edge
#pragma unroll
      for (int u = 0; u < kAhead; ++u)
#pragma unroll
        for (int v = 0; v < NV; ++v)
          if (j + u < n && act[v]) {
            const int eu = base + j + u;
            const bool first = eu == start;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              const float c = combine<C>(wh[u][v], to_float(x[u][v].v[k]));
              if (first || (IS_MIN ? c < best[v][k] : c > best[v][k])) {
                best[v][k] = c;
                win[v][k] = eu;
              }
            }
          }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!act[v]) continue;
    Packed<T, VEC> y;
    Packed<int, VEC> a;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      y.v[k] = from_float<T>(isfinite(best[v][k]) ? best[v][k] : 0.f);
      a.v[k] = win[v][k];
    }
    // written once, evict-first: out and arg must not push the feature
    // slice that later rows gather from out of L2
    const int64_t o = static_cast<int64_t>(row) * feat + f[v];
    store_streaming(out + o, y);
    store_streaming(arg + o, a);
  }
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

// The lanes whose place j in a chunk of n of a row's edges is this lane's
// index: from the ballots of "has a place" (j < n) and of each of the bits
// a place below n has, each kept where this lane's own bit is set and
// inverted where it is clear.
__device__ __forceinline__ unsigned placed_at_lane(unsigned j, int n,
                                                   int lane) {
  const bool ok = j < static_cast<unsigned>(n);
  const int bits = kWarp - __clz(max(n - 1, 1));
  unsigned m = __ballot_sync(kFullMask, ok);
  for (int b = 0; b < bits; ++b) {
    const unsigned set = __ballot_sync(kFullMask, ok && ((j >> b) & 1u));
    m &= (lane >> b) & 1 ? set : ~set;
  }
  return m;
}

// The winner masks: word w of CSC slot k, bit b = [arg[row, 32 w + b] ==
// the CSR edge at k], at mask[((w / sw) * nnz + k) * sw + w % sw] (sw
// words a column-pass slice, stored together), for every edge of every
// non-empty row and every word w < ceil(feat / 32); the words of a last,
// partial group of sw are written as 0. One warp a row; lane l holds
// feature 32 w + l of kMaskWords words at a time.
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    winner_mask_kernel(const int* __restrict__ rowptr,
                       const int* __restrict__ slot,
                       const int* __restrict__ arg,
                       unsigned* __restrict__ mask, int num_rows, int feat,
                       int nnz, int sw) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
  if (row >= num_rows) return;  // uniform across the warp
  const int lane = threadIdx.x;
  const int words = (feat + kWarp - 1) / kWarp;
  const int* arg_row = arg + static_cast<int64_t>(row) * feat;
  // the row's arg, read once with the streaming hint, kMaskWords loads in
  // flight a lane; the first ones while the row's bounds arrive
  int a[kMaskWords];
#pragma unroll
  for (int i = 0; i < kMaskWords; ++i) {
    const int f = i * kWarp + lane;
    a[i] = i < words && f < feat ? __ldcs(arg_row + f) : -1;
  }
  const int start = rowptr[row];
  const int end = rowptr[row + 1];
  if (start == end) return;  // an empty row owns no edge
  for (int w0 = 0; w0 < words; w0 += kMaskWords) {
    if (w0 > 0) {
#pragma unroll
      for (int i = 0; i < kMaskWords; ++i) {
        const int f = (w0 + i) * kWarp + lane;
        a[i] = w0 + i < words && f < feat ? __ldcs(arg_row + f) : -1;
      }
    }
    for (int c0 = start; c0 < end; c0 += kWarp) {
      const int e = c0 + lane;
      const int n = min(kWarp, end - c0);  // edges of this chunk
      const int64_t k = e < end ? slot[e] : 0;
      // -1 (no feature), the sentinel nnz and other chunks' edges have no
      // place in [0, n)
      unsigned mine[kMaskWords];
#pragma unroll
      for (int i = 0; i < kMaskWords; ++i) {
        mine[i] = 0u;
        if (w0 + i >= words) continue;  // uniform across the warp
        mine[i] = placed_at_lane(static_cast<unsigned>(a[i] - c0), n, lane);
      }
      if (e >= end) continue;
      // lane j writes edge c0 + j's words, the sw of a slice in one store
      if (sw == 1) {
#pragma unroll
        for (int i = 0; i < kMaskWords; ++i)
          if (w0 + i < words)
            mask[static_cast<int64_t>(w0 + i) * nnz + k] = mine[i];
      } else if (sw == 2) {
#pragma unroll
        for (int i = 0; i < kMaskWords; i += 2)
          if (w0 + i < words)
            *reinterpret_cast<uint2*>(
                mask + (static_cast<int64_t>((w0 + i) / 2) * nnz + k) * 2) =
                make_uint2(mine[i], mine[i + 1]);
      } else {  // sw == 4
#pragma unroll
        for (int i = 0; i < kMaskWords; i += 4)
          if (w0 + i < words)
            *reinterpret_cast<uint4*>(
                mask + (static_cast<int64_t>((w0 + i) / 4) * nnz + k) * 4) =
                make_uint4(mine[i], mine[i + 1], mine[i + 2], mine[i + 3]);
      }
    }
  }
}

// d[c, f] for the features of slice blockIdx.y: the sum over the CSC
// column c's edges k (in CSC order) that won (row_csc[k], f), by the masks,
// of w(k, f) * g[row_csc[k], f]. Lane l of a warp serves column
// (warp * 32 + l) / group and the vectors v < NV at feature
// (blockIdx.y * group * NV + v * group + l % group) * VEC, as the forward;
// the slice's words of the mask, sw of them, sit together a slot.
template <typename T, int VEC, int NV, bool WEIGHTED, bool HEADS>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    d_dense_cols_kernel(const int* __restrict__ colptr,
                        const int* __restrict__ row_csc,
                        const float* __restrict__ w_csc,
                        const unsigned* __restrict__ mask,
                        const T* __restrict__ g, T* __restrict__ out,
                        int num_cols, int feat, int heads, int head_feat,
                        int nnz, int group, int sw) {
  static_assert(kWarp % VEC == 0, "a vector lies in one mask word");
  const int lane = threadIdx.x;
  const int li = lane & (group - 1);
  const int c = (blockIdx.x * kWarpsPerBlock + threadIdx.y) *
                    (kWarp / group) + lane / group;
  const bool has_col = c < num_cols;
  int f[NV], head[NV];
  bool act[NV];
  const unsigned* word[NV];  // this vector's mask word of slot 0
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    f[v] = ((blockIdx.y * NV + v) * group + li) * VEC;
    act[v] = has_col && f[v] < feat;  // VEC divides feat: the vector fits
    head[v] = HEADS && act[v] ? f[v] / head_feat : 0;
    const int w = f[v] / kWarp;
    word[v] = mask + static_cast<int64_t>(w / sw) * nnz * sw + w % sw;
  }
  // a lane past the last column keeps taking part in the warp's shuffles
  const int start = has_col ? colptr[c] : 0;
  const int end = has_col ? colptr[c + 1] : 0;
  constexpr unsigned kBits = (1u << VEC) - 1u;

  float acc[NV][VEC];
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[v][q] = 0.f;
  // every lane runs every trip (the warp's longest column decides), so the
  // full-mask shuffles never see a lane that has left
  for (int base = start; __any_sync(kFullMask, base < end); base += group) {
    int r_mine = 0;
    float w_mine = 1.f;
    if (base + li < end) {
      r_mine = row_csc[base + li];
      if (WEIGHTED && !HEADS) w_mine = w_csc[base + li];
    }
    const int n = max(min(group, end - base), 0);  // this group's edges
    const int n_warp = __reduce_max_sync(kFullMask, n);
    // one edge at a time: its mask words, then the gathers of g where it
    // won, then the adds, in CSC order as the one-warp-a-column mapping
    for (int j = 0; j < n_warp; ++j) {
      const int r = __shfl_sync(kFullMask, r_mine, j, group);
      const float wj = __shfl_sync(kFullMask, w_mine, j, group);
      const int64_t k = base + j;
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const unsigned won =
            j < n && act[v] ? (__ldg(word[v] + k * sw) >> (f[v] % kWarp)) &
                                  kBits
                            : 0u;
        if (!won) continue;
        const Packed<T, VEC> x = *reinterpret_cast<const Packed<T, VEC>*>(
            g + static_cast<int64_t>(r) * feat + f[v]);
        const float wh =
            WEIGHTED && HEADS ? w_csc[k * heads + head[v]] : wj;
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          if ((won >> q) & 1u) acc[v][q] += wh * to_float(x.v[q]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (!act[v]) continue;
    Packed<T, VEC> y;
#pragma unroll
    for (int q = 0; q < VEC; ++q) y.v[q] = from_float<T>(acc[v][q]);
    // written once, evict-first: d_dense must not push the slice of g
    // that later columns gather from out of L2
    store_streaming(out + static_cast<int64_t>(c) * feat + f[v], y);
  }
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

// The forward's arguments, passed down the template dispatch.
struct Fwd {
  const int* rowptr;
  const int* col;
  const float* val;
  const void* x;
  void* out;
  int* arg;
  int num_rows, feat, heads, nnz, vec, group, nv;
  cudaStream_t s;
};

// Feature slice blockIdx.y is the grid's slowest dimension: every row block
// of slice s is dispatched before slice s + 1's, so the slice of X that
// the rows gather from stays in L2 while they do.
template <typename T, int VEC, int NV, int C, bool IS_MIN, bool HEADS>
int launch_path(const Fwd& a) {
  const int rows = kWarpsPerBlock * (kWarp / a.group);  // rows per block
  const int slice = a.group * NV * VEC;
  const dim3 grid((a.num_rows + rows - 1) / rows,
                  (a.feat + slice - 1) / slice);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  maxmin_kernel<T, VEC, NV, C, IS_MIN, HEADS>
      <<<grid, dim3(kWarp, kWarpsPerBlock), 0, a.s>>>(
          a.rowptr, a.col, a.val, static_cast<const T*>(a.x),
          static_cast<T*>(a.out), a.arg, a.num_rows, a.feat, a.heads,
          a.feat / a.heads, a.nnz, a.group);
  return cudaGetLastError();
}

// Refuses a path the kernel cannot run: `vec` a power of two of at most 16
// bytes dividing the head width, with x and out aligned to it and arg to
// vec int32; `group` 4, 8, 16 or 32 lanes; `nv` 1 to kMaxVectors.
template <typename T, int C, bool IS_MIN, bool HEADS>
int launch_forward(const Fwd& a) {
  const int bytes = a.vec * static_cast<int>(sizeof(T));
  if (a.vec < 1 || (a.vec & (a.vec - 1)) || bytes > 16 ||
      (a.feat / a.heads) % a.vec || !aligned(a.x, bytes) ||
      !aligned(a.out, bytes) || !aligned(a.arg, a.vec * 4) ||
      (a.group != 4 && a.group != 8 && a.group != 16 && a.group != 32) ||
      a.nv < 1 || a.nv > kMaxVectors)
    return cudaErrorInvalidValue;
  int err = cudaErrorInvalidValue;
  with_vec<T>(a.vec, [&](auto v) {
    constexpr int kVec = decltype(v)::value;
    err = a.nv == 1 ? launch_path<T, kVec, 1, C, IS_MIN, HEADS>(a)
                    : launch_path<T, kVec, 2, C, IS_MIN, HEADS>(a);
  });
  return err;
}

template <typename T, bool IS_MIN, bool HEADS>
int forward_compute(int compute, const Fwd& a) {
  switch (compute) {
    case kCopy:
      // copy_u reads no values: the single-value kernel, whatever `heads`
      if constexpr (!HEADS) return launch_forward<T, kCopy, IS_MIN, HEADS>(a);
      return cudaErrorInvalidValue;
    case kAdd:
      return launch_forward<T, kAdd, IS_MIN, HEADS>(a);
    case kSub:
      return launch_forward<T, kSub, IS_MIN, HEADS>(a);
    case kMul:
      return launch_forward<T, kMul, IS_MIN, HEADS>(a);
    case kDiv:
      return launch_forward<T, kDiv, IS_MIN, HEADS>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int forward(int compute, int is_min, const Fwd& a) {
  const bool multi = a.heads > 1 && compute != kCopy;
  if (is_min)
    return multi ? forward_compute<T, true, true>(compute, a)
                 : forward_compute<T, true, false>(compute, a);
  return multi ? forward_compute<T, false, true>(compute, a)
               : forward_compute<T, false, false>(compute, a);
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

// The masked d_dense's arguments, passed down the template dispatch.
struct Masked {
  const int* rowptr;
  const int* slot;
  const int* arg;
  unsigned* mask;
  const int* colptr;
  const int* row_csc;
  const float* w_csc;
  const void* g;
  void* out;
  int num_rows, num_cols, nnz, feat, heads, vec, group, nv;
  cudaStream_t s;
};

// Mask words a column-pass slice reads, stored together a slot: the
// slice's width over 32, or 1 for a slice narrower than a word.
int slice_words(const Masked& a) {
  return max(1, a.group * a.nv * a.vec / kWarp);
}

// The column pass on the path (VEC, NV, group), the feature slice the
// grid's slowest dimension, as the forward's `launch_path`.
template <typename T, int VEC, int NV, bool WEIGHTED, bool HEADS>
int launch_cols(const Masked& a) {
  const int cols = kWarpsPerBlock * (kWarp / a.group);  // columns a block
  const int slice = a.group * NV * VEC;
  const dim3 grid((a.num_cols + cols - 1) / cols,
                  (a.feat + slice - 1) / slice);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  d_dense_cols_kernel<T, VEC, NV, WEIGHTED, HEADS>
      <<<grid, dim3(kWarp, kWarpsPerBlock), 0, a.s>>>(
          a.colptr, a.row_csc, a.w_csc, a.mask, static_cast<const T*>(a.g),
          static_cast<T*>(a.out), a.num_cols, a.feat, a.heads,
          a.feat / a.heads, a.nnz, a.group, slice_words(a));
  return cudaGetLastError();
}

template <typename T, bool WEIGHTED, bool HEADS>
int masked_weights(const Masked& a) {
  int err = cudaErrorInvalidValue;
  with_vec<T>(a.vec, [&](auto v) {
    constexpr int kVec = decltype(v)::value;
    err = a.nv == 1 ? launch_cols<T, kVec, 1, WEIGHTED, HEADS>(a)
                    : launch_cols<T, kVec, 2, WEIGHTED, HEADS>(a);
  });
  return err;
}

// The mask pass, then the column pass. Refuses a path the column pass
// cannot run, as `launch_forward` does, or whose slice spans more than 4
// mask words (128 features).
template <typename T>
int d_dense_masked(const Masked& a) {
  const int bytes = a.vec * static_cast<int>(sizeof(T));
  if (a.vec < 1 || (a.vec & (a.vec - 1)) || bytes > 16 ||
      (a.feat / a.heads) % a.vec || !aligned(a.g, bytes) ||
      !aligned(a.out, bytes) ||
      (a.group != 4 && a.group != 8 && a.group != 16 && a.group != 32) ||
      a.nv < 1 || a.nv > kMaxVectors || slice_words(a) > 4)
    return cudaErrorInvalidValue;
  // every word is written below; zeroing the masks first puts their lines
  // in L2, so the pass's scattered stores of part of a sector do not each
  // fetch it from HBM
  const int sw = slice_words(a);
  const int groups = (a.feat + kWarp * sw - 1) / (kWarp * sw);
  const cudaError_t zero = cudaMemsetAsync(
      a.mask, 0, sizeof(unsigned) * static_cast<size_t>(a.nnz) * sw * groups,
      a.s);
  if (zero != cudaSuccess) return zero;
  winner_mask_kernel<<<(a.num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock,
                       dim3(kWarp, kWarpsPerBlock), 0, a.s>>>(
      a.rowptr, a.slot, a.arg, a.mask, a.num_rows, a.feat, a.nnz, sw);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.w_csc == nullptr) return masked_weights<T, false, false>(a);
  if (a.heads > 1) return masked_weights<T, true, true>(a);
  return masked_weights<T, true, false>(a);
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
// 4 div; is_min != 0 takes the minimum. (vec, group, nv) is the path:
// `vec` elements a load (dividing F / H; x and out aligned to it, arg to
// vec int32), `group` lanes a row (4, 8, 16 or 32), `nv` vectors a lane
// (1 or 2); a feature slice is group * nv * vec wide. Returns a
// cudaError_t.
int dg_spmm_maxmin(int dtype, int device, int compute, int is_min,
                   const int* rowptr, const int* col, const float* val,
                   const void* x, void* out, int* arg, int num_rows, int feat,
                   int heads, int nnz, int vec, int group, int nv,
                   void* stream) {
  if (bad_shape(num_rows, feat, heads) || compute < kCopy || compute > kDiv)
    return cudaErrorInvalidValue;
  if (compute != kCopy && val == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Fwd a{rowptr,   col,  val,   x,     out, arg,
              num_rows, feat, heads, nnz,   vec, group,
              nv,       static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return forward<float>(compute, is_min, a);
  if (dtype == kBFloat16) return forward<__nv_bfloat16>(compute, is_min, a);
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

// The same d_dense in two passes: the winner masks (`mask`, scratch the
// caller allocates, [ceil(F / 32 / sw), nnz, sw] uint32 with sw =
// max(1, group * nv * vec / 32) <= 4; every word is written) from arg over
// the CSR rows (rowptr [M+1]; slot [nnz]: the CSC slot of each CSR edge,
// the inverse of perm), then the columns on the path (vec, group, nv):
// `vec` elements a load (dividing F / H; g and out aligned to it), `group`
// lanes a column (4, 8, 16 or 32), `nv` vectors a lane (1 or 2). Returns a
// cudaError_t.
int dg_maxmin_d_dense_masked(int dtype, int device, const int* rowptr,
                             const int* slot, const int* arg, unsigned* mask,
                             const int* colptr, const int* row_csc,
                             const float* w_csc, const void* g, void* out,
                             int num_rows, int num_cols, int nnz, int feat,
                             int heads, int vec, int group, int nv,
                             void* stream) {
  if (bad_shape(num_rows, feat, heads) || num_cols <= 0 || nnz <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Masked a{rowptr,   slot,     arg, mask,  colptr, row_csc,
                 w_csc,    g,        out, num_rows, num_cols, nnz,
                 feat,     heads,    vec, group, nv,
                 static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return d_dense_masked<float>(a);
  if (dtype == kBFloat16) return d_dense_masked<__nv_bfloat16>(a);
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
