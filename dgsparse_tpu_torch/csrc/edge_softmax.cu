// Edge softmax over CSR rows, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes `edge_softmax`
// (`dgsparse_tpu/ops/edge_softmax.py`) with XLA segment ops, and the port
// ran the same chain as aten ops (a scatter_reduce max, row gathers, an
// index_add of row sums, four to six elementwise passes, and autograd's
// backward over them). Per (edge e of row r, head h), for logits x [nnz, H]
// in CSR edge order:
//   forward   alpha[e, h] = exp(x[e, h] - m[r, h]) / max(s[r, h], 1e-38),
//             m the row's max (0 where it is not finite), s the row's sum
//             of exps: a row whose logits are all -inf gives 0, not NaN;
//   backward  dx[e, h] = alpha[e, h] * (g[e, h] - d[r, h]),
//             d[r, h] = sum over the row's e' of alpha[e', h] * g[e', h].
// fp32 throughout, expf (not __expf) and no fast math. x, g and dx are read
// and written through their strides (the GAT layer's logits may be
// column-major); alpha is row-major [nnz, H], as spmm_multihead reads it.
//
// What bounds it: bytes. Each value is read once and written once, a few
// flops each: 8 bytes a value forward, 12 backward (ogbn-arxiv's 2.48 M
// edges at 8 heads: 159 and 238 MB, 48 and 71 us at 3.35 TB/s). The design:
//   - a row's entries are contiguous, so a group of G lanes takes a row: P
//     lanes an edge, one head each (P the heads rounded up to a power of
//     two, at most 8; more heads in slices of P along gridDim.y), E = G / P
//     edges a pass. At H = 8: 4 edges x 8 heads a warp, a row a warp;
//   - a group holds a row of up to kMaxChunk (128) entries, NV = 128 / E
//     values a lane, all loads of the row in flight before any use: one read
//     gives the max (xor shuffles over the E lanes of a head), the exps and
//     their sum, and alpha is written once. The values sit in registers; a
//     long row's spill to L1 where the register bound (kFwdBlocks) is
//     tighter than NV. No atomics; each sum is taken in a fixed order, so
//     two calls agree bitwise;
//   - hub rows, longer than the split plan's chunk (`Storage.row_split()`,
//     the plan csr_spmm and sddmm_csr take; at most kMaxChunk): in the same
//     launch the first blocks take the plan's chunks, one group a chunk,
//     and write each chunk's partial (max, sum of exps) per head; the other
//     blocks skip those rows. A second, small launch runs a group a chunk
//     again: it combines the partials of the chunk's row in a fixed order,
//     so every chunk of a row sees bitwise the same (max, sum), and then
//     normalises its chunk, reading its logits a second time;
//   - the backward has the same mapping, with alpha and g in registers and
//     the chunks' partial dots combined by its second launch.

#include <cmath>

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kMaxChunk = 128;  // the longest row or chunk a group holds
constexpr float kFloor = 1e-38f;  // the floor of a row's sum of exps
// Blocks an SM the first launches ask of the compiler, so registers: 8 (32
// registers) forward, 4 (64) backward. On an NVIDIA H100 80GB HBM3 (700 W)
// at H = 8 on the benchmark's graph, both launches of a call by CUDA
// events, more blocks in flight beat a row held wholly in registers: the
// forward 98.7 us at 8 blocks (its long rows' values then spill to L1),
// 105.6 at 6, 116.0 without a bound (53 registers); the backward 132.4 us
// at 4, 138.0 without (80 registers), 149.0 at 6.
constexpr int kFwdBlocks = 8;
constexpr int kBwdBlocks = 4;

// A split plan on the device: the chunks of the rows longer than `size`
// entries, in CSR order (`size` bounds every row when there are none).
struct RowSplit {
  const int* row;    // [chunks] the row of each chunk
  const int* start;  // [chunks] its first entry; a chunk runs `size`
                     // entries or to its row's end
  int chunks, size;
};

// Strides of a [nnz, H] operand, in elements.
struct Strides {
  int64_t edge, head;
};

__device__ __forceinline__ int64_t at(const Strides& s, int e, int h) {
  return static_cast<int64_t>(e) * s.edge + static_cast<int64_t>(h) * s.head;
}

// A thread's place: P lanes an edge, G lanes a slot (a row or a chunk).
template <int P, int G>
struct Lanes {
  static constexpr int E = G / P;                              // edges a pass
  static constexpr int NV = kMaxChunk / E;                     // values a lane
  static constexpr int kSlots = kWarpsPerBlock * (kWarp / G);  // a block's
  int slot;  // the group's slot within the block
  int sub;   // the lane's edge within a pass
  int head;
  __device__ __forceinline__ Lanes()
      : slot(threadIdx.y * (kWarp / G) + threadIdx.x / G),
        sub(threadIdx.x % G / P),
        head(blockIdx.y * P + threadIdx.x % P) {}
};

// Max and sum over the E lanes of one head in a group (xor offsets P to
// G / 2): every lane ends with bitwise the same value.
template <int P, int G>
__device__ __forceinline__ float head_max(float x) {
#pragma unroll
  for (int o = P; o < G; o *= 2)
    x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

template <int P, int G>
__device__ __forceinline__ float head_sum(float x) {
#pragma unroll
  for (int o = P; o < G; o *= 2) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__device__ __forceinline__ float finite_or_zero(float m) {
  return isfinite(m) ? m : 0.f;
}

// The entries [start, end) of a group's slot in the first launch: in the
// first `chunk_blocks` blocks a chunk of the plan (`chunk` its index), in
// the others a row of at most split.size entries (`chunk` -1). Empty past
// the end and for a split row, whose chunks take it. Every lane stays to
// the end of the kernel: the shuffles name the whole warp.
__device__ __forceinline__ void find_slot(const int* __restrict__ rowptr,
                                          int num_rows, const RowSplit& split,
                                          int chunk_blocks, int slots,
                                          int slot, int& start, int& end,
                                          int& chunk) {
  start = end = 0;
  chunk = -1;
  if (static_cast<int>(blockIdx.x) < chunk_blocks) {
    const int c = blockIdx.x * slots + slot;
    if (c < split.chunks) {
      chunk = c;
      start = split.start[c];
      end = min(start + split.size, rowptr[split.row[c] + 1]);
    }
  } else {
    const int row = (blockIdx.x - chunk_blocks) * slots + slot;
    if (row < num_rows) {
      const int s = rowptr[row], e = rowptr[row + 1];
      if (e - s <= split.size) {
        start = s;
        end = e;
      }
    }
  }
}

// The chunks of the row of chunk c: [first, first + count).
__device__ __forceinline__ void row_chunks(const int* __restrict__ rowptr,
                                           const RowSplit& split, int c,
                                           int& start, int& end, int& first,
                                           int& count) {
  const int row = split.row[c];
  const int rs = rowptr[row], re = rowptr[row + 1];
  start = split.start[c];
  end = min(start + split.size, re);
  first = c - (start - rs) / split.size;
  count = (re - rs + split.size - 1) / split.size;
}

template <int P, int G>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kFwdBlocks)
    softmax_kernel(const int* __restrict__ rowptr, const float* __restrict__ x,
                   Strides xs, float* __restrict__ alpha,
                   float2* __restrict__ work, int num_rows, int heads,
                   RowSplit split, int chunk_blocks) {
  using L = Lanes<P, G>;
  const L l;
  int start, end, chunk;
  find_slot(rowptr, num_rows, split, chunk_blocks, L::kSlots, l.slot, start,
            end, chunk);
  const int n = l.head < heads ? end - start : 0;
  float v[L::NV];
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    v[k] = i < end ? x[at(xs, i, l.head)] : -INFINITY;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    mx = fmaxf(mx, v[k]);
  }
  mx = head_max<P, G>(mx);
  const float shift = finite_or_zero(mx);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    v[k] = expf(v[k] - shift);  // 0 for a lane past the end (-inf)
    sum += v[k];
  }
  sum = head_sum<P, G>(sum);
  if (chunk >= 0) {
    if (n > 0 && l.sub == 0)
      work[static_cast<int64_t>(chunk) * heads + l.head] =
          make_float2(mx, sum);
    return;
  }
  const float denom = fmaxf(sum, kFloor);
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    if (i < end) alpha[static_cast<int64_t>(i) * heads + l.head] = v[k] / denom;
  }
}

// The second launch: a group a chunk. Its logits are loaded first (into
// registers, as in the first launch), then the row's (max, sum of exps)
// comes from the row's chunk partials (each lane a stride of them, the
// loads unrolled, then the shuffles) and the chunk's alpha is written.
template <int P, int G>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    softmax_split_kernel(const int* __restrict__ rowptr,
                         const float* __restrict__ x, Strides xs,
                         float* __restrict__ alpha,
                         const float2* __restrict__ work, int heads,
                         RowSplit split) {
  using L = Lanes<P, G>;
  const L l;
  const int c = blockIdx.x * L::kSlots + l.slot;
  int start = 0, end = 0, first = 0, count = 0;
  if (c < split.chunks && l.head < heads)
    row_chunks(rowptr, split, c, start, end, first, count);
  const int n = end - start;
  float v[L::NV];
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    v[k] = i < end ? x[at(xs, i, l.head)] : -INFINITY;
  }
  const float2* w = work + static_cast<int64_t>(first) * heads + l.head;
  float mx = -INFINITY;
#pragma unroll 4
  for (int k = l.sub; k < count; k += L::E)
    mx = fmaxf(mx, w[static_cast<int64_t>(k) * heads].x);
  mx = head_max<P, G>(mx);
  const float shift = finite_or_zero(mx);
  float sum = 0.f;
#pragma unroll 4
  for (int k = l.sub; k < count; k += L::E) {
    const float2 p = w[static_cast<int64_t>(k) * heads];
    // an all -inf chunk adds nothing (its exp factor could overflow)
    if (p.y != 0.f) sum += p.y * expf(finite_or_zero(p.x) - shift);
  }
  sum = head_sum<P, G>(sum);
  const float denom = fmaxf(sum, kFloor);
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    if (i < end)
      alpha[static_cast<int64_t>(i) * heads + l.head] =
          expf(v[k] - shift) / denom;
  }
}

template <int P, int G>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock, kBwdBlocks)
    softmax_bwd_kernel(const int* __restrict__ rowptr,
                       const float* __restrict__ alpha,
                       const float* __restrict__ g, Strides gs,
                       float* __restrict__ dx, Strides ds,
                       float* __restrict__ work, int num_rows, int heads,
                       RowSplit split, int chunk_blocks) {
  using L = Lanes<P, G>;
  const L l;
  int start, end, chunk;
  find_slot(rowptr, num_rows, split, chunk_blocks, L::kSlots, l.slot, start,
            end, chunk);
  const int n = l.head < heads ? end - start : 0;
  float a[L::NV], b[L::NV];
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    a[k] = i < end ? alpha[static_cast<int64_t>(i) * heads + l.head] : 0.f;
    b[k] = i < end ? g[at(gs, i, l.head)] : 0.f;
  }
  float dot = 0.f;
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    dot += a[k] * b[k];
  }
  dot = head_sum<P, G>(dot);
  if (chunk >= 0) {
    if (n > 0 && l.sub == 0)
      work[static_cast<int64_t>(chunk) * heads + l.head] = dot;
    return;
  }
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    if (i < end) dx[at(ds, i, l.head)] = a[k] * (b[k] - dot);
  }
}

// The backward's second launch: the chunk's alpha and g into registers,
// the row's dot from its chunks' partials, then the chunk's dx.
template <int P, int G>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    softmax_bwd_split_kernel(const int* __restrict__ rowptr,
                             const float* __restrict__ alpha,
                             const float* __restrict__ g, Strides gs,
                             float* __restrict__ dx, Strides ds,
                             const float* __restrict__ work, int heads,
                             RowSplit split) {
  using L = Lanes<P, G>;
  const L l;
  const int c = blockIdx.x * L::kSlots + l.slot;
  int start = 0, end = 0, first = 0, count = 0;
  if (c < split.chunks && l.head < heads)
    row_chunks(rowptr, split, c, start, end, first, count);
  const int n = end - start;
  float a[L::NV], b[L::NV];
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    a[k] = i < end ? alpha[static_cast<int64_t>(i) * heads + l.head] : 0.f;
    b[k] = i < end ? g[at(gs, i, l.head)] : 0.f;
  }
  const float* w = work + static_cast<int64_t>(first) * heads + l.head;
  float dot = 0.f;
#pragma unroll 4
  for (int k = l.sub; k < count; k += L::E)
    dot += w[static_cast<int64_t>(k) * heads];
  dot = head_sum<P, G>(dot);
#pragma unroll
  for (int k = 0; k < L::NV; ++k) {
    if (k * L::E >= n) break;
    const int i = start + k * L::E + l.sub;
    if (i < end) dx[at(ds, i, l.head)] = a[k] * (b[k] - dot);
  }
}

inline int blocks_for(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

struct Launch {
  const int* rowptr;
  int num_rows, heads;
  RowSplit split;
  cudaStream_t stream;
};

struct Fwd {
  const float* x;
  Strides xs;
  float* alpha;
  float2* work;
};

struct Bwd {
  const float* alpha;
  const float* g;
  Strides gs;
  float* dx;
  Strides ds;
  float* work;
};

template <int P, int G>
struct Grid {
  dim3 block, rows, chunks;
  int chunk_blocks;
  explicit Grid(const Launch& a) : block(kWarp, kWarpsPerBlock) {
    using L = Lanes<P, G>;
    const int slices = (a.heads + P - 1) / P;
    chunk_blocks = blocks_for(a.split.chunks, L::kSlots);
    rows = dim3(chunk_blocks + blocks_for(a.num_rows, L::kSlots), slices);
    chunks = dim3(chunk_blocks, slices);
  }
};

template <int P, int G>
int launch(const Launch& a, const Fwd& f) {
  const Grid<P, G> grid(a);
  if (grid.rows.y > 65535) return cudaErrorInvalidConfiguration;
  softmax_kernel<P, G><<<grid.rows, grid.block, 0, a.stream>>>(
      a.rowptr, f.x, f.xs, f.alpha, f.work, a.num_rows, a.heads, a.split,
      grid.chunk_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split.chunks == 0) return err;
  softmax_split_kernel<P, G><<<grid.chunks, grid.block, 0, a.stream>>>(
      a.rowptr, f.x, f.xs, f.alpha, f.work, a.heads, a.split);
  return cudaGetLastError();
}

template <int P, int G>
int launch(const Launch& a, const Bwd& b) {
  const Grid<P, G> grid(a);
  if (grid.rows.y > 65535) return cudaErrorInvalidConfiguration;
  softmax_bwd_kernel<P, G><<<grid.rows, grid.block, 0, a.stream>>>(
      a.rowptr, b.alpha, b.g, b.gs, b.dx, b.ds, b.work, a.num_rows, a.heads,
      a.split, grid.chunk_blocks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.split.chunks == 0) return err;
  softmax_bwd_split_kernel<P, G><<<grid.chunks, grid.block, 0, a.stream>>>(
      a.rowptr, b.alpha, b.g, b.gs, b.dx, b.ds, b.work, a.heads, a.split);
  return cudaGetLastError();
}

// The paths instantiated, (lanes an edge, lanes a slot): those of
// `kernels/edge_softmax.py::softmax_path`.
template <typename Op>
int dispatch(int lanes, int group, const Launch& a, const Op& op) {
  switch (lanes * 100 + group) {
    case 116: return launch<1, 16>(a, op);
    case 232: return launch<2, 32>(a, op);
    case 432: return launch<4, 32>(a, op);
    case 832: return launch<8, 32>(a, op);
  }
  return cudaErrorInvalidValue;
}

// The launch's common arguments; false where they cannot be run: no rows
// or heads, a chunk of more than kMaxChunk entries, a plan without its
// arrays or workspace.
bool common(int device, const int* rowptr, int num_rows, int heads,
            const int* plan, int chunks, int chunk, const void* work,
            void* stream, Launch* a) {
  if (num_rows <= 0 || heads <= 0 || chunk < 1 || chunk > kMaxChunk ||
      chunks < 0 || (chunks > 0 && (!plan || !work)))
    return false;
  if (cudaSetDevice(device) != cudaSuccess) return false;
  *a = {rowptr, num_rows, heads,
        {plan, chunks > 0 ? plan + chunks : nullptr, chunks, chunk},
        static_cast<cudaStream_t>(stream)};
  return true;
}

}  // namespace

extern "C" {

// alpha [nnz, H] (fp32, row-major) = the softmax over each CSR row
// (rowptr [M+1] int32) of x [nnz, H] (fp32, element (e, h) at
// x[e * x_edge + h * x_head]), on the path (lanes, group). The split plan:
// `chunks` chunks of `chunk` entries (1 to 128; every row longer than
// `chunk` is split), `plan` int32 chunk_row [chunks] then chunk_start
// [chunks], `work` 8 bytes a chunk and head; `chunks` 0, `plan` and `work`
// NULL for none, and then no row is longer than `chunk`. Returns a
// cudaError_t.
int dg_edge_softmax(int device, const int* rowptr, const float* x,
                    int64_t x_edge, int64_t x_head, float* alpha, void* work,
                    int num_rows, int heads, int lanes, int group,
                    const int* plan, int chunks, int chunk, void* stream) {
  Launch a;
  if (!common(device, rowptr, num_rows, heads, plan, chunks, chunk, work,
              stream, &a))
    return cudaErrorInvalidValue;
  const Fwd f{x, {x_edge, x_head}, alpha, static_cast<float2*>(work)};
  return dispatch(lanes, group, a, f);
}

// dx [nnz, H] = alpha * (g - the row's sum of alpha * g), per head, for
// alpha [nnz, H] row-major, g and dx through their strides as x above;
// `work` 4 bytes a chunk and head. Returns a cudaError_t.
int dg_edge_softmax_bwd(int device, const int* rowptr, const float* alpha,
                        const float* g, int64_t g_edge, int64_t g_head,
                        float* dx, int64_t dx_edge, int64_t dx_head,
                        float* work, int num_rows, int heads, int lanes,
                        int group, const int* plan, int chunks, int chunk,
                        void* stream) {
  Launch a;
  if (!common(device, rowptr, num_rows, heads, plan, chunks, chunk, work,
              stream, &a))
    return cudaErrorInvalidValue;
  const Bwd b{alpha, g, {g_edge, g_head}, dx, {dx_edge, dx_head}, work};
  return dispatch(lanes, group, a, b);
}

}  // extern "C"
