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
// (from HBM, or L2 when d2 fits its 50 MB), never by FLOPs: scattered
// pieces of 16 to 256 bytes, so by L2's sector rate more than by bytes
// (arxiv rows have ~7 edges). The design (`sddmm_group_kernel`) is csr_spmm's group mapping
// (csrc/spmm_csr.cu) with the edges of a row spread over lanes:
//   - Q lanes a head, each lane K vectors of VEC elements of it (lane q
//     vectors q, q + Q, ...: a head's loads are contiguous across its
//     lanes), up to 16 bytes a load and about 32 bytes a lane an edge;
//     HP heads of an edge side by side, so P = Q * HP lanes an edge; a
//     group of G lanes a row takes G / P of its edges a pass, and a warp
//     32 / G rows. At GAT's widths: H=4 F=16 fp32, two 16-byte loads a
//     lane, 2 lanes a head, 8 an edge, 4 edges of a row a pass; H=1 F=7,
//     an edge a lane (7 scalar loads), 8 lanes a row, 4 rows a warp;
//   - a lane's K gathers are in flight before its FMAs, one edge at a
//     time (two edges' gathers in flight, or more bytes a lane, were
//     slower on an H100: the gathers are bound by L2's sector rate, and
//     more in flight only costs registers);
//   - per head, the row's d1 segment sits in registers, loaded once per
//     row (chunk by chunk when the head is wider than Q * K vectors);
//   - neighbouring lanes hold neighbouring edges, so a group's outputs of
//     [nnz, H] are written together, each once: no atomics, no zero-fill,
//     deterministic.
// The path (VEC, K, Q, HP, G) is a pure function of F, H, the dtype and
// the pointers' alignment (`kernels/sddmm_csr.py::sddmm_path`, checked on
// the CPU), passed in; the launcher only refuses a path the kernel cannot
// run. `sddmm_csr_kernel`, the mapping before it, runs where the group
// mapping would load scalars (`pick_sddmm`; path "warp_per_row"), where
// it is faster (the reference's sddmmCSR*Scale, SURVEY.md 2.4-2.5): one
// warp a row, LPH
// lanes a head (LPH * K >= F) with K scalar elements each, strided by LPH,
// the heads of an edge side by side and 32 / (lanes an edge) edges of the
// row at a time, the row's col read 32 at a time and broadcast by
// __shfl_sync, each dot summed by xor shuffles and written by one lane.
// Rows map to gridDim.x; empty rows write nothing (they own no edges).
//
// Hub rows: a row's group walks its edges a pass at a time (4 edges at
// GAT's widths), so a row of ~13,100 entries (ogbn-arxiv's largest) keeps
// one group busy for ~3,300 dependent passes, milliseconds after every
// other warp has finished. The CSR's split plan (`kernels/spmm_csr.py::
// split_plan`, built once per storage, the one `csr_spmm` takes) cuts each
// row longer than C entries into chunks of C consecutive entries. One
// launch then has two roles, by block index, in both mappings: the first
// blocks take the chunks, one group (one warp on WARP_PER_ROW) a chunk as
// if it were a row, loading the row's d1 segment once per chunk; they are
// scheduled first, so the long work starts first. The other blocks map
// rows as before and skip a row longer than C. An SDDMM writes each (edge,
// head) once, so there is no workspace, no second launch and no atomics:
// each output is the same per-edge dot, its features summed in the same
// order, so the split launch's output is bitwise the one without a plan
// (MEAN divides by the whole row's degree). Without a plan, or with an
// empty one, the launch is the one before plans existed.

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kMaxK = 8;  // elements a lane holds per chunk: 256 features

// A split plan on the device: the chunks of the rows longer than `size`
// entries, in CSR order.
struct RowSplit {
  const int* row;    // [chunks] the row of each chunk
  const int* start;  // [chunks] its first entry; a chunk runs `size`
                     // entries or to its row's end
  int chunks, size;
};

// Blocks of `per_block` slots for `n` slots.
inline int blocks_for(int n, int per_block) {
  return (n + per_block - 1) / per_block;
}

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
// side by side (LPH * heads_per_pass <= 32 lanes). A warp serves a row, or
// with SPLIT in the first `chunk_blocks` blocks a chunk of `split`.
template <typename T, int K, int LPH, bool SPLIT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sddmm_csr_kernel(const int* __restrict__ rowptr,
                     const int* __restrict__ col, const T* __restrict__ d1,
                     const T* __restrict__ d2, float* __restrict__ out,
                     int num_rows, int heads, int feat, int heads_per_pass,
                     int mean, RowSplit split, int chunk_blocks) {
  int row, start, end, deg;  // deg: the whole row's, for MEAN
  if constexpr (SPLIT) {
    // every branch below is uniform across the warp
    if (blockIdx.x < chunk_blocks) {
      const int chunk = blockIdx.x * kWarpsPerBlock + threadIdx.y;
      if (chunk >= split.chunks) return;
      row = split.row[chunk];
      start = split.start[chunk];
      const int row_end = rowptr[row + 1];
      end = min(start + split.size, row_end);
      deg = row_end - rowptr[row];
    } else {
      row = (blockIdx.x - chunk_blocks) * kWarpsPerBlock + threadIdx.y;
      if (row >= num_rows) return;
      start = rowptr[row];
      end = rowptr[row + 1];
      deg = end - start;
      if (deg > split.size) return;  // its chunks write it
    }
  } else {
    row = blockIdx.x * kWarpsPerBlock + threadIdx.y;
    if (row >= num_rows) return;  // uniform across the warp
    start = rowptr[row];
    end = rowptr[row + 1];
    deg = end - start;
  }
  if (start == end) return;
  const int lane = threadIdx.x;
  const int lanes_per_edge = LPH * heads_per_pass;
  const int edges_per_pass = kWarp / lanes_per_edge;
  const int slot = lane / lanes_per_edge;       // edge of the row in flight
  const int hp = lane % lanes_per_edge / LPH;   // head within the pass
  const int lg = lane % LPH;                    // lane within the head
  const int hf = heads * feat;
  const int chunks = (feat + LPH * K - 1) / (LPH * K);
  const float denom = mean ? static_cast<float>(deg) : 1.f;
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

// out[e, h] for the rows of this warp's groups. Lane l serves slot
// (warp * 32 + l) / group, counted from the first block of its role: a
// row, or with SPLIT in the first `chunk_blocks` blocks a chunk of
// `split`. Within its group, edge slot (l % group) / P of each pass, head
// h0 + (l % P) / Q and vectors q + k * Q (q = l % Q) of that head, VEC
// elements each; CHUNKED when a head is wider than Q * K vectors, which
// then come chunk by chunk.
template <typename T, int VEC, int K, bool CHUNKED, bool SPLIT>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
    sddmm_group_kernel(const int* __restrict__ rowptr,
                       const int* __restrict__ col, const T* __restrict__ d1,
                       const T* __restrict__ d2, float* __restrict__ out,
                       int num_rows, int heads, int feat, int q_lanes,
                       int heads_per_pass, int group, int mean,
                       RowSplit split, int chunk_blocks) {
  using V = Packed<T, VEC>;
  const int lane = threadIdx.x;
  const int li = lane & (group - 1);
  // a lane past the last slot, or on a split row, walks no edges but
  // keeps taking part in the warp's shuffles
  int row, start, end, deg;  // deg: the whole row's, for MEAN
  bool has_row;
  if constexpr (SPLIT) {
    const bool chunk_role = blockIdx.x < chunk_blocks;  // block-uniform
    const int unit =
        ((chunk_role ? blockIdx.x : blockIdx.x - chunk_blocks) *
             kWarpsPerBlock + threadIdx.y) * (kWarp / group) + lane / group;
    row = start = end = deg = 0;
    has_row = false;
    if (chunk_role) {
      if (unit < split.chunks) {
        row = split.row[unit];
        start = split.start[unit];
        const int row_end = rowptr[row + 1];
        end = min(start + split.size, row_end);
        deg = row_end - rowptr[row];
        has_row = true;
      }
    } else if (unit < num_rows) {
      start = rowptr[unit];
      end = rowptr[unit + 1];
      deg = end - start;
      has_row = deg <= split.size;  // else its chunks write it
      row = has_row ? unit : 0;
      if (!has_row) start = end = 0;
    }
  } else {
    row = (blockIdx.x * kWarpsPerBlock + threadIdx.y) * (kWarp / group) +
          lane / group;
    has_row = row < num_rows;
    start = has_row ? rowptr[row] : 0;
    end = has_row ? rowptr[row + 1] : 0;
    deg = end - start;
  }
  const int per_edge = q_lanes * heads_per_pass;  // P
  const int in_pass = group / per_edge;           // edges a pass
  const int slot = li / per_edge;
  const int hp = li % per_edge / q_lanes;
  const int q = li % q_lanes;
  const int hf = heads * feat;
  const int head_vecs = feat / VEC;
  const int chunks = CHUNKED ? (head_vecs + q_lanes * K - 1) / (q_lanes * K)
                             : 1;
  const T* d1_row = d1 + static_cast<int64_t>(has_row ? row : 0) * hf;

  for (int h0 = 0; h0 < heads; h0 += heads_per_pass) {  // uniform
    const int h = h0 + hp;
    const bool head_ok = has_row && h < heads;
    float a[K][VEC];
    auto load_d1 = [&](int ch) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = (ch * K + k) * q_lanes + q;
        V x;
        if (head_ok && v < head_vecs)
          x = *reinterpret_cast<const V*>(d1_row + h * feat + v * VEC);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          a[k][i] = head_ok && v < head_vecs ? to_float(x.v[i]) : 0.f;
      }
    };
    if (!CHUNKED) load_d1(0);  // the row's d1 segment, once
    // every lane runs every pass (the warp's longest row decides), so the
    // full-mask shuffles never see a lane that has left
    for (int base = start; __any_sync(kFullMask, base < end);
         base += in_pass) {
      const int e = base + slot;
      const bool valid = head_ok && e < end;
      const int c = valid ? col[e] : 0;
      float acc = 0.f;
      for (int ch = 0; ch < chunks; ++ch) {
        if (CHUNKED) load_d1(ch);
        // the lane's K gathers in flight before the first FMA
        V x[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = (ch * K + k) * q_lanes + q;
          if (valid && v < head_vecs)
            x[k] = *reinterpret_cast<const V*>(
                d2 + static_cast<int64_t>(c) * hf + h * feat + v * VEC);
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int v = (ch * K + k) * q_lanes + q;
          if (valid && v < head_vecs) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              acc += a[k][i] * to_float(x[k].v[i]);
          }
        }
      }
      for (int off = q_lanes / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kFullMask, acc, off);
      if (valid && q == 0)
        out[static_cast<int64_t>(e) * heads + h] =
            mean ? acc / static_cast<float>(deg) : acc;
    }
  }
}

// One launch of the one-warp-a-row kernel: the chunks' blocks first where
// `split` has chunks, else the kernel without roles.
template <typename T, int K, int LPH>
void launch_k(cudaStream_t s, const int* rowptr, const int* col,
              const void* d1, const void* d2, float* out, int num_rows,
              int heads, int feat, int mean, const RowSplit& split) {
  int per_pass = 1;  // heads side by side: a power of two, <= 32 lanes
  while (per_pass < heads && per_pass * 2 * LPH <= kWarp) per_pass *= 2;
  const dim3 block(kWarp, kWarpsPerBlock);
  const int row_blocks = blocks_for(num_rows, kWarpsPerBlock);
  const auto* a = static_cast<const T*>(d1);
  const auto* b = static_cast<const T*>(d2);
  if (split.chunks == 0) {
    sddmm_csr_kernel<T, K, LPH, false><<<row_blocks, block, 0, s>>>(
        rowptr, col, a, b, out, num_rows, heads, feat, per_pass, mean, split,
        0);
  } else {
    const int chunk_blocks = blocks_for(split.chunks, kWarpsPerBlock);
    sddmm_csr_kernel<T, K, LPH, true>
        <<<chunk_blocks + row_blocks, block, 0, s>>>(
            rowptr, col, a, b, out, num_rows, heads, feat, per_pass, mean,
            split, chunk_blocks);
  }
}

// Lanes per head LPH and elements per lane K for a head of `feat`
// features: four elements a lane up to F = 128 (LPH = 1 ... 32), then
// eight, in chunks of 256 features beyond that.
template <typename T>
int launch(int device, const int* rowptr, const int* col, const void* d1,
           const void* d2, float* out, int num_rows, int heads, int feat,
           int mean, const RowSplit& split, void* stream) {
  if (num_rows <= 0 || heads <= 0 || feat <= 0) return cudaErrorInvalidValue;
  if (static_cast<int64_t>(heads) * feat > INT32_MAX)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DG_LAUNCH(K, LPH)                                                  \
  launch_k<T, K, LPH>(s, rowptr, col, d1, d2, out, num_rows, heads, feat, \
                      mean, split)
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

// The group kernel's arguments, passed down the template dispatch.
struct Group {
  const int* rowptr;
  const int* col;
  const void* d1;
  const void* d2;
  float* out;
  int num_rows, heads, feat, mean, q, heads_per_pass, group;
  RowSplit split;
  cudaStream_t s;
};

template <typename T, int VEC, int K, bool CHUNKED>
void launch_group_kernel(const Group& a) {
  const int slots = kWarpsPerBlock * (kWarp / a.group);  // slots a block
  const int row_blocks = blocks_for(a.num_rows, slots);
  const dim3 block(kWarp, kWarpsPerBlock);
  const auto* d1 = static_cast<const T*>(a.d1);
  const auto* d2 = static_cast<const T*>(a.d2);
  if (a.split.chunks == 0) {
    sddmm_group_kernel<T, VEC, K, CHUNKED, false>
        <<<row_blocks, block, 0, a.s>>>(
            a.rowptr, a.col, d1, d2, a.out, a.num_rows, a.heads, a.feat,
            a.q, a.heads_per_pass, a.group, a.mean, a.split, 0);
  } else {
    const int chunk_blocks = blocks_for(a.split.chunks, slots);
    sddmm_group_kernel<T, VEC, K, CHUNKED, true>
        <<<chunk_blocks + row_blocks, block, 0, a.s>>>(
            a.rowptr, a.col, d1, d2, a.out, a.num_rows, a.heads, a.feat,
            a.q, a.heads_per_pass, a.group, a.mean, a.split, chunk_blocks);
  }
}

template <typename T, int VEC, int K>
int launch_group(const Group& a) {
  if (a.feat / VEC > a.q * K)
    launch_group_kernel<T, VEC, K, true>(a);
  else
    launch_group_kernel<T, VEC, K, false>(a);
  return cudaGetLastError();
}

// K vectors a lane, at most 16 elements of T a lane.
template <typename T, int VEC>
int group_k(int k, const Group& a) {
  switch (k) {
    case 1:
      return launch_group<T, VEC, 1>(a);
    case 2:
      if constexpr (2 * VEC <= 16) return launch_group<T, VEC, 2>(a);
      break;
    case 4:
      if constexpr (4 * VEC <= 16) return launch_group<T, VEC, 4>(a);
      break;
    case 8:
      if constexpr (8 * VEC <= 16) return launch_group<T, VEC, 8>(a);
      break;
  }
  return cudaErrorInvalidValue;
}

bool pow2(int x) { return x >= 1 && (x & (x - 1)) == 0; }

// Refuses a path the group kernel cannot run: `vec` a power of two of at
// most 16 bytes dividing F, d1 and d2 aligned to it; `k` 1, 2, 4 or 8 with
// k * vec <= 16; q, heads_per_pass and group powers of two with
// q * heads_per_pass <= group <= 32.
template <typename T>
int group_path(int vec, int k, const Group& a) {
  const int bytes = vec * static_cast<int>(sizeof(T));
  if (!pow2(vec) || bytes > 16 || a.feat % vec || !aligned(a.d1, bytes) ||
      !aligned(a.d2, bytes) || !pow2(k) || k > 8 || k * vec > 16 ||
      !pow2(a.q) || !pow2(a.heads_per_pass) || !pow2(a.group) ||
      a.group > kWarp || a.q * a.heads_per_pass > a.group)
    return cudaErrorInvalidValue;
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2) return group_k<T, 8>(k, a);
      return cudaErrorInvalidValue;
    case 4:
      return group_k<T, 4>(k, a);
    case 2:
      return group_k<T, 2>(k, a);
    default:
      return group_k<T, 1>(k, a);
  }
}

// The split plan as the C interface takes it: `chunks` chunks of `chunk`
// entries, `plan` int32 chunk_row [chunks] then chunk_start [chunks] (the
// rest of `kernels/spmm_csr.py::SplitPlan.index` is unread here); no
// chunks, no plan. False where the arguments cannot be a plan.
bool row_split(const int* plan, int chunks, int chunk, RowSplit* split) {
  if (chunks < 0 || (chunks > 0 && (!plan || chunk < 1))) return false;
  *split = {plan, chunks > 0 ? plan + chunks : nullptr, chunks, chunk};
  return true;
}

}  // namespace

extern "C" {

// out[nnz, H] (fp32) = per-edge, per-head dots of d1 [M, H*F] rows and
// d2 [N, H*F] rows over CSR A (rowptr [M+1], col [nnz] int32), d1 and d2
// in `dtype` (0 fp32, 1 bf16); mean != 0 divides by max(deg, 1). On the
// path (vec, k, q, heads_per_pass, group): `vec` elements a load, `k`
// vectors a lane, `q` lanes a head, `heads_per_pass` heads of an edge side
// by side, `group` lanes a row. A split plan of `chunks` > 0 chunks of
// `chunk` entries (every row longer than `chunk`): `plan`, int32 chunk_row
// [chunks] and chunk_start [chunks] one after the other; `chunks` 0 and
// `plan` NULL for none. Returns a cudaError_t.
int dg_sddmm_csr_group(int dtype, int device, const int* rowptr,
                       const int* col, const void* d1, const void* d2,
                       float* out, int num_rows, int heads, int feat,
                       int mean, int vec, int k, int q, int heads_per_pass,
                       int group, const int* plan, int chunks, int chunk,
                       void* stream) {
  RowSplit split;
  if (num_rows <= 0 || heads <= 0 || feat <= 0 ||
      static_cast<int64_t>(heads) * feat > INT32_MAX ||
      !row_split(plan, chunks, chunk, &split))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Group a{rowptr, col,  d1,   d2,    out, num_rows, heads, feat, mean,
                q,      heads_per_pass, group, split,
                static_cast<cudaStream_t>(stream)};
  if (dtype == kFloat32) return group_path<float>(vec, k, a);
  if (dtype == kBFloat16) return group_path<__nv_bfloat16>(vec, k, a);
  return cudaErrorInvalidValue;
}

// The same on the one-warp-a-row mapping (no path). Returns a cudaError_t.
int dg_sddmm_csr(int dtype, int device, const int* rowptr, const int* col,
                 const void* d1, const void* d2, float* out, int num_rows,
                 int heads, int feat, int mean, const int* plan, int chunks,
                 int chunk, void* stream) {
  RowSplit split;
  if (!row_split(plan, chunks, chunk, &split)) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch<float>(device, rowptr, col, d1, d2, out, num_rows, heads,
                         feat, mean, split, stream);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(device, rowptr, col, d1, d2, out, num_rows,
                                 heads, feat, mean, split, stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
