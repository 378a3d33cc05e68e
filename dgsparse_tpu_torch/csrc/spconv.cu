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
// channels) one direction is 2 * 2.08 M * 64 * 64 = 17 GFLOP against ~27 MB
// of compulsory bytes: operations bound it, and dW has as many. Both
// kernels run their products on the tensor cores (mma.sync.m16n8k8, TF32)
// and keep fp32 parity with the JAX package's Precision.HIGHEST (1e-5) as
// 3xTF32 (common.cuh), at 495 / 3 = 165 TFLOP/s of fp32-accurate product
// against 67 TFLOP/s of FFMA: 0.10 ms at enc2 for each. bf16 values are
// exact in TF32, so bf16 takes one exact TF32 pass with fp32 sums (the
// same fragments as fp32, where an m16n8k16 bf16 path would need its own).
//
// spconv_pairs: each (destination row, offset) has at most one pair, so at
// one offset the pairs of a block of 128 destination rows form a dense
// product of at most 128 gathered rows with one weight slice. One CTA owns
// 128 destination rows and a tile of 32 or 64 output channels. It reads its
// rows' pairs once into a map [offset][row] -> source row in shared memory
// and walks the offsets where some row has a pair, 32 input channels per
// step, through a two-stage cp.async ring: while one step multiplies, the
// next step's weight slice and gathered rows (one 16-byte cp.async per 4
// fp32 channels) are in flight. 8 warps, 4 x 2, each hold a 32 x CT/2
// accumulator tile in registers. Two variants, chosen per plan:
//   padded (DENSE): A row j is destination row j, zero-filled (cp.async
//   src-size 0) where the row has no pair at the offset; the accumulator is
//   the output tile itself, kept in registers across every offset and
//   written once. No compaction, no shared-memory sums; it computes the
//   empty rows too (23 % of the products at enc2). Each step's tiles are
//   split into TF32 parts once (`split_tile`), not per warp that loads
//   them, and every product is unconditional.
//   compacting: A row j is the j-th row with a pair at the offset (the map
//   compacted once per CTA); only the warps whose 32 rows hold pairs
//   multiply, and each offset's product is added into fp32 row sums in
//   shared memory, written once at the end. For sparse plans (the fine
//   grid: 2-10 rows of 128 per offset), where the padded variant would
//   multiply mostly zeros.
// The rule (`dg_spconv_pairs`): a plan whose mean pairs per (block of 128
// rows, offset), reckoned once by `kernels/spconv.py::pair_csr`, reach
// kDenseRows takes the padded variant; below that the compacting one does
// less than half the padded one's products. No atomics; every sum is taken
// in a fixed order, so results are bitwise repeatable.
//
// spconv_dw: dW[k] = Σ over offset k's pairs of x[in]ᵀ g[out] is a product
// of M = c_in by N = c_out over K = the pairs. One CTA per (chunk of one
// offset's pairs, 64 x 64 tile of dW) walks its chunk 32 pairs a step
// through a three-stage cp.async ring: the step's gathered x rows and g
// rows land as [pair][channel] tiles (one 16-byte cp.async per 4 fp32 or 8
// bf16 channels where rows are 16-byte aligned, element copies otherwise),
// which the fragments read as they are, x's k-major as A = xᵀ
// (`load_a_kmajor`) and g's as B; each step's pair ids are read once,
// into shared memory, a step ahead of the copies that use them. What
// bounds this kernel is shared-memory traffic: fp32 values are split into
// TF32 parts as their fragments load: a split pass (`split_tile`) that
// writes big and small tiles, and doubles the bytes each fragment reads,
// ran slower on an H100 than the repeated splits; the three products
// follow `mma_tiles`' order, under masks that are uniform across each
// warp. 8 warps in two groups of 2 x 2 hold 32 x 32 tiles of dW in
// registers, each group over half of a step's k8 slices, and their sums
// join once, in a fixed order, into the chunk's partial; a second launch
// sums each offset's partials in chunk order. Deterministic, no atomics.
// Two CTAs an SM (125 registers a thread).

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kRows = 128;     // destination rows per CTA (spconv_pairs)
constexpr int kKC = 32;        // input channels per pipeline step
constexpr int kStages = 2;     // depth of the cp.async ring
constexpr int kDenseRows = 64; // mean busy rows per (block, offset) that
                               // select the padded variant
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448 - 1024;  // a CTA's shared memory, less
                                           // the static row_ptr
constexpr int kDwPairs = 32;   // pairs staged per step (spconv_dw)
constexpr int kDwTile = 64;    // dW tile: 64 input x 64 output channels
constexpr int kDwStride = kDwTile + 8;  // staged row stride, elements
constexpr int kDwStages = 3;   // depth of spconv_dw's cp.async ring
constexpr int kDwIdSlots = 4;  // steps of pair ids in shared memory

// Dynamic shared memory of pairs_kernel<T, CT, DENSE>: the ring of A tiles
// (gathered rows [kRows][kSA]) and B tiles (weight slices [kKC][kSB]); the
// padded fp32 variant's TF32 remainders of the step in use (split_tile), or
// the compacting variant's fp32 row sums [kRows][CT]; the map
// [k_vol][kRows]; per offset its count and the list of busy offsets; the
// compacting variant's destination rows [k_vol][kRows] (bytes). Row strides
// pad by 16 bytes (A) and 8 elements (B), so rows stay 16-byte aligned and
// the fragment loads hit 32 distinct banks.
template <typename T, int CT, bool DENSE>
struct PairsSmem {
  static constexpr int kSA = kKC + 16 / static_cast<int>(sizeof(T));
  static constexpr int kSB = CT + 8;
  static constexpr int kABytes = kRows * kSA * sizeof(T);
  static constexpr int kBBytes = kKC * kSB * sizeof(T);
  static constexpr int kRing = kStages * (kABytes + kBBytes);
  static constexpr int kSmall =
      DENSE && sizeof(T) == 4 ? kABytes + kBBytes : 0;
  static constexpr int kAcc = DENSE ? 0 : kRows * CT * 4;
  static size_t bytes(int k_vol) {
    return kRing + kSmall + kAcc + 4 * k_vol * (kRows + 2) +
           (DENSE ? 0 : k_vol * kRows);
  }
};

// One CTA per (128 destination rows, CT output channels).
template <typename T, int CT, bool DENSE, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    pairs_kernel(const int* __restrict__ ptr, const int* __restrict__ src,
                 const int* __restrict__ widx, const T* __restrict__ x,
                 const T* __restrict__ w, float* __restrict__ out,
                 int num_rows, int c_in, int c_out, int k_vol) {
  using L = PairsSmem<T, CT, DENSE>;
  // fp32: 3xTF32, split once per staged tile in the padded variant (every
  // value is used), on load in the compacting one; bf16: exact
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kMode = !kSplit ? kExact : DENSE ? kPreSplit : kSplitOnLoad;
  constexpr int kE = 16 / sizeof(T);       // elements per 16-byte copy
  constexpr int kWN = CT / 2;              // warp tile: 32 rows x kWN
  constexpr int kNT = kWN / 8;             // n8 tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring_a = reinterpret_cast<T*>(smem);
  T* const ring_b = reinterpret_cast<T*>(smem + kStages * L::kABytes);
  float* const small_a = reinterpret_cast<float*>(smem + L::kRing);
  float* const small_b = small_a + L::kABytes / 4;
  float* const acc_s = reinterpret_cast<float*>(smem + L::kRing + L::kSmall);
  int* const map =
      reinterpret_cast<int*>(smem + L::kRing + L::kSmall + L::kAcc);
  int* const cnt = map + k_vol * kRows;
  int* const klist = cnt + k_vol;
  unsigned char* const lrow = reinterpret_cast<unsigned char*>(klist + k_vol);
  __shared__ int row_ptr[kRows + 1];
  __shared__ int num_k;

  const int r0 = blockIdx.x * kRows;
  const int o0 = blockIdx.y * CT;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 2, wn = warp % 2;
  const int rows = min(kRows, num_rows - r0);

  for (int i = tid; i <= kRows; i += kThreads)
    row_ptr[i] = ptr[r0 + min(i, rows)];
  for (int i = tid; i < k_vol * kRows; i += kThreads) map[i] = -1;
  for (int i = tid; i < k_vol; i += kThreads) cnt[i] = 0;
  if (!DENSE)
    for (int i = tid; i < kRows * CT; i += kThreads) acc_s[i] = 0.f;
  __syncthreads();
  // map[k][r] = the source row of the pair (r0 + r, offset k), or -1
  for (int p = row_ptr[0] + tid; p < row_ptr[kRows]; p += kThreads) {
    int lo = 0, hi = rows;  // row_ptr[lo] <= p < row_ptr[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (row_ptr[mid] <= p) lo = mid; else hi = mid;
    }
    const int k = widx[p];
    map[k * kRows + lo] = src[p];
    cnt[k] = 1;
  }
  __syncthreads();
  if (!DENSE) {
    // compact each offset's busy rows in row order: map[k][j] = the j-th
    // source row, lrow[k][j] its destination row, cnt[k] their number
    for (int k = warp; k < k_vol; k += kWarpsPerBlock) {
      if (!cnt[k]) continue;
      int* m = map + k * kRows;
      int v[kRows / kWarp];
#pragma unroll
      for (int j = 0; j < kRows / kWarp; ++j) v[j] = m[j * kWarp + lane];
      __syncwarp();
      int n = 0;
#pragma unroll
      for (int j = 0; j < kRows / kWarp; ++j) {
        const unsigned b = __ballot_sync(kFullMask, v[j] >= 0);
        if (v[j] >= 0) {
          const int at = n + __popc(b & ((1u << lane) - 1u));
          m[at] = v[j];
          lrow[k * kRows + at] = static_cast<unsigned char>(j * kWarp + lane);
        }
        n += __popc(b);
      }
      __syncwarp();
      if (lane == 0) cnt[k] = n;
    }
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < k_vol; ++k)
      if (cnt[k]) klist[n++] = k;
    num_k = n;
  }
  __syncthreads();

  const int nchunk = (c_in + kKC - 1) / kKC;
  const int nsteps = num_k * nchunk;

  // step s: offset klist[s / nchunk], input channels i0 .. i0 + kKC
  auto issue = [&](int s) {
    const int k = klist[s / nchunk];
    const int i0 = (s % nchunk) * kKC;
    // whole k8 slices; all of them in the padded variant, which multiplies
    // every slice of a step
    const int kc = DENSE ? kKC : min(kKC, (c_in - i0 + 7) / 8 * 8);
    T* as = ring_a + (s % kStages) * kRows * L::kSA;
    T* bs = ring_b + (s % kStages) * kKC * L::kSB;
    const int* m = map + k * kRows;
    const int nrows = DENSE ? kRows : cnt[k];
    const T* wk = w + static_cast<int64_t>(k) * c_in * c_out;
    if (VEC) {
      // 16-byte copies: a row's source id and column, zero-filled where the
      // row has no pair or the columns pass c_in (constant trip counts in
      // the padded variant)
      auto copy_a = [&](int e, int qa) {
        const int j = e / qa, c = (e % qa) * kE;
        const int sj = m[j];
        const int n = sj >= 0 ? max(min(kE, c_in - i0 - c), 0) : 0;
        cp_async16(as + j * L::kSA + c,
                   n ? x + static_cast<int64_t>(sj) * c_in + i0 + c : x,
                   n * static_cast<int>(sizeof(T)));
      };
      if constexpr (DENSE) {
#pragma unroll
        for (int it = 0; it < kRows * kKC / kE / kThreads; ++it)
          copy_a(tid + it * kThreads, kKC / kE);
      } else {
        for (int e = tid; e < nrows * (kc / kE); e += kThreads)
          copy_a(e, kc / kE);
      }
      constexpr int qb = CT / kE;
#pragma unroll 2
      for (int e = tid; e < kc * qb; e += kThreads) {
        const int i = e / qb, o = (e % qb) * kE;
        const int n = i0 + i < c_in ? max(min(kE, c_out - o0 - o), 0) : 0;
        cp_async16(bs + i * L::kSB + o,
                   n ? wk + static_cast<int64_t>(i0 + i) * c_out + o0 + o : w,
                   n * static_cast<int>(sizeof(T)));
      }
    } else {
      for (int e = tid; e < nrows * kc; e += kThreads) {
        const int j = e / kc, c = e % kc;
        const int sj = m[j];
        const bool ok = sj >= 0 && i0 + c < c_in;
        cp_async_elem(as + j * L::kSA + c,
                      ok ? x + static_cast<int64_t>(sj) * c_in + i0 + c : x,
                      ok);
      }
      for (int e = tid; e < kc * CT; e += kThreads) {
        const int i = e / CT, o = e % CT;
        const bool ok = i0 + i < c_in && o0 + o < c_out;
        cp_async_elem(bs + i * L::kSB + o,
                      ok ? wk + static_cast<int64_t>(i0 + i) * c_out + o0 + o
                         : w,
                      ok);
      }
    }
  };

  // padded: warp (wm, wn) holds rows 32 wm .. + 32 and columns wn * kWN ..
  // + kWN of the output tile, acc[m-tile][n-tile], for every offset;
  // compacting: warp w holds n-tile w % kNTiles and the m-tiles w /
  // kNTiles + j * kMStride of each offset's busy rows, acc[j][0], until
  // they are added into acc_s
  constexpr int kNTiles = CT / 8;
  constexpr int kMStride = kWarpsPerBlock / kNTiles;
  constexpr int kAccM = DENSE ? 2 : kRows / 16 / kMStride;
  constexpr int kAccN = DENSE ? kNT : 1;
  float acc[kAccM][kAccN][4];
#pragma unroll
  for (int m = 0; m < kAccM; ++m)
#pragma unroll
    for (int n = 0; n < kAccN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  // compacting: the busy n-tiles from this warp's on
  const int cnt_n = (c_out - o0 + 7) / 8 - warp % kNTiles;
  const int ct_nt = warp % kNTiles, ct_m0 = warp / kNTiles;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();

    const int k = klist[s / nchunk];
    const int i0 = (s % nchunk) * kKC;
    T* as = ring_a + (s % kStages) * kRows * L::kSA;
    T* bs = ring_b + (s % kStages) * kKC * L::kSB;
    if constexpr (DENSE) {
      if constexpr (kSplit) {
        split_tile(reinterpret_cast<float*>(as), small_a, kRows, kKC, L::kSA,
                   tid, kThreads);
        split_tile(reinterpret_cast<float*>(bs), small_b, kKC, CT, L::kSB,
                   tid, kThreads);
        __syncthreads();
      }
      // every k8 slice and n-tile, unconditionally: the tiles are
      // zero-filled past c_in and c_out, and a product under a branch the
      // compiler cannot prove uniform costs a warp barrier each
      const int a_off = 32 * wm * L::kSA, b_off = wn * kWN;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        Frag<4> a[2];
        Frag<2> b[kNT];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int at = a_off + mt * 16 * L::kSA + kk;
          load_a<kMode>(a[mt], as + at, small_a + at, L::kSA, 1, lane);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int at = b_off + kk * L::kSB + nt * 8;
          load_b<kMode>(b[nt], bs + at, small_b + at, L::kSB, lane);
        }
        mma_tiles<kSplit, kSplit>(acc, a, b, 2, kNT);
      }
    } else {
      // this warp's m-tiles that hold busy rows
      const int nrows = cnt[k];
      const int cnt_m =
          cnt_n > 0 ? ((nrows + 15) / 16 - ct_m0 + kMStride - 1) / kMStride
                    : 0;
      bs += ct_nt * 8;
#pragma unroll
      for (int kk = 0; kk < kKC; kk += 8) {
        if (i0 + kk >= c_in || cnt_m <= 0) break;
        Frag<2> b[1];
        load_b<kMode>(b[0], bs + kk * L::kSB, nullptr, L::kSB, lane);
#pragma unroll
        for (int j = 0; j < kAccM; j += 2) {
          if (j >= cnt_m) break;
          Frag<4> a[2];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (j + h < cnt_m)
              load_a<kMode>(a[h],
                            as + (ct_m0 + (j + h) * kMStride) * 16 * L::kSA +
                                kk,
                            nullptr, L::kSA, 1, lane);
          mma_tiles<kSplit, kSplit>(
              *reinterpret_cast<float(*)[2][1][4]>(&acc[j]), a, b,
              min(2, cnt_m - j), 1);
        }
      }
      if (s % nchunk == nchunk - 1) {
        // the offset's product into its busy rows' sums: one thread per
        // (busy row, channel), steps apart by the barrier
#pragma unroll
        for (int j = 0; j < kAccM; ++j) {
          if (j >= cnt_m) break;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = (ct_m0 + j * kMStride) * 16 + g + 8 * (i >> 1);
            if (row < nrows)
              acc_s[lrow[k * kRows + row] * CT + ct_nt * 8 + 2 * t +
                    (i & 1)] += acc[j][0][i];
            acc[j][0][i] = 0.f;
          }
        }
      }
    }
  }

  if constexpr (DENSE) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 32 * wm + 16 * mt + g + 8 * (i >> 1);
          const int o = o0 + wn * kWN + nt * 8 + 2 * t + (i & 1);
          if (r < rows && o < c_out)
            out[static_cast<int64_t>(r0 + r) * c_out + o] = acc[mt][nt][i];
        }
  } else {
    __syncthreads();
    for (int e = tid; e < rows * CT; e += kThreads) {
      const int r = e / CT, o = e % CT;
      if (o0 + o < c_out)
        out[static_cast<int64_t>(r0 + r) * c_out + o0 + o] = acc_s[e];
    }
  }
}

// Dynamic shared memory of dw_partial_kernel<T>: the ring of staged x
// rows and g rows, each tile [kDwPairs][kDwStride] (a pair's channels in a
// row: the product reads x's tile k-major as A = xᵀ and g's as B), then
// the pair ids of kDwIdSlots steps ([slot][in ids, out ids]). The stride
// of 72 elements keeps rows 16-byte aligned and the fragment loads on
// distinct banks.
template <typename T>
struct DwSmem {
  static constexpr int kTile = kDwPairs * kDwStride * sizeof(T);
  static constexpr int kRing = kDwStages * 2 * kTile;
  static constexpr int kIds = kDwIdSlots * 2 * kDwPairs * 4;
  static constexpr int kBytes = kRing + kIds;
};

// One CTA per (chunk c of one offset's pairs, 64 x 64 tile of dW): the
// partial sum over pairs [bounds[c], bounds[c + 1]) of x[in]ᵀ g[out], into
// part[c] [c_in, c_out]. M = input channels, N = output channels, K = the
// chunk's pairs, kDwPairs a step through a kDwStages-deep cp.async ring.
// 8 warps in two groups of 2 x 2: each warp holds a 32 x 32 tile of dW in
// registers, and group kg multiplies the k8 slices 2 j + kg of each step
// (fewer fragment loads a product than 8 warps of 32 x 16 over every
// slice); group 1's sums join group 0's once, at the end.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    dw_partial_kernel(const int* __restrict__ bounds,
                      const int* __restrict__ in_ids,
                      const int* __restrict__ out_ids,
                      const T* __restrict__ x, const T* __restrict__ g,
                      float* __restrict__ part, int c_in, int c_out) {
  // fp32: 3xTF32, each value split as its fragment loads (a split pass
  // over the staged tiles costs more shared-memory traffic than the
  // repeated splits cost instructions); bf16: one exact pass
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kMode = kSplit ? kSplitOnLoad : kExact;
  constexpr int kE = 16 / sizeof(T);               // elements a 16-byte copy
  constexpr int kTileElems = kDwPairs * kDwStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  int* const ids = reinterpret_cast<int*>(smem + DwSmem<T>::kRing);

  const int c = blockIdx.x;
  const int i0 = blockIdx.y * kDwTile;
  const int o0 = blockIdx.z * kDwTile;
  const int tid = threadIdx.x, lane = tid % kWarp;
  // warp-uniform as the compiler sees it, so the masks below branch
  // uniformly and the products need no warp barrier
  const int warp = __shfl_sync(kFullMask, tid / kWarp, 0);
  const int kg = warp / 4, wm = warp % 4 / 2, wn = warp % 2;
  const int lo = bounds[c];
  const int hi = bounds[c + 1];
  const int nsteps = (hi - lo + kDwPairs - 1) / kDwPairs;

  // pair ids of step s, one a thread of the first 2 * kDwPairs: in ids,
  // then out ids; -1 past the chunk
  auto load_id = [&](int s) {
    const int q = lo + s * kDwPairs + tid % kDwPairs;
    if (q >= hi) return -1;
    return tid < kDwPairs ? in_ids[q] : out_ids[q];
  };
  auto id_slot = [&](int s) { return ids + (s % kDwIdSlots) * 2 * kDwPairs; };

  // step s: pairs lo + s * kDwPairs .., their x rows (channels i0 ..) and
  // g rows (channels o0 ..), zero-filled past the chunk and the channels
  auto issue = [&](int s) {
    T* xs = ring + (s % kDwStages) * 2 * kTileElems;
    T* gs = xs + kTileElems;
    const int* sid = id_slot(s);
    if (VEC) {
      constexpr int q = kDwTile / kE;
#pragma unroll
      for (int it = 0; it < kDwPairs * q / kThreads; ++it) {
        const int e = tid + it * kThreads;
        const int p = e / q, col = (e % q) * kE;
        const int xi = sid[p], gi = sid[kDwPairs + p];
        const int nx = xi >= 0 && i0 + col < c_in ? kE : 0;
        const int ng = gi >= 0 && o0 + col < c_out ? kE : 0;
        cp_async16(xs + p * kDwStride + col,
                   nx ? x + static_cast<int64_t>(xi) * c_in + i0 + col : x,
                   nx * static_cast<int>(sizeof(T)));
        cp_async16(gs + p * kDwStride + col,
                   ng ? g + static_cast<int64_t>(gi) * c_out + o0 + col : g,
                   ng * static_cast<int>(sizeof(T)));
      }
    } else {
#pragma unroll 4
      for (int e = tid; e < kDwPairs * kDwTile; e += kThreads) {
        const int p = e / kDwTile, col = e % kDwTile;
        const int xi = sid[p], gi = sid[kDwPairs + p];
        const bool okx = xi >= 0 && i0 + col < c_in;
        const bool okg = gi >= 0 && o0 + col < c_out;
        cp_async_elem(xs + p * kDwStride + col,
                      okx ? x + static_cast<int64_t>(xi) * c_in + i0 + col
                          : x,
                      okx);
        cp_async_elem(gs + p * kDwStride + col,
                      okg ? g + static_cast<int64_t>(gi) * c_out + o0 + col
                          : g,
                      okg);
      }
    }
  };

  // the ids of steps 0 .. kDwStages - 1 in shared memory, the next step's
  // in a register: each step's ids are read once, a step ahead of the
  // copies that use them
  int next_id = 0;
  if (tid < 2 * kDwPairs) {
#pragma unroll
    for (int s = 0; s < kDwStages; ++s) id_slot(s)[tid] = load_id(s);
    next_id = load_id(kDwStages);
  }
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;
  // this warp's m16 / n8 tiles that hold channels (zero-filled past them:
  // the mask only saves products)
  const int m_valid = min(max((c_in - i0 - 32 * wm + 15) / 16, 0), 2);
  const int n_valid = min(max((c_out - o0 - 32 * wn + 7) / 8, 0), 4);

#pragma unroll
  for (int s = 0; s < kDwStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kDwStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (s + kDwStages - 1 < nsteps) issue(s + kDwStages - 1);
    cp_async_commit();
    if (tid < 2 * kDwPairs) {
      // slot s + kDwStages was last read by issue(s + kDwStages -
      // kDwIdSlots), before this step's barrier
      id_slot(s + kDwStages)[tid] = next_id;
      next_id = load_id(s + kDwStages + 1);
    }

    const T* xs = ring + (s % kDwStages) * 2 * kTileElems;
    const T* gs = xs + kTileElems;
#pragma unroll
    for (int j = 0; j < kDwPairs / 16; ++j) {
      const int kk = 16 * j + 8 * kg;  // this group's k8 slices
      Frag<4> a[2];
      Frag<2> b[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        load_a_kmajor<kMode>(a[mt], xs + kk * kDwStride + 32 * wm + 16 * mt,
                             nullptr, kDwStride, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        load_b<kMode>(b[nt], gs + kk * kDwStride + 32 * wn + 8 * nt, nullptr,
                      kDwStride, lane);
      mma_tiles<kSplit, kSplit>(acc, a, b, m_valid, n_valid);
    }
  }

  // group 1's sums into group 0's through the idle ring, in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float* red =
      reinterpret_cast<float*>(smem) + (warp % 4) * 32 * kWarp + lane;
  if (kg == 1) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[((m * 4 + n) * 4 + i) * kWarp] = acc[m][n][i];
  }
  __syncthreads();
  if (kg == 1) return;
  float* pc = part + static_cast<int64_t>(c) * c_in * c_out;
  const int gq = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v =
            acc[mt][nt][i] + red[((mt * 4 + nt) * 4 + i) * kWarp];
        const int r = i0 + 32 * wm + 16 * mt + gq + 8 * (i >> 1);
        const int o = o0 + 32 * wn + 8 * nt + 2 * t + (i & 1);
        if (r < c_in && o < c_out)
          pc[static_cast<int64_t>(r) * c_out + o] = v;
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

template <typename T, int CT, bool DENSE, bool VEC>
int launch_pairs_variant(const int* ptr, const int* src, const int* widx,
                         const void* x, const void* w, float* out,
                         int num_rows, int c_in, int c_out, int k_vol,
                         cudaStream_t s) {
  const size_t smem = PairsSmem<T, CT, DENSE>::bytes(k_vol);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  auto kernel = pairs_kernel<T, CT, DENSE, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((num_rows + kRows - 1) / kRows, (c_out + CT - 1) / CT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, s>>>(
      ptr, src, widx, static_cast<const T*>(x), static_cast<const T*>(w), out,
      num_rows, c_in, c_out, k_vol);
  return cudaGetLastError();
}

template <typename T, int CT>
int launch_pairs_ct(const int* ptr, const int* src, const int* widx,
                    const void* x, const void* w, float* out, int num_rows,
                    int c_in, int c_out, int k_vol, bool dense, bool vec,
                    cudaStream_t s) {
#define DG_PAIRS(D, V)                                                     \
  return launch_pairs_variant<T, CT, D, V>(ptr, src, widx, x, w, out,      \
                                           num_rows, c_in, c_out, k_vol, s)
  if (dense) {
    if (vec) DG_PAIRS(true, true);
    DG_PAIRS(true, false);
  }
  if (vec) DG_PAIRS(false, true);
  DG_PAIRS(false, false);
#undef DG_PAIRS
}

template <typename T>
int launch_pairs(int device, const int* ptr, const int* src, const int* widx,
                 const void* x, const void* w, float* out, int num_rows,
                 int c_in, int c_out, int k_vol, float density,
                 void* stream) {
  if (num_rows <= 0 || c_in <= 0 || c_out <= 0 || k_vol <= 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool dense = density >= kDenseRows;
  // 16-byte cp.async needs every row of x and of each weight slice to
  // start on a 16-byte boundary; otherwise the element-wise copies
  const int esize = static_cast<int>(sizeof(T));
  const bool vec = (c_in * esize) % 16 == 0 && (c_out * esize) % 16 == 0 &&
                   aligned(x, 16) && aligned(w, 16);
  if (c_out <= 32)
    return launch_pairs_ct<T, 32>(ptr, src, widx, x, w, out, num_rows, c_in,
                                  c_out, k_vol, dense, vec, s);
  return launch_pairs_ct<T, 64>(ptr, src, widx, x, w, out, num_rows, c_in,
                                c_out, k_vol, dense, vec, s);
}

template <typename T, bool VEC>
cudaError_t launch_dw_partial(const int* bounds, const int* in_ids,
                              const int* out_ids, const void* x,
                              const void* g, float* part, int num_chunks,
                              int c_in, int c_out, cudaStream_t s) {
  auto kernel = dw_partial_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DwSmem<T>::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_chunks, (c_in + kDwTile - 1) / kDwTile,
                  (c_out + kDwTile - 1) / kDwTile);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, DwSmem<T>::kBytes, s>>>(
      bounds, in_ids, out_ids, static_cast<const T*>(x),
      static_cast<const T*>(g), part, c_in, c_out);
  return cudaGetLastError();
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
    // 16-byte cp.async needs every row of x and g to start on a 16-byte
    // boundary; otherwise the element-wise copies
    const int esize = static_cast<int>(sizeof(T));
    const bool vec = (c_in * esize) % 16 == 0 && (c_out * esize) % 16 == 0 &&
                     aligned(x, 16) && aligned(g, 16);
    err = vec ? launch_dw_partial<T, true>(bounds, in_ids, out_ids, x, g,
                                           part, num_chunks, c_in, c_out, s)
              : launch_dw_partial<T, false>(bounds, in_ids, out_ids, x, g,
                                            part, num_chunks, c_in, c_out,
                                            s);
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
// sorted by offset, each (row, offset) at most once, every widx < k_vol;
// `row_block` must be 128. `density`, the plan's mean pairs per (block of
// 128 rows, offset), picks the variant: padded at kDenseRows and above,
// compacting below. Returns a cudaError_t.
int dg_spconv_pairs(int dtype, int device, const int* ptr, const int* src,
                    const int* widx, const void* x, const void* w,
                    float* out, int num_rows, int c_in, int c_out, int k_vol,
                    int row_block, float density, void* stream) {
  if (row_block != kRows) return cudaErrorInvalidValue;
  if (dtype == kFloat32)
    return launch_pairs<float>(device, ptr, src, widx, x, w, out, num_rows,
                               c_in, c_out, k_vol, density, stream);
  if (dtype == kBFloat16)
    return launch_pairs<__nv_bfloat16>(device, ptr, src, widx, x, w, out,
                                       num_rows, c_in, c_out, k_vol, density,
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
