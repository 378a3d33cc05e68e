// Dense-cell SpMM (forward and transpose) and dense-cell SDDMM for Hopper
// (sm_90a): the hybrid plan's materialized tier.
//
// Replaces two TPU kernels:
//   `dgsparse_tpu/kernels/pallas_spmm.py::spmm_dense_cells` (body
//   `_cell_matmul_kernel`): out[seg[t]] += cells[order[t]] @ B[win[t]], or
//   cellᵀ @ g into column windows with `transpose`, from the same cells;
//   `dgsparse_tpu/kernels/pallas_sddmm.py::sddmm_cells` (body
//   `_sddmm_cells_kernel`): out[t] = d1[rb[t]] @ d2[cw[t]]ᵀ, the [128, 128]
//   block of per-edge dots of each cell.
// The TPU kernels walk the cells in one sequential grid and carry a row
// block's sum in VMEM from one grid step to the next; here CTAs run in
// parallel, so one CTA owns one output block and walks that block's run of
// cells itself (a CSR over blocks, `blk_ptr`), keeping the sum in registers
// and writing it once, with no atomics: results are bitwise repeatable, and
// a block no cell visits is written as zero (the tier sum relies on it).
//
// What bounds them: a 128x128 cell times a [128, F] window is 2*128*128*F
// flops on 64 KB of cell and 512*F bytes of window, ~F/4 flops a byte.
// spmm_dense_cells runs its products on the tensor cores (mma.sync.m16n8k8,
// TF32) and keeps fp32 parity with the JAX package's Precision.HIGHEST
// (1e-5) as 3xTF32 (common.cuh): the cells are split into big + small TF32
// parts, and so is an fp32 B; a bf16 B is exact in TF32 and takes two
// passes (small·b + big·b). At 495 / 3 = 165 TFLOP/s of fp32-accurate
// product the GCN widths (F = 41, 64) are bound by the cell bytes, ~0.53 GB
// at Reddit scale (6,332 cells), ~160 us at 3.35 TB/s; each cell is read
// once per 64-feature tile, so once at F <= 64. Design: one CTA of 8 warps
// (4 x 2, each a 32 x 32 accumulator tile in registers) computes a [128,
// 64] output tile; the cells of its run are walked in k slices of 32
// through a three-stage cp.async ring (16-byte copies, zero-filled past the
// matrix), so a slice's copy overlaps the products of the two before it
// and the next cell's first slices are in flight while a cell finishes. The
// transpose stages the cell rows k0 .. k0 + 31 as they lie and reads A(r,
// k) = cell[k0 + k][r] from them at a row stride of 136 floats, so its
// fragment loads hit 32 distinct banks; no transposed copy of the cells
// exists.
//
// The bf16 compute mode (the JAX package's compute_dtype=bfloat16: the
// cells rounded to bf16, a bf16 B, fp32 accumulation) has a kernel of its
// own, dense_cells_bf16_kernel. It reads bf16 cell blocks, half the bytes
// of the fp32 ones: at Reddit scale 0.30 GB at F = 64, ~89 us at
// 3.35 TB/s. Both operands are bf16, so each product is one exact pass of
// mma.sync.m16n8k16 (bf16 in, fp32 accumulators), half the instructions of
// TF32's m16n8k8 on converted values, with no split; and the fragments
// come from shared memory through ldmatrix, which loads a warp's 16 x 16
// A tile or two 16 x 8 B tiles in one instruction where 16-bit element
// loads would take 32 (with those, the products fell behind the copies:
// 0.58 of the bound at F = 64 on an H100). The CTA
// design is the fp32 kernel's: one output block and 64 features a CTA, 8
// warps of 32 x 32, the block's cells walked through a three-stage
// cp.async ring, here in k slices of 64 (two a cell; a stage is 27 KB).
// ldmatrix reads 8 rows of 16 bytes a matrix, so the staged rows are
// padded to lie 4 banks apart: forward cell rows of 64 + 8 bf16 (144
// bytes), transposed rows of 128 + 8 (272 bytes; a bare bf16 row of 128
// is 256 bytes and would put all 8 rows on the same banks), B rows of 64
// + 8. The transpose reads A(r, k) = cell[k0 + k][r] through
// ldmatrix.trans from the staged rows, and B(k, n) comes through
// ldmatrix.trans too; a B staged flat (F = 41: rows of 82 bytes, not the
// 16-byte rows ldmatrix needs) is read element by element instead.
//
// sddmm_cells writes a [128, 128] fp32 block per cell, 64 KB, against
// 2 * 128 * F input values: at Reddit scale (6,332 cells) 415 MB of output,
// ~78 % of its compulsory bytes at F = 64, so the block store bounds it
// once the products run on the tensor cores (13.3 GFLOP at F = 64: 80 us at
// 165 TFLOP/s of 3xTF32, 198 us at FFMA's 67). Design: the products are
// 3xTF32 mma.sync as above, stepped 16 features at a time (F = 41 pads to
// 48); a CTA walks a chunk of consecutive cells, which the plan sorts by
// row block, and stages a row block's d1 once for the run of cells that
// shares it (~3.5 at Reddit scale; split as its fragments load, which
// leaves room for the store's staging), while each cell's d2 window
// streams through a three-stage cp.async ring and is split once a slice;
// a finished block goes out through each warp's staging tile in shared
// memory as 16-byte streaming stores that cover whole 128-byte lines
// (stores straight from the fragments, 32-byte pieces of 16 rows each, were
// slower), and the other CTA on the SM multiplies meanwhile.
//
// sddmm_cells' bf16 compute mode (`pallas_sddmm.py:125 sddmm_cells` with
// compute_dtype=bfloat16: bf16 d1 and d2, exact products, fp32 sums and
// fp32 blocks) has a kernel of its own, sddmm_cells_bf16_kernel. The fp32
// block store bounds it harder still: the inputs halve, the 415 MB of
// blocks do not (at Reddit scale F = 64 ~475 MB in all, 142 us at
// 3.35 TB/s; 13.3 GFLOP, 13 us at bf16's 989 TFLOP/s). So the design keeps
// the store path above (the staging tiles, the streaming stores, two CTAs
// an SM) and makes everything before it cheap enough to hide behind the
// other CTA's stores: products on bf16 mma.sync.m16n8k16, one pass per 16
// features (TF32 m16n8k8 on widened values would take two); fragments by
// ldmatrix (d1's rows are A's rows and d2's rows B's columns, both
// k-contiguous, so no .trans),
// from rows padded to 64 + 8 bf16 (144 bytes, an odd multiple of 16:
// ldmatrix's 8 rows on distinct banks); a step is one cell's 64-feature
// slice (one step a cell at F <= 64, a barrier a cell, not four), d2
// through a two-stage cp.async ring and d1 into the other of two buffers
// with the same step's copies where its row block changes. (A ring three
// steps deep, two cells ahead, ran no faster on an H100: what the loads
// cost beside the stores is their traffic, not their wait.) Ragged widths
// keep 16-byte copies: 128 rows of F bf16 are 256 F bytes, so a row block
// starts on a 16-byte boundary whatever F is; F = 41's rows (82 bytes) are
// copied as the aligned 16-byte pieces that cover them and shifted into
// place in shared memory (`repack_tile`), k zero-padded to a multiple of
// 16 (48). Only a base pointer off 16 bytes takes element copies (4-byte
// cp.async where it allows, else loads).
//
// Offsets indexed by cell * 16384 or by row * F are 64-bit: at Reddit
// scale the cell array holds ~1.04e8 floats.

#include <type_traits>

#include "common.cuh"

using namespace dg;

namespace {

constexpr int kR = 128;       // cell rows (row block)
constexpr int kC = 128;       // cell columns (column window)
constexpr int kCell = kR * kC;
constexpr int kK = 32;        // contraction slice staged per step
constexpr int kFT = 64;       // output features per CTA (SpMM)
constexpr int kStages = 3;    // depth of the SpMM's cp.async ring
constexpr int kThreads = 256;

// How the SpMM stages its B slices (window rows in0 .. in0 + kK, features
// f0 .. f0 + kFT): kBRows, 16-byte copies per row, when rows start on
// 16-byte boundaries; kBFlat, when F <= kFT but rows do not (F = 41 in
// fp32): the slice's rows lie back to back in memory from a 16-byte
// boundary (in0 is a multiple of 32), so it is copied as one run of 16-byte
// chunks and read at row stride F; kBElem otherwise, element by element.
enum BMode : int { kBRows, kBFlat, kBElem };

// Stages the B slice of one step, window rows in0 .. in0 + KK and
// features f0 .. f0 + kFT, at row stride `sb` (kBRows, kBElem) or as it
// lies (kBFlat: row stride F), zero past the matrix.
template <typename T, int BMODE, int KK>
__device__ __forceinline__ void stage_b(T* bs, int sb, const T* b,
                                        int64_t in0, int in_rows, int feat,
                                        int f0, int tid) {
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte copy
  if constexpr (BMODE == kBRows) {
    constexpr int qb = kFT / kE;
#pragma unroll
    for (int it = 0; it < KK * qb / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int k = e / qb, f = (e % qb) * kE;
      const int64_t row = in0 + k;
      const int n = row < in_rows ? max(min(kE, feat - f0 - f), 0) : 0;
      cp_async16(bs + k * sb + f, n ? b + row * feat + f0 + f : b,
                 n * static_cast<int>(sizeof(T)));
    }
  } else if constexpr (BMODE == kBFlat) {
    const int64_t e0 = in0 * feat;  // 16-byte aligned: in0 % 32 == 0
    const int64_t e1 = (in0 + KK < in_rows ? in0 + KK : in_rows) * feat;
    for (int q = tid; q < (KK * feat + kE - 1) / kE; q += kThreads) {
      const int64_t at = e0 + static_cast<int64_t>(q) * kE;
      const int64_t left = e1 - at;
      const int n = left <= 0 ? 0 : left >= kE ? kE : static_cast<int>(left);
      cp_async16(bs + q * kE, n ? b + at : b,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
#pragma unroll
    for (int it = 0; it < KK * kFT / kThreads; ++it) {
      const int e = tid + it * kThreads;
      const int k = e / kFT, f = e % kFT;
      const int64_t row = in0 + k;
      const bool ok = row < in_rows && f0 + f < feat;
      cp_async_elem(bs + k * sb + f, ok ? b + row * feat + f0 + f : b, ok);
    }
  }
}

// Dynamic shared memory of dense_cells_kernel<T, TRANSPOSE>: a ring of A
// slices (forward: cell rows [kR][kK + 4]; transpose: cell rows k0 ..
// k0 + kK, [kK][kC + 8]) and B slices ([kK][kFT + 8] window rows), and the
// TF32 remainders of the step in use (split_tile). The pads keep rows
// 16-byte aligned and the fragment loads on 32 distinct banks.
template <typename T, bool TRANSPOSE>
struct CellsSmem {
  static constexpr int kSA = TRANSPOSE ? kC + 8 : kK + 4;
  static constexpr int kABytes = (TRANSPOSE ? kK : kR) * kSA * 4;
  static constexpr int kSB = kFT + 8;
  static constexpr int kBBytes = kK * kSB * sizeof(T);
  // one step's remainders: of the A slice, and of an fp32 B slice
  static constexpr int kSmall = kABytes + (sizeof(T) == 4 ? kBBytes : 0);
  static constexpr int kBytes = kStages * (kABytes + kBBytes) + kSmall;
};

// One CTA per (output block, 64-feature tile). Forward: output block = row
// block, A = cell [R, C], B rows = column window. Transpose: output block =
// column window, A = cellᵀ [C, R], B rows = row block. order[p] (or p when
// NULL) is the p-th cell of the block runs blk_ptr delimits; win[cell] is
// the cell's B block.
template <typename T, bool TRANSPOSE, int BMODE>
__global__ void __launch_bounds__(kThreads, 2)
    dense_cells_kernel(const float* __restrict__ cells,
                       const int* __restrict__ blk_ptr,
                       const int* __restrict__ order,
                       const int* __restrict__ win, const T* __restrict__ b,
                       float* __restrict__ out, int out_rows, int in_rows,
                       int feat) {
  using L = CellsSmem<T, TRANSPOSE>;
  constexpr bool kSplitB = sizeof(T) == 4;  // a bf16 B is exact in TF32
  constexpr int kModeB = kSplitB ? kPreSplit : kExact;
  constexpr int kSlices = kC / kK;          // k slices per cell
  extern __shared__ __align__(16) unsigned char smem[];
  float* const ring_a = reinterpret_cast<float*>(smem);
  T* const ring_b = reinterpret_cast<T*>(smem + kStages * L::kABytes);
  float* const small_a =
      reinterpret_cast<float*>(smem + kStages * (L::kABytes + L::kBBytes));
  float* const small_b = small_a + L::kABytes / 4;
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows 32 wm, cols 32 wn
  const int p0 = blk_ptr[blk];
  const int nsteps = (blk_ptr[blk + 1] - p0) * kSlices;
  const int ldb = BMODE == kBFlat ? feat : L::kSB;  // B's row stride in smem

  // step s: cell p0 + s / kSlices, contraction k0 .. k0 + kK
  auto issue = [&](int s) {
    const int p = p0 + s / kSlices;
    const int k0 = (s % kSlices) * kK;
    const int c = order != nullptr ? order[p] : p;
    const float* cell = cells + static_cast<int64_t>(c) * kCell;
    const int64_t in0 = static_cast<int64_t>(win[c]) * kC + k0;
    float* as = ring_a + (s % kStages) * (L::kABytes / 4);
    T* bs =
        ring_b + (s % kStages) * (L::kBBytes / static_cast<int>(sizeof(T)));
    // the A slice: 128 x 32 floats, 1024 copies of 16 bytes
#pragma unroll
    for (int it = 0; it < kR * kK / 4 / kThreads; ++it) {
      const int e = tid + it * kThreads;
      if (!TRANSPOSE) {
        const int r = e / (kK / 4), q = (e % (kK / 4)) * 4;
        cp_async16(as + r * L::kSA + q, cell + r * kC + k0 + q, 16);
      } else {
        const int k = e / (kC / 4), q = (e % (kC / 4)) * 4;
        cp_async16(as + k * L::kSA + q, cell + (k0 + k) * kC + q, 16);
      }
    }
    // the B slice, zero past the matrix
    stage_b<T, BMODE, kK>(bs, L::kSB, b, in0, in_rows, feat, f0, tid);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

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

    float* as = ring_a + (s % kStages) * (L::kABytes / 4);
    T* bs =
        ring_b + (s % kStages) * (L::kBBytes / static_cast<int>(sizeof(T)));
    // each value split once, not in each of the 2 (A) or 4 (B) warps that
    // load it; a flat B slice is split whole (the words past its rows feed
    // only output columns past F)
    split_tile(as, small_a, TRANSPOSE ? kK : kR, TRANSPOSE ? kC : kK, L::kSA,
               tid, kThreads);
    if constexpr (kSplitB) {
      if constexpr (BMODE == kBFlat)
        split_tile(bs, small_b, 1, kK * L::kSB, 0, tid, kThreads);
      else
        split_tile(bs, small_b, kK, kFT, L::kSB, tid, kThreads);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; kk += 8) {
      Frag<4> a[2];
      Frag<2> bf[4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 32 * wm + 16 * mt;
        if (!TRANSPOSE) {
          const int at = r * L::kSA + kk;
          load_a<kPreSplit>(a[mt], as + at, small_a + at, L::kSA, 1, lane);
        } else {
          const int at = kk * L::kSA + r;
          load_a<kPreSplit>(a[mt], as + at, small_a + at, 1, L::kSA, lane);
        }
      }
      // every n-tile, unconditionally: B is zero past F (or, flat, feeds
      // only columns past F), and a product under a branch the compiler
      // cannot prove uniform costs a warp barrier each
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int at = kk * ldb + wn * 32 + nt * 8;
        load_b<kModeB>(bf[nt], bs + at, small_b + at, ldb, lane);
      }
      mma_tiles<true, kSplitB>(acc, a, bf, 2, 4);
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = static_cast<int64_t>(blk) * kR + 32 * wm +
                            16 * mt + g + 8 * (i >> 1);
        const int f = f0 + wn * 32 + nt * 8 + 2 * t + (i & 1);
        if (row < out_rows && f < feat) out[row * feat + f] = acc[mt][nt][i];
      }
}

// --- spmm_dense_cells, bf16 compute mode -------------------------------------

constexpr int kKB = 64;  // contraction slice staged per step (bf16 mode)

// A warp's fragments of mma.m16n8k16 (bf16, row.col) through ldmatrix: four
// 8 x 8 matrices of 16-bit values, lane l giving the address of row l % 8
// of matrix l / 8; with .trans each matrix arrives transposed.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += a · b, bf16 products (exact) summed in fp32. Fragments (lane = 4 g
// + t; two bf16 a register, the lower k in the low half): A [16 x 16]:
// a0 (g, 2t..), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..);
// B [16 x 8]: b0 (2t.., g), b1 (2t + 8.., g); C as in m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values as one fragment register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Dynamic shared memory of dense_cells_bf16_kernel<TRANSPOSE>: a ring of
// A slices (forward: cell rows [kR][kKB + 8]; transpose: cell rows k0 ..
// k0 + kKB, [kKB][kC + 8]) and B slices ([kKB][kFT + 8]), bf16. Each row
// is 16-byte aligned and 4 banks from the next (see the file's comment).
template <bool TRANSPOSE>
struct CellsBf16Smem {
  static constexpr int kSA = TRANSPOSE ? kC + 8 : kKB + 8;
  static constexpr int kABytes = (TRANSPOSE ? kKB : kR) * kSA * 2;
  static constexpr int kSB = kFT + 8;
  static constexpr int kBBytes = kKB * kSB * 2;
  static constexpr int kBytes = kStages * (kABytes + kBBytes);
};

// dense_cells_kernel's work in the bf16 compute mode: bf16 cells, a bf16
// B, one mma.m16n8k16 pass a product; the same CTAs, ring and output.
template <bool TRANSPOSE, int BMODE>
__global__ void __launch_bounds__(kThreads, 2)
    dense_cells_bf16_kernel(const __nv_bfloat16* __restrict__ cells,
                            const int* __restrict__ blk_ptr,
                            const int* __restrict__ order,
                            const int* __restrict__ win,
                            const __nv_bfloat16* __restrict__ b,
                            float* __restrict__ out, int out_rows,
                            int in_rows, int feat) {
  using L = CellsBf16Smem<TRANSPOSE>;
  using bf16 = __nv_bfloat16;
  constexpr int kSlices = kC / kKB;  // k slices per cell
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const ring_a = reinterpret_cast<bf16*>(smem);
  bf16* const ring_b = reinterpret_cast<bf16*>(smem + kStages * L::kABytes);
  const int blk = blockIdx.x;
  const int f0 = blockIdx.y * kFT;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows 32 wm, cols 32 wn
  const int p0 = blk_ptr[blk];
  const int nsteps = (blk_ptr[blk + 1] - p0) * kSlices;
  const int ldb = BMODE == kBFlat ? feat : L::kSB;  // B's row stride in smem

  // step s: cell p0 + s / kSlices, contraction k0 .. k0 + kKB
  auto issue = [&](int s) {
    const int p = p0 + s / kSlices;
    const int k0 = (s % kSlices) * kKB;
    const int c = order != nullptr ? order[p] : p;
    const bf16* cell = cells + static_cast<int64_t>(c) * kCell;
    const int64_t in0 = static_cast<int64_t>(win[c]) * kC + k0;
    bf16* as = ring_a + (s % kStages) * (L::kABytes / 2);
    bf16* bs = ring_b + (s % kStages) * (L::kBBytes / 2);
    // the A slice: 128 x 64 values, 1024 copies of 16 bytes
#pragma unroll
    for (int it = 0; it < kR * kKB / 8 / kThreads; ++it) {
      const int e = tid + it * kThreads;
      if (!TRANSPOSE) {
        const int r = e / (kKB / 8), q = (e % (kKB / 8)) * 8;
        cp_async16(as + r * L::kSA + q, cell + r * kC + k0 + q, 16);
      } else {
        const int k = e / (kC / 8), q = (e % (kC / 8)) * 8;
        cp_async16(as + k * L::kSA + q, cell + (k0 + k) * kC + q, 16);
      }
    }
    stage_b<bf16, BMODE, kKB>(bs, L::kSB, b, in0, in_rows, feat, f0, tid);
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  const int g = lane >> 2, t = lane & 3;
  const int li = lane >> 3, lj = lane & 7;  // lane's matrix, row in it
  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_async_commit();

    const bf16* as = ring_a + (s % kStages) * (L::kABytes / 2);
    const bf16* bs = ring_b + (s % kStages) * (L::kBBytes / 2);
#pragma unroll
    for (int kk = 0; kk < kKB; kk += 16) {
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = 32 * wm + 16 * mt;
        if (!TRANSPOSE) {
          // matrix li: rows r + 8 (li & 1) .., k kk + 8 (li >> 1) ..
          ldmatrix_x4(a[mt], as + (r + (lane & 15)) * L::kSA + kk +
                                 (lane >> 4) * 8);
        } else {
          // A(r, k) = staged[k][r], each matrix transposed on load
          ldmatrix_x4_trans(a[mt], as + (kk + lj + (li >> 1) * 8) * L::kSA +
                                       r + (li & 1) * 8);
        }
      }
      // every n-tile, unconditionally (B is zero past F, or, flat, feeds
      // only columns past F): a product under a branch the compiler cannot
      // prove uniform costs a warp barrier each
      if constexpr (BMODE == kBFlat) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bf16* col = bs + wn * 32 + nt * 8 + g;
          const int k = kk + 2 * t;
          bf[nt][0] = pack_bf16(col[k * ldb], col[(k + 1) * ldb]);
          bf[nt][1] = pack_bf16(col[(k + 8) * ldb], col[(k + 9) * ldb]);
        }
      } else {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // matrices: k kk + 8 (li & 1) .., n-tile 2 np + (li >> 1)
          uint32_t r4[4];
          ldmatrix_x4_trans(r4, bs + (kk + (lane & 15)) * ldb + wn * 32 +
                                    np * 16 + (lane >> 4) * 8);
          bf[2 * np][0] = r4[0];
          bf[2 * np][1] = r4[1];
          bf[2 * np + 1][0] = r4[2];
          bf[2 * np + 1][1] = r4[3];
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], bf[nt]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t row = static_cast<int64_t>(blk) * kR + 32 * wm +
                            16 * mt + g + 8 * (i >> 1);
        const int f = f0 + wn * 32 + nt * 8 + 2 * t + (i & 1);
        if (row < out_rows && f < feat) out[row * feat + f] = acc[mt][nt][i];
      }
}

// --- sddmm_cells ----------------------------------------------------------

constexpr int kSK = 16;       // d2 features staged per step
constexpr int kD1F = 64;      // d1 features resident (a feature chunk)
constexpr int kSddmmStages = 3;

constexpr int kSO = 64 + 8;    // row stride of a warp's staging tile (fp32)

// Dynamic shared memory of sddmm_cells_kernel: the row block's d1 chunk
// [kR][kD1F + pad], as it lies in memory (split as its fragments are
// loaded); a ring of d2 slices [kC][kSK + pad] and the remainders of the
// slice in use; and each warp's staging tile [16][kSO] for the block
// store, all fp32. The pads (16 bytes) keep rows 16-byte aligned and the
// fragment loads on 32 distinct banks; the staging tile's row stride (72,
// 8 banks apart) keeps its 8-byte writes on distinct banks. 112,640
// bytes, two CTAs an SM.
struct SddmmSmem {
  static constexpr int kPad = 4;
  static constexpr int kSA = kD1F + kPad;
  static constexpr int kSB = kSK + kPad;
  static constexpr int kABytes = kR * kSA * 4;
  static constexpr int kBBytes = kC * kSB * 4;
  static constexpr int kSmallB = kABytes + kSddmmStages * kBBytes;
  static constexpr int kStage = kSmallB + kC * kSB * 4;
  static constexpr int kBytes = kStage + kThreads / kWarp * 16 * kSO * 4;
};

// Copies rows r0 .. r0 + rows, features f0 .. f0 + cols (cols a multiple of
// 16) of the row-major [nrows, feat] matrix `src` into `dst` at row stride
// `ld`, zero past nrows or feat: 16-byte copies when VEC16 (rows 16-byte
// aligned), else element by element. The CTA's threads share the copies.
template <typename T, bool VEC16>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int64_t r0, int rows, int nrows,
                                           int feat, int f0, int cols,
                                           int tid) {
  if constexpr (VEC16) {
    constexpr int kE = 16 / sizeof(T);
    const int q = cols / kE;
    for (int e = tid; e < rows * q; e += kThreads) {
      const int r = e / q, c = (e % q) * kE;
      const int64_t row = r0 + r;
      const int n = row < nrows ? max(min(kE, feat - f0 - c), 0) : 0;
      cp_async16(dst + r * ld + c, n ? src + row * feat + f0 + c : src,
                 n * static_cast<int>(sizeof(T)));
    }
  } else {
    for (int e = tid; e < rows * cols; e += kThreads) {
      const int r = e / cols, c = e % cols;
      const int64_t row = r0 + r;
      const bool ok = row < nrows && f0 + c < feat;
      cp_async_elem(dst + r * ld + c, ok ? src + row * feat + f0 + c : src,
                    ok);
    }
  }
}

// A finished [128, 128] block out from the accumulators of sddmm_cells_kernel
// and sddmm_cells_bf16_kernel (a warp's 32 x 64 tile at `o`, rows kC
// apart), 16 rows at a time through the warp's staging tile `st` [16][kSO]:
// a store instruction then covers two rows' 256 contiguous bytes, whole
// 128-byte lines, with the streaming hint.
__device__ __forceinline__ void store_block(const float (&acc)[2][2][4][4],
                                            float* st, float* o, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* c = acc[h][mt][nt];
        const int col = 32 * h + 8 * nt + 2 * t;
        *reinterpret_cast<float2*>(st + g * kSO + col) =
            make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(st + (g + 8) * kSO + col) =
            make_float2(c[2], c[3]);
      }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 2 * i + lane / 16, col = (lane % 16) * 4;
      store_streaming(o + (16 * mt + row) * kC + col,
                      *reinterpret_cast<const float4*>(st + row * kSO + col));
    }
    __syncwarp();
  }
}

// Cells p0 .. p0 + chunk of the plan (sorted by row block): per cell p the
// block out[p] = d1[rb[p] * 128 : +128] @ d2[cw[p] * 128 : +128]ᵀ of fp32
// d1 and d2, on the tensor cores (3xTF32). The CTA keeps the row block's
// d1 (a 64-feature chunk of it) staged while consecutive cells share it,
// and streams each cell's d2 window in 16-feature slices through a
// cp.async ring. 8 warps, 4 x 2, each a 32 x 64 tile of the block (two
// halves of 4 n-tiles) in registers; a finished block goes out through the
// warps' staging tiles.
template <bool VEC16>
__global__ void __launch_bounds__(kThreads, 2)
    sddmm_cells_kernel(const int* __restrict__ cell_rb,
                       const int* __restrict__ cell_cw,
                       const float* __restrict__ d1,
                       const float* __restrict__ d2,
                       float* __restrict__ out, int num_cells, int num_rows,
                       int num_cols, int feat, int chunk) {
  using L = SddmmSmem;
  constexpr int kSlicesPerChunk = kD1F / kSK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* const a_tile = reinterpret_cast<float*>(smem);
  float* const ring = reinterpret_cast<float*>(smem + L::kABytes);
  float* const b_small = reinterpret_cast<float*>(smem + L::kSmallB);
  const int p0 = blockIdx.x * chunk;
  const int slices = (feat + kSK - 1) / kSK;  // per cell
  const int nsteps = (min(p0 + chunk, num_cells) - p0) * slices;
  const int chunks = (feat + kD1F - 1) / kD1F;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 2, wn = warp % 2;  // rows 32 wm, columns 64 wn

  // step s: cell p0 + s / slices, features (s % slices) * kSK + [0, kSK)
  auto issue = [&](int s) {
    const int p = p0 + s / slices;
    stage_rows<float, VEC16>(ring + (s % kSddmmStages) * (L::kBBytes / 4),
                             L::kSB, d2,
                             static_cast<int64_t>(cell_cw[p]) * kC, kC,
                             num_cols, feat, (s % slices) * kSK, kSK, tid);
  };

  float acc[2][2][4][4];  // [half][m-tile][n-tile][fragment]
  auto zero = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] = 0.f;
  };
  zero();

#pragma unroll
  for (int s = 0; s < kSddmmStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_async_commit();
  }
  int64_t staged = -1;  // row block * chunks + feature chunk of the d1 tile
  for (int s = 0; s < nsteps; ++s) {
    const int p = p0 + s / slices, j = s % slices;
    const int fc = j / kSlicesPerChunk;
    const int64_t key = static_cast<int64_t>(cell_rb[p]) * chunks + fc;
    if (key != staged) {  // uniform: a new row block or feature chunk
      __syncthreads();    // every warp is done with the staged tile
      const int f0 = fc * kD1F;
      const int cols = min(kD1F, (feat - f0 + kSK - 1) / kSK * kSK);
      stage_rows<float, VEC16>(a_tile, L::kSA, d1,
                               static_cast<int64_t>(cell_rb[p]) * kR, kR,
                               num_rows, feat, f0, cols, tid);
      cp_async_commit();
      cp_async_wait<0>();
      staged = key;  // visible to every warp after the barrier below
    }
    cp_async_wait<kSddmmStages - 2>();
    __syncthreads();  // step s landed; step s - 1's stage is free
    if (s + kSddmmStages - 1 < nsteps) issue(s + kSddmmStages - 1);
    cp_async_commit();

    float* bs = ring + (s % kSddmmStages) * (L::kBBytes / 4);
    split_tile(bs, b_small, kC, kSK, L::kSB, tid, kThreads);
    __syncthreads();
    const int ka = (j % kSlicesPerChunk) * kSK;
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 8) {
      Frag<4> a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int at = (32 * wm + 16 * mt) * L::kSA + ka + kk;
        load_a<kSplitOnLoad>(a[mt], a_tile + at, nullptr, L::kSA, 1, lane);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Frag<2> b[4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int at = (64 * wn + 32 * h + 8 * nt) * L::kSB + kk;
          load_b_nk<kPreSplit>(b[nt], bs + at, b_small + at, L::kSB, lane);
        }
        mma_tiles<true, true>(acc[h], a, b, 2, 4);
      }
    }

    if (j == slices - 1) {
      store_block(acc,
                  reinterpret_cast<float*>(smem + L::kStage) +
                      warp * 16 * kSO,
                  out + static_cast<int64_t>(p) * kCell + (32 * wm) * kC +
                      64 * wn,
                  lane);
      zero();
    }
  }
}

// --- sddmm_cells, bf16 compute mode ------------------------------------------

constexpr int kBK = 64;         // features a step: d2's slice, d1's chunk
constexpr int kBS = kBK + 8;    // staged row stride, bf16: 144 bytes
constexpr int kBPieces = kBS / 8;  // 16-byte pieces a staged row holds

// How sddmm_cells_bf16_kernel stages a tile (128 rows, features f0 .. f0 +
// kp) of d1 or d2 into rows of kBS bf16, zero past the matrix and past F:
//   kTileRows, rows on 16-byte boundaries (base aligned, F % 8 == 0):
//     16-byte cp.async copies straight into the rows;
//   kTileFlat, base aligned, F % 8 != 0: the 128 rows lie back to back from
//     a 16-byte boundary (256 F bytes), so each row's features lie in at
//     most 9 aligned 16-byte pieces of the flat matrix; those are copied
//     (16-byte cp.async), and `repack_tile` then shifts each row to its
//     start and zeroes what lies past F;
//   kTilePairs, base 4-byte aligned, F even: 4-byte cp.async copies of two
//     values; kTileElem, otherwise: synchronous 2-byte loads.
enum TileMode : int { kTileRows, kTileFlat, kTilePairs, kTileElem };

template <int MODE>
__device__ __forceinline__ void stage_tile_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t r0, int nrows,
                                                int feat, int f0, int kp,
                                                int tid) {
  if constexpr (MODE == kTileRows) {
    const int q = kp / 8;
    for (int e = tid; e < kR * q; e += kThreads) {
      const int r = e / q, c = (e % q) * 8;
      const int64_t row = r0 + r;
      const bool ok = row < nrows && f0 + c < feat;  // a piece is all or none
      cp_async16(dst + r * kBS + c, ok ? src + row * feat + f0 + c : src,
                 ok ? 16 : 0);
    }
  } else if constexpr (MODE == kTileFlat) {
    const int64_t end = static_cast<int64_t>(nrows) * feat;
    const int cols = min(kBK, feat - f0);
    for (int e = tid; e < kR * kBPieces; e += kThreads) {
      const int r = e / kBPieces, i = e % kBPieces;
      const int64_t first = (r0 + r) * feat + f0;  // the row's first value
      if (i * 8 >= static_cast<int>(first % 8) + cols) continue;  // unused
      const int64_t at = first / 8 * 8 + 8 * i;
      const int64_t left = r0 + r < nrows ? end - at : 0;
      const int n = left <= 0 ? 0 : left >= 8 ? 16 : 2 * static_cast<int>(left);
      cp_async16(dst + r * kBS + 8 * i, n ? src + at : src, n);
    }
  } else if constexpr (MODE == kTilePairs) {
    const int q = kp / 2;
    for (int e = tid; e < kR * q; e += kThreads) {
      const int r = e / q, k = (e % q) * 2;
      const int64_t row = r0 + r;
      const bool ok = row < nrows && f0 + k < feat;  // F even: both or none
      cp_async4(dst + r * kBS + k, ok ? src + row * feat + f0 + k : src,
                ok ? 4 : 0);
    }
  } else {
    for (int e = tid; e < kR * kp; e += kThreads) {
      const int r = e / kp, k = e % kp;
      const int64_t row = r0 + r;
      const bool ok = row < nrows && f0 + k < feat;
      cp_async_elem(dst + r * kBS + k, ok ? src + row * feat + f0 + k : src,
                    ok);
    }
  }
}

// kTileFlat's second half, in place: row r of `t` holds its features from
// value (row * F + f0) % 8 on; each 16-byte unit of the first kp values is
// rebuilt from the five words that cover it (a funnel shift by 0 or 16
// bits), values past F or rows past nrows as real zeros (0 x NaN is NaN).
// The shifted rows overlap their sources: every thread reads its units,
// then a barrier, then writes them. The caller synchronises after.
__device__ __forceinline__ void repack_tile(__nv_bfloat16* t, int64_t r0,
                                            int nrows, int feat, int f0,
                                            int kp, int tid) {
  constexpr int kUnits = kR * kBK / 8 / kThreads;  // at most, a thread
  const int q = kp / 8, cols = min(kBK, feat - f0);
  const uint32_t* t32 = reinterpret_cast<const uint32_t*>(t);
  uint32_t w[kUnits][4];
#pragma unroll
  for (int it = 0; it < kUnits; ++it) {
    const int e = tid + it * kThreads;
    if (e >= kR * q) break;
    const int r = e / q, u = e % q;
    const int64_t row = r0 + r;
    const int off = static_cast<int>((row * feat + f0) % 8) + 8 * u;
    const uint32_t* s = t32 + r * (kBS / 2) + off / 2;
    const int sh = (off & 1) * 16;
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) x[i] = s[i];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = 8 * u + 2 * i;
      const uint32_t keep = row >= nrows ? 0u
                            : k + 1 < cols ? 0xffffffffu
                            : k < cols     ? 0x0000ffffu
                                           : 0u;
      w[it][i] = __funnelshift_r(x[i], x[i + 1], sh) & keep;
    }
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kUnits; ++it) {
    const int e = tid + it * kThreads;
    if (e >= kR * q) break;
    *reinterpret_cast<uint4*>(t + (e / q) * kBS + (e % q) * 8) =
        make_uint4(w[it][0], w[it][1], w[it][2], w[it][3]);
  }
}

// Dynamic shared memory of sddmm_cells_bf16_kernel: two d1 tiles (the one
// in use and the next row block's, loaded a step ahead), a two-stage ring
// of d2 tiles, [kR][kBS] bf16 each, and each warp's staging tile for the
// store: 110,592 bytes, two CTAs an SM.
struct SddmmBf16Smem {
  static constexpr int kTile = kR * kBS;  // values
  static constexpr int kStage = 4 * kTile * 2;
  static constexpr int kBytes = kStage + kThreads / kWarp * 16 * kSO * 4;
};

// sddmm_cells_kernel's work in the bf16 compute mode (bf16 d1 and d2): per
// cell p of the chunk the fp32 block d1[rb[p] * 128 : +128] @
// d2[cw[p] * 128 : +128]ᵀ. A step is one cell's 64-feature slice; its d2
// tile streams through a two-stage cp.async ring, and d1's tile is loaded
// (into the other of two buffers, with the same step's copies) only where
// the row block or the slice changes. 8 warps, 4 x 2, each a 32 x 64 tile
// of the block in registers, fed by ldmatrix (A = d1's rows, B = d2's rows,
// both k-contiguous, so neither is transposed) into bf16 mma.m16n8k16.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    sddmm_cells_bf16_kernel(const int* __restrict__ cell_rb,
                            const int* __restrict__ cell_cw,
                            const __nv_bfloat16* __restrict__ d1,
                            const __nv_bfloat16* __restrict__ d2,
                            float* __restrict__ out, int num_cells,
                            int num_rows, int num_cols, int feat, int chunk) {
  using L = SddmmBf16Smem;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const a_buf = reinterpret_cast<bf16*>(smem);
  bf16* const b_ring = a_buf + 2 * L::kTile;
  const int p0 = blockIdx.x * chunk;
  const int slices = (feat + kBK - 1) / kBK;  // per cell
  const int nsteps = (min(p0 + chunk, num_cells) - p0) * slices;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int wm = warp / 2, wn = warp % 2;  // rows 32 wm, columns 64 wn

  // step s: cell p0 + s / slices, features (s % slices) * kBK + [0, kp)
  auto new_a = [&](int s) {  // uniform: d1's row block or slice changes
    return s == 0 || slices > 1 ||
           cell_rb[p0 + s / slices] != cell_rb[p0 + (s - 1) / slices];
  };
  auto kp_of = [&](int s) {
    return (min(kBK, feat - (s % slices) * kBK) + 15) / 16 * 16;
  };
  int a_issued = 1;  // the d1 buffer of the latest load
  auto issue = [&](int s) {
    const int p = p0 + s / slices, f0 = (s % slices) * kBK, kp = kp_of(s);
    if (new_a(s)) {
      a_issued ^= 1;
      stage_tile_bf16<MODE>(a_buf + a_issued * L::kTile, d1,
                            static_cast<int64_t>(cell_rb[p]) * kR, num_rows,
                            feat, f0, kp, tid);
    }
    stage_tile_bf16<MODE>(b_ring + (s & 1) * L::kTile, d2,
                          static_cast<int64_t>(cell_cw[p]) * kC, num_cols,
                          feat, f0, kp, tid);
  };

  float acc[2][2][4][4];  // [half][m-tile][n-tile][fragment]
  auto zero = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][mt][nt][i] = 0.f;
  };
  zero();

  if (nsteps > 0) issue(0);
  cp_async_commit();
  const int li = lane >> 3, lj = lane & 7;  // lane's matrix, row in it
  int a_cur = 1;
  for (int s = 0; s < nsteps; ++s) {
    const int p = p0 + s / slices, j = s % slices, kp = kp_of(s);
    const bool fresh = new_a(s);
    if (fresh) a_cur ^= 1;
    cp_async_wait<0>();
    __syncthreads();  // step s landed; step s - 1's tiles are free
    if (s + 1 < nsteps) issue(s + 1);
    cp_async_commit();

    bf16* as = a_buf + a_cur * L::kTile;
    bf16* bs = b_ring + (s & 1) * L::kTile;
    if constexpr (MODE == kTileFlat) {
      repack_tile(bs, static_cast<int64_t>(cell_cw[p]) * kC, num_cols, feat,
                  j * kBK, kp, tid);
      if (fresh)
        repack_tile(as, static_cast<int64_t>(cell_rb[p]) * kR, num_rows,
                    feat, j * kBK, kp, tid);
      __syncthreads();
    }
    // k steps of 16 up to kp, which depends on the step alone: the
    // products sit under no thread-dependent branch
    for (int kk = 0; kk < kp; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        // matrices: rows 32 wm + 16 mt + 8 (li & 1) .., k kk + 8 (li >> 1)
        ldmatrix_x4(a[mt], as + (32 * wm + 16 * mt + (lane & 15)) * kBS +
                               kk + (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4][2];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          // matrices: n-tile 2 np + (li >> 1), k kk + 8 (li & 1); d2's
          // rows are B's columns, so b0 and b1 load untransposed
          uint32_t r4[4];
          ldmatrix_x4(r4, bs + (64 * wn + 32 * h + 16 * np + 8 * (li >> 1) +
                                lj) * kBS +
                              kk + 8 * (li & 1));
          b[2 * np][0] = r4[0];
          b[2 * np][1] = r4[1];
          b[2 * np + 1][0] = r4[2];
          b[2 * np + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(acc[h][mt][nt], a[mt], b[nt]);
      }
    }

    if (j == slices - 1) {
      store_block(acc,
                  reinterpret_cast<float*>(smem + L::kStage) +
                      warp * 16 * kSO,
                  out + static_cast<int64_t>(p) * kCell + (32 * wm) * kC +
                      64 * wn,
                  lane);
      zero();
    }
  }
}

template <typename T, bool TRANSPOSE, int BMODE>
int launch_cells_variant(const float* cells, const int* blk_ptr,
                         const int* order, const int* win, const void* b,
                         float* out, int num_blocks, int out_rows,
                         int in_rows, int feat, cudaStream_t s) {
  constexpr int smem = CellsSmem<T, TRANSPOSE>::kBytes;
  auto kernel = dense_cells_kernel<T, TRANSPOSE, BMODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (feat + kFT - 1) / kFT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, s>>>(cells, blk_ptr, order, win,
                                      static_cast<const T*>(b), out,
                                      out_rows, in_rows, feat);
  return cudaGetLastError();
}

template <typename T, int BMODE>
int launch_cells_mode(const float* cells, const int* blk_ptr,
                      const int* order, const int* win, const void* b,
                      float* out, int num_blocks, int out_rows, int in_rows,
                      int feat, int transpose, cudaStream_t s) {
  if (transpose)
    return launch_cells_variant<T, true, BMODE>(
        cells, blk_ptr, order, win, b, out, num_blocks, out_rows, in_rows,
        feat, s);
  return launch_cells_variant<T, false, BMODE>(cells, blk_ptr, order, win, b,
                                               out, num_blocks, out_rows,
                                               in_rows, feat, s);
}

template <typename T>
int launch_cells(int device, const float* cells, const int* blk_ptr,
                 const int* order, const int* win, const void* b, float* out,
                 int num_blocks, int out_rows, int in_rows, int feat,
                 int transpose, void* stream) {
  if (num_blocks <= 0 || feat <= 0 || out_rows <= 0 || in_rows <= 0 ||
      !aligned(cells, 16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = aligned(b, 16);
  if (b16 && (feat * static_cast<int>(sizeof(T))) % 16 == 0)
    return launch_cells_mode<T, kBRows>(cells, blk_ptr, order, win, b, out,
                                        num_blocks, out_rows, in_rows, feat,
                                        transpose, s);
  if (b16 && feat <= kFT)
    return launch_cells_mode<T, kBFlat>(cells, blk_ptr, order, win, b, out,
                                        num_blocks, out_rows, in_rows, feat,
                                        transpose, s);
  return launch_cells_mode<T, kBElem>(cells, blk_ptr, order, win, b, out,
                                      num_blocks, out_rows, in_rows, feat,
                                      transpose, s);
}

template <bool TRANSPOSE, int BMODE>
int launch_cells_bf16_variant(const void* cells, const int* blk_ptr,
                              const int* order, const int* win, const void* b,
                              float* out, int num_blocks, int out_rows,
                              int in_rows, int feat, cudaStream_t s) {
  constexpr int smem = CellsBf16Smem<TRANSPOSE>::kBytes;
  auto kernel = dense_cells_bf16_kernel<TRANSPOSE, BMODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(num_blocks, (feat + kFT - 1) / kFT);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(cells), blk_ptr, order, win,
      static_cast<const __nv_bfloat16*>(b), out, out_rows, in_rows, feat);
  return cudaGetLastError();
}

template <int BMODE>
int launch_cells_bf16_mode(const void* cells, const int* blk_ptr,
                           const int* order, const int* win, const void* b,
                           float* out, int num_blocks, int out_rows,
                           int in_rows, int feat, int transpose,
                           cudaStream_t s) {
  if (transpose)
    return launch_cells_bf16_variant<true, BMODE>(
        cells, blk_ptr, order, win, b, out, num_blocks, out_rows, in_rows,
        feat, s);
  return launch_cells_bf16_variant<false, BMODE>(
      cells, blk_ptr, order, win, b, out, num_blocks, out_rows, in_rows,
      feat, s);
}

// The bf16 mode's launch: B's staging chosen as in launch_cells.
int launch_cells_bf16(int device, const void* cells, const int* blk_ptr,
                      const int* order, const int* win, const void* b,
                      float* out, int num_blocks, int out_rows, int in_rows,
                      int feat, int transpose, void* stream) {
  if (num_blocks <= 0 || feat <= 0 || out_rows <= 0 || in_rows <= 0 ||
      !aligned(cells, 16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b16 = aligned(b, 16);
  if (b16 && feat % 8 == 0)
    return launch_cells_bf16_mode<kBRows>(cells, blk_ptr, order, win, b, out,
                                          num_blocks, out_rows, in_rows, feat,
                                          transpose, s);
  if (b16 && feat <= kFT)
    return launch_cells_bf16_mode<kBFlat>(cells, blk_ptr, order, win, b, out,
                                          num_blocks, out_rows, in_rows, feat,
                                          transpose, s);
  return launch_cells_bf16_mode<kBElem>(cells, blk_ptr, order, win, b, out,
                                        num_blocks, out_rows, in_rows, feat,
                                        transpose, s);
}

template <bool VEC16>
int launch_sddmm_variant(const int* cell_rb, const int* cell_cw,
                         const void* d1, const void* d2, float* out,
                         int num_cells, int num_rows, int num_cols, int feat,
                         int chunk, cudaStream_t s) {
  constexpr int smem = SddmmSmem::kBytes;
  auto kernel = sddmm_cells_kernel<VEC16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(num_cells + chunk - 1) / chunk, kThreads, smem, s>>>(
      cell_rb, cell_cw, static_cast<const float*>(d1),
      static_cast<const float*>(d2), out, num_cells, num_rows, num_cols, feat,
      chunk);
  return cudaGetLastError();
}

int launch_sddmm(int device, const int* cell_rb, const int* cell_cw,
                 const void* d1, const void* d2, float* out, int num_cells,
                 int num_rows, int num_cols, int feat, int chunk,
                 void* stream) {
  if (num_cells <= 0 || feat <= 0 || chunk <= 0 || !aligned(out, 16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned(d1, 16) && aligned(d2, 16) && feat % 4 == 0)
    return launch_sddmm_variant<true>(cell_rb, cell_cw, d1, d2, out,
                                      num_cells, num_rows, num_cols, feat,
                                      chunk, s);
  return launch_sddmm_variant<false>(cell_rb, cell_cw, d1, d2, out,
                                     num_cells, num_rows, num_cols, feat,
                                     chunk, s);
}

template <int MODE>
int launch_sddmm_bf16_variant(const int* cell_rb, const int* cell_cw,
                              const void* d1, const void* d2, float* out,
                              int num_cells, int num_rows, int num_cols,
                              int feat, int chunk, cudaStream_t s) {
  constexpr int smem = SddmmBf16Smem::kBytes;
  auto kernel = sddmm_cells_bf16_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(num_cells + chunk - 1) / chunk, kThreads, smem, s>>>(
      cell_rb, cell_cw, static_cast<const __nv_bfloat16*>(d1),
      static_cast<const __nv_bfloat16*>(d2), out, num_cells, num_rows,
      num_cols, feat, chunk);
  return cudaGetLastError();
}

// The bf16 mode's launch: the staging (TileMode) the operands' pointers
// and F allow, the same for d1 and d2.
int launch_sddmm_bf16(int device, const int* cell_rb, const int* cell_cw,
                      const void* d1, const void* d2, float* out,
                      int num_cells, int num_rows, int num_cols, int feat,
                      int chunk, void* stream) {
  if (num_cells <= 0 || feat <= 0 || chunk <= 0 || !aligned(out, 16))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto mode) {
    return launch_sddmm_bf16_variant<decltype(mode)::value>(
        cell_rb, cell_cw, d1, d2, out, num_cells, num_rows, num_cols, feat,
        chunk, s);
  };
  if (aligned(d1, 16) && aligned(d2, 16))
    return feat % 8 == 0
               ? launch(std::integral_constant<int, kTileRows>())
               : launch(std::integral_constant<int, kTileFlat>());
  if (aligned(d1, 4) && aligned(d2, 4) && feat % 2 == 0)
    return launch(std::integral_constant<int, kTilePairs>());
  return launch(std::integral_constant<int, kTileElem>());
}

}  // namespace

extern "C" {

// out [out_rows, F] fp32, every row written: for each output block
// (num_blocks of 128 rows) the sum over its cells p in [blk_ptr[blk],
// blk_ptr[blk+1]) of A(cell) @ B[win[cell] * 128 : +128], cell = order[p]
// (order NULL: p), A = the cell [128, 128] or, with transpose != 0, its
// transpose; B [in_rows, F], rows past in_rows counting as 0. The cells in
// `cells_dtype`: fp32 (3xTF32) with B in `dtype` (0 fp32, 1 bf16), or
// bf16 (the bf16 compute mode, dense_cells_bf16_kernel) with a bf16 B.
// Returns a cudaError_t (cudaErrorInvalidValue for bf16 cells with an
// fp32 B).
int dg_spmm_dense_cells(int cells_dtype, int dtype, int device,
                        const void* cells, const int* blk_ptr,
                        const int* order, const int* win, const void* b,
                        float* out, int num_blocks, int out_rows, int in_rows,
                        int feat, int transpose, void* stream) {
  if (cells_dtype == kBFloat16)
    return dtype == kBFloat16
               ? launch_cells_bf16(device, cells, blk_ptr, order, win, b, out,
                                   num_blocks, out_rows, in_rows, feat,
                                   transpose, stream)
               : cudaErrorInvalidValue;
  if (cells_dtype != kFloat32) return cudaErrorInvalidValue;
  const float* fcells = static_cast<const float*>(cells);
  if (dtype == kFloat32)
    return launch_cells<float>(device, fcells, blk_ptr, order, win, b, out,
                               num_blocks, out_rows, in_rows, feat,
                               transpose, stream);
  if (dtype == kBFloat16)
    return launch_cells<__nv_bfloat16>(device, fcells, blk_ptr, order, win,
                                       b, out, num_blocks, out_rows, in_rows,
                                       feat, transpose, stream);
  return cudaErrorInvalidValue;
}

// out [num_cells * 128 * 128] fp32: per cell t the block
// d1[cell_rb[t] * 128 + r] . d2[cell_cw[t] * 128 + c] for r, c < 128, over
// F features of d1 [num_rows, F] and d2 [num_cols, F] in `dtype` (fp32:
// sddmm_cells_kernel on 3xTF32; bf16: sddmm_cells_bf16_kernel); rows
// past num_rows / num_cols count as 0. A CTA takes `chunk` consecutive
// cells; cells of one row block next to each other share its staged d1
// (any order is right). Returns a cudaError_t.
int dg_sddmm_cells(int dtype, int device, const int* cell_rb,
                   const int* cell_cw, const void* d1, const void* d2,
                   float* out, int num_cells, int num_rows, int num_cols,
                   int feat, int chunk, void* stream) {
  if (dtype == kFloat32)
    return launch_sddmm(device, cell_rb, cell_cw, d1, d2, out, num_cells,
                        num_rows, num_cols, feat, chunk, stream);
  if (dtype == kBFloat16)
    return launch_sddmm_bf16(device, cell_rb, cell_cw, d1, d2, out,
                             num_cells, num_rows, num_cols, feat, chunk,
                             stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
