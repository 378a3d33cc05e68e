// Helpers shared by the port's CUDA kernels (csrc/*.cu): warp shape, the
// dtype codes of the C interface, fp32 <-> storage-type conversions,
// vectorised loads and stores, streaming stores, cp.async copies into
// shared memory, and the tensor-core product of `spconv.cu` (spconv_pairs,
// spconv_dw) and `spmm_cells.cu` (mma.sync on TF32, fp32 kept as 3xTF32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dg {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// `dtype` argument of the C entry points (kernels/_launch.py DTYPE_CODE)
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

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// --- cp.async: global -> shared without a register round trip ------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes to `dst`, of which the first `bytes` (0..16) come from `src` and
// the rest are zero; both 16-byte aligned, `src` a valid address even when
// `bytes` is 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes to `dst`, of which the first `bytes` (0 or 4) come from `src`;
// both 4-byte aligned, `src` valid even when `bytes` is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// One element to `dst`: *src where `valid`, else zero. fp32 goes through a
// 4-byte cp.async; a 2-byte bf16 has none, so it is loaded and stored.
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src,
                                              bool valid) {
  cp_async4(dst, src, valid ? 4 : 0);
}
__device__ __forceinline__ void cp_async_elem(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              bool valid) {
  *dst = valid ? *src : __float2bfloat16(0.f);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes to global memory with the streaming hint (.cs: evict first), for
// output written once and not read again by the kernel, so that it does not
// push the inputs out of L2.
__device__ __forceinline__ void store_streaming(float* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// VEC elements to `p` (aligned to their size) with the same hint, as
// 16-byte stores where they are that wide, else as one store.
template <typename T, int VEC>
__device__ __forceinline__ void store_streaming(T* p,
                                                const Packed<T, VEC>& v) {
  constexpr int kBytes = sizeof(Packed<T, VEC>);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i)
      __stcs(reinterpret_cast<int4*>(p) + i,
             reinterpret_cast<const int4*>(&v)[i]);
  } else if constexpr (kBytes == 8) {
    __stcs(reinterpret_cast<int2*>(p), *reinterpret_cast<const int2*>(&v));
  } else if constexpr (kBytes == 4) {
    __stcs(reinterpret_cast<int*>(p), *reinterpret_cast<const int*>(&v));
  } else {
    __stcs(reinterpret_cast<short*>(p), *reinterpret_cast<const short*>(&v));
  }
}

// --- tensor cores: mma.sync.m16n8k8 on TF32 ------------------------------
//
// fp32 parity (the JAX package's Precision.HIGHEST, 1e-5 of the terms'
// absolute sum) survives the tensor cores only as 3xTF32: each fp32 operand
// is split into big = tf32(a) (round to nearest on 10 mantissa bits, ties
// away from zero) and small = a - big (which the tensor core cuts to
// TF32), and a·b is summed as small·big + big·small + big·big in fp32 (the
// small·small term, ~2^-22 of the product, is dropped). A bf16 value is
// exact in TF32 and needs no split, so a product with one bf16 side takes
// two passes and one of two bf16 sides a single exact pass.
// `utils/testing.py::tf32_round` emulates the rounding for the CPU tests.
// big is rounded to nearest, not cut toward zero: a cut is cheaper but
// biased, and over the ~10^5-term sums of a Reddit layer's bias gradient
// the bias broke the step-1 gradient check against the plain versions. A
// split is three instructions (`tf32` two integer ones, then a subtract),
// where cvt.rna twice cost several times that (spconv_dw at enc2 ran
// faster on an H100 without it). Where the products outrun the shared
// memory, a kernel splits each staged value once (`split_tile`); where the
// shared memory is the limit (spconv_dw), each warp splits the values it
// loads into a fragment.
//
// Fragments of mma.m16n8k8 (lane = 4 g + t, g = lane / 4, t = lane % 4):
//   A [16 x 8]: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B [8 x 8]:  b0 (t, g), b1 (t + 4, g);
//   C [16 x 8]: c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//               c3 (g + 8, 2t + 1).

// x rounded to TF32 as cvt.rna.tf32.f32 rounds a finite value (to nearest
// on the top 10 mantissa bits, ties away from zero) in two integer
// instructions, which issue at a higher rate than the conversion: a carry
// into bit 13, then the low 13 bits cleared, as `utils/testing.py::
// tf32_round` does. An infinity stays one; a NaN may come out as an
// infinity or a zero (the carry runs into the sign bit), so `split_tf32`
// keeps it in the remainder.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// How an operand's TF32 parts are had: kExact, the value itself (a bf16
// value, exact in TF32; no remainder); kSplitOnLoad, split as it is loaded
// into a fragment; kPreSplit, split once per staged tile by `split_tile`,
// its big parts in place and its remainders in a tile of the same layout.
enum Split : int { kExact, kSplitOnLoad, kPreSplit };

// x as TF32 operands: big + small ≈ x to ~2^-22. small = x - big is exact
// in fp32 and passed as it is: the tensor core reads a TF32 operand's top
// 19 bits and drops the rest, so small loses at most 2^-11 of itself (up
// to 2^-22 of x, the order of the small·small term already dropped). A
// NaN x leaves a NaN in small, whatever tf32 made of it, so the product
// stays NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// Splits `n` floats at `s` (16-byte aligned, n a multiple of 4; rows of
// `cols` floats `stride` apart, cols a multiple of 4) into their TF32 big
// parts, in place, and their remainders, into `small` at the same offsets.
// The CTA's `nthreads` threads share the work, 4 values each at a time.
__device__ __forceinline__ void split_tile(float* s, float* small, int rows,
                                           int cols, int stride, int tid,
                                           int nthreads) {
  const int q = cols / 4;
  for (int e = tid; e < rows * q; e += nthreads) {
    const int at = (e / q) * stride + (e % q) * 4;
    const float4 v = *reinterpret_cast<const float4*>(s + at);
    uint32_t b[4], r[4];
    split_tf32(v.x, b[0], r[0]);
    split_tf32(v.y, b[1], r[1]);
    split_tf32(v.z, b[2], r[2]);
    split_tf32(v.w, b[3], r[3]);
    *reinterpret_cast<uint4*>(s + at) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(small + at) =
        make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// One operand value at s[i] as TF32 parts, by `MODE` (`small`: the
// remainders of a kPreSplit tile, else unused).
template <int MODE, typename T>
__device__ __forceinline__ void operand(const T* s, const float* small, int i,
                                        uint32_t& big, uint32_t& rem) {
  if (MODE == kSplitOnLoad) {
    split_tf32(to_float(s[i]), big, rem);
  } else if (MODE == kPreSplit) {
    big = __float_as_uint(to_float(s[i]));
    rem = __float_as_uint(small[i]);
  } else {
    big = __float_as_uint(to_float(s[i]));
    rem = 0u;
  }
}

// Not volatile: independent products may be interleaved by the compiler.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An operand fragment: the TF32 parts of its values.
template <int N>
struct Frag {
  uint32_t big[N];
  uint32_t small[N];
};

// The A fragment at (row 0, k 0) of `s`, where A(r, k) = s[r * rs + k * ks]
// (rs = row stride, ks = 1 for a row-major tile; rs = 1 for a tile staged
// k-major, as a transposed operand is), by `MODE`.
template <int MODE, typename T>
__device__ __forceinline__ void load_a(Frag<4>& f, const T* s,
                                       const float* small, int rs, int ks,
                                       int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int at[4] = {g * rs + t * ks, (g + 8) * rs + t * ks,
                     g * rs + (t + 4) * ks, (g + 8) * rs + (t + 4) * ks};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    operand<MODE>(s, small, at[i], f.big[i], f.small[i]);
}

// The A fragment at (row 0, k 0) of a tile staged k-major, A(r, k) =
// s[k * ks + r]: rows of [k][channels] staging read as the transposed
// operand without a copy (spconv_dw: A = xᵀ). With ks = 72 elements,
// fp32 or bf16, no two lanes of a fragment load meet in one bank at
// different words.
template <int MODE, typename T>
__device__ __forceinline__ void load_a_kmajor(Frag<4>& f, const T* s,
                                              const float* small, int ks,
                                              int lane) {
  load_a<MODE>(f, s, small, 1, ks, lane);
}

// The B fragment at (k 0, column 0) of `s`, where B(k, n) = s[k * ks + n].
template <int MODE, typename T>
__device__ __forceinline__ void load_b(Frag<2>& f, const T* s,
                                       const float* small, int ks, int lane) {
  const int g = lane >> 2, t = lane & 3;
  operand<MODE>(s, small, t * ks + g, f.big[0], f.small[0]);
  operand<MODE>(s, small, (t + 4) * ks + g, f.big[1], f.small[1]);
}

// The B fragment at (k 0, column 0) of `s` staged n-major, B(k, n) =
// s[n * ns + k]: the rows of a matrix that enters the product transposed.
template <int MODE, typename T>
__device__ __forceinline__ void load_b_nk(Frag<2>& f, const T* s,
                                          const float* small, int ns,
                                          int lane) {
  const int g = lane >> 2, t = lane & 3;
  operand<MODE>(s, small, g * ns + t, f.big[0], f.small[0]);
  operand<MODE>(s, small, g * ns + t + 4, f.big[1], f.small[1]);
}

// acc[m][n] += a[m] · b[n] for m < m_valid, n < n_valid: the small cross
// terms first, then big·big, each pass over every tile before the next so
// that the products of one pass are independent of each other.
template <bool SPLIT_A, bool SPLIT_B, int M, int N>
__device__ __forceinline__ void mma_tiles(float (&acc)[M][N][4],
                                          const Frag<4> (&a)[M],
                                          const Frag<2> (&b)[N], int m_valid,
                                          int n_valid) {
  if (SPLIT_A) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (m < m_valid && n < n_valid)
          mma_tf32(acc[m][n], a[m].small, b[n].big);
  }
  if (SPLIT_B) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n)
        if (m < m_valid && n < n_valid)
          mma_tf32(acc[m][n], a[m].big, b[n].small);
  }
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (m < m_valid && n < n_valid) mma_tf32(acc[m][n], a[m].big, b[n].big);
}

}  // namespace dg
