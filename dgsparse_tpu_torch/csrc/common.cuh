// Helpers shared by the port's CUDA kernels (csrc/*.cu): warp shape, the
// dtype codes of the C interface, fp32 <-> storage-type conversions and
// vectorised loads and stores.

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

}  // namespace dg
