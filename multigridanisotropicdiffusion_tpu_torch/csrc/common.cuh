// Shared helpers of the hand-written Hopper kernels.
//
// Storage types: float, __nv_bfloat16 and double.  Loads widen to the
// compute type (float for float and bf16, double for double) and the result
// is rounded once at the store, by the bf16 intrinsics where it applies.
// Every kernel launches on the stream it is given, allocates nothing, and
// its C entry point returns cudaGetLastError() for the Python wrapper to
// check.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mad {

template <typename T>
struct Compute {
  using type = float;
};
template <>
struct Compute<double> {
  using type = double;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ double load(const double* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Operations that round on their own, never contracted into a fused
// multiply-add: kernels that must agree bit for bit with their plain PyTorch
// versions (which round once per op) use them.
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

inline unsigned blocks_for(int64_t n, int per_block) {
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace mad

// Instantiates MACRO(suffix, storage type) for each supported storage type.
#define MAD_FOR_EACH_TYPE(MACRO) \
  MACRO(f32, float)              \
  MACRO(bf16, __nv_bfloat16)     \
  MACRO(f64, double)
