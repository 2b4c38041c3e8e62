// Shared helpers of the usdm_tpu_torch Hopper kernels (plain C interface,
// no PyTorch headers: built by ops/_build.py with nvcc for sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace usdm {

// dtype codes, mirrored by ops/_build.py DTYPE_CODES
enum DtypeCode : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

static __device__ __forceinline__ float to_f32(float x) { return x; }
static __device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
static __device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// signed byte i of v -> its exact float: 2^23 + (b ^ 0x80) built in the
// mantissa, then 2^23 + 128 subtracted (no int -> float conversion)
static __device__ __forceinline__ float byte_f32(uint32_t v, int i) {
  const uint32_t u = v ^ 0x80808080u;
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | i)) - 8388736.f;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Finite "minus infinity" of the online softmaxes: exp(x - m) stays 0, and
// m - m stays 0 (true -inf would give NaN), as in the Pallas kernels.
constexpr float kNegInf = -1e30f;

}  // namespace usdm
