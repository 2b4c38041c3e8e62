// K4: fused residual add + row mask + LayerNorm for Hopper.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/fused_ln.py::_kernel (wrapper
// add_mask_ln): out = LN((x + r) * rowmask) * w + b, optionally * rowmask
// again, with f32 statistics; row t of batch b is valid iff t < lengths[b].
// The rounding follows the plain version step by step: x + r is rounded to
// the input dtype, the normalized row (x - mean) * rsqrt(var + eps) is rounded
// to the input dtype BEFORE the scale and shift, and the product with w and
// the sum with b are each rounded, as separate bf16 tensor ops round them.
//
// Bound: a pure streaming pass, 2 reads and 1 write of [rows, H] (68 MB at
// the Voicebox training shape [8, 1379, 1024] bf16, ~20 us at 3.35 TB/s).
// Design: one warp per row, the row held in registers (each lane keeps 4
// neighbouring values per 128 columns, loaded with one 8- or 16-byte access),
// a two-pass mean and variance by warp shuffles, so x and r are read once and
// nothing but the output is written.  H is a multiple of 128 up to 4096; the
// kernel is instantiated for 1, 2, 4, ... 32 chunks of 128 columns.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

static __device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

static __device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

static __device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

static __device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// round a float to T and back: the rounding of one op on T tensors
static __device__ __forceinline__ float round_to(float v, float*) { return v; }
static __device__ __forceinline__ float round_to(float v, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
add_mask_ln_kernel(const T* __restrict__ x, const T* __restrict__ r,
                   const int* __restrict__ lengths, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out, int n_rows, int t_len,
                   int h, int post_mask, float eps) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // warp-uniform
  const bool valid = (row % t_len) < lengths[row / t_len];
  const int nc = h >> 7;
  const size_t base = (size_t)row * h;
  T* const tag = nullptr;

  float v[NC][4];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < nc) {
      const int c = j * 128 + lane * 4;
      float a[4], b[4];
      load4(x + base + c, a);
      load4(r + base + c, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[j][e] = valid ? round_to(a[e] + b[e], tag) : 0.f;
        sum += v[j][e];
      }
    }
  }
  const float mean = usdm::warp_sum(sum) / (float)h;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < nc) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = v[j][e] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(usdm::warp_sum(sq) / (float)h + eps);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    if (j < nc) {
      const int c = j * 128 + lane * 4;
      float ww[4], bb[4], o[4];
      load4(w + c, ww);
      load4(bias + c, bb);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = round_to((v[j][e] - mean) * rstd, tag);
        const float s = round_to(round_to(y * ww[e], tag) + bb[e], tag);
        o[e] = (post_mask && !valid) ? 0.f : s;
      }
      store4(out + base + c, o);
    }
  }
}

template <typename T>
int launch(const void* x, const void* r, const int* lengths, const void* w, const void* b,
           void* out, int n_rows, int t_len, int h, int post_mask, float eps, cudaStream_t st) {
  const int nc = h / 128;
  const dim3 grid((n_rows + kRowsPerBlock - 1) / kRowsPerBlock);
#define USDM_LN_CASE(N)                                                                   \
  if (nc <= N) {                                                                          \
    add_mask_ln_kernel<T, N><<<grid, kThreads, 0, st>>>(                                  \
        (const T*)x, (const T*)r, lengths, (const T*)w, (const T*)b, (T*)out, n_rows, t_len, \
        h, post_mask, eps);                                                               \
    return (int)cudaGetLastError();                                                       \
  }
  USDM_LN_CASE(1)
  USDM_LN_CASE(2)
  USDM_LN_CASE(4)
  USDM_LN_CASE(8)
  USDM_LN_CASE(16)
  USDM_LN_CASE(32)
#undef USDM_LN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int usdm_add_mask_ln(const void* x, const void* r, const void* lengths,
                                const void* w, const void* b, void* out, int batch, int t_len,
                                int h, int post_mask, float eps, int dtype, void* stream) {
  if (h < 128 || h % 128 != 0 || h > 4096 || batch < 1 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  const int n_rows = batch * t_len;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)
    return launch<__nv_bfloat16>(x, r, (const int*)lengths, w, b, out, n_rows, t_len, h,
                                 post_mask, eps, st);
  if (dtype == usdm::kF32)
    return launch<float>(x, r, (const int*)lengths, w, b, out, n_rows, t_len, h, post_mask,
                         eps, st);
  return (int)cudaErrorInvalidValue;
}
