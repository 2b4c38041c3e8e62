// X2: W4A8 matvec over a packed int4 weight, for Hopper.
//
// Replaces the Pallas TPU kernel scripts/exp_int4_pallas.py::qmv4_kernel
// (wrapper qmv4), the same function as the nested qmv4_kernel of
// scripts/exp_int4.py.  The weight W [Dout, Din] (4-bit two's complement) is
// packed [Dout, Din / 2] uint8: the low nibble of byte j is W[:, j], the high
// nibble W[:, Din / 2 + j] (the halves of the input axis, no interleave).
//   out[b, o] = f32(sum_k qy[b, k] * W[o, k] in int32) * s[o]
// for qy [B, Din] int8 (B <= 16), s [Dout] f32; no activation scale inside.
//
// Bound: the packed weight read, Dout * Din / 2 bytes over 3.35 TB/s (half
// of the int8 weight's).  Design: K6's ("oi" layout): a block of 8 warps owns
// 16 output rows, 2 per warp; each lane streams 16 packed bytes (32 weights)
// of each of its 2 rows at a time.  The nibbles are sign-extended bytewise,
// (n ^ 8) - 8 per byte with __vsub4, the low ones against x[j..] and the high
// ones against x[Din / 2 + j..], both by __dp4a into exact int32
// accumulators.  The activations are read through L1 (__ldg): every warp
// reads the same ones.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kMaxM = 16;

__device__ __forceinline__ int lo_nibbles(uint32_t v) {
  return (int)__vsub4((v & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int hi_nibbles(uint32_t v) {
  return (int)__vsub4(((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__device__ __forceinline__ int dot32(const int4& w, const int4& xl, const int4& xh, int c) {
  c = __dp4a(lo_nibbles((uint32_t)w.x), xl.x, c);
  c = __dp4a(hi_nibbles((uint32_t)w.x), xh.x, c);
  c = __dp4a(lo_nibbles((uint32_t)w.y), xl.y, c);
  c = __dp4a(hi_nibbles((uint32_t)w.y), xh.y, c);
  c = __dp4a(lo_nibbles((uint32_t)w.z), xl.z, c);
  c = __dp4a(hi_nibbles((uint32_t)w.z), xh.z, c);
  c = __dp4a(lo_nibbles((uint32_t)w.w), xl.w, c);
  return __dp4a(hi_nibbles((uint32_t)w.w), xh.w, c);
}

template <int MB>
__global__ void __launch_bounds__(kThreads)
qmv4_kernel(const int8_t* __restrict__ qy, const uint8_t* __restrict__ w,
            const float* __restrict__ s, float* __restrict__ out, int m, int dout, int dh) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const int din = 2 * dh;
  const int chunks = dh >> 4;  // 16-byte chunks of a packed row

  int acc[kRowsPerWarp][MB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < MB; ++i) acc[r][i] = 0;

  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll 4
  for (int c = lane; c < chunks; c += 32) {
    int4 wv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      wv[r] = row0 + r < dout
                  ? __ldg(reinterpret_cast<const int4*>(w + (size_t)(row0 + r) * dh) + c)
                  : zero;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      if (i >= m) break;
      const int8_t* x = qy + (size_t)i * din;
      const int4 xl = __ldg(reinterpret_cast<const int4*>(x) + c);
      const int4 xh = __ldg(reinterpret_cast<const int4*>(x + dh) + c);
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = dot32(wv[r], xl, xh, acc[r][i]);
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      int v = acc[r][i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && row < dout && i < m)
        out[(size_t)i * dout + row] = __fmul_rn(__int2float_rn(v), s[row]);
    }
  }
}

}  // namespace

// qy [m, 2 * dh] int8, w [dout, dh] uint8 packed, s [dout] f32 -> out
// [m, dout] f32.  1 <= m <= 16, dh % 16 == 0.
extern "C" int usdm_qmv4(const void* qy, const void* w, const void* s, void* out, int m,
                         int dout, int dh, void* stream) {
  if (m < 1 || m > kMaxM || dout < 1 || dh < 16 || dh % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((dout + kRowsPerBlock - 1) / kRowsPerBlock);
  const int8_t* x = (const int8_t*)qy;
  const uint8_t* w8 = (const uint8_t*)w;
  const float* sf = (const float*)s;
  float* o = (float*)out;
  if (m <= 1)
    qmv4_kernel<1><<<grid, kThreads, 0, st>>>(x, w8, sf, o, m, dout, dh);
  else if (m <= 4)
    qmv4_kernel<4><<<grid, kThreads, 0, st>>>(x, w8, sf, o, m, dout, dh);
  else
    qmv4_kernel<16><<<grid, kThreads, 0, st>>>(x, w8, sf, o, m, dout, dh);
  return (int)cudaGetLastError();
}
