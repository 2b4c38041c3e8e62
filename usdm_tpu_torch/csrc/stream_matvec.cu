// K6: W8A8 decode matvec for Hopper.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/stream_matvec.py::_qmv_kernel
// (wrapper stream_qmv).  y [M, Din] (bf16 or f32, M <= 16) times an int8
// weight in "oi" layout, q [Dout, Din] with bf16 per-output scales s [Dout]:
//   1. each row of y is quantized once, by a small first kernel:
//      ys = max(amax / 127, 1e-8), qx = clip(rint(y / ys), -127, 127), in
//      the reference's IEEE operations (round half to even);
//   2. acc = qx . q exactly in int32 (__dp4a), then out = acc * ys * s in f32
//      in that order (models/quant.py::qmm's epilogue), cast to out's dtype.
//
// Bound: the weight read.  Each weight byte is used M times (2M int8 ops per
// byte, far below the H100's ~590 int8 op/byte ridge), so the kernel is
// held to Dout * Din bytes over 3.35 TB/s: 17.5 us for one [14336, 4096]
// projection.  Design: a block of 8 warps owns 16 output rows, 2 per warp;
// every lane streams 16 bytes of each of its 2 rows at a time (a warp reads
// 512 contiguous bytes of a row), so each weight byte is read once, with
// 8 independent 16-byte loads in flight per lane per tile.  The block stages
// the quantized activations of a 2048-column tile in shared memory and every
// weight load is used against all M rows from there, 2 rows per shared load.
// The TPU kernel's double-buffered manual DMA is not carried over: the many
// warps in flight on each SM hide the load latency instead.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 2;
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kTile = 2048;  // activation bytes per row staged per tile
constexpr int kMaxM = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ y, int8_t* __restrict__ qx, float* __restrict__ ys,
                     int din) {
  const int m = blockIdx.x;
  const T* row = y + (size_t)m * din;
  __shared__ float s_red[kWarps];
  float amax = 0.f;
  for (int i = threadIdx.x; i < din; i += kThreads) amax = fmaxf(amax, fabsf(usdm::to_f32(row[i])));
  amax = usdm::warp_max(amax);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = amax;
  __syncthreads();
  float a = s_red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) a = fmaxf(a, s_red[w]);
  const float scale = fmaxf(__fdiv_rn(a, 127.f), 1e-8f);
  if (threadIdx.x == 0) ys[m] = scale;
  for (int i = threadIdx.x; i < din; i += kThreads) {
    const float q = rintf(__fdiv_rn(usdm::to_f32(row[i]), scale));
    qx[(size_t)m * din + i] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
  }
}

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

template <int MB, typename TO>
__global__ void __launch_bounds__(kThreads)
qmv_kernel(const int8_t* __restrict__ qx, const float* __restrict__ ys,
           const int8_t* __restrict__ w, const __nv_bfloat16* __restrict__ s,
           TO* __restrict__ out, int m, int dout, int din) {
  __shared__ __align__(16) int8_t s_x[MB][kTile];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;

  int acc[kRowsPerWarp][MB];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < MB; ++i) acc[r][i] = 0;

  const int4 zero = make_int4(0, 0, 0, 0);
  for (int k0 = 0; k0 < din; k0 += kTile) {
    const int chunks = min(kTile, din - k0) >> 4;  // 16-byte chunks in this tile
    for (int i = threadIdx.x; i < MB * chunks; i += kThreads) {
      const int mm = i / chunks, c = i - mm * chunks;
      *reinterpret_cast<int4*>(&s_x[mm][c * 16]) =
          mm < m ? *reinterpret_cast<const int4*>(qx + (size_t)mm * din + k0 + c * 16) : zero;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      int4 wv[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        wv[r] = row0 + r < dout
                    ? __ldg(reinterpret_cast<const int4*>(w + (size_t)(row0 + r) * din + k0) + c)
                    : zero;
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const int4 xv = *reinterpret_cast<const int4*>(&s_x[i][c * 16]);
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) acc[r][i] = dot16(wv[r], xv, acc[r][i]);
      }
    }
    __syncthreads();  // s_x is rewritten by the next tile
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      int v = acc[r][i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && row < dout && i < m) {
        const float o = __fmul_rn(__fmul_rn(__int2float_rn(v), ys[i]), __bfloat162float(s[row]));
        usdm::store(out + (size_t)i * dout + row, o);
      }
    }
  }
}

template <int MB>
cudaError_t launch_mv(const int8_t* qx, const float* ys, const int8_t* w,
                      const __nv_bfloat16* s, void* out, int m, int dout, int din,
                      int out_dtype, cudaStream_t st) {
  const dim3 grid((dout + kRowsPerBlock - 1) / kRowsPerBlock);
  if (out_dtype == usdm::kBF16)
    qmv_kernel<MB, __nv_bfloat16><<<grid, kThreads, 0, st>>>(qx, ys, w, s,
                                                             (__nv_bfloat16*)out, m, dout, din);
  else if (out_dtype == usdm::kF32)
    qmv_kernel<MB, float><<<grid, kThreads, 0, st>>>(qx, ys, w, s, (float*)out, m, dout, din);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// y [m, din] (in_dtype), w [dout, din] int8, s [dout] bf16 -> out [m, dout]
// (out_dtype); qx [m, din] int8 and ys [m] f32 are the caller's scratch.
extern "C" int usdm_stream_qmv(const void* y, const void* w, const void* s, void* qx, void* ys,
                               void* out, int m, int dout, int din, int in_dtype,
                               int out_dtype, void* stream) {
  if (m < 1 || m > kMaxM || dout < 1 || din < 16 || din % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == usdm::kBF16)
    quantize_rows_kernel<__nv_bfloat16><<<m, kThreads, 0, st>>>(
        (const __nv_bfloat16*)y, (int8_t*)qx, (float*)ys, din);
  else if (in_dtype == usdm::kF32)
    quantize_rows_kernel<float><<<m, kThreads, 0, st>>>((const float*)y, (int8_t*)qx,
                                                        (float*)ys, din);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int8_t* q8 = (const int8_t*)qx;
  const float* ysf = (const float*)ys;
  const int8_t* w8 = (const int8_t*)w;
  const __nv_bfloat16* sb = (const __nv_bfloat16*)s;
  if (m <= 1) return (int)launch_mv<1>(q8, ysf, w8, sb, out, m, dout, din, out_dtype, st);
  if (m <= 2) return (int)launch_mv<2>(q8, ysf, w8, sb, out, m, dout, din, out_dtype, st);
  if (m <= 4) return (int)launch_mv<4>(q8, ysf, w8, sb, out, m, dout, din, out_dtype, st);
  if (m <= 8) return (int)launch_mv<8>(q8, ysf, w8, sb, out, m, dout, din, out_dtype, st);
  return (int)launch_mv<16>(q8, ysf, w8, sb, out, m, dout, din, out_dtype, st);
}
