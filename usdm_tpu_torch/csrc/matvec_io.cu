// X1: matvecs over an int8 weight in the "io" layout, for Hopper.
//
// Replaces the Pallas TPU kernels scripts/exp_matvec.py::_mv_bf16_kernel
// (X1a) and ::_mv_i8_kernel (X1b), launched by make_mv.  The weight is
// q [Din, Dout] int8 (one INPUT row contiguous: usdm_tpu's layout of a
// quantized weight) with bf16 per-column scales s [Dout]:
//   X1a  out = bf16((sum_k f32(y[k]) * f32(bf16(q[k, o]))) * f32(s[o])),
//        y [1, Din] bf16, the sum in f32;
//   X1b  out = bf16(f32(sum_k qx[k] * q[k, o] in int32) * f32(s[o])),
//        qx [1, Din] int8.
//
// Bound: the weight read, Din * Dout bytes over 3.35 TB/s.  Design: a thread
// owns 16 adjacent output columns and reads them 16 bytes at a time from
// consecutive rows; a block covers `bf` columns (512 or 1024, the Pallas tile
// width) with bf / 16 threads per row group and 256 / (bf / 16) row groups,
// and a slice of the Din rows.  With 16 columns per thread a [*, 4096]
// output has only 8 such column blocks, so Din is split across row groups in
// a block and across `ks` blocks (enough blocks for every SM); the row
// groups are combined in shared memory in a fixed order, the slices by a
// second pass in slice order, so the result is deterministic.  In the io
// layout the 4 bytes of a 32-bit word are 4 different columns, so X1b
// transposes 4 rows x 4 bytes with __byte_perm, after which each word holds
// one column's 4 consecutive rows and __dp4a applies.  int8 -> f32 goes
// through the mantissa (no conversion instructions).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;  // output columns per thread

// words a, b, c, d of rows k..k+3 (bytes = 4 columns) -> out[j] = column j's
// bytes of rows k..k+3, in row order
__device__ __forceinline__ void transpose4(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                                           uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(a, b, 0x5140), t1 = __byte_perm(a, b, 0x7362);
  const uint32_t t2 = __byte_perm(c, d, 0x5140), t3 = __byte_perm(c, d, 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

__device__ __forceinline__ uint32_t word(const int4& v, int p) {
  return (uint32_t)(p == 0 ? v.x : p == 1 ? v.y : p == 2 ? v.z : v.w);
}

// part[slice, o]: the sum over the slice's rows, f32 (X1a) or int32 (X1b)
template <bool I8>
__global__ void __launch_bounds__(kThreads)
mv_io_partial(const void* __restrict__ xv, const int8_t* __restrict__ q, void* __restrict__ part,
              int din, int dout, int bf, int kchunk) {
  using Acc = typename std::conditional<I8, int, float>::type;
  __shared__ Acc s_acc[kThreads * kCols];  // [groups][bf]
  const int lanes = bf / kCols;
  const int groups = kThreads / lanes;
  const int t = threadIdx.x % lanes, g = threadIdx.x / lanes;
  const int col = blockIdx.x * bf + t * kCols;
  const int k0 = blockIdx.y * kchunk, k1 = min(din, k0 + kchunk);

  Acc acc[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e) acc[e] = 0;
  if (col < dout) {
#pragma unroll 2
    for (int k = k0 + 4 * g; k < k1; k += 4 * groups) {  // 4 rows at a time
      int4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = __ldg(reinterpret_cast<const int4*>(q + (size_t)(k + i) * dout + col));
      if constexpr (I8) {
        const int xw = __ldg(reinterpret_cast<const int*>(static_cast<const int8_t*>(xv) + k));
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          uint32_t cw[4];
          transpose4(word(r[0], p), word(r[1], p), word(r[2], p), word(r[3], p), cw);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[4 * p + j] = __dp4a((int)cw[j], xw, acc[4 * p + j]);
        }
      } else {
        const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(xv) + k;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float yk = __bfloat162float(y[i]);
#pragma unroll
          for (int e = 0; e < kCols; ++e)  // int8 -> bf16 is exact
            acc[e] = fmaf(yk, usdm::byte_f32(word(r[i], e >> 2), e & 3), acc[e]);
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kCols; ++e) s_acc[g * bf + t * kCols + e] = acc[e];
  __syncthreads();
  for (int c = threadIdx.x; c < bf; c += kThreads) {
    const int o = blockIdx.x * bf + c;
    if (o >= dout) continue;
    Acc a = s_acc[c];
    for (int gg = 1; gg < groups; ++gg) a += s_acc[gg * bf + c];  // fixed group order
    static_cast<Acc*>(part)[(size_t)blockIdx.y * dout + o] = a;
  }
}

// out[o] = bf16(f32(sum over slices in slice order) * f32(s[o]))
template <bool I8>
__global__ void __launch_bounds__(kThreads)
mv_io_combine(const void* __restrict__ part, const __nv_bfloat16* __restrict__ s,
              __nv_bfloat16* __restrict__ out, int dout, int ks) {
  using Acc = typename std::conditional<I8, int, float>::type;
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= dout) return;
  const Acc* p = static_cast<const Acc*>(part);
  Acc a = 0;
  for (int i = 0; i < ks; ++i) a += p[(size_t)i * dout + o];
  float af;
  if constexpr (I8) af = __int2float_rn(a);
  else af = a;
  out[o] = __float2bfloat16_rn(__fmul_rn(af, __bfloat162float(s[o])));
}

}  // namespace

// x [1, din] (bf16 for X1a, int8 for X1b), q [din, dout] int8, s [dout]
// bf16 -> out [1, dout] bf16; part [ks, dout] f32/int32 is the caller's
// scratch, ks = ceil(din / kchunk).  dout % 16 == 0, din % 4 == 0,
// kchunk % 4 == 0, bf 512 or 1024.
extern "C" int usdm_mv_io(const void* x, const void* q, const void* s, void* part, void* out,
                          int din, int dout, int bf, int kchunk, int int8_x, void* stream) {
  if (din < 4 || din % 4 || dout < kCols || dout % kCols || kchunk < 4 || kchunk % 4 ||
      (bf != 512 && bf != 1024))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int ks = (din + kchunk - 1) / kchunk;
  const dim3 grid((dout + bf - 1) / bf, ks);
  const int8_t* q8 = (const int8_t*)q;
  if (int8_x)
    mv_io_partial<true><<<grid, kThreads, 0, st>>>(x, q8, part, din, dout, bf, kchunk);
  else
    mv_io_partial<false><<<grid, kThreads, 0, st>>>(x, q8, part, din, dout, bf, kchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int cgrid = (dout + kThreads - 1) / kThreads;
  const __nv_bfloat16* sb = (const __nv_bfloat16*)s;
  if (int8_x)
    mv_io_combine<true><<<cgrid, kThreads, 0, st>>>(part, sb, (__nv_bfloat16*)out, dout, ks);
  else
    mv_io_combine<false><<<cgrid, kThreads, 0, st>>>(part, sb, (__nv_bfloat16*)out, dout, ks);
  return (int)cudaGetLastError();
}
