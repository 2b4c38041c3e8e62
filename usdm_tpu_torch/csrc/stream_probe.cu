// X3: weight-streaming probes for Hopper.
//
// Replaces the Pallas TPU kernels of scripts/exp_stream_variants.py:
// make_kernel(mode, bpad) (every mode) and run_multi_dma's kernel, which
// splits each tile's DMA into nch concurrent copies.  Both stream all of an
// int8 weight w [F, D] tile by tile (tiles of BF rows) and return
//   out[0, j] = sum over tiles i, in tile order, in f32, of g(tile_i)[j],
// j < 128, with g by mode:
//   dma_only  tile[0, j]                              (copy: loads only)
//   dot       (x @ tile^T)[0, j], int8 x int8 -> int32 (__dp4a), x [bpad, D]
//   vpu       the same product as f32 products summed in f32
//   dot_bf16  the same product, operands through bf16, summed in f32
//
// Bound: the weight read, F * D bytes over 3.35 TB/s (17.5 us for one
// [14336, 4096] layer); the dot modes do bpad int8 multiply-adds per byte.
// Design: on the card a tile is no unit of transfer.  Each warp streams whole
// rows (grid-stride over rows, as many blocks as fit on the SMs at once);
// every lane requests LOADS 16-byte chunks of its row before it uses any of
// them, the analogue of the TPU kernel's concurrent DMAs (nch).  A row's dot
// with x's first row is the output for the first 128 rows of each tile, so
// the per-tile results are written to part [NT, 128] (no order across
// blocks), and a second pass adds them in tile order, as the TPU kernel's
// loop does.  Everything else a mode loads (the other rows of each tile, the
// other rows of x) is folded into one int per block of `sink`, so the
// compiler can drop no load: the timed bytes are all F * D.
// f32 order of vpu and dot_bf16: every product is an exact integer, and a
// lane's share of a row (the 16-byte chunks c = lane mod 32) stays an exact
// integer for D <= 32768; then the warp's shuffle sum adds the 32 shares in
// a 5-level tree (lane l + lane l + 16, ...), the only adds that round.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kOut = 128;  // output columns: the first 128 rows of a tile
constexpr int kMaxF32D = 32768;  // vpu, dot_bf16: lane shares <= 64 * 16 * 2^14 = 2^24

enum Mode : int { kCopy = 0, kDot = 1, kF32 = 2, kBF16 = 3 };

using usdm::byte_f32;

__device__ __forceinline__ float via_bf16(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));  // exact for |f| <= 256
}

template <int MODE>
__device__ __forceinline__ void mac16(const int4& w, const int4& x, int& acc_i, float& acc_f) {
  const uint32_t wv[4] = {(uint32_t)w.x, (uint32_t)w.y, (uint32_t)w.z, (uint32_t)w.w};
  const uint32_t xv[4] = {(uint32_t)x.x, (uint32_t)x.y, (uint32_t)x.z, (uint32_t)x.w};
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    if (MODE == kDot) {
      acc_i = __dp4a((int)wv[p], (int)xv[p], acc_i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = byte_f32(wv[p], e), b = byte_f32(xv[p], e);
        if (MODE == kBF16) {
          a = via_bf16(a);
          b = via_bf16(b);
        }
        acc_f = fmaf(a, b, acc_f);  // the product is exact in f32
      }
    }
  }
}

template <int MODE, int BPAD, int LOADS>
__global__ void __launch_bounds__(kThreads)
stream_probe_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    float* __restrict__ part, int* __restrict__ sink, int rows, int d, int bf) {
  __shared__ unsigned s_fold[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = d >> 4;  // 16-byte chunks per row
  const int4 zero = make_int4(0, 0, 0, 0);
  unsigned fold_i = 0;  // wraps: only its dependence on every load matters
  float fold_f = 0.f;

  for (int r = blockIdx.x * kWarps + warp; r < rows; r += gridDim.x * kWarps) {
    const int4* wrow = reinterpret_cast<const int4*>(w + (size_t)r * d);
    const bool out_row = r % bf < kOut;
    int acc_i[BPAD];
    float acc_f[BPAD];
#pragma unroll
    for (int b = 0; b < BPAD; ++b) {
      acc_i[b] = 0;
      acc_f[b] = 0.f;
    }
#pragma unroll 1
    for (int c0 = lane; c0 < chunks; c0 += 32 * LOADS) {
      int4 wv[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {  // all LOADS requests before any use
        const int c = c0 + 32 * u;
        wv[u] = c < chunks ? __ldg(wrow + c) : zero;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int c = c0 + 32 * u;
        if (MODE == kCopy) {
          fold_i += (unsigned)wv[u].x + wv[u].y + wv[u].z + wv[u].w;
          if (r % bf == 0 && c < kOut / 16) {  // a tile's first row: its output
            const uint32_t wq[4] = {(uint32_t)wv[u].x, (uint32_t)wv[u].y, (uint32_t)wv[u].z,
                                    (uint32_t)wv[u].w};
            float* o = part + (size_t)(r / bf) * kOut + c * 16;
#pragma unroll
            for (int e = 0; e < 16; ++e) o[e] = byte_f32(wq[e >> 2], e & 3);
          }
        } else {
#pragma unroll
          for (int b = 0; b < BPAD; ++b) {
            const int4 xv =
                c < chunks ? __ldg(reinterpret_cast<const int4*>(x + (size_t)b * d) + c) : zero;
            mac16<MODE>(wv[u], xv, acc_i[b], acc_f[b]);
          }
        }
      }
    }
    if (MODE != kCopy) {
#pragma unroll
      for (int b = 0; b < BPAD; ++b) {
        fold_i += (unsigned)acc_i[b];
        fold_f += acc_f[b];
      }
      if (out_row) {  // the row's dot with x's first row, summed over lanes
        float v;
        if (MODE == kDot) {
          int s = acc_i[0];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          v = __int2float_rn(s);
        } else {
          v = usdm::warp_sum(acc_f[0]);
        }
        if (lane == 0) part[(size_t)(r / bf) * kOut + r % bf] = v;
      }
    }
  }
  unsigned f = fold_i + __float_as_uint(fold_f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) f += __shfl_xor_sync(0xffffffffu, f, o);
  if (lane == 0) s_fold[warp] = f;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += s_fold[i];
    sink[blockIdx.x] = (int)t;
  }
}

// out[j] = sum over tiles in tile order, from 0, in f32 (the TPU kernel's
// fori_loop accumulator); 16 tiles' loads are issued before their adds
__global__ void fold_tiles_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  int nt) {
  constexpr int kBatch = 16;
  const int j = threadIdx.x;
  float a = 0.f;
  for (int i0 = 0; i0 < nt; i0 += kBatch) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      v[k] = i0 + k < nt ? part[(size_t)(i0 + k) * kOut + j] : 0.f;
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (i0 + k < nt) a = __fadd_rn(a, v[k]);
  }
  out[j] = a;
}

template <int MODE, int BPAD, int LOADS>
cudaError_t launch(const int8_t* x, const int8_t* w, float* part, int* sink, int sink_len,
                   int rows, int d, int bf, cudaStream_t st) {
  auto kern = stream_probe_kernel<MODE, BPAD, LOADS>;
  // blocks that fit on the card at once, asked once per instantiation (the
  // first call), so that later calls make no API call but the launch and
  // can be captured in a CUDA graph
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                                                kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = std::max(1, per_sm) * sms;
  }
  int grid = (rows + kWarps - 1) / kWarps;
  grid = std::min(std::min(grid, resident), sink_len);
  kern<<<grid, kThreads, 0, st>>>(x, w, part, sink, rows, d, bf);
  return cudaGetLastError();
}

template <int MODE, int BPAD>
cudaError_t by_loads(int loads, const int8_t* x, const int8_t* w, float* part, int* sink,
                     int sink_len, int rows, int d, int bf, cudaStream_t st) {
  switch (loads) {
    case 1: return launch<MODE, BPAD, 1>(x, w, part, sink, sink_len, rows, d, bf, st);
    case 2: return launch<MODE, BPAD, 2>(x, w, part, sink, sink_len, rows, d, bf, st);
    case 4: return launch<MODE, BPAD, 4>(x, w, part, sink, sink_len, rows, d, bf, st);
    case 8: return launch<MODE, BPAD, 8>(x, w, part, sink, sink_len, rows, d, bf, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [bpad, d] int8, w [rows, d] int8 -> out [128] f32; part [rows / bf, 128]
// f32 and sink [sink_len] int are the caller's scratch.  Modes 0-3 as above;
// bpad 1, 8 or 32 for mode 1 and 1 otherwise; loads 1, 2, 4 or 8.
extern "C" int usdm_stream_probe(const void* x, const void* w, void* part, void* sink,
                                 void* out, int rows, int d, int bf, int mode, int bpad,
                                 int loads, int sink_len, void* stream) {
  if (rows < 1 || d < 16 || d % 16 != 0 || bf < kOut || rows % bf != 0 || sink_len < 1 ||
      ((mode == kF32 || mode == kBF16) && d > kMaxF32D))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* x8 = (const int8_t*)x;
  const int8_t* w8 = (const int8_t*)w;
  float* p = (float*)part;
  int* s = (int*)sink;
  cudaError_t err;
  if (mode == kCopy && bpad == 1)
    err = by_loads<kCopy, 1>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else if (mode == kDot && bpad == 1)
    err = by_loads<kDot, 1>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else if (mode == kDot && bpad == 8)
    err = by_loads<kDot, 8>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else if (mode == kDot && bpad == 32)
    err = by_loads<kDot, 32>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else if (mode == kF32 && bpad == 1)
    err = by_loads<kF32, 1>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else if (mode == kBF16 && bpad == 1)
    err = by_loads<kBF16, 1>(loads, x8, w8, p, s, sink_len, rows, d, bf, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  fold_tiles_kernel<<<1, kOut, 0, st>>>(p, (float*)out, rows / bf);
  return (int)cudaGetLastError();
}
