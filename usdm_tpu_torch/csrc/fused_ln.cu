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
//
// The backward (add_mask_ln_bwd_kernel, then dw_db_reduce_kernel) replaces
// the vjp of usdm_tpu's `_xla_ref` (usdm_tpu/ops/fused_ln.py::_bwd), which
// XLA fuses: one streaming pass recomputes s = round(x + r) * m, the mean and
// rstd, and takes gy = post_mask ? g * m : g, dn = round(gy * w), the
// LayerNorm backward in f32 against the unrounded normalized row
// nf = (s - mean) * rstd, dx = dr = round(rstd * ((dn - mean(dn)) -
// (nf - mean(nf)) * mean(dn * nf))) * m.  dw = sum_rows round(gy * round(nf))
// and db = sum_rows gy are f32 partials per block, summed by a second small
// launch in a fixed order: no float atomics, the same bits on every run.
// Bound: x, r and g read once and dx written once, 4 x 22.6 MB at the
// training shape (~27 us at 3.35 TB/s), plus the partials.  Design: a row's
// 128-column chunks are spread over WPR warps with at most 4 chunks a lane
// (x + r, then g and dn, and the dw / db partials stay in registers: 64
// floats a lane at most), the row's sums meet in shared memory; a block of 8
// warps walks rows 8 / WPR at a time over a grid of at most 264 blocks, and
// its warps' partials for their columns are added in shared memory at the
// end.

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

// ---------------------------------------------------------------- backward
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kBwdColsPerBlock = 4096;  // RPB * H <= 8 rows x 512 columns

// the sums of one row over its WPR warps: each warp's shuffled value goes
// through red[warp]; every warp reads its row's WPR entries in order
template <int WPR>
static __device__ __forceinline__ float row_sum(float v, float* red, int warp) {
  v = usdm::warp_sum(v);
  if (WPR == 1) return v;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % WPR;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < WPR; ++i) s += red[first + i];
  return s;
}

template <typename T, int CH, int WPR>
__global__ void __launch_bounds__(kBwdThreads, 2)
add_mask_ln_bwd_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ g,
                       const int* __restrict__ lengths, const T* __restrict__ w,
                       T* __restrict__ dx, float* __restrict__ part, int n_rows, int t_len,
                       int h, int post_mask, float eps) {
  constexpr int kRowsPerIter = kBwdWarps / WPR;
  __shared__ float s_red[3][4][kBwdWarps];  // sum, squares, (dn, dn nf, nf)
  __shared__ float s_acc[2][kBwdColsPerBlock];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int slot = warp / WPR, wir = warp % WPR;
  const int nc = h >> 7;
  const float inv_h = 1.f / (float)h;
  T* const tag = nullptr;
  float dw[CH][4], db[CH][4];
#pragma unroll
  for (int j = 0; j < CH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dw[j][e] = db[j][e] = 0.f;

  const int n_iter = (n_rows + kRowsPerIter - 1) / kRowsPerIter;
  for (int it = blockIdx.x; it < n_iter; it += gridDim.x) {
    const int row = it * kRowsPerIter + slot;
    const bool live = row < n_rows;  // dead rows add zeros, but keep the barriers
    const bool valid = live && (row % t_len) < lengths[row / t_len];
    const size_t base = (size_t)(live ? row : 0) * h;
    float v[CH][4], gd[CH][4];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int cj = wir * CH + j;
      if (cj < nc && live) {
        const int c = cj * 128 + lane * 4;
        float a[4], b[4];
        load4(x + base + c, a);
        load4(r + base + c, b);
        load4(g + base + c, gd[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[j][e] = valid ? round_to(a[e] + b[e], tag) : 0.f;
          if (post_mask && !valid) gd[j][e] = 0.f;
          sum += v[j][e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][e] = gd[j][e] = 0.f;
      }
    }
    const float mean = row_sum<WPR>(sum, s_red[0][0], warp) * inv_h;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (wir * CH + j < nc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float d = v[j][e] - mean;
          sq += d * d;
        }
    const float rstd = rsqrtf(row_sum<WPR>(sq, s_red[1][0], warp) * inv_h + eps);
    float s_dn = 0.f, s_dnn = 0.f, s_n = 0.f;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int cj = wir * CH + j;
      if (cj < nc) {
        float ww[4];
        load4(w + cj * 128 + lane * 4, ww);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float nf = (v[j][e] - mean) * rstd;
          const float gy = gd[j][e];
          dw[j][e] += round_to(gy * round_to(nf, tag), tag);
          db[j][e] += gy;
          const float dn = round_to(gy * ww[e], tag);
          gd[j][e] = dn;
          s_dn += dn;
          s_dnn += dn * nf;
          s_n += nf;
        }
      }
    }
    // three sums of one row in one exchange
    s_dn = usdm::warp_sum(s_dn);
    s_dnn = usdm::warp_sum(s_dnn);
    s_n = usdm::warp_sum(s_n);
    if (WPR > 1) {
      if (lane == 0) {
        s_red[2][0][warp] = s_dn;
        s_red[2][1][warp] = s_dnn;
        s_red[2][2][warp] = s_n;
      }
      __syncthreads();
      const int first = warp - wir;
      s_dn = s_dnn = s_n = 0.f;
#pragma unroll
      for (int i = 0; i < WPR; ++i) {
        s_dn += s_red[2][0][first + i];
        s_dnn += s_red[2][1][first + i];
        s_n += s_red[2][2][first + i];
      }
    }
    const float m_dn = s_dn * inv_h, m_dnn = s_dnn * inv_h, m_n = s_n * inv_h;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int cj = wir * CH + j;
      if (cj < nc && live) {
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float nf = (v[j][e] - mean) * rstd;
          const float dxf = rstd * ((gd[j][e] - m_dn) - (nf - m_n) * m_dnn);
          o[e] = valid ? round_to(dxf, tag) : 0.f;
        }
        store4(dx + base + cj * 128 + lane * 4, o);
      }
    }
  }

  // the block's dw / db partials: its row slots' sums added in slot order
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int cj = wir * CH + j;
    if (cj < nc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = slot * h + cj * 128 + lane * 4 + e;
        s_acc[0][c] = dw[j][e];
        s_acc[1][c] = db[j][e];
      }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < h; c += kBwdThreads) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int sl = 0; sl < kRowsPerIter; ++sl) {
      a += s_acc[0][sl * h + c];
      b += s_acc[1][sl * h + c];
    }
    part[(size_t)blockIdx.x * 2 * h + c] = a;
    part[(size_t)blockIdx.x * 2 * h + h + c] = b;
  }
}

// part [n_blocks][2][h] -> dw, db [h]: column c of dw (y 0) or db (y 1),
// 8 threads over the blocks in a fixed order, then their 8 sums in order
template <typename T>
__global__ void __launch_bounds__(256)
dw_db_reduce_kernel(const float* __restrict__ part, T* __restrict__ dw, T* __restrict__ db,
                    int n_blocks, int h) {
  __shared__ float s[8][33];
  const int c = blockIdx.x * 32 + threadIdx.x, which = blockIdx.y;
  float a = 0.f;
  if (c < h)
    for (int b = threadIdx.y; b < n_blocks; b += 8) a += part[((size_t)b * 2 + which) * h + c];
  s[threadIdx.y][threadIdx.x] = a;
  __syncthreads();
  if (threadIdx.y == 0 && c < h) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) t += s[i][threadIdx.x];
    usdm::store((which ? db : dw) + c, t);
  }
}

template <typename T>
int launch_bwd(const void* x, const void* r, const void* g, const int* lengths, const void* w,
               void* dx, void* dw, void* db, float* part, int n_rows, int t_len, int h,
               int post_mask, float eps, int n_blocks, cudaStream_t st) {
  const int nc = h / 128;
#define USDM_LN_BWD_CASE(N, CH, WPR)                                                      \
  if (nc <= N) {                                                                          \
    add_mask_ln_bwd_kernel<T, CH, WPR><<<n_blocks, kBwdThreads, 0, st>>>(                 \
        (const T*)x, (const T*)r, (const T*)g, lengths, (const T*)w, (T*)dx, part, n_rows, \
        t_len, h, post_mask, eps);                                                        \
  } else
  USDM_LN_BWD_CASE(1, 1, 1)
  USDM_LN_BWD_CASE(2, 2, 1)
  USDM_LN_BWD_CASE(4, 4, 1)
  USDM_LN_BWD_CASE(8, 4, 2)
  USDM_LN_BWD_CASE(16, 4, 4)
  USDM_LN_BWD_CASE(32, 4, 8)
  return (int)cudaErrorInvalidValue;
#undef USDM_LN_BWD_CASE
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_db_reduce_kernel<T><<<dim3((h + 31) / 32, 2), dim3(32, 8), 0, st>>>(part, (T*)dw, (T*)db,
                                                                        n_blocks, h);
  return (int)cudaGetLastError();
}

}  // namespace

// g [batch, t_len, h] the output's gradient -> dx (= dr) [batch, t_len, h],
// dw, db [h]; part holds n_blocks * 2 * h floats of the caller's scratch
// (n_blocks: the backward's grid, 1 .. 264).
extern "C" int usdm_add_mask_ln_bwd(const void* x, const void* r, const void* g,
                                    const void* lengths, const void* w, void* dx, void* dw,
                                    void* db, void* part, int batch, int t_len, int h,
                                    int post_mask, float eps, int n_blocks, int dtype,
                                    void* stream) {
  if (h < 128 || h % 128 != 0 || h > 4096 || batch < 1 || t_len < 1 || n_blocks < 1)
    return (int)cudaErrorInvalidValue;
  const int n_rows = batch * t_len;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)
    return launch_bwd<__nv_bfloat16>(x, r, g, (const int*)lengths, w, dx, dw, db, (float*)part,
                                     n_rows, t_len, h, post_mask, eps, n_blocks, st);
  if (dtype == usdm::kF32)
    return launch_bwd<float>(x, r, g, (const int*)lengths, w, dx, dw, db, (float*)part, n_rows,
                             t_len, h, post_mask, eps, n_blocks, st);
  return (int)cudaErrorInvalidValue;
}

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
