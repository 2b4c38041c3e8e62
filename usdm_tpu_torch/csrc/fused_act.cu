// K3: BigVGAN's anti-aliased snake activation in one pass, for Hopper.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/fused_act.py::_kernel (wrapper
// fused_activation1d): 2x kaiser-sinc upsample (12 taps, as two 6-tap phase
// FIRs of the same input window), snake / snake-beta in f32 with optional
// log-scale alpha/beta, and the 12-tap 2x downsample, with the replicate
// padding of both resamplers.  Layout [B, C, T] (time contiguous).
//
//   up[2s]   = sum_j fe[j] * x[clamp(s - 3 + j)]      fe = 2 g[0::2]
//   up[2s+1] = sum_j fo[j] * x[clamp(s - 2 + j)]      fo = 2 g[1::2]
//   y[t]     = sum_k g[k] * snake(up[clamp(2t + k - 5)])   (k = 0..11)
//
// The clamps are the replicate pads of usdm_tpu.models.bigvgan.upsample2
// (input space) and downsample2 (up space); applied in the kernel, they make
// every output exact, edges included.
//
// Bound: device-memory bandwidth (x read once, y written once: 8 bytes an
// output in f32); issuing ~2.2 warp-instructions an output (529 a lane for
// its 8 outputs of an interior task) takes about as long.  Design:
//  * register blocking: a warp takes one task, a tile of kTile = 30 * kR
//    outputs of one row; lane l holds the kR = 8 consecutive samples at
//    tile - kR + l kR, so lanes 1..30 write the tile and lanes 0 and 31 only
//    supply halos.  Halos move between lanes by shuffles; nothing goes
//    through shared memory, and the two upsample phases are straight-line
//    FIRs with no branch on parity;
//  * each lane snakes its own 2 kR up-samples once and trades the 5 + 5
//    snake values its outputs need with its neighbours (snaking all 2 kR +
//    10 up-samples in every lane and trading only x took 24 % longer);
//  * the 12 taps and the two 6-tap phases are __constant__ operands of the
//    FMAs;
//  * x and y move as 16-, 8-, 4- or 2-byte vectors, the widest the row
//    alignment allows (chosen by the wrapper); tasks whose samples stay
//    inside the row take no clamp, the others (the tiles at t = 0 and
//    t = T - 1) clamp every index and patch the up-space pad;
//  * a grid of as many blocks as fit on the card walks the (row, tile)
//    tasks, each warp loading its next task's samples before it computes
//    the current one;
//  * sin^2 has period pi: the argument is reduced by pi in f32 (Cody-Waite,
//    two FMAs) and sin taken on [-pi/2, pi/2] by a degree-9 odd polynomial
//    (sin_sq below), in place of sinf's longer reduction and its branch.

#include "common.cuh"

namespace {

constexpr int kR = 8;                     // consecutive samples per lane
constexpr int kLanes = 32;
constexpr int kTile = (kLanes - 2) * kR;  // outputs per task (lanes 1..30)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

// kaiser_sinc_filter1d(0.25, 0.3, 12) in f32: the downsample's taps g
#define USDM_G0 0.00202896656f
#define USDM_G1 0.00938946381f
#define USDM_G2 -0.0255434643f
#define USDM_G3 -0.0576573759f
#define USDM_G4 0.128572613f
#define USDM_G5 0.443209797f
__constant__ float kG[12] = {USDM_G0, USDM_G1, USDM_G2, USDM_G3, USDM_G4, USDM_G5,
                             USDM_G5, USDM_G4, USDM_G3, USDM_G2, USDM_G1, USDM_G0};
// the upsample's phases, fe = 2 g[0::2] then fo = 2 g[1::2] (exact: a power of two)
__constant__ float kUp[12] = {2.f * USDM_G0, 2.f * USDM_G2, 2.f * USDM_G4,
                              2.f * USDM_G5, 2.f * USDM_G3, 2.f * USDM_G1,
                              2.f * USDM_G1, 2.f * USDM_G3, 2.f * USDM_G5,
                              2.f * USDM_G4, 2.f * USDM_G2, 2.f * USDM_G0};

constexpr float kInvPi = 0.318309873f;
constexpr float kPiHi = 3.14159274f;      // pi rounded to f32
constexpr float kPiLo = -8.74227766e-08f;  // pi - kPiHi
constexpr float kRound = 12582912.f;       // 1.5 * 2^23: adding it rounds to an integer
// sin(r) = r + r z (kS3 + z (kS5 + z (kS7 + z kS9))), z = r^2, on [-pi/2,
// pi/2]: coefficients fitted to the relative error (least squares on
// Chebyshev nodes, reweighted towards minimax), 1.1e-8 before f32 rounding
constexpr float kS3 = -0.166666612f;
constexpr float kS5 = 0.00833310094f;
constexpr float kS7 = -0.000198120179f;
constexpr float kS9 = 2.61099331e-06f;

// sin^2(v) with a relative error of a few f32 ulps: k = rint(v / pi) (exact
// for |v| < 2^22), r = v - k pi in two FMAs (Cody-Waite), then sin(r) for r
// in [-pi/2, pi/2] as an odd polynomial of degree 9: 6 FMA-pipe
// instructions, no MUFU, and an error relative to sin^2 (1/b scales it with
// the output, where __sinf's 2^-21.41 absolute error would not shrink)
__device__ __forceinline__ float sin_sq(float v) {
  const float k = fmaf(v, kInvPi, kRound) - kRound;
  float r = fmaf(-k, kPiHi, v);
  r = fmaf(-k, kPiLo, r);
  const float z = r * r;
  float p = fmaf(z, kS9, kS7);
  p = fmaf(z, p, kS5);
  p = fmaf(z, p, kS3);
  const float s = fmaf(r * z, p, r);
  return s * s;
}

template <int B>
struct Chunk;
template <>
struct Chunk<16> { using type = uint4; };
template <>
struct Chunk<8> { using type = uint2; };
template <>
struct Chunk<4> { using type = uint32_t; };
template <>
struct Chunk<2> { using type = uint16_t; };

// kR samples from p (VEC-byte aligned) as VEC-byte vectors
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&v)[kR]) {
  constexpr int kPer = VEC / (int)sizeof(T);
  using C = typename Chunk<VEC>::type;
#pragma unroll
  for (int c = 0; c < kR / kPer; ++c) {
    const C raw = reinterpret_cast<const C*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) v[c * kPer + i] = usdm::to_f32(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_row(T* p, const float (&v)[kR]) {
  constexpr int kPer = VEC / (int)sizeof(T);
  using C = typename Chunk<VEC>::type;
#pragma unroll
  for (int c = 0; c < kR / kPer; ++c) {
    C raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) usdm::store(e + i, v[c * kPer + i]);
    reinterpret_cast<C*>(p)[c] = raw;
  }
}

struct Task {
  int row;        // b * C + c
  int c;          // channel
  int tile;       // tile of the row
  int t0;         // first output of the tile
  bool interior;  // every sample the warp loads lies in [0, T)
};

__device__ __forceinline__ void place(Task& k, int t_len) {
  k.t0 = k.tile * kTile;
  k.interior = k.t0 >= kR && k.t0 + (kLanes - 1) * kR <= t_len;
}

// this lane's kR samples x[pos .. pos + kR), clamped into the row at the edges
template <typename T, int VEC>
__device__ __forceinline__ void load_task(const T* __restrict__ x, int t_len, const Task& k,
                                          int lane, float (&v)[kR]) {
  const T* xr = x + (long long)k.row * t_len;
  const int pos = k.t0 - kR + lane * kR;
  if (k.interior) {
    load_row<T, VEC>(xr + pos, v);
  } else {
#pragma unroll
    for (int i = 0; i < kR; ++i) v[i] = usdm::to_f32(xr[min(max(pos + i, 0), t_len - 1)]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void compute_task(const T* __restrict__ x, T* __restrict__ y,
                                             const float* __restrict__ alpha,
                                             const float* __restrict__ beta, int t_len,
                                             int logscale, const Task& k, int lane,
                                             const float (&xv)[kR]) {
  float a = alpha[k.c];
  float bb = beta[k.c];
  if (logscale) {
    a = expf(a);
    bb = expf(bb);
  }
  const float inv_b = 1.0f / (bb + 1e-9f);
  auto snake = [a, inv_b](float u) { return u + inv_b * sin_sq(u * a); };
  const int pos = k.t0 - kR + lane * kR;  // this lane's samples pos .. pos + kR - 1

  // the up-space replicate pad: up[m] for m < 0 is up[0], for m >= 2T up[2T - 1]
  float s_first = 0.f, s_last = 0.f;
  if (!k.interior) {
    const T* xr = x + (long long)k.row * t_len;
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      u0 = fmaf(kUp[j], usdm::to_f32(xr[min(max(j - 3, 0), t_len - 1)]), u0);
      u1 = fmaf(kUp[6 + j], usdm::to_f32(xr[min(max(t_len - 3 + j, 0), t_len - 1)]), u1);
    }
    s_first = snake(u0);
    s_last = snake(u1);
  }

  // w[i] = x[pos - 3 + i]
  float w[kR + 6];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = __shfl_up_sync(kFull, xv[kR - 3 + i], 1);
#pragma unroll
  for (int i = 0; i < kR; ++i) w[3 + i] = xv[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[kR + 3 + i] = __shfl_down_sync(kFull, xv[i], 1);
  // s[i] = snake(up[2 pos + i]): this lane's own up-samples
  float s[2 * kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    float e = 0.f, o = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      e = fmaf(kUp[j], w[q + j], e);
      o = fmaf(kUp[6 + j], w[q + 1 + j], o);
    }
    s[2 * q] = snake(e);
    s[2 * q + 1] = snake(o);
  }
  // v[i] = snake(up[2 pos - 5 + i]), i < 2 kR + 10: every up-sample this
  // lane's outputs read
  float v[2 * kR + 10];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[i] = __shfl_up_sync(kFull, s[2 * kR - 5 + i], 1);
#pragma unroll
  for (int i = 0; i < 2 * kR; ++i) v[5 + i] = s[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) v[2 * kR + 5 + i] = __shfl_down_sync(kFull, s[i], 1);
  if (!k.interior) {
    // up-samples outside [0, 2T), whichever lane computed them
#pragma unroll
    for (int i = 0; i < 2 * kR + 10; ++i) {
      const int m = 2 * pos - 5 + i;
      if (m < 0) v[i] = s_first;
      if (m >= 2 * t_len) v[i] = s_last;
    }
  }

  if (lane == 0 || lane == kLanes - 1) return;
  float out[kR];
#pragma unroll
  for (int q = 0; q < kR; ++q) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 12; ++j) acc = fmaf(kG[j], v[2 * q + j], acc);
    out[q] = acc;
  }
  T* yr = y + (long long)k.row * t_len + pos;
  if (k.interior) {
    store_row<T, VEC>(yr, out);
  } else {
#pragma unroll
    for (int q = 0; q < kR; ++q)
      if (pos + q < t_len) usdm::store(yr + q, out[q]);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_snake_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ alpha,
                   const float* __restrict__ beta, int channels, int t_len, int tiles_per_row,
                   int n_tasks, int logscale) {
  const int lane = threadIdx.x & 31;
  int task = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (task >= n_tasks) return;  // warp-uniform
  // tasks are (row, tile) pairs in row-major order; a warp steps by `stride`
  // of them, its row, channel and tile advanced without a division
  const int stride = gridDim.x * kWarps;
  const int d_row = stride / tiles_per_row, d_tile = stride - d_row * tiles_per_row;
  const int d_c = d_row % channels;
  Task cur;
  cur.row = task / tiles_per_row;
  cur.tile = task - cur.row * tiles_per_row;
  cur.c = cur.row % channels;
  place(cur, t_len);
  float xv[kR];
  load_task<T, VEC>(x, t_len, cur, lane, xv);
  for (;;) {
    // the next task's samples are in flight while this one computes
    const bool more = task < n_tasks - stride;
    Task nk = cur;
    float nx[kR];
    if (more) {
      nk.tile += d_tile;
      nk.row += d_row;
      nk.c += d_c;
      if (nk.tile >= tiles_per_row) {
        nk.tile -= tiles_per_row;
        ++nk.row;
        ++nk.c;
      }
      if (nk.c >= channels) nk.c -= channels;
      place(nk, t_len);
      load_task<T, VEC>(x, t_len, nk, lane, nx);
    }
    compute_task<T, VEC>(x, y, alpha, beta, t_len, logscale, cur, lane, xv);
    if (!more) break;
    task += stride;
    cur = nk;
#pragma unroll
    for (int i = 0; i < kR; ++i) xv[i] = nx[i];
  }
}

template <typename T, int VEC>
int launch(const void* x, void* y, const void* alpha, const void* beta, int batch, int channels,
           int t_len, int logscale, cudaStream_t st) {
  auto kern = fused_snake_kernel<T, VEC>;
  static int per_sm = [&] {  // resident blocks per SM, once per instantiation
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tiles_per_row = (t_len + kTile - 1) / kTile;
  const long long n_tasks = (long long)batch * channels * tiles_per_row;
  if (n_tasks > (1LL << 30)) return (int)cudaErrorInvalidValue;
  const int need = (int)((n_tasks + kWarps - 1) / kWarps);
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
  kern<<<blocks, kThreads, 0, st>>>((const T*)x, (T*)y, (const float*)alpha,
                                    (const float*)beta, channels, t_len, tiles_per_row,
                                    (int)n_tasks, logscale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, void* y, const void* alpha, const void* beta, int batch,
               int channels, int t_len, int logscale, cudaStream_t st) {
  switch (vec) {
    case 16:
      return launch<T, 16>(x, y, alpha, beta, batch, channels, t_len, logscale, st);
    case 8:
      return launch<T, 8>(x, y, alpha, beta, batch, channels, t_len, logscale, st);
    case 4:
      return launch<T, 4>(x, y, alpha, beta, batch, channels, t_len, logscale, st);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch<T, 2>(x, y, alpha, beta, batch, channels, t_len, logscale, st);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// vec: the bytes of one vector load or store (16, 8, 4, or 2 for bf16); the
// caller guarantees x, y and every row start are aligned to it.
extern "C" int usdm_fused_snake(const void* x, void* y, const void* alpha, const void* beta,
                                int batch, int channels, int t_len, int logscale, int dtype,
                                int vec, void* stream) {
  if (batch < 1 || channels < 1 || t_len < 1 || t_len > (1 << 29))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)
    return launch_vec<__nv_bfloat16>(vec, x, y, alpha, beta, batch, channels, t_len, logscale,
                                     st);
  if (dtype == usdm::kF32)
    return launch_vec<float>(vec, x, y, alpha, beta, batch, channels, t_len, logscale, st);
  return (int)cudaErrorInvalidValue;
}
