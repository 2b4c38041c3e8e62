// K5: flash-attention backward for Hopper (dq and dk/dv kernels) -- the C
// entry points, which dispatch by dtype, and the f32 route.
//
// Replaces the Pallas TPU kernels usdm_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (driven by _bwd_pallas).  Both
// recompute the probabilities from the forward's log-sum-exp,
//   P = exp(S - lse),  S = scale * q.k - alibi,
//   dP = dO.v,  dS = P * (dP - delta) * scale,  delta = rowsum(dO * O),
// with the masks of K2 (csrc/flash_attention.cu): q_seg == k_seg and
// q_seg >= 0 (negative ids are padding), causal q_pos >= k_pos, window
// q_pos - k_pos <= window, and the Voicebox ALiBi -2^{-(h+1)*8/H} * |i - j|
// with key position 0 exempt.  A row with no valid key gets zero gradient.
//
//   dq kernel:  one block per (batch, head, 64-query tile); it walks the
//               32-key tiles and accumulates dQ += dS . K in f32.
//   dkv kernel: one block per (batch, kv head, 64-key tile); it walks the G
//               query heads of its group and their 32-query tiles, and
//               accumulates dV += P^T . dO and dK += dS^T . Q in f32.  dK and
//               dV are written once, with no atomics, so the result does not
//               depend on the order blocks run in.
//
// Unlike the Pallas grids, which clamp and skip tiles by FLAT index (only
// right when query and key flat indices are aligned), each tile skip here
// compares the position ranges of the tile's valid queries and keys, as K2
// does.  Ragged Tq/Tk are masked in-kernel; operands are strided [B, T, H, d]
// views (last dim contiguous); lse and delta are [B, H, Tq] f32.
//
// One route per dtype.  bf16 operands go to the tensor-core kernels in
// csrc/flash_attention_bwd_dq_mma.cu and csrc/flash_attention_bwd_dkv_mma.cu.
// f32 operands stay here (the Pallas kernels ask for Precision.HIGHEST on
// f32, which a bf16 mma cannot give): f32 FMAs on the CUDA cores over tiles
// staged in shared memory, 4 x 2 scores per thread, P and dS never rounded
// below f32.  The backward does 3.5x the forward's multiply-adds (5 products
// of [T, T, d] per head against 2) and is bound by operations, here against
// the 67 TFLOP/s f32 peak off the tensor cores.
// Head dims are multiples of 8 up to 128: column lane tc owns the output
// dims tc + 16 j < d (at d 8 lanes 8-15 accumulate nothing).

#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 256;  // 16 row groups x 16 column lanes
constexpr int kBig = 64;       // rows a block owns (queries for dq, keys for dkv)
constexpr int kStep = 32;      // rows of the other side per inner step
constexpr int kMaxDJ = 8;      // dims a lane owns: tc + 16 j < d <= 128
constexpr int kPs = kStep + 1; // row stride of the [kBig][kStep] score tiles

using usdm::Strides;

using usdm::mma::allowed;    // the mask rules and the position-based tile skip are
using usdm::mma::tile_runs;  // the tensor-core route's

// min/max position of the valid rows (seg >= 0) among n <= 64 rows, by warp 0;
// result in out[0] (min) and out[1] (max); min > max when none is valid.
static __device__ __forceinline__ void valid_range(const int* pos, const int* seg, int n,
                                                   int* out) {
  if (threadIdx.x < 32) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = threadIdx.x; r < n; r += 32)
      if (seg[r] >= 0) {
        mn = min(mn, pos[r]);
        mx = max(mx, pos[r]);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (threadIdx.x == 0) {
      out[0] = mn;
      out[1] = mx;
    }
  }
}

static __device__ __forceinline__ void stage_rows(float* dst, const float* src, Strides s, int b,
                                                  int head, int t0, int n_rows, int t_len,
                                                  int d, int rs) {
  for (int i = threadIdx.x; i < n_rows * d; i += kThreads) {
    const int r = i / d, c = i - r * d, t = t0 + r;
    dst[r * rs + c] = t < t_len ? src[b * s.b + t * s.t + head * s.h + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, const int* __restrict__ qpos,
                        const int* __restrict__ kpos, const int* __restrict__ qseg,
                        const int* __restrict__ kseg, int n_heads, int n_kv_heads, int tq,
                        int tk, int d, Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int causal, int window, int alibi, float scale) {
  const int q0 = blockIdx.x * kBig;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // query rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // key cols tc, tc+16; dq dims tc + 16*j
  const int rs = d + 1;     // odd row stride: lanes reading 16 rows hit 16 banks

  extern __shared__ float smem[];
  float* s_q = smem;                   // [kBig][rs]
  float* s_do = s_q + kBig * rs;       // [kBig][rs]
  float* s_k = s_do + kBig * rs;       // [kStep][rs]
  float* s_v = s_k + kStep * rs;       // [kStep][rs]
  float* s_ds = s_v + kStep * rs;      // [kBig][kPs]
  float* s_lse = s_ds + kBig * kPs;    // [kBig]
  float* s_delta = s_lse + kBig;       // [kBig]
  int* s_qpos = (int*)(s_delta + kBig);
  int* s_qseg = s_qpos + kBig;
  int* s_kpos = s_qseg + kBig;
  int* s_kseg = s_kpos + kStep;
  __shared__ int s_range[4];

  stage_rows(s_q, q, sq, b, h, q0, kBig, tq, d, rs);
  stage_rows(s_do, dout, sdo, b, h, q0, kBig, tq, d, rs);
  for (int r = tid; r < kBig; r += kThreads) {
    const int t = q0 + r;
    const bool in = t < tq;
    s_qpos[r] = in ? qpos[(size_t)b * tq + t] : 0;
    s_qseg[r] = in ? qseg[(size_t)b * tq + t] : -1;
    s_lse[r] = in ? lse[((size_t)b * n_heads + h) * tq + t] : 0.f;
    s_delta[r] = in ? delta[((size_t)b * n_heads + h) * tq + t] : 0.f;
  }
  __syncthreads();
  valid_range(s_qpos, s_qseg, kBig, s_range);
  __syncthreads();
  const int q_min = s_range[0], q_max = s_range[1];
  const float slope = alibi ? exp2f(-(h + 1.0f) * (8.0f / n_heads)) : 0.f;

  float acc[4][kMaxDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; q_min <= q_max && k0 < tk; k0 += kStep) {
    if (tid < kStep) {
      const int t = k0 + tid;
      s_kpos[tid] = t < tk ? kpos[(size_t)b * tk + t] : 0;
      s_kseg[tid] = t < tk ? kseg[(size_t)b * tk + t] : -2;
    }
    __syncthreads();
    valid_range(s_kpos, s_kseg, kStep, s_range + 2);
    __syncthreads();
    if (!tile_runs(q_min, q_max, s_range[2], s_range[3], causal, window)) continue;

    stage_rows(s_k, k, sk, b, hk, k0, kStep, tk, d, rs);
    stage_rows(s_v, v, sv, b, hk, k0, kStep, tk, d, rs);
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
    for (int c = 0; c < d; ++c) {
      const float k0v = s_k[tc * rs + c], k1v = s_k[(tc + 16) * rs + c];
      const float v0v = s_v[tc * rs + c], v1v = s_v[(tc + 16) * rs + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = s_q[(tr * 4 + i) * rs + c];
        const float dov = s_do[(tr * 4 + i) * rs + c];
        s[i][0] += qv * k0v;
        s[i][1] += qv * k1v;
        dp[i][0] += dov * v0v;
        dp[i][1] += dov * v1v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = s_qpos[r], qsg = s_qseg[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tc + 16 * j;
        const int kp = s_kpos[col];
        float ds = 0.f;
        if (allowed(qsg, s_kseg[col], qp, kp, causal, window)) {
          float val = s[i][j] * scale;
          if (alibi && kp != 0) val -= slope * fabsf((float)(qp - kp));
          const float p = expf(val - s_lse[r]);
          ds = p * (dp[i][j] - s_delta[r]) * scale;
        }
        s_ds[r * kPs + col] = ds;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kStep; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = s_ds[(tr * 4 + i) * kPs + kk];
#pragma unroll
      for (int j = 0; j < kMaxDJ; ++j) {
        if (tc + 16 * j < d) {
          const float kv = s_k[kk * rs + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kv;
        }
      }
    }
    __syncthreads();  // s_k / s_v / s_ds are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + tr * 4 + i;
    if (t >= tq) continue;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j)
      if (tc + 16 * j < d) dq[b * sdq.b + t * sdq.t + h * sdq.h + tc + 16 * j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const int* __restrict__ qpos, const int* __restrict__ kpos,
                         const int* __restrict__ qseg, const int* __restrict__ kseg,
                         int n_heads, int n_kv_heads, int tq, int tk, int d, Strides sq,
                         Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                         int causal, int window, int alibi, float scale) {
  const int k0 = blockIdx.x * kBig;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = n_heads / n_kv_heads;
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // key rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // query cols tc, tc+16; dk/dv dims tc + 16*j
  const int rs = d + 1;

  extern __shared__ float smem[];
  float* s_k = smem;                   // [kBig][rs]
  float* s_v = s_k + kBig * rs;        // [kBig][rs]
  float* s_q = s_v + kBig * rs;        // [kStep][rs]
  float* s_do = s_q + kStep * rs;      // [kStep][rs]
  float* s_p = s_do + kStep * rs;      // [kBig][kPs]
  float* s_ds = s_p + kBig * kPs;      // [kBig][kPs]
  float* s_lse = s_ds + kBig * kPs;    // [kStep]
  float* s_delta = s_lse + kStep;      // [kStep]
  int* s_kpos = (int*)(s_delta + kStep);
  int* s_kseg = s_kpos + kBig;
  int* s_qpos = s_kseg + kBig;
  int* s_qseg = s_qpos + kStep;
  __shared__ int s_range[4];

  stage_rows(s_k, k, sk, b, hk, k0, kBig, tk, d, rs);
  stage_rows(s_v, v, sv, b, hk, k0, kBig, tk, d, rs);
  for (int r = tid; r < kBig; r += kThreads) {
    const int t = k0 + r;
    s_kpos[r] = t < tk ? kpos[(size_t)b * tk + t] : 0;
    s_kseg[r] = t < tk ? kseg[(size_t)b * tk + t] : -2;
  }
  __syncthreads();
  valid_range(s_kpos, s_kseg, kBig, s_range + 2);
  __syncthreads();
  const int k_min = s_range[2], k_max = s_range[3];

  float adk[4][kMaxDJ], adv[4][kMaxDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) adk[i][j] = adv[i][j] = 0.f;

  for (int g = 0; k_min <= k_max && g < group; ++g) {
    const int h = hk * group + g;
    const float slope = alibi ? exp2f(-(h + 1.0f) * (8.0f / n_heads)) : 0.f;
    for (int q0 = 0; q0 < tq; q0 += kStep) {
      if (tid < kStep) {
        const int t = q0 + tid;
        const bool in = t < tq;
        s_qpos[tid] = in ? qpos[(size_t)b * tq + t] : 0;
        s_qseg[tid] = in ? qseg[(size_t)b * tq + t] : -1;
        s_lse[tid] = in ? lse[((size_t)b * n_heads + h) * tq + t] : 0.f;
        s_delta[tid] = in ? delta[((size_t)b * n_heads + h) * tq + t] : 0.f;
      }
      __syncthreads();
      valid_range(s_qpos, s_qseg, kStep, s_range);
      __syncthreads();
      if (!tile_runs(s_range[0], s_range[1], k_min, k_max, causal, window)) continue;

      stage_rows(s_q, q, sq, b, h, q0, kStep, tq, d, rs);
      stage_rows(s_do, dout, sdo, b, h, q0, kStep, tq, d, rs);
      __syncthreads();

      float s[4][2], dp[4][2];  // transposed: [key][query]
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
      for (int c = 0; c < d; ++c) {
        const float q0v = s_q[tc * rs + c], q1v = s_q[(tc + 16) * rs + c];
        const float d0v = s_do[tc * rs + c], d1v = s_do[(tc + 16) * rs + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float kv = s_k[(tr * 4 + i) * rs + c];
          const float vv = s_v[(tr * 4 + i) * rs + c];
          s[i][0] += kv * q0v;
          s[i][1] += kv * q1v;
          dp[i][0] += vv * d0v;
          dp[i][1] += vv * d1v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tr * 4 + i;
        const int kp = s_kpos[r], ksg = s_kseg[r];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = tc + 16 * j;
          const int qp = s_qpos[col];
          float p = 0.f, ds = 0.f;
          if (allowed(s_qseg[col], ksg, qp, kp, causal, window)) {
            float val = s[i][j] * scale;
            if (alibi && kp != 0) val -= slope * fabsf((float)(qp - kp));
            p = expf(val - s_lse[col]);
            ds = p * (dp[i][j] - s_delta[col]) * scale;
          }
          s_p[r * kPs + col] = p;
          s_ds[r * kPs + col] = ds;
        }
      }
      __syncthreads();

      for (int qq = 0; qq < kStep; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = s_p[(tr * 4 + i) * kPs + qq];
          dsv[i] = s_ds[(tr * 4 + i) * kPs + qq];
        }
#pragma unroll
        for (int j = 0; j < kMaxDJ; ++j) {
          if (tc + 16 * j < d) {
            const float dov = s_do[qq * rs + tc + 16 * j];
            const float qv = s_q[qq * rs + tc + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              adv[i][j] += pv[i] * dov;
              adk[i][j] += dsv[i] * qv;
            }
          }
        }
      }
      __syncthreads();  // s_q / s_do / s_p / s_ds are rewritten by the next tile
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + tr * 4 + i;
    if (t >= tk) continue;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) {
      if (tc + 16 * j < d) {
        dk[b * sdk.b + t * sdk.t + hk * sdk.h + tc + 16 * j] = adk[i][j];
        dv[b * sdv.b + t * sdv.t + hk * sdv.h + tc + 16 * j] = adv[i][j];
      }
    }
  }
}

size_t dq_smem(int d) {
  const size_t rs = d + 1;
  return sizeof(float) * (2 * kBig * rs + 2 * kStep * rs + kBig * kPs + 2 * kBig) +
         sizeof(int) * (2 * kBig + 2 * kStep);
}

size_t dkv_smem(int d) {
  const size_t rs = d + 1;
  return sizeof(float) * (2 * kBig * rs + 2 * kStep * rs + 2 * kBig * kPs + 2 * kStep) +
         sizeof(int) * (2 * kBig + 2 * kStep);
}

int launch_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                  const float* lse, const float* delta, float* dq, const usdm::FlashShape& s,
                  Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                  cudaStream_t st) {
  const size_t smem = dq_smem(s.d);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tq + kBig - 1) / kBig, s.n_heads, s.batch);
  flash_bwd_dq_f32_kernel<<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, s.qpos, s.kpos, s.qseg, s.kseg, s.n_heads, s.n_kv_heads,
      s.tq, s.tk, s.d, sq, sk, sv, sdo, sdq, s.causal, s.window, s.alibi, s.scale);
  return (int)cudaGetLastError();
}

int launch_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                   const float* lse, const float* delta, float* dk, float* dv,
                   const usdm::FlashShape& s, Strides sq, Strides sk, Strides sv, Strides sdo,
                   Strides sdk, Strides sdv, cudaStream_t st) {
  const size_t smem = dkv_smem(s.d);
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tk + kBig - 1) / kBig, s.n_kv_heads, s.batch);
  flash_bwd_dkv_f32_kernel<<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, s.qpos, s.kpos, s.qseg, s.kseg, s.n_heads,
      s.n_kv_heads, s.tq, s.tk, s.d, sq, sk, sv, sdo, sdk, sdv, s.causal, s.window, s.alibi,
      s.scale);
  return (int)cudaGetLastError();
}

using bf16 = __nv_bfloat16;

}  // namespace

// Strides of q, k, v, dO and the outputs come as (b, t, h) triples, in that
// order; the head_dim axis is contiguous.
extern "C" int usdm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, const void* qpos,
                                 const void* kpos, const void* qseg, const void* kseg,
                                 int batch, int n_heads, int n_kv_heads, int tq, int tk, int d,
                                 const long long* strides, int causal, int window, int alibi,
                                 float scale, int dtype, void* stream) {
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sdo{strides[9], strides[10], strides[11]},
      sdq{strides[12], strides[13], strides[14]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // the tensor-core route
    return usdm::flash_bwd_dq_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                   (const bf16*)dout, (const float*)lse, (const float*)delta,
                                   (bf16*)dq, s, sq, sk, sv, sdo, sdq, st);
  if (dtype == usdm::kF32)  // the CUDA-core route
    return launch_dq_f32((const float*)q, (const float*)k, (const float*)v, (const float*)dout,
                         (const float*)lse, (const float*)delta, (float*)dq, s, sq, sk, sv, sdo,
                         sdq, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int usdm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* qpos, const void* kpos, const void* qseg,
                                  const void* kseg, int batch, int n_heads, int n_kv_heads,
                                  int tq, int tk, int d, const long long* strides, int causal,
                                  int window, int alibi, float scale, int dtype, void* stream) {
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sdo{strides[9], strides[10], strides[11]},
      sdk{strides[12], strides[13], strides[14]}, sdv{strides[15], strides[16], strides[17]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // the tensor-core route
    return usdm::flash_bwd_dkv_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                    (const bf16*)dout, (const float*)lse, (const float*)delta,
                                    (bf16*)dk, (bf16*)dv, s, sq, sk, sv, sdo, sdk, sdv, st);
  if (dtype == usdm::kF32)  // the CUDA-core route
    return launch_dkv_f32((const float*)q, (const float*)k, (const float*)v,
                          (const float*)dout, (const float*)lse, (const float*)delta,
                          (float*)dk, (float*)dv, s, sq, sk, sv, sdo, sdk, sdv, st);
  return (int)cudaErrorInvalidValue;
}
