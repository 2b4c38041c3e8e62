// K2: flash-attention forward for Hopper -- the C entry point, which
// dispatches by dtype, and the f32 route.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/flash_attention.py::_fwd_kernel
// (wrapper flash_attention, forward only).  Blocked online-softmax attention
// with masks taken from POSITIONS and SEGMENT IDS (q_seg == k_seg, q_seg >= 0;
// causal q_pos >= k_pos; window q_pos - k_pos <= window), GQA by mapping head
// h to kv head h / (H / Hkv) with no K/V repeat, optional Voicebox ALiBi
// -2^{-(h+1)*8/H} * |i - j| with key position 0 exempt, and the log-sum-exp
// per row.  Fully-masked rows output 0.
//
// Unlike the Pallas kernel, which skips key blocks by FLAT index (only valid
// when query and key flat indices are aligned), the tile skip here compares
// the position ranges of the tile's valid queries and keys, so chunked prefill
// (queries at start + i against context keys at j) is handled exactly.
// Ragged Tq/Tk are masked in-kernel; no host-side padding.  Operands are
// addressed through strides (last dim contiguous), so [B, T, H, d] and
// [B, H, T, d] layouts, and views of a gathered KV context, need no copy.
//
// One route per dtype.  bf16 operands go to the tensor-core kernel in
// csrc/flash_attention_mma.cu.  f32 operands stay here: the Pallas kernel
// asks for Precision.HIGHEST on f32, which a bf16 mma cannot give, so this
// route multiplies in f32 on the CUDA cores, on tiles staged in shared memory
// (64 query rows x 32 keys per step, 4x2 scores and 4 x d/16 outputs per
// thread).  Attention is bound by operations at the paths' f32 shapes
// (Voicebox B 2 x T 449 x d 64, XLS-R T 2100 x d 80), against the 67 TFLOP/s
// f32 peak off the tensor cores.

#include <limits.h>

#include "mma.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 32;       // keys per inner step
constexpr int kThreads = 256; // 16 row groups x 16 column lanes
constexpr int kMaxDJ = 8;     // head_dim / 16: head_dim <= 128

static __device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

static __device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

using usdm::Strides;

__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, const int* __restrict__ qseg,
                     const int* __restrict__ kseg, int n_heads, int n_kv_heads, int tq, int tk,
                     int d, Strides sq, Strides sk, Strides sv, Strides so, int causal,
                     int window, int alibi, float scale) {
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;  // rows tr*4 .. tr*4+3
  const int tc = tid & 15;  // score cols tc, tc+16; output dims tc + 16*j
  const int dj = d >> 4;
  const int qs_stride = d + 4;
  const int ks_stride = d + 1;
  const int ps_stride = kBK + 1;

  extern __shared__ float smem[];
  float* s_q = smem;                          // [kBQ][d+4]
  float* s_k = s_q + kBQ * qs_stride;         // [kBK][d+1]
  float* s_v = s_k + kBK * ks_stride;         // [kBK][d]
  float* s_p = s_v + kBK * d;                 // [kBQ][kBK+1]
  int* s_qpos = (int*)(s_p + kBQ * ps_stride);
  int* s_qseg = s_qpos + kBQ;
  int* s_kpos = s_qseg + kBQ;
  int* s_kseg = s_kpos + kBK;
  __shared__ int s_range[4];  // valid q min/max, valid k min/max positions

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d, t = q0 + r;
    s_q[r * qs_stride + c] = t < tq ? q[b * sq.b + t * sq.t + h * sq.h + c] : 0.f;
  }
  for (int r = tid; r < kBQ; r += kThreads) {
    const int t = q0 + r;
    s_qpos[r] = t < tq ? qpos[(size_t)b * tq + t] : 0;
    s_qseg[r] = t < tq ? qseg[(size_t)b * tq + t] : -1;
  }
  __syncthreads();
  if (tid < 32) {
    int mn = INT_MAX, mx = INT_MIN;
    for (int r = tid; r < kBQ; r += 32)
      if (s_qseg[r] >= 0) {
        mn = min(mn, s_qpos[r]);
        mx = max(mx, s_qpos[r]);
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (tid == 0) {
      s_range[0] = mn;
      s_range[1] = mx;
    }
  }
  __syncthreads();
  const int q_min = s_range[0];
  const int q_max = s_range[1];
  const float slope = alibi ? exp2f(-(h + 1.0f) * (8.0f / n_heads)) : 0.f;

  float m[4], l[4], acc[4][kMaxDJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = usdm::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; q_min <= q_max && k0 < tk; k0 += kBK) {
    if (tid < kBK) {
      const int t = k0 + tid;
      s_kpos[tid] = t < tk ? kpos[(size_t)b * tk + t] : 0;
      s_kseg[tid] = t < tk ? kseg[(size_t)b * tk + t] : -2;
    }
    __syncthreads();
    if (tid < 32) {  // kBK == 32: one key per lane
      const bool ok = s_kseg[tid] >= 0;
      int mn = ok ? s_kpos[tid] : INT_MAX, mx = ok ? s_kpos[tid] : INT_MIN;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, off));
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      if (tid == 0) {
        s_range[2] = mn;
        s_range[3] = mx;
      }
    }
    __syncthreads();
    // tile skip from positions: no valid key, all keys in the queries'
    // future (causal), or all keys below every query's window
    const int k_min = s_range[2], k_max = s_range[3];
    bool run = k_min <= k_max;
    if (causal) run = run && k_min <= q_max;
    if (window >= 0) run = run && (q_min - k_max <= window);
    if (!run) continue;  // block-uniform

    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d, t = k0 + r;
      const bool in = t < tk;
      s_k[r * ks_stride + c] = in ? k[b * sk.b + t * sk.t + hk * sk.h + c] : 0.f;
      s_v[r * d + c] = in ? v[b * sv.b + t * sv.t + hk * sv.h + c] : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(tr * 4 + i) * qs_stride + c];
      kv[0] = s_k[tc * ks_stride + c];
      kv[1] = s_k[(tc + 16) * ks_stride + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] += qv[i] * kv[0];
        s[i][1] += qv[i] * kv[1];
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      const int qp = s_qpos[r], qsg = s_qseg[r];
      bool ok[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = tc + 16 * j;
        const int kp = s_kpos[col];
        bool a = qsg >= 0 && qsg == s_kseg[col];
        if (causal) a = a && qp >= kp;
        if (window >= 0) a = a && (qp - kp <= window);
        float val = s[i][j] * scale;
        if (alibi && kp != 0) val -= slope * fabsf((float)(qp - kp));
        ok[j] = a;
        s[i][j] = a ? val : usdm::kNegInf;
      }
      const float mx = group16_max(fmaxf(s[i][0], s[i][1]));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p0 = ok[0] ? expf(s[i][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(s[i][1] - m_new) : 0.f;
      l[i] = l[i] * alpha + group16_sum(p0 + p1);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kMaxDJ; ++j) acc[i][j] *= alpha;
      s_p[r * ps_stride + tc] = p0;
      s_p[r * ps_stride + tc + 16] = p1;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(tr * 4 + i) * ps_stride + kk];
#pragma unroll
      for (int j = 0; j < kMaxDJ; ++j) {
        if (j < dj) {
          const float vv = s_v[kk * d + tc + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
    __syncthreads();  // s_k / s_v / s_p are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + tr * 4 + i;
    if (t >= tq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxDJ; ++j)
      if (j < dj) o[b * so.b + t * so.t + h * so.h + tc + 16 * j] = acc[i][j] * inv;
    if (tc == 0) lse[((size_t)b * n_heads + h) * tq + t] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

int launch_f32(const float* q, const float* k, const float* v, float* o, float* lse,
               const usdm::FlashShape& s, Strides sq, Strides sk, Strides sv, Strides so,
               cudaStream_t st) {
  const int d = s.d;
  const size_t smem = sizeof(float) * ((size_t)kBQ * (d + 4) + (size_t)kBK * (d + 1) +
                                       (size_t)kBK * d + (size_t)kBQ * (kBK + 1)) +
                      sizeof(int) * (2 * kBQ + 2 * kBK);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tq + kBQ - 1) / kBQ, s.n_heads, s.batch);
  flash_fwd_f32_kernel<<<grid, kThreads, smem, st>>>(
      q, k, v, o, lse, s.qpos, s.kpos, s.qseg, s.kseg, s.n_heads, s.n_kv_heads, s.tq, s.tk, d,
      sq, sk, sv, so, s.causal, s.window, s.alibi, s.scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int usdm_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* qpos, const void* kpos, const void* qseg,
                              const void* kseg, int batch, int n_heads, int n_kv_heads, int tq,
                              int tk, int d, long long sq_b, long long sq_t, long long sq_h,
                              long long sk_b, long long sk_t, long long sk_h, long long sv_b,
                              long long sv_t, long long sv_h, long long so_b, long long so_t,
                              long long so_h, int causal, int window, int alibi, float scale,
                              int dtype, void* stream) {
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h}, sv{sv_b, sv_t, sv_h},
      so{so_b, so_t, so_h};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // the tensor-core route
    return usdm::flash_fwd_bf16((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, s, sq,
                                sk, sv, so, st);
  if (dtype == usdm::kF32)  // the CUDA-core route
    return launch_f32((const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse,
                      s, sq, sk, sv, so, st);
  return (int)cudaErrorInvalidValue;
}
