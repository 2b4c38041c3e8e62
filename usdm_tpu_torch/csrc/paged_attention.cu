// K1: paged-KV decode attention for Hopper.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/paged_attention.py::_decode_kernel
// (wrapper paged_decode_attention).  One query token per slot attends to the
// slot's KV pages, read straight from the pool [Hkv, NT, P, d] through the
// page table [B, maxp] (ids already offset by the layer's region), with an
// online softmax in f32 and an optional sliding window
// (kv_len - 1 - pos <= window).
//
// Bound: device-memory bandwidth and, at batch 1, memory latency.  Each
// (slot, kv head) reads its K and V pages once (2 * kv_len * d * 2 bytes in
// bf16) for 4 * G * kv_len * d flops: ~2 flops per byte, far below the H100's
// ~295 flop/byte ridge.  A decode step finds the KV of each layer cold in L2.
// Design: one block per (kv head, slot), so the G query heads of a group
// share every K/V page read.  The block's 8 warps walk different pages at
// once, each with its own online softmax, and every lane issues the loads of
// 8 rows before using them, so many row loads are in flight per SM; the
// warps' partial results are merged at the end.  Only valid, in-window rows
// are read (rows past kv_len may hold anything).  At batch 1 this still uses
// only Hkv = 8 of the 132 SMs: splitting the KV length across blocks
// (split-K with a combine pass) is the next performance step.
//
// int8 pools (the Pallas kernel's quantized branch): K and V rows are int8
// with f32 per-(head, token) scales in page-major pools [NT, Hkv, P].  The
// scales are folded into the softmax in f32 as the TPU kernel folds them:
// a row's k-scale multiplies its score, its v-scale multiplies its
// probability before the p @ V product (the softmax sum takes the
// probability without it).  A row's scales are read only where its K/V row
// is (valid, in-window rows), so stale or unwritten slots are never read.
// Page traffic halves against bf16; the scale rows add 8 bytes per token and
// head.  Shared memory is the same f32 score and accumulator staging as
// bf16: 8 warps x G x (page + d) x 4 bytes, 24 KiB at page 64 and 48 KiB at
// page 256 (G 4, d 128), past the 48 KiB default with the static merge
// arrays, so the launch raises the kernel's dynamic limit when needed.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;  // query heads per kv head
constexpr int kMaxE = 4;  // head_dim / 32: head_dim <= 128
constexpr int kRows = 8;  // rows whose loads a lane issues together
constexpr int kMaxSmem = 96 * 1024;  // dynamic shared memory the launch may ask for

// T: q and out (f32 or bf16); KV: the pools (T, or int8 with scales)
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                    const KV* __restrict__ v_pool, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ table,
                    const int* __restrict__ seq_lens, T* __restrict__ out, int hkv, int g, int d,
                    int n_total_pages, int page, int maxp, int window, float scale) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int e_per_lane = d >> 5;  // this lane's dims: lane*E .. lane*E + E - 1

  extern __shared__ float smem[];
  float* s_p = smem + warp * g * page;                    // [kWarps][g][page]
  float* s_acc = smem + kWarps * g * page;                // [kWarps][g][d]
  __shared__ float s_m[kWarps][kMaxG];
  __shared__ float s_l[kWarps][kMaxG];

  const int kv_len = seq_lens[b];
  const T* qb = q + ((size_t)b * hkv + h) * g * d;
  float qr[kMaxG][kMaxE];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
    for (int e = 0; e < kMaxE; ++e)
      qr[gi][e] = (gi < g && e < e_per_lane)
                      ? usdm::to_f32(qb[gi * d + lane * e_per_lane + e]) * scale
                      : 0.f;

  float m[kMaxG], l[kMaxG], acc[kMaxG][kMaxE];
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    m[gi] = usdm::kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kMaxE; ++e) acc[gi][e] = 0.f;
  }

  const int first_valid = window >= 0 ? max(kv_len - 1 - window, 0) : 0;
  const int first_page = first_valid / page;
  const int last_page = (kv_len - 1) / page;

  for (int pg = first_page + warp; pg <= last_page; pg += kWarps) {
    const int pid = table[(size_t)b * maxp + pg];
    const size_t base = ((size_t)h * n_total_pages + pid) * page * d + lane * e_per_lane;
    const KV* kp = k_pool + base;
    const KV* vp = v_pool + base;
    const size_t srow = ((size_t)pid * hkv + h) * page;  // this page's scale row
    const int j0 = max(first_valid - pg * page, 0);
    const int j1 = min(kv_len - pg * page, page);

    // scores of kRows rows at a time; d split over lanes, warp-reduced
    for (int j = j0; j < j1; j += kRows) {
      float kr[kRows][kMaxE];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kMaxE; ++e)
          kr[r][e] = (j + r < j1 && e < e_per_lane)
                         ? usdm::to_f32(kp[(size_t)(j + r) * d + e]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float ksc = 1.f;
        if constexpr (kQuant) ksc = j + r < j1 ? k_scales[srow + j + r] : 0.f;
#pragma unroll
        for (int gi = 0; gi < kMaxG; ++gi) {
          if (gi < g) {
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < kMaxE; ++e) s += qr[gi][e] * kr[r][e];
            s = usdm::warp_sum(s);
            if constexpr (kQuant) s *= ksc;
            if (lane == 0 && j + r < j1) s_p[gi * page + j + r] = s;
          }
        }
      }
    }
    __syncwarp();

    // online-softmax update of this warp's state
    float alpha[kMaxG];
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi) {
      alpha[gi] = 1.f;
      if (gi < g) {
        float mx = usdm::kNegInf;
        for (int j = j0 + lane; j < j1; j += 32) mx = fmaxf(mx, s_p[gi * page + j]);
        const float m_new = fmaxf(m[gi], usdm::warp_max(mx));
        float sum = 0.f;
        for (int j = j0 + lane; j < j1; j += 32) {
          const float p = expf(s_p[gi * page + j] - m_new);
          s_p[gi * page + j] = p;
          sum += p;
        }
        alpha[gi] = expf(m[gi] - m_new);
        l[gi] = l[gi] * alpha[gi] + usdm::warp_sum(sum);
        m[gi] = m_new;
      }
    }
    __syncwarp();

    // acc = acc * alpha + p @ V over this lane's dims, kRows rows at a time
#pragma unroll
    for (int gi = 0; gi < kMaxG; ++gi)
#pragma unroll
      for (int e = 0; e < kMaxE; ++e) acc[gi][e] *= alpha[gi];
    for (int j = j0; j < j1; j += kRows) {
      float vr[kRows][kMaxE];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < kMaxE; ++e)
          vr[r][e] = (j + r < j1 && e < e_per_lane)
                         ? usdm::to_f32(vp[(size_t)(j + r) * d + e]) : 0.f;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (j + r < j1) {
          float vsc = 1.f;
          if constexpr (kQuant) vsc = v_scales[srow + j + r];
#pragma unroll
          for (int gi = 0; gi < kMaxG; ++gi) {
            if (gi < g) {
              float p = s_p[gi * page + j + r];
              if constexpr (kQuant) p *= vsc;
#pragma unroll
              for (int e = 0; e < kMaxE; ++e) acc[gi][e] += p * vr[r][e];
            }
          }
        }
      }
    }
    __syncwarp();  // s_p is rewritten by this warp's next page
  }

  // merge the warps' partial softmax states
#pragma unroll
  for (int gi = 0; gi < kMaxG; ++gi) {
    if (gi < g) {
#pragma unroll
      for (int e = 0; e < kMaxE; ++e)
        if (e < e_per_lane) s_acc[(warp * g + gi) * d + lane * e_per_lane + e] = acc[gi][e];
      if (lane == 0) {
        s_m[warp][gi] = m[gi];
        s_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * hkv + h) * g * d;
  for (int i = tid; i < g * d; i += kThreads) {
    const int gi = i / d;
    float mx = usdm::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, s_m[w][gi]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(s_m[w][gi] - mx);
      lsum += s_l[w][gi] * c;
      a += s_acc[(w * g + gi) * d + (i - gi * d)] * c;
    }
    usdm::store(ob + i, lsum > 0.f ? a / lsum : 0.f);
  }
}

template <typename T, typename KV>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
                   const void* v_scales, const void* table, const void* seq_lens, void* out,
                   int batch, int hkv, int g, int d, int n_total_pages, int page, int maxp,
                   int window, float scale, size_t smem, cudaStream_t st) {
  auto kern = paged_decode_kernel<T, KV>;
  static size_t allowed = 48 * 1024 - 2 * sizeof(float) * kWarps * kMaxG;  // static arrays
  if (smem > allowed) {
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    allowed = kMaxSmem;
  }
  kern<<<dim3(hkv, batch), kThreads, smem, st>>>(
      (const T*)q, (const KV*)k_pool, (const KV*)v_pool, (const float*)k_scales,
      (const float*)v_scales, (const int*)table, (const int*)seq_lens, (T*)out, hkv, g, d,
      n_total_pages, page, maxp, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q/out dtype `dtype` (f32 or bf16); pools of `kv_dtype`: the same as q, or
// int8 with f32 scale pools k_scales/v_scales [n_total_pages, hkv, page]
// (null otherwise).
extern "C" int usdm_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scales, const void* v_scales, const void* table,
                                 const void* seq_lens, void* out, int batch, int hkv, int g,
                                 int d, int n_total_pages, int page, int maxp, int window,
                                 float scale, int dtype, int kv_dtype, void* stream) {
  if (d % 32 != 0 || d > 32 * kMaxE || g < 1 || g > kMaxG || page < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kWarps * g * (page + d);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == usdm::kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr) || (!quant && kv_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;
#define USDM_LAUNCH(T, KV)                                                                   \
  err = launch<T, KV>(q, k_pool, v_pool, k_scales, v_scales, table, seq_lens, out, batch, hkv, \
                      g, d, n_total_pages, page, maxp, window, scale, smem, st)
  if (dtype == usdm::kBF16 && quant) USDM_LAUNCH(__nv_bfloat16, int8_t);
  else if (dtype == usdm::kBF16) USDM_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  else if (dtype == usdm::kF32 && quant) USDM_LAUNCH(float, int8_t);
  else if (dtype == usdm::kF32) USDM_LAUNCH(float, float);
#undef USDM_LAUNCH
  return (int)err;
}
