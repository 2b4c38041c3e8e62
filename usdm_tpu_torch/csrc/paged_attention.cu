// K1: paged-KV decode attention for Hopper, split over the KV length.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/paged_attention.py::_decode_kernel
// (wrapper paged_decode_attention).  One query token per slot attends to the
// slot's KV pages, read straight from the pool [Hkv, NT, P, d] through the
// page table [B, maxp] (ids already offset by the layer's region), with an
// online softmax in f32 and an optional sliding window
// (kv_len - 1 - pos <= window).  Only valid, in-window rows are read (rows
// past kv_len may hold anything).
//
// Bound: device-memory bandwidth and, at small batch, memory latency.  Each
// (slot, kv head) reads its K and V rows once (2 * kv_len * d * 2 bytes in
// bf16) for 4 * G * kv_len * d flops: ~2 flops per byte, far below the H100's
// ~295 flop/byte ridge.  A decode step finds the KV of each layer cold in L2.
// The first design (one block per (kv head, slot)) put 8 blocks on 132 SMs
// at batch 1 and paid a 5-level shuffle tree per query head per row.
//
// Design:
//   - grid (Hkv, B, S): the G query heads of a group share every K/V row
//     read, and the slot's valid rows [lo, kv_len) are cut into S contiguous
//     ranges, one per block.  S is chosen by the wrapper from shapes alone
//     (B, Hkv, the table width and the page size), to fill the SMs; each block
//     reads kv_len on the device and takes ceil((kv_len - lo) / S) rows,
//     rounded up to 16, so short and long slots both spread over the splits
//     and no value is read back to the host (the call can be captured in a
//     CUDA graph).  A split past the valid rows writes an empty state.
//   - inside a block, a lane owns 8 dims of a row (16 bytes of bf16, 8 of
//     int8, 32 of f32): a 128-dim row is 16 lanes wide, so a warp holds 2
//     rows and a score needs a 4-level shuffle reduction within the row's
//     lanes (GQA's G heads share it).  Rows are dealt to the block's row
//     streams (d/8-lane groups, rounded up to a power of two) in turn, 4 per
//     stream in flight: at d 128 a block pass reads 32 consecutive rows,
//     coalesced within each page, and each lane issues 4 K and 4 V loads
//     before it uses one.  Page 256 is no special
//     case: rows, not pages, are dealt to the warps.  (mma.sync with G padded
//     to 16 rows would waste 3/4 of each product at G 4, and the products are
//     not what bounds the kernel.)  A head dim is any multiple of 16 up to
//     128: a 16-dim row (the tiny test models') is 2 lanes wide, so a block
//     holds 64 streams, a pass reads 256 rows, and a score takes one
//     shuffle; the streams' states in shared memory stay under 48 KiB.
//   - each stream keeps its own online softmax (base 2, log2(e) folded into
//     the scale); the block merges its streams in shared memory and writes
//     the split's partial state (acc[G][d], m, l) to f32 scratch
//     [B, Hkv, S, G, d + 2] that the wrapper allocates.  A second launch
//     merges the S states of each (slot, head) and writes out in q's dtype.
//     A second launch, and not the last-arriving block through an atomic
//     ticket: a ticket array must be zero before every call (one more memset
//     under a CUDA graph) and needs a fence per block; the launch costs a few
//     microseconds and keeps both kernels free of ordering.
//
// int8 pools (the Pallas kernel's quantized branch): K and V rows are int8
// with f32 per-(head, token) scales in page-major pools [NT, Hkv, P].  The
// scales are folded into the softmax in f32 as the TPU kernel folds them:
// a row's k-scale multiplies its score, its v-scale multiplies its
// probability before the p @ V product (the softmax sum takes the
// probability without it).  A row's scales are read only where its K/V row
// is (valid, in-window rows), so stale or unwritten slots are never read.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;        // dims of a row per lane
constexpr int kInFlight = 4;   // rows per stream whose loads are issued together
constexpr int kRowAlign = 16;  // a split's row count is a multiple of this
constexpr int kMaxSplits = 1024;
constexpr float kLog2e = 1.4426950408889634f;

static __device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 8 elements of a pool row, loaded raw (so a lane's loads of several rows
// are in flight together) and converted at use
template <typename KV>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16> {
  uint4 r;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    r = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { r = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void to_f32(float (&x)[kVec]) const {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<int8_t> {
  uint2 r;
  __device__ __forceinline__ void load(const int8_t* p) { r = *reinterpret_cast<const uint2*>(p); }
  __device__ __forceinline__ void zero() { r = make_uint2(0, 0); }
  __device__ __forceinline__ void to_f32(float (&x)[kVec]) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = usdm::byte_f32(r.x, i);
      x[4 + i] = usdm::byte_f32(r.y, i);
    }
  }
};

template <>
struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ void to_f32(float (&x)[kVec]) const {
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
};

// The rows [r0, r1) of split blockIdx.z of the slot's valid rows
struct SplitRows {
  int r0, r1;
  __device__ __forceinline__ SplitRows(int kv_len, int window) {
    const int lo = window >= 0 ? max(kv_len - 1 - window, 0) : 0;
    const int n_splits = gridDim.z;
    int chunk = (kv_len - lo + n_splits - 1) / n_splits;
    chunk = (chunk + kRowAlign - 1) / kRowAlign * kRowAlign;
    r0 = min(lo + (int)blockIdx.z * chunk, kv_len);
    r1 = min(r0 + chunk, kv_len);
  }
};

// T: q (f32 or bf16); KV: the pools (T, or int8 with scales); GP: the group
// size g rounded up to a power of two (registers are sized by it)
template <typename T, typename KV, int GP>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                   const KV* __restrict__ v_pool, const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales, const int* __restrict__ table,
                   const int* __restrict__ seq_lens, float* __restrict__ part, int hkv, int g,
                   int d, int n_total_pages, int page, int maxp, int window, float scale2,
                   int lanes_log2) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lanes = 1 << lanes_log2;          // lanes of a row: d / 8 up to a power of two
  const int sl = threadIdx.x & (lanes - 1);   // this lane's place in its row
  const int stream = threadIdx.x >> lanes_log2;
  const int n_streams = kThreads >> lanes_log2;
  const int col = sl * kVec;
  const bool col_ok = col < d;

  const SplitRows rows(seq_lens[b], window);

  const T* qb = q + ((size_t)b * hkv + h) * g * d;
  float qr[GP][kVec];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi)
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      qr[gi][e] = gi < g && col_ok ? usdm::to_f32(qb[gi * d + col + e]) * scale2 : 0.f;

  float m[GP], l[GP], acc[GP][kVec];
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) {
    m[gi] = usdm::kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[gi][e] = 0.f;
  }

  const int* tb = table + (size_t)b * maxp;
  const size_t head_base = (size_t)h * n_total_pages;
  const int pass = n_streams * kInFlight;
  // block-uniform trip count: every lane of a warp takes part in the shuffles
  for (int rb = rows.r0; rb < rows.r1; rb += pass) {
    Chunk<KV> kc[kInFlight], vc[kInFlight];
    float ksc[kInFlight], vsc[kInFlight];
    bool ok[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int row = rb + u * n_streams + stream;
      ok[u] = row < rows.r1;
      ksc[u] = vsc[u] = 0.f;
      kc[u].zero();
      vc[u].zero();
      if (ok[u]) {
        const int pid = tb[row / page];
        const int off = row - row / page * page;
        const size_t at = ((head_base + pid) * page + off) * d + col;
        if (col_ok) {
          kc[u].load(k_pool + at);
          vc[u].load(v_pool + at);
        }
        if constexpr (kQuant) {
          const size_t srow = ((size_t)pid * hkv + h) * page + off;
          ksc[u] = k_scales[srow];
          vsc[u] = v_scales[srow];
        }
      }
    }
    // scores: this lane's 8 dims, reduced over the row's lanes
    float sc[kInFlight][GP];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      float x[kVec];
      kc[u].to_f32(x);
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) s = fmaf(qr[gi][e], x[e], s);
        for (int o = lanes >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if constexpr (kQuant) s *= ksc[u];
        sc[u][gi] = ok[u] ? s : usdm::kNegInf;
      }
    }
    // online softmax over these rows, then acc += p * v
#pragma unroll
    for (int gi = 0; gi < GP; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) mx = fmaxf(mx, sc[u][gi]);
      const float alpha = fast_exp2(m[gi] - mx);
      m[gi] = mx;
      l[gi] *= alpha;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[gi][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      float x[kVec];
      vc[u].to_f32(x);
#pragma unroll
      for (int gi = 0; gi < GP; ++gi) {
        float p = ok[u] ? fast_exp2(sc[u][gi] - m[gi]) : 0.f;
        l[gi] += p;
        if constexpr (kQuant) p *= vsc[u];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[gi][e] = fmaf(p, x[e], acc[gi][e]);
      }
    }
  }

  // merge the block's streams -> this split's state [g][d + 2] (acc, m, l)
  extern __shared__ float smem[];  // [n_streams][g][d + 2]
  const int w = d + 2;
  float* mine = smem + stream * g * w;
#pragma unroll
  for (int gi = 0; gi < GP; ++gi) {
    if (gi < g) {
      if (col_ok)
#pragma unroll
        for (int e = 0; e < kVec; ++e) mine[gi * w + col + e] = acc[gi][e];
      if (sl == 0) {
        mine[gi * w + d] = m[gi];
        mine[gi * w + d + 1] = l[gi];
      }
    }
  }
  __syncthreads();
  float* out = part + (((size_t)b * hkv + h) * gridDim.z + blockIdx.z) * g * w;
  for (int i = threadIdx.x; i < g * w; i += kThreads) {
    const int gi = i / w, c = i - gi * w;
    float mx = usdm::kNegInf;
    for (int st = 0; st < n_streams; ++st) mx = fmaxf(mx, smem[(st * g + gi) * w + d]);
    float sum = 0.f;
    if (c == d) {
      sum = mx;
    } else {
      const int src = c == d + 1 ? d + 1 : c;
      for (int st = 0; st < n_streams; ++st) {
        const float* ss = smem + (st * g + gi) * w;
        sum += ss[src] * fast_exp2(ss[d] - mx);
      }
    }
    out[i] = sum;
  }
}

// max (MAX) or sum over the block's threads; every thread gets the result
template <bool MAX>
static __device__ __forceinline__ float block_reduce(float v, float* s_red) {
  v = MAX ? usdm::warp_max(v) : usdm::warp_sum(v);
  __syncthreads();  // s_red may still be read from a previous call
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = s_red[0];
  for (int w = 1; w < kThreads / 32; ++w) v = MAX ? fmaxf(v, s_red[w]) : v + s_red[w];
  return v;
}

// out[b, h, gi, :] = sum_s acc_s 2^(m_s - M) / sum_s l_s 2^(m_s - M), M = max_s m_s.
// One block per (slot, head, query head); thread c < d owns column c.  The
// splits' weights go through shared memory kThreads at a time, and the
// loop over them is unrolled so a thread's loads of several splits are in
// flight together.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out, int hkv, int g, int d,
                     int n_splits) {
  __shared__ float s_w[kThreads];
  __shared__ float s_red[kThreads / 32];
  const int hg = blockIdx.x;  // h * g + gi
  const int b = blockIdx.y;
  const int h = hg / g, gi = hg - h * g;
  const int tid = threadIdx.x;
  const size_t stride = (size_t)g * (d + 2);  // from one split's state to the next
  const float* p = part + ((size_t)b * hkv + h) * n_splits * stride + gi * (d + 2);
  float mx = usdm::kNegInf;
  for (int s = tid; s < n_splits; s += kThreads) mx = fmaxf(mx, p[s * stride + d]);
  mx = block_reduce<true>(mx, s_red);
  float lsum = 0.f;
  for (int s = tid; s < n_splits; s += kThreads)
    lsum += p[s * stride + d + 1] * fast_exp2(p[s * stride + d] - mx);
  lsum = block_reduce<false>(lsum, s_red);
  float a = 0.f;
  for (int s0 = 0; s0 < n_splits; s0 += kThreads) {
    const int n = min(kThreads, n_splits - s0);
    __syncthreads();  // the previous chunk's weights are read
    if (tid < n) s_w[tid] = fast_exp2(p[(s0 + tid) * stride + d] - mx);
    __syncthreads();
    if (tid < d) {
      const float* pc = p + s0 * stride + tid;
#pragma unroll 8
      for (int s = 0; s < n; ++s) a = fmaf(pc[s * stride], s_w[s], a);
    }
  }
  if (tid < d)
    usdm::store(out + (((size_t)b * hkv + h) * g + gi) * d + tid, lsum > 0.f ? a / lsum : 0.f);
}

template <typename T, typename KV, int GP>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool, const void* k_scales,
                   const void* v_scales, const void* table, const void* seq_lens, void* out,
                   float* part, int batch, int hkv, int g, int d, int n_total_pages, int page,
                   int maxp, int window, float scale, int n_splits, cudaStream_t st) {
  int lanes_log2 = 0;
  while ((kVec << lanes_log2) < d) ++lanes_log2;
  const size_t smem = sizeof(float) * (size_t)(kThreads >> lanes_log2) * g * (d + 2);
  paged_split_kernel<T, KV, GP><<<dim3(hkv, batch, n_splits), kThreads, smem, st>>>(
      (const T*)q, (const KV*)k_pool, (const KV*)v_pool, (const float*)k_scales,
      (const float*)v_scales, (const int*)table, (const int*)seq_lens, part, hkv, g, d,
      n_total_pages, page, maxp, window, scale * kLog2e, lanes_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<T><<<dim3(hkv * g, batch), kThreads, 0, st>>>(part, (T*)out, hkv, g, d,
                                                                      n_splits);
  return cudaGetLastError();
}

}  // namespace

// q/out dtype `dtype` (f32 or bf16); pools of `kv_dtype`: the same as q, or
// int8 with f32 scale pools k_scales/v_scales [n_total_pages, hkv, page]
// (null otherwise); part: f32 scratch [batch, hkv, n_splits, g, d + 2].
extern "C" int usdm_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const void* k_scales, const void* v_scales, const void* table,
                                 const void* seq_lens, void* out, void* part, int batch, int hkv,
                                 int g, int d, int n_total_pages, int page, int maxp, int window,
                                 float scale, int n_splits, int dtype, int kv_dtype,
                                 void* stream) {
  if (d % 16 != 0 || d > 128 || g < 1 || g > 8 || page < 1 || batch < 1 || n_splits < 1 ||
      n_splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const bool quant = kv_dtype == usdm::kI8;
  if (quant != (k_scales != nullptr && v_scales != nullptr) || (!quant && kv_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int gp = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  cudaError_t err = cudaErrorInvalidValue;
#define USDM_LAUNCH_G(T, KV, GP)                                                             \
  err = launch<T, KV, GP>(q, k_pool, v_pool, k_scales, v_scales, table, seq_lens, out,       \
                          (float*)part, batch, hkv, g, d, n_total_pages, page, maxp, window, \
                          scale, n_splits, st)
#define USDM_LAUNCH(T, KV)                  \
  if (gp == 1) USDM_LAUNCH_G(T, KV, 1);     \
  else if (gp == 2) USDM_LAUNCH_G(T, KV, 2); \
  else if (gp == 4) USDM_LAUNCH_G(T, KV, 4); \
  else USDM_LAUNCH_G(T, KV, 8)
  if (dtype == usdm::kBF16 && quant) { USDM_LAUNCH(__nv_bfloat16, int8_t); }
  else if (dtype == usdm::kBF16) { USDM_LAUNCH(__nv_bfloat16, __nv_bfloat16); }
  else if (dtype == usdm::kF32 && quant) { USDM_LAUNCH(float, int8_t); }
  else if (dtype == usdm::kF32) { USDM_LAUNCH(float, float); }
#undef USDM_LAUNCH
#undef USDM_LAUNCH_G
  return (int)err;
}
