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
// addressed through strides (last dim contiguous, rows on 16-byte
// boundaries), so [B, T, H, d] and [B, H, T, d] layouts, and views of a
// gathered KV context, need no copy.
//
// One route per dtype.  bf16 operands go to the tensor-core kernel in
// csrc/flash_attention_mma.cu.  f32 operands take the route below, also on
// the tensor cores: the Pallas kernel asks for Precision.HIGHEST on f32,
// which one TF32 product (10 mantissa bits, ~3 digits) cannot give, so every
// product is 3xTF32, the scheme of CUTLASS's OpMultiplyAddFastF32: each f32
// operand x splits as big = tf32(x), small = tf32(x - big), and a . b is
// small.big + big.small + big.big in f32 accumulators (the small.small term,
// ~2^-22 of the product, is dropped).  Both S = Q.K^T and O = P.V are done
// so, P split in registers after the softmax.
//
// Bound: at the paths' f32 shapes (Voicebox B 2 x T 449 x 16 heads of d 64,
// XLS-R T 2100 x 16 heads of d 80) attention is bound by operations: three
// TF32 products per f32 product against the 495 TFLOP/s TF32 peak.  The
// kernel keeps PR 5's bf16 structure (csrc/mma.cuh): one block of 4 warps per
// (batch, head, 64 queries), 16 query rows per warp; a once-per-block scan of
// every key tile's position and segment ranges, from which dead tiles are
// skipped before their K/V is loaded and fully-allowed tiles take the
// mask-free path; base-2 softmax with log2(e) folded into the scale, the slope
// and the log-sum-exp; K and V tiles of 64 keys in a two-stage cp.async ring,
// one barrier a step.  What differs from bf16:
//   - mma.sync.m16n8k8 with tf32 operands, which ldmatrix (16-bit elements)
//     cannot load: fragments come by 32-bit-element ld.shared.  The reduced
//     axis of every product is permuted inside each step of 8 (the sum does
//     not care in which order it adds), so a lane's elements sit side by
//     side: one float4 of K gives the B operands of two k-steps of Q.K^T,
//     the S accumulator of keys 8j..8j+7 is the A operand of P.V's k-step j as
//     it stands, and one float2 of V gives B operands of two output n-tiles
//     (output columns permuted within each 16, undone by the float4 store).
//   - Q's 16 rows per warp stay in registers as f32 (d / 2 values a lane) and
//     are split per step; the K and V tiles are unpadded [64][D] f32 with
//     their 16-byte chunks XOR-swizzled by row (K: chunk ^ (row & 1) << 2, V:
//     chunk ^ (row & 6)), which keeps the float4 reads of 8-lane phases and
//     the float2 reads of 16-lane phases free of bank conflicts.
//   - f32 tiles take twice bf16's shared memory: two stages of K and V are
//     32 KiB per 16 head dims, 64 KiB at D 64, 96 KiB at D 96, 128 KiB at
//     D 128.  Registers (ptxas: 176 at D 64, 251 at D 96, 255 with 324 bytes
//     of spill at D 128) hold D 64 and D 96 to 2 blocks (8 warps) an SM,
//     shared memory D 128 to 1; no path runs the f32 route at d 128.
//   - the splits round with two integer operations instead of
//     cvt.rna.tf32.f32 (the same bits for finite values): ptxas expands the
//     conversion into compares and selects for the special values (FSETP and
//     SEL led the SASS), and on an H100 that form took 0.79-0.80 ms at XLS-R's
//     shape (chip_smoke.py case (c)) against 0.54-0.55 ms.
// Head dims (multiples of 8) that are not 32, 64, 96 or 128 run at the next
// of those widths with zero-filled columns (XLS-R's d 80 at 96, the tiny
// models' d 8 and 16 at 32), as the bf16 route does.  The splits, the
// products, the swizzles and the tile loader are in csrc/tf32.cuh, shared
// with the f32 backward.

#include "tf32.cuh"

namespace usdm {
namespace {

using namespace mma;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, FlashShape s, Strides sq, Strides sk, Strides sv,
                      Strides so) {
  constexpr int kE = kTile * D;  // floats of one K or V tile
  constexpr int kC = D / 16;     // 16-column chunks of a row
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (s.n_heads / s.n_kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // the fragments' group and thread-in-group

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);          // 2 stages [64][D], swizzled
  float* s_v = s_k + 2 * kE;                            // 2 stages [64][D], swizzled
  int* s_kpos = reinterpret_cast<int*>(s_v + 2 * kE);   // [2][64]
  int* s_kseg = s_kpos + 2 * kTile;
  int4* s_info = reinterpret_cast<int4*>(s_kseg + 2 * kTile);  // [key tiles]

  const int* qpos = s.qpos + (size_t)b * s.tq;
  const int* qseg = s.qseg + (size_t)b * s.tq;
  const int* kpos = s.kpos + (size_t)b * s.tk;
  const int* kseg = s.kseg + (size_t)b * s.tk;
  const F32Loader<D, 0> load_k(k + b * sk.b + hk * sk.h, sk.t, s.d);
  const F32Loader<D, 1> load_v(v + b * sv.b + hk * sv.h, sv.t, s.d);

  const TileInfo own = scan_rows(qpos, qseg, q0, s.tq, -1);
  // this lane's two query rows, and its columns 16c + 4t4 .. + 3 of each
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qp[2] = {r0 < s.tq ? qpos[r0] : 0, r1 < s.tq ? qpos[r1] : 0};
  const int qs[2] = {r0 < s.tq ? qseg[r0] : -1, r1 < s.tq ? qseg[r1] : -1};
  float4 qa[kC], qb[kC];
  {
    const float* qh = q + b * sq.b + h * sq.h;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = c * 16 + t4 * 4;
      qa[c] = r0 < s.tq && col < s.d ? *reinterpret_cast<const float4*>(qh + r0 * sq.t + col)
                                     : zero;
      qb[c] = r1 < s.tq && col < s.d ? *reinterpret_cast<const float4*>(qh + r1 * sq.t + col)
                                     : zero;
    }
  }
  const float scale2 = s.scale * kLog2e;
  const float slope2 = s.alibi ? alibi_slope2(h, s.n_heads) : 0.f;

  const int n_tiles = own.pmin <= own.pmax ? (s.tk + kTile - 1) / kTile : 0;
  scan_tiles(kpos, kseg, s.tk, -2, s_info, n_tiles);
  __syncthreads();
  auto next_tile = [&](int t) {
    for (; t < n_tiles; ++t) {
      const TileInfo ki = tile_info(s_info, t);
      if (tile_runs(own.pmin, own.pmax, ki.pmin, ki.pmax, s.causal, s.window)) break;
    }
    return t;
  };
  auto prefetch = [&](int t, int stage) {
    load_k.load(smem_u32(s_k + stage * kE), t * kTile, s.tk);
    load_v.load(smem_u32(s_v + stage * kE), t * kTile, s.tk);
    void* const dst[2] = {s_kpos + stage * kTile, s_kseg + stage * kTile};
    const void* const src[2] = {kpos, kseg};
    load_rows<2>(dst, src, t * kTile, s.tk);
    cp_async_commit();
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  // K: row 8n + g, chunk 4c + t4 (its columns 16c + 4t4 .. + 3) -- the B
  // operands of k-steps 2c and 2c + 1; the row's parity is g's
  const float* k_lane = s_k + g * D + t4 * 4;
  const int k_swz = g & 1;
  // V: rows 8j + 2t4 and + 1, columns 16c + 2g, + 1 (chunk 4c + g / 2) -- the
  // B operands of output n-tiles 2c and 2c + 1; both rows have row & 6 == 2t4
  const int v_w = (g >> 1) ^ (2 * t4);
  const float* v_lane = s_v + 2 * t4 * D + (g & 1) * 2;

  int t = next_tile(0);
  if (t < n_tiles) prefetch(t, 0);
  for (int stage = 0; t < n_tiles; stage ^= 1) {
    const int tn = next_tile(t + 1);
    cp_async_wait_all();
    __syncthreads();  // tile t has landed, and every warp is done with tile t's predecessor
    if (tn < n_tiles) prefetch(tn, stage ^ 1);  // overlaps this tile's products

    // S = Q.K^T: in step 2c, a lane's k = t4 / t4 + 4 are columns 16c + 4t4 / + 1;
    // in step 2c + 1, 16c + 4t4 + 2 / + 3
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const float* kt = k_lane + stage * kE;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const SplitA a0(qa[c].x, qb[c].x, qa[c].y, qb[c].y);
      const SplitA a1(qa[c].z, qb[c].z, qa[c].w, qb[c].w);
      const int off = (c ^ k_swz) * 16;  // chunk (4c + t4) ^ (k_swz << 2)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float4 kv = *reinterpret_cast<const float4*>(kt + n * 8 * D + off);
        mma_3xtf32(sc[n], a0, kv.x, kv.y);
        mma_3xtf32(sc[n], a1, kv.z, kv.w);
      }
    }

    const int* kp_s = s_kpos + stage * kTile;
    const int* ks_s = s_kseg + stage * kTile;
    const int cols = s.tk - t * kTile;
    const bool full = tile_full(own, tile_info(s_info, t), s.causal, s.window);
#define STEP(FULL, ALIBI)                                                                    \
  softmax_step<D, FULL, ALIBI>(sc, acc, m, l, kp_s, ks_s, cols, qp, qs, s.causal, s.window, \
                               scale2, slope2)
    if (s.alibi) {
      if (full) STEP(true, true); else STEP(false, true);
    } else {
      if (full) STEP(true, false); else STEP(false, false);
    }
#undef STEP

    // O += P.V: in k-step j, a lane's k = t4 / t4 + 4 are keys 8j + 2t4 / + 1,
    // which is where the S accumulator of n-tile j holds them
    const float* vt = v_lane + stage * kE;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const SplitA p(sc[j][0], sc[j][2], sc[j][1], sc[j][3]);
      const float* vr = vt + j * 8 * D;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int off = (8 * (c >> 1) + ((4 * (c & 1)) ^ v_w)) * 4;
        const float2 x0 = *reinterpret_cast<const float2*>(vr + off);
        const float2 x1 = *reinterpret_cast<const float2*>(vr + D + off);
        mma_3xtf32(acc[2 * c], p, x0.x, x1.x);
        mma_3xtf32(acc[2 * c + 1], p, x0.y, x1.y);
      }
    }
    t = tn;
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  const float f0 = l[0] > 0.f ? 1.f / l[0] : 0.f, f1 = l[1] > 0.f ? 1.f / l[1] : 0.f;
  // n-tiles 2c and 2c + 1 hold columns 16c + 4t4 + {0, 2} and + {1, 3}
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int col = c * 16 + t4 * 4;
    if (col >= s.d) break;
    if (r0 < s.tq)
      *reinterpret_cast<float4*>(ob + r0 * so.t + col) =
          make_float4(acc[2 * c][0] * f0, acc[2 * c + 1][0] * f0, acc[2 * c][1] * f0,
                      acc[2 * c + 1][1] * f0);
    if (r1 < s.tq)
      *reinterpret_cast<float4*>(ob + r1 * so.t + col) =
          make_float4(acc[2 * c][2] * f1, acc[2 * c + 1][2] * f1, acc[2 * c][3] * f1,
                      acc[2 * c + 1][3] * f1);
  }
  if (t4 == 0) {  // m is in base 2; a row with no valid key keeps -1e30 as it is
    float* lse_b = lse + ((size_t)b * s.n_heads + h) * s.tq;
    if (r0 < s.tq)
      lse_b[r0] = (m[0] > 0.5f * kNegInf ? m[0] * kLn2 : kNegInf) + logf(fmaxf(l[0], 1e-30f));
    if (r1 < s.tq)
      lse_b[r1] = (m[1] > 0.5f * kNegInf ? m[1] * kLn2 : kNegInf) + logf(fmaxf(l[1], 1e-30f));
  }
}

template <int D>
int launch_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                const FlashShape& s, Strides sq, Strides sk, Strides sv, Strides so,
                cudaStream_t st) {
  const int smem = 4 * kTile * D * (int)sizeof(float) + 4 * kTile * (int)sizeof(int) +
                   tile_info_bytes(s.tk);
  cudaError_t err = allow_smem(flash_fwd_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_fwd_tf32_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, s, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

int flash_fwd_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                  const FlashShape& s, Strides sq, Strides sk, Strides sv, Strides so,
                  cudaStream_t st) {
#define CALL(DD) return launch_tf32<DD>(q, k, v, o, lse, s, sq, sk, sv, so, st)
  USDM_FLASH_DISPATCH_D(s.d, CALL)
#undef CALL
}

}  // namespace
}  // namespace usdm

extern "C" int usdm_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* qpos, const void* kpos, const void* qseg,
                              const void* kseg, int batch, int n_heads, int n_kv_heads, int tq,
                              int tk, int d, long long sq_b, long long sq_t, long long sq_h,
                              long long sk_b, long long sk_t, long long sk_h, long long sv_b,
                              long long sv_t, long long sv_h, long long so_b, long long so_t,
                              long long so_h, int causal, int window, int alibi, float scale,
                              int dtype, void* stream) {
  using usdm::Strides;
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{sq_b, sq_t, sq_h}, sk{sk_b, sk_t, sk_h}, sv{sv_b, sv_t, sv_h},
      so{so_b, so_t, so_h};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // bf16 operands, one product per product
    return usdm::flash_fwd_bf16((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                                (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, s, sq,
                                sk, sv, so, st);
  if (dtype == usdm::kF32)  // 3xTF32
    return usdm::flash_fwd_f32((const float*)q, (const float*)k, (const float*)v, (float*)o,
                               (float*)lse, s, sq, sk, sv, so, st);
  return (int)cudaErrorInvalidValue;
}
