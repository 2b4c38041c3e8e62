// K2, bf16 route: flash-attention forward on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/flash_attention.py::_fwd_kernel
// for bf16 operands (the f32 route is csrc/flash_attention.cu, which also
// holds the C entry point that dispatches by dtype).  Same function: blocked
// online-softmax attention, masks from POSITIONS and SEGMENT IDS, GQA by
// head h -> kv head h / (H / Hkv), optional Voicebox ALiBi with key position
// 0 exempt, the log-sum-exp per row, fully-masked rows output 0.  Like the
// Pallas kernel it feeds the matrix unit bf16 operands with f32 accumulation
// and rounds the probabilities to bf16 before P.V; the row sum is taken from
// the unrounded probabilities.
//
// Bound: at the paths' shapes (B 8 x T 1379 x 16 heads of d 64 in training;
// Tq 512 x Tk 2048, GQA 32/8, d 128 in prefill) attention is bound by
// operations, so both products run as mma.sync.m16n8k16 (csrc/mma.cuh):
//   - one block of 4 warps per (batch, head, 64 queries); a warp owns 16 query
//     rows and keeps its 16 x D output, row max and row sum in registers;
//   - K and V tiles of 64 keys arrive by 16-byte cp.async into a two-stage
//     ring of padded shared-memory tiles, so the next tile's load overlaps
//     this tile's products; Q's 64 rows are loaded once;
//   - S = Q.K^T lands in the m16n8 accumulator layout, where the mask, ALiBi
//     and the online softmax are applied (row reductions over the 4 lanes of
//     a quad); the rounded probabilities are the next product's A operand as
//     they stand, without a trip through shared memory;
//   - the position and segment ranges of every key tile are scanned once per
//     block; from them, tiles that no mask lets through are skipped before
//     their K/V is loaded, and tiles in which every pair passes every mask
//     (most of them) take a path without mask tests;
//   - the softmax runs in base 2 with log2(e) folded into the scale and the
//     ALiBi slope, so a probability costs one multiply-add and one ex2.
// Ragged Tq/Tk are zero-filled and masked in-kernel; operands are strided
// [B, T, H, d] views whose rows start on 16-byte boundaries (the wrapper
// checks); head dims (multiples of 8) that are not 32, 64, 96 or 128 run at
// the next of those widths with zero-filled columns: the tiny test models'
// d 8 and d 16 at 32, whose zero columns add nothing to Q.K^T and whose
// output columns past d are not stored.

#include "mma.cuh"

namespace usdm {
namespace {

using namespace mma;

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, FlashShape s, Strides sq, Strides sk, Strides sv,
                     Strides so) {
  constexpr int kE = Tile<D>::kElems;
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (s.n_heads / s.n_kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);  // [64][D+8]
  __nv_bfloat16* s_k = s_q + kE;                                // 2 stages
  __nv_bfloat16* s_v = s_k + 2 * kE;                            // 2 stages
  int* s_kpos = reinterpret_cast<int*>(s_v + 2 * kE);           // [2][64]
  int* s_kseg = s_kpos + 2 * kTile;
  int4* s_info = reinterpret_cast<int4*>(s_kseg + 2 * kTile);   // [key tiles]

  const int* qpos = s.qpos + (size_t)b * s.tq;
  const int* qseg = s.qseg + (size_t)b * s.tq;
  const int* kpos = s.kpos + (size_t)b * s.tk;
  const int* kseg = s.kseg + (size_t)b * s.tk;
  const TileLoader<D> load_k(k + b * sk.b + hk * sk.h, sk.t, s.d);
  const TileLoader<D> load_v(v + b * sv.b + hk * sv.h, sv.t, s.d);

  const TileInfo own = scan_rows(qpos, qseg, q0, s.tq, -1);
  // this lane's two query rows
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qp[2] = {r0 < s.tq ? qpos[r0] : 0, r1 < s.tq ? qpos[r1] : 0};
  const int qs[2] = {r0 < s.tq ? qseg[r0] : -1, r1 < s.tq ? qseg[r1] : -1};
  const float scale2 = s.scale * kLog2e;
  const float slope2 = s.alibi ? alibi_slope2(h, s.n_heads) : 0.f;

  const int n_tiles = own.pmin <= own.pmax ? (s.tk + kTile - 1) / kTile : 0;
  scan_tiles(kpos, kseg, s.tk, -2, s_info, n_tiles);
  __syncthreads();
  // the first key tile at or after t that some (query, key) pair passes
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

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this lane's share of the row sum
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int t = next_tile(0);
  if (t < n_tiles) {
    // joins the first group
    TileLoader<D>(q + b * sq.b + h * sq.h, sq.t, s.d).load(smem_u32(s_q), q0, s.tq);
    prefetch(t, 0);
  }
  for (int stage = 0; t < n_tiles; stage ^= 1) {
    const int tn = next_tile(t + 1);
    cp_async_wait_all();
    __syncthreads();  // tile t has landed, and every warp is done with tile t's predecessor
    if (tn < n_tiles) prefetch(tn, stage ^ 1);  // overlaps this tile's products

    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    gemm_nt<D>(sc, s_q, warp * 16, s_k + stage * kE);

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
    uint32_t p[4][4];
    pack_operand(p, sc);
    gemm_reg_nn<D>(acc, p, s_v + stage * kE);
    t = tn;
  }

  l[0] = quad_sum(l[0]);
  l[1] = quad_sum(l[1]);
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  store_rows<D>(acc, r0 < s.tq ? ob + r0 * so.t : nullptr, r1 < s.tq ? ob + r1 * so.t : nullptr,
                s.d, l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f);
  if ((lane & 3) == 0) {  // m is in base 2; a row with no valid key keeps -1e30 as it is
    float* lse_b = lse + ((size_t)b * s.n_heads + h) * s.tq;
    if (r0 < s.tq)
      lse_b[r0] = (m[0] > 0.5f * kNegInf ? m[0] * kLn2 : kNegInf) + logf(fmaxf(l[0], 1e-30f));
    if (r1 < s.tq)
      lse_b[r1] = (m[1] > 0.5f * kNegInf ? m[1] * kLn2 : kNegInf) + logf(fmaxf(l[1], 1e-30f));
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
           __nv_bfloat16* o, float* lse, const FlashShape& s, Strides sq, Strides sk, Strides sv,
           Strides so, cudaStream_t st) {
  const int smem = 5 * Tile<D>::kBytes + 4 * kTile * (int)sizeof(int) + tile_info_bytes(s.tk);
  cudaError_t err = allow_smem(flash_fwd_mma_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_fwd_mma_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, s, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, float* lse, const FlashShape& s, Strides sq, Strides sk,
                   Strides sv, Strides so, cudaStream_t st) {
#define CALL(DD) return launch<DD>(q, k, v, o, lse, s, sq, sk, sv, so, st)
  USDM_FLASH_DISPATCH_D(s.d, CALL)
#undef CALL
}

}  // namespace usdm
