// K5 dq, f32 route: flash-attention backward for the queries on Hopper's
// tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/flash_attention.py::
// _bwd_dq_kernel for f32 operands (the C entry point that dispatches by
// dtype, and the design of the f32 route, are in csrc/flash_attention_bwd.cu;
// the products and the tile layout in csrc/tf32.cuh).  One block of 4 warps
// per (batch, head, 64 queries): Q and dO are loaded once into shared memory,
// K and V tiles of 64 keys arrive by cp.async into a two-stage ring; per
// tile S = Q.K^T and dP = dO.V^T land in the accumulator layout, where mask,
// ALiBi, ex2 and dS = P * (dP - delta) * scale are applied, and dS is split
// in registers as the A operand of dQ += dS.K.

#include "tf32.cuh"

namespace usdm {
namespace {

using namespace mma;

// One 16 x 64 tile of the dq kernel in the accumulator layout (rows: this
// lane's two queries, columns: the tile's keys): sc (q.k sums) and dp (dO.v
// sums) -> dS = P * (dP - delta) * scale in sc.  FULL: every pair of the tile
// passes every mask.  lse2 is log2(e) * log-sum-exp of this lane's two rows.
template <bool FULL, bool ALIBI>
static __device__ __forceinline__ void dq_step(
    float (&sc)[8][4], const float (&dp)[8][4], const int* kp_s, const int* ks_s, int cols,
    const int (&qp)[2], const int (&qs)[2], const float (&lse2)[2], const float (&delta)[2],
    int causal, int window, float scale, float scale2, float slope2) {
  const int c2 = (threadIdx.x & 3) * 2;
  const float qpf[2] = {biased_pos(qp[0]), biased_pos(qp[1])};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 kp = *reinterpret_cast<const int2*>(kp_s + n * 8 + c2);
    int2 ks = make_int2(0, 0);
    if (!FULL) ks = *reinterpret_cast<const int2*>(ks_s + n * 8 + c2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = j >> 1;
      const int kpj = (j & 1) ? kp.y : kp.x;
      const float sl = ALIBI && kpj != 0 ? slope2 : 0.f;  // key position 0 is exempt
      float p = fast_exp2(
          score2<ALIBI>(sc[n][j], scale2, sl, qpf[row], biased_pos(kpj)) - lse2[row]);
      if (!FULL) {
        // masked: P is 0 whatever ex2 gives (its S is finite and must not leak)
        const bool a = n * 8 + c2 + (j & 1) < cols &&
                       allowed(qs[row], (j & 1) ? ks.y : ks.x, qp[row], kpj, causal, window);
        p = a ? p : 0.f;
      }
      sc[n][j] = p * (dp[n][j] - delta[row]) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dq, FlashShape s, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdq) {
  constexpr int kE = kTile * D;  // floats of one tile
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (s.n_heads / s.n_kv_heads);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_q = reinterpret_cast<float*>(smem);         // [64][D], swizzle 2
  float* s_do = s_q + kE;                              // [64][D]
  float* s_k = s_do + kE;                              // 2 stages
  float* s_v = s_k + 2 * kE;                           // 2 stages
  int* s_kpos = reinterpret_cast<int*>(s_v + 2 * kE);  // [2][64]
  int* s_kseg = s_kpos + 2 * kTile;
  int4* s_info = reinterpret_cast<int4*>(s_kseg + 2 * kTile);  // [key tiles]

  const int* qpos = s.qpos + (size_t)b * s.tq;
  const int* qseg = s.qseg + (size_t)b * s.tq;
  const int* kpos = s.kpos + (size_t)b * s.tk;
  const int* kseg = s.kseg + (size_t)b * s.tk;
  const F32Loader<D, 2> load_k(k + b * sk.b + hk * sk.h, sk.t, s.d);
  const F32Loader<D, 2> load_v(v + b * sv.b + hk * sv.h, sv.t, s.d);
  const float* lse_b = lse + ((size_t)b * s.n_heads + h) * s.tq;
  const float* delta_b = delta + ((size_t)b * s.n_heads + h) * s.tq;

  const TileInfo own = scan_rows(qpos, qseg, q0, s.tq, -1);
  const int r0 = q0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int qp[2] = {r0 < s.tq ? qpos[r0] : 0, r1 < s.tq ? qpos[r1] : 0};
  const int qs[2] = {r0 < s.tq ? qseg[r0] : -1, r1 < s.tq ? qseg[r1] : -1};
  const float lse2[2] = {r0 < s.tq ? lse_b[r0] * kLog2e : 0.f,
                         r1 < s.tq ? lse_b[r1] * kLog2e : 0.f};
  const float row_delta[2] = {r0 < s.tq ? delta_b[r0] : 0.f, r1 < s.tq ? delta_b[r1] : 0.f};
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

  const Lanes<D> ln;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int t = next_tile(0);
  if (t < n_tiles) {
    F32Loader<D, 2>(q + b * sq.b + h * sq.h, sq.t, s.d).load(smem_u32(s_q), q0, s.tq);
    F32Loader<D, 2>(dout + b * sdo.b + h * sdo.h, sdo.t, s.d).load(smem_u32(s_do), q0, s.tq);
    prefetch(t, 0);
  }
  const float* q_w = s_q + warp * 16 * D;  // this warp's rows
  const float* do_w = s_do + warp * 16 * D;
  for (int stage = 0; t < n_tiles; stage ^= 1) {
    const int tn = next_tile(t + 1);
    cp_async_wait_all();
    __syncthreads();  // tile t has landed, and every warp is done with tile t's predecessor
    if (tn < n_tiles) prefetch(tn, stage ^ 1);  // overlaps this tile's products

    const float* kt = s_k + stage * kE;
    float sc[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[n][j] = dp[n][j] = 0.f;
    gemm_nt_3x<D>(sc, q_w, kt, ln);                 // S = Q.K^T
    gemm_nt_3x<D>(dp, do_w, s_v + stage * kE, ln);  // dP = dO.V^T

    const int* kp_s = s_kpos + stage * kTile;
    const int* ks_s = s_kseg + stage * kTile;
    const int cols = s.tk - t * kTile;
    const bool full = tile_full(own, tile_info(s_info, t), s.causal, s.window);
#define STEP(FULL, ALIBI)                                                                  \
  dq_step<FULL, ALIBI>(sc, dp, kp_s, ks_s, cols, qp, qs, lse2, row_delta, s.causal, s.window, \
                       s.scale, scale2, slope2)
    if (s.alibi) {
      if (full) STEP(true, true); else STEP(false, true);
    } else {
      if (full) STEP(true, false); else STEP(false, false);
    }
#undef STEP
    gemm_nn_3x<D>(acc, sc, kt, ln);  // dQ += dS.K
    t = tn;
  }

  float* ob = dq + b * sdq.b + h * sdq.h;
  store_rows_f32<D>(acc, r0 < s.tq ? ob + r0 * sdq.t : nullptr,
                    r1 < s.tq ? ob + r1 * sdq.t : nullptr, s.d);
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v, const float* dout,
              const float* lse, const float* delta, float* dq, const FlashShape& s, Strides sq,
              Strides sk, Strides sv, Strides sdo, Strides sdq, cudaStream_t st) {
  const int smem = 6 * kTile * D * (int)sizeof(float) + 4 * kTile * (int)sizeof(int) +
                   tile_info_bytes(s.tk);
  cudaError_t err = allow_smem(flash_bwd_dq_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tq + kTile - 1) / kTile, s.n_heads, s.batch);
  flash_bwd_dq_tf32_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dq, s,
                                                            sq, sk, sv, sdo, sdq);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_bwd_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, const FlashShape& s,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                     cudaStream_t st) {
#define CALL(DD) return launch_dq<DD>(q, k, v, dout, lse, delta, dq, s, sq, sk, sv, sdo, sdq, st)
  USDM_FLASH_DISPATCH_D(s.d, CALL)
#undef CALL
}

}  // namespace usdm
