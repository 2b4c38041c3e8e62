// K5 dk/dv, f32 route: flash-attention backward for the keys and values on
// Hopper's tensor cores in 3xTF32.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/flash_attention.py::
// _bwd_dkv_kernel for f32 operands (the C entry point that dispatches by
// dtype, and the design of the f32 route, are in csrc/flash_attention_bwd.cu;
// the products and the tile layout in csrc/tf32.cuh).  One block of 4 warps
// per (batch, kv head, 64 keys): K and V are loaded once into shared memory;
// the block walks the group's heads and their 64-query tiles, whose Q and dO
// (with log-sum-exp, delta, positions and segments) arrive by cp.async into a
// two-stage ring.  Per tile S^T = K.Q^T gives P^T, split in registers as the
// A operand of dV += P^T.dO; dP^T = V.dO^T gives dS^T, the A operand of
// dK += dS^T.Q.  dK and dV are written once by the block that owns the keys.

#include "tf32.cuh"

namespace usdm {
namespace {

using namespace mma;

// One transposed 16 x 64 tile of the dk/dv kernel (rows: this lane's two
// keys, columns: the tile's queries): st (k.q sums) -> P^T.  `cols` is the
// count of queries the tile has.
template <bool FULL, bool ALIBI>
static __device__ __forceinline__ void dkv_step(float (&st)[8][4], const int* qp_s,
                                                const int* qs_s, const float* lse_s, int cols,
                                                const int (&kp)[2], const int (&ks)[2],
                                                int causal, int window, float scale2,
                                                float slope2) {
  const int c2 = (threadIdx.x & 3) * 2;
  const float kpf[2] = {biased_pos(kp[0]), biased_pos(kp[1])};
  // key position 0 is exempt from ALiBi
  const float sl[2] = {kp[0] != 0 ? slope2 : 0.f, kp[1] != 0 ? slope2 : 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int2 qp = *reinterpret_cast<const int2*>(qp_s + n * 8 + c2);
    const float2 ls = *reinterpret_cast<const float2*>(lse_s + n * 8 + c2);
    int2 qs = make_int2(0, 0);
    if (!FULL) qs = *reinterpret_cast<const int2*>(qs_s + n * 8 + c2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = j >> 1;
      const int qpj = (j & 1) ? qp.y : qp.x;
      const float lse2 = ((j & 1) ? ls.y : ls.x) * kLog2e;
      float p = fast_exp2(
          score2<ALIBI>(st[n][j], scale2, sl[row], biased_pos(qpj), kpf[row]) - lse2);
      if (!FULL) {
        const bool a = n * 8 + c2 + (j & 1) < cols &&
                       allowed((j & 1) ? qs.y : qs.x, ks[row], qpj, kp[row], causal, window);
        p = a ? p : 0.f;
      }
      st[n][j] = p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ dk, float* __restrict__ dv, FlashShape s,
                          Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                          Strides sdv) {
  constexpr int kE = kTile * D;
  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = s.n_heads / s.n_kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c2 = (lane & 3) * 2;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_k = reinterpret_cast<float*>(smem);           // [64][D], swizzle 2
  float* s_v = s_k + kE;                                 // [64][D]
  float* s_q = s_v + kE;                                 // 2 stages
  float* s_do = s_q + 2 * kE;                            // 2 stages
  int* s_qpos = reinterpret_cast<int*>(s_do + 2 * kE);   // [2][64]
  int* s_qseg = s_qpos + 2 * kTile;
  float* s_lse = reinterpret_cast<float*>(s_qseg + 2 * kTile);  // [2][64]
  float* s_delta = s_lse + 2 * kTile;
  int4* s_info = reinterpret_cast<int4*>(s_delta + 2 * kTile);  // [query tiles]

  const int* qpos = s.qpos + (size_t)b * s.tq;
  const int* qseg = s.qseg + (size_t)b * s.tq;
  const int* kpos = s.kpos + (size_t)b * s.tk;
  const int* kseg = s.kseg + (size_t)b * s.tk;

  const TileInfo own = scan_rows(kpos, kseg, k0, s.tk, -2);
  // this lane's two key rows
  const int r0 = k0 + warp * 16 + (lane >> 2), r1 = r0 + 8;
  const int kp[2] = {r0 < s.tk ? kpos[r0] : 0, r1 < s.tk ? kpos[r1] : 0};
  const int ks[2] = {r0 < s.tk ? kseg[r0] : -2, r1 < s.tk ? kseg[r1] : -2};
  const float scale2 = s.scale * kLog2e;

  // the walk: item i is query tile i % n_qt of the group's head i / n_qt
  const int n_qt = (s.tq + kTile - 1) / kTile;
  const int n_items = own.pmin <= own.pmax ? group * n_qt : 0;
  scan_tiles(qpos, qseg, s.tq, -1, s_info, n_items ? n_qt : 0);
  __syncthreads();
  auto next_item = [&](int i) {
    for (; i < n_items; ++i) {
      const TileInfo qi = tile_info(s_info, i % n_qt);
      if (tile_runs(qi.pmin, qi.pmax, own.pmin, own.pmax, s.causal, s.window)) break;
    }
    return i;
  };
  // loaders at the group's first head; prefetch() moves them to item i's head
  const F32Loader<D, 2> load_q(q + b * sq.b + hk * group * sq.h, sq.t, s.d);
  const F32Loader<D, 2> load_do(dout + b * sdo.b + hk * group * sdo.h, sdo.t, s.d);
  auto prefetch = [&](int i, int stage) {
    const int g = i / n_qt, h = hk * group + g, t0 = (i % n_qt) * kTile;
    load_q.load(smem_u32(s_q + stage * kE), t0, s.tq, g * sq.h);
    load_do.load(smem_u32(s_do + stage * kE), t0, s.tq, g * sdo.h);
    const size_t row = ((size_t)b * s.n_heads + h) * s.tq;
    void* const dst[4] = {s_qpos + stage * kTile, s_qseg + stage * kTile,
                          s_lse + stage * kTile, s_delta + stage * kTile};
    const void* const src[4] = {qpos, qseg, lse + row, delta + row};
    load_rows<4>(dst, src, t0, s.tq);
    cp_async_commit();
  };

  const Lanes<D> ln;
  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) adk[n][j] = adv[n][j] = 0.f;

  int i = next_item(0);
  if (i < n_items) {
    F32Loader<D, 2>(k + b * sk.b + hk * sk.h, sk.t, s.d).load(smem_u32(s_k), k0, s.tk);
    F32Loader<D, 2>(v + b * sv.b + hk * sv.h, sv.t, s.d).load(smem_u32(s_v), k0, s.tk);
    prefetch(i, 0);
  }
  const float* k_w = s_k + warp * 16 * D;  // this warp's rows
  const float* v_w = s_v + warp * 16 * D;
  for (int stage = 0; i < n_items; stage ^= 1) {
    const int in = next_item(i + 1);
    cp_async_wait_all();
    __syncthreads();  // item i has landed, and every warp is done with item i's predecessor
    if (in < n_items) prefetch(in, stage ^ 1);  // overlaps this item's products
    const float slope2 = s.alibi ? alibi_slope2(hk * group + i / n_qt, s.n_heads) : 0.f;
    const float* qt = s_q + stage * kE;
    const float* dot = s_do + stage * kE;

    // S^T = K.Q^T: rows are this warp's keys, columns the tile's queries
    float st[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) st[n][0] = st[n][1] = st[n][2] = st[n][3] = 0.f;
    gemm_nt_3x<D>(st, k_w, qt, ln);
    const int qtile = i % n_qt;
    const int cols = s.tq - qtile * kTile;
    const bool full = tile_full(tile_info(s_info, qtile), own, s.causal, s.window);
#define STEP(FULL, ALIBI)                                                                   \
  dkv_step<FULL, ALIBI>(st, s_qpos + stage * kTile, s_qseg + stage * kTile,                 \
                        s_lse + stage * kTile, cols, kp, ks, s.causal, s.window, scale2,    \
                        slope2)
    if (s.alibi) {
      if (full) STEP(true, true); else STEP(false, true);
    } else {
      if (full) STEP(true, false); else STEP(false, false);
    }
#undef STEP
    gemm_nn_3x<D>(adv, st, dot, ln);  // dV += P^T.dO

    // dP^T = V.dO^T, then dS^T in place
    float dpt[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) dpt[n][0] = dpt[n][1] = dpt[n][2] = dpt[n][3] = 0.f;
    gemm_nt_3x<D>(dpt, v_w, dot, ln);
    const float* delta_s = s_delta + stage * kTile + c2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + n * 8);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dpt[n][j] = st[n][j] * (dpt[n][j] - ((j & 1) ? dl.y : dl.x)) * s.scale;
    }
    gemm_nn_3x<D>(adk, dpt, qt, ln);  // dK += dS^T.Q
    i = in;
  }

  float* dkb = dk + b * sdk.b + hk * sdk.h;
  float* dvb = dv + b * sdv.b + hk * sdv.h;
  store_rows_f32<D>(adk, r0 < s.tk ? dkb + r0 * sdk.t : nullptr,
                    r1 < s.tk ? dkb + r1 * sdk.t : nullptr, s.d);
  store_rows_f32<D>(adv, r0 < s.tk ? dvb + r0 * sdv.t : nullptr,
                    r1 < s.tk ? dvb + r1 * sdv.t : nullptr, s.d);
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dk, float* dv, const FlashShape& s,
               Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
               cudaStream_t st) {
  const int smem = 6 * kTile * D * (int)sizeof(float) + 8 * kTile * (int)sizeof(int) +
                   tile_info_bytes(s.tq);
  cudaError_t err = allow_smem(flash_bwd_dkv_tf32_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((s.tk + kTile - 1) / kTile, s.n_kv_heads, s.batch);
  flash_bwd_dkv_tf32_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, dout, lse, delta, dk, dv,
                                                             s, sq, sk, sv, sdo, sdk, sdv);
  return (int)cudaGetLastError();
}

}  // namespace

int flash_bwd_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dk, float* dv,
                      const FlashShape& s, Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdk, Strides sdv, cudaStream_t st) {
#define CALL(DD) \
  return launch_dkv<DD>(q, k, v, dout, lse, delta, dk, dv, s, sq, sk, sv, sdo, sdk, sdv, st)
  USDM_FLASH_DISPATCH_D(s.d, CALL)
#undef CALL
}

}  // namespace usdm
