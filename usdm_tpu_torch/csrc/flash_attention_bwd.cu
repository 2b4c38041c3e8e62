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
//   dq kernel:  one block of 4 warps per (batch, head, 64 queries); it walks
//               the 64-key tiles and accumulates dQ += dS . K.
//   dkv kernel: one block of 4 warps per (batch, kv head, 64 keys); it walks
//               the G query heads of its group and their 64-query tiles, and
//               accumulates dV += P^T . dO and dK += dS^T . Q.  dK and dV are
//               written once, with no atomics, so the result does not depend
//               on the order blocks run in.
//
// Unlike the Pallas grids, which clamp and skip tiles by FLAT index (only
// right when query and key flat indices are aligned), each tile skip here
// compares the position ranges of the tile's valid queries and keys, as K2
// does.  Ragged Tq/Tk are masked in-kernel; operands are strided [B, T, H, d]
// views (last dim contiguous, rows on 16-byte boundaries); lse and delta are
// [B, H, Tq] f32.
//
// One route per dtype, both on the tensor cores.  bf16 operands go to the
// kernels in csrc/flash_attention_bwd_dq_mma.cu and
// csrc/flash_attention_bwd_dkv_mma.cu.  f32 operands go to the kernels in
// csrc/flash_attention_bwd_dq_tf32.cu and csrc/flash_attention_bwd_dkv_tf32.cu,
// described below: the Pallas kernels ask for Precision.HIGHEST on f32, so
// every one of the five products is 3xTF32 (csrc/tf32.cuh), as in the f32
// forward, and P and dS are split in registers after they are formed in f32.
//
// Bound: operations.  The backward does 3.5x the forward's multiply-adds (dq:
// S = Q.K^T, dP = dO.V^T, dQ = dS.K; dk/dv: S^T, dP^T, dV = P^T.dO,
// dK = dS^T.Q), three TF32 products each against the 495 TFLOP/s TF32 peak.
// The kernels keep the bf16 route's structure (csrc/mma.cuh): 16 rows a warp,
// the other side in 64-row tiles through a two-stage cp.async ring with one
// barrier a step, the once-per-block scan of every tile's position and
// segment ranges (dead tiles skipped before their loads, fully allowed tiles
// on the path without mask tests), ex2 with log2(e) folded into the scale,
// the slope and the log-sum-exp, and the dk/dv tile computed transposed
// (S^T = K.Q^T, dP^T = V.dO^T), so that P^T and dS^T come out in the
// accumulator layout that is the next product's A operand.  What the f32
// tiles change:
//   - a tile is read in two roles: in dq, K is the B operand of Q.K^T
//     (reduced over the head dims: a lane reads a float4 of row g of each 8,
//     its columns 16c + 4t4 .. + 3 the k of steps 2c and 2c + 1) and of
//     dS.K (reduced over the keys: float2s of rows 2t4 and 2t4 + 1, columns
//     16c + 2g and + 1, the B operands of output n-tiles 2c and 2c + 1); in
//     dk/dv, Q and dO are each read both ways.  Every tile is stored once,
//     unpadded, under tf32.cuh's swizzle 2, which keeps both reads free of
//     bank conflicts.
//   - the 16 rows a warp owns (Q and dO in dq, K and V in dk/dv) stay in
//     shared memory beside the ring, loaded once, and are read by the same
//     float4 pattern as the A operand of the products reduced over the head
//     dims (rows g and g + 8).  Keeping them in registers, as the forward
//     keeps Q, would add d floats a lane to the accumulators (dk/dv holds
//     dK and dV, d floats a lane) and not fit at d 128.
//   - dQ, dK and dV are sums over a walk of tiles: each 3xTF32 product is
//     summed from zero and added to them by f32 adds (tf32.cuh's
//     mma_3xtf32_add), since the tensor cores' own accumulation truncates.
//   - shared memory is 6 [64][D] f32 tiles: 48 KiB at D 32, 96 KiB at D 64,
//     192 KiB at D 128.
// Head dims (multiples of 8) that are not 32, 64, 96 or 128 run at the next
// of those widths with zero-filled columns, as the forward does.

#include "tf32.cuh"

using bf16 = __nv_bfloat16;

// Strides of q, k, v, dO and the outputs come as (b, t, h) triples, in that
// order; the head_dim axis is contiguous.
extern "C" int usdm_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, const void* qpos,
                                 const void* kpos, const void* qseg, const void* kseg,
                                 int batch, int n_heads, int n_kv_heads, int tq, int tk, int d,
                                 const long long* strides, int causal, int window, int alibi,
                                 float scale, int dtype, void* stream) {
  using usdm::Strides;
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sdo{strides[9], strides[10], strides[11]},
      sdq{strides[12], strides[13], strides[14]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // bf16 operands, one product per product
    return usdm::flash_bwd_dq_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                   (const bf16*)dout, (const float*)lse, (const float*)delta,
                                   (bf16*)dq, s, sq, sk, sv, sdo, sdq, st);
  if (dtype == usdm::kF32)  // 3xTF32
    return usdm::flash_bwd_dq_f32((const float*)q, (const float*)k, (const float*)v,
                                  (const float*)dout, (const float*)lse, (const float*)delta,
                                  (float*)dq, s, sq, sk, sv, sdo, sdq, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int usdm_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* qpos, const void* kpos, const void* qseg,
                                  const void* kseg, int batch, int n_heads, int n_kv_heads,
                                  int tq, int tk, int d, const long long* strides, int causal,
                                  int window, int alibi, float scale, int dtype, void* stream) {
  using usdm::Strides;
  const usdm::FlashShape s{batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi, scale,
                           (const int*)qpos, (const int*)kpos, (const int*)qseg,
                           (const int*)kseg};
  if (usdm::flash_bad_shape(s)) return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, sdo{strides[9], strides[10], strides[11]},
      sdk{strides[12], strides[13], strides[14]}, sdv{strides[15], strides[16], strides[17]};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == usdm::kBF16)  // bf16 operands, one product per product
    return usdm::flash_bwd_dkv_bf16((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                    (const bf16*)dout, (const float*)lse, (const float*)delta,
                                    (bf16*)dk, (bf16*)dv, s, sq, sk, sv, sdo, sdk, sdv, st);
  if (dtype == usdm::kF32)  // 3xTF32
    return usdm::flash_bwd_dkv_f32((const float*)q, (const float*)k, (const float*)v,
                                   (const float*)dout, (const float*)lse, (const float*)delta,
                                   (float*)dk, (float*)dv, s, sq, sk, sv, sdo, sdk, sdv, st);
  return (int)cudaErrorInvalidValue;
}
