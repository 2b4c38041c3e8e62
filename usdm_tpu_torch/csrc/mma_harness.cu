// Harnesses for the tensor-core parts in csrc/mma.cuh; no path of the port
// calls them.
//
// usdm_mma_tile_products: one block computes S = Q.K^T of one 64 x 64 tile
// (gemm_nt) and O = bf16(S).V (pack_operand, gemm_reg_nn) from [64, d] bf16
// operands that went through the kernels' own tile loader, and writes both in
// f32.  It is held against torch.matmul of the same bf16 values in f32: a
// wrong fragment layout, a wrong ldmatrix address or a bank-padding mistake
// shows here, apart from any mask or softmax.
//
// usdm_mma_mix_rate: a rate probe.  Blocks of 4 warps keep one Q, K and V
// tile (d 64) in shared memory and repeat one 64-key step of the forward
// kernel's products on it, with no loads, mask or softmax, in four forms: the
// kernels' own mix (per warp 36 ldmatrix.x4 and 64 mma), the mma alone, the
// ldmatrix alone, and the mix with each K/V fragment used for two 16-row
// tiles (36 ldmatrix.x4 per 128 mma).  It says what the shared-memory
// operand traffic, not the tensor cores, allows a 16-rows-per-warp design.

#include "mma.cuh"

namespace {

using namespace usdm::mma;

template <int D>
__global__ void __launch_bounds__(kThreads)
mma_tile_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, float* __restrict__ s_out,
                float* __restrict__ o_out, int d) {
  constexpr int kE = Tile<D>::kElems;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + kE;
  __nv_bfloat16* s_v = s_k + kE;
  TileLoader<D>(q, d, d).load(smem_u32(s_q), 0, kTile);
  TileLoader<D>(k, d, d).load(smem_u32(s_k), 0, kTile);
  TileLoader<D>(v, d, d).load(smem_u32(s_v), 0, kTile);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = warp * 16 + (lane >> 2), c2 = (lane & 3) * 2;
  float sc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
  gemm_nt<D>(sc, s_q, warp * 16, s_k);
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    s_out[r0 * kTile + n * 8 + c2] = sc[n][0];
    s_out[r0 * kTile + n * 8 + c2 + 1] = sc[n][1];
    s_out[(r0 + 8) * kTile + n * 8 + c2] = sc[n][2];
    s_out[(r0 + 8) * kTile + n * 8 + c2 + 1] = sc[n][3];
  }
  uint32_t p[4][4];
  pack_operand(p, sc);
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  gemm_reg_nn<D>(acc, p, s_v);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + c2;
    if (col >= d) break;
    o_out[r0 * d + col] = acc[n][0];
    o_out[r0 * d + col + 1] = acc[n][1];
    o_out[(r0 + 8) * d + col] = acc[n][2];
    o_out[(r0 + 8) * d + col + 1] = acc[n][3];
  }
}

template <int D>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v, float* s_out,
           float* o_out, int d, cudaStream_t st) {
  const int smem = 3 * Tile<D>::kBytes;
  cudaError_t err = allow_smem(mma_tile_kernel<D>, smem);
  if (err != cudaSuccess) return (int)err;
  mma_tile_kernel<D><<<1, kThreads, smem, st>>>(q, k, v, s_out, o_out, d);
  return (int)cudaGetLastError();
}

// one 64-key step of the forward's products on resident tiles, `iters` times
template <int MODE>
__global__ void __launch_bounds__(kThreads)
mma_mix_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, float* __restrict__ out, int iters) {
  constexpr int D = 64;
  constexpr int kE = Tile<D>::kElems;
  constexpr int kS = Tile<D>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + kE;
  __nv_bfloat16* s_v = s_k + kE;
  TileLoader<D>(q, D, D).load(smem_u32(s_q), 0, kTile);
  TileLoader<D>(k, D, D).load(smem_u32(s_k), 0, kTile);
  TileLoader<D>(v, D, D).load(smem_u32(s_v), 0, kTile);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[2][D / 8][4], sink = 0.f;
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[0][n][j] = acc[1][n][j] = 0.f;
  for (int it = 0; it < iters; ++it) {
    float sc[2][8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[0][n][j] = sc[1][n][j] = 0.f;
    if (MODE == 0) {  // the kernels' mix
      gemm_nt<D>(sc[0], s_q, warp * 16, s_k);
      uint32_t p[4][4];
      pack_operand(p, sc[0]);
      gemm_reg_nn<D>(acc[0], p, s_v);
    } else if (MODE == 1) {  // 128 mma on two loaded fragments
      uint32_t a[4], b[4];
      ldsm_x4(a, smem_u32(s_q + (warp * 16 + (lane & 15)) * kS + (lane >> 4) * 8));
      ldsm_x4(b, smem_u32(s_k + (lane & 7) * kS + it % 4 * 8));
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          mma_16816(acc[0][n], a, b[r & 1], b[2 + (r & 1)]);
          mma_16816(sc[0][n], a, b[r & 1], b[2 + (r & 1)]);
        }
#pragma unroll
      for (int n = 0; n < 8; ++n) sink += sc[0][n][0];
    } else if (MODE == 2) {  // 36 ldmatrix.x4, folded so that none is dropped
      uint32_t x = 0;
#pragma unroll
      for (int r = 0; r < 36; ++r) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(s_k + ((lane & 7) + 8 * (r & 7)) * kS + ((lane >> 3) & 3) * 8 +
                            (r >> 3) * 8));
        x ^= b[0] ^ b[1] ^ b[2] ^ b[3];
      }
      sink += __uint_as_float(x & 0x3fffffu);
    } else {  // each K and V fragment used for two 16-row tiles
      const uint32_t a_addr =
          smem_u32(s_q + ((warp & 1) * 32 + (lane & 15)) * kS + (lane >> 4) * 8);
      const uint32_t k_addr =
          smem_u32(s_k + ((lane >> 4) * 8 + (lane & 7)) * kS + ((lane >> 3) & 1) * 8);
      const uint32_t v_addr =
          smem_u32(s_v + (((lane >> 3) & 1) * 8 + (lane & 7)) * kS + (lane >> 4) * 8);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a0[4], a1[4];
        ldsm_x4(a0, a_addr + ks * 32);
        ldsm_x4(a1, a_addr + 16 * kS * 2 + ks * 32);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t b[4];
          ldsm_x4(b, k_addr + (np * 16 * kS + ks * 16) * 2);
          mma_16816(sc[0][2 * np], a0, b[0], b[1]);
          mma_16816(sc[0][2 * np + 1], a0, b[2], b[3]);
          mma_16816(sc[1][2 * np], a1, b[0], b[1]);
          mma_16816(sc[1][2 * np + 1], a1, b[2], b[3]);
        }
      }
      uint32_t p0[4][4], p1[4][4];
      pack_operand(p0, sc[0]);
      pack_operand(p1, sc[1]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, v_addr + (ks * 16 * kS + np * 16) * 2);
          mma_16816(acc[0][2 * np], p0[ks], b[0], b[1]);
          mma_16816(acc[0][2 * np + 1], p0[ks], b[2], b[3]);
          mma_16816(acc[1][2 * np], p1[ks], b[0], b[1]);
          mma_16816(acc[1][2 * np + 1], p1[ks], b[2], b[3]);
        }
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) sink += acc[0][n][j] + acc[1][n][j];
  out[blockIdx.x * kThreads + threadIdx.x] = sink;
}

}  // namespace

// q, k, v: contiguous [64, d] bf16; s_out [64, 64] f32; o_out [64, d] f32
extern "C" int usdm_mma_tile_products(const void* q, const void* k, const void* v, void* s_out,
                                      void* o_out, int d, void* stream) {
  if (d % 16 != 0 || d < 16 || d > 128) return (int)cudaErrorInvalidValue;
#define CALL(DD)                                                                          \
  return launch<DD>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,                     \
                    (const __nv_bfloat16*)v, (float*)s_out, (float*)o_out, d,             \
                    (cudaStream_t)stream)
  USDM_FLASH_DISPATCH_D(d, CALL)
#undef CALL
}

// q, k, v: contiguous [64, 64] bf16; out: [blocks * 128] f32 (a sink).  mode 0
// the kernels' mix, 1 mma only, 2 ldmatrix only, 3 fragments reused over two
// 16-row tiles; `smem` bytes of dynamic shared memory per block set how many
// blocks an SM holds.
extern "C" int usdm_mma_mix_rate(const void* q, const void* k, const void* v, void* out,
                                 int iters, int mode, int blocks, int smem, void* stream) {
  if (mode < 0 || mode > 3 || blocks < 1 || iters < 1 || smem < 3 * Tile<64>::kBytes)
    return (int)cudaErrorInvalidValue;
#define CALL(M)                                                                              \
  {                                                                                          \
    cudaError_t err = allow_smem(mma_mix_kernel<M>, smem);                                   \
    if (err != cudaSuccess) return (int)err;                                                 \
    mma_mix_kernel<M><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(                     \
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,           \
        (float*)out, iters);                                                                 \
  }
  if (mode == 0) CALL(0) else if (mode == 1) CALL(1) else if (mode == 2) CALL(2) else CALL(3)
#undef CALL
  return (int)cudaGetLastError();
}
