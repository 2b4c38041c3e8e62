// 3xTF32 parts shared by the f32 flash-attention kernels: the forward
// (flash_attention.cu) and the backward's dq and dk/dv
// (flash_attention_bwd_dq_tf32.cu, flash_attention_bwd_dkv_tf32.cu; their
// design is described in flash_attention_bwd.cu).
//
// Every f32 product runs on the tensor cores as mma.sync.m16n8k8 with tf32
// operands in the 3xTF32 scheme of CUTLASS's OpMultiplyAddFastF32: each f32
// operand x splits as big = tf32(x), small = tf32(x - big), and a . b is
// small.big + big.small + big.big in f32 accumulators (the small.small term,
// ~2^-22 of the product, is dropped).  ldmatrix moves 16-bit elements, so the
// fragments come from unpadded [64][D] f32 tiles by 32-bit-element
// ld.shared, their 16-byte chunks XOR-swizzled by row (swizzle<SWZ>) so that
// a warp's reads are free of bank conflicts.
#pragma once

#include "mma.cuh"

namespace usdm {

// f32 launchers of the backward (flash_attention_bwd_dq_tf32.cu,
// flash_attention_bwd_dkv_tf32.cu)
int flash_bwd_dq_f32(const float* q, const float* k, const float* v, const float* dout,
                     const float* lse, const float* delta, float* dq, const FlashShape& s,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                     cudaStream_t st);
int flash_bwd_dkv_f32(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dk, float* dv,
                      const FlashShape& s, Strides sq, Strides sk, Strides sv, Strides sdo,
                      Strides sdk, Strides sdv, cudaStream_t st);

namespace mma {

// cvt.rna.tf32.f32's result in two integer operations: half a TF32 ulp added
// to the magnitude bits, the 13 bits below TF32's mantissa cleared (round to
// nearest, ties away from zero; finite x)
static __device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to ~2^-22 of |x|; x - big is exact in f32
static __device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// an A operand (16 x 8) in its big and small halves
struct SplitA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ SplitA(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// c (16 x 8, f32) += a (16 x 8, row-major) . b (8 x 8, column-major), tf32
static __device__ __forceinline__ void mma_1688(float (&c)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32, the small terms first; b's two f32 elements are
// split here
static __device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a, float b0,
                                                  float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_1688(c, a.small, bb0, bb1);
  mma_1688(c, a.big, bs0, bs1);
  mma_1688(c, a.big, bb0, bb1);
}

// The 16-byte chunk of row r that holds chunk c of the row; every swizzle
// stays inside c's group of 8 chunks.  SWZ 0 and 1 are the forward's K and V
// tiles (each tile read one way).  SWZ 2 serves a tile read both ways, as the
// backward reads K (dq) and Q and dO (dk/dv): as the B operand of a product
// reduced over the head dims (float4 of rows g of each 8, quarter-warp
// phases: rows 2m and 2m + 1 must differ in the chunk's bit 2) and as the B
// operand of a product reduced over the rows (float2 of rows 2t4 and
// 2t4 + 1 of each 8, half-warp phases: the four even rows, and the four odd
// ones, must differ in the chunk's bits 1-2).  (r & 6) ^ ((r & 1) << 2) gives
// both.
template <int SWZ>
static __device__ __forceinline__ int swizzle(int c, int r) {
  if (SWZ == 0) return c ^ ((r & 1) << 2);
  if (SWZ == 1) return c ^ (r & 6);
  return c ^ (r & 6) ^ ((r & 1) << 2);
}

// Loads 64-row tiles of one strided [B, T, H, d] f32 operand into unpadded,
// swizzled [64][D] shared-memory tiles by 16-byte cp.async, as mma.cuh's
// TileLoader does for bf16: a row has kSlots 4-float slots (the power of two
// at or above D / 4; those past D / 4 idle), thread i takes slot i % kSlots of
// rows i / kSlots + j * kRowsPerPass.  Rows past t_len and columns past d are
// zero-filled.  The caller commits the group.
template <int D, int SWZ>
struct F32Loader {
  static constexpr int kSlots = D <= 32 ? 8 : D <= 64 ? 16 : 32;
  static constexpr int kRowsPerPass = kThreads / kSlots;
  static constexpr int kPasses = kTile / kRowsPerPass;

  const float* base;   // a valid address for the copies that read nothing
  const float* first;  // this thread's slot in row (i / kSlots) of the operand's row 0
  long long stride_t;
  int row, slot;
  bool col_ok;

  __device__ __forceinline__ F32Loader(const float* src, long long stride, int d)
      : base(src), stride_t(stride) {
    slot = threadIdx.x % kSlots;
    row = threadIdx.x / kSlots;
    col_ok = slot * 4 < d;
    first = src + row * stride + slot * 4;
  }

  // rows t0 .. t0+63 -> the tile at shared-memory address `tile`; `offset`
  // moves to another head of the same operand
  __device__ __forceinline__ void load(uint32_t tile, int t0, int t_len,
                                       long long offset = 0) const {
    if (slot * 4 >= D) return;  // an idle slot (D 96: 8 of 32)
    const float* p = first + offset + t0 * stride_t;
    const int rows_left = t_len - t0 - row;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int r = row + j * kRowsPerPass;
      const bool ok = col_ok && j * kRowsPerPass < rows_left;
      cp_async16(tile + (uint32_t)(r * D + swizzle<SWZ>(slot, r) * 4) * 4, ok ? p : base, ok);
      p += kRowsPerPass * stride_t;
    }
  }
};

// c += a . b in 3xTF32, the three products summed from zero and their sum
// added to c by f32 adds.  The tensor cores truncate as they accumulate (the
// addends aligned to the largest, the bits shifted out dropped), so a sum
// carried through hundreds of products in the accumulator drifts toward zero
// by about an ulp of itself a product: on an H100, dV summed over 1,380
// queries that way missed the plain f32 version by 3.2e-4.  An f32 add rounds
// to nearest.  For the sums over a walk of tiles.
static __device__ __forceinline__ void mma_3xtf32_add(float (&c)[4], const SplitA& a, float b0,
                                                      float b1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(t, a, b0, b1);
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
  c[3] += t[3];
}

// A lane's reads of [64][D] f32 tiles under swizzle 2, in floats from row 0 of
// the tile (or of a warp's 16 rows), for even and odd 16-column chunks c (add
// 32 * (c >> 1)):
//   nt[c & 1]: the float4 of row g, columns 16c + 4t4 .. + 3 (the operands
//     of a product reduced over the head dims; rows g + 8n, and g + 8 for A);
//   nn[c & 1]: the float2 of row 2t4, columns 16c + 2g and + 1, and
//     nn[(c & 1) ^ 1] + D that of row 2t4 + 1 (the B operands of a product
//     reduced over the rows; rows + 8j).
template <int D>
struct Lanes {
  int nt[2], nn[2];
  __device__ __forceinline__ Lanes() {
    const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int w = t4 ^ (g & 6) ^ ((g & 1) << 2);  // chunk (4c + t4) ^ swizzle(row g), c even
    nt[0] = g * D + 4 * w;
    nt[1] = g * D + 4 * (w ^ 4);
    const int u = (g >> 1) ^ (2 * t4);  // chunk (4c + g / 2) ^ swizzle(row 2t4), c even
    nn[0] = 2 * t4 * D + 4 * u + 2 * (g & 1);
    nn[1] = 2 * t4 * D + 4 * (u ^ 4) + 2 * (g & 1);
  }
};

// acc (16 x 64) += A . B^T over the head dims in 3xTF32: A is a warp's 16 rows
// of a tile (`a` at the first), B the 64 rows of another (Q.K^T, dO.V^T and,
// transposed, K.Q^T, V.dO^T).  A lane's k = t4 / t4 + 4 of k-step 2c are
// columns 16c + 4t4 / + 1, of step 2c + 1 columns + 2 / + 3.
template <int D>
static __device__ __forceinline__ void gemm_nt_3x(float (&acc)[8][4], const float* a,
                                                  const float* b, const Lanes<D>& ln) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int off = ln.nt[c & 1] + 32 * (c >> 1);
    const float4 x = *reinterpret_cast<const float4*>(a + off);
    const float4 y = *reinterpret_cast<const float4*>(a + 8 * D + off);
    const SplitA a0(x.x, y.x, x.y, y.y), a1(x.z, y.z, x.w, y.w);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float4 bv = *reinterpret_cast<const float4*>(b + n * 8 * D + off);
      mma_3xtf32(acc[n], a0, bv.x, bv.y);
      mma_3xtf32(acc[n], a1, bv.z, bv.w);
    }
  }
}

// acc (16 x D) += P . B over the rows in 3xTF32: P is 16 x 64 in the m16n8
// accumulator layout, split here; B the 64 rows of a tile (dS.K, P^T.dO,
// dS^T.Q).  In k-step j a lane's k = t4 / t4 + 4 are rows 8j + 2t4 / + 1,
// which is where P's n-tile j holds them; output n-tiles 2c and 2c + 1 hold
// columns 16c + 4t4 + {0, 2} and + {1, 3}.  acc is a sum over a walk of
// tiles, so each product is added to it in f32 (mma_3xtf32_add).
template <int D>
static __device__ __forceinline__ void gemm_nn_3x(float (&acc)[D / 8][4],
                                                  const float (&p)[8][4], const float* b,
                                                  const Lanes<D>& ln) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const SplitA pa(p[j][0], p[j][2], p[j][1], p[j][3]);
    const float* r = b + j * 8 * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int hi = 32 * (c >> 1);
      const float2 x0 = *reinterpret_cast<const float2*>(r + ln.nn[c & 1] + hi);
      const float2 x1 = *reinterpret_cast<const float2*>(r + D + ln.nn[(c & 1) ^ 1] + hi);
      mma_3xtf32_add(acc[2 * c], pa, x0.x, x1.x);
      mma_3xtf32_add(acc[2 * c + 1], pa, x0.y, x1.y);
    }
  }
}

// two rows of a 16 x D accumulator of gemm_nn_3x -> rows of a strided f32
// output (row pointers null for rows past the end); columns past d are dropped
template <int D>
static __device__ __forceinline__ void store_rows_f32(const float (&acc)[D / 8][4], float* row0,
                                                      float* row1, int d) {
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const int col = c * 16 + t4 * 4;
    if (col >= d) break;
    if (row0)
      *reinterpret_cast<float4*>(row0 + col) =
          make_float4(acc[2 * c][0], acc[2 * c + 1][0], acc[2 * c][1], acc[2 * c + 1][1]);
    if (row1)
      *reinterpret_cast<float4*>(row1 + col) =
          make_float4(acc[2 * c][2], acc[2 * c + 1][2], acc[2 * c][3], acc[2 * c + 1][3]);
  }
}

}  // namespace mma
}  // namespace usdm
