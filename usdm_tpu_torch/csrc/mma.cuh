// Tensor-core parts shared by the bf16 flash-attention kernels
// (flash_attention_mma.cu, flash_attention_bwd_dq_mma.cu,
// flash_attention_bwd_dkv_mma.cu): inline-PTX mma.sync / ldmatrix / cp.async,
// the padded [64][D] shared-memory tile and its loader, the two warp-level
// products every kernel is built from, the position/segment tile scan, and the
// mask, ALiBi and online-softmax rules in the accumulator's register layout.
// The f32 forward (3xTF32, flash_attention.cu) shares all but the bf16 tile,
// loader and products.
//
// A block is 4 warps over 64 rows; warp w owns rows 16w .. 16w+15.  Products
// are mma.sync.m16n8k16 (bf16 operands, f32 accumulators).  In its m16n8
// accumulator, lane l holds rows l/4 and l/4 + 8 and columns 2*(l%4) + {0, 1}
// of each 8-column n-tile; two neighbouring n-tiles, rounded to bf16 pairs,
// are exactly the m16k16 A operand of the next product, so the probabilities
// and dS never pass through shared memory.
#pragma once

#include <limits.h>

#include "common.cuh"

namespace usdm {

struct Strides {
  long long b, t, h;
};

// what the three flash-attention kernels share: shapes, flags, rows
struct FlashShape {
  int batch, n_heads, n_kv_heads, tq, tk, d, causal, window, alibi;
  float scale;
  const int *qpos, *kpos, *qseg, *kseg;  // [B, Tq] / [B, Tk] int32
};

static inline bool flash_bad_shape(const FlashShape& s) {
  return s.d % 8 != 0 || s.d > 128 || s.n_kv_heads < 1 || s.n_heads % s.n_kv_heads != 0 ||
         s.tq < 1 || s.tk < 1 || s.batch < 1;
}

// bf16 launchers of the tensor-core route (each in its own .cu)
int flash_fwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                   __nv_bfloat16* o, float* lse, const FlashShape& s, Strides sq, Strides sk,
                   Strides sv, Strides so, cudaStream_t st);
int flash_bwd_dq_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      const __nv_bfloat16* dout, const float* lse, const float* delta,
                      __nv_bfloat16* dq, const FlashShape& s, Strides sq, Strides sk, Strides sv,
                      Strides sdo, Strides sdq, cudaStream_t st);
int flash_bwd_dkv_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                       const __nv_bfloat16* dout, const float* lse, const float* delta,
                       __nv_bfloat16* dk, __nv_bfloat16* dv, const FlashShape& s, Strides sq,
                       Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                       cudaStream_t st);

namespace mma {

constexpr int kTile = 64;      // rows of a tile, on either side of a product
constexpr int kThreads = 128;  // 4 warps x 16 rows

// A [64][D] bf16 tile in shared memory has rows of D + 8 elements: the 16
// bytes of padding make the row stride an odd number of 16-byte chunks, so the
// 8 row addresses of an ldmatrix fall into 8 different bank groups.
template <int D>
struct Tile {
  static constexpr int kStride = D + 8;
  static constexpr int kElems = kTile * kStride;
  static constexpr int kBytes = kElems * 2;
};

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
static __device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

static __device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

static __device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

static __device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, row-major) . b (16 x 8, column-major)
static __device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                                 uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16 (lo in the low half: the lower column)
static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Loads 64-row tiles of one strided [B, T, H, d] operand into padded
// shared-memory tiles by 16-byte cp.async.  What does not change from tile to
// tile is worked out once per thread: a row has kSlots 16-byte slots (the
// power of two at or above D / 8; the slots past D / 8 idle), thread i takes
// slot i % kSlots of rows i / kSlots + j * kRowsPerPass, so a tile costs each
// thread one pointer and kPasses adds, compares and copies.  Rows past t_len
// and columns past d (d < D: the tile is wider than the head) are
// zero-filled.  The caller commits the group.
template <int D>
struct TileLoader {
  static constexpr int kSlots = D <= 32 ? 4 : D <= 64 ? 8 : 16;
  static constexpr int kRowsPerPass = kThreads / kSlots;
  static constexpr int kPasses = kTile / kRowsPerPass;

  const __nv_bfloat16* base;  // a valid address for the copies that read nothing
  const __nv_bfloat16* first; // this thread's slot in row (i / kSlots) of the operand's row 0
  long long stride_t;         // elements from one row to the next
  uint32_t dst;               // byte offset of that slot inside a tile
  int row;                    // i / kSlots
  bool col_ok;                // the slot holds columns of the head

  // `src` points at row 0 of the (batch, head) the tiles come from
  __device__ __forceinline__ TileLoader(const __nv_bfloat16* src, long long stride, int d)
      : base(src), stride_t(stride) {
    const int slot = threadIdx.x % kSlots;
    row = threadIdx.x / kSlots;
    col_ok = slot * 8 < d;  // d <= D, so this also keeps the idle slots out
    first = src + row * stride + slot * 8;
    dst = (uint32_t)(row * Tile<D>::kStride + slot * 8) * 2;
  }

  // rows t0 .. t0+63 -> the tile at shared-memory address `tile`; `offset`
  // moves to another head of the same operand
  __device__ __forceinline__ void load(uint32_t tile, int t0, int t_len,
                                       long long offset = 0) const {
    if (threadIdx.x % kSlots * 8 >= D) return;  // an idle slot (D 96: 12 of 16)
    const __nv_bfloat16* p = first + offset + t0 * stride_t;
    const int rows_left = t_len - t0 - row;
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const bool ok = col_ok && j * kRowsPerPass < rows_left;
      cp_async16(tile + dst + j * kRowsPerPass * Tile<D>::kStride * 2, ok ? p : base, ok);
      p += kRowsPerPass * stride_t;
    }
  }
};

// acc (16 x 64) += A[a_row0 .. a_row0+15][0, D) . B[0 .. 63][0, D)^T, both
// tiles in shared memory with the reduced axis contiguous (Q.K^T, dO.V^T and,
// transposed, K.Q^T and V.dO^T): plain ldmatrix for both operands.
template <int D>
static __device__ __forceinline__ void gemm_nt(float (&acc)[8][4], const __nv_bfloat16* sa,
                                               int a_row0, const __nv_bfloat16* sb) {
  constexpr int kS = Tile<D>::kStride;
  const int lane = threadIdx.x & 31;
  // A: the four 8x8 matrices are (rows 0-7, k 0-7), (rows 8-15, k 0-7),
  // (rows 0-7, k 8-15), (rows 8-15, k 8-15); lane i addresses a row of matrix i/8
  const uint32_t a_addr = smem_u32(sa + (a_row0 + (lane & 15)) * kS + (lane >> 4) * 8);
  // B: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  const uint32_t b_addr =
      smem_u32(sb + ((lane >> 4) * 8 + (lane & 7)) * kS + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_addr + ks * 32);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_addr + (np * 16 * kS + ks * 16) * 2);
      mma_16816(acc[2 * np], a, b[0], b[1]);
      mma_16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += P (16 x 64, in registers as 4 k-steps of A operands) .
// B[0 .. 63][0, D), B in shared memory with the reduced axis as rows (P.V,
// dS.K, P^T.dO, dS^T.Q): ldmatrix.trans.
template <int D>
static __device__ __forceinline__ void gemm_reg_nn(float (&acc)[D / 8][4],
                                                   const uint32_t (&p)[4][4],
                                                   const __nv_bfloat16* sb) {
  constexpr int kS = Tile<D>::kStride;
  const int lane = threadIdx.x & 31;
  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const uint32_t b_addr =
      smem_u32(sb + (((lane >> 3) & 1) * 8 + (lane & 7)) * kS + (lane >> 4) * 8);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, b_addr + (ks * 16 * kS + np * 16) * 2);
      mma_16816(acc[2 * np], p[ks], b[0], b[1]);
      mma_16816(acc[2 * np + 1], p[ks], b[2], b[3]);
    }
  }
}

// a 16 x 64 f32 accumulator -> the A operands of the next product, rounded to
// bf16 in registers
static __device__ __forceinline__ void pack_operand(uint32_t (&p)[4][4],
                                                    const float (&c)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    p[ks][0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
    p[ks][1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
    p[ks][2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    p[ks][3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

static __device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

static __device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// What a tile skip and a tile's mask-free fast path need to know of 64 rows
// t0 .. t0+63 of one batch row: the position range of the valid rows (seg >= 0;
// pmin > pmax when none is) and the segment range of all 64 (rows past t_len
// count with pad_seg < 0, so a tile with padding never has smin == smax >= 0).
// Every warp computes the same answer, so decisions taken from it are
// block-uniform without a barrier.
struct TileInfo {
  int pmin, pmax, smin, smax;
};

static __device__ __forceinline__ TileInfo scan_rows(const int* pos, const int* seg, int t0,
                                                     int t_len, int pad_seg) {
  const int lane = threadIdx.x & 31;
  const int ta = t0 + lane, tb = ta + 32;
  const int pa = ta < t_len ? pos[ta] : 0, sa = ta < t_len ? seg[ta] : pad_seg;
  const int pb = tb < t_len ? pos[tb] : 0, sb = tb < t_len ? seg[tb] : pad_seg;
  int mn = INT_MAX, mx = INT_MIN;
  if (sa >= 0) mn = mx = pa;
  if (sb >= 0) {
    mn = min(mn, pb);
    mx = max(mx, pb);
  }
  TileInfo r;
  r.pmin = __reduce_min_sync(0xffffffffu, mn);
  r.pmax = __reduce_max_sync(0xffffffffu, mx);
  r.smin = __reduce_min_sync(0xffffffffu, min(sa, sb));
  r.smax = __reduce_max_sync(0xffffffffu, max(sa, sb));
  return r;
}

// scan_rows of every 64-row tile of one batch row -> s_info[tile], the warps
// taking tiles in turn; the caller's barrier makes them visible.  Done once,
// so the walk over the tiles reads its skip decisions from shared memory
// instead of waiting on global loads in every step.
static __device__ __forceinline__ void scan_tiles(const int* pos, const int* seg, int t_len,
                                                  int pad_seg, int4* s_info, int n_tiles) {
  for (int t = threadIdx.x >> 5; t < n_tiles; t += kThreads / 32) {
    const TileInfo r = scan_rows(pos, seg, t * kTile, t_len, pad_seg);
    if ((threadIdx.x & 31) == 0) s_info[t] = make_int4(r.pmin, r.pmax, r.smin, r.smax);
  }
}

static __device__ __forceinline__ TileInfo tile_info(const int4* s_info, int t) {
  const int4 v = s_info[t];
  return TileInfo{v.x, v.y, v.z, v.w};
}

// bytes of the s_info array for a side of t_len rows
static inline int tile_info_bytes(int t_len) { return 16 * ((t_len + kTile - 1) / kTile); }

// One 4-byte value per row of the tile t0 .. t0+63 -> shared memory, by
// cp.async from N (even) [t_len] arrays of int or float (positions, segments,
// log-sum-exp, delta): threads 0-63 take the even arrays, 64-127 the odd ones.
// Rows past t_len are zero-filled; the mask's column count keeps them out.
// Joins the caller's group.
template <int N>
static __device__ __forceinline__ void load_rows(void* const (&dst)[N],
                                                 const void* const (&src)[N], int t0,
                                                 int t_len) {
  static_assert(N % 2 == 0 && kThreads == 2 * kTile, "two arrays per pass");
  const bool odd = threadIdx.x >= kTile;
  const int r = threadIdx.x & (kTile - 1);
  const bool ok = t0 + r < t_len;
#pragma unroll
  for (int a = 0; a < N; a += 2) {
    const int* p = static_cast<const int*>(odd ? src[a + 1] : src[a]);
    int* d = static_cast<int*>(odd ? dst[a + 1] : dst[a]);
    cp_async4(smem_u32(d + r), ok ? p + t0 + r : p, ok);
  }
}

// a (query range, key range) pair that no mask lets through: no valid row on
// either side, all keys in the queries' future (causal), or all keys below
// every query's window.  From positions, not flat indices, so queries and keys
// need not be aligned (chunked prefill, packed segments).
static __device__ __forceinline__ bool tile_runs(int q_min, int q_max, int k_min, int k_max,
                                                 int causal, int window) {
  bool run = q_min <= q_max && k_min <= k_max;
  if (causal) run = run && k_min <= q_max;
  if (window >= 0) run = run && (q_min - k_max <= window);
  return run;
}

// a pair of tiles in which every (query, key) pair passes every mask: all 128
// rows are valid and of one segment, no key is in a query's future, none
// below a query's window.  Such a tile takes the path without mask tests.
static __device__ __forceinline__ bool tile_full(const TileInfo& q, const TileInfo& k,
                                                 int causal, int window) {
  bool full = q.smin == q.smax && k.smin == k.smax && q.smin == k.smin && q.smin >= 0;
  if (causal) full = full && q.pmin >= k.pmax;
  if (window >= 0) full = full && (q.pmax - k.pmin <= window);
  return full;
}

static __device__ __forceinline__ bool allowed(int qseg, int kseg, int qp, int kp, int causal,
                                               int window) {
  bool a = qseg >= 0 && qseg == kseg;
  if (causal) a = a && qp >= kp;
  if (window >= 0) a = a && (qp - kp <= window);
  return a;
}

// The softmaxes run in base 2: scores are scaled by scale * log2(e) and the
// ALiBi slope by log2(e), so a probability is one ex2 of a difference.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

static __device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// A position as a float without an int-to-float conversion (which shares the
// ex2 unit's rate): 2^23 + p, exact for 0 <= p < 2^23, built in the
// mantissa.  Differences of two such values are the exact position
// differences, which is all ALiBi needs.
static __device__ __forceinline__ float biased_pos(int p) {
  return __int_as_float(p | 0x4B000000);
}

// log2(e) * (scale * q.k - slope * |qp - kp|): `slope2` is log2(e) * slope, or
// 0 for key position 0 (exempt) and without ALiBi; positions as biased_pos
template <bool ALIBI>
static __device__ __forceinline__ float score2(float qk, float scale2, float slope2, float qpf,
                                               float kpf) {
  if (ALIBI) return fmaf(qk, scale2, -slope2 * fabsf(qpf - kpf));
  return qk * scale2;
}

// log2(e) * the Voicebox ALiBi slope 2^{-(h+1)*8/H} of head h
static __device__ __forceinline__ float alibi_slope2(int h, int n_heads) {
  return kLog2e * exp2f(-(h + 1.0f) * (8.0f / n_heads));
}

// Mask, ALiBi and the online-softmax step of one 16 x 64 score tile in the
// m16n8 accumulator layout (the same for the bf16 m16n8k16 and the f32
// m16n8k8 products): sc (q.k sums) -> probabilities relative to the new row
// max; m, l and the output accumulator are rescaled.  FULL: every pair of the
// tile passes every mask.  `cols` is the count of keys the tile has.
template <int D, bool FULL, bool ALIBI>
static __device__ __forceinline__ void softmax_step(
    float (&sc)[8][4], float (&acc)[D / 8][4], float (&m)[2], float (&l)[2], const int* kp_s,
    const int* ks_s, int cols, const int (&qp)[2], const int (&qs)[2], int causal, int window,
    float scale2, float slope2) {
  const int c2 = (threadIdx.x & 3) * 2;
  const float qpf[2] = {biased_pos(qp[0]), biased_pos(qp[1])};
  uint32_t okm = 0;  // bit 4n + j: entry sc[n][j] passes the mask
  float mx[2] = {kNegInf, kNegInf};
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
      float val = score2<ALIBI>(sc[n][j], scale2, sl, qpf[row], biased_pos(kpj));
      if (!FULL) {
        const bool a = n * 8 + c2 + (j & 1) < cols &&
                       allowed(qs[row], (j & 1) ? ks.y : ks.x, qp[row], kpj, causal, window);
        okm |= (uint32_t)a << (4 * n + j);
        val = a ? val : kNegInf;
      }
      sc[n][j] = val;
      mx[row] = fmaxf(mx[row], val);
    }
  }
  float alpha[2];
#pragma unroll
  for (int row = 0; row < 2; ++row) {
    const float m_new = fmaxf(m[row], quad_max(mx[row]));
    alpha[row] = fast_exp2(m[row] - m_new);
    m[row] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float p = fast_exp2(sc[n][j] - m[j >> 1]);
      // a masked entry is 0 whatever the row's max (a fully-masked row has
      // max -1e30, and ex2(-1e30 - -1e30) would be 1)
      if (!FULL) p = (okm >> (4 * n + j)) & 1u ? p : 0.f;
      sc[n][j] = p;
      rs[j >> 1] += p;
    }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// two rows of a 16 x D f32 accumulator -> bf16 rows of a strided output
// (row pointers null for rows past the end); columns past d are dropped
template <int D>
static __device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                                  __nv_bfloat16* row0, __nv_bfloat16* row1,
                                                  int d, float f0, float f1) {
  const int c2 = (threadIdx.x & 3) * 2;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + c2;
    if (col >= d) break;
    if (row0)
      *reinterpret_cast<__nv_bfloat162*>(row0 + col) =
          __floats2bfloat162_rn(acc[n][0] * f0, acc[n][1] * f0);
    if (row1)
      *reinterpret_cast<__nv_bfloat162*>(row1 + col) =
          __floats2bfloat162_rn(acc[n][2] * f1, acc[n][3] * f1);
  }
}

// Opt a kernel in to `smem` bytes of dynamic shared memory (above the 48 KB
// default) and ask for the largest shared-memory carveout, so that as many
// blocks as the registers allow are resident on an SM.
template <typename Kernel>
static inline cudaError_t allow_smem(Kernel kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// the tile width a head_dim is computed at: the instantiated D >= d
#define USDM_FLASH_DISPATCH_D(d, CALL) \
  if ((d) <= 32) { CALL(32); }         \
  else if ((d) <= 64) { CALL(64); }    \
  else if ((d) <= 96) { CALL(96); }    \
  else { CALL(128); }

}  // namespace mma
}  // namespace usdm
