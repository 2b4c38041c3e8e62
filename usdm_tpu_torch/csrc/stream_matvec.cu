// K6: W8A8 decode matvec for Hopper: int8 tensor cores from 3 rows, __dp4a
// on the CUDA cores at 1-2 rows (qmv_dp4a_kernel below), the row
// quantization inside the launch on both routes.
//
// Replaces the Pallas TPU kernel usdm_tpu/ops/stream_matvec.py::_qmv_kernel
// (wrapper stream_qmv).  y [M, Din] (bf16 or f32, M <= 16) times an int8
// weight in "oi" layout, q [Dout, Din] with bf16 per-output scales s [Dout]:
//   1. each row of y is quantized: ys = max(amax / 127, 1e-8),
//      qx = clip(rint(y / ys), -127, 127), in the reference's IEEE operations
//      (round half to even);
//   2. acc = qx . q exactly in int32, then out = acc * ys * s in f32 in that
//      order (models/quant.py::qmm's epilogue), cast to out's dtype.
//
// Bound: the weight read.  Each weight byte is used M times (2M int8 ops a
// byte, far below the H100's ~590 int8 op/byte ridge), so the kernel is held
// to Dout * Din bytes over 3.35 TB/s: 17.5 us for one [14336, 4096]
// projection.  Design of the tensor-core route (route 1):
//   * Products: mma.sync.m16n8k32 s8 x s8 -> s32, the weights as A (16
//     output rows x 32 k), the quantized rows of y as B (n 8: one n-tile for
//     M <= 8, two for M <= 16).  The int32 sum is exact, so any permutation
//     of the contraction axis that A and B share gives the same bits: lane
//     (g, t) = (lane / 4, lane % 4) takes the 16 contiguous bytes
//     [16 t, 16 t + 16) of each 64-byte k-chunk of rows g and g + 8 as its A
//     fragments of two products, and the same bytes of activation row g as
//     its B fragments.
//   * Weights stream through a ring of 4 tiles a warp in shared memory (16
//     rows x 128 bytes, 3 in flight), fed by 16-byte cp.async.  The ring is
//     private to each warp, so the main loop has no block barrier:
//     cp.async.wait_group and __syncwarp order it.
//   * A block is 8 warps of 16 output rows.  Din is split over a
//     thread-block cluster of C blocks (C 1-8, cluster rank = blockIdx.x)
//     until the grid has ~1 block per SM, so small projections fill the
//     card; integer partials add exactly, and the cluster's rank 0 sums them
//     from its peers' shared memory (distributed shared memory) and runs the
//     epilogue once.
//   * Row quantization is fused in: a scale-only pre-pass launch writes
//     the M row scales (M floats, in the caller's buffer), and every block
//     quantizes its slice of y into shared memory while staging it, so qx
//     never goes to global memory.
//   What this route loses time on at 8-16 rows is its fixed chain per call
//   (pre-pass, staging, cluster reduction) and, where Dout is 4096, a grid of
//   one 8-warp block per SM: at [4096, 4096] and [4096, 14336] it is slower
//   than the two-launch __dp4a kernel it replaced (PERF.md).  4 warps a
//   block, 32 rows a warp, ring tiles of 256 or 512 bytes a row, a ring of 8
//   tiles and a split of Din into narrow slices added by integer atomics
//   gained nothing over this at the four 7B shapes.  At 1-2 rows the weight
//   stream alone sets the pace, and route 2's simpler loads (more of them in
//   flight) win.
// The TPU kernel's double-buffered manual DMA becomes the cp.async ring.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxM = 16;
constexpr int kChunk = 64;        // k bytes of one lane-set of two m16n8k32 products
constexpr int kTileChunks = 2;    // k-chunks of a ring tile: 16 rows x 128 bytes, 2 KB
constexpr int kStages = 4;        // ring tiles per warp, 3 in flight
constexpr int kPhaseChunks = 32;  // k-chunks of activations staged at once (2 KB a row)
constexpr int kWarps = 8;           // a block: 8 warps of 16 output rows
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerBlock = kWarps * 16;
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kTargetBlocks = 128;  // ~1 block per SM on 132 SMs

static __device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
static __device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c (16 x 8, s32) += a (16 x 32 s8, row-major) . b (32 x 8 s8, column-major)
static __device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3,
                                              int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 8 neighbouring values of y (16-byte aligned) as f32
static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    f[2 * i] = __low2float(h);
    f[2 * i + 1] = __high2float(h);
  }
}

static __device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

static __device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
}

static __device__ __forceinline__ uint32_t quant4(const float* f, float scale) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(f[i], scale)), -127.f), 127.f);
    r |= (uint32_t)(uint8_t)(int8_t)q << (8 * i);
  }
  return r;
}

// Shared-memory layout of one block, in bytes (host and device agree).
struct Layout {
  int ring, act_stride, act, red;
  __host__ __device__ Layout(int mb, int phase_chunks) {
    ring = kWarps * kStages * 16 * kTileChunks * kChunk;
    // a row stride of 64 mod 128 bytes keeps the 8 lanes of each quarter-warp
    // lds.128 (two rows x 64 bytes) on 32 different banks
    const int w = phase_chunks * kChunk;
    act_stride = (w % 128 == 0) ? w + 64 : w;
    act = mb * 8 * act_stride;
    red = kWarps * mb * 4 * 32 * 4;
  }
  __host__ __device__ int bytes() const { return ring + act + red; }
};

// The scale-only pre-pass: one block per row writes ys[m].
template <typename TI>
__global__ void __launch_bounds__(256) row_scales_kernel(const TI* __restrict__ y,
                                                         float* __restrict__ ys, int din) {
  __shared__ float s_red[8];
  const TI* row = y + (size_t)blockIdx.x * din;
  float a = 0.f;
#pragma unroll 4
  for (int v = threadIdx.x; v < din / 8; v += 256) {
    float f[8];
    load8(row + v * 8, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(f[e]));
  }
  a = usdm::warp_max(a);
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < 8; ++w) a = fmaxf(a, s_red[w]);
    ys[blockIdx.x] = row_scale(a);
  }
}

// grid (C, row blocks), cluster (C, 1, 1); block (x, y) takes k-chunks
// [x kc, (x + 1) kc) of rows [128 y, 128 (y + 1)), 16 a warp, with the
// pre-pass's row scales ys_in.  The staging gives each row of y a group of
// 256 / pow2(m) threads, 8 loads in flight each.  Activation rows >= m and
// columns >= Din are never written: they meet zero-filled weights or land
// in output columns nobody stores.
template <int MB, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
qmv_mma_kernel(const TI* __restrict__ y, const int8_t* __restrict__ w,
               const __nv_bfloat16* __restrict__ s, const float* __restrict__ ys_in,
               TO* __restrict__ out, int m, int dout, int din, int kc, int phase_chunks) {
  constexpr int J = kTileChunks;
  constexpr int kPieces = J * 4;           // 16-byte pieces of a tile row
  constexpr int kTileVecs = 16 * kPieces;  // int4 of one warp's ring tile
  constexpr int kCopies = kTileVecs / 32;  // cp.async per lane per tile
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_scale[kMaxM];
  cg::cluster_group cluster = cg::this_cluster();
  const Layout lay(MB, phase_chunks);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nk = (din + kChunk - 1) / kChunk;
  const int c_lo = min(nk, (int)blockIdx.x * kc), c_hi = min(nk, c_lo + kc);
  const int n_chunks = c_hi - c_lo;
  const int n_iters = (n_chunks + J - 1) / J;
  const int row0 = ((int)blockIdx.y * kWarps + warp) * 16;
  int4* ring = reinterpret_cast<int4*>(smem) + warp * kStages * kTileVecs;
  int8_t* act = reinterpret_cast<int8_t*>(smem + lay.ring);
  int* red = reinterpret_cast<int*>(smem + lay.ring + lay.act);

  // Copies: piece p = i * 32 + lane of a tile is row p / kPieces, piece
  // p % kPieces, so each warp-wide cp.async reads whole 128-byte lines of 4
  // rows.  A piece lands at (row, piece ^ 4 (row & 1)): the fragment reads
  // (rows g and g + 1 of a quarter-warp, 4 pieces each) then fall on 8
  // different 16-byte bank groups.
  auto fill_tile = [&](int it) {
    const int k0 = (c_lo + it * J) * kChunk, k_end = min(din, c_hi * kChunk);
    const int4* slot = ring + (it % kStages) * kTileVecs;
#pragma unroll
    for (int i = 0; i < kCopies; ++i) {
      const int p = i * 32 + lane, r = p / kPieces, q = p % kPieces;
      const int row = row0 + r, k = k0 + q * 16;
      const bool ok = row < dout && k < k_end;
      cp_async16(smem_u32(slot + r * kPieces + (q ^ ((r & 1) << 2))),
                 ok ? w + (size_t)row * din + k : w, ok);
    }
  };
  // the ring fills while the first phase is staged
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_iters) fill_tile(st);
    cp_async_commit();
  }

  // ---- the row scales (visible after the first phase's barrier); the
  // block's Din-slice is [k_lo, k_hi)
  const int k_lo = c_lo * kChunk, k_hi = min(din, c_hi * kChunk);
  const int tpr = kThreads / (m > 8 ? 16 : m > 4 ? 8 : m > 2 ? 4 : m);  // threads a row
  const int my_row = threadIdx.x / tpr, lr = threadIdx.x % tpr;
  const TI* y_row = y + (size_t)min(my_row, m - 1) * din;
  if (threadIdx.x < m) s_scale[threadIdx.x] = ys_in[threadIdx.x];

  // ---- products over the block's chunks, activations staged by phases
  int acc[MB][4];
#pragma unroll
  for (int n = 0; n < MB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0;
  const int phase_vecs = phase_chunks * kChunk / 8;
  for (int it = 0; it < n_iters; ++it) {
    const int c0 = it * J;  // first local chunk of this tile
    if (c0 % phase_chunks == 0) {
      // stage activation chunks [c0, c0 + phase_chunks) quantized into act
      __syncthreads();  // scales written; every warp done with the last phase
      if (my_row < m) {
        const int kp = k_lo + c0 * kChunk;
        const float sc = s_scale[my_row];
        int8_t* a_row = act + my_row * lay.act_stride;
#pragma unroll 8
        for (int v = lr; v < phase_vecs; v += tpr) {
          if (kp + v * 8 < k_hi) {
            float f[8];
            load8(y_row + kp + v * 8, f);
            *reinterpret_cast<uint2*>(a_row + v * 8) = make_uint2(quant4(f, sc),
                                                                  quant4(f + 4, sc));
          }
        }
      }
      __syncthreads();
    }
    cp_async_wait<kStages - 2>();
    __syncwarp();  // the tile's pieces were copied by the warp's other lanes
    const int4* tile = ring + (it % kStages) * kTileVecs;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int c = c0 + j;
      if (c < n_chunks) {  // warp-uniform
        const int8_t* a_src = act + g * lay.act_stride + (c % phase_chunks) * kChunk + tig * 16;
        int4 bv[MB];
#pragma unroll
        for (int n = 0; n < MB; ++n)
          bv[n] = *reinterpret_cast<const int4*>(a_src + n * 8 * lay.act_stride);
        const int q = j * 4 + tig, sw = (g & 1) << 2;  // rows g and g + 8: same parity
        const int4 lo = tile[g * kPieces + (q ^ sw)];
        const int4 hi = tile[(g + 8) * kPieces + (q ^ sw)];
#pragma unroll
        for (int n = 0; n < MB; ++n) {
          mma_s8(acc[n], lo.x, hi.x, lo.y, hi.y, bv[n].x, bv[n].y);
          mma_s8(acc[n], lo.z, hi.z, lo.w, hi.w, bv[n].z, bv[n].w);
        }
      }
    }
    __syncwarp();  // every lane is done with the tile before it is refilled
    if (it + kStages - 1 < n_iters) fill_tile(it + kStages - 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // ---- the cluster's integer partials meet in rank 0
  if (gridDim.x > 1) {
    int* mine = red + warp * (MB * 4 * 32) + lane;
#pragma unroll
    for (int n = 0; n < MB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = acc[n][e];
    cluster.sync();
    if (blockIdx.x == 0) {
#pragma unroll
      for (int r = 1; r < kMaxCluster; ++r) {
        if (r < (int)gridDim.x) {
          const int* peer = cluster.map_shared_rank(mine, r);
#pragma unroll
          for (int n = 0; n < MB; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += peer[(n * 4 + e) * 32];
        }
      }
    }
    cluster.sync();  // peers keep their shared memory until rank 0 has read it
    if (blockIdx.x != 0) return;
  }

  // ---- epilogue: (acc * ys) * s in f32; lane holds rows g, g + 8 and
  // columns (activation rows) 2 tig, 2 tig + 1 of each n-tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + h * 8 + g;
    if (row >= dout) continue;
    const float sc = __bfloat162float(s[row]);
#pragma unroll
    for (int n = 0; n < MB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int mm = n * 8 + tig * 2 + e;
        if (mm < m) {
          const float o =
              __fmul_rn(__fmul_rn(__int2float_rn(acc[n][h * 2 + e]), s_scale[mm]), sc);
          usdm::store(out + (size_t)mm * dout + row, o);
        }
      }
  }
}

// The CUDA-core route for 1-2 rows (route 2, __dp4a): a block of 8 warps
// owns 16 output rows, 2 a warp; each lane streams 16 bytes of each of its 2
// rows at a time (a warp reads 512 contiguous bytes of a row), __dp4a
// against the quantized activations of a 2048-column tile in shared memory.
// The block first takes the rows' amax over all of Din itself (M x Din
// values, from L2), then quantizes each tile while staging it.  At 1-2 rows
// the weight stream alone sets the pace and this simpler kernel keeps more
// loads in flight than the ring.  From 3 rows on every block quantizing all
// of Din costs more than the tensor cores' route (PERF.md).
constexpr int kDpRowsPerWarp = 2;
constexpr int kDpRowsPerBlock = kWarps * kDpRowsPerWarp;
constexpr int kDpTile = 2048;  // activation columns staged per tile
constexpr int kDpMaxRows = 2;  // route 2 takes up to 2 rows

__device__ __forceinline__ int dot16(const int4& a, const int4& b, int c) {
  c = __dp4a(a.x, b.x, c);
  c = __dp4a(a.y, b.y, c);
  c = __dp4a(a.z, b.z, c);
  return __dp4a(a.w, b.w, c);
}

template <int MB, typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
qmv_dp4a_kernel(const TI* __restrict__ y, const int8_t* __restrict__ w,
                const __nv_bfloat16* __restrict__ s, TO* __restrict__ out, int m, int dout,
                int din) {
  __shared__ __align__(16) int8_t s_x[MB][kDpTile];
  __shared__ float s_part[kWarps];
  __shared__ float s_scale[MB];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * kDpRowsPerBlock + warp * kDpRowsPerWarp;

  // row scales: kThreads / MB threads a row, 4 loads in flight each
  {
    constexpr int tpr = kThreads / MB;
    const int my_row = threadIdx.x / tpr, lr = threadIdx.x % tpr;
    float a = 0.f;
    if (my_row < m) {
      const TI* y_row = y + (size_t)my_row * din;
#pragma unroll 4
      for (int v = lr; v < din / 8; v += tpr) {
        float f[8];
        load8(y_row + v * 8, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaxf(a, fabsf(f[e]));
      }
    }
    a = usdm::warp_max(a);
    if (lane == 0) s_part[warp] = a;
    __syncthreads();
    if (threadIdx.x < m) {
      constexpr int wpr = kWarps / MB;
      float v = 0.f;
#pragma unroll
      for (int i = 0; i < wpr; ++i) v = fmaxf(v, s_part[threadIdx.x * wpr + i]);
      s_scale[threadIdx.x] = row_scale(v);
    }
  }

  int acc[kDpRowsPerWarp][MB];
#pragma unroll
  for (int r = 0; r < kDpRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < MB; ++i) acc[r][i] = 0;

  const int4 zero = make_int4(0, 0, 0, 0);
  for (int k0 = 0; k0 < din; k0 += kDpTile) {
    const int chunks = min(kDpTile, din - k0) >> 4;  // 16-byte chunks in this tile
    __syncthreads();  // scales written; s_x free again
    for (int i = threadIdx.x; i < MB * chunks * 2; i += kThreads) {
      const int mm = i / (chunks * 2), c = i - mm * chunks * 2;  // 8-column groups
      uint2 q = make_uint2(0u, 0u);
      if (mm < m) {
        float f[8];
        load8(y + (size_t)mm * din + k0 + c * 8, f);
        q = make_uint2(quant4(f, s_scale[mm]), quant4(f + 4, s_scale[mm]));
      }
      *reinterpret_cast<uint2*>(&s_x[mm][c * 8]) = q;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = lane; c < chunks; c += 32) {
      int4 wv[kDpRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kDpRowsPerWarp; ++r)
        wv[r] = row0 + r < dout
                    ? __ldg(reinterpret_cast<const int4*>(w + (size_t)(row0 + r) * din + k0) + c)
                    : zero;
#pragma unroll
      for (int i = 0; i < MB; ++i) {
        const int4 xv = *reinterpret_cast<const int4*>(&s_x[i][c * 16]);
#pragma unroll
        for (int r = 0; r < kDpRowsPerWarp; ++r) acc[r][i] = dot16(wv[r], xv, acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kDpRowsPerWarp; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int i = 0; i < MB; ++i) {
      int v = acc[r][i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0 && row < dout && i < m) {
        const float o = __fmul_rn(__fmul_rn(__int2float_rn(v), s_scale[i]),
                                  __bfloat162float(s[row]));
        usdm::store(out + (size_t)i * dout + row, o);
      }
    }
  }
}

struct Plan {
  int route, cluster, kc, phase_chunks, row_blocks;
};

// The plan from the shapes alone (the same bits whatever the card: an
// integer sum has no order).  Route 1 splits Din over the smallest cluster
// (1-8 blocks) that makes ~1 block per SM, keeping at least two ring tiles
// of k a block.
static Plan plan(int m, int dout, int din, int route) {
  Plan p;
  p.route = route > 0 ? route : m <= kDpMaxRows ? 2 : 1;
  p.row_blocks = (dout + kRowsPerBlock - 1) / kRowsPerBlock;
  const int nk = (din + kChunk - 1) / kChunk;
  p.cluster = 1;
  while (p.cluster < kMaxCluster && p.row_blocks * p.cluster < kTargetBlocks &&
         nk >= 2 * p.cluster * 2 * kTileChunks)
    p.cluster *= 2;
  p.kc = (nk + p.cluster - 1) / p.cluster;
  const int tiles = (p.kc + kTileChunks - 1) / kTileChunks;
  p.phase_chunks = std::min(kPhaseChunks, tiles * kTileChunks);
  return p;
}

template <int MB, typename TI, typename TO>
cudaError_t launch_mv(const TI* y, const int8_t* w, const __nv_bfloat16* s, const float* ys,
                      TO* out, int m, int dout, int din, const Plan& p, cudaStream_t st) {
  auto kern = qmv_mma_kernel<MB, TI, TO>;
  constexpr int kMaxDevices = 64;
  static bool opted_in[kMaxDevices] = {};  // per device, per instantiation
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout(MB, kPhaseChunks).bytes());
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, p.row_blocks, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Layout(MB, p.phase_chunks).bytes();
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, y, w, s, ys, out, m, dout, din, p.kc, p.phase_chunks);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t by_tiles(const TI* y, const int8_t* w, const __nv_bfloat16* s, const float* ys,
                     TO* out, int m, int dout, int din, const Plan& p, cudaStream_t st) {
  if (p.route == 2) {
    const dim3 grid((dout + kDpRowsPerBlock - 1) / kDpRowsPerBlock);
    if (m == 1)
      qmv_dp4a_kernel<1, TI, TO><<<grid, kThreads, 0, st>>>(y, w, s, out, m, dout, din);
    else
      qmv_dp4a_kernel<2, TI, TO><<<grid, kThreads, 0, st>>>(y, w, s, out, m, dout, din);
    return cudaGetLastError();
  }
  return m <= 8 ? launch_mv<1>(y, w, s, ys, out, m, dout, din, p, st)
                : launch_mv<2>(y, w, s, ys, out, m, dout, din, p, st);
}

template <typename TI>
cudaError_t by_out(const TI* y, const int8_t* w, const __nv_bfloat16* s, float* ws, void* out,
                   int m, int dout, int din, int out_dtype, const Plan& p, cudaStream_t st) {
  const float* ys = nullptr;
  if (p.route == 1) {  // the scale-only pre-pass
    row_scales_kernel<TI><<<m, 256, 0, st>>>(y, ws, din);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ys = ws;
  }
  if (out_dtype == usdm::kBF16)
    return by_tiles(y, w, s, ys, (__nv_bfloat16*)out, m, dout, din, p, st);
  if (out_dtype == usdm::kF32) return by_tiles(y, w, s, ys, (float*)out, m, dout, din, p, st);
  return cudaErrorInvalidValue;
}

int run(const void* y, const void* w, const void* s, void* ws, void* out, int m, int dout,
        int din, int in_dtype, int out_dtype, int route, void* stream) {
  if (m < 1 || m > kMaxM || dout < 1 || din < 16 || din % 16 != 0 || ws == nullptr ||
      route < 0 || route > 2 || (route == 2 && m > kDpMaxRows))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(m, dout, din, route);
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* w8 = (const int8_t*)w;
  const __nv_bfloat16* sb = (const __nv_bfloat16*)s;
  if (in_dtype == usdm::kBF16)
    return (int)by_out((const __nv_bfloat16*)y, w8, sb, (float*)ws, out, m, dout, din,
                       out_dtype, p, st);
  if (in_dtype == usdm::kF32)
    return (int)by_out((const float*)y, w8, sb, (float*)ws, out, m, dout, din, out_dtype, p,
                       st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// y [m, din] (in_dtype), w [dout, din] int8, s [dout] bf16 -> out [m, dout]
// (out_dtype); ws: 16 floats of the caller's for the pre-pass's row scales.
extern "C" int usdm_stream_qmv(const void* y, const void* w, const void* s, void* ws, void* out,
                               int m, int dout, int din, int in_dtype, int out_dtype,
                               void* stream) {
  return run(y, w, s, ws, out, m, dout, din, in_dtype, out_dtype, 0, stream);
}

// The same with the route forced (1: tensor cores, 2: __dp4a, at most 2
// rows): the tests hold both routes to the same bits.
extern "C" int usdm_stream_qmv_route(const void* y, const void* w, const void* s, void* ws,
                                     void* out, int m, int dout, int din, int in_dtype,
                                     int out_dtype, int route, void* stream) {
  return run(y, w, s, ws, out, m, dout, din, in_dtype, out_dtype, route, stream);
}
