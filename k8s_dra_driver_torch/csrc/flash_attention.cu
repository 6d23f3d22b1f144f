// Flash attention, forward and backward, for Hopper.
//
// Replaces the three TPU kernels of k8s_dra_driver_tpu/ops/flash_attention.py,
// each by a bf16 kernel on the tensor cores and an f32 kernel on the CUDA
// cores, chosen by dtype (ops/flash_attention.py: forward_kernel_for,
// backward_kernel_for):
//   flash_fwd_wgmma / flash_fwd_fma         <- `_flash_kernel` (causal or full
//                     attention with the online softmax; also lse = m + log l),
//   flash_bwd_dq_wgmma / flash_bwd_dq_fma   <- `_dq_kernel`  (dQ, recomputing
//                     P from lse),
//   flash_bwd_dkv_wgmma / flash_bwd_dkv_fma <- `_dkv_kernel` (dK and dV,
//                     recomputing P from lse).
//
// Layout: q, k, v, out, dout, dq, dk, dv are [BH, S, D] (row-major, the
// `to_bh` layout), lse and delta are [BH, S] f32 (one value per row, not the
// TPU's 128-lane broadcast).  The wgmma kernels take bfloat16 q, k, v, dout
// with 16-byte-aligned bases (TMA reads from nothing else), the fma kernels
// float32, the backward ones with 16-byte-aligned bases too (cp.async reads 16
// bytes at a time); dq/dk/dv come out in the input dtype, and the bf16 forward may
// write out in float32 (`out_f32`, the ring composition's partials).  Head
// dims 16, 32, 64, 128.  Any S: the ragged last tile is masked here.
//
// What it computes, with scale = 1/sqrt(D) and masked scores at -1e30:
//   s  = (q . k) * scale                      f32 dot, scaled after the dot
//   fwd: online softmax over k tiles in f32; p rounded to the input type
//        before P.V; out = acc / l rounded once; lse = m + log l
//   p  = exp(s - lse),  dp = dout . v (f32),  ds = p * (dp - delta)
//   dq = scale * sum_k ds(rounded to T) * k
//   dv = sum_q p(rounded to T) * dout,  dk = scale * sum_q ds(rounded to T) * q
// The casts sit where the Pallas kernels put them.  delta = rowsum(dout*out)
// is computed outside, as in the JAX package.
//
// Design.  Pallas carries (m, l, acc) across a grid that runs in order; Hopper
// blocks run in no order, so each block owns its output tile and loops over
// the other sequence axis itself:
//   fwd, dq: one block per (bh, 64-row q tile), looping over 64-key tiles up
//            to the diagonal (causal) or to S, the longest q tiles first;
//   dkv:     one block per (bh, 64-key tile), looping over q tiles from the
//            diagonal on (causal) or from 0, the first key tiles first.
// dQ and dK/dV stay two passes, as in Pallas, so every output element is
// written by exactly one block: no atomics, and repeated calls give the same
// bits.
//
// What bounds them on this card.  At the training shape (BH 64, S 1024, D 64,
// bf16, causal) the forward moves 33.8 MB and does 8.6 GFLOP, dQ 42.5 MB and
// 12.9 GFLOP, dK/dV 50.9 MB and 17.2 GFLOP: at 989 TFLOP/s and 3.35 TB/s the
// least times are 10.1, 13.0 and 17.4 us, operations-bound for both backward
// passes and nearly so for the forward.  Only the tensor cores come near it.
//
// The bf16 kernels run every product there.  One warpgroup per block owns a
// 64-row output tile.  Tiles are [64 x D] bf16 in shared memory, 128-byte
// swizzled (64-byte, 32-byte at D 32, 16) as TMA writes them.  The block's own
// tiles come once; the other axis's pair of tiles comes through a 2-stage ring,
// each stage guarded by an mbarrier: while the block works on tile j, the TMA
// load of tile j + 1 is in flight, and tile j + 2 is requested as soon as tile
// j's stage is read.  Every product has one of two shapes:
//   * A . B^T over D, both tiles K-major: an m64n64k16 wgmma per 16 of D from
//     shared memory, f32 accumulators (forward Q K^T; dQ's Q K^T and dO V^T;
//     dK/dV's K Q^T and V dO^T, issued together before one wait);
//   * a 64 x 64 f32 fragment rounded to bf16 in registers times a [64 x D]
//     tile: the fragment's 16-column slices are, as they stand, the A operand
//     of an m64nDk16 wgmma, and B is the tile read MN-major through the
//     transpose bit (forward P V; dQ's dS K; dK/dV's P^T dO and dS^T Q).
// Scores are scaled after the dot and masked on the fragment, on the diagonal
// tile and on the ragged tile only (TMA's zero fill is no mask: lse read as 0
// past S would give p = 1 there).  A thread's fragment holds 2 rows and 16
// columns of each 64 x 64 tile, so the forward's row max and sum take two
// shuffles, dQ keeps its two rows' lse and delta in registers, and dK/dV reads
// the ring tile's 64 lse and delta values by column from shared memory, where
// they are stored one tile ahead from loads issued an iteration earlier.  The
// thread that issues TMA is the consumer warpgroup's own thread 0, not a
// separate producer warp: each block waits on its products before the
// arithmetic on their fragments, and two to four blocks on an SM overlap one
// another instead.  At D 128 dK/dV's 64 + 64 accumulators and two score tiles
// would not fit in 255 registers a thread, so two warpgroups split dK's and
// dV's columns, each recomputing the score tiles (1.5x the products).
//
// The f32 kernels (flash_fwd_fma_kernel, flash_bwd_dq_fma_kernel,
// flash_bwd_dkv_fma_kernel) do their products as f32 FMAs on the CUDA cores.
// For f32 that is the design, not a stopgap: the tensor cores take f32 only
// as TF32 (a 10-bit mantissa), far outside the 2^-16 limit.  Their bound is
// 67 TFLOP/s of f32 FMAs: at the training shape in f32, 128.3 us for the
// forward, 192.5 us for dQ and 256.7 us for dK/dV.
//
// The three are built around what an SM sustains.  Measured on an H100
// (bench/fma_bench.py), a loop of f32 FMAs fed from shared memory runs at
// 57% of the FMA rate with 4x4 blocks of two products a thread, 61% with one
// 8x4 block and 68% with 8x8, whether it reads one float or four at a time;
// so the per-thread block sets the ceiling, and the rest of the time goes to
// the phases between the products (exp, barriers, copies), which need other
// warps to hide them.  What they share:
//   * Groups of 128 threads.  A thread owns an 8x4 block of its group's
//     64x64 score tile (8 rows, columns tx + 16 j): per 4 elements of D, 8 +
//     4 float4 loads for 128 FMAs on 32 independent chains.  In the second
//     products it owns the same 8 rows of the output and D/16 of its
//     columns, read and written V = min(4, D/16) at a time.
//   * p = 2^(s scale log2 e - c log2 e), one MUFU op, with c the row's
//     running max (forward) or its lse (backward); 0 where masked, the masks
//     evaluated only on tiles that cross the diagonal or S.
//   * Tiles read by 16-byte cp.async land in rows padded to D+4 floats (a
//     multiple of 16 bytes); rows at or past S are zero-filled through the
//     copy's src-size operand (TMA fills them with zeros itself), and the
//     masks stay explicit on the fragment all the same (p = 0 there, not
//     exp(0 - lse)).  (D+4)/4 is odd, so the 16-byte words of 8 neighbouring
//     rows at one column fall in distinct bank quads.
//   * Two blocks an SM at D <= 64 (the carveout set to the most shared
//     memory), so that one block's exp, exchange and barriers overlap the
//     other's products; one at D 128.
//
// The forward is one group per (bh, 64-row q tile), 128 threads.
//   * Rows.  A warp owns 16 consecutive rows (a thread's rows are ty + 2 i,
//     its half-warp taking the even or the odd ones), so a row's 64 scores
//     lie in the 16 lanes of one half-warp: the row max is 4 shuffles, the
//     thread that owns a row in S owns it in O, so m, l and the correction
//     stay in its registers, and P goes from S to P.V through shared memory
//     rows that only the warp writes and reads, behind a __syncwarp instead
//     of a block barrier.  A thread keeps its 4 columns' share of l; the 16
//     shares are summed once, at the end, in a fixed order.
//   * Copies.  Q lands once, by cp.async.  K and V come by TMA (one thread
//     issues whole tiles, no per-thread copy instructions) through a 2-stage
//     ring, each stage behind an mbarrier.  At the top of iteration j the
//     threads wait for tile j's barrier, then one block barrier says that
//     iteration j - 1 no longer reads the other stage, which is then refilled
//     with tile j + 1 while tile j is used.  Per-thread 16-byte cp.async of
//     the same tiles, tried first, cost the products several percent of the
//     kernel's time in copy instructions.
//   * Banks.  A warp reads Q by 2 rows at a time (one wavefront), K by 16
//     rows at one column and V by 16 neighbouring vectors of one row (two
//     wavefronts each, the fewest 256 bytes allow).  So V is stored as TMA
//     writes it unswizzled, dense rows of D floats, and K swizzled in panels
//     of 128-byte rows (64 at D 16): the 16-byte unit u of row r sits at unit
//     u ^ (r % 8) (u ^ (r / 2 % 4)), and a thread's 4 K rows share that key.
//     The P tile's rows are 80 floats apart (80 mod 32 = 16), which puts a
//     warp's 32 scalar stores (2 rows x 16 columns) on 32 distinct banks.
//   * Each product loop takes two steps (8 elements of D, or 8 keys) an
//     iteration, so that one step's loads are in flight during the other's
//     FMAs: 168 registers at D 64, which two 128-thread blocks an SM allow.
//   * m is kept as the largest raw dot q.k, so lse = m scale + log l is the
//     Pallas kernel's m + log l; out = acc / l, rounded once.
//   * Shared memory: 2 K and 2 V tiles, Q, P and 1 KB of alignment: 42, 62,
//     102 and 182 KB at D 16, 32, 64, 128.
//
// The backward pair:
//   * Groups.  A block is two groups, one per score product: dQ's group A
//     computes S = Q K^T, B dP = dO V^T; dK/dV's A computes S^T = K Q^T, B
//     dP^T = V dO^T; a thread's rows are ty + 8 i.  A writes p to a shared
//     P tile; B then turns it into ds = p (dp - delta) in place (dQ) or into
//     a dS^T tile (dK/dV).  This exchange sits on the critical path of every
//     tile, so it is kept short: lse and delta are in registers, not reread
//     from shared memory per element.  The second products split the same
//     way: in dK/dV A does dV = P^T dO and B dK = dS^T Q; in dQ A sums dS K
//     over the first 32 keys of each tile and B over the last 32, and B's
//     sums join A's through shared memory once, at the end, in a fixed
//     order.
//   * Two blocks an SM at D <= 64 take <= 128 registers a thread (256
//     threads a block) and ~105 KB of shared memory each.
//   * Copies.  The block's own tiles (Q and dO for dQ; K and V for dK/dV)
//     land once.  dQ keeps K in a 2-stage ring (tile j + 1 is copied while
//     tile j is used, released by cp.async.wait_group and one barrier) and V
//     in one buffer, refilled as soon as the score products have read it.
//     dK/dV holds one Q/dO tile, with its 64 lse and delta values copied 4
//     bytes at a time, refilled after the second products: a second stage
//     would not fit beside a second block, and the other block covers the
//     copy.
//   * Banks.  A warp is an 8 (tx) x 4 (ty) patch of its group's thread grid,
//     so an LDS.128 reads 4 rows or 8 rows of a tile, or 8 neighbouring
//     vectors of one row.  The P/dS tiles have rows of 72 floats, which put
//     a warp's 32 scalar stores (4 rows x 8 columns) on 32 distinct banks.
//   * Shared memory: dQ holds Q, dO, 2 K tiles, V and dS: 43, 63, 103 and 183
//     KB at D 16, 32, 64, 128; dK/dV holds K, V, Q, dO, P^T, dS^T, lse and
//     delta: 56.5, 72.5, 104.5 and 168.5 KB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // key rows per tile
constexpr float NEG_INF = -1e30f;
constexpr size_t MAX_SMEM = 232448;  // bytes of shared memory a block may have

static_assert(BQ == BK, "the causal tile walks below assume square tiles");

// ---- f32 on the CUDA cores: what the three kernels share ----------------------

constexpr float LOG2E = 1.4426950408889634f;

// 2^x by one MUFU instruction, results under 2^-126 flushed to 0 (exp2f
// spends a few more instructions on them: 14 us of dQ's time at the
// training shape on an H100)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// reductions over the 16 lanes of a half-warp
__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int SV = 4;  // elements of D a score product reads at once (one float4)

// A group is 128 threads; a thread owns a BR x BC block of its group's 64 x
// 64 score tile, rows RS apart and columns tx + GX j.  A backward block is
// two groups, the forward's one.
constexpr int GROUP = 128;
constexpr int THREADS = 2 * GROUP;
constexpr int BR = 8, BC = 4;
constexpr int GY = BQ / BR, GX = BK / BC;  // 8 x 16 threads
constexpr int LS = 72;  // row stride of the backward's P/dS tiles

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread has issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + 64) of one [S, D] f32 slab into shared memory with row
// stride D + 4, by 16-byte cp.async from NT threads; rows at or past S are
// zero-filled
template <int D, int NT = THREADS>
__device__ __forceinline__ void copy_tile(float* dst, const float* __restrict__ src, int row0,
                                          int S) {
  constexpr int C = D / 4;  // 16-byte pieces per row
  static_assert(BQ * C % NT == 0, "a tile's pieces must split evenly over the threads");
#pragma unroll
  for (int it = 0; it < BQ * C / NT; ++it) {
    const int i = threadIdx.x + it * NT;
    const int r = i / C, c = i % C, g = row0 + r;
    cp_async16(dst + r * (D + 4) + 4 * c, src + (size_t)(g < S ? g : 0) * D + 4 * c, g < S);
  }
}

// V consecutive floats (V = 1, 2, 4) as one load or store
template <int V>
__device__ __forceinline__ void load_vec(float (&r)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

// a thread's output columns V tx + GX V h + u: V features as one vector,
// D / GX / V vectors a row
template <int D> __host__ __device__ constexpr int out_vec() { return D >= 64 ? 4 : D / GX; }

// where element e of a padded row sits: at e
struct Padded {
  __device__ int operator()(int e) const { return e; }
};

// One score product, s[i][j] += a_i . b_j over D: a_i = a + RS i (D+4) is
// one of the thread's rows, b_j = b + GX j LB one of its columns, its element
// e at b_j + col(e); SV consecutive elements of each come as one vector, U
// steps of SV a loop iteration, and each sum runs over D in order.
template <int D, int RS = GY, int U = 1, int LB = D + 4, typename Col = Padded>
__device__ __forceinline__ void score_product(float (&s)[BR][BC], const float* a, const float* b,
                                              Col col = Col()) {
  constexpr int LD = D + 4;
  static_assert(D % (U * SV) == 0, "the unrolled steps must divide D");
#pragma unroll 1  // more would push the backward at D 64 past 128 registers
  for (int e0 = 0; e0 < D; e0 += U * SV) {
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int e = e0 + uu * SV;
      const float* be = b + col(e);
      float ar[BR][SV], br[BC][SV];
#pragma unroll
      for (int i = 0; i < BR; ++i) load_vec<SV>(ar[i], a + i * RS * LD + e);
#pragma unroll
      for (int j = 0; j < BC; ++j) load_vec<SV>(br[j], be + j * GX * LB);
#pragma unroll
      for (int u = 0; u < SV; ++u)
#pragma unroll
        for (int i = 0; i < BR; ++i)
#pragma unroll
          for (int j = 0; j < BC; ++j) s[i][j] = fmaf(ar[i][u], br[j][u], s[i][j]);
    }
  }
}

// One second product over N rows of a [N x D] tile x with rows LX floats
// apart:
//   acc[i][V h + u] += sum_{r < N} w_i[r] x[r LX + GX V h + u],
// w_i = w + RS i LW one of the thread's rows of a P or dS tile (row stride
// LW), read 4 entries at a time as one float4; x points at the thread's first
// output column and is read as V-wide vectors; U steps of 4 rows a loop
// iteration, and each sum runs over r in order.
template <int D, int N, int RS = GY, int LW = LS, int U = 1, int LX = D + 4>
__device__ __forceinline__ void tile_product(float (&acc)[BR][D / GX], const float* w,
                                             const float* x) {
  constexpr int V = out_vec<D>(), NV = D / GX / V;
  static_assert(N % (4 * U) == 0, "the unrolled steps must divide N");
#pragma unroll 1
  for (int r0 = 0; r0 < N; r0 += 4 * U) {
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const int r = r0 + 4 * uu;
      float wr[BR][4];
#pragma unroll
      for (int i = 0; i < BR; ++i) load_vec<4>(wr[i], w + i * RS * LW + r);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float xr[NV][V];
#pragma unroll
        for (int h = 0; h < NV; ++h) load_vec<V>(xr[h], x + (r + u) * LX + GX * V * h);
#pragma unroll
        for (int i = 0; i < BR; ++i)
#pragma unroll
          for (int h = 0; h < NV; ++h)
#pragma unroll
            for (int e = 0; e < V; ++e)
              acc[i][h * V + e] = fmaf(wr[i][u], xr[h][e], acc[i][h * V + e]);
      }
    }
  }
}

// p, a pointer into shared memory, moved up to the next multiple of 1024
// bytes; offset from p rather than rebuilt from an integer, so that the
// compiler still reads through it with shared-memory loads
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_addr(p) & 1023)) & 1023);
}

// blocks an SM runs at once: 2 where shared memory allows (D <= 64)
template <int D> __host__ __device__ constexpr int fma_blocks() { return D <= 64 ? 2 : 1; }

// number of 64-key tiles a q tile starting at q0 attends
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  int n = (S + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

// ---- the f32 forward: one group per 64-row q tile, K/V by TMA through a 2-stage ring

constexpr int FR = 2;   // a forward thread's rows are ty + FR i
constexpr int LP = 80;  // row stride of the forward's P tile
constexpr int FU = 2;   // steps of the forward's product loops an iteration

// The forward's K and V tiles, [64 x D] f32 each as TMA writes them.  K is
// D / PW panels of [64 rows x PW floats] (rows of 128 bytes, 64 at D 16),
// swizzled: the 16-byte unit u of row r sits at unit u ^ key(r), key(r) =
// r % 8 (128-byte rows) or r / 2 % 4 (64-byte rows).  V is dense rows of D
// floats.
template <int D>
struct FwdTiles {
  static constexpr int PW = D < 32 ? D : 32;  // panel width, floats
  static constexpr int PANEL = BK * PW;       // floats a panel
  static constexpr int FLOATS = BK * D;       // floats a tile
  static constexpr int BYTES = 4 * FLOATS;
};

// where element e of a swizzled K row with key `key` sits
template <int D>
struct SwizzledCol {
  int key;
  __device__ int operator()(int e) const {
    using T = FwdTiles<D>;
    return e / T::PW * T::PANEL + ((e % T::PW / 4) ^ key) * 4;
  }
};

// K and V tile j of head bh into k_s and v_s, completing on bar (one
// thread)
template <int D>
__device__ __forceinline__ void fwd_load_kv(float* k_s, float* v_s, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap, uint64_t* bar, int j,
                                            int bh) {
  using T = FwdTiles<D>;
  hopper::mbar_expect_tx(bar, 2 * T::BYTES);
#pragma unroll
  for (int p = 0; p < D / T::PW; ++p)
    hopper::tma_load_3d(k_s + p * T::PANEL, kmap, bar, p * T::PW, j * BK, bh);
  hopper::tma_load_3d(v_s, vmap, bar, 0, j * BK, bh);
}

// kmap reads [BH, S, D] f32 in boxes of [1 x 64 rows x PW], swizzled; vmap
// in boxes of [1 x 64 rows x D]; rows at or past S read as 0.  q is read
// by 16-byte cp.async.  grid (BH, ceil(S / 64)), 128 threads.
template <int D>
__global__ void __launch_bounds__(GROUP, fma_blocks<D>())
flash_fwd_fma_kernel(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const float* __restrict__ q,
                     float* __restrict__ out, float* __restrict__ lse, int S, int causal,
                     float scale) {
  using T = FwdTiles<D>;
  constexpr int LD = D + 4, EC = D / GX, V = out_vec<D>(), NV = EC / V;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  // warp w owns rows [16 w, 16 w + 16): half-warp h the rows 16 w + h + 2 i
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int tx = lane % 16, ty = 16 * w + lane / 16;
  extern __shared__ uint8_t smem_raw[];
  float* k_s = reinterpret_cast<float*>(align_1024(smem_raw));  // [2 stages][64 x D]
  float* v_s = k_s + 2 * T::FLOATS;                             // [2 stages][64 x D]
  float* q_s = v_s + 2 * T::FLOATS;                             // [BQ][LD]
  float* p_s = q_s + BQ * LD;                                   // [BQ][LP]
  uint64_t* bar = reinterpret_cast<uint64_t*>(p_s + BQ * LP);   // [2 stages]
  const size_t base = (size_t)bh * S * D;
  const int n_kt = key_tiles(q0, S, causal);
  if (threadIdx.x == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::mbar_init_fence();
    fwd_load_kv<D>(k_s, v_s, &kmap, &vmap, &bar[0], 0, bh);
  }
  copy_tile<D, GROUP>(q_s, q + base, q0, S);
  cp_async_commit();

  // per row: m the largest raw dot q . k so far (p = 2^(s sl2 - m sl2)), l
  // this thread's columns' share of the row's sum of p
  const float sl2 = scale * LOG2E;
  float m[BR], l[BR], acc[BR][EC];
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;
  }
  const float* qa = q_s + ty * LD;
  // the thread's K rows tx + GX j share their swizzle key
  const SwizzledCol<D> kcol{T::PW == 32 ? tx % 8 : tx / 2 % 4};
  cp_async_wait_all();
  __syncthreads();  // Q is in; the barriers are initialised

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK, s = kt & 1;
    hopper::mbar_wait(&bar[s], (kt >> 1) & 1);
    __syncthreads();  // tile kt is in; iteration kt - 1 no longer reads the other stage
    if (threadIdx.x == 0 && kt + 1 < n_kt)
      fwd_load_kv<D>(k_s + (s ^ 1) * T::FLOATS, v_s + (s ^ 1) * T::FLOATS, &kmap, &vmap,
                     &bar[s ^ 1], kt + 1, bh);

    float x[BR][BC] = {};
    score_product<D, FR, FU, T::PW>(x, qa, k_s + s * T::FLOATS + tx * T::PW, kcol);
    const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
    float* p_t = p_s + ty * LP + tx;  // the thread's (0, 0) entry
#pragma unroll
    for (int i = 0; i < BR; ++i) {
      const int qp = q0 + ty + FR * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BC; ++j) {
        const int kp = k0 + tx + GX * j;
        if (edge && (kp >= S || (causal && kp > qp))) x[i][j] = NEG_INF;
        mx = fmaxf(mx, x[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float mb = m_new * sl2;
      const float corr = exp2_ftz(fmaf(m[i], sl2, -mb));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BC; ++j) {
        const float p = exp2_ftz(fmaf(x[i][j], sl2, -mb));
        sum += p;
        p_t[FR * i * LP + GX * j] = p;
      }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < EC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();  // the warp's rows of p are in
    tile_product<D, BK, FR, LP, FU, D>(acc, p_s + ty * LP, v_s + s * T::FLOATS + V * tx);
  }

#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const float l_row = half_sum(l[i]);  // every lane takes part
    const int qp = q0 + ty + FR * i;
    if (qp >= S) continue;
    float* row = out + base + (size_t)qp * D + V * tx;
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = acc[i][h * V + e] / l_row;
      store_vec<V>(row + GX * V * h, o);
    }
    if (tx == 0) lse[(size_t)bh * S + qp] = m[i] * scale + logf(l_row);
  }
}

// ---- the f32 backward: one product per group ----------------------------------

// the thread's rows (row0 + ty + GY i) of a [64 x D] output tile, scaled, to
// global memory; rows at or past S are not written
template <int D>
__device__ __forceinline__ void store_rows(float* out, const float (&acc)[BR][D / GX], int row0,
                                           int S, int tx, int ty, float scale) {
  constexpr int V = out_vec<D>(), NV = D / GX / V;
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int g = row0 + ty + GY * i;
    if (g >= S) continue;
#pragma unroll
    for (int h = 0; h < NV; ++h) {
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) o[e] = scale * acc[i][h * V + e];
      store_vec<V>(out + (size_t)g * D + V * tx + GX * V * h, o);
    }
  }
}

// a group's thread grid: each of its 4 warps is an 8 x 4 patch, tx in
// [8 (w % 2), +8), ty in [4 (w / 2 % 2), +4), so a warp reads 4 rows and 8
// columns of the score tiles
__device__ __forceinline__ int bwd_tx() { return threadIdx.x % 8 + 8 * (threadIdx.x / 32 % 2); }
__device__ __forceinline__ int bwd_ty() { return threadIdx.x % 32 / 8 + 4 * (threadIdx.x / 64 % 2); }

template <int D>
__global__ void __launch_bounds__(THREADS, fma_blocks<D>())
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int causal, float scale) {
  constexpr int LD = D + 4, TILE = BQ * LD, EC = D / GX;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  // group A: S = Q K^T, then dQ over keys [0, 32) of each tile; group B:
  // dP = dO V^T, then dQ over keys [32, 64)
  const bool a = threadIdx.x < GROUP;
  const int tx = bwd_tx(), ty = bwd_ty();
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][LD]
  float* do_s = q_s + TILE;       // [BQ][LD]
  float* k_s = do_s + TILE;       // [2 stages][BK][LD]
  float* v_s = k_s + 2 * TILE;    // [BK][LD]
  float* ds_s = v_s + TILE;       // [BQ][LS], p, then ds
  const size_t base = (size_t)bh * S * D;
  copy_tile<D>(q_s, q + base, q0, S);
  copy_tile<D>(do_s, dout + base, q0, S);
  copy_tile<D>(k_s, k + base, 0, S);
  copy_tile<D>(v_s, v + base, 0, S);
  cp_async_commit();

  // A keeps its rows' lse log2 e (p = 2^(s scale log2 e - lse log2 e)), B
  // their delta
  const float sl2 = scale * LOG2E;
  float row_r[BR], acc[BR][EC];
#pragma unroll
  for (int i = 0; i < BR; ++i) {
    const int qp = q0 + ty + GY * i;
    row_r[i] = qp >= S ? 0.f : a ? lse[(size_t)bh * S + qp] * LOG2E : delta[(size_t)bh * S + qp];
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    const float* k_t = k_s + (kt & 1) * TILE;
    cp_async_wait_all();
    __syncthreads();  // K and V of tile kt are in; iteration kt - 1 no longer reads ds_s or k_t's twin
    if (kt + 1 < n_kt) {
      copy_tile<D>(k_s + ((kt + 1) & 1) * TILE, k + base, k0 + BK, S);
      cp_async_commit();
    }

    float x[BR][BC] = {};  // A: s, B: dp
    score_product<D>(x, (a ? q_s : do_s) + ty * LD, (a ? k_t : v_s) + tx * LD);
    float* ds_t = ds_s + ty * LS + tx;  // the thread's (0, 0) entry
    if (a) {
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        const int qp = q0 + ty + GY * i;
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          const int kp = k0 + tx + GX * j;
          const bool masked = edge && (kp >= S || (causal && kp > qp));
          ds_t[GY * i * LS + GX * j] = masked ? 0.f : exp2_ftz(fmaf(x[i][j], sl2, -row_r[i]));
        }
      }
    }
    __syncthreads();  // p is in; V of tile kt is read
    if (kt + 1 < n_kt) {
      copy_tile<D>(v_s, v + base, k0 + BK, S);
      cp_async_commit();
    }
    if (!a) {
#pragma unroll
      for (int i = 0; i < BR; ++i)
#pragma unroll
        for (int j = 0; j < BC; ++j) {
          float* e = ds_t + GY * i * LS + GX * j;
          *e = *e * (x[i][j] - row_r[i]);
        }
    }
    __syncthreads();  // ds is in
    const int kh = a ? 0 : BK / 2;
    tile_product<D, BK / 2>(acc, ds_s + ty * LS + kh, k_t + kh * LD + out_vec<D>() * tx);
  }

  // B's sums meet A's through shared memory, A's first: q_s and do_s were
  // last read before the loop's last barrier
  float* part = smem;  // [BR * EC][GROUP]
  const int t = threadIdx.x % GROUP;
  if (!a) {
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int c = 0; c < EC; ++c) part[(i * EC + c) * GROUP + t] = acc[i][c];
  }
  __syncthreads();
  if (a) {
#pragma unroll
    for (int i = 0; i < BR; ++i)
#pragma unroll
      for (int c = 0; c < EC; ++c) acc[i][c] += part[(i * EC + c) * GROUP + t];
    store_rows<D>(dq + base, acc, q0, S, tx, ty, scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, fma_blocks<D>())
flash_bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int causal,
                         float scale) {
  constexpr int LD = D + 4, TILE = BQ * LD, EC = D / GX;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most q tiles
  // group A: S^T = K Q^T, then dV = P^T dO; group B: dP^T = V dO^T, then
  // dK = dS^T Q.  A thread's rows are keys, its score columns queries.
  const bool a = threadIdx.x < GROUP;
  const int tx = bwd_tx(), ty = bwd_ty();
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][LD]
  float* v_s = k_s + TILE;         // [BK][LD]
  float* q_s = v_s + TILE;         // [BQ][LD]
  float* do_s = q_s + TILE;        // [BQ][LD]
  float* pt_s = do_s + TILE;       // [BK][LS], p^T
  float* dst_s = pt_s + BK * LS;   // [BK][LS], ds^T
  float* lse_s = dst_s + BK * LS;  // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]
  const size_t base = (size_t)bh * S * D;

  // q tile qt: its q, dout, lse and delta
  auto copy_q_tile = [&](int qt) {
    const int q0 = qt * BQ;
    copy_tile<D>(q_s, q + base, q0, S);
    copy_tile<D>(do_s, dout + base, q0, S);
    if (threadIdx.x < 2 * BQ) {
      const int qp = q0 + threadIdx.x % BQ;
      cp_async4(lse_s + threadIdx.x,
                (threadIdx.x < BQ ? lse : delta) + (size_t)bh * S + (qp < S ? qp : 0), qp < S);
    }
    cp_async_commit();
  };

  // causal: q tiles whose last row reaches k0, i.e. from the diagonal tile on
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (S + BQ - 1) / BQ;
  copy_tile<D>(k_s, k + base, k0, S);
  copy_tile<D>(v_s, v + base, k0, S);
  copy_q_tile(qt0);

  const float sl2 = scale * LOG2E;
  float acc[BR][EC];  // A: dv, B: dk
#pragma unroll
  for (int i = 0; i < BR; ++i)
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    cp_async_wait_all();
    __syncthreads();  // q tile qt is in

    float x[BR][BC] = {};  // A: s^T, B: dp^T
    score_product<D>(x, (a ? k_s : v_s) + ty * LD, (a ? q_s : do_s) + tx * LD);
    // A: lse log2 e of the thread's columns, B: their delta (read once: the
    // stores below may alias them for the compiler)
    float col_r[BC];
#pragma unroll
    for (int c = 0; c < BC; ++c)
      col_r[c] = a ? lse_s[tx + GX * c] * LOG2E : delta_s[tx + GX * c];
    if (a) {
      const bool edge = q0 + BQ > S || (causal && k0 + BK - 1 > q0);
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        const int kp = k0 + ty + GY * i;
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          const int r = tx + GX * c, qp = q0 + r;
          const bool masked = edge && (qp >= S || (causal && kp > qp));
          pt_s[(ty + GY * i) * LS + r] = masked ? 0.f : exp2_ftz(fmaf(x[i][c], sl2, -col_r[c]));
        }
      }
    }
    __syncthreads();  // p^T is in
    if (!a) {
#pragma unroll
      for (int i = 0; i < BR; ++i)
#pragma unroll
        for (int c = 0; c < BC; ++c) {
          const int e = (ty + GY * i) * LS + tx + GX * c;
          dst_s[e] = pt_s[e] * (x[i][c] - col_r[c]);
        }
    }
    __syncthreads();  // ds^T is in
    tile_product<D, BQ>(acc, (a ? pt_s : dst_s) + ty * LS, (a ? do_s : q_s) + out_vec<D>() * tx);
    if (qt + 1 < n_qt) {
      __syncthreads();  // q tile qt and p^T/ds^T are read
      copy_q_tile(qt + 1);
    }
  }
  store_rows<D>((a ? dv : dk) + base, acc, k0, S, tx, ty, a ? 1.f : scale);
}

// ---- bf16 on the tensor cores ---------------------------------------------------
//
// Tiles are [64 rows x D] bf16 in shared memory as D / P panels of [64 rows x
// P] (P = min(D, 64) elements, rows of 2P bytes, swizzled as TMA writes them),
// 1024-aligned.  Accumulator fragments (m64nN, f32): register 4 c + 2 h + e
// holds row 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e, warp
// counted within the warpgroup.

template <int D>
struct Tiles {
  static constexpr int P = D < 64 ? D : 64;       // panel width, elements
  static constexpr int ROWB = 2 * P;              // bytes per panel row
  static constexpr int PANEL = 64 * ROWB;         // bytes per panel
  static constexpr int BYTES = (D / P) * PANEL;   // bytes per [64 x D] tile
  static constexpr uint32_t SBO = 8 * ROWB;       // one swizzle atom: 8 rows
  static constexpr uint64_t LAYOUT = hopper::layout_of(ROWB);
  // the base aligned to 1024, `tiles` tiles, then `extra` bytes (barriers)
  static constexpr size_t smem(int tiles, size_t extra) { return 1024 + tiles * BYTES + extra; }
};

// TMA of rows row0 .. row0 + 63 of head bh from two [BH, S, D] tensors into
// two tiles, completing on one barrier; rows at or past S read as 0
template <int D>
__device__ __forceinline__ void tma_pair(uint64_t* bar, uint8_t* a_s, const CUtensorMap* amap,
                                         uint8_t* b_s, const CUtensorMap* bmap, int row0,
                                         int bh) {
  using Tl = Tiles<D>;
  hopper::mbar_expect_tx(bar, 2 * Tl::BYTES);
#pragma unroll
  for (int p = 0; p < D / Tl::P; ++p) {
    hopper::tma_load_3d(a_s + p * Tl::PANEL, amap, bar, p * Tl::P, row0, bh);
    hopper::tma_load_3d(b_s + p * Tl::PANEL, bmap, bar, p * Tl::P, row0, bh);
  }
}

// d[64 x 64] += A . B^T over D: A, B [64 x D] tiles at shared addresses a, b,
// both K-major; D / 16 wgmma steps, issued, not waited on
template <int D>
__device__ __forceinline__ void ss_tile(float* d, uint32_t a, uint32_t b) {
  using Tl = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / (Tl::P / 16)) * Tl::PANEL + (kk % (Tl::P / 16)) * 32;
    hopper::wgmma_ss_n64(d, hopper::make_desc(a + off, 16, Tl::SBO, Tl::LAYOUT),
                         hopper::make_desc(b + off, 16, Tl::SBO, Tl::LAYOUT), 1);
  }
}

// o (+)= a . b for one 16-row step: A = bf16 pairs, B = N columns MN-major
template <int N>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a, uint64_t desc_b) {
  if constexpr (N == 16) hopper::wgmma_rs_n16(o, a, desc_b);
  else if constexpr (N == 32) hopper::wgmma_rs_n32(o, a, desc_b);
  else if constexpr (N == 64) hopper::wgmma_rs_n64(o, a, desc_b);
  else hopper::wgmma_rs_n128(o, a, desc_b);
}

// o[64 x N] += A[64 x 64] . B[64 x N]: A as four 16-column register
// fragments (to_a), B the N columns of a [64 x D] tile that start at shared
// address b, read MN-major; 4 wgmma steps, issued, not waited on
template <int D, int N>
__device__ __forceinline__ void rs_tile(float* o, const uint32_t (&a)[4][4], uint32_t b) {
  using Tl = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    pv_step<N>(o, a[kk], hopper::make_desc(b + kk * 16 * Tl::ROWB, Tl::PANEL, Tl::SBO,
                                           Tl::LAYOUT));
}

// a 64 x 64 f32 fragment rounded to bf16 as the A operands of four 16-column
// steps: the fragment's columns 16 kk .. 16 kk + 15 are A's fragment as is
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4], const float* f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = hopper::pack_bf16(f[8 * kk + 2 * r], f[8 * kk + 2 * r + 1]);
}

// qmap, kmap, vmap read [BH, S, D] bf16 in boxes of [1 x 64 rows x P];
// rows at or past S read as 0.  grid (BH, ceil(S / 64)), 128 threads.
template <int D>
__global__ void __launch_bounds__(128)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap, void* __restrict__ out,
                       float* __restrict__ lse, int out_f32, int S, int causal, float scale) {
  using Tl = Tiles<D>;
  constexpr int NP = D / Tl::P;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* q_s = base;                        // [64 x D]
  uint8_t* k_s = base + Tl::BYTES;            // [2][64 x D]
  uint8_t* v_s = base + 3 * Tl::BYTES;        // [2][64 x D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 5 * Tl::BYTES);  // k/v stages, then q
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    hopper::mbar_expect_tx(&bar[2], Tl::BYTES);
    for (int p = 0; p < NP; ++p)
      hopper::tma_load_3d(q_s + p * Tl::PANEL, &qmap, &bar[2], p * Tl::P, q0, bh);
    for (int s = 0; s < 2 && s < n_kt; ++s)
      tma_pair<D>(&bar[s], k_s + s * Tl::BYTES, &kmap, v_s + s * Tl::BYTES, &vmap, s * BK, bh);
  }

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_a = hopper::smem_addr(q_s);
  hopper::mbar_wait(&bar[2], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BK;
    hopper::mbar_wait(&bar[s], (kt >> 1) & 1);
    const uint32_t k_a = hopper::smem_addr(k_s + s * Tl::BYTES);
    const uint32_t v_a = hopper::smem_addr(v_s + s * Tl::BYTES);

    // scores: q . k^T
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
    ss_tile<D>(sc, q_a, k_a);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<32>(sc);

    // scale after the dot; mask the diagonal tile and keys at or past S
    const bool edge = (causal && kt == qt) || k0 + BK > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int qp = row0 + 8 * ((i / 2) % 2);
      float x = sc[i] * scale;
      if (edge && (kp >= S || (causal && kp > qp))) x = NEG_INF;
      sc[i] = x;
    }
    // online softmax on the fragment: a row's 64 scores lie in the 4 lanes
    // that share lane / 4; l sums the unrounded p in f32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(sc[4 * c + 2 * h], sc[4 * c + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float corr = expf(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(sc[4 * c + 2 * h + e] - m_new);
          sc[4 * c + 2 * h + e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        o[4 * c + 2 * h] *= corr;
        o[4 * c + 2 * h + 1] *= corr;
      }
    }

    // o += p . v, p rounded to bf16
    uint32_t a[4][4];
    to_a(a, sc);
    hopper::wgmma_fence();
    rs_tile<D, D>(o, a, v_a);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<D / 2>(o);

    __syncthreads();  // stage s is read; refill it with tile kt + 2
    if (tid == 0 && kt + 2 < n_kt)
      tma_pair<D>(&bar[s], k_s + s * Tl::BYTES, &kmap, v_s + s * Tl::BYTES, &vmap, (kt + 2) * BK,
                  bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row0 + 8 * h;
    if (qp >= S) continue;
    const size_t row = ((size_t)bh * S + qp) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      const float v0 = o[4 * c + 2 * h] / l[h], v1 = o[4 * c + 2 * h + 1] / l[h];
      if (out_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(out) + row + col) = make_float2(v0, v1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(out) + row + col) =
            hopper::pack_bf16(v0, v1);
    }
    if (lane % 4 == 0) lse[(size_t)bh * S + qp] = m[h] + logf(l[h]);
  }
}

// dQ for one (bh, 64-row q tile): Q and dO once, K and V through the ring.
// grid (BH, ceil(S / 64)), 128 threads.
template <int D>
__global__ void __launch_bounds__(128)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int causal, float scale) {
  using Tl = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* q_s = base;                        // [64 x D]
  uint8_t* do_s = base + Tl::BYTES;           // [64 x D]
  uint8_t* k_s = base + 2 * Tl::BYTES;        // [2][64 x D]
  uint8_t* v_s = base + 4 * Tl::BYTES;        // [2][64 x D]
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + 6 * Tl::BYTES);  // k/v stages, then q/do
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal rows first
  const int q0 = qt * BQ;
  int n_kt = (S + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, qt + 1);

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tma_pair<D>(&bar[2], q_s, &qmap, do_s, &domap, q0, bh);
    for (int s = 0; s < 2 && s < n_kt; ++s)
      tma_pair<D>(&bar[s], k_s + s * Tl::BYTES, &kmap, v_s + s * Tl::BYTES, &vmap, s * BK, bh);
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row0 + 8 * h;
    lse_r[h] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    delta_r[h] = qp < S ? delta[(size_t)bh * S + qp] : 0.f;
  }
  const uint32_t q_a = hopper::smem_addr(q_s), do_a = hopper::smem_addr(do_s);
  hopper::mbar_wait(&bar[2], 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt & 1, k0 = kt * BK;
    hopper::mbar_wait(&bar[s], (kt >> 1) & 1);
    const uint32_t k_a = hopper::smem_addr(k_s + s * Tl::BYTES);
    const uint32_t v_a = hopper::smem_addr(v_s + s * Tl::BYTES);

    // s = q . k^T and dp = dout . v^T, both issued before one wait
    float sc[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = dp[i] = 0.f;
    hopper::wgmma_fence();
    ss_tile<D>(sc, q_a, k_a);
    ss_tile<D>(dp, do_a, v_a);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<32>(sc);
    hopper::reg_fence<32>(dp);

    // ds = p * (dp - delta), p = exp(s * scale - lse), masked on the
    // diagonal tile and for keys at or past S
    const bool edge = (causal && kt == qt) || k0 + BK > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i / 2) % 2;
      const int kp = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      const int qp = row0 + 8 * h;
      const bool masked = edge && (kp >= S || (causal && kp > qp));
      const float p = masked ? 0.f : expf(sc[i] * scale - lse_r[h]);
      sc[i] = p * (dp[i] - delta_r[h]);
    }

    // acc += ds . k, ds rounded to bf16, k read MN-major
    uint32_t a[4][4];
    to_a(a, sc);
    hopper::wgmma_fence();
    rs_tile<D, D>(acc, a, k_a);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<D / 2>(acc);

    __syncthreads();  // stage s is read; refill it with tile kt + 2
    if (tid == 0 && kt + 2 < n_kt)
      tma_pair<D>(&bar[s], k_s + s * Tl::BYTES, &kmap, v_s + s * Tl::BYTES, &vmap, (kt + 2) * BK,
                  bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = row0 + 8 * h;
    if (qp >= S) continue;
    __nv_bfloat16* row = dq + ((size_t)bh * S + qp) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<uint32_t*>(row + 8 * c + 2 * (lane % 4)) =
          hopper::pack_bf16(scale * acc[4 * c + 2 * h], scale * acc[4 * c + 2 * h + 1]);
  }
}

// warpgroups of a dK/dV block: at D 128 two split dK's and dV's columns (one
// warpgroup's 64 + 64 accumulators and two score tiles would not fit in 255
// registers a thread), each recomputing the score tiles
template <int D> __host__ __device__ constexpr int dkv_groups() { return D == 128 ? 2 : 1; }

// dK and dV for one (bh, 64-key tile): K and V once, Q and dO through the
// ring, each q tile's lse and delta in shared memory beside it.  grid (BH,
// ceil(S / 64)), 128 threads a warpgroup.
template <int D>
__global__ void __launch_bounds__(128 * dkv_groups<D>())
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                           int S, int causal, float scale) {
  using Tl = Tiles<D>;
  constexpr int N = D / dkv_groups<D>();  // dK/dV columns of one warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = align_1024(smem_raw);
  uint8_t* k_s = base;                        // [64 x D]
  uint8_t* v_s = base + Tl::BYTES;            // [64 x D]
  uint8_t* q_s = base + 2 * Tl::BYTES;        // [2][64 x D]
  uint8_t* do_s = base + 4 * Tl::BYTES;       // [2][64 x D]
  float* lse_s = reinterpret_cast<float*>(base + 6 * Tl::BYTES);  // [2][64]
  float* delta_s = lse_s + 2 * BQ;                                 // [2][64]
  uint64_t* bar = reinterpret_cast<uint64_t*>(delta_s + 2 * BQ);   // q/do stages, then k/v
  const int tid = threadIdx.x, lane = tid % 32, warp = (tid % 128) / 32, wg = tid / 128;
  const int bh = blockIdx.x;
  const int kt = blockIdx.y;  // the first key tiles see the most q tiles
  const int k0 = kt * BK;
  const int qt0 = causal ? kt : 0;  // causal: from the diagonal q tile on
  const int n = (S + BQ - 1) / BQ - qt0;
  const float* rows = (tid < BQ ? lse : delta) + (size_t)bh * S;  // read by tid < 128

  if (tid < 2 * BQ) {  // the first q tile's lse and delta
    const int qp = qt0 * BQ + tid % BQ;
    (tid < BQ ? lse_s : delta_s)[tid % BQ] = qp < S ? rows[qp] : 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) hopper::mbar_init(&bar[i], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    tma_pair<D>(&bar[2], k_s, &kmap, v_s, &vmap, k0, bh);
    for (int s = 0; s < 2 && s < n; ++s)
      tma_pair<D>(&bar[s], q_s + s * Tl::BYTES, &qmap, do_s + s * Tl::BYTES, &domap,
                  (qt0 + s) * BQ, bh);
  }

  float dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int kp0 = k0 + warp * 16 + lane / 4;  // this thread's keys: kp0, kp0 + 8
  const uint32_t k_a = hopper::smem_addr(k_s), v_a = hopper::smem_addr(v_s);
  hopper::mbar_wait(&bar[2], 0);

  for (int j = 0; j < n; ++j) {
    const int s = j & 1, qt = qt0 + j, q0 = qt * BQ;
    // the next q tile's lse or delta, loaded now and stored at the end
    float next = 0.f;
    if (tid < 2 * BQ && j + 1 < n && q0 + BQ + tid % BQ < S) next = rows[q0 + BQ + tid % BQ];
    hopper::mbar_wait(&bar[s], (j >> 1) & 1);
    const uint32_t q_a = hopper::smem_addr(q_s + s * Tl::BYTES);
    const uint32_t do_a = hopper::smem_addr(do_s + s * Tl::BYTES);

    // s^T = k . q^T and dp^T = v . dout^T, both issued before one wait
    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    hopper::wgmma_fence();
    ss_tile<D>(st, k_a, q_a);
    ss_tile<D>(dpt, v_a, do_a);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<32>(st);
    hopper::reg_fence<32>(dpt);

    // p^T = exp(s^T * scale - lse[col]), ds^T = p^T * (dp^T - delta[col]),
    // masked on the diagonal tile and for queries at or past S
    const bool edge = (causal && qt == kt) || q0 + BQ > S;
    const float* ls = lse_s + s * BQ;
    const float* dl = delta_s + s * BQ;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dl + col);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * h + e;
          const int qp = q0 + col + e, kp = kp0 + 8 * h;
          const bool masked = edge && (qp >= S || (causal && kp > qp));
          const float p = masked ? 0.f : expf(st[i] * scale - (e ? l2.y : l2.x));
          st[i] = p;
          dpt[i] = p * (dpt[i] - (e ? d2.y : d2.x));
        }
    }

    // dv += p^T . dout and dk += ds^T . q, the A fragments rounded to bf16,
    // dout and q read MN-major from this warpgroup's columns
    uint32_t ap[4][4], ads[4][4];
    to_a(ap, st);
    to_a(ads, dpt);
    hopper::wgmma_fence();
    rs_tile<D, N>(dv_acc, ap, do_a + wg * Tl::PANEL);
    rs_tile<D, N>(dk_acc, ads, q_a + wg * Tl::PANEL);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<N / 2>(dv_acc);
    hopper::reg_fence<N / 2>(dk_acc);

    // the previous reader of buffer (j + 1) & 1 was iteration j - 1
    if (tid < 2 * BQ && j + 1 < n) (tid < BQ ? lse_s : delta_s)[((j + 1) & 1) * BQ + tid % BQ] = next;
    __syncthreads();  // stage s is read; refill it with q tile qt + 2
    if (tid == 0 && j + 2 < n)
      tma_pair<D>(&bar[s], q_s + s * Tl::BYTES, &qmap, do_s + s * Tl::BYTES, &domap,
                  (qt + 2) * BQ, bh);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = kp0 + 8 * h;
    if (kp >= S) continue;
    const size_t row = ((size_t)bh * S + kp) * D + wg * N;
#pragma unroll
    for (int c = 0; c < N / 8; ++c) {
      const int col = 8 * c + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(dk + row + col) =
          hopper::pack_bf16(scale * dk_acc[4 * c + 2 * h], scale * dk_acc[4 * c + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + col) =
          hopper::pack_bf16(dv_acc[4 * c + 2 * h], dv_acc[4 * c + 2 * h + 1]);
    }
  }
}

// ---- host -------------------------------------------------------------------------

// forward: K and V in 2 stages from a 1024-aligned base, Q, P, the stages'
// barriers
template <int D> constexpr size_t fwd_fma_smem() {
  return 1024 + sizeof(float) * (4 * BQ * D + BQ * (D + 4) + BQ * LP) + 2 * sizeof(uint64_t);
}
// dQ: Q, dO, K in 2 stages, V and dS; dK/dV: K, V, Q, dO, P^T, dS^T, lse and delta
template <int D> constexpr size_t dq_fma_smem() {
  return sizeof(float) * (5 * BQ * (D + 4) + BQ * LS);
}
template <int D> constexpr size_t dkv_fma_smem() {
  return sizeof(float) * (4 * BQ * (D + 4) + 2 * BK * LS + 2 * BQ);
}
// two blocks an SM at D 64: the SM's 228 KB hold two blocks and 1 KB each
static_assert(2 * (fwd_fma_smem<64>() + 1024) <= 233472 &&
                  2 * (dq_fma_smem<64>() + 1024) <= 233472 &&
                  2 * (dkv_fma_smem<64>() + 1024) <= 233472,
              "two f32 blocks of each kernel must fit one SM's shared memory at D 64");
static_assert(fwd_fma_smem<128>() <= MAX_SMEM && dq_fma_smem<128>() <= MAX_SMEM &&
                  dkv_fma_smem<128>() <= MAX_SMEM,
              "the f32 kernels' tiles must fit one block's shared memory");
template <int D> constexpr size_t fwd_wgmma_smem() { return Tiles<D>::smem(5, 64); }
template <int D> constexpr size_t dq_wgmma_smem() { return Tiles<D>::smem(6, 64); }
template <int D> constexpr size_t dkv_wgmma_smem() {
  return Tiles<D>::smem(6, 4 * BQ * sizeof(float) + 64);
}

// Most instantiations need more than the default 48 KB of dynamic shared
// memory; the attribute is set once per kernel.  `most_shared` also asks for
// the whole carveout of the SM's 256 KB as shared memory, so that two blocks
// of ~105 KB fit on one SM.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done, bool most_shared = false) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && most_shared)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) *done = true;
  return err;
}

dim3 grid_of(int BH, int S) { return dim3(BH, (S + BQ - 1) / BQ); }

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// bf16 [BH, S, D] tensor maps in boxes of [1 x 64 rows x P]; false when a
// base is not 16-byte aligned or the driver refuses a map
template <int D>
bool tile_maps(CUtensorMap* maps, const void* const* src, int n, int BH, int S) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)S * D * 2};
  const uint32_t box[3] = {(uint32_t)Tiles<D>::P, (uint32_t)BQ, 1};
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(src[i]) % 16 ||
        !hopper::make_map(&maps[i], src[i], 3, dims, strides, box))
      return false;
  return true;
}

// the forward's f32 [BH, S, D] tensor maps: k in swizzled boxes of [1 x 64
// rows x PW], v in boxes of [1 x 64 rows x D]
template <int D>
bool fwd_fma_maps(CUtensorMap* kmap, CUtensorMap* vmap, const void* k, const void* v, int BH,
                  int S) {
  constexpr int PW = FwdTiles<D>::PW;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 4, (uint64_t)S * D * 4};
  const uint32_t kbox[3] = {(uint32_t)PW, (uint32_t)BK, 1}, vbox[3] = {(uint32_t)D, (uint32_t)BK, 1};
  return hopper::encode_map(kmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, k, 3, dims, strides, kbox,
                            PW == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B) &&
         hopper::encode_map(vmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, v, 3, dims, strides, vbox,
                            CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D>
int launch_fwd_fma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                   int S, int causal, float scale, cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (!aligned16({q, k, v, out}) || !fwd_fma_maps<D>(&kmap, &vmap, k, v, BH, S))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_fma_smem<D>(), &ready, true);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), GROUP, fwd_fma_smem<D>(), stream>>>(
      kmap, vmap, (const float*)q, (float*)out, (float*)lse, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                     int out_f32, int BH, int S, int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  if (!tile_maps<D>(maps, src, 3, BH, S)) return (int)cudaErrorInvalidValue;
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_wgmma_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), 128, fwd_wgmma_smem<D>(), stream>>>(
      maps[0], maps[1], maps[2], out, (float*)lse, out_f32, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dq, int BH, int S, int causal,
                  float scale, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dq})) return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dq_fma_smem<D>(), &ready, true);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, dq_fma_smem<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dq, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                   int causal, float scale, cudaStream_t stream) {
  if (!aligned16({q, k, v, dout, dk, dv})) return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dkv_fma_smem<D>(), &ready, true);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, dkv_fma_smem<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout, (const float*)lse,
      (const float*)delta, (float*)dk, (float*)dv, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_wgmma(const void* q, const void* k, const void* v, const void* dout,
                    const void* lse, const void* delta, void* dq, int BH, int S, int causal,
                    float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, dout};
  if (!tile_maps<D>(maps, src, 4, BH, S)) return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dq_wgmma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dq_wgmma_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), 128, dq_wgmma_smem<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dq, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                     int causal, float scale, cudaStream_t stream) {
  CUtensorMap maps[4];
  const void* src[4] = {q, k, v, dout};
  if (!tile_maps<D>(maps, src, 4, BH, S)) return (int)cudaErrorInvalidValue;
  auto kernel = flash_bwd_dkv_wgmma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dkv_wgmma_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), 128 * dkv_groups<D>(), dkv_wgmma_smem<D>(), stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int S) { return BH < 1 || S < 1 || (S + BQ - 1) / BQ > 65535; }

}  // namespace

// `return CALL` with the constant D bound to the head dim d (16, 32, 64, 128)
#define BY_HEAD_DIM(...)                                        \
  switch (d) {                                                  \
    case 16: { constexpr int D = 16; return __VA_ARGS__; }      \
    case 32: { constexpr int D = 32; return __VA_ARGS__; }      \
    case 64: { constexpr int D = 64; return __VA_ARGS__; }      \
    case 128: { constexpr int D = 128; return __VA_ARGS__; }    \
  }                                                             \
  return (int)cudaErrorInvalidValue

extern "C" {

// Each launcher returns the CUDA error code of its launch (0 = launched);
// lse and delta are [BH, S] float32.  The _fma launchers take float32
// operands, the _wgmma ones bfloat16; both backward routes take 16-byte-aligned
// bases only.

// out [BH, S, d] float32
int flash_fwd_fma(int d, const void* q, const void* k, const void* v, void* out, void* lse,
                  int out_f32, int BH, int S, int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_fwd_fma<D>(q, k, v, out, lse, BH, S, causal, scale, (cudaStream_t)stream));
}

// out [BH, S, d] bfloat16, or float32 when out_f32 != 0
int flash_fwd_wgmma(int d, const void* q, const void* k, const void* v, void* out, void* lse,
                    int out_f32, int BH, int S, int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_fwd_wgmma<D>(q, k, v, out, lse, out_f32, BH, S, causal, scale,
                                  (cudaStream_t)stream));
}

// dq [BH, S, d] in the input dtype
int flash_bwd_dq_fma(int d, const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* delta, void* dq, int BH, int S, int causal,
                     float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_dq_fma<D>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale,
                               (cudaStream_t)stream));
}

int flash_bwd_dq_wgmma(int d, const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, int BH, int S, int causal,
                       float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_dq_wgmma<D>(q, k, v, dout, lse, delta, dq, BH, S, causal, scale,
                                 (cudaStream_t)stream));
}

// dk, dv [BH, S, d] in the input dtype
int flash_bwd_dkv_fma(int d, const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                      int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_dkv_fma<D>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale,
                                (cudaStream_t)stream));
}

int flash_bwd_dkv_wgmma(int d, const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dk, void* dv, int BH, int S,
                        int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  BY_HEAD_DIM(launch_dkv_wgmma<D>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale,
                                  (cudaStream_t)stream));
}

// bytes of dynamic shared memory the f32 kernel of `pass` (0 forward, 1 dQ,
// 2 dK/dV) asks for at head dim d
int flash_fma_smem(int d, int pass) {
  BY_HEAD_DIM((int)(pass == 0 ? fwd_fma_smem<D>() : pass == 1 ? dq_fma_smem<D>()
                                                               : dkv_fma_smem<D>()));
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
