// int4 dequant-dot for Hopper: out[M, N] = x[M, K] @ W, W = (nibble - 8) * scale.
//
// Replaces the TPU kernel `_int4_kernel` (k8s_dra_driver_tpu/ops/int4_matmul.py,
// reached through int4_matmul_2d / int4_matmul and quant.matmul_last).
//
// Layout (models/quant.py Quantized4Matrix): packed [K/2, N] uint8, per-group
// half-split along K -- within a group of GS = 64 input rows, byte i holds row
// i (low nibble) and row i + 32 (high nibble), both biased by +8; scale
// [K/GS, N] f32, one per (group, column).
//
// Numerics: each weight is dequantized as (float)(nibble - 8) * scale and
// rounded to x's dtype BEFORE the product, so the dequantized values are
// bit-identical to Quantized4Matrix.dequant(); products and sums are f32.
// The order of the sums differs from one plain matmul (and between the two
// kernels), so results agree to float tolerance, not bit for bit; each kernel
// sums in a fixed order, so a call repeated on the same inputs gives the same
// bits.
//
// Two kernels, chosen by the wrapper (ops/int4_matmul.py) from M and dtype:
//
// * int4_splitk -- bf16 at M <= 16 (decode) and float32 at every M.  At M = 8
//   the work is ~4 operations per packed byte, far below the H100's ~295
//   bf16 operations per byte, so the packed weight read bounds it (0.79 MB
//   for qkv, 2.1 MB for mlp_up and mlp_down: 0.19-0.73 us at 3.35 TB/s), and
//   matrices that small are read in a few memory latencies only if every
//   load is in flight at once.  So K is split across the blocks of a
//   thread-block cluster (up to 8), each block owns 128 columns x G scale
//   groups, every lane issues all of its 16-byte packed loads (16 columns of
//   one packed row, coalesced along N), its scales and its x before any
//   arithmetic, and each packed byte and scale is read from device memory
//   once.  In bf16 the products run on the tensor cores as mma.sync m16n8k16
//   on out^T = W^T x^T: the 8 rows of x are the mma's N, and the 16 bytes a
//   lane loads are, dequantized in registers, exactly its A fragments, so
//   the K sum happens inside the mma and no shuffle reduction is needed (on
//   the CUDA cores, one FMA per weight and row and 2-3 shuffles per partial
//   sum took longer than the loads).  Two warps share a group, one per
//   half of its packed rows.  float32 stays on the CUDA cores (f32 FMAs,
//   2 shuffles and one shared-memory pass per partial sum): through the
//   tensor cores it would run as TF32, which breaks the float32 limit of
//   2^-16; it is the check path, not the serving path.  The K slices' sums
//   meet in shared memory: every block of the cluster stores its [8 x 128]
//   sums into its slot of rank 0's shared memory, and after one cluster
//   barrier rank 0 adds the slots in split order.  No float is ever added
//   atomically and no partial sum travels through device memory, so a call
//   repeated on the same inputs gives the same bits.
//
// * int4_wgmma -- bf16 at M > 16 (prefill: M = 256 at the serving path's
//   prompt bucket).  2 M K N operations against K N / 2 weight bytes: the
//   CUDA cores' f32 FMAs (67 TFLOP/s) bound the old kernel, so this one runs
//   the products on the tensor cores.  One warpgroup per block owns 64
//   columns and up to 256 rows (4 wgmma m64 tiles); per scale group it
//   dequantizes the [64 x 64] weight tile into shared memory as bf16 (the
//   value dequant() rounds to), K-major and 128-byte swizzled, while TMA brings
//   x's [rows x 64] tile into a 2-stage ring, and m64n64k16 wgmma products
//   accumulate in f32 registers.  The next group's tile is dequantized while
//   the current group's products run.  K is split across up to 8 blocks to
//   fill the SMs; the splits of one output tile form a thread-block cluster,
//   each block leaves its [rows x 64] f32 partial sums in its own shared
//   memory, and each block then sums a slice of the tile's rows over the
//   cluster in split order through distributed shared memory: the 64 KB
//   partial tiles never travel through device memory, and the final sum is
//   spread over all the tile's blocks.
//
// Shape rule (the wrapper checks it and raises): GS == 64, K % 64 == 0,
// N % 64 == 0, any M >= 1.  Every block matrix of FLAGSHIP_MODERN fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GS = 64;     // input rows per scale group
constexpr int HALF = GS / 2;
constexpr int BN = 64;     // output columns per block (both kernels)
constexpr int THREADS = 128;

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---- split-K GEMV: bf16 decode (mma.sync), float32 at every M (FMA) --------

constexpr int SK_BN = 128;    // output columns per block
constexpr int SK_ROWS = 8;    // x rows per block
constexpr int MAX_CLUSTER = 8;  // splits of one output tile: a portable cluster

// The end of both split-K kernels.  sum(o) is this block's sum over its K
// slice at position o of the 8 x 128 output tile, for output row and column
// coord(o).  The splits of the tile form a cluster along grid y: every block
// stores its sums into slot `rank` of rank 0's `slots` (distributed shared
// memory, [splits][8 x 128] f32), and after one cluster barrier rank 0 sums
// the slots in split order and stores the tile.  With one split the block
// stores its own sums.  The kernel arrived at the cluster barrier when it
// began (cluster_arrive_relaxed), so the first wait here means that every
// block of the cluster runs and its shared memory may be written.
template <typename T, typename Sum, typename Coord>
__device__ __forceinline__ void reduce_store(float* slots, Sum sum, Coord coord,
                                             T* __restrict__ out, int m0, int mr, int n0,
                                             int ncols, int N, int splits) {
  constexpr int TILE = SK_ROWS * SK_BN;
  if (splits == 1) {
    for (int o = threadIdx.x; o < TILE; o += blockDim.x) {
      int m, c;
      coord(o, m, c);
      if (m < mr && c < ncols) out[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(sum(o));
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  float* slot = cluster.map_shared_rank(slots, 0) + rank * TILE;
  hopper::cluster_wait();
  for (int o = threadIdx.x; o < TILE; o += blockDim.x) slot[o] = sum(o);
  hopper::cluster_arrive();
  hopper::cluster_wait();  // every block's sums are in rank 0's slots
  if (rank != 0) return;
  for (int o = threadIdx.x; o < TILE; o += blockDim.x) {
    int m, c;
    coord(o, m, c);
    if (m >= mr || c >= ncols) continue;
    float v = slots[o];
    for (int r = 1; r < splits; ++r) v += slots[r * TILE + o];
    out[(size_t)(m0 + m) * N + n0 + c] = from_f<T>(v);
  }
}

// (q - 8) as f32 for a nibble q, without an int-to-float conversion:
// 0x4B000000 | q is the float 2^23 + q
__device__ __forceinline__ float centered(uint32_t q) {
  return __int_as_float(0x4B000000u | q) - 8388616.f;
}

__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr int MMA_WARPS = 8;  // bf16 block: 8 warps, two per scale group
constexpr int MMA_GW = 1;     // groups per warp pair in flight at once

// bf16: out^T [N x 8] = W^T [N x K] . x^T [K x 8] as mma.sync m16n8k16
// products, the 8 rows of x the mma's N.  grid (ceil(N / 128), splits,
// ceil(M / 8)), clusters (1, splits, 1); block 8 warps: warps 2p and 2p + 1
// take the block's groups p, p + 4, ..., warp 2p + h the packed rows 16 h ..
// 16 h + 15 of each (the group's k16 steps h and h + 2: low, then high
// nibbles).  Lane l (g = l / 4, t = l % 4) reads 16 bytes (columns n0 + 16 g
// .. + 16) of packed rows 16 h + 2t, + 1, + 8, + 9: exactly the A fragments
// of 8 mma tiles j whose rows g and g + 8 are columns n0 + 16 g + 2 j and + 1.
__global__ void __launch_bounds__(MMA_WARPS * 32, 2)
int4_splitk_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M,
                        int K, int N, int G, int splits) {
  extern __shared__ float slots[];                  // [splits][8 x 128], read at rank 0
  __shared__ float red[MMA_WARPS][32][32];          // per-warp sums, by register and lane
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int pair = warp / 2, h = warp % 2;
  const int g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * SK_BN;
  const int ncols = min(SK_BN, N - n0);
  const bool live = 16 * g < ncols;
  const int gb = blockIdx.y * G;
  const int ngb = min(G, K / GS - gb);
  const int m0 = blockIdx.z * SK_ROWS;
  const int mr = min(SK_ROWS, M - m0);
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);
  if (splits > 1) hopper::cluster_arrive_relaxed();  // see reduce_store

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // this pair's groups pair, pair + 4, ..., MMA_GW at a time (all of them at
  // once when the block has at most 4 MMA_GW)
  for (int c0 = pair; c0 < ngb; c0 += 4 * MMA_GW) {
    // every load in flight before any arithmetic: packed bytes, scales, x
    uint4 pk[MMA_GW][4];
    float4 sc[MMA_GW][4];
    uint32_t xb[MMA_GW][2][2];
#pragma unroll
    for (int i = 0; i < MMA_GW; ++i) {
      const int gl = c0 + 4 * i;
      const bool valid = gl < ngb;
      const int grp = gb + gl;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int prow = 16 * h + (r / 2) * 8 + (r % 2) + 2 * t;
        pk[i][r] = (valid && live)
                       ? __ldg(reinterpret_cast<const uint4*>(
                             packed + (size_t)(grp * HALF + prow) * N + n0 + 16 * g))
                       : make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sc[i][q] = (valid && live) ? __ldg(reinterpret_cast<const float4*>(
                                         scale + (size_t)grp * N + n0 + 16 * g) + q)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xb[i][s][e] = (valid && g < mr)
                            ? __ldg(x32 + ((size_t)(m0 + g) * K + (size_t)grp * GS +
                                           16 * (h + 2 * s) + 2 * t + 8 * e) / 2)
                            : 0u;
    }

#pragma unroll
    for (int i = 0; i < MMA_GW; ++i) {
      if (c0 + 4 * i >= ngb) continue;
      const float scol[16] = {sc[i][0].x, sc[i][0].y, sc[i][0].z, sc[i][0].w,
                              sc[i][1].x, sc[i][1].y, sc[i][1].z, sc[i][1].w,
                              sc[i][2].x, sc[i][2].y, sc[i][2].z, sc[i][2].w,
                              sc[i][3].x, sc[i][3].y, sc[i][3].z, sc[i][3].w};
#pragma unroll
      for (int s = 0; s < 2; ++s) {  // low nibbles (k16 step h), then high (h + 2)
        // nib[r][wd]: the nibbles of word wd of this lane's packed row r, one per byte
        uint32_t nib[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t words[4] = {pk[i][r].x, pk[i][r].y, pk[i][r].z, pk[i][r].w};
#pragma unroll
          for (int wd = 0; wd < 4; ++wd) nib[r][wd] = (words[wd] >> (4 * s)) & 0x0F0F0F0Fu;
        }
        // the weight of column 16 g + b in packed row r: byte b % 4 of
        // nib[r][b / 4] placed under the exponent of 2^23, centred, scaled
        auto w = [&](int r, int b) {
          const uint32_t f = __byte_perm(nib[r][b / 4], 0x4B000000u, 0x7440 + (b % 4));
          return (__uint_as_float(f) - 8388616.f) * scol[b];
        };
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          uint32_t a[4];
          a[0] = hopper::pack_bf16(w(0, 2 * j), w(1, 2 * j));
          a[1] = hopper::pack_bf16(w(0, 2 * j + 1), w(1, 2 * j + 1));
          a[2] = hopper::pack_bf16(w(2, 2 * j), w(3, 2 * j));
          a[3] = hopper::pack_bf16(w(2, 2 * j + 1), w(3, 2 * j + 1));
          mma_bf16_16816(acc[j], a, xb[i][s]);
        }
      }
    }
  }

  // the warps' sums meet in fixed order, each warp's registers stored
  // lane-contiguous (no bank conflicts): position o = 32 (4 j + e) + lane
  // holds register e of tile j, i.e. row 16 g + 2 j + e / 2 of the mma
  // (output column) and column 2 t + e % 2 (output row)
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][4 * j + e][lane] = acc[j][e];
  __syncthreads();
  auto sum = [&](int o) {
    float v = red[0][o / 32][o % 32];
#pragma unroll
    for (int w = 1; w < MMA_WARPS; ++w) v += red[w][o / 32][o % 32];
    return v;
  };
  auto coord = [](int o, int& m, int& c) {
    const int r = o / 32, l = o % 32;
    c = 16 * (l / 4) + 2 * (r / 4) + (r % 4) / 2;
    m = 2 * (l % 4) + r % 2;
  };
  reduce_store(slots, sum, coord, out, m0, mr, n0, ncols, N, splits);
}

// float32: f32 FMAs on the CUDA cores (the check path; tensor cores would
// run f32 as TF32).  grid and clusters as above; block 128 threads, lane l
// of warp w: columns n0 + 16 (l % 8) .. + 16 of packed rows k and k + 16 of
// each group, k = 4 w + l / 8.
__global__ void __launch_bounds__(THREADS)
int4_splitk_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                       const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                       int N, int G, int splits) {
  extern __shared__ float slots[];                      // [splits][8 x 128], read at rank 0
  __shared__ float xs[SK_ROWS][GS];                     // one group of x's rows
  __shared__ float red[THREADS / 32][SK_ROWS][SK_BN];   // per-warp sums
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = lane % 8, kl = warp * 4 + lane / 8;
  const int n0 = blockIdx.x * SK_BN;
  const int ncols = min(SK_BN, N - n0);
  const bool live = tx * 16 < ncols;
  const int g0 = blockIdx.y * G;
  const int ng = min(G, K / GS - g0);
  const int m0 = blockIdx.z * SK_ROWS;
  const int mr = min(SK_ROWS, M - m0);
  if (splits > 1) hopper::cluster_arrive_relaxed();  // see reduce_store

  float acc[SK_ROWS][16];
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[m][c] = 0.f;
  for (int gi = 0; gi < ng; ++gi) {
    __syncthreads();  // the previous group's x is read
    for (int i = tid; i < SK_ROWS * GS; i += THREADS) {
      const int m = i / GS, k = i % GS;
      xs[m][k] = m < mr ? x[(size_t)(m0 + m) * K + (size_t)(g0 + gi) * GS + k] : 0.f;
    }
    __syncthreads();
    if (!live) continue;
    const float* sp = scale + (size_t)(g0 + gi) * N + n0 + tx * 16;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int r = kl + 16 * j;
      const uint4 pk = __ldg(reinterpret_cast<const uint4*>(
          packed + (size_t)((g0 + gi) * HALF + r) * N + n0 + tx * 16));
      const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const uint32_t byte = (words[c / 4] >> (8 * (c % 4))) & 0xFFu;
        const float s = __ldg(sp + c);
        const float lo = centered(byte & 0xFu) * s;
        const float hi = centered(byte >> 4) * s;
#pragma unroll
        for (int m = 0; m < SK_ROWS; ++m) {
          acc[m][c] = fmaf(xs[m][r], lo, acc[m][c]);
          acc[m][c] = fmaf(xs[m][r + HALF], hi, acc[m][c]);
        }
      }
    }
  }
  // the warp's 4 row lanes (lanes l, l ^ 8, l ^ 16, l ^ 24), then the 4 warps
#pragma unroll
  for (int m = 0; m < SK_ROWS; ++m)
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 8) red[warp][m][tx * 16 + c] = v;
    }
  __syncthreads();
  auto sum = [&](int o) {
    const int m = o / SK_BN, c = o % SK_BN;
    return red[0][m][c] + red[1][m][c] + red[2][m][c] + red[3][m][c];
  };
  auto coord = [](int o, int& m, int& c) { m = o / SK_BN, c = o % SK_BN; };
  reduce_store(slots, sum, coord, out, m0, mr, n0, ncols, N, splits);
}

// ---- wgmma GEMM: bf16 prefill ----------------------------------------------

constexpr int TILE_BYTES = 64 * 64 * 2;  // one [64 x 64] bf16 tile, 8 rows of 1024 B
constexpr int PART_LD = BN + 4;          // row stride of the partial-sum tile, floats

template <int MT> constexpr size_t wgmma_smem() {
  return 1024 + 2 * MT * TILE_BYTES + 2 * TILE_BYTES + 64;
}
static_assert(64 * 4 * PART_LD * 4 <= 2 * 4 * TILE_BYTES + 2 * TILE_BYTES,
              "the partial-sum tile reuses the x ring and the weight tiles");
static_assert(64 * 1 * PART_LD * 4 <= 2 * 1 * TILE_BYTES + 2 * TILE_BYTES,
              "the partial-sum tile reuses the x ring and the weight tiles");

// Dequantize one group's [64 K x 64 N] weight tile (this thread: packed row
// pr, columns cq .. cq + 16) into `tile`, stored [n][k] K-major with 128-byte
// swizzle: element (n, k) at byte n * 128 + ((k / 8) ^ (n % 8)) * 16 + (k % 8) * 2.
__device__ __forceinline__ void dequant_tile(uint8_t* tile, uint4 pk, const float* sc, int pr,
                                             int cq) {
  const uint32_t words[4] = {pk.x, pk.y, pk.z, pk.w};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int n = cq + c;
    const int byte = (words[c / 4] >> (8 * (c % 4))) & 0xFF;
    const int klo = pr, khi = pr + HALF;
    uint8_t* row = tile + n * 128;
    *reinterpret_cast<__nv_bfloat16*>(row + (((klo >> 3) ^ (n & 7)) << 4) + (klo & 7) * 2) =
        __float2bfloat16_rn((float)((byte & 0xF) - 8) * sc[c]);
    *reinterpret_cast<__nv_bfloat16*>(row + (((khi >> 3) ^ (n & 7)) << 4) + (khi & 7) * 2) =
        __float2bfloat16_rn((float)((byte >> 4) - 8) * sc[c]);
  }
}

__device__ __forceinline__ void load_group(const uint8_t* __restrict__ packed,
                                           const float* __restrict__ scale, int g, int pr,
                                           int cq, int n0, int N, uint4& pk, float* sc) {
  pk = __ldg(reinterpret_cast<const uint4*>(packed + (size_t)(g * HALF + pr) * N + n0 + cq));
  const float4* s4 = reinterpret_cast<const float4*>(scale + (size_t)g * N + n0 + cq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(s4 + i);
    sc[4 * i] = v.x, sc[4 * i + 1] = v.y, sc[4 * i + 2] = v.z, sc[4 * i + 3] = v.w;
  }
}

// grid (N / 64, splits, ceil(M / (64 MT))), clusters of (1, splits, 1);
// block = one warpgroup.  xmap reads x [M, K] bf16 in boxes of [64 K x
// 64 MT rows], 128-byte swizzled.
template <int MT>
__global__ void __launch_bounds__(THREADS)
int4_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ out, int M, int K,
                  int N, int G, int splits) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xs = base;                            // [2][64 MT rows][64 K] bf16
  uint8_t* wt = base + 2 * MT * TILE_BYTES;      // [2][64 N][64 K] bf16
  uint64_t* bar = reinterpret_cast<uint64_t*>(wt + 2 * TILE_BYTES);  // [2]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int g0 = blockIdx.y * G;
  const int ng = min(G, K / GS - g0);
  const int mb0 = blockIdx.z * 64 * MT;
  const int pr = tid / 4, cq = (tid % 4) * 16;   // this thread's share of a weight tile
  constexpr uint32_t X_BYTES = MT * TILE_BYTES;

  if (tid == 0) {
    hopper::mbar_init(&bar[0], 1);
    hopper::mbar_init(&bar[1], 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < 2 && s < ng; ++s) {
      hopper::mbar_expect_tx(&bar[s], X_BYTES);
      hopper::tma_load_2d(xs + s * X_BYTES, &xmap, &bar[s], (g0 + s) * GS, mb0);
    }
  }
  uint4 pk;
  float sc[16];
  load_group(packed, scale, g0, pr, cq, n0, N, pk, sc);
  dequant_tile(wt, pk, sc, pr, cq);
  if (ng > 1) load_group(packed, scale, g0 + 1, pr, cq, n0, N, pk, sc);
  hopper::fence_async_smem();
  __syncthreads();

  float acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;

  for (int gi = 0; gi < ng; ++gi) {
    const int s = gi & 1;
    hopper::mbar_wait(&bar[s], (gi >> 1) & 1);
    const uint32_t xa = hopper::smem_addr(xs + s * X_BYTES);
    const uint32_t wa = hopper::smem_addr(wt + s * TILE_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GS / 16; ++kk) {
      const uint64_t db = hopper::make_desc(wa + kk * 32, 16, 1024, 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        hopper::wgmma_ss_n64(acc[mt], hopper::make_desc(xa + mt * TILE_BYTES + kk * 32, 16, 1024, 1),
                             db, 1);
    }
    hopper::wgmma_commit();
    // the next group's weight tile, while the products run
    if (gi + 1 < ng) {
      dequant_tile(wt + (s ^ 1) * TILE_BYTES, pk, sc, pr, cq);
      if (gi + 2 < ng) load_group(packed, scale, g0 + gi + 2, pr, cq, n0, N, pk, sc);
    }
    hopper::wgmma_wait_all();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) hopper::reg_fence<32>(acc[mt]);
    hopper::fence_async_smem();
    __syncthreads();  // stage s and weight tile s are free again
    if (tid == 0 && gi + 2 < ng) {
      hopper::mbar_expect_tx(&bar[s], X_BYTES);
      hopper::tma_load_2d(xs + s * X_BYTES, &xmap, &bar[s], (g0 + gi + 2) * GS, mb0);
    }
  }

  // accumulator fragment: register 4 c + 2 h + e holds row 16 warp + lane / 4
  // + 8 h, column 8 c + 2 (lane % 4) + e of each m64 tile
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mb0 + mt * 64 + warp * 16 + lane / 4 + 8 * h;
          if (m < M)
            *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n0 + 8 * c + 2 * (lane % 4)) =
                hopper::pack_bf16(acc[mt][4 * c + 2 * h], acc[mt][4 * c + 2 * h + 1]);
        }
    return;
  }
  // The splits of one output tile form a thread-block cluster: each block
  // leaves its K-slice's partial sums in its own shared memory (the x ring
  // and weight tiles are no longer read), then every block sums a slice of
  // the tile's rows over the cluster's blocks in split order.
  float* part = reinterpret_cast<float*>(base);  // [64 MT rows][PART_LD]
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(part + (mt * 64 + warp * 16 + lane / 4 + 8 * h) * PART_LD +
                                   8 * c + 2 * (lane % 4)) =
            make_float2(acc[mt][4 * c + 2 * h], acc[mt][4 * c + 2 * h + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rows = (MT * 64 + splits - 1) / splits;
  const int r0 = (int)cluster.block_rank() * rows;
  const int r1 = min(MT * 64, r0 + rows);
  for (int o = tid; o < (r1 - r0) * (BN / 4); o += THREADS) {
    const int r = r0 + o / (BN / 4), c = 4 * (o % (BN / 4));
    if (mb0 + r >= M) continue;
    float4 p[MAX_CLUSTER];
#pragma unroll
    for (int s = 0; s < MAX_CLUSTER; ++s)
      if (s < splits)
        p[s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, s) + r * PART_LD + c);
    float4 v = p[0];
#pragma unroll
    for (int s = 1; s < MAX_CLUSTER; ++s)
      if (s < splits) v.x += p[s].x, v.y += p[s].y, v.z += p[s].z, v.w += p[s].w;
    __nv_bfloat16* dst = out + (size_t)(mb0 + r) * N + n0 + c;
    *reinterpret_cast<uint32_t*>(dst) = hopper::pack_bf16(v.x, v.y);
    *reinterpret_cast<uint32_t*>(dst + 2) = hopper::pack_bf16(v.z, v.w);
  }
  cluster.sync();  // every block's partials stay until the whole cluster has read them
}

// ---- launchers -----------------------------------------------------------------

bool bad_plan(int M, int K, int N, int group_size, int G, int splits) {
  return group_size != GS || K % GS || N % BN || M < 1 || G < 1 || splits > MAX_CLUSTER ||
         splits != (K / GS + G - 1) / G;
}

// a launch of `kernel` whose splits (grid y) form one cluster per tile
template <typename Kernel, typename... Args>
cudaError_t launch_clustered(Kernel kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = grid.y;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int MT>
cudaError_t launch_wgmma(const CUtensorMap& xmap, const void* packed, const void* scale,
                         void* out, int M, int K, int N, int G, int splits,
                         cudaStream_t stream) {
  auto kernel = int4_wgmma_kernel<MT>;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)wgmma_smem<MT>());
    if (err != cudaSuccess) return err;
    ready = true;
  }
  return launch_clustered(kernel, dim3(N / BN, splits, (M + 64 * MT - 1) / (64 * MT)),
                          THREADS, wgmma_smem<MT>(), stream, xmap, (const uint8_t*)packed,
                          (const float*)scale, (__nv_bfloat16*)out, M, K, N, G, splits);
}

}  // namespace

extern "C" {

// The split-K kernel.  dtype: 0 = float32 (FMAs), 1 = bfloat16 (mma.sync);
// x and out in that dtype, x 4-byte aligned.  G groups of 64 K rows per
// block, splits = ceil(K / 64 / G) <= 8 blocks (one cluster) per output tile.  Returns the CUDA error code of the
// launch (0 = launched).
int int4_splitk(int dtype, const void* x, const void* packed, const void* scale, void* out,
                int M, int K, int N, int group_size, int G, int splits, void* stream) {
  if (bad_plan(M, K, N, group_size, G, splits) || (M + SK_ROWS - 1) / SK_ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + SK_BN - 1) / SK_BN, splits, (M + SK_ROWS - 1) / SK_ROWS);
  const size_t slots = splits > 1 ? sizeof(float) * splits * SK_ROWS * SK_BN : 0;
  cudaStream_t s = (cudaStream_t)stream;
  static bool ready = false;  // both kernels may take a full cluster's slots
  if (!ready) {
    const int most = (int)(sizeof(float) * MAX_CLUSTER * SK_ROWS * SK_BN);
    cudaError_t err = cudaFuncSetAttribute(int4_splitk_f32_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(int4_splitk_bf16_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  if (dtype == 0)
    return (int)launch_clustered(int4_splitk_f32_kernel, grid, THREADS, slots, s,
                                 (const float*)x, (const uint8_t*)packed, (const float*)scale,
                                 (float*)out, M, K, N, G, splits);
  if (dtype == 1) {
    if (reinterpret_cast<uintptr_t>(x) % 4) return (int)cudaErrorInvalidValue;
    return (int)launch_clustered(int4_splitk_bf16_kernel, grid, MMA_WARPS * 32, slots, s,
                                 (const __nv_bfloat16*)x, (const uint8_t*)packed,
                                 (const float*)scale, (__nv_bfloat16*)out, M, K, N, G, splits);
  }
  return (int)cudaErrorInvalidValue;
}

// The wgmma kernel, bfloat16 x and out, x 16-byte aligned.  mt (1-4) m64
// tiles per block; G groups of 64 K rows per block, splits = ceil(K / 64 /
// G) <= 8 blocks (one cluster) per output tile.
int int4_wgmma(const void* x, const void* packed, const void* scale, void* out, int M, int K,
               int N, int group_size, int G, int splits, int mt, void* stream) {
  if (bad_plan(M, K, N, group_size, G, splits) || mt < 1 || mt > 4 ||
      reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap;
  const uint64_t dims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t strides[1] = {(uint64_t)K * 2};
  const uint32_t box[2] = {64, (uint32_t)(64 * mt)};
  if (!hopper::make_map(&xmap, x, 2, dims, strides, box)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mt) {
    case 1: return (int)launch_wgmma<1>(xmap, packed, scale, out, M, K, N, G, splits, s);
    case 2: return (int)launch_wgmma<2>(xmap, packed, scale, out, M, K, N, G, splits, s);
    case 3: return (int)launch_wgmma<3>(xmap, packed, scale, out, M, K, N, G, splits, s);
    default: return (int)launch_wgmma<4>(xmap, packed, scale, out, M, K, N, G, splits, s);
  }
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
