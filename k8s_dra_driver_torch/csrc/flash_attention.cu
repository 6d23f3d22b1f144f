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
// float32; dq/dk/dv come out in the input dtype, and the bf16 forward may
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
// flash_bwd_dkv_fma_kernel) do their products as f32 FMAs on the CUDA cores,
// from tiles in shared memory (rows padded to D+1 floats so the lanes of a
// half-warp that read 16 different rows hit 16 different banks); each of the
// 256 threads owns a 4x4 block of the 64x64 score tile and a 4 x D/16 block of
// the output tile in registers.  For f32 that is the design, not a stopgap:
// the tensor cores would run f32 as TF32, far outside the 2^-16 limit.  Their
// bound is 67 TFLOP/s of f32 FMAs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // key rows per tile
constexpr int TX = 16, TY = 16;      // thread grid of an f32 block
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;          // tile rows per thread (4)
constexpr int CM = BK / TX;          // score columns per thread (4)
constexpr int LP = 65;               // padded row stride of the 64-wide p/ds tiles
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the causal tile walks below assume square tiles");

// ---- f32 on the CUDA cores ----------------------------------------------------

// reductions over the 16 lanes of a half-warp (the lanes that share ty)
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

// rows [row0, row0 + rows) of one [S, D] slab into shared memory with row
// stride D + 1; rows at or past S are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int S, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, e = i % D;
    const int g = row0 + r;
    dst[r * (D + 1) + e] = g < S ? src[(size_t)g * D + e] : 0.f;
  }
}

// number of 64-key tiles a q tile starting at q0 attends
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  int n = (S + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int S, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int EC = D / TX;  // output features per thread
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  extern __shared__ float smem[];
  float* q_s = smem;            // [BQ][LD]
  float* k_s = q_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;   // [BK][LD]
  float* p_s = v_s + BK * LD;   // [BQ][LP]
  const size_t base = (size_t)bh * S * D;
  load_tile<D>(q_s, q + base, q0, S, BQ);

  float m[RM], l[RM], acc[RM][EC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's k/v/p are no longer read
    load_tile<D>(k_s, k + base, k0, S, BK);
    load_tile<D>(v_s, v + base, k0, S, BK);
    __syncthreads();

    float s[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int e = 0; e < D; ++e) {
      float qa[RM], kb[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) qa[i] = q_s[(ty + TY * i) * LD + e];
#pragma unroll
      for (int j = 0; j < CM; ++j) kb[j] = k_s[(tx + TX * j) * LD + e];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + TY * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int kp = k0 + tx + TX * j;
        float x = s[i][j] * scale;
        if (kp >= S || (causal && kp > qp)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + TY * i) * LP + tx + TX * j] = p;
      }
      sum = half_sum(sum);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < EC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vb[EC];
#pragma unroll
      for (int j = 0; j < EC; ++j) vb[j] = v_s[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = p_s[(ty + TY * i) * LP + c];
#pragma unroll
        for (int j = 0; j < EC; ++j) acc[i][j] = fmaf(p, vb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= S) continue;
    const size_t row = base + (size_t)qp * D;
#pragma unroll
    for (int j = 0; j < EC; ++j) out[row + tx + TX * j] = acc[i][j] / l[i];
    if (tx == 0) lse[(size_t)bh * S + qp] = m[i] + logf(l[i]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int S, int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int EC = D / TX;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* do_s = q_s + BQ * LD;   // [BQ][LD]
  float* k_s = do_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* ds_s = v_s + BK * LD;   // [BQ][LP]
  const size_t base = (size_t)bh * S * D;
  load_tile<D>(q_s, q + base, q0, S, BQ);
  load_tile<D>(do_s, dout + base, q0, S, BQ);

  float lse_r[RM], delta_r[RM], acc[RM][EC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty + TY * i;
    lse_r[i] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
    delta_r[i] = qp < S ? delta[(size_t)bh * S + qp] : 0.f;
#pragma unroll
    for (int c = 0; c < EC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(q0, S, causal);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<D>(k_s, k + base, k0, S, BK);
    load_tile<D>(v_s, v + base, k0, S, BK);
    __syncthreads();

    float s[RM][CM], dp[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float qa[RM], da[RM], kb[CM], vb[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qa[i] = q_s[(ty + TY * i) * LD + e];
        da[i] = do_s[(ty + TY * i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        kb[j] = k_s[(tx + TX * j) * LD + e];
        vb[j] = v_s[(tx + TX * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
          dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int kp = k0 + tx + TX * j;
        const bool masked = kp >= S || (causal && kp > qp);
        const float p = masked ? 0.f : expf(s[i][j] * scale - lse_r[i]);
        ds_s[(ty + TY * i) * LP + tx + TX * j] = p * (dp[i][j] - delta_r[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float kb[EC];
#pragma unroll
      for (int j = 0; j < EC; ++j) kb[j] = k_s[c * LD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float d = ds_s[(ty + TY * i) * LP + c];
#pragma unroll
        for (int j = 0; j < EC; ++j) acc[i][j] = fmaf(d, kb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty + TY * i;
    if (qp >= S) continue;
    const size_t row = base + (size_t)qp * D;
#pragma unroll
    for (int j = 0; j < EC; ++j) dq[row + tx + TX * j] = scale * acc[i][j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv, int S, int causal,
                         float scale) {
  constexpr int LD = D + 1;
  constexpr int EC = D / TX;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * BK;  // the first key tiles see the most q tiles
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][LD]
  float* v_s = k_s + BK * LD;      // [BK][LD]
  float* q_s = v_s + BK * LD;      // [BQ][LD]
  float* do_s = q_s + BQ * LD;     // [BQ][LD]
  float* pt_s = do_s + BQ * LD;    // [BK][LP], p^T
  float* dst_s = pt_s + BK * LP;   // [BK][LP], ds^T
  float* lse_s = dst_s + BK * LP;  // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]
  const size_t base = (size_t)bh * S * D;
  load_tile<D>(k_s, k + base, k0, S, BK);
  load_tile<D>(v_s, v + base, k0, S, BK);

  // this thread's rows are keys k0 + ty + TY*i, its score columns queries
  float dk_acc[RM][EC], dv_acc[RM][EC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < EC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // causal: q tiles whose last row reaches k0, i.e. from the diagonal tile on
  const int qt0 = causal ? k0 / BQ : 0;
  const int n_qt = (S + BQ - 1) / BQ;
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<D>(q_s, q + base, q0, S, BQ);
    load_tile<D>(do_s, dout + base, q0, S, BQ);
    for (int r = threadIdx.x; r < BQ; r += THREADS) {
      const int qp = q0 + r;
      lse_s[r] = qp < S ? lse[(size_t)bh * S + qp] : 0.f;
      delta_s[r] = qp < S ? delta[(size_t)bh * S + qp] : 0.f;
    }
    __syncthreads();

    float st[RM][CM], dpt[RM][CM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CM; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      float ka[RM], va[RM], qb[CM], db[CM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        ka[i] = k_s[(ty + TY * i) * LD + e];
        va[i] = v_s[(ty + TY * i) * LD + e];
      }
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        qb[j] = q_s[(tx + TX * j) * LD + e];
        db[j] = do_s[(tx + TX * j) * LD + e];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          st[i][j] = fmaf(ka[i], qb[j], st[i][j]);
          dpt[i][j] = fmaf(va[i], db[j], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int kp = k0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < CM; ++j) {
        const int r = tx + TX * j;
        const int qp = q0 + r;
        const bool masked = qp >= S || (causal && kp > qp);
        const float p = masked ? 0.f : expf(st[i][j] * scale - lse_s[r]);
        pt_s[(ty + TY * i) * LP + r] = p;
        dst_s[(ty + TY * i) * LP + r] = p * (dpt[i][j] - delta_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < BQ; ++r) {
      float qb[EC], db[EC];
#pragma unroll
      for (int j = 0; j < EC; ++j) {
        qb[j] = q_s[r * LD + tx + TX * j];
        db[j] = do_s[r * LD + tx + TX * j];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = pt_s[(ty + TY * i) * LP + r];
        const float d = dst_s[(ty + TY * i) * LP + r];
#pragma unroll
        for (int j = 0; j < EC; ++j) {
          dv_acc[i][j] = fmaf(p, db[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(d, qb[j], dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int kp = k0 + ty + TY * i;
    if (kp >= S) continue;
    const size_t row = base + (size_t)kp * D;
#pragma unroll
    for (int j = 0; j < EC; ++j) {
      dk[row + tx + TX * j] = scale * dk_acc[i][j];
      dv[row + tx + TX * j] = dv_acc[i][j];
    }
  }
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

__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

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

template <int D> constexpr size_t fwd_fma_smem() {
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * LP);
}
template <int D> constexpr size_t dq_fma_smem() {
  return sizeof(float) * (4 * BQ * (D + 1) + BQ * LP);
}
template <int D> constexpr size_t dkv_fma_smem() {
  return sizeof(float) * (4 * BQ * (D + 1) + 2 * BK * LP + 2 * BQ);
}
template <int D> constexpr size_t fwd_wgmma_smem() { return Tiles<D>::smem(5, 64); }
template <int D> constexpr size_t dq_wgmma_smem() { return Tiles<D>::smem(6, 64); }
template <int D> constexpr size_t dkv_wgmma_smem() {
  return Tiles<D>::smem(6, 4 * BQ * sizeof(float) + 64);
}

// Most instantiations need more than the default 48 KB of dynamic shared
// memory; the attribute is set once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

dim3 grid_of(int BH, int S) { return dim3(BH, (S + BQ - 1) / BQ); }

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

template <int D>
int launch_fwd_fma(const void* q, const void* k, const void* v, void* out, void* lse, int BH,
                   int S, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_fma_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, fwd_fma_smem<D>(), stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (float*)lse, S, causal,
      scale);
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
  auto kernel = flash_bwd_dq_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dq_fma_smem<D>(), &ready);
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
  auto kernel = flash_bwd_dkv_fma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dkv_fma_smem<D>(), &ready);
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
// operands, the _wgmma ones bfloat16 with 16-byte-aligned bases.

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

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
