// Flash attention, forward and backward, for Hopper.
//
// Replaces the three TPU kernels of k8s_dra_driver_tpu/ops/flash_attention.py:
//   flash_fwd_wgmma (bf16) and flash_fwd (f32)
//                  <- `_flash_kernel` (causal or full attention with the online
//                     softmax; also returns lse = m + log l),
//   flash_bwd_dq   <- `_dq_kernel`  (dQ, recomputing P from lse),
//   flash_bwd_dkv  <- `_dkv_kernel` (dK and dV, recomputing P from lse).
//
// Layout: q, k, v, out, dout, dq, dk, dv are [BH, S, D] (row-major, the
// `to_bh` layout), lse and delta are [BH, S] f32 (one value per row, not the
// TPU's 128-lane broadcast).  Types: float32 or bfloat16 for all of q, k, v,
// dout (dq/dk/dv in that type); out may be float32 over bfloat16 inputs
// (`out_f32`, the ring composition's partials).  Head dims 16, 32, 64, 128.
// Any S: the ragged last tile is masked here.
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
//            diagonal on (causal) or from 0.
// dQ and dK/dV stay two passes, as in Pallas, so every output element is
// written by exactly one block: no atomics, deterministic gradients.
//
// What bounds them on this card.  At the training shape (BH 64, S 1024, D 64,
// bf16, causal) the forward moves 33.8 MB and does 8.6 GFLOP, dQ 42.5 MB and
// 12.9 GFLOP, dK/dV 50.9 MB and 17.2 GFLOP: at 989 TFLOP/s and 3.35 TB/s the
// least times are 10.1, 13.0 and 17.4 us, operations-bound for both backward
// passes and nearly so for the forward.  Only the tensor cores come near it.
//
// The bf16 forward (flash_fwd_wgmma_kernel) runs both products there.  One
// warpgroup per block owns 64 query rows.  TMA brings the q tile once and
// the k/v tiles through a 2-stage ring in shared memory, 128-byte swizzled
// (64-byte, 32-byte at D 32, 16), each stage guarded by an mbarrier; while
// the block works on tile j, the TMA load of tile j + 1 is in flight, and
// tile j + 2 is requested as soon as tile j's stage is read.  S = Q K^T is an
// m64n64k16 wgmma per 16 of D with both operands in shared memory and f32
// accumulators; the scores are scaled after the dot and masked at -1e30 on
// the diagonal tile and past S only.  The online softmax runs on the
// accumulator fragment in registers (a row's 64 scores lie in 4 lanes, so
// its max and sum take two shuffles); l sums the unrounded p in f32.  P is
// rounded to bf16 in registers and is, as it stands, the A operand of the
// P V wgmma (m64nDk16, 4 steps of 16 keys), whose B operand, V, is read
// MN-major from shared memory through the transpose bit.  out = acc / l is
// rounded once (f32 under out_f32); lse = m + log l.  The thread that issues
// TMA is the consumer warpgroup's own thread 0, not a separate producer
// warp: each block waits on its products before its softmax, and
// blocks of 96 registers and 41 KB at D 64 overlap each other on an SM
// instead.
//
// The f32 forward (flash_fwd_kernel) and both backward kernels do their
// products as f32 FMAs on the CUDA cores, from tiles converted to f32 in
// shared memory (rows padded to D+1 floats so the lanes of a half-warp that
// read 16 different rows hit 16 different banks); each of the 256 threads
// owns a 4x4 block of the 64x64 score tile and a 4 x D/16 block of the
// output tile in registers.  For f32 that is the design, not a stopgap: the
// tensor cores would run f32 as TF32, far outside the 2^-16 limit.  The
// backward's bf16 redesign on wgmma reuses the forward's TMA ring.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;               // query rows per tile
constexpr int BK = 64;               // key rows per tile
constexpr int TX = 16, TY = 16;      // thread grid of a block
constexpr int THREADS = TX * TY;
constexpr int RM = BQ / TY;          // tile rows per thread (4)
constexpr int CM = BK / TX;          // score columns per thread (4)
constexpr int LP = 65;               // padded row stride of the 64-wide p/ds tiles
constexpr float NEG_INF = -1e30f;

static_assert(BQ == BK, "the causal tile walk below assumes square tiles");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and read back as f32 (the Pallas kernels' `.astype(T)`)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

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

// rows [row0, row0 + rows) of one [S, D] slab into shared memory as f32 with
// row stride D + 1; rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, int row0,
                                          int S, int rows) {
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, e = i % D;
    const int g = row0 + r;
    dst[r * (D + 1) + e] = g < S ? to_f(src[(size_t)g * D + e]) : 0.f;
  }
}

// number of 64-key tiles a q tile starting at q0 attends
__device__ __forceinline__ int key_tiles(int q0, int S, int causal) {
  int n = (S + BK - 1) / BK;
  if (causal) n = min(n, (q0 + BQ - 1) / BK + 1);
  return n;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 void* __restrict__ out, float* __restrict__ lse, int out_f32, int S,
                 int causal, float scale) {
  constexpr int LD = D + 1;
  constexpr int EC = D / TX;  // output features per thread
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest causal rows first
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  extern __shared__ float smem[];
  float* q_s = smem;            // [BQ][LD]
  float* k_s = q_s + BQ * LD;   // [BK][LD]
  float* v_s = k_s + BK * LD;   // [BK][LD]
  float* p_s = v_s + BK * LD;   // [BQ][LP], p rounded to T
  const size_t base = (size_t)bh * S * D;
  load_tile<T, D>(q_s, q + base, q0, S, BQ);

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
    load_tile<T, D>(k_s, k + base, k0, S, BK);
    load_tile<T, D>(v_s, v + base, k0, S, BK);
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
        p_s[(ty + TY * i) * LP + tx + TX * j] = round_to<T>(p);
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
    for (int j = 0; j < EC; ++j) {
      const float val = acc[i][j] / l[i];
      if (out_f32)
        static_cast<float*>(out)[row + tx + TX * j] = val;
      else
        static_cast<T*>(out)[row + tx + TX * j] = from_f<T>(val);
    }
    if (tx == 0) lse[(size_t)bh * S + qp] = m[i] + logf(l[i]);
  }
}

// ---- the bf16 forward on the tensor cores ---------------------------------------
//
// One block = one warpgroup = one (bh, 64-row q tile).  Tiles are [64 rows x D]
// bf16 in shared memory as D / P panels of [64 rows x P] (P = min(D, 64)
// elements, rows of 2P bytes, swizzled as TMA writes them), 1024-aligned.

template <int D>
struct Tiles {
  static constexpr int P = D < 64 ? D : 64;       // panel width, elements
  static constexpr int ROWB = 2 * P;              // bytes per panel row
  static constexpr int PANEL = 64 * ROWB;         // bytes per panel
  static constexpr int BYTES = (D / P) * PANEL;   // bytes per [64 x D] tile
  static constexpr uint32_t SBO = 8 * ROWB;       // one swizzle atom: 8 rows
  static constexpr uint64_t LAYOUT = hopper::layout_of(ROWB);
  static constexpr size_t SMEM = 1024 + 5 * BYTES + 64;  // q, k[2], v[2], barriers
};

// o (+)= p . v for one 16-key step: A = p's bf16 pairs, B = v MN-major
template <int D>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a, uint64_t desc_v) {
  if constexpr (D == 16) hopper::wgmma_rs_n16(o, a, desc_v);
  else if constexpr (D == 32) hopper::wgmma_rs_n32(o, a, desc_v);
  else if constexpr (D == 64) hopper::wgmma_rs_n64(o, a, desc_v);
  else hopper::wgmma_rs_n128(o, a, desc_v);
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
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
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
    for (int s = 0; s < 2 && s < n_kt; ++s) {
      hopper::mbar_expect_tx(&bar[s], 2 * Tl::BYTES);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_3d(k_s + s * Tl::BYTES + p * Tl::PANEL, &kmap, &bar[s], p * Tl::P,
                            s * BK, bh);
        hopper::tma_load_3d(v_s + s * Tl::BYTES + p * Tl::PANEL, &vmap, &bar[s], p * Tl::P,
                            s * BK, bh);
      }
    }
  }

  // accumulator fragments (m64nN, f32): register 4 c + 2 h + e holds row
  // 16 warp + lane / 4 + 8 h, column 8 c + 2 (lane % 4) + e
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

    // scores: q . k^T, both K-major, D / 16 steps of 16 along D
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / (Tl::P / 16)) * Tl::PANEL + (kk % (Tl::P / 16)) * 32;
      hopper::wgmma_ss_n64(sc, hopper::make_desc(q_a + off, 16, Tl::SBO, Tl::LAYOUT),
                           hopper::make_desc(k_a + off, 16, Tl::SBO, Tl::LAYOUT), 1);
    }
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

    // p rounded to bf16 as the A operand of p . v, 16 keys a step: the
    // score fragment's columns 16 kk .. 16 kk + 15 are A's fragment as is
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) a[kk][r] = hopper::pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      pv_step<D>(o, a[kk], hopper::make_desc(v_a + kk * 16 * Tl::ROWB, Tl::PANEL, Tl::SBO,
                                             Tl::LAYOUT));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::reg_fence<D / 2>(o);

    __syncthreads();  // stage s is read; refill it with tile kt + 2
    if (tid == 0 && kt + 2 < n_kt) {
      hopper::mbar_expect_tx(&bar[s], 2 * Tl::BYTES);
      for (int p = 0; p < NP; ++p) {
        hopper::tma_load_3d(k_s + s * Tl::BYTES + p * Tl::PANEL, &kmap, &bar[s], p * Tl::P,
                            (kt + 2) * BK, bh);
        hopper::tma_load_3d(v_s + s * Tl::BYTES + p * Tl::PANEL, &vmap, &bar[s], p * Tl::P,
                            (kt + 2) * BK, bh);
      }
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int causal,
                    float scale) {
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
  float* ds_s = v_s + BK * LD;   // [BQ][LP], ds rounded to T
  const size_t base = (size_t)bh * S * D;
  load_tile<T, D>(q_s, q + base, q0, S, BQ);
  load_tile<T, D>(do_s, dout + base, q0, S, BQ);

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
    load_tile<T, D>(k_s, k + base, k0, S, BK);
    load_tile<T, D>(v_s, v + base, k0, S, BK);
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
        ds_s[(ty + TY * i) * LP + tx + TX * j] = round_to<T>(p * (dp[i][j] - delta_r[i]));
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
    for (int j = 0; j < EC; ++j) dq[row + tx + TX * j] = from_f<T>(scale * acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int S, int causal, float scale) {
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
  float* pt_s = do_s + BQ * LD;    // [BK][LP], p^T rounded to T
  float* dst_s = pt_s + BK * LP;   // [BK][LP], ds^T rounded to T
  float* lse_s = dst_s + BK * LP;  // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]
  const size_t base = (size_t)bh * S * D;
  load_tile<T, D>(k_s, k + base, k0, S, BK);
  load_tile<T, D>(v_s, v + base, k0, S, BK);

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
    load_tile<T, D>(q_s, q + base, q0, S, BQ);
    load_tile<T, D>(do_s, dout + base, q0, S, BQ);
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
        pt_s[(ty + TY * i) * LP + r] = round_to<T>(p);
        dst_s[(ty + TY * i) * LP + r] = round_to<T>(p * (dpt[i][j] - delta_s[r]));
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
      dk[row + tx + TX * j] = from_f<T>(scale * dk_acc[i][j]);
      dv[row + tx + TX * j] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * LP);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * BQ * (D + 1) + BQ * LP);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * BQ * (D + 1) + 2 * BK * LP + 2 * BQ);
}

// Every instantiation needs more than the default 48 KB of dynamic shared
// memory at D >= 64; the attribute is set once per kernel.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

dim3 grid_of(int BH, int S) { return dim3(BH, (S + BQ - 1) / BQ); }

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, int out_f32,
               int BH, int S, int causal, float scale, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, fwd_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, fwd_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, out, (float*)lse, out_f32, S, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse,
                     int out_f32, int BH, int S, int causal, float scale, cudaStream_t stream) {
  using Tl = Tiles<D>;
  CUtensorMap maps[3];
  const void* src[3] = {q, k, v};
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)S * D * 2};
  const uint32_t box[3] = {(uint32_t)Tl::P, (uint32_t)BK, 1};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(src[i]) % 16 ||
        !hopper::make_map(&maps[i], src[i], 3, dims, strides, box))
      return (int)cudaErrorInvalidValue;
  }
  auto kernel = flash_fwd_wgmma_kernel<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, Tl::SMEM, &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), 128, Tl::SMEM, stream>>>(maps[0], maps[1], maps[2], out,
                                                    (float*)lse, out_f32, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int BH, int S, int causal, float scale,
              cudaStream_t stream) {
  auto kernel = flash_bwd_dq_kernel<T, D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dq_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, dq_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dq, S, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int BH, int S, int causal, float scale,
               cudaStream_t stream) {
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  static bool ready = false;
  cudaError_t err = allow_smem(kernel, dkv_smem<D>(), &ready);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid_of(BH, S), THREADS, dkv_smem<D>(), stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dk, (T*)dv, S, causal, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int S) { return BH < 1 || S < 1 || (S + BQ - 1) / BQ > 65535; }

}  // namespace

// The dispatch over dtype (0 = float32, 1 = bfloat16) and head dim.
#define FA_DISPATCH(FN, ...)                                                    \
  do {                                                                          \
    if (dtype == 0) {                                                           \
      switch (d) {                                                              \
        case 16: return FN<float, 16>(__VA_ARGS__);                             \
        case 32: return FN<float, 32>(__VA_ARGS__);                             \
        case 64: return FN<float, 64>(__VA_ARGS__);                             \
        case 128: return FN<float, 128>(__VA_ARGS__);                           \
      }                                                                         \
    } else if (dtype == 1) {                                                    \
      switch (d) {                                                              \
        case 16: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                     \
        case 32: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                     \
        case 64: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                     \
        case 128: return FN<__nv_bfloat16, 128>(__VA_ARGS__);                   \
      }                                                                         \
    }                                                                           \
    return (int)cudaErrorInvalidValue;                                          \
  } while (0)

extern "C" {

// The forward on the CUDA cores, float32 q, k, v (dtype 0; bfloat16 goes to
// flash_fwd_wgmma).  out [BH, S, d] float32; lse [BH, S] float32.  Each
// launcher returns the CUDA error code of its launch (0 = launched).
int flash_fwd(int dtype, int d, const void* q, const void* k, const void* v, void* out,
              void* lse, int out_f32, int BH, int S, int causal, float scale, void* stream) {
  if (bad_shape(BH, S) || dtype != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_fwd<float, 16>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 32: return launch_fwd<float, 32>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 64: return launch_fwd<float, 64>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 128: return launch_fwd<float, 128>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The forward on the tensor cores, bfloat16 q, k, v (16-byte aligned).  out
// [BH, S, d] bfloat16, or float32 when out_f32 != 0; lse [BH, S] float32.
int flash_fwd_wgmma(int d, const void* q, const void* k, const void* v, void* out, void* lse,
                    int out_f32, int BH, int S, int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 16: return launch_fwd_wgmma<16>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 32: return launch_fwd_wgmma<32>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 64: return launch_fwd_wgmma<64>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
    case 128: return launch_fwd_wgmma<128>(q, k, v, out, lse, out_f32, BH, S, causal, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dq [BH, S, d] in the input dtype; lse and delta [BH, S] float32.
int flash_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, void* dq, int BH, int S,
                 int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  FA_DISPATCH(launch_dq, q, k, v, dout, lse, delta, dq, BH, S, causal, scale,
              (cudaStream_t)stream);
}

// dk, dv [BH, S, d] in the input dtype.
int flash_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                  int BH, int S, int causal, float scale, void* stream) {
  if (bad_shape(BH, S)) return (int)cudaErrorInvalidValue;
  FA_DISPATCH(launch_dkv, q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale,
              (cudaStream_t)stream);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
