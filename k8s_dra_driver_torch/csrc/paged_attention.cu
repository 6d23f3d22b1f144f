// Ragged paged attention over a block-pooled KV cache, for Hopper.
//
// Replaces the TPU kernel `_paged_kernel` (k8s_dra_driver_tpu/ops/
// paged_attention.py) in both its instantiations: APPEND = true is the fused
// append+attend of `paged_append_attention` (the serving decode step), and
// APPEND = false the read-only `paged_window_attention` /
// `paged_decode_attention`.
//
// What it computes, for row b and KV head h: query j of the window (nq
// queries at positions pos[b] .. pos[b]+nq-1, G = Hq/Hkv query heads per KV
// head) attends key positions <= pos[b] + j through the row's block table,
// softmax in f32 with masked scores at -1e30.  With APPEND the window's own
// keys come from new_k/new_v (so every row, written or not, attends the same
// keys the TPU kernel blends in), and rows with write_mask[b] != 0 also store
// them into the pool in place.  Rows with write_mask 0 never write: their
// tables may be stale and point at blocks another row now owns.
//
// Layout: one layer's pool [n_blocks, Hkv, D, bs] (positions contiguous on
// the last axis, the JAX package's layout), q/out [B, nq, Hq, D], new k/v
// [B, nq, Hkv, D], table [B, max_blocks] int32, pos [B] int32.
//
// Design: one thread block per (row, KV head), so a block touches only its
// own row's pages and its own head's stripe and no two blocks race.  The
// block walks only the row's live pages, a tile of `pages_per_tile` pages
// (~64 keys) at a time: the K and V stripes of the tile land in shared
// memory as f32, each warp owns query rows and computes their scores (lanes
// over key positions, coalesced), the online-softmax state (m, l) and the
// accumulator stay in f32 in shared memory.  Probabilities are rounded to
// the pool dtype before the P.V product, as the TPU kernel does.
//
// What bounds it on this card: decode reads each live K/V page once
// (B=8, context 512, bf16: 4.19 MB per layer, 1.25 us at 3.35 TB/s) for ~17
// MFLOP, so device-memory bytes bound it.  The kernel reads each live page
// exactly once and skips dead pages.  It is the simple version: the grid is
// B * Hkv blocks (32 at the serving shape), which underfills the 132 SMs;
// split-K decoding (several blocks per row, merged by their (m, l)) is the
// next step and is left to a later change.
//
// Rule (the wrapper checks it and raises): D in {16, 32, 64, 128}; with
// APPEND nq <= bs; pos[b] + nq <= max_blocks * bs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes(int rows, int d, int tk) {
  // q, acc [rows][d]; k, v [d][tk + 1]; p [rows][tk]; m, l [rows]
  return sizeof(float) *
         ((size_t)2 * rows * d + (size_t)2 * d * (tk + 1) + (size_t)rows * tk + 2 * rows);
}

template <typename T, int D, bool APPEND>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ new_k,
                       const T* __restrict__ new_v, T* k_pool, T* v_pool,
                       const int* __restrict__ table, const int* __restrict__ pos,
                       const int* __restrict__ write_mask, void* __restrict__ out,
                       int out_f32, int hkv, int groups, int nq, int bs,
                       int max_blocks, int pages_per_tile, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int hq = hkv * groups;
  const int rows = groups * nq;  // row r: query head h*G + r/nq, window index r%nq
  const int tk = bs * pages_per_tile;
  const int ks = tk + 1;         // padded stride: lanes over features hit distinct banks
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc_s = q_s + rows * D;
  float* k_s = acc_s + rows * D;
  float* v_s = k_s + D * ks;
  float* p_s = v_s + D * ks;
  float* m_s = p_s + rows * tk;
  float* l_s = m_s + rows;

  const int p0 = pos[b];
  const int length = p0 + nq;  // keys attended by the last window query
  const int* trow = table + (size_t)b * max_blocks;
  int n_pages = (length + bs - 1) / bs;
  if (n_pages > max_blocks) n_pages = max_blocks;
  // pool element (block, h, e, t) sits at ((block * hkv + h) * D + e) * bs + t

  if (APPEND && write_mask[b] != 0) {
    for (int i = threadIdx.x; i < nq * D; i += THREADS) {
      const int j = i / D, e = i % D;
      const int p = p0 + j;
      if (p / bs >= max_blocks) continue;  // past the table: the caller's contract
      const size_t blk = (size_t)trow[p / bs];
      const size_t dst = ((blk * hkv + h) * D + e) * bs + (p % bs);
      const size_t src = (((size_t)b * nq + j) * hkv + h) * D + e;
      k_pool[dst] = new_k[src];
      v_pool[dst] = new_v[src];
    }
  }
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, e = i % D;
    const int g = r / nq, j = r % nq;
    q_s[i] = to_f(q[(((size_t)b * nq + j) * hq + (size_t)h * groups + g) * D + e]);
    acc_s[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = THREADS / 32;
  const int n_tiles = (n_pages + pages_per_tile - 1) / pages_per_tile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kbase = tile * tk;
    for (int i = threadIdx.x; i < D * tk; i += THREADS) {
      const int e = i / tk, tt = i % tk;
      const int page = tile * pages_per_tile + tt / bs;
      const int kp = kbase + tt;
      float kv = 0.f, vv = 0.f;  // dead positions: zero V (their weight is 0)
      if (kp < length && page < n_pages) {
        if (APPEND && kp >= p0) {
          const size_t src = (((size_t)b * nq + (kp - p0)) * hkv + h) * D + e;
          kv = to_f(new_k[src]);
          vv = to_f(new_v[src]);
        } else {
          const size_t blk = (size_t)trow[page];
          const size_t off = ((blk * hkv + h) * D + e) * bs + (tt % bs);
          kv = to_f(k_pool[off]);
          vv = to_f(v_pool[off]);
        }
      }
      k_s[e * ks + tt] = kv;
      v_s[e * ks + tt] = vv;
    }
    __syncthreads();

    for (int r = warp; r < rows; r += n_warps) {
      const int limit = p0 + r % nq;  // window query j attends kp <= pos + j
      const float* qr = q_s + r * D;
      float* pr = p_s + r * tk;
      float mx = NEG_INF;
      for (int tt = lane; tt < tk; tt += 32) {
        float s = 0.f;
#pragma unroll 16
        for (int e = 0; e < D; ++e) s += qr[e] * k_s[e * ks + tt];
        s *= scale;
        if (kbase + tt > limit) s = NEG_INF;
        pr[tt] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int tt = lane; tt < tk; tt += 32) {
        const float p = expf(pr[tt] - m_new);
        sum += p;
        pr[tt] = to_f(from_f<T>(p));  // P in the pool dtype for the P.V product
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      __syncwarp();
      for (int e = lane; e < D; e += 32) {
        float a = 0.f;
        for (int tt = 0; tt < tk; ++tt) a += pr[tt] * v_s[e * ks + tt];
        acc_s[r * D + e] = acc_s[r * D + e] * corr + a;
      }
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();
  }

  // the f32 state is rounded once, to the query's dtype (out_f32: float32
  // queries over a bf16 pool keep a float32 result, as the TPU kernel does)
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, e = i % D;
    const int g = r / nq, j = r % nq;
    const size_t o = (((size_t)b * nq + j) * hq + (size_t)h * groups + g) * D + e;
    const float val = acc_s[i] / l_s[r];
    if (out_f32)
      static_cast<float*>(out)[o] = val;
    else
      static_cast<T*>(out)[o] = from_f<T>(val);
  }
}

template <typename T, int D, bool APPEND>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const int* table, const int* pos, const int* wmask, void* out,
           int out_f32, int B, int hkv, int groups, int nq, int bs,
           int max_blocks, int pages_per_tile, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(groups * nq, D, bs * pages_per_tile);
  auto kernel = paged_attention_kernel<T, D, APPEND>;
  static size_t allowed = 48 * 1024;  // per instantiation: raise the cap once
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  dim3 grid(B, hkv);
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)nk, (const T*)nv, (T*)kp, (T*)vp, table, pos, wmask,
      out, out_f32, hkv, groups, nq, bs, max_blocks, pages_per_tile, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool APPEND>
int dispatch_d(int d, const void* q, const void* nk, const void* nv, void* kp, void* vp,
               const int* table, const int* pos, const int* wmask, void* out,
               int out_f32, int B, int hkv, int groups, int nq, int bs,
               int max_blocks, int ppt, float scale, cudaStream_t s) {
#define PA_LAUNCH(DIM)                                                              \
  launch<T, DIM, APPEND>(q, nk, nv, kp, vp, table, pos, wmask, out, out_f32, B, hkv, \
                         groups, nq, bs, max_blocks, ppt, scale, s)
  switch (d) {
    case 16: return PA_LAUNCH(16);
    case 32: return PA_LAUNCH(32);
    case 64: return PA_LAUNCH(64);
    case 128: return PA_LAUNCH(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PA_LAUNCH
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, new k/v and the pools share it);
// out is float32 when out_f32 != 0, else in that dtype.  k_pool/v_pool
// point at ONE layer's pool [n_blocks, hkv, d, bs]; new_k, new_v and
// write_mask are read only when append != 0.  Returns the CUDA error code of
// the launch (0 = launched).
int paged_attention(int dtype, int append, int d, const void* q, const void* new_k,
                    const void* new_v, void* k_pool, void* v_pool, const void* table,
                    const void* pos, const void* write_mask, void* out, int out_f32,
                    int B, int hkv, int groups, int nq, int bs, int max_blocks,
                    int pages_per_tile, float scale, void* stream) {
  if (B < 1 || hkv < 1 || groups < 1 || nq < 1 || bs < 1 || max_blocks < 1 ||
      pages_per_tile < 1)
    return (int)cudaErrorInvalidValue;
  const int* t = (const int*)table;
  const int* p = (const int*)pos;
  const int* w = (const int*)write_mask;
  cudaStream_t s = (cudaStream_t)stream;
#define PA_DISPATCH(TYPE, APP)                                                      \
  dispatch_d<TYPE, APP>(d, q, new_k, new_v, k_pool, v_pool, t, p, w, out, out_f32, B, \
                        hkv, groups, nq, bs, max_blocks, pages_per_tile, scale, s)
  if (dtype == 0) return append ? PA_DISPATCH(float, true) : PA_DISPATCH(float, false);
  if (dtype == 1)
    return append ? PA_DISPATCH(__nv_bfloat16, true) : PA_DISPATCH(__nv_bfloat16, false);
#undef PA_DISPATCH
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
