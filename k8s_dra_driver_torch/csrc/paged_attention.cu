// Ragged paged attention over a block-pooled KV cache, for Hopper: a
// split-K decode over page ranges with a fixed-order merge.
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
// [B, nq, Hkv, D], table [B, max_blocks] int32, pos [B] int32, workspace
// [B, Hkv, n_splits, G*nq, D + 2] float32.
//
// What bounds it on this card: decode reads each live K/V page once
// (B=8, context 512, bf16: 4.19 MB per layer, 1.25 us at 3.35 TB/s) for ~17
// MFLOP, so device-memory bytes bound it, and with so little data per row
// the time goes to latency unless many loads are in flight on every SM.
//
// Design: two launches on the caller's stream.
// * partial (grid n_splits x Hkv x B, 128 threads): block (s, h, b) owns
//   pages [s*P, (s+1)*P) of row b (P = pages_per_split).  It reads pos[b]
//   and its P table entries together, returns at once when its range holds
//   no live page, then issues every load of its range before any compute:
//   the K and V stripes [D, bs] of each live page (contiguous in the pool)
//   land in shared memory in the pool dtype through 16-byte cp.async, pages
//   padded apart so lanes over keys hit distinct banks.  With APPEND the
//   window positions inside the range take new_k/new_v (and rows with
//   write_mask store them; each position lies in exactly one block's range).
//   Scores are computed lanes over keys; each query row then takes its
//   split-local max m_s, p = exp(s - m_s) (masked keys p = 0 exactly),
//   l_s summed from the unrounded p, and acc_s = sum p.V in f32 with p
//   rounded to the pool dtype first.  (m_s, l_s, acc_s) go to the workspace.
// * merge (grid Hkv x B): reads pos[b] and the row's live splits in the
//   fixed order s = 0 .. n_live-1: m = max m_s, l = sum l_s exp(m_s - m),
//   out = sum acc_s exp(m_s - m) / l, rounded once to the output dtype.
// A split may hold only keys masked for an early window query (pos = 63,
// nq = 4, 64-key splits: split 1 for query 0).  Its p are all 0, so l_s and
// acc_s are 0 and m_s stays -1e30; its merge weight exp(-1e30 - m) is 0 as
// well, since split 0 always holds key 0, which every query attends.  There
// are no atomics: two calls give the same bits.  Neither launch reads pos on
// the host; n_splits = ceil(max_blocks / P) comes from the table's shape.
//
// Rule (the wrapper checks it and raises): D in {16, 32, 64, 128}; with
// APPEND nq <= bs; pools 16-byte aligned; pos[b] + nq <= max_blocks * bs.

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

// the 16 bytes at p (16-byte aligned) widened to f32
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = w[i];
    const float2 f2 = __bfloat1622float2(pair);
    f[2 * i] = f2.x;
    f[2 * i + 1] = f2.y;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
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

// Shared-memory stride of one page's [D, bs] stripe, in elements: the
// stripe plus one page row rounded up to 16 bytes, so the keys of
// neighbouring pages start on other banks.
__host__ __device__ __forceinline__ int page_stride(int d, int bs, int itemsize) {
  const int pad = (bs * itemsize + 15) / 16 * 16;
  return (d * bs * itemsize + pad) / itemsize;
}

size_t partial_smem_bytes(int rows, int d, int bs, int pps, int nq, bool append,
                          int itemsize) {
  // k, v [pps][stride] and, with append, the window's k, v [nq][d] in the
  // pool dtype; q [rows][d], p [rows][pps*bs] in f32; the split's table
  // entries [pps]
  return (size_t)2 * pps * page_stride(d, bs, itemsize) * itemsize +
         (append ? (size_t)2 * nq * d * itemsize : 0) +
         sizeof(float) * ((size_t)rows * d + (size_t)rows * pps * bs) + sizeof(int) * pps;
}

// live pages of a row: those holding a position < pos + nq, within the table
__device__ __forceinline__ int live_pages(int p0, int nq, int bs, int max_blocks) {
  const int n = (p0 + nq + bs - 1) / bs;
  return n < max_blocks ? n : max_blocks;
}

template <typename T, int D, bool APPEND>
__global__ void __launch_bounds__(THREADS)
paged_attention_partial(const T* __restrict__ q, const T* __restrict__ new_k,
                        const T* __restrict__ new_v, T* k_pool, T* v_pool,
                        const int* __restrict__ table, const int* __restrict__ pos,
                        const int* __restrict__ write_mask, float* __restrict__ ws,
                        int hkv, int groups, int nq, int bs, int max_blocks, int pps,
                        int n_splits, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements in 16 bytes
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int hq = hkv * groups;
  const int rows = groups * nq;  // row r: query head h*G + r/nq, window index r%nq
  const int tk = pps * bs;       // keys of a whole split
  const int stride = page_stride(D, bs, sizeof(T));
  const int first = s * pps;
  const int* trow = table + (size_t)b * max_blocks;

  // pos and the split's table entries are loaded together
  int blk = 0;
  if (tid < pps && first + tid < max_blocks) blk = trow[first + tid];
  const int p0 = pos[b];
  const int wm = APPEND ? (write_mask ? write_mask[b] : 1) : 0;
  const int n_pages = live_pages(p0, nq, bs, max_blocks);
  if (first >= n_pages) return;  // no live page here: write nothing
  const int live = min(pps, n_pages - first);
  const int kbase = first * bs;
  const int n_keys = min(min(p0 + nq, n_pages * bs) - kbase, live * bs);

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);
  T* v_s = k_s + (size_t)pps * stride;
  T* win_k = v_s + (size_t)pps * stride;  // the window's new k, v (APPEND)
  T* win_v = win_k + (APPEND ? nq * D : 0);
  float* q_s = reinterpret_cast<float*>(win_v + (APPEND ? nq * D : 0));
  float* p_s = q_s + rows * D;
  int* blk_s = reinterpret_cast<int*>(p_s + rows * tk);
  if (tid < pps) blk_s[tid] = blk;
  __syncthreads();

  // every K/V load of the range in flight before any compute; a stripe of
  // (block, h) is D*bs contiguous elements at ((block * hkv + h) * D) * bs
  // (the pools are 16-byte aligned, the wrapper checks it, and a stripe
  // is a whole number of 16-byte pieces since D * sizeof(T) >= 32)
  const int chunks = D * bs / VEC;
  for (int c = tid; c < live * chunks; c += THREADS) {
    const int pg = c / chunks, w = c - pg * chunks;
    const size_t src = ((size_t)blk_s[pg] * hkv + h) * D * bs + (size_t)w * VEC;
    cp_async16(k_s + pg * stride + w * VEC, k_pool + src);
    cp_async16(v_s + pg * stride + w * VEC, v_pool + src);
  }
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, e = i - r * D;
    const int g = r / nq, j = r - g * nq;
    q_s[i] = to_f(q[(((size_t)b * nq + j) * hq + (size_t)h * groups + g) * D + e]);
  }
  // the window's own keys in this range, loaded while the stripes are in
  // flight and staged beside them; writing rows store them into the pool
  // (the stripes in flight may read the old or the new value: shared
  // memory takes the staged ones below either way)
  if (APPEND) {
    for (int i = tid; i < nq * D; i += THREADS) {
      const int j = i / D, e = i - j * D;
      const int p = p0 + j;
      const int pg = p / bs - first;
      if (pg < 0 || pg >= live) continue;  // another split's page, or past the table
      const size_t src = (((size_t)b * nq + j) * hkv + h) * D + e;
      win_k[i] = new_k[src];
      win_v[i] = new_v[src];
      if (wm != 0) {
        const size_t dst = (((size_t)blk_s[pg] * hkv + h) * D + e) * bs + (p % bs);
        k_pool[dst] = win_k[i];
        v_pool[dst] = win_v[i];
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (APPEND) {  // each thread moves the window elements it staged
    for (int i = tid; i < nq * D; i += THREADS) {
      const int j = i / D, e = i - j * D;
      const int t = p0 + j - kbase;
      if (t < 0 || t >= live * bs) continue;
      k_s[(t / bs) * stride + e * bs + t % bs] = win_k[i];
      v_s[(t / bs) * stride + e * bs + t % bs] = win_v[i];
    }
  }
  // positions of the last live page past the row's keys: V zero (their p is
  // 0, and the pool there may hold anything)
  for (int i = tid; i < (live * bs - n_keys) * D; i += THREADS) {
    const int t = n_keys + i / D, e = i % D;
    v_s[(t / bs) * stride + e * bs + t % bs] = from_f<T>(0.f);
  }
  __syncthreads();

  // scores, lanes over keys: masked pairs keep the -1e30 marker
  for (int i = tid; i < rows * tk; i += THREADS) {
    const int r = i / tk, t = i - r * tk;
    float sc = NEG_INF;
    if (t < n_keys && kbase + t <= p0 + r % nq) {
      const T* kc = k_s + (t / bs) * stride + t % bs;
      const float4* q4 = reinterpret_cast<const float4*>(q_s + r * D);
      float a = 0.f;
#pragma unroll 4
      for (int e4 = 0; e4 < D / 4; ++e4) {
        const float4 qv = q4[e4];
        a = fmaf(qv.x, to_f(kc[(4 * e4 + 0) * bs]), a);
        a = fmaf(qv.y, to_f(kc[(4 * e4 + 1) * bs]), a);
        a = fmaf(qv.z, to_f(kc[(4 * e4 + 2) * bs]), a);
        a = fmaf(qv.w, to_f(kc[(4 * e4 + 3) * bs]), a);
      }
      sc = a * scale;
    }
    p_s[i] = sc;
  }
  __syncthreads();

  // per query row: the split's max, p = exp(s - m_s) (0 where masked, so a
  // split masked for the whole row gives l_s = 0, acc_s = 0, m_s = -1e30),
  // l_s from the unrounded p, p rounded to the pool dtype for P.V
  float* ws_split = ws + (((size_t)b * hkv + h) * n_splits + s) * rows * (D + 2);
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < rows; r += THREADS / 32) {
    float* pr = p_s + r * tk;
    float mx = NEG_INF;
    for (int t = lane; t < tk; t += 32) mx = fmaxf(mx, pr[t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < tk; t += 32) {
      const float sc = pr[t];
      const float p = sc == NEG_INF ? 0.f : expf(sc - mx);
      sum += p;
      pr[t] = to_f(from_f<T>(p));
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ws_split[r * (D + 2) + D] = mx;
      ws_split[r * (D + 2) + D + 1] = sum;
    }
  }
  __syncthreads();

  // acc_s = P.V in f32: a thread per (row, feature), 16 bytes of V and of P
  // at a time where the page allows it
  const bool vec = bs % VEC == 0;
  for (int i = tid; i < rows * D; i += THREADS) {
    const int r = i / D, e = i - r * D;
    const float* pr = p_s + r * tk;
    float a = 0.f;
    if (vec) {
      for (int pg = 0; pg < live; ++pg) {
        const T* vr = v_s + pg * stride + e * bs;
        const float* pp = pr + pg * bs;
        for (int t = 0; t < bs; t += VEC) {
          float vv[VEC], pv[VEC];
          load16(vr + t, vv);
#pragma unroll
          for (int u = 0; u < VEC; u += 4) load16(pp + t + u, pv + u);
#pragma unroll
          for (int u = 0; u < VEC; ++u) a = fmaf(pv[u], vv[u], a);
        }
      }
    } else {
      for (int t = 0; t < n_keys; ++t)
        a = fmaf(pr[t], to_f(v_s[(t / bs) * stride + e * bs + t % bs]), a);
    }
    ws_split[r * (D + 2) + e] = a;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
paged_attention_merge(const float* __restrict__ ws, const int* __restrict__ pos,
                      void* __restrict__ out, int out_f32, int hkv, int groups, int nq,
                      int bs, int max_blocks, int pps, int n_splits) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int hq = hkv * groups;
  const int rows = groups * nq;
  const int n_pages = live_pages(pos[b], nq, bs, max_blocks);
  const int n_live = (n_pages + pps - 1) / pps;
  const size_t split_stride = (size_t)rows * (D + 2);
  const float* row_ws = ws + ((size_t)b * hkv + h) * n_splits * split_stride;
  // the splits' partials are read CHUNK at a time, all loads of a chunk in
  // flight together; a chunk's slots past the last live split weigh 0
  constexpr int CHUNK = 8;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, e = i - r * D;
    const float* pr = row_ws + r * (D + 2);
    float m = NEG_INF;
    for (int s0 = 0; s0 < n_live; s0 += CHUNK) {
      float ms[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u)
        ms[u] = s0 + u < n_live ? pr[(s0 + u) * split_stride + D] : NEG_INF;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) m = fmaxf(m, ms[u]);
    }
    float l = 0.f, a = 0.f;
    for (int s0 = 0; s0 < n_live; s0 += CHUNK) {
      float ms[CHUNK], ls[CHUNK], as[CHUNK];
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {
        const bool in = s0 + u < n_live;
        const float* ps = pr + (s0 + u) * split_stride;
        ms[u] = in ? ps[D] : NEG_INF;
        ls[u] = in ? ps[D + 1] : 0.f;
        as[u] = in ? ps[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) {  // the fixed order: repeatable bits
        const float w = expf(ms[u] - m);
        l = fmaf(ls[u], w, l);
        a = fmaf(as[u], w, a);
      }
    }
    // rounded once, to the query's dtype (out_f32: float32 queries over a
    // bf16 pool keep a float32 result, as the TPU kernel does)
    const int g = r / nq, j = r - g * nq;
    const size_t o = (((size_t)b * nq + j) * hq + (size_t)h * groups + g) * D + e;
    const float val = a / l;
    if (out_f32)
      static_cast<float*>(out)[o] = val;
    else
      static_cast<T*>(out)[o] = from_f<T>(val);
  }
}

template <typename T, int D, bool APPEND>
int launch(const void* q, const void* nk, const void* nv, void* kp, void* vp,
           const int* table, const int* pos, const int* wmask, float* ws, void* out,
           int out_f32, int B, int hkv, int groups, int nq, int bs, int max_blocks,
           int pps, int n_splits, float scale, cudaStream_t stream) {
  const size_t smem = partial_smem_bytes(groups * nq, D, bs, pps, nq, APPEND, sizeof(T));
  auto partial = paged_attention_partial<T, D, APPEND>;
  static size_t allowed = 48 * 1024;  // per instantiation: raise the cap once
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  partial<<<dim3(n_splits, hkv, B), THREADS, smem, stream>>>(
      (const T*)q, (const T*)nk, (const T*)nv, (T*)kp, (T*)vp, table, pos, wmask, ws,
      hkv, groups, nq, bs, max_blocks, pps, n_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attention_merge<T, D><<<dim3(hkv, B), THREADS, 0, stream>>>(
      ws, pos, out, out_f32, hkv, groups, nq, bs, max_blocks, pps, n_splits);
  return (int)cudaGetLastError();
}

template <typename T, bool APPEND>
int dispatch_d(int d, const void* q, const void* nk, const void* nv, void* kp, void* vp,
               const int* table, const int* pos, const int* wmask, float* ws, void* out,
               int out_f32, int B, int hkv, int groups, int nq, int bs, int max_blocks,
               int pps, int n_splits, float scale, cudaStream_t s) {
#define PA_LAUNCH(DIM)                                                                  \
  launch<T, DIM, APPEND>(q, nk, nv, kp, vp, table, pos, wmask, ws, out, out_f32, B, hkv, \
                         groups, nq, bs, max_blocks, pps, n_splits, scale, s)
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
// write_mask are read only when append != 0, and a null write_mask lets
// every row write.  workspace is float32
// [B, hkv, n_splits, groups * nq, d + 2] with n_splits * pages_per_split >=
// max_blocks.  Launches the partial and the merge kernel on `stream` and
// returns the first CUDA error code (0 = both launched).
int paged_attention(int dtype, int append, int d, const void* q, const void* new_k,
                    const void* new_v, void* k_pool, void* v_pool, const void* table,
                    const void* pos, const void* write_mask, void* workspace, void* out,
                    int out_f32, int B, int hkv, int groups, int nq, int bs, int max_blocks,
                    int pages_per_split, int n_splits, float scale, void* stream) {
  if (B < 1 || hkv < 1 || groups < 1 || nq < 1 || bs < 1 || max_blocks < 1 ||
      pages_per_split < 1 || pages_per_split > THREADS ||
      (long long)n_splits * pages_per_split < max_blocks)
    return (int)cudaErrorInvalidValue;
  const int* t = (const int*)table;
  const int* p = (const int*)pos;
  const int* w = (const int*)write_mask;
  float* ws = (float*)workspace;
  cudaStream_t s = (cudaStream_t)stream;
#define PA_DISPATCH(TYPE, APP)                                                           \
  dispatch_d<TYPE, APP>(d, q, new_k, new_v, k_pool, v_pool, t, p, w, ws, out, out_f32, B, \
                        hkv, groups, nq, bs, max_blocks, pages_per_split, n_splits, scale, s)
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
