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
// The accumulation order differs from one plain matmul, so results agree to
// float tolerance, not bit for bit.
//
// What bounds it on this card: at decode (M = 8) the work is a few
// operations per weight byte, far below the H100's ~295 bf16 operations per
// byte, so the packed weight read bounds it (qkv: 0.79 MB at K=1024,
// N=1536).  The design reads each packed byte once from device memory
// (nibble-sized traffic, the point of int4) and unpacks in registers into a
// shared-memory tile that all M rows of the block reuse.  It is simple on
// purpose: CUDA-core FMAs, one 64-column tile per block, no split-K, so at
// decode the grid is only N/64 blocks (16..64) and underfills the 132 SMs.
// A later change should split K across blocks and feed wgmma for prefill.
//
// Shape rule (the wrapper checks it and raises): GS == 64, K % 64 == 0,
// N % 64 == 0, any M >= 1.  Every block matrix of FLAGSHIP_MODERN fits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GS = 64;     // input rows per scale group (one K step)
constexpr int HALF = GS / 2;
constexpr int BN = 64;     // output columns per block
constexpr int BM = 32;     // output rows per block
constexpr int THREADS = 256;
constexpr int RPT = BM / (THREADS / BN);  // output rows per thread (8)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scale, T* __restrict__ out,
                   int M, int K, int N) {
  __shared__ float xs[BM][GS];
  __shared__ float ws[GS][BN];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int col = tid % BN;        // this thread's output column in the tile
  const int row0 = (tid / BN) * RPT;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int g = 0; g < K / GS; ++g) {
    for (int i = tid; i < BM * GS; i += THREADS) {
      const int r = i / GS, k = i % GS, m = m0 + r;
      xs[r][k] = m < M ? to_f(x[(size_t)m * K + (size_t)g * GS + k]) : 0.f;
    }
    for (int i = tid; i < HALF * BN; i += THREADS) {
      const int kr = i / BN, c = i % BN;
      const uint8_t byte = packed[(size_t)(g * HALF + kr) * N + n0 + c];
      const float s = scale[(size_t)g * N + n0 + c];
      // round to x's dtype exactly where dequant() does
      ws[kr][c] = to_f(from_f<T>((float)((int)(byte & 0xF) - 8) * s));
      ws[kr + HALF][c] = to_f(from_f<T>((float)((int)(byte >> 4) - 8) * s));
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < GS; ++k) {
      const float w = ws[k][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i) acc[i] += xs[row0 + i][k] * w;
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + row0 + i;
    if (m < M) out[(size_t)m * N + n0 + col] = from_f<T>(acc[i]);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out).  Returns the CUDA error code
// of the launch (0 = launched).
int int4_matmul(int dtype, const void* x, const void* packed, const void* scale,
                void* out, int M, int K, int N, int group_size, void* stream) {
  if (group_size != GS || K % GS || N % BN || M < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    int4_matmul_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)x, (const uint8_t*)packed, (const float*)scale, (float*)out, M, K, N);
  } else if (dtype == 1) {
    int4_matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scale,
        (__nv_bfloat16*)out, M, K, N);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* int4_matmul_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
