// The rate of f32 FMAs fed from shared memory, by the block of products a
// thread owns.  Each thread of NT a block (MINB blocks an SM at most, the
// shared memory each asks for holding it there; 4 SMs' worth of 256-thread
// blocks of work) runs a loop over 64 elements of a contraction:
//   s[p][i][j] += a[p][i][e] * b[p][j][e]
// for P products of an RB x CB block each, reading its RB rows and CB
// columns from tiles padded to 68 floats as the f32 flash backward does
// (warps of 8 x 4 threads), VEC elements at a time (4: one float4, 1: one
// float).  Printed: TFLOP/s and the share of 67 TFLOP/s, the H100 SXM's f32
// rate.  Run by fma_bench.py.

#include <cstdio>
#include <cuda_runtime.h>

constexpr int LD = 68;

__device__ __forceinline__ float lane_of(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int RB, int CB, int P, int VEC, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB) fma_loop(float* out, int iters) {
  extern __shared__ float sm[];
  for (int i = threadIdx.x; i < 4 * 64 * LD; i += NT) sm[i] = (i % 7) * 1e-3f;
  __syncthreads();
  constexpr int GY = 64 / RB, GX = 64 / CB, GT = GY * GX;  // threads per 64 x 64 tile
  const int t = threadIdx.x % GT, grp = threadIdx.x / GT;
  const int w = t / 32, l = t % 32, txb = GX / 8;
  const int tx = l % 8 + 8 * (w % txb), ty = l / 8 + 4 * (w / txb);
  const float* a = sm + (grp % 2) * 64 * LD + ty * LD;
  const float* b = sm + 2 * 64 * LD + (grp / 2 % 2) * 64 * LD + tx * LD;
  float s[P][RB][CB] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll 2
    for (int e = 0; e < 64; e += 4) {
      float4 ar[P][RB], br[P][CB];
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float* x = a + p * LD + i * GY * LD + e;
          ar[p][i] = VEC == 4 ? *reinterpret_cast<const float4*>(x)
                              : make_float4(x[0], x[1], x[2], x[3]);
        }
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          const float* x = b + p * LD + j * GX * LD + e;
          br[p][j] = VEC == 4 ? *reinterpret_cast<const float4*>(x)
                              : make_float4(x[0], x[1], x[2], x[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int i = 0; i < RB; ++i)
#pragma unroll
            for (int j = 0; j < CB; ++j)
              s[p][i][j] = fmaf(lane_of(ar[p][i], u), lane_of(br[p][j], u), s[p][i][j]);
    }
  }
  float acc = 0;
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int j = 0; j < CB; ++j) acc += s[p][i][j];
  out[blockIdx.x * NT + threadIdx.x] = acc;
}

template <int RB, int CB, int P, int VEC, int NT = 256, int MINB = 1, int SMEM = 4 * 64 * LD * 4 + 8192>
void run(const char* name, float* out) {
  auto k = fma_loop<RB, CB, P, VEC, NT, MINB>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  cudaFuncSetAttribute(k, cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  const int iters = 200, blocks = 132 * 4 * 256 / NT;
  k<<<blocks, NT, SMEM>>>(out, 2);
  cudaEvent_t s, e;
  cudaEventCreate(&s);
  cudaEventCreate(&e);
  cudaEventRecord(s);
  k<<<blocks, NT, SMEM>>>(out, iters);
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms;
  cudaEventElapsedTime(&ms, s, e);
  const double flop = 2.0 * blocks * NT * iters * 64 * RB * CB * P;
  printf("%-26s %8.3f ms  %6.2f TFLOP/s  %.3f of 67  (%s)\n", name, ms, flop / ms / 1e9,
         flop / ms / 1e9 / 67.0, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  float* out;
  cudaMalloc(&out, 132 * 4 * 256 * sizeof(float));
  constexpr int TWO = 105 * 1024, ONE = 150 * 1024;  // shared memory for 2 or 1 blocks an SM
  run<4, 4, 2, 4>("4x4, two products, float4", out);
  run<4, 4, 2, 1>("4x4, two products, float", out);
  run<4, 4, 1, 4>("4x4, one product, float4", out);
  run<8, 4, 1, 4>("8x4, one product, float4", out);
  run<8, 4, 1, 1>("8x4, one product, float", out);
  run<8, 8, 1, 4>("8x8, one product, float4", out);
  run<8, 8, 1, 1>("8x8, one product, float", out);
  run<8, 4, 1, 4, 256, 2, TWO>("8x4, 256 threads, 2/SM", out);
  run<8, 4, 1, 4, 256, 1, ONE>("8x4, 256 threads, 1/SM", out);
  run<8, 8, 1, 4, 128, 2, TWO>("8x8, 128 threads, 2/SM", out);
  run<8, 8, 1, 4, 128, 1, ONE>("8x8, 128 threads, 1/SM", out);
  return 0;
}
