// Times the f32 backward launchers (flash_bwd_dq_fma, flash_bwd_dkv_fma) of
// one build of csrc/flash_attention.cu at B.H 64, S 1024, D 64 and 128,
// causal and full, on made-up inputs: 10 launches after 2, between CUDA
// events, L2 not flushed.  argv[1] names the build.  Run by fma_bench.py.

#include <cmath>
#include <cstdio>
#include <cuda_runtime.h>

extern "C" int flash_bwd_dq_fma(int d, const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                int BH, int S, int causal, float scale, void* stream);
extern "C" int flash_bwd_dkv_fma(int d, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta, void* dk,
                                 void* dv, int BH, int S, int causal, float scale, void* stream);

__global__ void fill(float* x, size_t n, float a) {
  for (size_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    x[i] = a * (float)((i * 2654435761u) % 1000) / 1000.f - a / 2;
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "";
  const int BH = 64, S = 1024, iters = 10;
  for (int d : {64, 128}) {
    const size_t n = (size_t)BH * S * d;
    float *q, *k, *v, *dout, *dq, *dk, *dv, *lse, *delta;
    for (float** p : {&q, &k, &v, &dout, &dq, &dk, &dv}) cudaMalloc(p, n * sizeof(float));
    cudaMalloc(&lse, BH * S * sizeof(float));
    cudaMalloc(&delta, BH * S * sizeof(float));
    for (float* p : {q, k, v, dout}) fill<<<1024, 256>>>(p, n, 2.f);
    for (float* p : {lse, delta}) fill<<<64, 256>>>(p, BH * S, 1.f);
    const float scale = 1.f / sqrtf((float)d);
    for (int causal : {1, 0}) {
      auto run_dq = [&] {
        return flash_bwd_dq_fma(d, q, k, v, dout, lse, delta, dq, BH, S, causal, scale, 0);
      };
      auto run_dkv = [&] {
        return flash_bwd_dkv_fma(d, q, k, v, dout, lse, delta, dk, dv, BH, S, causal, scale, 0);
      };
      int rc = run_dq() | run_dkv() | run_dq() | run_dkv();
      cudaEvent_t e0, e1, e2;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventCreate(&e2);
      cudaEventRecord(e0);
      for (int i = 0; i < iters; ++i) rc |= run_dq();
      cudaEventRecord(e1);
      for (int i = 0; i < iters; ++i) rc |= run_dkv();
      cudaEventRecord(e2);
      cudaEventSynchronize(e2);
      float ms_dq, ms_dkv;
      cudaEventElapsedTime(&ms_dq, e0, e1);
      cudaEventElapsedTime(&ms_dkv, e1, e2);
      printf("%-22s D %3d causal %d: dq %7.1f us  dkv %7.1f us  (launch rc %d, %s)\n", name, d,
             causal, ms_dq * 1e3 / iters, ms_dkv * 1e3 / iters, rc,
             cudaGetErrorString(cudaGetLastError()));
    }
    for (float* p : {q, k, v, dout, dq, dk, dv, lse, delta}) cudaFree(p);
  }
  return 0;
}
