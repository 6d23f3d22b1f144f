// Times the f32 forward launcher (flash_fwd_fma) of one build of
// csrc/flash_attention.cu at B.H 64, S 1024, D 64 and 128, causal and full,
// on made-up inputs: 10 launches after 2, between CUDA events, L2 not
// flushed.  argv[1] names the build.  Run by fma_bench.py.

#include <cmath>
#include <cstdio>
#include <cuda_runtime.h>

extern "C" int flash_fwd_fma(int d, const void* q, const void* k, const void* v, void* out,
                             void* lse, int out_f32, int BH, int S, int causal, float scale,
                             void* stream);

__global__ void fill(float* x, size_t n, float a) {
  for (size_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x)
    x[i] = a * (float)((i * 2654435761u) % 1000) / 1000.f - a / 2;
}

int main(int argc, char** argv) {
  const char* name = argc > 1 ? argv[1] : "";
  const int BH = 64, S = 1024, iters = 10;
  for (int d : {64, 128}) {
    const size_t n = (size_t)BH * S * d;
    float *q, *k, *v, *out, *lse;
    for (float** p : {&q, &k, &v, &out}) cudaMalloc(p, n * sizeof(float));
    cudaMalloc(&lse, BH * S * sizeof(float));
    for (float* p : {q, k, v}) fill<<<1024, 256>>>(p, n, 2.f);
    const float scale = 1.f / sqrtf((float)d);
    for (int causal : {1, 0}) {
      auto run = [&] { return flash_fwd_fma(d, q, k, v, out, lse, 1, BH, S, causal, scale, 0); };
      int rc = run() | run();
      cudaEvent_t e0, e1;
      cudaEventCreate(&e0);
      cudaEventCreate(&e1);
      cudaEventRecord(e0);
      for (int i = 0; i < iters; ++i) rc |= run();
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      printf("%-22s D %3d causal %d: fwd %7.1f us  (launch rc %d, %s)\n", name, d, causal,
             ms * 1e3 / iters, rc, cudaGetErrorString(cudaGetLastError()));
    }
    for (float* p : {q, k, v, out, lse}) cudaFree(p);
  }
  return 0;
}
