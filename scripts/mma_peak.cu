// Peak rate of mma.sync.m16n8k8 TF32 on this card: every warp issues
// independent products from registers, nothing else. Built and timed by
// scripts/torch_mma_peak.py.
#include <cuda_runtime.h>

#include <cstdint>

template <int CHAINS>
__global__ void __launch_bounds__(256)
mma_peak_kernel(float* out, int iters) {
  float acc[CHAINS][4];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  uint32_t a[4], b[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = __float_as_uint(1.f + threadIdx.x + e);
  b[0] = __float_as_uint(0.5f);
  b[1] = __float_as_uint(0.25f);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]), "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) s += acc[c][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// returns milliseconds of one launch of `blocks` blocks of 8 warps, each
// warp issuing iters x chains products of 16x8x8
extern "C" float nq_mma_peak(float* out, int blocks, int iters, int chains) {
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  float ms = -1.f;
  for (int rep = 0; rep < 3; ++rep) {
    cudaEventRecord(t0);
    if (chains == 16)
      mma_peak_kernel<16><<<blocks, 256>>>(out, iters);
    else
      mma_peak_kernel<8><<<blocks, 256>>>(out, iters);
    cudaEventRecord(t1);
    cudaEventSynchronize(t1);
    cudaEventElapsedTime(&ms, t0, t1);
  }
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
