// Device helpers shared by the decoder-tail kernels.
#pragma once

#include <cuda_runtime.h>

// erf by Abramowitz & Stegun 7.1.26 (max abs error 1.5e-7), evaluated in
// the same order as `_erf` in neuroquant_tpu/ops/tail_fused.py, so the
// kernels' GELU is the JAX tail's, not the exact-erf one.
__device__ __forceinline__ float nq_erf(float x) {
  const float s = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float nq_gelu(float x) {
  return 0.5f * x * (1.0f + nq_erf(x * 0.7071067811865476f));
}

// d/dz [z * Phi(z)] = Phi(z) + z * phi(z), in the order of `_gelu_grad` in
// neuroquant_tpu/ops/tail_fused.py: the backward's GELU' epilogue.
__device__ __forceinline__ float nq_gelu_grad(float z) {
  const float phi = expf(-0.5f * z * z) * 0.3989422804014327f;
  const float cdf = 0.5f * (1.0f + nq_erf(z * 0.7071067811865476f));
  return cdf + z * phi;
}
