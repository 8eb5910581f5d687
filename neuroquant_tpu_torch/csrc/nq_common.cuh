// Device helpers shared by the decoder-tail kernels.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

using nq_bf16 = __nv_bfloat16;

// An element as fp32, and fp32 to an element (bf16: round to nearest even,
// what tensor.to(torch.bfloat16) does)
__device__ __forceinline__ float nq_f32(float v) { return v; }
__device__ __forceinline__ float nq_f32(nq_bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T nq_from_f32(float v);
template <>
__device__ __forceinline__ float nq_from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ nq_bf16 nq_from_f32<nq_bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// Two bf16 in one register, `lo` in the low half
__device__ __forceinline__ uint32_t nq_pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ float nq_bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float nq_bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Element u (a constant after unrolling) of a 16-byte vector of T, as fp32
__device__ __forceinline__ uint32_t nq_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T>
__device__ __forceinline__ float nq_lane(const uint4& v, int u);
template <>
__device__ __forceinline__ float nq_lane<float>(const uint4& v, int u) {
  return __uint_as_float(nq_word(v, u));
}
template <>
__device__ __forceinline__ float nq_lane<nq_bf16>(const uint4& v, int u) {
  const uint32_t w = nq_word(v, u >> 1);
  return (u & 1) ? nq_bf16_hi(w) : nq_bf16_lo(w);
}

// Four consecutive elements of T from fp32 values: one 16-byte (fp32) or
// 8-byte (bf16) store; p aligned to the store's size
__device__ __forceinline__ void nq_store4(float* p, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void nq_store4(nq_bf16* p, float a, float b,
                                          float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(nq_pack_bf16(a, b),
                                            nq_pack_bf16(c, d));
}

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

// GELU of the two bf16 of a register, in fp32, each rounded back to bf16
// (the JAX tail's `_gelu` on a bf16 operand)
__device__ __forceinline__ uint32_t nq_gelu_bf16x2(uint32_t w) {
  return nq_pack_bf16(nq_gelu(nq_bf16_lo(w)), nq_gelu(nq_bf16_hi(w)));
}
