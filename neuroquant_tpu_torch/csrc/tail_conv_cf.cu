// tail_conv_cf: one conv layer of the channels-first decoder tail.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:1133
// `_fwd_kernel` (launched by `_conv_cf_one`): the forward's `emit='z'|'y'`
// and `act_in` cases of `_tail_fwd_impl`, and the backward's dx pass with
// the `out_mul` epilogue (`_tail_apply_bwd`).
//
//   out[b, co, m] = e( mask[m] * (sum_k W[k, co] * a(x[b, chan[k], m + shift[k]]) + bias[co])
//                      * GELU'(out_mul[b, co, m]) )
//
// with a = GELU when act_in (else identity), e = GELU when emit_y, the
// GELU' factor only when out_mul is given (a template parameter, so the
// decode's instantiation is the one without it); GELU and GELU' by the
// Abramowitz & Stegun 7.1.26 erf that the JAX tail uses. x is
// (B, cin, Mp) fp32 channels-first flat with a zero border; positions
// outside [0, Mp) read zero. The K axis is a host-built list of rows
// (flat shift, input channel): the dense taps of an f=1 layer, or the
// union of nonzero blocks of a layer packed with f >= 2, which skips the
// packed kernel's structurally zero blocks (4x fewer MACs at the HNeRV
// Bunny head). Padded K rows have channel -1 and a zero weight row.
//
// Bound on the H100: at HNeRV Bunny-3M the prefix conv and tail L0/L1 are
// bound by operations (8.7 / 23.9 / 66.7 GFLOP per frame in fp32 against
// 67 TFLOP/s outside the tensor cores, ~0.13 / 0.36 / 1.0 ms), the head by
// bytes (~136 MB at 3.35 TB/s, ~0.04 ms). fp32 operands keep the kernel
// exact against the CPU reference, so the tensor cores (TF32/bf16) are not
// used in this first version.
//
// Design for that bound: a shared-memory tiled direct convolution. A block
// of 256 threads owns a 64 (output channels) x 128 (positions) tile and
// walks K in steps of 16 rows: it stages 16x64 weights and 16x128 shifted
// input values (coalesced along positions, GELU applied once per staged
// value) in shared memory, then each thread accumulates a 4x8 register
// tile with float4 shared-memory reads, 32 FMAs per 3 loads. The epilogue
// adds the bias, multiplies by GELU'(out_mul) for the dx pass, applies the
// border mask computed from the flat index, the output GELU, and writes
// float4 rows. Nothing is double-buffered yet.
//
// The dx pass runs on the transposed layer (channels swapped, taps
// mirrored, the convT's union blocks): it is the same function on another
// K list, so the same kernel.

#include <cuda_runtime.h>

#include "nq_common.cuh"

namespace {

constexpr int BM = 64;    // output channels per block
constexpr int BN = 128;   // flat positions per block
constexpr int BK = 16;    // K rows per shared-memory stage
constexpr int THREADS = 256;

template <bool kOutMul>
__global__ void __launch_bounds__(THREADS)
tail_conv_cf_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_mul,
                    const int* __restrict__ kshift,
                    const int* __restrict__ kchan, float* __restrict__ out,
                    int cin, int cout, int mp, int kpad, int h, int wd,
                    int pad, int act_in, int emit_y) {
  __shared__ __align__(16) float ws[BK][BM];
  __shared__ __align__(16) float xs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // 8 positions: tx*4.., 64+tx*4..
  const int ty = tid / 16;            // 4 output channels: ty*4..
  const int m0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * BM;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * cin * mp;

  const int xcol = tid % BN, xrow0 = tid / BN;   // 2 rows per pass
  const int wcol = tid % BM, wrow0 = tid / BM;   // 4 rows per pass

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kpad; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kr = xrow0 + 2 * i;
      const int ch = kchan[k0 + kr];
      const int pos = m0 + xcol + kshift[k0 + kr];
      float v = 0.f;
      if (ch >= 0 && pos >= 0 && pos < mp) {
        v = xb[(size_t)ch * mp + pos];
        if (act_in) v = nq_gelu(v);
      }
      xs[kr][xcol] = v;
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int kr = wrow0 + 4 * i;
      const int co = co0 + wcol;
      ws[kr][wcol] = co < cout ? w[(size_t)(k0 + kr) * cout + co] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[kk][ty * 4]);
      const float4 p0 = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
      const float4 p1 =
          *reinterpret_cast<const float4*>(&xs[kk][64 + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const int hp = h + 2 * pad, wp = wd + 2 * pad;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= cout) continue;
    const float bb = bias != nullptr ? bias[co] : 0.f;
    float* orow = out + ((size_t)b * cout + co) * mp;
    const float* mrow = kOutMul ? out_mul + ((size_t)b * cout + co) * mp
                                : nullptr;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mb = m0 + half * 64 + tx * 4;
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = mb + j;
        const int row = m / wp, col = m - (m / wp) * wp;
        const bool inside = m < hp * wp && row >= pad && row < pad + h &&
                            col >= pad && col < pad + wd;
        float z = acc[i][half * 4 + j] + bb;
        if (kOutMul && m < mp) z *= nq_gelu_grad(mrow[m]);
        z *= inside ? 1.f : 0.f;
        r[j] = emit_y ? nq_gelu(z) : z;
      }
      if (mb + 3 < mp) {
        *reinterpret_cast<float4*>(orow + mb) = make_float4(r[0], r[1], r[2],
                                                            r[3]);
      } else {
        for (int j = 0; j < 4; ++j)
          if (mb + j < mp) orow[mb + j] = r[j];
      }
    }
  }
}

}  // namespace

extern "C" int nq_tail_conv_cf(const float* x, const float* w,
                               const float* bias, const float* out_mul,
                               const int* kshift, const int* kchan,
                               float* out, int batch, int cin, int cout,
                               int mp, int kpad, int h, int wd, int pad,
                               int act_in, int emit_y, void* stream) {
  if (kpad % BK != 0 || mp % BN != 0 || batch < 1 || cout < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mp / BN, (cout + BM - 1) / BM, batch);
  if (out_mul != nullptr)
    tail_conv_cf_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, w, bias, out_mul, kshift, kchan, out, cin, cout, mp, kpad, h, wd,
        pad, act_in, emit_y);
  else
    tail_conv_cf_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        x, w, bias, nullptr, kshift, kchan, out, cin, cout, mp, kpad, h, wd,
        pad, act_in, emit_y);
  return (int)cudaGetLastError();
}

extern "C" const char* nq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
