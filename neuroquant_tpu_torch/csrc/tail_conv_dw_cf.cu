// tail_conv_dw_cf: weight and bias gradient of one conv layer of the
// channels-first decoder tail.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:1172
// `_dw_kernel` (launched by `_conv_cf_dw_one`):
//
//   dW[k, co] = sum_{b, m} g[b, co, m] * a(x[b, chan[k], m + shift[k]])
//
// with a = GELU when act_in (the saved residuals are pre-activations; GELU
// by the Abramowitz & Stegun erf of the JAX tail), over every position m of
// the (B, C, Mp) channels-first flat layout. g is the cotangent of the
// layer's output and is already border-masked, so no mask is applied here.
// The K axis is the forward's host-built list of (flat shift, input
// channel) rows (dense taps, or the union of nonzero blocks of a layer
// packed with f >= 2), so dW comes out in the forward's operand layout and
// the wrapper scatters it back to the canonical kernel. A row with channel
// -2 reads 1 everywhere: its dW row is db = sum_{b, m} g[b, co, m]. A row
// with channel -1 (K padding) reads 0.
//
// Bound on the H100: at HNeRV Bunny-3M, batch 2, operations. The
// reduction runs over B*Mp = 106,496 positions of the tail (8,192 at the
// prefix), the output is small (K rows x cout, e.g. 1,345 x 48 at the
// head), and the FLOPs equal the forward conv's: 2 x positions x K x cout
// (fp32, outside the tensor cores in this first version).
//
// Design for that bound: a tiled outer-product accumulation. A block of
// 256 threads owns a 64 (K rows) x 64 (output channels) tile and walks its
// share of the positions in stages of 32: it stages a(x) for its 64 rows and
// g for its 64 channels (each warp reads 4 rows x 8 consecutive positions,
// so the transposed shared-memory writes hit 32 distinct banks), then each
// thread accumulates a 4x4 register tile with float4 shared-memory reads.
// One block per output tile over all positions would leave most of the 132
// SMs idle at the small layers, so the positions are split across the
// grid's third axis; each split writes its partial tile to a scratch
// buffer, and a second pass adds the partials in a fixed order, so the
// result is the same from run to run (no atomics).

#include <cuda_runtime.h>

#include "nq_common.cuh"

namespace {

constexpr int BK = 64;    // K rows per block
constexpr int BC = 64;    // output channels per block
constexpr int BP = 32;    // positions per shared-memory stage
constexpr int LD = 68;    // padded stage row: float4-aligned, bank-spread
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
tail_conv_dw_cf_kernel(const float* __restrict__ x,
                       const float* __restrict__ g,
                       const int* __restrict__ kshift,
                       const int* __restrict__ kchan,
                       float* __restrict__ part, int cin, int cout, int mp,
                       int nk, int positions, int chunk, int act_in) {
  __shared__ __align__(16) float xs[BP][LD];
  __shared__ __align__(16) float gs[BP][LD];

  const int tid = threadIdx.x;
  const int tx = tid % 16;            // 4 output channels: tx*4..
  const int ty = tid / 16;            // 4 K rows: ty*4..
  const int k0 = blockIdx.x * BK;
  const int c0 = blockIdx.y * BC;
  const int p_begin = blockIdx.z * chunk;
  const int p_end = min(p_begin + chunk, positions);

  // staging map: lane -> position lane % 8 and row lane / 8 of its warp's
  // 8-position x 4-row patch; warp -> patch (warp % 4, warp / 4); rows
  // repeat every 8
  const int lane = tid % 32, warp = tid / 32;
  const int sp = (warp % 4) * 8 + lane % 8;
  const int sr = (warp / 4) * 4 + lane / 8;
  int rshift[BK / 8], rchan[BK / 8];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i) {
    const int k = k0 + sr + 8 * i;
    rchan[i] = k < nk ? kchan[k] : -1;
    rshift[i] = k < nk ? kshift[k] : 0;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int p0 = p_begin; p0 < p_end; p0 += BP) {
    const int p = p0 + sp;
    const bool valid = p < p_end;
    const int b = valid ? p / mp : 0;
    const int m = valid ? p - b * mp : 0;
    const float* xb = x + (size_t)b * cin * mp;
    const float* gb = g + (size_t)b * cout * mp;
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      const int r = sr + 8 * i;
      float v = 0.f;
      if (valid) {
        const int ch = rchan[i];
        if (ch == -2) {
          v = 1.f;
        } else if (ch >= 0) {
          const int pos = m + rshift[i];
          if (pos >= 0 && pos < mp) {
            v = xb[(size_t)ch * mp + pos];
            if (act_in) v = nq_gelu(v);
          }
        }
      }
      xs[sp][r] = v;
      const int c = c0 + r;
      gs[sp][r] = (valid && c < cout) ? gb[(size_t)c * mp + m] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pp = 0; pp < BP; ++pp) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[pp][ty * 4]);
      const float4 q = *reinterpret_cast<const float4*>(&gs[pp][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float qv[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], qv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* pout = part + (size_t)blockIdx.z * nk * cout;
  const int c = c0 + tx * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= nk) continue;
    float* row = pout + (size_t)k * cout;
    if (c + 3 < cout) {
      *reinterpret_cast<float4*>(row + c) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      for (int j = 0; j < 4; ++j)
        if (c + j < cout) row[c + j] = acc[i][j];
    }
  }
}

// out[i] = sum over splits s, in order, of part[s, i]
__global__ void dw_reduce_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + i];
  out[i] = s;
}

}  // namespace

extern "C" int nq_tail_conv_dw_cf(const float* x, const float* g,
                                  const int* kshift, const int* kchan,
                                  float* part, float* out, int batch, int cin,
                                  int cout, int mp, int nk, int splits,
                                  int chunk, int act_in, void* stream) {
  const long positions = (long)batch * mp;
  if (batch < 1 || cout < 1 || cout % 4 != 0 || nk < 1 || splits < 1 ||
      chunk < 1 || chunk % BP != 0 || mp % BP != 0 ||
      (long)splits * chunk < positions || positions > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nk + BK - 1) / BK, (cout + BC - 1) / BC, splits);
  tail_conv_dw_cf_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, g, kshift, kchan, part, cin, cout, mp, nk, (int)positions, chunk,
      act_in);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nk * cout;
  dw_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, out, n, splits);
  return (int)cudaGetLastError();
}
