// pack_cf: NHWC -> channels-first flat layout of the decoder tail's entry.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:656
// `_pack_cf_kernel` (launched by `_pack_cf_t`) together with the pad and
// flatten glue of `pack_cf` (:714-734), in one pass:
//
//   out[b, ch, (y+pad)*wp + (x+pad)] = in[b, y, x, ch]   (ch < c, interior)
//   out[...] = 0                    (border ring, channel pad, flat tail pad)
//
// in is (B, h, w, c) fp32 contiguous, out (B, c8, Mp) with
// wp = w + 2*pad, Mp >= (h+2*pad)*wp and Mp a multiple of the tile tm.
//
// Bound on the H100: bytes. A transpose with no arithmetic: the tail entry
// of HNeRV Bunny-3M reads 10.9 MB and writes 11.9 MB per frame, 6.8 us at
// 3.35 TB/s; the prefix entry's 1.9 MB is bound by launch latency.
//
// Design for that bound: a block owns an aligned tile of tm flat output
// positions (a power of two, 8..128; tail_fused.pack_cf_geometry picks it)
// x all c8 channels, and writes every output element of it exactly once,
// border ring, channel pad and tail pad included, so the output needs no
// memset.
// - The interior positions of a tile map to ONE contiguous run of input
//   positions (raster order on both sides), so the block reads that run,
//   positions x c floats, as 16-byte loads of its aligned cover (at c=53 a
//   run starts at any alignment; the block keeps the offset `shift`) and
//   stages it in shared memory as it lies.
// - Each position's row and column, and its offset in the staged run, are
//   computed once per tile (a table of tm ints), not per element.
// - Stores are 16-byte: a warp writes 16 channel rows x 8 positions, two
//   float4 per row, so every 32-byte sector of the output is written whole
//   by one instruction; the staged reads are at most 2-way bank-conflicted.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS_IN_FLIGHT = 8;    // loads a thread issues before it waits
constexpr int SMEM_MAX = 48 * 1024;   // without an opt-in attribute

// Input positions (flat over h*w) with a flat output index below m.
__device__ __forceinline__ int interior_before(int m, int h, int w, int pad,
                                               int wp) {
  const int r = m / wp, col = m - r * wp;
  const int rows = min(max(r - pad, 0), h);
  const int part = (r >= pad && r < pad + h) ? min(max(col - pad, 0), w) : 0;
  return rows * w + part;
}

__global__ void __launch_bounds__(THREADS)
pack_cf_kernel(const float* __restrict__ in, float* __restrict__ out, int h,
               int w, int c, int c8, int pad, int mp, int tm, int log_pairs) {
  extern __shared__ float4 smem4[];
  int* src = reinterpret_cast<int*>(smem4);             // [tm] run offsets
  float* run = reinterpret_cast<float*>(smem4) + tm;     // staged input run
  const int m0 = blockIdx.x * tm, b = blockIdx.y;
  const int wp = w + 2 * pad, hpwp = (h + 2 * pad) * wp;
  const int q0 = interior_before(min(m0, hpwp), h, w, pad, wp);
  const int q1 = interior_before(min(m0 + tm, hpwp), h, w, pad, wp);
  const float* base = in + ((size_t)b * h * w + q0) * c;
  const int shift = (int)((reinterpret_cast<uintptr_t>(base) >> 2) & 3);
  const int nv4 = q1 > q0 ? ((q1 - q0) * c + shift + 3) >> 2 : 0;
  const float4* cover = reinterpret_cast<const float4*>(base - shift);
  float4* run4 = reinterpret_cast<float4*>(run);
  // all LOADS_IN_FLIGHT loads of a thread are issued before any is stored,
  // so a block waits for one memory round trip, not one per load
  for (int i0 = threadIdx.x; i0 < nv4; i0 += THREADS * LOADS_IN_FLIGHT) {
    float4 v[LOADS_IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k)
      if (i0 + k * THREADS < nv4) v[k] = __ldg(cover + i0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k)
      if (i0 + k * THREADS < nv4) run4[i0 + k * THREADS] = v[k];
  }
  for (int t = threadIdx.x; t < tm; t += THREADS) {
    const int m = m0 + t, r = m / wp, col = m - r * wp;
    const bool inside = m < hpwp && r >= pad && r < pad + h && col >= pad &&
                        col < pad + w;
    src[t] = inside ? shift + ((r - pad) * w + col - pad - q0) * c : -1;
  }
  __syncthreads();

  // lane -> (channel chl of a 16-row slab, position half pg of 8 positions)
  const int lane = threadIdx.x & 31, chl = lane & 15, pg = lane >> 4;
  const int pairs = 1 << log_pairs;                      // tm / 8
  const int items = ((c8 + 15) >> 4) << log_pairs;
  for (int it = threadIdx.x >> 5; it < items; it += WARPS) {
    const int ch = ((it >> log_pairs) << 4) + chl;
    const int p = ((it & (pairs - 1)) << 3) + (pg << 2);
    if (ch >= c8) continue;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = src[p + i];
      v[i] = (ch < c && s >= 0) ? run[s + ch] : 0.f;
    }
    *reinterpret_cast<float4*>(out + ((size_t)b * c8 + ch) * mp + m0 + p) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

}  // namespace

// prm: batch, h, w, c, c8, pad, mp, tm (see tail_fused.pack_cf_geometry)
extern "C" int nq_pack_cf(const float* in, float* out, const int* prm,
                          void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], h = prm[1], w = prm[2], c = prm[3], c8 = prm[4],
            pad = prm[5], mp = prm[6], tm = prm[7];
  int log_pairs = 0;
  while ((8 << log_pairs) < tm) ++log_pairs;
  const size_t smem = (size_t)tm * sizeof(int) +
                      ((size_t)tm * c + 8) * sizeof(float);
  if (h < 1 || w < 1 || c < 1 || c8 < c || pad < 0 || tm < 8 || tm > 128 ||
      (8 << log_pairs) != tm || mp % tm ||
      mp < (h + 2 * pad) * (w + 2 * pad) || smem > SMEM_MAX ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(in) & 3))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mp / tm, batch);
  pack_cf_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      in, out, h, w, c, c8, pad, mp, tm, log_pairs);
  return (int)cudaGetLastError();
}
