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
//
// Instantiated for fp32 -> fp32, and for the bf16 tail (the TPU kernel's
// `out_dtype`, the fp32 -> bf16 entry of `_entry_and_cast` in one pass)
// fp32 -> bf16 and bf16 -> bf16: the same kernel on the input's element
// size (a 16-byte load is 8 bf16), values rounded to the output's type to
// nearest even (bf16 -> bf16 is exact), 8-byte stores of 4 bf16 per lane.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nq_common.cuh"

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

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
pack_cf_kernel(const TI* __restrict__ in, TO* __restrict__ out, int h,
               int w, int c, int c8, int pad, int mp, int tm, int log_pairs) {
  constexpr int VEC = 16 / sizeof(TI);                   // elements a load
  extern __shared__ uint4 smem4[];
  int* src = reinterpret_cast<int*>(smem4);             // [tm] run offsets
  TI* run = reinterpret_cast<TI*>(src + tm);             // staged input run
  const int m0 = blockIdx.x * tm, b = blockIdx.y;
  const int wp = w + 2 * pad, hpwp = (h + 2 * pad) * wp;
  const int q0 = interior_before(min(m0, hpwp), h, w, pad, wp);
  const int q1 = interior_before(min(m0 + tm, hpwp), h, w, pad, wp);
  const TI* base = in + ((size_t)b * h * w + q0) * c;
  const int shift =
      (int)((reinterpret_cast<uintptr_t>(base) / sizeof(TI)) & (VEC - 1));
  const int nv = q1 > q0 ? ((q1 - q0) * c + shift + VEC - 1) / VEC : 0;
  const uint4* cover = reinterpret_cast<const uint4*>(base - shift);
  uint4* run4 = reinterpret_cast<uint4*>(run);
  // all LOADS_IN_FLIGHT loads of a thread are issued before any is stored,
  // so a block waits for one memory round trip, not one per load
  for (int i0 = threadIdx.x; i0 < nv; i0 += THREADS * LOADS_IN_FLIGHT) {
    uint4 v[LOADS_IN_FLIGHT];
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k)
      if (i0 + k * THREADS < nv) v[k] = __ldg(cover + i0 + k * THREADS);
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k)
      if (i0 + k * THREADS < nv) run4[i0 + k * THREADS] = v[k];
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
      v[i] = (ch < c && s >= 0) ? nq_f32(run[s + ch]) : 0.f;
    }
    nq_store4(out + ((size_t)b * c8 + ch) * mp + m0 + p, v[0], v[1], v[2],
              v[3]);
  }
}

}  // namespace

// prm: batch, h, w, c, c8, pad, mp, tm (see tail_fused.pack_cf_geometry),
// then the input's and the output's type: 0 fp32, 1 bf16 (fp32 -> fp32,
// fp32 -> bf16, bf16 -> bf16)
extern "C" int nq_pack_cf(const void* in, void* out, const int* prm,
                          void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], h = prm[1], w = prm[2], c = prm[3], c8 = prm[4],
            pad = prm[5], mp = prm[6], tm = prm[7], tin = prm[8],
            tout = prm[9];
  int log_pairs = 0;
  while ((8 << log_pairs) < tm) ++log_pairs;
  const size_t isz = tin == 1 ? 2 : 4;
  // the offset table, the staged run and room for its 16-byte cover
  const size_t smem = (size_t)tm * sizeof(int) +
                      ((size_t)tm * c + 32 / isz) * isz;
  if (h < 1 || w < 1 || c < 1 || c8 < c || pad < 0 || tm < 8 || tm > 128 ||
      (8 << log_pairs) != tm || mp % tm ||
      mp < (h + 2 * pad) * (w + 2 * pad) || smem > SMEM_MAX ||
      (tin == 1 && tout != 1) || tin < 0 || tin > 1 || tout < 0 ||
      tout > 1 || (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(in) & (isz - 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(mp / tm, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tin == 0 && tout == 0)
    pack_cf_kernel<float, float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(in), static_cast<float*>(out), h, w, c, c8,
        pad, mp, tm, log_pairs);
  else if (tin == 0)
    pack_cf_kernel<float, nq_bf16><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(in), static_cast<nq_bf16*>(out), h, w, c,
        c8, pad, mp, tm, log_pairs);
  else
    pack_cf_kernel<nq_bf16, nq_bf16><<<grid, THREADS, smem, st>>>(
        static_cast<const nq_bf16*>(in), static_cast<nq_bf16*>(out), h, w, c,
        c8, pad, mp, tm, log_pairs);
  return (int)cudaGetLastError();
}
