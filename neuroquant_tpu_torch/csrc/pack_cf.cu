// pack_cf: NHWC -> channels-first flat layout of the decoder tail's entry.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:656
// `_pack_cf_kernel` (launched by `_pack_cf_t`) together with the pad and
// flatten glue of `pack_cf` (:714-734), in one pass:
//
//   out[b, ch, (y+pad)*wp + (x+pad)] = in[b, y, x, ch]   (ch < c, interior)
//   out[...] = 0                    (border ring, channel pad, flat tail pad)
//
// in is (B, h, w, c) contiguous, out (B, c8, Mp) with wp = w + 2*pad,
// Mp >= (h+2*pad)*wp and Mp a multiple of the tile tm.
//
// Bound on the H100: bytes. A transpose with no arithmetic: the tail entry
// of HNeRV Bunny-3M reads 10.9 MB and writes 11.9 MB per frame in fp32
// (6.8 us at 3.35 TB/s), 6.0 MB in bf16 (5.0 us); the prefix entry's
// 0.8-1.9 MB is bound by launch latency.
//
// Both kernels below own aligned tiles of tm flat output positions x all
// c8 channels and write every output element of a tile exactly once,
// border ring, channel pad and tail pad included, so the output needs no
// memset. The interior positions of a tile map to ONE contiguous run of
// input positions (raster order on both sides), positions x c elements; a
// block stages the run's 16-byte-aligned cover in shared memory as it
// lies (at c=53 a run starts at any alignment; the block keeps the offset
// `shift`), and a table of tm ints gives each position's offset in it
// (computed once per tile, not per element).
//
// fp32 -> fp32 (pack_cf_kernel): one tile per block (tm a power of two,
// 8..128; tail_fused.pack_cf_geometry picks it); the run loaded with
// 16-byte loads, 8 in flight per thread; a warp writes 16 channel rows x 8
// positions, two float4 per row, so every 32-byte sector of the output is
// written whole by one instruction; the staged reads are at most 2-way
// bank-conflicted.
//
// -> bf16, from fp32 (the tail's bf16 entry, the TPU kernel's `out_dtype`:
// `_entry_and_cast` in one pass) or from bf16 (pack_cf_bf16_kernel): the
// same map, redesigned for 2-byte outputs (tail_fused.pack_cf_bf16_geometry
// picks the tile):
// - the run arrives by one TMA bulk copy under an mbarrier, while the
//   block's threads compute the offset table;
// - a lane pair writes 16 positions of one channel row, 8 bf16 (16 bytes)
//   a lane, so a warp's instruction writes 16 whole 32-byte sectors; the
//   staged reads of the two lanes of a pair are 8 positions apart;
// - tiles of 16 to 256 positions, one a block: 64 at the Bunny tail
//   entry, 832 blocks an image, all resident at once. Fewer blocks, each
//   walking several tiles through a two-stage ring of bulk copies, were
//   slower at every shape measured (PERF.md, Findings);
// - values rounded to bf16 to nearest even (bf16 -> bf16 is exact).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nq_common.cuh"
#include "nq_tma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LOADS_IN_FLIGHT = 8;    // loads a thread issues before it waits
constexpr int SMEM_MAX = 48 * 1024;   // without an opt-in attribute
constexpr int SMEM_BLOCK = 232448;    // a block's shared memory, at most

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
  extern __shared__ uint4 smem4[];
  int* src = reinterpret_cast<int*>(smem4);             // [tm] run offsets
  float* run = reinterpret_cast<float*>(src + tm);       // staged input run
  const int m0 = blockIdx.x * tm, b = blockIdx.y;
  const int wp = w + 2 * pad, hpwp = (h + 2 * pad) * wp;
  const int q0 = interior_before(min(m0, hpwp), h, w, pad, wp);
  const int q1 = interior_before(min(m0 + tm, hpwp), h, w, pad, wp);
  const float* base = in + ((size_t)b * h * w + q0) * c;
  const int shift = (int)((reinterpret_cast<uintptr_t>(base) / 4) & 3);
  const int nv = q1 > q0 ? ((q1 - q0) * c + shift + 3) / 4 : 0;
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
      v[i] = (ch < c && s >= 0) ? run[s + ch] : 0.f;
    }
    nq_store4(out + ((size_t)b * c8 + ch) * mp + m0 + p, v[0], v[1], v[2],
              v[3]);
  }
}

// ---- bf16 outputs ----------------------------------------------------------

// The bits of an element rounded to bf16 (nearest even; exact from bf16)
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_bits(nq_bf16 v) {
  return __bfloat16_as_ushort(v);
}

// Shared memory of the bf16 kernel: its mbarrier, the tile's offset
// table (tm ints) from byte 128, then the staged run (tm*c elements and 32
// bytes for its cover's offset and rounding) from a 128-byte boundary.
// tail_fused.pack_cf_bf16_geometry mirrors it.
__host__ __device__ __forceinline__ int run_offset(int tm) {
  return 128 + (tm * 4 + 127) / 128 * 128;
}
__host__ __device__ __forceinline__ int bf16_smem(int tm, int c, int isz) {
  return run_offset(tm) + (tm * c * isz + 32 + 127) / 128 * 128;
}

template <typename TI>
__global__ void __launch_bounds__(THREADS)
pack_cf_bf16_kernel(const TI* __restrict__ in, nq_bf16* __restrict__ out,
                    int h, int w, int c, int c8, int pad, int mp, int tm) {
  constexpr int VEC = 16 / sizeof(TI);                   // elements a 16 B
  extern __shared__ __align__(128) unsigned char smem[];
  int* src = reinterpret_cast<int*>(smem + 128);         // [tm] run offsets
  const TI* run = reinterpret_cast<const TI*>(smem + run_offset(tm));
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int m0 = blockIdx.x * tm, b = blockIdx.y;
  const int wp = w + 2 * pad, hpwp = (h + 2 * pad) * wp;
  const int q0 = interior_before(min(m0, hpwp), h, w, pad, wp);
  const int q1 = interior_before(min(m0 + tm, hpwp), h, w, pad, wp);
  const TI* base = in + ((size_t)b * h * w + q0) * c;
  const int shift =
      (int)((reinterpret_cast<uintptr_t>(base) / sizeof(TI)) & (VEC - 1));
  // thread 0: the run's 16-byte cover in one bulk copy
  if (threadIdx.x == 0) {
    nq_mbar_init(bar, 1);
    nq_fence_mbar_init();
    if (q1 > q0) {
      const uint32_t bytes =
          (((q1 - q0) * c + shift) * (int)sizeof(TI) + 15) / 16 * 16;
      nq_mbar_expect_tx(bar, bytes);
      nq_bulk_load((uint32_t)__cvta_generic_to_shared(run), base - shift,
                   bytes, bar);
    } else {
      nq_mbar_arrive(bar);         // a tile of border and pad only
    }
  }
  // while it is in flight: each position's offset in the run, or -1
  for (int t = threadIdx.x; t < tm; t += THREADS) {
    const int m = m0 + t, r = m / wp, col = m - r * wp;
    const bool inside = m < hpwp && r >= pad && r < pad + h && col >= pad &&
                        col < pad + w;
    src[t] = inside ? shift + ((r - pad) * w + col - pad - q0) * c : -1;
  }
  __syncthreads();                 // the table, and the mbarrier's init
  nq_mbar_wait(bar, 0);

  // a lane pair per channel row, 8 positions (16 bytes) a lane
  const int lane = threadIdx.x & 31;
  const int row = lane >> 1, half = lane & 1;
  const int groups = tm >> 4;                   // 16-position groups
  const int items = ((c8 + 15) >> 4) * groups;
  for (int it = threadIdx.x >> 5; it < items; it += WARPS) {
    const int slab = it / groups;
    const int ch = slab * 16 + row;
    if (ch >= c8) continue;
    const int p = (it - slab * groups) * 16 + half * 8;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s0 = src[p + 2 * i], s1 = src[p + 2 * i + 1];
      const uint32_t lo = (ch < c && s0 >= 0) ? bf16_bits(run[s0 + ch]) : 0;
      const uint32_t hi = (ch < c && s1 >= 0) ? bf16_bits(run[s1 + ch]) : 0;
      v[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(out + ((size_t)b * c8 + ch) * mp + m0 + p) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <typename TI>
cudaError_t launch_bf16(const void* in, void* out, int batch, int h, int w,
                        int c, int c8, int pad, int mp, int tm, int smem,
                        cudaStream_t st) {
  auto kernel = pack_cf_bf16_kernel<TI>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<dim3(mp / tm, batch), THREADS, smem, st>>>(
      static_cast<const TI*>(in), static_cast<nq_bf16*>(out), h, w, c, c8,
      pad, mp, tm);
  return cudaGetLastError();
}

}  // namespace

// prm: batch, h, w, c, c8, pad, mp, tm, the input's and the output's type
// (0 fp32, 1 bf16: fp32 -> fp32, fp32 -> bf16, bf16 -> bf16), then the
// shared-memory bytes a block (see tail_fused.pack_cf_geometry and
// pack_cf_bf16_geometry)
extern "C" int nq_pack_cf(const void* in, void* out, const int* prm,
                          void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], h = prm[1], w = prm[2], c = prm[3], c8 = prm[4],
            pad = prm[5], mp = prm[6], tm = prm[7], tin = prm[8],
            tout = prm[9], smem_in = prm[10];
  const cudaStream_t st = (cudaStream_t)stream;
  if (h < 1 || w < 1 || c < 1 || c8 < c || c8 % 8 || pad < 0 || tm < 8 ||
      mp % tm || mp < (h + 2 * pad) * (w + 2 * pad) || tin < 0 || tin > 1 ||
      tout < 0 || tout > 1 || (tin == 1 && tout != 1) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(in) & (tin == 1 ? 1 : 3)))
    return (int)cudaErrorInvalidValue;
  if (tout == 0) {
    int log_pairs = 0;
    while ((8 << log_pairs) < tm) ++log_pairs;
    // the offset table, the staged run and room for its 16-byte cover
    const size_t smem = (size_t)tm * sizeof(int) + ((size_t)tm * c + 8) * 4;
    if (tm > 128 || (8 << log_pairs) != tm || smem > SMEM_MAX ||
        smem_in != (int)smem)
      return (int)cudaErrorInvalidValue;
    pack_cf_kernel<<<dim3(mp / tm, batch), THREADS, smem, st>>>(
        static_cast<const float*>(in), static_cast<float*>(out), h, w, c, c8,
        pad, mp, tm, log_pairs);
    return (int)cudaGetLastError();
  }
  const long smem = bf16_smem(tm, c, tin == 1 ? 2 : 4);
  if (tm > 256 || tm % 16 || smem > SMEM_BLOCK || smem_in != smem)
    return (int)cudaErrorInvalidValue;
  if (tin == 0)
    return (int)launch_bf16<float>(in, out, batch, h, w, c, c8, pad, mp, tm,
                                   (int)smem, st);
  return (int)launch_bf16<nq_bf16>(in, out, batch, h, w, c, c8, pad, mp, tm,
                                   (int)smem, st);
}
