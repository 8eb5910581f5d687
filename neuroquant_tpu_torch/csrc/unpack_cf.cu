// unpack_cf: channels-first flat layout -> NHWC, the backward of pack_cf.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:666
// `_unpack_cf_kernel` (defined beside `_pack_cf_kernel`; the JAX package
// takes an XLA transpose for `pack_cf`'s backward, :736-745):
//
//   out[b, y, x, ch] = in[b, ch, (y+pad)*wp + (x+pad)]   (ch < c)
//
// in is (B, c8, Mp) fp32, out (B, h, w, c) contiguous: only the interior is
// read, the border ring, the channel pad and the flat tail pad are dropped.
//
// Bound on the H100: bytes. A transpose with no arithmetic: at HNeRV
// Bunny-3M, batch 2, the tail entry moves 43.6 MB (13 us at 3.35 TB/s); the
// prefix entry's 3.3 MB is bound by launch latency.
//
// Design for that bound: the mirror of pack_cf.cu.
// - A block owns tq consecutive interior positions of one image (a power of
//   two, 8..128; tail_fused.unpack_cf_geometry picks it) x all c channels:
//   one contiguous run of the NHWC output.
// - For every channel, those positions lie in one stretch of the channel's
//   padded flat row (contiguous within each image row, the 2*pad border
//   columns between rows included). The block reads each stretch as 16-byte
//   loads of its cover, aligned to 32 bytes (16 where that would start
//   before the tensor; the offset `shift` is the same for every channel),
//   8 loads in flight per thread. Two lanes read the two halves of one
//   32-byte sector, consecutive lane pairs consecutive channels, so a
//   warp's load uses every byte of the 16 sectors it touches.
// - Each loaded value goes straight to its place in the output run, staged
//   in shared memory in NHWC order: a table of one int per cover element,
//   computed once per block while the first loads are in flight (a row and
//   column per position, not per element), gives that place, or -1 for a
//   border element. A warp's 32 stores hit 16 channels at two positions
//   4 apart: at most 2-way bank conflicts.
// - The run is written back as aligned 16-byte stores (scalar stores for
//   at most 3 floats at either end where the run is not 16-byte aligned),
//   so every 32-byte sector of the output is written whole.
//
// Instantiated for fp32 -> fp32, and for the bf16 tail's cotangent
// (bf16 -> fp32 where pack_cf's input was fp32, bf16 -> bf16): the same
// kernel on the input's element size (a 16-byte load is 8 bf16, the cover
// aligned to 32 bytes), each value converted as it is placed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nq_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int LOADS_IN_FLIGHT = 8;    // loads a thread issues before it waits
constexpr int SMEM_MAX = 48 * 1024;   // without an opt-in attribute

// Ints of the cover table: tq positions span at most (tq-1)/w + 1 row
// crossings of 2*pad border columns each, plus the cover's offset (< 2*vec
// elements of a 16-byte load) and its rounding to whole loads; a multiple
// of 4 so that the run after it stays 16-byte aligned.
// tail_fused._unpack_cf_table mirrors it.
__host__ __device__ __forceinline__ int table_ints(int tq, int w, int pad,
                                                   int vec) {
  return (tq + 2 * pad * ((tq - 1) / w + 1) + 3 * vec + 3) & ~3;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS)
unpack_cf_kernel(const TI* __restrict__ in, TO* __restrict__ out, int h,
                 int w, int c, int c8, int pad, int mp, int tq) {
  constexpr int VI = 16 / sizeof(TI), VO = 16 / sizeof(TO);
  extern __shared__ uint4 smem4[];
  int* tbl = reinterpret_cast<int*>(smem4);                 // [cover] -> run
  TO* run = reinterpret_cast<TO*>(tbl + table_ints(tq, w, pad, VI));
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  const size_t first = (size_t)b * c8 * mp + m_lo;          // channel 0
  const TI* row0 = in + first;
  const int shift =
      (int)((reinterpret_cast<uintptr_t>(row0) / sizeof(TI)) &
            (first >= 2 * VI ? 2 * VI - 1 : VI - 1));
  const int nv = (m_hi - m_lo + shift + VI - 1) / VI;
  const size_t o0 = ((size_t)b * hw + q0) * c;
  const int a = (int)(o0 & (VO - 1));  // the run's offset in its 16 bytes

  // items: (channel, 16-byte load) pairs, a lane pair per channel and
  // sector; all LOADS_IN_FLIGHT loads of a thread are issued before any is
  // stored, so a block waits for one memory round trip, not one per load
  const uint4* cover = reinterpret_cast<const uint4*>(row0 - shift);
  const int items = 2 * c * ((nv + 1) >> 1);
  uint4 v[LOADS_IN_FLIGHT];
  int vv[LOADS_IN_FLIGHT], ch[LOADS_IN_FLIGHT];
  auto fetch = [&](int i0) {
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k) {
      const int i = i0 + k * THREADS, pr = i >> 1;
      vv[k] = 2 * (pr / c) + (i & 1);
      ch[k] = pr - (pr / c) * c;
      if (i < items && vv[k] < nv)
        v[k] = __ldg(cover + (size_t)ch[k] * (mp / VI) + vv[k]);
    }
  };
  auto place = [&](int i0) {
#pragma unroll
    for (int k = 0; k < LOADS_IN_FLIGHT; ++k) {
      if (i0 + k * THREADS >= items || vv[k] >= nv) continue;
      const int* t = tbl + VI * vv[k];
#pragma unroll
      for (int u = 0; u < VI; ++u)
        if (t[u] >= 0)
          run[t[u] + ch[k]] = nq_from_f32<TO>(nq_lane<TI>(v[k], u));
    }
  };

  fetch(threadIdx.x);
  // the table, while the first loads are in flight; every thread reaches
  // the barrier
  for (int j = threadIdx.x; j < VI * nv; j += THREADS) {
    const int m = m_lo - shift + j;
    int d = -1;
    if (m >= m_lo && m < m_hi) {
      const int r = m / wp, col = m - r * wp;
      if (col >= pad && col < pad + w)
        d = a + ((r - pad) * w + col - pad - q0) * c;
    }
    tbl[j] = d;
  }
  __syncthreads();
  place(threadIdx.x);
  for (int i0 = threadIdx.x + THREADS * LOADS_IN_FLIGHT; i0 < items;
       i0 += THREADS * LOADS_IN_FLIGHT) {
    fetch(i0);
    place(i0);
  }
  __syncthreads();

  const int n = (q1 - q0) * c;        // elements of the run
  TO* o = out + o0;
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  if (threadIdx.x < hd) o[threadIdx.x] = run[a + threadIdx.x];
  if (threadIdx.x < tl)
    o[hd + VO * nb + threadIdx.x] = run[a + hd + VO * nb + threadIdx.x];
  // a + hd is 0 or VO: the staged body is 16-byte aligned as the output's
  const uint4* r4 = reinterpret_cast<const uint4*>(run + a + hd);
  uint4* o4 = reinterpret_cast<uint4*>(o + hd);
  for (int i = threadIdx.x; i < nb; i += THREADS) o4[i] = r4[i];
}

}  // namespace

// prm: batch, h, w, c, c8, pad, mp, tq (see tail_fused.unpack_cf_geometry),
// then the input's and the output's type: 0 fp32, 1 bf16 (fp32 -> fp32,
// bf16 -> fp32, bf16 -> bf16)
extern "C" int nq_unpack_cf(const void* in, void* out, const int* prm,
                            void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], h = prm[1], w = prm[2], c = prm[3], c8 = prm[4],
            pad = prm[5], mp = prm[6], tq = prm[7], tin = prm[8],
            tout = prm[9];
  const int isz = tin == 1 ? 2 : 4, osz = tout == 1 ? 2 : 4;
  if (h < 1 || w < 1 || c < 1 || c8 < c || pad < 0 || tq < 8 || tq > 128 ||
      (tq & (tq - 1)) || mp % (16 / isz) ||
      mp < (h + 2 * pad) * (w + 2 * pad) || tin < 0 || tin > 1 ||
      tout < 0 || tout > 1 || (tin == 0 && tout != 0) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(in) & (isz - 1)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)table_ints(tq, w, pad, 16 / isz) * sizeof(int) +
                      ((size_t)tq * c + 16 / osz) * osz;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((h * w + tq - 1) / tq, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tin == 0)
    unpack_cf_kernel<float, float><<<grid, THREADS, smem, st>>>(
        static_cast<const float*>(in), static_cast<float*>(out), h, w, c, c8,
        pad, mp, tq);
  else if (tout == 0)
    unpack_cf_kernel<nq_bf16, float><<<grid, THREADS, smem, st>>>(
        static_cast<const nq_bf16*>(in), static_cast<float*>(out), h, w, c,
        c8, pad, mp, tq);
  else
    unpack_cf_kernel<nq_bf16, nq_bf16><<<grid, THREADS, smem, st>>>(
        static_cast<const nq_bf16*>(in), static_cast<nq_bf16*>(out), h, w, c,
        c8, pad, mp, tq);
  return (int)cudaGetLastError();
}
