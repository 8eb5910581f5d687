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
// That kernel (unpack_cf_kernel) runs fp32 -> fp32. The bf16 tail's
// cotangent (bf16 -> fp32 where pack_cf's input was fp32, bf16 -> bf16)
// takes unpack_cf_bf16_kernel, designed for 2-byte inputs
// (tail_fused.unpack_cf_bf16_geometry picks the tile):
// - a block owns tq interior positions of one image x all c channels, one
//   tile a block: the launch's positions in 4 equal tiles per SM, all
//   resident at once, so that no SM ends a wave after the others (a
//   power-of-two tile left 4 blocks on some SMs and 3 on the rest);
// - each channel's stretch (its 16-byte cover) arrives in shared memory by
//   one TMA bulk copy, all c of them under one mbarrier, while the threads
//   compute the table of each position's byte offset in a staged row;
// - the transpose is read out of shared memory: lane i writes 16-byte
//   vector i of the block's NHWC output run (8 bf16 or 4 fp32: channels of
//   one position, or of two where c is no multiple of the vector), reading
//   its elements down the staged channel rows. Row r starts at r * pitch
//   plus 16 bytes for each 8 rows before it, so the rows 8 apart that a
//   warp's lanes read at one position fall in different banks;
// - scalar stores for at most 7 elements at either end of a run whose
//   start is not 16-byte aligned.
// A copy starts and ends on 16 bytes: for an input not 16-byte aligned the
// first and last copies read into the 16-byte granules around the tensor.
// Its bound is bytes too (the Bunny-3M tail entry to bf16 at batch 2:
// 21.7 MB, 6.5 us at 3.35 TB/s). On an NVIDIA H100 80GB HBM3 at 700 W it
// took 0.0080 ms hot and 0.0125 cold there, the kernel it replaced 0.0114
// / 0.0141, a plain contiguous copy of the same bytes 0.0053 / 0.0108: a
// block's loads and its stores do not overlap, and staging the positions
// in two to four waves of copies did not change that
// (scripts/torch_layout_bench.py --dtype bf16; PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

#include "nq_common.cuh"
#include "nq_tma.cuh"

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

// ---- bf16 inputs -----------------------------------------------------------

constexpr int SMEM_BLOCK = 232448;    // a block's shared memory, at most

// Staged row length in bytes: a tile's stretch of a padded row (tq
// positions and the 2*pad border columns of every row crossing), its
// cover's offset (< 8 elements) and rounding to 16 bytes.
// tail_fused._unpack_cf_bf16_pitch mirrors it.
__host__ __device__ __forceinline__ int bf16_pitch(int tq, int w, int pad) {
  return 2 * ((tq + 2 * pad * ((tq - 1) / w + 1) + 14) & ~7);
}

// Shared memory of the bf16 kernel: its mbarrier, the position table (tq + 1
// ints) from byte 16, the staged rows from a 128-byte boundary: row r at
// r * pitch + 16 * (r >> 3). tail_fused._unpack_cf_bf16_smem mirrors it.
__host__ __device__ __forceinline__ int bf16_rows_offset(int tq) {
  return (16 + 4 * (tq + 1) + 127) / 128 * 128;
}
__host__ __device__ __forceinline__ int bf16_row(int r, int pitch) {
  return r * pitch + 16 * (r >> 3);
}
__host__ __device__ __forceinline__ int bf16_smem(int tq, int w, int pad,
                                                  int c) {
  return bf16_rows_offset(tq) + bf16_row(c, bf16_pitch(tq, w, pad));
}

template <typename TO>
__device__ __forceinline__ TO bf16_as(uint16_t v);
template <>
__device__ __forceinline__ float bf16_as<float>(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
template <>
__device__ __forceinline__ nq_bf16 bf16_as<nq_bf16>(uint16_t v) {
  return __ushort_as_bfloat16(v);
}

template <typename TO>
__global__ void __launch_bounds__(THREADS)
unpack_cf_bf16_kernel(const nq_bf16* __restrict__ in, TO* __restrict__ out,
                      int h, int w, int c, int c8, int pad, int mp, int tq) {
  constexpr int VO = 16 / sizeof(TO);                    // outputs a vector
  extern __shared__ __align__(128) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem + 16);          // [tq+1] byte cols
  const unsigned char* rows = smem + bf16_rows_offset(tq);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int pitch = bf16_pitch(tq, w, pad);
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  // every channel row's stretch lies at the same offset from a 16-byte
  // boundary (Mp is a multiple of 8): one shift, one copy size
  const nq_bf16* first = in + (size_t)b * c8 * mp + m_lo;
  const int shift = (int)((reinterpret_cast<uintptr_t>(first) >> 1) & 7);
  const uint32_t bytes = (uint32_t)(((m_hi - m_lo + shift) * 2 + 15) & ~15);
  if (threadIdx.x == 0) {
    nq_mbar_init(bar, 1);
    nq_fence_mbar_init();
    nq_mbar_expect_tx(bar, bytes * (uint32_t)c);
  }
  __syncthreads();                 // the mbarrier's init, before any copy
  const uint32_t rows_sh = (uint32_t)__cvta_generic_to_shared(rows);
  for (int ch = threadIdx.x; ch < c; ch += THREADS)
    nq_bulk_load(rows_sh + bf16_row(ch, pitch),
                 first - shift + (size_t)ch * mp, bytes, bar);
  // while they are in flight: each position's byte offset in a staged row
  for (int t = threadIdx.x; t < q1 - q0; t += THREADS) {
    const int q = q0 + t, y = q / w;
    tbl[t] = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo + shift);
  }
  __syncthreads();                 // the table
  nq_mbar_wait(bar, 0);

  auto at = [&](int ch, int col) -> uint16_t {
    return *reinterpret_cast<const uint16_t*>(rows + bf16_row(ch, pitch) +
                                              col);
  };
  const int n = (q1 - q0) * c;        // elements of the run
  TO* o = out + ((size_t)b * hw + q0) * c;
  const int a = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) &
                      (VO - 1));
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  if (threadIdx.x < hd + tl) {         // the run's unaligned ends
    const int e = threadIdx.x < hd ? threadIdx.x
                                   : hd + VO * nb + threadIdx.x - hd;
    const int p = e / c;
    o[e] = bf16_as<TO>(at(e - p * c, tbl[p]));
  }
  uint4* o4 = reinterpret_cast<uint4*>(o + hd);
  for (int v = threadIdx.x; v < nb; v += THREADS) {
    const int e = hd + VO * v;
    int p = e / c, ch = e - p * c, col = tbl[p];
    uint32_t word[4];
#pragma unroll
    for (int k = 0; k < VO; ++k) {
      const uint16_t x = at(ch, col);
      if (sizeof(TO) == 4) {
        word[k] = (uint32_t)x << 16;
      } else if (k & 1) {
        word[k >> 1] |= (uint32_t)x << 16;
      } else {
        word[k >> 1] = x;
      }
      if (++ch == c) {              // the next position (tbl has tq + 1)
        ch = 0;
        col = tbl[++p];
      }
    }
    o4[v] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <typename TO>
cudaError_t launch_bf16(const void* in, void* out, int batch, int h, int w,
                        int c, int c8, int pad, int mp, int tq, int smem,
                        cudaStream_t st) {
  auto kernel = unpack_cf_bf16_kernel<TO>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BLOCK);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<dim3((h * w + tq - 1) / tq, batch), THREADS, smem, st>>>(
      static_cast<const nq_bf16*>(in), static_cast<TO*>(out), h, w, c, c8,
      pad, mp, tq);
  return cudaGetLastError();
}

}  // namespace

// prm: batch, h, w, c, c8, pad, mp, tq (see tail_fused.unpack_cf_geometry
// and unpack_cf_bf16_geometry), then the input's and the output's type: 0
// fp32, 1 bf16 (fp32 -> fp32, bf16 -> fp32, bf16 -> bf16); from bf16, an
// 11th: the kernel's shared-memory bytes a block
extern "C" int nq_unpack_cf(const void* in, void* out, const int* prm,
                            void* stream) {
  if (prm == nullptr || prm[0] < 1) return (int)cudaErrorInvalidValue;
  const int batch = prm[0], h = prm[1], w = prm[2], c = prm[3], c8 = prm[4],
            pad = prm[5], mp = prm[6], tq = prm[7], tin = prm[8],
            tout = prm[9];
  const int isz = tin == 1 ? 2 : 4;
  if (h < 1 || w < 1 || c < 1 || c8 < c || pad < 0 || tq < 8 ||
      mp % (16 / isz) ||
      mp < (h + 2 * pad) * (w + 2 * pad) || tin < 0 || tin > 1 ||
      tout < 0 || tout > 1 || (tin == 0 && tout != 0) ||
      (reinterpret_cast<uintptr_t>(out) & 15) ||
      (reinterpret_cast<uintptr_t>(in) & (isz - 1)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tin == 1) {
    const long smem = bf16_smem(tq, w, pad, c);
    if (tq > 256 || tq % 8 || smem > SMEM_BLOCK || prm[10] != smem)
      return (int)cudaErrorInvalidValue;
    if (tout == 0)
      return (int)launch_bf16<float>(in, out, batch, h, w, c, c8, pad, mp,
                                     tq, (int)smem, st);
    return (int)launch_bf16<nq_bf16>(in, out, batch, h, w, c, c8, pad, mp, tq,
                                     (int)smem, st);
  }
  const size_t smem = (size_t)table_ints(tq, w, pad, 4) * sizeof(int) +
                      ((size_t)tq * c + 4) * 4;
  if (tq > 128 || (tq & (tq - 1)) || smem > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((h * w + tq - 1) / tq, batch);
  unpack_cf_kernel<float, float><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(in), static_cast<float*>(out), h, w, c, c8,
      pad, mp, tq);
  return (int)cudaGetLastError();
}
