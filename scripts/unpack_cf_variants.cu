// Variants of the bf16 unpack_cf kernel (neuroquant_tpu_torch/csrc/
// unpack_cf.cu, unpack_cf_bf16_kernel), built and timed by
// scripts/torch_unpack_cf_variants.py: the measurements behind its design.
// Not part of the library. Modes of exp_unpack:
//   0   the kernel's design: one bulk copy per channel row, the transpose
//       read out of shared memory, lane i writing vector i
//   1   the same with a branch-free two-position index
//   2   loads, then constant stores (no transpose)
//   3   mode 1's transpose and stores with no loads (shared memory
//       unread)
//   4   the loads alone
//   5   cp.async 16-byte loads by every thread in place of TMA (mode 1's
//       transpose)
//   12, 13, 14   the positions in 2, 3, 4 stages of TMA copies, each on its
//       own mbarrier, a stage's stores under the later stages' loads
//   22, 23, 24   the same on cp.async commit groups
//   30, 31   the index stepped without a division, one or two vectors a
//       lane (256 threads); 32, 33 the same at 512 threads; 34 two
//       vectors a lane at 128 threads
//   40  the run staged in shared memory, stored by one TMA bulk store
//   50  a plain contiguous copy of the same bytes (tq = blocks)
#include <cuda_runtime.h>
#include <stdint.h>
#include "nq_common.cuh"
#include "nq_tma.cuh"

namespace {
constexpr int THREADS = 256;
__host__ __device__ __forceinline__ int bf16_pitch(int tq, int w, int pad) {
  return 2 * ((tq + 2 * pad * ((tq - 1) / w + 1) + 14) & ~7);
}
__host__ __device__ __forceinline__ int rows_offset(int tq) {
  return (16 + 4 * (tq + 1) + 127) / 128 * 128;
}
__host__ __device__ __forceinline__ int row_of(int r, int pitch) {
  return r * pitch + 16 * (r >> 3);
}
__host__ __device__ __forceinline__ int smem_of(int tq, int w, int pad, int c) {
  return rows_offset(tq) + row_of(c, bf16_pitch(tq, w, pad));
}

template <typename TO, int MODE>
__global__ void __launch_bounds__(THREADS)
kern(const nq_bf16* __restrict__ in, TO* __restrict__ out, int h, int w,
     int c, int c8, int pad, int mp, int tq) {
  constexpr int VO = 16 / sizeof(TO);
  extern __shared__ __align__(128) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem + 16);
  const unsigned char* rows = smem + rows_offset(tq);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int pitch = bf16_pitch(tq, w, pad);
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  const nq_bf16* first = in + (size_t)b * c8 * mp + m_lo;
  const int shift = (int)((reinterpret_cast<uintptr_t>(first) >> 1) & 7);
  const uint32_t bytes = (uint32_t)(((m_hi - m_lo + shift) * 2 + 15) & ~15);
  const uint32_t rows_sh = (uint32_t)__cvta_generic_to_shared(rows);
  if (MODE == 5) {
    // cp.async 16-byte loads by all threads: (channel, chunk) items
    const int nch = bytes / 16;
    const int items = nch * c;
    for (int i = threadIdx.x; i < items; i += THREADS) {
      const int ch = i / nch, k = i - ch * nch;
      const uint32_t dst = rows_sh + row_of(ch, pitch) + 16 * k;
      const void* src = first - shift + (size_t)ch * mp + 8 * k;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  } else if (MODE != 3) {
    if (threadIdx.x == 0) {
      nq_mbar_init(bar, 1);
      nq_fence_mbar_init();
      nq_mbar_expect_tx(bar, bytes * (uint32_t)c);
    }
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += THREADS)
      nq_bulk_load(rows_sh + row_of(ch, pitch), first - shift + (size_t)ch * mp, bytes, bar);
  }
  for (int t = threadIdx.x; t < q1 - q0; t += THREADS) {
    const int q = q0 + t, y = q / w;
    tbl[t] = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo + shift);
  }
  if (MODE == 5) asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  if (MODE != 3 && MODE != 5) nq_mbar_wait(bar, 0);
  auto at = [&](int ch, int col) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(rows + row_of(ch, pitch) + col);
  };
  const int n = (q1 - q0) * c;
  TO* o = out + ((size_t)b * hw + q0) * c;
  const int a = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) & (VO - 1));
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  if (threadIdx.x < hd + tl) {
    const int e = threadIdx.x < hd ? threadIdx.x : hd + VO * nb + threadIdx.x - hd;
    const int p = e / c;
    uint32_t x = at(e - p * c, tbl[p]);
    if (sizeof(TO) == 4) reinterpret_cast<uint32_t*>(o)[e] = x << 16;
    else reinterpret_cast<uint16_t*>(o)[e] = (uint16_t)x;
  }
  uint4* o4 = reinterpret_cast<uint4*>(o + hd);
  if (MODE == 4) {
    if (threadIdx.x == 0 && nb > 0) o4[0] = make_uint4(at(0, tbl[0]), 0, 0, 0);
    return;
  }
  for (int v = threadIdx.x; v < nb; v += THREADS) {
    const int e = hd + VO * v;
    uint32_t word[4];
    if (MODE == 2) {
      word[0] = word[1] = word[2] = word[3] = (uint32_t)v;
    } else if (MODE == 0) {
      int p = e / c, ch = e - p * c, col = tbl[p];
#pragma unroll
      for (int k = 0; k < VO; ++k) {
        const uint32_t x = at(ch, col);
        if (sizeof(TO) == 4) word[k] = x << 16;
        else if (k & 1) word[k >> 1] |= x << 16;
        else word[k >> 1] = x;
        if (++ch == c) { ch = 0; col = tbl[++p]; }
      }
    } else {
      // the vector spans positions p and p + 1 (c >= VO) or more
      const int p = e / c, ch0 = e - p * c;
      if (c >= VO) {
        const int s = c - ch0;               // elements at p
        const int col0 = tbl[p], col1 = tbl[p + 1];
        const int r0 = row_of(ch0, pitch) + col0;
#pragma unroll
        for (int k = 0; k < VO; ++k) {
          const int off = k < s ? r0 + k * pitch + 16 * (((ch0 + k) >> 3) - (ch0 >> 3))
                                : row_of(k - s, pitch) + col1;
          const uint32_t x = *reinterpret_cast<const uint16_t*>(rows + off);
          if (sizeof(TO) == 4) word[k] = x << 16;
          else if (k & 1) word[k >> 1] |= x << 16;
          else word[k >> 1] = x;
        }
      } else {
        int pp = p, ch = ch0, col = tbl[p];
#pragma unroll
        for (int k = 0; k < VO; ++k) {
          const uint32_t x = at(ch, col);
          if (sizeof(TO) == 4) word[k] = x << 16;
          else if (k & 1) word[k >> 1] |= x << 16;
          else word[k >> 1] = x;
          if (++ch == c) { ch = 0; col = tbl[++pp]; }
        }
      }
    }
    o4[v] = make_uint4(word[0], word[1], word[2], word[3]);
  }
}

template <typename TO, int MODE>
int go(const void* in, void* out, int batch, int h, int w, int c, int c8,
       int pad, int mp, int tq, cudaStream_t st) {
  auto k = kern<TO, MODE>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  const int smem = smem_of(tq, w, pad, c);
  k<<<dim3((h * w + tq - 1) / tq, batch), THREADS, smem, st>>>(
      (const nq_bf16*)in, (TO*)out, h, w, c, c8, pad, mp, tq);
  return (int)cudaGetLastError();
}

// S stages of the tile's positions: stage s's bytes of every row (16-byte
// pieces of the cover) land on mbarrier s (TMA, LOADER 0) or commit group s
// (cp.async, LOADER 1); the vectors whose positions have all landed are
// transposed and stored while later stages are in flight.
template <typename TO, int S, int LOADER>
__global__ void __launch_bounds__(THREADS)
staged(const nq_bf16* __restrict__ in, TO* __restrict__ out, int h, int w,
       int c, int c8, int pad, int mp, int tq) {
  constexpr int VO = 16 / sizeof(TO);
  extern __shared__ __align__(128) unsigned char smem[];
  int* bnd = reinterpret_cast<int*>(smem + 8 * S);      // [S] ready positions
  int* tbl = reinterpret_cast<int*>(smem + 8 * S + 4 * S + 16 - ((8 * S + 4 * S) & 15));
  const unsigned char* rows = smem + ((8 * S + 4 * S + 16 + 4 * (tq + 1) + 127) / 128 * 128);
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(smem);
  const int pitch = bf16_pitch(tq, w, pad);
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  const nq_bf16* first = in + (size_t)b * c8 * mp + m_lo;
  const int shift = (int)((reinterpret_cast<uintptr_t>(first) >> 1) & 7);
  const int bytes = ((m_hi - m_lo + shift) * 2 + 15) & ~15;
  const int piece = ((bytes + S - 1) / S + 15) & ~15;
  const uint32_t rows_sh = (uint32_t)__cvta_generic_to_shared(rows);
  const int npos = q1 - q0;
  if (LOADER == 0) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) nq_mbar_init(bar0 + 8 * s, 1);
      nq_fence_mbar_init();
      for (int s = 0; s < S; ++s) {
        const int lo = min(s * piece, bytes), hi = min(lo + piece, bytes);
        if (hi > lo) nq_mbar_expect_tx(bar0 + 8 * s, (uint32_t)((hi - lo) * c));
        else nq_mbar_arrive(bar0 + 8 * s);
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < c * S; i += THREADS) {
      const int s = i / c, ch = i - s * c;       // stage-major: stage 0 first
      const int lo = min(s * piece, bytes), hi = min(lo + piece, bytes);
      if (hi > lo)
        nq_bulk_load(rows_sh + row_of(ch, pitch) + lo,
                     reinterpret_cast<const char*>(first - shift + (size_t)ch * mp) + lo,
                     hi - lo, bar0 + 8 * s);
    }
  } else {
    const int nch = bytes / 16;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int lo = min(s * piece, bytes) / 16, hi = min(s * piece + piece, bytes) / 16;
      const int items = (hi - lo) * c;
      for (int i = threadIdx.x; i < items; i += THREADS) {
        const int ch = i / (hi - lo), k = lo + i - ch * (hi - lo);
        const uint32_t dst = rows_sh + row_of(ch, pitch) + 16 * k;
        const void* src = reinterpret_cast<const char*>(first - shift + (size_t)ch * mp) + 16 * k;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
      }
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
    (void)nch;
  }
  // the table, and each stage's count of positions whose element has landed
  for (int t = threadIdx.x; t < npos; t += THREADS) {
    const int q = q0 + t, y = q / w;
    const int col = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo + shift);
    tbl[t] = col;
    int nxt = 1 << 30;
    if (t + 1 < npos) {
      const int q2 = q + 1, y2 = q2 / w;
      nxt = 2 * ((y2 + pad) * wp + pad + (q2 - y2 * w) - m_lo + shift);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int end = min(s * piece + piece, bytes);
      if (col < end && nxt >= end) bnd[s] = t + 1;
      if (t == 0 && col >= end) bnd[s] = 0;
    }
  }
  __syncthreads();
  const int n = npos * c;
  TO* o = out + ((size_t)b * hw + q0) * c;
  const int a = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) & (VO - 1));
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  uint4* o4 = reinterpret_cast<uint4*>(o + hd);
  auto at = [&](int ch, int col) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(rows + row_of(ch, pitch) + col);
  };
  int v0 = 0;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (LOADER == 0) {
      nq_mbar_wait(bar0 + 8 * s, 0);
    } else {
      if (s == 0) asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
      if (s == 1) asm volatile("cp.async.wait_group %0;" ::"n"(S > 2 ? S - 2 : 0) : "memory");
      if (s == 2) asm volatile("cp.async.wait_group %0;" ::"n"(S > 3 ? S - 3 : 0) : "memory");
      if (s >= 3) asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
    }
    const int ready = s == S - 1 ? n : bnd[s] * c;
    const int v1 = s == S - 1 ? nb : max(v0, min(nb, (ready - hd) / VO));
    for (int v = v0 + threadIdx.x; v < v1; v += THREADS) {
      const int e = hd + VO * v;
      int p = e / c, ch = e - p * c, col = tbl[p];
      uint32_t word[4];
#pragma unroll
      for (int k = 0; k < VO; ++k) {
        const uint32_t x = at(ch, col);
        if (sizeof(TO) == 4) word[k] = x << 16;
        else if (k & 1) word[k >> 1] |= x << 16;
        else word[k >> 1] = x;
        if (++ch == c) { ch = 0; col = tbl[++p]; }
      }
      o4[v] = make_uint4(word[0], word[1], word[2], word[3]);
    }
    v0 = v1;
  }
  if (threadIdx.x < hd + tl) {
    const int e = threadIdx.x < hd ? threadIdx.x : hd + VO * nb + threadIdx.x - hd;
    const int p = e / c;
    uint32_t x = at(e - p * c, tbl[p]);
    if (sizeof(TO) == 4) reinterpret_cast<uint32_t*>(o)[e] = x << 16;
    else reinterpret_cast<uint16_t*>(o)[e] = (uint16_t)x;
  }
}

__host__ __device__ __forceinline__ int staged_smem(int tq, int w, int pad, int c, int S) {
  return (8 * S + 4 * S + 16 + 4 * (tq + 1) + 127) / 128 * 128 + row_of(c, bf16_pitch(tq, w, pad));
}

template <typename TO, int S, int L>
int go_staged(const void* in, void* out, int batch, int h, int w, int c, int c8,
              int pad, int mp, int tq, cudaStream_t st) {
  auto k = staged<TO, S, L>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  const int smem = staged_smem(tq, w, pad, c, S);
  k<<<dim3((h * w + tq - 1) / tq, batch), THREADS, smem, st>>>(
      (const nq_bf16*)in, (TO*)out, h, w, c, c8, pad, mp, tq);
  return (int)cudaGetLastError();
}

// incremental indexing: no division per vector, the row offset stepped per
// element; two vectors a lane at a time
template <typename TO, int NT, int ILP>
__global__ void __launch_bounds__(NT)
incr(const nq_bf16* __restrict__ in, TO* __restrict__ out, int h, int w,
     int c, int c8, int pad, int mp, int tq) {
  constexpr int VO = 16 / sizeof(TO);
  extern __shared__ __align__(128) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem + 16);
  const unsigned char* rows = smem + rows_offset(tq);
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int pitch = bf16_pitch(tq, w, pad);
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  const nq_bf16* first = in + (size_t)b * c8 * mp + m_lo;
  const int shift = (int)((reinterpret_cast<uintptr_t>(first) >> 1) & 7);
  const uint32_t bytes = (uint32_t)(((m_hi - m_lo + shift) * 2 + 15) & ~15);
  const uint32_t rows_sh = (uint32_t)__cvta_generic_to_shared(rows);
  if (threadIdx.x == 0) {
    nq_mbar_init(bar, 1);
    nq_fence_mbar_init();
    nq_mbar_expect_tx(bar, bytes * (uint32_t)c);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += NT)
    nq_bulk_load(rows_sh + row_of(ch, pitch), first - shift + (size_t)ch * mp, bytes, bar);
  for (int t = threadIdx.x; t < q1 - q0; t += NT) {
    const int q = q0 + t, y = q / w;
    tbl[t] = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo + shift);
  }
  __syncthreads();
  nq_mbar_wait(bar, 0);
  const int n = (q1 - q0) * c;
  TO* o = out + ((size_t)b * hw + q0) * c;
  const int a = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) & (VO - 1));
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  if (threadIdx.x < hd + tl) {
    const int e = threadIdx.x < hd ? threadIdx.x : hd + VO * nb + threadIdx.x - hd;
    const int p = e / c, ch = e - p * c;
    uint32_t x = *reinterpret_cast<const uint16_t*>(rows + row_of(ch, pitch) + tbl[p]);
    if (sizeof(TO) == 4) reinterpret_cast<uint32_t*>(o)[e] = x << 16;
    else reinterpret_cast<uint16_t*>(o)[e] = (uint16_t)x;
  }
  uint4* o4 = reinterpret_cast<uint4*>(o + hd);
  auto vec = [&](int p, int ch) -> uint4 {
    int off = row_of(ch, pitch) + tbl[p];
    uint32_t word[4];
#pragma unroll
    for (int k = 0; k < VO; ++k) {
      const uint32_t x = *reinterpret_cast<const uint16_t*>(rows + off);
      if (sizeof(TO) == 4) word[k] = x << 16;
      else if (k & 1) word[k >> 1] |= x << 16;
      else word[k >> 1] = x;
      if (k + 1 < VO) {
        if (++ch == c) { ch = 0; off = tbl[++p]; }
        else off += pitch + ((ch & 7) ? 0 : 16);
      }
    }
    return make_uint4(word[0], word[1], word[2], word[3]);
  };
  // a lane's vectors v, v + NT, ...: (p, ch) of the first element stepped
  const int se = VO * NT, dp = se / c, dch = se - dp * c;
  int e0 = hd + VO * (int)threadIdx.x;
  int p = e0 / c, ch = e0 - p * c;
  auto step = [&](int& pp, int& cc) { pp += dp; cc += dch; if (cc >= c) { cc -= c; ++pp; } };
  int v = threadIdx.x;
  if (ILP == 2) {
    for (; v + NT < nb; v += 2 * NT) {
      int p2 = p, ch2 = ch;
      step(p2, ch2);
      const uint4 a0 = vec(p, ch), a1 = vec(p2, ch2);
      o4[v] = a0;
      o4[v + NT] = a1;
      p = p2; ch = ch2;
      step(p, ch);
    }
  }
  for (; v < nb; v += NT) {
    o4[v] = vec(p, ch);
    step(p, ch);
  }
}

template <typename TO, int NT, int ILP>
int go_incr(const void* in, void* out, int batch, int h, int w, int c, int c8,
            int pad, int mp, int tq, cudaStream_t st) {
  auto k = incr<TO, NT, ILP>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  const int smem = smem_of(tq, w, pad, c);
  k<<<dim3((h * w + tq - 1) / tq, batch), NT, smem, st>>>(
      (const nq_bf16*)in, (TO*)out, h, w, c, c8, pad, mp, tq);
  return (int)cudaGetLastError();
}

// the floor: a contiguous copy of the same bytes (in -> out as 16-byte
// vectors), grid-stride
__global__ void copy_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, size_t n) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n; i += (size_t)gridDim.x * blockDim.x)
    out[i] = in[i];
}

// bulk-store variant: the transposed run staged in shared memory, stored by
// one TMA bulk copy (its 16-byte-aligned body)
template <typename TO>
__global__ void __launch_bounds__(THREADS)
bstore(const nq_bf16* __restrict__ in, TO* __restrict__ out, int h, int w,
       int c, int c8, int pad, int mp, int tq) {
  constexpr int VO = 16 / sizeof(TO);
  extern __shared__ __align__(128) unsigned char smem[];
  int* tbl = reinterpret_cast<int*>(smem + 16);
  const int pitch = bf16_pitch(tq, w, pad);
  const unsigned char* rows = smem + rows_offset(tq);
  uint4* run = reinterpret_cast<uint4*>(smem + rows_offset(tq) + ((row_of(c, pitch) + 127) & ~127));
  const uint32_t bar = (uint32_t)__cvta_generic_to_shared(smem);
  const int b = blockIdx.y, hw = h * w, wp = w + 2 * pad;
  const int q0 = blockIdx.x * tq, q1 = min(q0 + tq, hw);
  const int y0 = q0 / w, yl = (q1 - 1) / w;
  const int m_lo = (y0 + pad) * wp + pad + (q0 - y0 * w);
  const int m_hi = (yl + pad) * wp + pad + (q1 - 1 - yl * w) + 1;
  const nq_bf16* first = in + (size_t)b * c8 * mp + m_lo;
  const int shift = (int)((reinterpret_cast<uintptr_t>(first) >> 1) & 7);
  const uint32_t bytes = (uint32_t)(((m_hi - m_lo + shift) * 2 + 15) & ~15);
  const uint32_t rows_sh = (uint32_t)__cvta_generic_to_shared(rows);
  if (threadIdx.x == 0) {
    nq_mbar_init(bar, 1);
    nq_fence_mbar_init();
    nq_mbar_expect_tx(bar, bytes * (uint32_t)c);
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += THREADS)
    nq_bulk_load(rows_sh + row_of(ch, pitch), first - shift + (size_t)ch * mp, bytes, bar);
  for (int t = threadIdx.x; t < q1 - q0; t += THREADS) {
    const int q = q0 + t, y = q / w;
    tbl[t] = 2 * ((y + pad) * wp + pad + (q - y * w) - m_lo + shift);
  }
  __syncthreads();
  nq_mbar_wait(bar, 0);
  const int n = (q1 - q0) * c;
  TO* o = out + ((size_t)b * hw + q0) * c;
  const int a = (int)((reinterpret_cast<uintptr_t>(o) / sizeof(TO)) & (VO - 1));
  const int hd = min((VO - a) & (VO - 1), n);
  const int nb = (n - hd) / VO;
  const int tl = n - hd - VO * nb;
  auto at = [&](int ch, int col) -> uint32_t {
    return *reinterpret_cast<const uint16_t*>(rows + row_of(ch, pitch) + col);
  };
  if (threadIdx.x < hd + tl) {
    const int e = threadIdx.x < hd ? threadIdx.x : hd + VO * nb + threadIdx.x - hd;
    const int p = e / c;
    uint32_t x = at(e - p * c, tbl[p]);
    if (sizeof(TO) == 4) reinterpret_cast<uint32_t*>(o)[e] = x << 16;
    else reinterpret_cast<uint16_t*>(o)[e] = (uint16_t)x;
  }
  for (int v = threadIdx.x; v < nb; v += THREADS) {
    const int e = hd + VO * v;
    int p = e / c, ch = e - p * c, col = tbl[p];
    uint32_t word[4];
#pragma unroll
    for (int k = 0; k < VO; ++k) {
      const uint32_t x = at(ch, col);
      if (sizeof(TO) == 4) word[k] = x << 16;
      else if (k & 1) word[k >> 1] |= x << 16;
      else word[k >> 1] = x;
      if (++ch == c) { ch = 0; col = tbl[++p]; }
    }
    run[v] = make_uint4(word[0], word[1], word[2], word[3]);
  }
  nq_fence_proxy_async();
  __syncthreads();
  if (threadIdx.x == 0 && nb > 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(o + hd),
                 "r"((uint32_t)__cvta_generic_to_shared(run)), "r"((uint32_t)(16 * nb)) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

template <typename TO>
int go_bstore(const void* in, void* out, int batch, int h, int w, int c, int c8,
              int pad, int mp, int tq, cudaStream_t st) {
  auto k = bstore<TO>;
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  const int pitch = bf16_pitch(tq, w, pad);
  const int smem = rows_offset(tq) + ((row_of(c, pitch) + 127) & ~127) + tq * c * (int)sizeof(TO) + 16;
  k<<<dim3((h * w + tq - 1) / tq, batch), THREADS, smem, st>>>(
      (const nq_bf16*)in, (TO*)out, h, w, c, c8, pad, mp, tq);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int exp_unpack(int mode, int tout, const void* in, void* out,
                          int batch, int h, int w, int c, int c8, int pad,
                          int mp, int tq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(M) case M: return tout ? go<nq_bf16, M>(in, out, batch, h, w, c, c8, pad, mp, tq, st) \
                                     : go<float, M>(in, out, batch, h, w, c, c8, pad, mp, tq, st);
  switch (mode) { CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) }
#define SCASE(M, S, L) case M: return tout ? go_staged<nq_bf16, S, L>(in, out, batch, h, w, c, c8, pad, mp, tq, st) \
                                   : go_staged<float, S, L>(in, out, batch, h, w, c, c8, pad, mp, tq, st);
#define ICASE(M, NT, ILP) case M: return tout ? go_incr<nq_bf16, NT, ILP>(in, out, batch, h, w, c, c8, pad, mp, tq, st) \
                                   : go_incr<float, NT, ILP>(in, out, batch, h, w, c, c8, pad, mp, tq, st);
  if (mode == 40) return tout ? go_bstore<nq_bf16>(in, out, batch, h, w, c, c8, pad, mp, tq, st)
                              : go_bstore<float>(in, out, batch, h, w, c, c8, pad, mp, tq, st);
  if (mode == 50) {   // the floor: tq = blocks
    const size_t n = (size_t)batch * h * w * c * (tout ? 2 : 4) / 16;
    copy_kernel<<<tq, 256, 0, st>>>((const uint4*)in, (uint4*)out, n);
    return (int)cudaGetLastError();
  }
  switch (mode) { ICASE(30, 256, 1) ICASE(31, 256, 2) ICASE(32, 512, 1) ICASE(33, 512, 2) ICASE(34, 128, 2) }
  switch (mode) { SCASE(12, 2, 0) SCASE(14, 4, 0) SCASE(22, 2, 1) SCASE(24, 4, 1) SCASE(23, 3, 1) SCASE(13, 3, 0) }
  return -1;
}
