// tail_conv_cf: one conv layer of the channels-first decoder tail.
//
// Replaces the TPU kernel neuroquant_tpu/ops/tail_fused.py:1133
// `_fwd_kernel` (launched by `_conv_cf_one`): the forward's `emit='z'|'y'|
// 'zy'` and `act_in` cases of `_tail_fwd_impl`, and the backward's dx pass
// with the `out_mul` epilogue (`_tail_apply_bwd`).
//
//   z[b, co, m] = mask[m] * (sum_k W[k, co] * a(x[b, chan(k), m + shift(k)])
//                            + bias[co]) * GELU'(out_mul[b, co, m])
//   out_z = z,  out_y = GELU(z)      (either or both)
//
// with a = GELU when act_in (else identity) and the GELU' factor only when
// out_mul is given (a template parameter: the decode's instantiation has
// none); GELU and GELU' by the Abramowitz & Stegun 7.1.26 erf of the JAX
// tail. x is (B, cin, Mp) fp32 channels-first flat with a zero border;
// positions outside [0, Mp) read zero. The K axis is a host-built list of
// steps of 4 rows, (flat shift, first channel, valid rows): the rows of a
// step read consecutive channels at one shift, the rows past `valid rows`
// read zero (their weight rows are zero too). The list covers the dense
// taps of an f=1 layer or the union of nonzero blocks of a layer packed
// with f >= 2, and pads to whole stages of 8 steps with empty steps. The dx
// pass runs on the transposed layer: the same function on another list.
//
// Bound on the H100: operations at every layer but the head (8.7 / 25.2 /
// 66.7 GFLOP per frame at HNeRV Bunny-3M; 0.13 / 0.38 / 1.0 ms at the
// 67 TFLOP/s of the fp32 pipes, a third of that on the tensor cores with
// three TF32 products per fp32 product at 495 TFLOP/s); the head by bytes
// (~136 MB, 0.04 ms at 3.35 TB/s).
//
// Design for that bound: an implicit GEMM out[cout, Mp] = W^T[cout, K] *
// X[K, Mp] whose X operand is gathered by shifts, on the tensor cores at
// fp32 accuracy (nq_mma.cuh: 3xTF32, mma.sync.m16n8k8).
//  * A block of 8 warps (2 x 4) owns 128, 96 or 64 output channels x 128
//    positions; a warp 64, 48 or 32 channels x 32 positions, as 16x8
//    fragments (cout 176 takes two tiles of 96, cout 48 and 56 one of 64).
//    A 16-channel fragment row wholly past cout is skipped; the warp grid
//    puts the two channel halves on the same SM sub-partitions, so the
//    skipped work is saved on each.
//  * K is walked in stages of 32 rows through a ring of 3 or 4 stages in
//    dynamic shared memory (92-106 KB, two blocks per SM). A stage is
//    brought in by 16-byte cp.async copies: m0 + shift has no alignment, so
//    an X row is copied from m0 + shift rounded down to a multiple of 4, 33
//    vectors for 128 positions, and the multiply reads it at column +
//    (shift & 3); zero-filled outside [0, Mp) and past a step's valid rows.
//    The weight slab is contiguous. The loads of stage k+2 (k+3) are in
//    flight while stage k is multiplied; one __syncthreads per stage.
//  * Row strides of 136 / 72 floats (= 8 mod 32) make every fragment load
//    hit 32 distinct banks.
//  * act_in: each thread applies GELU to the values it copied itself, once,
//    after its copies land and before the stage's barrier.
//  * Epilogue from the accumulator fragments: bias, GELU'(out_mul), the
//    border mask read once per thread from the (Mp) mask vector (no
//    division), GELU for out_y, 8-byte stores that fill 32-byte sectors;
//    'zy' writes both outputs from the one accumulator.
//  * A launch with too few tiles to fill the card (the prefix's dx pass:
//    64 tiles, K = 21,200) splits K across blocks; each split writes its raw
//    partial sums, and a second pass in the same launcher adds them in a
//    fixed order and applies the epilogue: no atomics, the same bits every
//    run.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "nq_common.cuh"
#include "nq_mma.cuh"

namespace {

constexpr int BN = 128;      // positions per block
constexpr int BK = 32;       // K rows per stage: 8 steps of 4 rows
constexpr int LDX = BN + 8;  // X stage row stride, floats
constexpr int THREADS = 256;
constexpr int WN = 4;        // 8-position fragments per warp (warp: 32)

template <int WM>            // 16-channel fragments per warp
struct Tile {
  static constexpr int BM = 32 * WM;        // output channels per block
  static constexpr int LDW = BM + 8;        // W stage row stride, floats
  static constexpr int STAGE = BK * LDX + BK * LDW;   // floats per stage
  static constexpr int STAGES = WM == 2 ? 4 : 3;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 4;
};

template <bool kOutMul>
__device__ __forceinline__ float conv_epilogue(float acc, float bias, float om,
                                               float mask) {
  float z = acc + bias;
  if (kOutMul) z *= nq_gelu_grad(om);
  return z * mask;
}

template <int WM, bool kOutMul>
__global__ void __launch_bounds__(THREADS, 2)
tail_conv_cf_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_mul,
                    const float* __restrict__ mask,
                    const int4* __restrict__ ksteps, float* __restrict__ out_z,
                    float* __restrict__ out_y, float* __restrict__ part,
                    int batch, int cin, int cout, int mp, int ktiles,
                    int splits, int act_in) {
  using T = Tile<WM>;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int m0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * T::BM;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z - b * splits;
  const int per = (ktiles + splits - 1) / splits;
  const int kt_begin = split * per;
  const int nkt = min(ktiles, kt_begin + per) - kt_begin;
  const float* xb = x + (size_t)b * cin * mp;

  // X staging: a row of a stage holds x[chan][a .. a + 132) with a = m0 +
  // shift rounded down to a multiple of 4, as 33 aligned 16-byte vectors;
  // the multiply reads it at column + (shift & 3)
  constexpr int XV = BN / 4 + 1;               // vectors per X row
  constexpr int XROUNDS = (BK * XV + THREADS - 1) / THREADS;

  auto load_stage = [&](int stage, int kt) {
    float* xs = smem + stage * T::STAGE;
    float* ws = xs + BK * LDX;
#pragma unroll
    for (int i = 0; i < XROUNDS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= BK * XV) break;
      const int row = idx / XV, v = idx - row * XV;
      const int4 st = __ldg(&ksteps[kt * (BK / 4) + (row >> 2)]);
      const int rr = row & 3;                  // shift, chan, rows
      const int pos = m0 + (st.x & ~3) + 4 * v;
      const bool valid = rr < st.z && pos >= 0 && pos + 4 <= mp;
      const float* src = valid ? xb + (size_t)(st.y + rr) * mp + pos : xb;
      nq_cp_async16(nq_smem_addr(xs + row * LDX + 4 * v), src, valid);
    }
    constexpr int VECS = T::BM / 4;            // 16-byte vectors per W row
#pragma unroll
    for (int i = 0; i < BK * VECS / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / VECS, v = idx - row * VECS;
      const int co = co0 + v * 4;
      const bool valid = co < cout;
      const float* src = valid ? w + (size_t)(kt * BK + row) * cout + co : w;
      nq_cp_async16(nq_smem_addr(ws + row * T::LDW + v * 4), src, valid);
    }
  };

  float acc[WM][WN][4];
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int j = 0; j < WN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  bool mt_ok[WM];   // fragment row has a channel below cout (warp-uniform)
#pragma unroll
  for (int i = 0; i < WM; ++i)
    mt_ok[i] = co0 + (warp_m * WM + i) * 16 < cout;

  // One stage multiplied into the accumulators. `all_rows_t` (a type):
  // every fragment row of this warp has channels, so the loop body has no
  // branch and the compiler overlaps one fragment's loads with another's
  // products (measured on an NVIDIA H100: 6-10% at the 96- and 128-channel
  // tiles, a loss at the 64-channel tile, which keeps the branch).
  auto multiply = [&](const float* xs, const float* ws, int offs,
                      auto all_rows_t) {
#pragma unroll
    for (int k0 = 0; k0 < BK; k0 += 8) {
      // rows k0 + t and k0 + t + 4 lie in two steps: their column offsets
      const int off0 = (offs >> (k0 >> 1)) & 3;
      const int off1 = (offs >> ((k0 >> 1) + 2)) & 3;
      uint32_t bb[WN][2], bs[WN][2];
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const float* p = xs + (k0 + t) * LDX + warp_n * (WN * 8) + j * 8 + g;
        nq_split_tf32(p[off0], bb[j][0], bs[j][0]);
        nq_split_tf32(p[4 * LDX + off1], bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int i = 0; i < WM; ++i) {
        if constexpr (!decltype(all_rows_t)::value) {
          if (!mt_ok[i]) continue;
        }
        const float* p = ws + (k0 + t) * T::LDW + (warp_m * WM + i) * 16 + g;
        uint32_t ab[4], as[4];
        nq_split_tf32(p[0], ab[0], as[0]);
        nq_split_tf32(p[8], ab[1], as[1]);
        nq_split_tf32(p[4 * T::LDW], ab[2], as[2]);
        nq_split_tf32(p[4 * T::LDW + 8], ab[3], as[3]);
#pragma unroll
        for (int j = 0; j < WN; ++j)
          nq_mma_3xtf32(acc[i][j], ab, as, bb[j], bs[j]);
      }
    }
  };
  const bool all_rows = WM > 2 && mt_ok[WM - 1];

#pragma unroll
  for (int s = 0; s < T::STAGES - 1; ++s) {
    if (s < nkt) load_stage(s, kt_begin + s);
    nq_cp_async_commit();
  }

  for (int it = 0; it < nkt; ++it) {
    const int stage = it % T::STAGES;
    // the stage's 8 column offsets (shift & 3), 2 bits each, fetched ahead
    // of the wait
    int offs = 0;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j)
      offs |= (__ldg(&ksteps[(kt_begin + it) * (BK / 4) + j].x) & 3)
              << (2 * j);
    nq_cp_async_wait<T::STAGES - 2>();
    float* xs = smem + stage * T::STAGE;
    const float* ws = xs + BK * LDX;
    if (act_in) {
      // this thread's own copies have landed: GELU them once, in place
#pragma unroll
      for (int i = 0; i < XROUNDS; ++i) {
        const int idx = tid + i * THREADS;
        if (idx >= BK * XV) break;
        const int row = idx / XV, v = idx - row * XV;
        float4* p = reinterpret_cast<float4*>(xs + row * LDX + 4 * v);
        float4 q = *p;
        q.x = nq_gelu(q.x);
        q.y = nq_gelu(q.y);
        q.z = nq_gelu(q.z);
        q.w = nq_gelu(q.w);
        *p = q;
      }
    }
    __syncthreads();
    // the stage multiplied in the previous turn is free: refill it
    if (it + T::STAGES - 1 < nkt)
      load_stage((it + T::STAGES - 1) % T::STAGES,
                 kt_begin + it + T::STAGES - 1);
    nq_cp_async_commit();

    if (all_rows)
      multiply(xs, ws, offs, std::true_type{});
    else
      multiply(xs, ws, offs, std::false_type{});
  }

  // epilogue: thread owns rows g, g + 8 of each fragment row and columns
  // 2t, 2t + 1 of each fragment column
  const int mcol = m0 + warp_n * (WN * 8) + 2 * t;
  if (splits > 1) {
    float* pb = part + ((size_t)split * batch + b) * cout * mp;
#pragma unroll
    for (int i = 0; i < WM; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int co = co0 + (warp_m * WM + i) * 16 + g + 8 * hh;
        if (co >= cout) continue;
#pragma unroll
        for (int j = 0; j < WN; ++j)
          *reinterpret_cast<float2*>(pb + (size_t)co * mp + mcol + j * 8) =
              make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
      }
    return;
  }

  float2 mk[WN];
#pragma unroll
  for (int j = 0; j < WN; ++j)
    mk[j] = *reinterpret_cast<const float2*>(mask + mcol + j * 8);
#pragma unroll
  for (int i = 0; i < WM; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int co = co0 + (warp_m * WM + i) * 16 + g + 8 * hh;
      if (co >= cout) continue;
      const float bv = bias != nullptr ? bias[co] : 0.f;
      const size_t row = ((size_t)b * cout + co) * mp;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const size_t o = row + mcol + j * 8;
        float2 om = make_float2(0.f, 0.f);
        if (kOutMul) om = *reinterpret_cast<const float2*>(out_mul + o);
        const float z0 = conv_epilogue<kOutMul>(acc[i][j][2 * hh], bv, om.x,
                                                mk[j].x);
        const float z1 = conv_epilogue<kOutMul>(acc[i][j][2 * hh + 1], bv,
                                                om.y, mk[j].y);
        if (out_z != nullptr)
          *reinterpret_cast<float2*>(out_z + o) = make_float2(z0, z1);
        if (out_y != nullptr)
          *reinterpret_cast<float2*>(out_y + o) =
              make_float2(nq_gelu(z0), nq_gelu(z1));
      }
    }
}

// Second pass of a split-K launch: the splits' partial sums added in order,
// then the epilogue; 4 positions per thread.
template <bool kOutMul>
__global__ void tail_conv_cf_finish_kernel(
    const float4* __restrict__ part, const float* __restrict__ bias,
    const float4* __restrict__ out_mul, const float4* __restrict__ mask,
    float4* __restrict__ out_z, float4* __restrict__ out_y, long total4,
    int cout, int mp4, int splits) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total4) return;
  float4 s = part[i];
  for (int k = 1; k < splits; ++k) {
    const float4 p = part[(size_t)k * total4 + i];
    s.x += p.x;
    s.y += p.y;
    s.z += p.z;
    s.w += p.w;
  }
  const long row = i / mp4;
  const int m4 = (int)(i - row * mp4);
  const float bv = bias != nullptr ? bias[row % cout] : 0.f;
  const float4 mk = mask[m4];
  float4 om = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kOutMul) om = out_mul[i];
  float4 z;
  z.x = conv_epilogue<kOutMul>(s.x, bv, om.x, mk.x);
  z.y = conv_epilogue<kOutMul>(s.y, bv, om.y, mk.y);
  z.z = conv_epilogue<kOutMul>(s.z, bv, om.z, mk.z);
  z.w = conv_epilogue<kOutMul>(s.w, bv, om.w, mk.w);
  if (out_z != nullptr) out_z[i] = z;
  if (out_y != nullptr)
    out_y[i] =
        make_float4(nq_gelu(z.x), nq_gelu(z.y), nq_gelu(z.z), nq_gelu(z.w));
}

template <int WM, bool kOutMul>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   const float* out_mul, const float* mask, const int4* ksteps,
                   float* out_z, float* out_y, float* part, int batch, int cin,
                   int cout, int mp, int ktiles, int splits, int act_in,
                   cudaStream_t stream) {
  using T = Tile<WM>;
  auto kernel = tail_conv_cf_kernel<WM, kOutMul>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(mp / BN, (cout + T::BM - 1) / T::BM, batch * splits);
  kernel<<<grid, THREADS, T::SMEM_BYTES, stream>>>(
      x, w, bias, out_mul, mask, ksteps, out_z, out_y, part, batch, cin, cout,
      mp, ktiles, splits, act_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long total4 = (long)batch * cout * (mp / 4);
  tail_conv_cf_finish_kernel<kOutMul>
      <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), bias,
          reinterpret_cast<const float4*>(out_mul),
          reinterpret_cast<const float4*>(mask),
          reinterpret_cast<float4*>(out_z), reinterpret_cast<float4*>(out_y),
          total4, cout, mp / 4, splits);
  return cudaGetLastError();
}

}  // namespace

// ksteps: (nsteps, 4) int32 rows (shift, first channel, valid rows, 0),
// nsteps a multiple of 8; w: (4 * nsteps, cout). out_z / out_y: either or
// both. part: (splits, B, cout, Mp) scratch when splits > 1, else unused.
extern "C" int nq_tail_conv_cf(const float* x, const float* w,
                               const float* bias, const float* out_mul,
                               const float* mask, const int* ksteps,
                               float* out_z, float* out_y, float* part,
                               int batch, int cin, int cout, int mp,
                               int nsteps, int splits, int act_in,
                               void* stream) {
  if (nsteps < 1 || nsteps % (BK / 4) != 0 || mp % BN != 0 || batch < 1 ||
      cout < 1 || cout % 4 != 0 || splits < 1 ||
      (splits > 1 && part == nullptr) ||
      (out_z == nullptr && out_y == nullptr) ||
      (long)batch * splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int ktiles = nsteps / (BK / 4);
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
  // output channels per block: 64, 96 or 128 (_conv_tile_m of
  // ops/tail_fused.py): the tile that leaves the fewest fragment rows of
  // the last tile empty; 64 for a K of at most 8 stages, whose time is the
  // epilogue's
  const int wm = (cout <= 64 || ktiles <= 8)                   ? 2
                 : (cout <= 96 || (cout > 128 && cout <= 192)) ? 3
                                                               : 4;
#define NQ_LAUNCH(WM, OM)                                                    \
  launch<WM, OM>(x, w, bias, out_mul, mask, ks, out_z, out_y, part, batch,   \
                 cin, cout, mp, ktiles, splits, act_in, st)
  cudaError_t err;
  if (out_mul != nullptr)
    err = wm == 2 ? NQ_LAUNCH(2, true)
                  : wm == 3 ? NQ_LAUNCH(3, true) : NQ_LAUNCH(4, true);
  else
    err = wm == 2 ? NQ_LAUNCH(2, false)
                  : wm == 3 ? NQ_LAUNCH(3, false) : NQ_LAUNCH(4, false);
#undef NQ_LAUNCH
  return (int)err;
}

extern "C" const char* nq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
