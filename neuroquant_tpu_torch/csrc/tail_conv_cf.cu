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
//
// The bf16 instantiation (nq_tail_conv_cf_bf16; the TPU kernel's own
// operand type, `_mxu_cast` and `_entry_and_cast` of the JAX tail): x, the
// weight operand, the bias and out_mul are bf16, the sums fp32; the bias,
// GELU', the mask and GELU are applied to the fp32 sum, and z and y are
// each rounded once to bf16 (round to nearest even). act_in rounds GELU(x)
// to bf16 before the multiply. The split-K partial sums stay fp32.
//
// Bound on the H100: operations at 989 TFLOP/s (bf16 dense) at every layer
// but the head (0.009 / 0.024 / 0.067 ms a frame at HNeRV Bunny-3M), bytes
// at the head. Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): what holds
// the kernel back is moving x and the weights from L2 to the SMs, not the
// tensor cores: with the realignment, the products and the epilogue all
// compiled out, L1's decode still took 0.30 of its 0.50 ms.
//
// Design (nq_tma.cuh; a wgmma implicit GEMM out[cout, Mp] = W^T[cout, K] *
// X[K, Mp], X gathered by shifts):
//  * A block is one producer warp and two consumer warpgroups; its tile is
//    128 channels x 256 positions (one block an SM) or, where 64-channel
//    slabs pad cout less (176 -> 192, cout <= 64), 64 x 256 (two). Each
//    warpgroup multiplies its 128 positions of every 64-channel slab with
//    wgmma m64n128k16, the sums in registers.
//  * K is walked in stages of 32 rows (8 steps) through a ring of 6 or 3
//    stages filled by TMA under mbarriers (full: the copies' bytes landed;
//    empty: both warpgroups' products of the stage are done). The weight
//    rows come whole, in the 128-byte swizzle wgmma reads (M-major A). The
//    x rows come as boxes of a run of steps (4 to 32 rows of consecutive
//    channels at one shift; the host's box plan in column 3 of the step
//    list), 3-D (Mp, cin, B) so that positions before 0 or past Mp read
//    zeros and no box crosses a frame.
//  * The shift: a TMA box may only start on 16 bytes (8 positions), so a
//    box starts at m0 + shift rounded down to 8 and holds 144 positions
//    per 128 served, unswizzled; each warpgroup realigns its rows (two
//    aligned 16-byte loads, a word select and a 16-bit funnel shift per
//    16 bytes), applies GELU when act_in, and writes them swizzled
//    (N-major B) into one of its two operand buffers, while its previous
//    stage's products run.
//  * Every product chains in the tensor core's accumulator over the split's
//    whole K (scale-d 0 at its first product): the outputs round to bf16,
//    and the truncation over at most 334 k16 products stays far inside a
//    bf16 unit (nq_mma.cuh).
//  * Epilogue: the sums staged as fp32 in the ring, then the bias, GELU',
//    mask and GELU on 8 positions a thread, 16-byte stores along the
//    channels-first rows. The K split of a launch with too few tiles and
//    its fixed-order second pass are the fp32 instantiation's.

#include <cuda_runtime.h>

#include <stdint.h>

#include <cstdint>
#include <type_traits>

#include "nq_common.cuh"
#include "nq_mma.cuh"
#include "nq_tma.cuh"

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

// ---- bf16 instantiation: a TMA ring and wgmma ----------------------------

constexpr int BK16 = 32;              // K rows per stage: 8 steps
constexpr int STEPS16 = BK16 / 4;
constexpr int CONSUMERS16 = 256;      // two consumer warpgroups
constexpr int THREADS16 = CONSUMERS16 + 32;   // and one producer warp
constexpr int SEG16 = 144;            // staged positions per 128 served
constexpr int SROW16 = SEG16 * 2;     // staged row, bytes
constexpr int SEG_BYTES16 = BK16 * SROW16;    // 9 KB
constexpr int WSLAB16 = BK16 * 128;   // weight rows of 64 channels: 4 KB

// MT = 2: 128 output channels x 256 positions, one block on each SM;
// MT = 1: 64 channels x 256 positions, two blocks on each SM. Warpgroup w
// multiplies the 128 positions 128 w.. of every 64-channel slab (MT
// m64n128 products, 64 MT fp32 sums a thread) and realigns only the x rows
// it multiplies.
template <int MT>
struct Tile16 {
  static constexpr int BM = 64 * MT;
  static constexpr int BN = 256;
  static constexpr int PW = BN / 2;             // positions a warpgroup
  static constexpr int NSEG = BN / 128;         // staged segments
  static constexpr int BLOCKS = MT == 2 ? 1 : 2;  // blocks on each SM
  static constexpr int STAGE = NSEG * SEG_BYTES16 + MT * WSLAB16;
  static constexpr int STAGES = MT == 2 ? 6 : 3;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int OPBUF = BK16 * 128 * (PW / 64);  // realigned x rows
  static constexpr int OPS = 2 * 2 * OPBUF;     // two per warpgroup
  static constexpr int EPI_LD = PW + 8;         // epilogue row, floats
  static constexpr int EPI = 2 * 64 * MT * EPI_LD * 4;
  static constexpr int AREA = RING + OPS > EPI ? RING + OPS : EPI;
  static constexpr int SMEM_BYTES = 1024 + AREA + 16 * STAGES;
};

// the tensor maps of one launch, kernel parameters (__grid_constant__)
struct alignas(64) ConvMaps16 {
  CUtensorMap x[NQ_BOX_HEIGHTS];   // x (Mp, cin, B), boxes 144 x 4..32 rows
  CUtensorMap w;                   // w_op (cout, K rows), boxes 64 x 32
};

template <int MT, bool kOutMul>
__global__ void __launch_bounds__(THREADS16, Tile16<MT>::BLOCKS)
tail_conv_cf_bf16_kernel(const __grid_constant__ ConvMaps16 maps,
                         const nq_bf16* __restrict__ bias,
                         const nq_bf16* __restrict__ out_mul,
                         const float* __restrict__ mask,
                         const int4* __restrict__ ksteps,
                         nq_bf16* __restrict__ out_z,
                         nq_bf16* __restrict__ out_y,
                         float* __restrict__ part, int batch, int cout,
                         int mp, int ktiles, int splits, int act_in) {
  using T = Tile16<MT>;
  constexpr int CPR = T::PW / 8;                // 16-byte chunks a row
  constexpr int PER = BK16 * CPR / 128;         // chunks a thread, a stage
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nq_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + T::AREA;         // STAGES barriers each
  const uint32_t empty = full + 8 * T::STAGES;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * T::BN;
  const int co0 = blockIdx.y * T::BM;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z - b * splits;
  const int per = (ktiles + splits - 1) / splits;
  const int kt_begin = split * per;
  const int nkt = max(0, min(ktiles, kt_begin + per) - kt_begin);

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      nq_mbar_init(full + 8 * s, 1);
      nq_mbar_init(empty + 8 * s, CONSUMERS16 / 32);
    }
    nq_fence_mbar_init();
  }
  __syncthreads();

  if (warp == CONSUMERS16 / 32) {
    // producer: lane j < 8 copies the box the plan starts at step j of
    // the stage (rows 4j.., the positions from m0 + shift rounded down to
    // 8, one box per 128 positions), lanes below BM / 64 a 64-channel slab
    // of the weight rows
    for (int it = 0; it < nkt; ++it) {
      const int s = it % T::STAGES;
      const int kt = kt_begin + it;
      int4 st = make_int4(0, 0, 0, 0);
      if (lane < STEPS16) st = __ldg(&ksteps[kt * STEPS16 + lane]);
      nq_mbar_wait(empty + 8 * s, ((it / T::STAGES) & 1) ^ 1);
      if (lane == 0) nq_mbar_expect_tx(full + 8 * s, T::STAGE);
      __syncwarp();
      const uint32_t xs = base + s * T::STAGE;
      if (lane < STEPS16 && st.w > 0) {
        const CUtensorMap* xm = &maps.x[nq_box_map(st.w)];
        const int a = (m0 + st.x) & ~7;
#pragma unroll
        for (int g = 0; g < T::NSEG; ++g)
          nq_tma_load_3d(xs + g * SEG_BYTES16 + lane * 4 * SROW16, xm,
                         a + 128 * g, st.y, b, full + 8 * s);
      }
      if (lane < MT)
        nq_tma_load_2d(xs + T::NSEG * SEG_BYTES16 + lane * WSLAB16, &maps.w,
                       co0 + 64 * lane, kt * BK16, full + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg, thread wt of it
  const int wg = warp >> 2, wt = tid & 127;
  const int seg = wg;                           // its staged segment
  const uint32_t opw = base + T::RING + wg * 2 * T::OPBUF;
  unsigned char* opw_p = smem + T::RING + wg * 2 * T::OPBUF;
  // no instruction but wgmma defines the sums (ptxas serializes the
  // products otherwise): the first product overwrites them (scale-d 0)
  float acc[MT][T::PW / 2];

  for (int it = 0; it < nkt; ++it) {
    const int s = it % T::STAGES;
    const int buf = it & 1;
    // the shift's residue r = shift mod 8 of each row this thread moves,
    // fetched ahead of the wait
    int rr[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j)
      rr[j] = __ldg(&ksteps[(kt_begin + it) * STEPS16 +
                            ((wt + 128 * j) / CPR >> 2)].x) & 7;
    nq_mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
    // realign the staged rows into this warpgroup's operand buffer: row
    // k, chunk c reads 8 values from column 8c + r, written in the
    // 128-byte swizzle, N-major (64 positions a line, atoms of 8 rows)
    const unsigned char* stg = smem + s * T::STAGE + seg * SEG_BYTES16;
    unsigned char* opb = opw_p + buf * T::OPBUF;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int i = wt + 128 * j;
      const int k = i / CPR, c = i % CPR;
      const unsigned char* src = stg + k * SROW16 + c * 16;
      uint4 q = nq_realign16(*reinterpret_cast<const uint4*>(src),
                             *reinterpret_cast<const uint4*>(src + 16), rr[j]);
      if (act_in) nq_gelu_chunk(q);
      *reinterpret_cast<uint4*>(opb + (c >> 3) * (BK16 * 128) + k * 128 +
                                (((c & 7) ^ (k & 7)) << 4)) = q;
    }
    nq_fence_proxy_async();
    // the previous stage's products are done: once every warp of the
    // warpgroup knows (and has written its rows), the buffer they read may
    // be rewritten next turn and their ring stage is released. Its
    // realignment above overlapped them.
    nq_wgmma_wait<0>();
    nq_named_bar_sync(1 + wg, 128);
    if (it > 0 && lane == 0)
      nq_mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
    nq_wgmma_fence();
    const uint32_t ws = base + s * T::STAGE + T::NSEG * SEG_BYTES16;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      // A = W^T: 64 channels (one atom wide, M-major), B = the realigned
      // x rows (N-major); a k16 slice is two 8-row atoms on
      const uint64_t db = nq_desc_sw128(opw + buf * T::OPBUF + q * 2048,
                                        BK16 * 128, 1024);
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const uint64_t da =
            nq_desc_sw128(ws + t * WSLAB16 + q * 2048, WSLAB16, 1024);
        nq_wgmma_n128<1, 1>(acc[t], da, db, it > 0 || q > 0);
      }
    }
    nq_wgmma_commit();
  }
  nq_wgmma_wait<0>();

  // epilogue: both warpgroups done with the ring and the operand buffers;
  // each stages its MT * 64 x PW fp32 tile there and writes it back along
  // the rows, 8 positions (16 bytes of bf16) a thread. A split with no K
  // tiles (a split count that does not divide them) stages zeros.
  nq_named_bar_sync(3, CONSUMERS16);
  float* stg = reinterpret_cast<float*>(smem) + wg * 64 * MT * T::EPI_LD;
  {
    const int wl = warp & 3, g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int j = 0; j < T::PW / 8; ++j) {
        float* p = stg + (64 * t + 16 * wl + g) * T::EPI_LD + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(p) = nkt > 0
            ? make_float2(acc[t][4 * j], acc[t][4 * j + 1])
            : make_float2(0.f, 0.f);
        *reinterpret_cast<float2*>(p + 8 * T::EPI_LD) = nkt > 0
            ? make_float2(acc[t][4 * j + 2], acc[t][4 * j + 3])
            : make_float2(0.f, 0.f);
      }
  }
  nq_named_bar_sync(1 + wg, 128);
  const int mb = m0 + T::PW * wg;
  for (int i = wt; i < 64 * MT * CPR; i += 128) {
    const int r = i / CPR, c8 = (i % CPR) * 8;
    const int co = co0 + r, m = mb + c8;
    if (co >= cout || m >= mp) continue;
    const float* sp = stg + r * T::EPI_LD + c8;
    const float4 a0 = *reinterpret_cast<const float4*>(sp);
    const float4 a1 = *reinterpret_cast<const float4*>(sp + 4);
    if (splits > 1) {
      float* pp = part + (((size_t)split * batch + b) * cout + co) * mp + m;
      *reinterpret_cast<float4*>(pp) = a0;
      *reinterpret_cast<float4*>(pp + 4) = a1;
      continue;
    }
    const float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv = bias != nullptr ? nq_f32(bias[co]) : 0.f;
    const float4 k0 = *reinterpret_cast<const float4*>(mask + m);
    const float4 k1 = *reinterpret_cast<const float4*>(mask + m + 4);
    const float mk[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
    const size_t o = ((size_t)b * cout + co) * mp + m;
    uint4 om = make_uint4(0u, 0u, 0u, 0u);
    if (kOutMul) om = *reinterpret_cast<const uint4*>(out_mul + o);
    float z[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t w = nq_word(om, e >> 1);
      z[e] = conv_epilogue<kOutMul>(v[e], bv,
                                    (e & 1) ? nq_bf16_hi(w) : nq_bf16_lo(w),
                                    mk[e]);
    }
    if (out_z != nullptr)
      *reinterpret_cast<uint4*>(out_z + o) = make_uint4(
          nq_pack_bf16(z[0], z[1]), nq_pack_bf16(z[2], z[3]),
          nq_pack_bf16(z[4], z[5]), nq_pack_bf16(z[6], z[7]));
    if (out_y != nullptr)
      *reinterpret_cast<uint4*>(out_y + o) = make_uint4(
          nq_pack_bf16(nq_gelu(z[0]), nq_gelu(z[1])),
          nq_pack_bf16(nq_gelu(z[2]), nq_gelu(z[3])),
          nq_pack_bf16(nq_gelu(z[4]), nq_gelu(z[5])),
          nq_pack_bf16(nq_gelu(z[6]), nq_gelu(z[7])));
  }
}

// Second pass of a bf16 split-K launch: the fp32 partial sums added in
// order, the epilogue, z and y rounded to bf16; 4 positions per thread.
template <bool kOutMul>
__global__ void tail_conv_cf_bf16_finish_kernel(
    const float4* __restrict__ part, const nq_bf16* __restrict__ bias,
    const uint2* __restrict__ out_mul, const float4* __restrict__ mask,
    nq_bf16* __restrict__ out_z, nq_bf16* __restrict__ out_y, long total4,
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
  const float bv = bias != nullptr ? nq_f32(bias[row % cout]) : 0.f;
  const float4 mk = mask[m4];
  uint2 om = make_uint2(0u, 0u);
  if (kOutMul) om = out_mul[i];
  const float z0 = conv_epilogue<kOutMul>(s.x, bv, nq_bf16_lo(om.x), mk.x);
  const float z1 = conv_epilogue<kOutMul>(s.y, bv, nq_bf16_hi(om.x), mk.y);
  const float z2 = conv_epilogue<kOutMul>(s.z, bv, nq_bf16_lo(om.y), mk.z);
  const float z3 = conv_epilogue<kOutMul>(s.w, bv, nq_bf16_hi(om.y), mk.w);
  if (out_z != nullptr) nq_store4(out_z + 4 * i, z0, z1, z2, z3);
  if (out_y != nullptr)
    nq_store4(out_y + 4 * i, nq_gelu(z0), nq_gelu(z1), nq_gelu(z2),
              nq_gelu(z3));
}

template <int MT, bool kOutMul>
cudaError_t launch_bf16(const ConvMaps16& maps, const nq_bf16* bias,
                        const nq_bf16* out_mul, const float* mask,
                        const int4* ksteps, nq_bf16* out_z, nq_bf16* out_y,
                        float* part, int batch, int cout, int mp, int ktiles,
                        int splits, int act_in, cudaStream_t stream) {
  using T = Tile16<MT>;
  auto kernel = tail_conv_cf_bf16_kernel<MT, kOutMul>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((mp + T::BN - 1) / T::BN, (cout + T::BM - 1) / T::BM,
                  batch * splits);
  kernel<<<grid, THREADS16, T::SMEM_BYTES, stream>>>(
      maps, bias, out_mul, mask, ksteps, out_z, out_y, part, batch, cout, mp,
      ktiles, splits, act_in);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long total4 = (long)batch * cout * (mp / 4);
  tail_conv_cf_bf16_finish_kernel<kOutMul>
      <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), bias,
          reinterpret_cast<const uint2*>(out_mul),
          reinterpret_cast<const float4*>(mask), out_z, out_y, total4, cout,
          mp / 4, splits);
  return cudaGetLastError();
}

// 64-channel slabs per block of the bf16 kernel (conv_bf16_tile of
// ops/tail_fused.py): 2 unless 1 pads cout to fewer channels
int conv16_mt(int cout) {
  return (cout + 127) / 128 * 128 <= (cout + 63) / 64 * 64 ? 2 : 1;
}

// output channels per block of the fp32 kernel
int conv_wm(int cout, int ktiles) {
  return (cout <= 64 || ktiles <= 8)                   ? 2
         : (cout <= 96 || (cout > 128 && cout <= 192)) ? 3
                                                       : 4;
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
  const int wm = conv_wm(cout, ktiles);
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

// The bf16 instantiation: x, w, bias, out_mul, out_z, out_y bf16 (bias,
// out_mul, out_z or out_y may be NULL as above), mask and part fp32; x, w,
// out_mul and the outputs 16-byte aligned, cout a multiple of 8 (TMA's
// 16-byte row strides). Column 3 of each step is its box: the rows of the
// one copy that starts at this step (4, 8, 16 or 32, consecutive channels
// at the step's shift, within its stage), 0 when an earlier step's box
// covers it (ops/tail_fused.py, _box_plan). Returns cudaErrorInvalidValue
// for what it does not take and cudaErrorNotSupported when the driver
// refuses a tensor map.
extern "C" int nq_tail_conv_cf_bf16(const void* x, const void* w,
                                    const void* bias, const void* out_mul,
                                    const float* mask, const int* ksteps,
                                    void* out_z, void* out_y, float* part,
                                    int batch, int cin, int cout, int mp,
                                    int nsteps, int splits, int act_in,
                                    void* stream) {
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (nsteps < 1 || nsteps % STEPS16 != 0 || mp % BN != 0 || batch < 1 ||
      cin < 1 || cout < 1 || cout % 8 != 0 || splits < 1 ||
      (splits > 1 && part == nullptr) ||
      (out_z == nullptr && out_y == nullptr) ||
      (long)batch * splits > 65535 || misaligned(x) || misaligned(w) ||
      misaligned(out_mul) || misaligned(out_z) || misaligned(out_y))
    return (int)cudaErrorInvalidValue;
  ConvMaps16 maps;
  const uint64_t wdims[2] = {(uint64_t)cout, (uint64_t)nsteps * 4};
  const uint64_t wstride[1] = {(uint64_t)cout * 2};
  const uint32_t wbox[2] = {64, BK16};
  if (!nq_x_maps(maps.x, x, batch, cin, mp, SEG16) ||
      !nq_bf16_map(&maps.w, w, 2, wdims, wstride, wbox))
    return (int)cudaErrorNotSupported;
  const int ktiles = nsteps / STEPS16;
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
  const nq_bf16* bh = static_cast<const nq_bf16*>(bias);
  const nq_bf16* omh = static_cast<const nq_bf16*>(out_mul);
  nq_bf16* zh = static_cast<nq_bf16*>(out_z);
  nq_bf16* yh = static_cast<nq_bf16*>(out_y);
  const int mt = conv16_mt(cout);
#define NQ_LAUNCH(MT, OM)                                                  \
  launch_bf16<MT, OM>(maps, bh, omh, mask, ks, zh, yh, part, batch, cout, \
                      mp, ktiles, splits, act_in, st)
  cudaError_t err;
  if (out_mul != nullptr)
    err = mt == 2 ? NQ_LAUNCH(2, true) : NQ_LAUNCH(1, true);
  else
    err = mt == 2 ? NQ_LAUNCH(2, false) : NQ_LAUNCH(1, false);
#undef NQ_LAUNCH
  return (int)err;
}

// The launch geometry the bf16 entry uses for `cout`: out[0..3] = output
// channels and positions per block, ring stages, dynamic shared memory
// bytes (what ops/tail_fused.py's conv_bf16_geometry computes).
extern "C" int nq_tail_conv_cf_bf16_tile(int cout, int* out) {
  if (conv16_mt(cout) == 2) {
    out[0] = Tile16<2>::BM, out[1] = Tile16<2>::BN;
    out[2] = Tile16<2>::STAGES, out[3] = Tile16<2>::SMEM_BYTES;
  } else {
    out[0] = Tile16<1>::BM, out[1] = Tile16<1>::BN;
    out[2] = Tile16<1>::STAGES, out[3] = Tile16<1>::SMEM_BYTES;
  }
  return 0;
}

extern "C" const char* nq_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
