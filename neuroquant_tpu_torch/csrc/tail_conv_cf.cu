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
// carry zero weight rows. The list covers the dense taps of an f=1 layer
// or the union of nonzero blocks of a layer packed with f >= 2, and pads
// to whole stages of 8 steps with empty steps. The dx pass runs on the
// transposed layer: the same function on another list.
//
// Bound on the H100: operations at every layer but the head, three TF32
// products per fp32 product at 495 TFLOP/s (8.7 / 25.2 / 66.7 GFLOP of
// useful work a frame at HNeRV Bunny-3M: 0.053 / 0.145 / 0.404 ms); the
// head by bytes (~136 MB, 0.041 ms at 3.35 TB/s): 0.64 ms a decode.
//
// Design for that bound (nq_tma.cuh; a wgmma implicit GEMM, here out^T[Mp,
// cout] = X^T[Mp, K] * W[K, cout], X gathered by shifts, the bf16
// instantiation's x boxes at fp32 accuracy):
//  * A block is one producer warpgroup and two consumer warpgroups, one
//    block on each SM; its tile is 128 positions x NC channels, NC 64 for
//    cout <= 64, else 96 or 128, whichever pads cout less (176 -> 192).
//    Consumer w multiplies the positions 64 w.. with every channel
//    (m64nNCk8): with the second set of sums the promotion below keeps,
//    NC / 2 + NC / 2 registers a thread, so the tile stays under bf16's.
//  * K is walked in stages of 32 rows (8 steps) through a ring of 4, 5 or
//    6 stages filled by TMA under mbarriers (full: the copies' bytes
//    landed; wready: the weights split; empty: the stage's products done).
//    The x rows come as the bf16 kernel's boxes (the host's box plan in
//    column 3 of the step list), 136 positions per 128 served from m0 +
//    shift rounded down to 4 (a box starts on 16 bytes), unswizzled; the
//    weight rows K-major (the host's operand is (cout, K rows), the one
//    gather it makes either way), NC lines of 32 K values in the 128-byte
//    swizzle.
//  * wgmma reads a TF32 operand from shared memory only K-major, and A may
//    come from registers. So B is the weights: the producer warpgroup
//    splits each landed value into two TF32 parts rounded to nearest
//    (cvt.rna: hi, then lo = rna(v - hi)), hi in place and lo beside it
//    (elementwise, 16 bytes a thread: the swizzle moves nothing inside a
//    chunk). A is x^T: each consumer thread loads its fragment straight
//    from the staged rows at column + (shift & 3) (row stride 136 = 8 mod
//    32: the 32 lanes' loads on 32 banks) and splits it in registers. No
//    pass before the kernel and no transposition of x.
//  * 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22 of the
//    product, dropped), the small products first. The tensor core
//    truncates as it accumulates (nq_mma.cuh), so the 12 products of one
//    stage chain from zero (scale-d 0) and the stage's sum is added to the
//    running sum by the fp32 adders, round to nearest, once its products
//    are done; the other consumer's products run meanwhile.
//  * act_in: GELU on each x value before its split.
//  * Epilogue from the sums in registers: bias, GELU'(out_mul), the border
//    mask, GELU for out_y, 4-byte stores, a warp's filling 32-byte
//    sectors; 'zy' writes both outputs from the one sum.
//  * A launch with too few tiles to fill the card (the prefix's dx pass:
//    32-64 tiles, K = 21,216) splits K across blocks; each split writes its
//    raw partial sums, and a second pass in the same launcher adds them in
//    a fixed order and applies the epilogue: no atomics, the same bits
//    every run.
//  * Measured on an NVIDIA H100 (PERF.md): the products alone (no copies,
//    loads or splits) take 0.62x of L1's time, ~69% of the TF32 peak with
//    the per-stage promotion; the copies and loads overlap them in part.
//    A launch of at most 8 K stages and more than 128 channels (a packed
//    head's dx pass) spends its time filling the ring and in the epilogue,
//    one block on each SM: 1.6x the mma.sync kernel this design replaced.
//    Such launches run only in the training steps, which the host paces.
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

template <bool kOutMul>
__device__ __forceinline__ float conv_epilogue(float acc, float bias, float om,
                                               float mask) {
  float z = acc + bias;
  if (kOutMul) z *= nq_gelu_grad(om);
  return z * mask;
}

// ---- fp32: a TMA ring and wgmma at 3xTF32 ---------------------------------

constexpr int STEPS32 = BK / 4;
constexpr int CONSUMERS32 = 256;      // two consumer warpgroups
constexpr int THREADS32 = CONSUMERS32 + 128;  // and the producer warpgroup
constexpr int SEG32 = 136;            // staged positions per 128 served
constexpr int SROW32 = SEG32 * 4;     // staged row, bytes
constexpr int XSTG32 = BK * SROW32;   // a stage's x rows: 17 KB
constexpr int REG_CONSUMER = 232;     // registers a thread (setmaxnreg:
constexpr int REG_PRODUCER = 40;      // the producer's split needs few)

// NC output channels (64, 96 or 128) x 128 positions a block, one block on
// each SM; consumer warpgroup w multiplies the positions 64 w.. with every
// channel (m64nNCk8): NC / 2 fp32 sums and NC / 2 fragment registers a
// thread. A stage: the staged x rows, then the weight rows K-major (NC
// lines of the stage's 32 K values) as TMA lands them and rewritten as
// their TF32 hi part, then their lo part.
template <int NC>
struct Tile32 {
  static constexpr int WBYTES = NC * 128;
  static constexpr int STAGE = XSTG32 + 2 * WBYTES;
  static constexpr int STAGES = NC == 128 ? 4 : NC == 96 ? 5 : 6;
  static constexpr int SMEM_BYTES = 1024 + STAGES * STAGE + 8 * 3 * STAGES;
};

// the tensor maps of one launch, kernel parameters (__grid_constant__)
struct alignas(64) ConvMaps32 {
  CUtensorMap x[NQ_BOX_HEIGHTS];   // x (Mp, cin, B), boxes 136 x 4..32 rows
  CUtensorMap w;                   // w (cout, K rows), boxes NC x 32
};

template <int NC, bool kOutMul>
__global__ void __launch_bounds__(THREADS32, 1)
tail_conv_cf_kernel(const __grid_constant__ ConvMaps32 maps,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_mul,
                    const float* __restrict__ mask,
                    const int4* __restrict__ ksteps, float* __restrict__ out_z,
                    float* __restrict__ out_y, float* __restrict__ part,
                    int batch, int cout, int mp, int ktiles, int splits,
                    int act_in) {
  using T = Tile32<NC>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = nq_smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full = base + T::STAGES * T::STAGE;  // TMA bytes landed
  const uint32_t wready = full + 8 * T::STAGES;   // weights split
  const uint32_t empty = wready + 8 * T::STAGES;  // the stage's products done

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BN;
  const int co0 = blockIdx.y * NC;
  const int b = blockIdx.z / splits;
  const int split = blockIdx.z - b * splits;
  const int per = (ktiles + splits - 1) / splits;
  const int kt_begin = split * per;
  const int nkt = max(0, min(ktiles, kt_begin + per) - kt_begin);
  // lane j < 8 reads step j of a stage of the list
  auto step = [&](int it) {
    return lane < STEPS32 && it < nkt
        ? __ldg(&ksteps[(kt_begin + it) * STEPS32 + lane])
        : make_int4(0, 0, 0, 0);
  };

  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      nq_mbar_init(full + 8 * s, 1);
      nq_mbar_init(wready + 8 * s, 4);
      nq_mbar_init(empty + 8 * s, CONSUMERS32 / 32);
    }
    nq_fence_mbar_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS32 / 32) {
    // the producer warpgroup: its first warp keeps the TMA copies of the
    // next stages in flight (lane j < 8 the box the plan starts at step j,
    // rows 4j.., 136 positions from m0 + shift rounded down to 4; lane 0
    // the weight rows, 32 K values x NC channels in the 128-byte swizzle);
    // all four warps split the landed weights into TF32 hi (in place) and
    // lo, 16 bytes a thread at a time (the swizzle moves nothing inside a
    // 16-byte chunk)
    nq_setmaxnreg_dec<REG_PRODUCER>();
    const int pt = tid - CONSUMERS32;
    auto load_stage = [&](int it, int4 st) {
      const int s = it % T::STAGES;
      const int kt = kt_begin + it;
      nq_mbar_wait(empty + 8 * s, ((it / T::STAGES) & 1) ^ 1);
      if (lane == 0) nq_mbar_expect_tx(full + 8 * s, XSTG32 + T::WBYTES);
      __syncwarp();
      const uint32_t xs = base + s * T::STAGE;
      if (lane < STEPS32 && st.w > 0)
        nq_tma_load_3d(xs + lane * 4 * SROW32, &maps.x[nq_box_map(st.w)],
                       (m0 + st.x) & ~3, st.y, b, full + 8 * s);
      if (lane == 0)
        nq_tma_load_2d(xs + XSTG32, &maps.w, kt * BK, co0, full + 8 * s);
    };
    constexpr int AHEAD = T::STAGES - 1;
    int4 ahead = make_int4(0, 0, 0, 0);
    if (pt < 32) {
      for (int it = 0; it < min(AHEAD, nkt); ++it) load_stage(it, step(it));
      ahead = step(AHEAD);
    }
    for (int it = 0; it < nkt; ++it) {
      const int s = it % T::STAGES;
      nq_mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
      unsigned char* w = smem + s * T::STAGE + XSTG32;
#pragma unroll
      for (int c = pt; c < NC * 8; c += 128) {
        uint4* hp = reinterpret_cast<uint4*>(w + 16 * c);
        const uint4 v = *hp;
        uint4 h, l;
        nq_split_rna(__uint_as_float(v.x), h.x, l.x);
        nq_split_rna(__uint_as_float(v.y), h.y, l.y);
        nq_split_rna(__uint_as_float(v.z), h.z, l.z);
        nq_split_rna(__uint_as_float(v.w), h.w, l.w);
        *hp = h;
        *reinterpret_cast<uint4*>(w + T::WBYTES + 16 * c) = l;
      }
      nq_fence_proxy_async();
      __syncwarp();
      if (lane == 0) nq_mbar_arrive(wready + 8 * s);
      // the copies of a later stage, once this one's weights are out
      if (pt < 32 && it + AHEAD < nkt) {
        const int4 st = ahead;
        ahead = step(it + AHEAD + 1);
        load_stage(it + AHEAD, st);
      }
    }
    return;
  }

  // consumers: warpgroup wg (positions pn0..pn0 + 63), warp wl of it
  nq_setmaxnreg_inc<REG_CONSUMER>();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int pn0 = 64 * wg;
  // A = x^T, this warp's 16 positions x the stage's K rows, read from the
  // staged rows (row k of position p at k * 136 + p + (shift & 3): the 32
  // lanes' loads on 32 banks, 136 = 8 mod 32) and split in registers
  const int apos = pn0 + 16 * wl + g;
  // no instruction but wgmma defines frag (ptxas serializes the products
  // otherwise): the first product of each stage overwrites it (scale-d 0)
  float acc[NC / 2], frag[NC / 2];
#pragma unroll
  for (int i = 0; i < NC / 2; ++i) acc[i] = 0.f;
  uint32_t ah[4][4], al[4][4];
  int4 next = step(0);

  for (int it = 0; it < nkt; ++it) {
    const int s = it % T::STAGES;
    // the shift's residue r = shift mod 4 of each step, 2 bits a step
    int rr = 0;
#pragma unroll
    for (int j = 0; j < STEPS32; ++j)
      rr |= (__shfl_sync(0xffffffffu, next.x, j) & 3) << (2 * j);
    next = step(it + 1);
    nq_mbar_wait(full + 8 * s, (it / T::STAGES) & 1);
    nq_mbar_wait(wready + 8 * s, (it / T::STAGES) & 1);
    // the previous stage's products are done: its ring stage is free, and
    // its sum joins the running one by the fp32 adders (round to nearest;
    // the tensor core truncates as it accumulates)
    nq_wgmma_wait<0>();
    if (it > 0) {
      __syncwarp();
      if (lane == 0) nq_mbar_arrive(empty + 8 * ((it - 1) % T::STAGES));
#pragma unroll
      for (int i = 0; i < NC / 2; ++i) acc[i] += frag[i];
    }
    // this thread's A fragments (the previous products, which read them,
    // are done): slice q, a[0] (position g, k t), a[1] (g + 8, t), a[2],
    // a[3] at k t + 4, each value through GELU when act_in
    const float* stg = reinterpret_cast<const float*>(smem + s * T::STAGE);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 8 * q + t4 + 4 * (e >> 1);
        const int r = (rr >> (2 * (2 * q + (e >> 1)))) & 3;
        float v = stg[k * SEG32 + apos + 8 * (e & 1) + r];
        if (act_in) v = nq_gelu(v);
        nq_split_rna(v, ah[q][e], al[q][e]);
      }
    nq_wgmma_fence();
    // B = the weight rows (hi, lo), a k8 slice 32 bytes along the lines.
    // The small products first, while the chained sum is small: a_lo b_hi,
    // a_hi b_lo, then a_hi b_hi.
    const uint32_t wb = base + s * T::STAGE + XSTG32;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint64_t db =
            nq_desc_sw128(wb + (p == 1 ? T::WBYTES : 0) + 32 * q, 16, 1024);
        nq_wgmma_tf32<NC>(frag, p == 0 ? al[q] : ah[q], db, p > 0 || q > 0);
      }
    nq_wgmma_commit();
  }
  nq_wgmma_wait<0>();
  if (nkt > 0) {
#pragma unroll
    for (int i = 0; i < NC / 2; ++i) acc[i] += frag[i];
  }

  // epilogue from the sums: thread owns positions apos, apos + 8 and the
  // channels 8 j + 2 t4, + 1; 4-byte stores, a warp's filling 32-byte
  // sectors. A split writes its raw sums; a split with no K tiles zeros.
  float mk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) mk[h] = mask[m0 + apos + 8 * h];
#pragma unroll
  for (int j = 0; j < NC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int co = co0 + 8 * j + 2 * t4 + e;
      if (co >= cout) continue;
      if (splits > 1) {
        float* pb = part + (((size_t)split * batch + b) * cout + co) * mp + m0;
#pragma unroll
        for (int h = 0; h < 2; ++h) pb[apos + 8 * h] = acc[4 * j + 2 * h + e];
        continue;
      }
      const float bv = bias != nullptr ? bias[co] : 0.f;
      const size_t row = ((size_t)b * cout + co) * mp + m0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const size_t o = row + apos + 8 * h;
        const float z = conv_epilogue<kOutMul>(
            acc[4 * j + 2 * h + e], bv, kOutMul ? out_mul[o] : 0.f, mk[h]);
        if (out_z != nullptr) out_z[o] = z;
        if (out_y != nullptr) out_y[o] = nq_gelu(z);
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

template <int NC, bool kOutMul>
cudaError_t launch(const ConvMaps32& maps, const float* bias,
                   const float* out_mul, const float* mask, const int4* ksteps,
                   float* out_z, float* out_y, float* part, int batch,
                   int cout, int mp, int ktiles, int splits, int act_in,
                   cudaStream_t stream) {
  using T = Tile32<NC>;
  auto kernel = tail_conv_cf_kernel<NC, kOutMul>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(mp / BN, (cout + NC - 1) / NC, batch * splits);
  kernel<<<grid, THREADS32, T::SMEM_BYTES, stream>>>(
      maps, bias, out_mul, mask, ksteps, out_z, out_y, part, batch, cout, mp,
      ktiles, splits, act_in);
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

// output channels per block of the fp32 kernel (conv_f32_tile of
// ops/tail_fused.py): 64 for cout <= 64, else of 96 and 128 the one that
// pads cout least, 128 on a tie
int conv32_nc(int cout) {
  if (cout <= 64) return 64;
  return (cout + 95) / 96 * 96 < (cout + 127) / 128 * 128 ? 96 : 128;
}

}  // namespace

// ksteps: (nsteps, 4) int32 rows (shift, first channel, valid rows, box),
// nsteps a multiple of 8, column 3 the rows of the TMA box that starts at
// the step (ops/tail_fused.py, _box_plan); w: (cout, 4 * nsteps), the
// weight rows K-major (ops/tail_fused.py, conv_w_operand). out_z / out_y:
// either or both. part: (splits, B, cout, Mp) scratch when splits > 1,
// else unused. x and w 16-byte aligned, cout a multiple of 4. Returns
// cudaErrorInvalidValue for what it does not take and
// cudaErrorNotSupported when the CUDA driver refuses a tensor map.
extern "C" int nq_tail_conv_cf(const float* x, const float* w,
                               const float* bias, const float* out_mul,
                               const float* mask, const int* ksteps,
                               float* out_z, float* out_y, float* part,
                               int batch, int cin, int cout, int mp,
                               int nsteps, int splits, int act_in,
                               void* stream) {
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (nsteps < 1 || nsteps % STEPS32 != 0 || mp % BN != 0 || batch < 1 ||
      cin < 1 || cout < 1 || cout % 4 != 0 || splits < 1 ||
      (splits > 1 && part == nullptr) ||
      (out_z == nullptr && out_y == nullptr) ||
      (long)batch * splits > 65535 || misaligned(x) || misaligned(w))
    return (int)cudaErrorInvalidValue;
  const int nc = conv32_nc(cout);
  ConvMaps32 maps;
  const uint64_t wdims[2] = {(uint64_t)nsteps * 4, (uint64_t)cout};
  const uint64_t wstride[1] = {(uint64_t)nsteps * 16};
  const uint32_t wbox[2] = {BK, (uint32_t)nc};
  if (!nq_x_maps(maps.x, x, batch, cin, mp, SEG32,
                 CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
      !nq_tensor_map(&maps.w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 2, wdims,
                     wstride, wbox))
    return (int)cudaErrorNotSupported;
  const int ktiles = nsteps / STEPS32;
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
#define NQ_LAUNCH(NC, OM)                                                  \
  launch<NC, OM>(maps, bias, out_mul, mask, ks, out_z, out_y, part, batch, \
                 cout, mp, ktiles, splits, act_in, st)
  cudaError_t err;
  if (out_mul != nullptr)
    err = nc == 128 ? NQ_LAUNCH(128, true)
          : nc == 96 ? NQ_LAUNCH(96, true) : NQ_LAUNCH(64, true);
  else
    err = nc == 128 ? NQ_LAUNCH(128, false)
          : nc == 96 ? NQ_LAUNCH(96, false) : NQ_LAUNCH(64, false);
#undef NQ_LAUNCH
  return (int)err;
}

// The launch geometry the fp32 entry uses for `cout`: out[0..3] = output
// channels and positions per block, ring stages, dynamic shared memory
// bytes (what ops/tail_fused.py's conv_f32_geometry computes).
extern "C" int nq_tail_conv_cf_tile(int cout, int* out) {
  const int nc = conv32_nc(cout);
  out[0] = nc, out[1] = BN;
  out[2] = nc == 128 ? Tile32<128>::STAGES
           : nc == 96 ? Tile32<96>::STAGES : Tile32<64>::STAGES;
  out[3] = nc == 128 ? Tile32<128>::SMEM_BYTES
           : nc == 96 ? Tile32<96>::SMEM_BYTES : Tile32<64>::SMEM_BYTES;
  return 0;
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
