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
// weight operand, the bias and out_mul are bf16, the sums fp32 (one
// mma.sync.m16n8k16.bf16 product per product, bound at 989 TFLOP/s dense,
// so by bytes at the head); the bias, GELU', the mask and GELU are applied
// to the fp32 accumulator, and z and y are each rounded once to bf16 (round
// to nearest even). act_in rounds GELU(x) to bf16 before the multiply. The
// split-K partial sums stay fp32. The same block, warp and stage shapes and
// the same K-step list, with these differences:
//  * An X row is copied from m0 + shift rounded down to a multiple of 8
//    (16 bytes of bf16), 17 vectors for 128 positions, and read at column
//    + (shift & 7).
//  * The B fragment of m16n8k16 wants rows 2t and 2t+1 of one column in
//    one register: they lie in one K step (one shift), but in two rows of
//    the [K][N] stage, and an odd shift leaves them at any alignment, so
//    the fragment is built from 16-bit shared loads, two per register. The
//    stage row stride, 136 bf16 (= 8 mod 32 words), keeps these loads free
//    of bank conflicts.
//  * The A fragment (the weights, [K][cout] in the stage) comes by
//    ldmatrix.x4.trans: its rows are 16-byte aligned, and a row stride of
//    cout-tile + 8 bf16 (an odd number of 16-byte units) keeps it free of
//    bank conflicts.
//  * A stage's two k16 products of each fragment are chained in the tensor
//    core from zero and added to the fp32 sum by the fp32 adders (the
//    tensor core's truncating accumulation would otherwise drift over the
//    prefix's 21,200 K rows).

#include <cuda_runtime.h>

#include <stdint.h>

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

// ---- bf16 instantiation ------------------------------------------------

constexpr int LDX16 = BN + 8;   // X stage row stride, bf16 (= 8 mod 32 words)

template <int WM>
struct Tile16 {
  static constexpr int BM = 32 * WM;          // output channels per block
  static constexpr int LDW = BM + 8;          // W stage row stride, bf16
  static constexpr int STAGE = BK * LDX16 + BK * LDW;  // bf16 per stage
  static constexpr int STAGES = 4;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 2;
};

template <int WM, bool kOutMul>
__global__ void __launch_bounds__(THREADS, 2)
tail_conv_cf_bf16_kernel(const nq_bf16* __restrict__ x,
                         const nq_bf16* __restrict__ w,
                         const nq_bf16* __restrict__ bias,
                         const nq_bf16* __restrict__ out_mul,
                         const float* __restrict__ mask,
                         const int4* __restrict__ ksteps,
                         nq_bf16* __restrict__ out_z,
                         nq_bf16* __restrict__ out_y,
                         float* __restrict__ part, int batch, int cin,
                         int cout, int mp, int ktiles, int splits,
                         int act_in) {
  using T = Tile16<WM>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  nq_bf16* smem16 = reinterpret_cast<nq_bf16*>(smem_raw);

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
  const nq_bf16* xb = x + (size_t)b * cin * mp;

  // X staging: a row holds x[chan][a .. a + 136) with a = m0 + shift
  // rounded down to a multiple of 8, as 17 aligned 16-byte vectors
  constexpr int XV = BN / 8 + 1;
  constexpr int XROUNDS = (BK * XV + THREADS - 1) / THREADS;
  constexpr int VECS = T::BM / 8;              // 16-byte vectors per W row
  constexpr int WROUNDS = (BK * VECS + THREADS - 1) / THREADS;

  auto load_stage = [&](int stage, int kt) {
    nq_bf16* xs = smem16 + stage * T::STAGE;
    nq_bf16* ws = xs + BK * LDX16;
#pragma unroll
    for (int i = 0; i < XROUNDS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= BK * XV) break;
      const int row = idx / XV, v = idx - row * XV;
      const int4 st = __ldg(&ksteps[kt * (BK / 4) + (row >> 2)]);
      const int rr = row & 3;
      const int pos = m0 + (st.x & ~7) + 8 * v;
      const bool valid = rr < st.z && pos >= 0 && pos + 8 <= mp;
      const nq_bf16* src = valid ? xb + (size_t)(st.y + rr) * mp + pos : xb;
      nq_cp_async16(nq_smem_addr(xs + row * LDX16 + 8 * v), src, valid);
    }
#pragma unroll
    for (int i = 0; i < WROUNDS; ++i) {
      const int idx = tid + i * THREADS;
      if (idx >= BK * VECS) break;
      const int row = idx / VECS, v = idx - row * VECS;
      const int co = co0 + v * 8;
      const bool valid = co < cout;
      const nq_bf16* src =
          valid ? w + (size_t)(kt * BK + row) * cout + co : w;
      nq_cp_async16(nq_smem_addr(ws + row * T::LDW + v * 8), src, valid);
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

  // ldmatrix: lane l addresses row l % 8 of matrix l / 8; matrix q holds
  // the K rows 8 * (q / 2) .. of the channels 8 * (q % 2) .. of a fragment
  const int lm_row = ((lane >> 4) << 3) + (lane & 7);
  const int lm_col = ((lane >> 3) & 1) << 3;

  auto multiply = [&](const nq_bf16* xs, const nq_bf16* ws, int offs,
                      auto all_rows_t) {
    const uint16_t* xh = reinterpret_cast<const uint16_t*>(xs);
    // B fragments of the stage's two k16 halves: rows 2t, 2t+1 (and 2t+8,
    // 2t+9) of a half lie in step 4*half + t/2 (+ 2), at its column offset
    uint32_t bf[2][WN][2];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      const int off0 = (offs >> (3 * (4 * kh + (t >> 1)))) & 7;
      const int off1 = (offs >> (3 * (4 * kh + 2 + (t >> 1)))) & 7;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const int col = warp_n * (WN * 8) + j * 8 + g;
        const uint16_t* p = xh + (16 * kh + 2 * t) * LDX16 + col + off0;
        const uint16_t* q = xh + (16 * kh + 8 + 2 * t) * LDX16 + col + off1;
        bf[kh][j][0] = (uint32_t)p[0] | ((uint32_t)p[LDX16] << 16);
        bf[kh][j][1] = (uint32_t)q[0] | ((uint32_t)q[LDX16] << 16);
      }
    }
#pragma unroll
    for (int i = 0; i < WM; ++i) {
      if constexpr (!decltype(all_rows_t)::value) {
        if (!mt_ok[i]) continue;
      }
      uint32_t af[2][4];
#pragma unroll
      for (int kh = 0; kh < 2; ++kh)
        nq_ldmatrix_x4_trans(
            af[kh], nq_smem_addr(ws + (16 * kh + lm_row) * T::LDW +
                                 (warp_m * WM + i) * 16 + lm_col));
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        float d[4];
        nq_mma_bf16_zero(d, af[0], bf[0][j]);
        nq_mma_bf16(d, af[1], bf[1][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
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
    // the stage's 8 column offsets (shift & 7), 3 bits each
    int offs = 0;
#pragma unroll
    for (int j = 0; j < BK / 4; ++j)
      offs |= (__ldg(&ksteps[(kt_begin + it) * (BK / 4) + j].x) & 7)
              << (3 * j);
    nq_cp_async_wait<T::STAGES - 2>();
    nq_bf16* xs = smem16 + stage * T::STAGE;
    const nq_bf16* ws = xs + BK * LDX16;
    if (act_in) {
      // this thread's own copies have landed: GELU them once, in place,
      // each value rounded back to bf16
#pragma unroll
      for (int i = 0; i < XROUNDS; ++i) {
        const int idx = tid + i * THREADS;
        if (idx >= BK * XV) break;
        const int row = idx / XV, v = idx - row * XV;
        uint4* p = reinterpret_cast<uint4*>(xs + row * LDX16 + 8 * v);
        uint4 q = *p;
        q.x = nq_gelu_bf16x2(q.x);
        q.y = nq_gelu_bf16x2(q.y);
        q.z = nq_gelu_bf16x2(q.z);
        q.w = nq_gelu_bf16x2(q.w);
        *p = q;
      }
    }
    __syncthreads();
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
      const float bv = bias != nullptr ? nq_f32(bias[co]) : 0.f;
      const size_t row = ((size_t)b * cout + co) * mp;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        const size_t o = row + mcol + j * 8;
        uint32_t om = 0;
        if (kOutMul) om = *reinterpret_cast<const uint32_t*>(out_mul + o);
        const float z0 = conv_epilogue<kOutMul>(acc[i][j][2 * hh], bv,
                                                nq_bf16_lo(om), mk[j].x);
        const float z1 = conv_epilogue<kOutMul>(acc[i][j][2 * hh + 1], bv,
                                                nq_bf16_hi(om), mk[j].y);
        if (out_z != nullptr)
          *reinterpret_cast<uint32_t*>(out_z + o) = nq_pack_bf16(z0, z1);
        if (out_y != nullptr)
          *reinterpret_cast<uint32_t*>(out_y + o) =
              nq_pack_bf16(nq_gelu(z0), nq_gelu(z1));
      }
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

template <int WM, bool kOutMul>
cudaError_t launch_bf16(const nq_bf16* x, const nq_bf16* w,
                        const nq_bf16* bias, const nq_bf16* out_mul,
                        const float* mask, const int4* ksteps, nq_bf16* out_z,
                        nq_bf16* out_y, float* part, int batch, int cin,
                        int cout, int mp, int ktiles, int splits, int act_in,
                        cudaStream_t stream) {
  using T = Tile16<WM>;
  auto kernel = tail_conv_cf_bf16_kernel<WM, kOutMul>;
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
  tail_conv_cf_bf16_finish_kernel<kOutMul>
      <<<(unsigned)((total4 + 255) / 256), 256, 0, stream>>>(
          reinterpret_cast<const float4*>(part), bias,
          reinterpret_cast<const uint2*>(out_mul),
          reinterpret_cast<const float4*>(mask), out_z, out_y, total4, cout,
          mp / 4, splits);
  return cudaGetLastError();
}

// output channels per block, shared by both instantiations
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
// out_mul and the outputs 16-byte aligned.
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
  if (nsteps < 1 || nsteps % (BK / 4) != 0 || mp % BN != 0 || batch < 1 ||
      cout < 1 || cout % 8 != 0 || splits < 1 ||
      (splits > 1 && part == nullptr) ||
      (out_z == nullptr && out_y == nullptr) ||
      (long)batch * splits > 65535 || misaligned(x) || misaligned(w) ||
      misaligned(out_mul) || misaligned(out_z) || misaligned(out_y))
    return (int)cudaErrorInvalidValue;
  const int ktiles = nsteps / (BK / 4);
  const int4* ks = reinterpret_cast<const int4*>(ksteps);
  const cudaStream_t st = (cudaStream_t)stream;
  const nq_bf16* xh = static_cast<const nq_bf16*>(x);
  const nq_bf16* wh = static_cast<const nq_bf16*>(w);
  const nq_bf16* bh = static_cast<const nq_bf16*>(bias);
  const nq_bf16* omh = static_cast<const nq_bf16*>(out_mul);
  nq_bf16* zh = static_cast<nq_bf16*>(out_z);
  nq_bf16* yh = static_cast<nq_bf16*>(out_y);
  const int wm = conv_wm(cout, ktiles);
#define NQ_LAUNCH(WM, OM)                                                  \
  launch_bf16<WM, OM>(xh, wh, bh, omh, mask, ks, zh, yh, part, batch, cin, \
                      cout, mp, ktiles, splits, act_in, st)
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
